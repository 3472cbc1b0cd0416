"""AMP agent: PPO with an adversarial motion-prior discriminator (port of
isaacgymenvs_tpu/learn/amp.py).

The env's AMP windows (`extras['amp_obs']`) are captured in the rollout.
Before GAE, `amp_rms` takes the rollout's windows (it is data, never
trained), and each step's reward becomes task_reward_w x reward +
disc_reward_w x the style reward -log(max(1 - sigmoid(D(amp_obs)), 1e-4))
x disc_reward_scale. Each epoch draws one demo window per batch row from
the env's motion clip (`fetch_amp_obs_demo`); the agent's and the demos'
windows, normalized by `amp_rms`, go through the minibatch permutation
with the PPO dataset, and the discriminator's loss on the first
min(amp_minibatch_size, rows) of each minibatch joins the PPO loss:
disc_coef x (the BCE of agent -> 0 and demo -> 1 through softplus, the
logit kernel's L2 x disc_logit_reg, the gradient penalty on the demo
inputs x disc_grad_penalty / 2, the MLP kernels' L2 x disc_weight_decay).
One Adam optimizer steps the policy and the discriminator together, and
`truncate_grads` clips their joint gradient norm. Under a process group
`amp_rms` merges the global moments, the demo windows come from the
rank's stream, and the discriminator's rows are the global minibatch's
first min(amp_minibatch_size, rows), whichever rank holds them; the terms
of its weights alone (the logit and MLP L2) are rank 0's. The discriminator's
products are `nn.Linear`, as they are flax `Dense` in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .networks import MLP
from .ppo import PPO, PPOTrainState, _rms_state
from .running_stats import RunningMeanStd, rms_normalize, rms_update


class Discriminator(nn.Module):
    """An MLP (`disc_mlp`) and a single logit (`disc_logits`)."""

    def __init__(self, num_amp_obs: int, units: Sequence[int] = (1024, 512), act: str = "relu"):
        super().__init__()
        self.disc_mlp = MLP(num_amp_obs, units, act)
        self.disc_logits = nn.Linear(self.disc_mlp.out_dim, 1)

    def forward(self, amp_obs):
        return self.disc_logits(self.disc_mlp(amp_obs))[..., 0]


@dataclasses.dataclass
class AMPTrainState(PPOTrainState):
    amp_rms: RunningMeanStd | None = None  # normalizer of the AMP windows


class AMPAgent(PPO):
    capture_extras = ("amp_obs",)

    def __init__(self, env, train_params: Dict[str, Any], seed: int = 0):
        c = train_params.get("config", {})
        self.task_reward_w = float(c.get("task_reward_w", 0.0))
        self.disc_reward_w = float(c.get("disc_reward_w", 1.0))
        self.disc_reward_scale = float(c.get("disc_reward_scale", 2.0))
        self.disc_coef = float(c.get("disc_coef", 5.0))
        self.disc_logit_reg = float(c.get("disc_logit_reg", 0.05))
        self.disc_grad_penalty = float(c.get("disc_grad_penalty", 5.0))
        self.disc_weight_decay = float(c.get("disc_weight_decay", 1e-4))
        self.amp_minibatch_size = int(c.get("amp_minibatch_size", 4096))
        self.normalize_amp_input = bool(c.get("normalize_amp_input", True))
        if not hasattr(env, "fetch_amp_obs_demo"):
            raise ValueError("AMP needs an env with a demo sampler (fetch_amp_obs_demo)")
        super().__init__(env, train_params, seed)
        self.num_amp_obs = env.num_amp_obs
        disc_cfg = train_params.get("network", {}).get("disc", {})
        self.disc = Discriminator(self.num_amp_obs, tuple(disc_cfg.get("units", (1024, 512))),
                                  str(disc_cfg.get("activation", "relu"))).to(env.device)
        self._given_demos = None

    def named_trainables(self):
        """The policy's (and central value net's) parameters, then the
        discriminator's under `disc.`: one optimizer and one clip for all."""
        yield from super().named_trainables()
        for n, p in self.disc.named_parameters():
            yield f"disc.{n}", p

    def init(self) -> AMPTrainState:
        ts = super().init()
        fields = {f.name: getattr(ts, f.name) for f in dataclasses.fields(PPOTrainState)}
        return AMPTrainState(**fields, amp_rms=RunningMeanStd.create((self.num_amp_obs,), self.env.device))

    def _norm_amp(self, rms, x):
        return rms_normalize(rms, x) if self.normalize_amp_input else x

    # ---- the style reward ---------------------------------------------
    @torch.no_grad()
    def shape_rollout_rewards(self, ts, traj):
        amp_obs = traj.extras["amp_obs"]  # (T, N, A)
        rms = ts.amp_rms
        if self.normalize_amp_input:
            rms = rms_update(rms, amp_obs)
            ts = dataclasses.replace(ts, amp_rms=rms)
        prob = torch.sigmoid(self.disc(self._norm_amp(rms, amp_obs)))
        disc_r = -torch.log(torch.clamp(1.0 - prob, min=1e-4)) * self.disc_reward_scale
        combined = self.task_reward_w * traj.reward + self.disc_reward_w * disc_r
        return ts, traj._replace(reward=combined), {"disc_reward_mean": torch.mean(disc_r)}

    # ---- the discriminator's data and loss ------------------------------
    def train_epoch(self, ts, noise=None, perms=None, demos=None):
        """PPO's epoch; `demos` (the rank's rows of the batch, num_amp_obs)
        replaces the demo windows otherwise drawn from `ts.generator` after
        the rollout."""
        self._given_demos = demos
        try:
            return super().train_epoch(ts, noise, perms)
        finally:
            self._given_demos = None

    def extra_dataset(self, ts, traj, flat) -> tuple:
        # (rows, A), or (shards, rows / shards, A) under local_shuffle: the
        # demos are drawn flat and laid out as the agent's windows
        amp_obs = flat(traj.extras["amp_obs"])
        demos = self._given_demos
        if demos is None:
            demos = self.env.fetch_amp_obs_demo(ts.generator, amp_obs[..., 0].numel())
        # amp_rms stays as shape_rollout_rewards left it for the whole epoch,
        # so the windows are normalized once here
        return self._norm_amp(ts.amp_rms, amp_obs), self._norm_amp(ts.amp_rms, demos.reshape(amp_obs.shape))

    def extra_loss(self, batch_extra, share=None):
        agent_obs, demo_obs = batch_extra
        if share is None:
            k = rows = min(self.amp_minibatch_size, agent_obs.shape[0])
            mean = torch.mean
        else:  # the rank's rows among the global minibatch's first k, and its part of their means
            k = min(self.amp_minibatch_size, share.total)
            rows = share.first(k)
            mean = lambda x: torch.sum(x) / k
        d_agent = self.disc(agent_obs[:rows])
        # the gradient penalty on the demo inputs
        demo_obs = demo_obs[:rows].detach().requires_grad_(True)
        d_demo = self.disc(demo_obs)
        (demo_grad,) = torch.autograd.grad(d_demo.sum(), demo_obs, create_graph=True)
        grad_pen = mean(torch.sum(demo_grad ** 2, dim=-1))
        # BCE: agent -> 0, demo -> 1
        bce = 0.5 * (mean(F.softplus(d_agent)) + mean(F.softplus(-d_demo)))
        logit_reg = mlp_decay = 0.0
        if share is None or share.owner:  # terms of the weights alone: once over the ranks
            logit_reg = torch.sum(self.disc.disc_logits.weight ** 2)
            mlp_decay = sum(torch.sum(getattr(self.disc.disc_mlp, f"fc{i}").weight ** 2)
                            for i in range(self.disc.disc_mlp.n))
        disc_loss = (bce + self.disc_logit_reg * logit_reg + 0.5 * self.disc_grad_penalty * grad_pen
                     + self.disc_weight_decay * mlp_decay)
        acc = 0.5 * (mean((d_agent < 0).to(torch.float32)) + mean((d_demo > 0).to(torch.float32)))
        return self.disc_coef * disc_loss, {"disc_acc": acc.detach()}

    # ---- checkpoints ----------------------------------------------------
    def save(self, path: str, ts, epoch: int = 0, frames: int = 0):
        super().save(path, ts, epoch, frames, extra={"disc": self.disc.state_dict(),
                                                     "amp_rms": _rms_state(ts.amp_rms)})

    def load_state(self, ts, state: Dict[str, Any]):
        ts = super().load_state(ts, state)
        self.disc.load_state_dict(state["disc"])
        dev = self.env.device
        return dataclasses.replace(ts, amp_rms=RunningMeanStd(**{k: v.to(dev) for k, v in state["amp_rms"].items()}))
