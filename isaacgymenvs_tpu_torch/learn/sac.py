"""Soft Actor-Critic (port of isaacgymenvs_tpu/learn/sac.py).

The train yamls' SAC (`AntSAC.yaml`): twin Q critics with targets
averaged in by `critic_tau`, a tanh-squashed Gaussian actor with a
soft-clamped log-std, a learnable temperature alpha (`init_alpha`,
`alpha_lr`, `learnable_temperature`), `num_steps_per_episode` env steps
per epoch with one update per env step once `num_warmup_steps` steps have
been taken, uniform actions for the first `num_seed_steps` steps, a replay
ring buffer on the env's device, observation normalization.

One update, in the reference's order: the critic step on targets from the
current actor and the target critics, then the actor step against the
UPDATED critic, then the temperature step on the actor step's log-probs
(target entropy -num_acts), then the Polyak average of the targets. The
terminal flag stored in the buffer is `done & ~time_outs`. The three Adams
have optax's defaults. A checkpoint holds the actor, the critics, the
targets, log alpha and the observation normalizer, no optimizer moments
and no buffer, as the JAX package's.

The actors, critics and log alpha live in the `SAC` object (as `PPO`
keeps its network); a `SACTrainState` carries the optimizers bound to
them, the buffer, the env and the random stream.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..envcore.vec_task import EnvState, VecTask
from ..parallel import distributed
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .networks import MLP
from .replay_buffer import ReplayBuffer
from .running_stats import RunningMeanStd, rms_normalize, rms_update

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class SACConfig(NamedTuple):
    gamma: float = 0.99
    init_alpha: float = 1.0
    alpha_lr: float = 0.005
    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    critic_tau: float = 0.005
    batch_size: int = 4096
    learnable_temperature: bool = True
    num_seed_steps: int = 5
    num_warmup_steps: int = 10
    num_steps_per_episode: int = 8
    replay_buffer_size: int = 1_000_000
    normalize_input: bool = True
    reward_scale: float = 1.0
    max_epochs: int = 20000
    save_frequency: int = 0
    score_to_win: float = 1e9

    @classmethod
    def from_train_cfg(cls, params: Dict[str, Any]) -> "SACConfig":
        """Build from the train dict (`params.config`)."""
        c = params.get("config", params)
        shaper = c.get("reward_shaper", {})
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            init_alpha=float(c.get("init_alpha", 1.0)),
            alpha_lr=float(c.get("alpha_lr", 0.005)),
            actor_lr=float(c.get("actor_lr", 5e-4)),
            critic_lr=float(c.get("critic_lr", 5e-4)),
            critic_tau=float(c.get("critic_tau", 0.005)),
            batch_size=int(c.get("batch_size", 4096)),
            learnable_temperature=bool(c.get("learnable_temperature", True)),
            num_seed_steps=int(c.get("num_seed_steps", 5)),
            num_warmup_steps=int(c.get("num_warmup_steps", 10)),
            num_steps_per_episode=int(c.get("num_steps_per_episode", 8)),
            replay_buffer_size=int(c.get("replay_buffer_size", 1_000_000)),
            normalize_input=bool(c.get("normalize_input", True)),
            reward_scale=float(shaper.get("scale_value", 1.0)),
            max_epochs=int(c.get("max_epochs", 20000)),
            save_frequency=int(c.get("save_frequency", 0)),
            score_to_win=float(c.get("score_to_win", 1e9)),
        )


class SquashedGaussianActor(nn.Module):
    """MLP trunk, mu and log-std heads; the log-std soft-clamped into
    `log_std_bounds` through a tanh."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 256), act: str = "relu",
                 log_std_bounds: Tuple[float, float] = (-5.0, 2.0)):
        super().__init__()
        self.trunk = MLP(num_obs, units, act)
        self.mu = nn.Linear(self.trunk.out_dim, num_actions)
        self.log_std = nn.Linear(self.trunk.out_dim, num_actions)
        self.bounds = (float(log_std_bounds[0]), float(log_std_bounds[1]))

    def forward(self, obs):
        x = self.trunk(obs)
        lo, hi = self.bounds
        return self.mu(x), lo + 0.5 * (hi - lo) * (torch.tanh(self.log_std(x)) + 1.0)


class TwinQ(nn.Module):
    """Two Q networks on concat(obs, action)."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 256), act: str = "relu"):
        super().__init__()
        self.q1 = MLP(num_obs + num_actions, units, act)
        self.q1_out = nn.Linear(self.q1.out_dim, 1)
        self.q2 = MLP(num_obs + num_actions, units, act)
        self.q2_out = nn.Linear(self.q2.out_dim, 1)

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return self.q1_out(self.q1(x))[..., 0], self.q2_out(self.q2(x))[..., 0]


def _squashed_sample(eps, mu, log_std):
    """tanh(mu + exp(log_std) eps) and its log-probability, the Jacobian's
    1 - a^2 floored at 1e-6."""
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = torch.sum(
        -0.5 * eps**2 - log_std - _LOG_SQRT_2PI - torch.log(torch.clamp(1.0 - a**2, min=1e-6)), dim=-1
    )
    return a, logp


@dataclasses.dataclass
class SACTrainState:
    """What evolves across epochs besides the parameters (which live in
    `SAC.actor`, `SAC.critic`, `SAC.target` and `SAC.log_alpha`)."""

    env_state: EnvState
    obs: torch.Tensor
    obs_rms: RunningMeanStd
    buffer: ReplayBuffer
    ep_return: torch.Tensor
    ep_len: torch.Tensor
    total_steps: int  # env steps so far (seed and warm-up gates)
    generator: torch.Generator  # actions, buffer indices, the update's noise
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam


class SAC:
    """SAC trainer bound to a VecTask env."""

    def __init__(self, env: VecTask, train_params: Dict[str, Any], seed: int = 0):
        if distributed.process_count() > 1:  # the JAX package's SAC takes no mesh either
            raise NotImplementedError("SAC trains in one process: multi_gpu with more than one rank is not ported")
        self.env = env
        self.cfg = SACConfig.from_train_cfg(train_params)
        net = train_params.get("network", {})
        mlp = net.get("mlp", {})
        bounds = net.get("log_std_bounds", [-5, 2])
        units = tuple(mlp.get("units", (512, 256)))
        act = str(mlp.get("activation", "relu"))
        self.seed = seed
        # float32 matrix products in full precision, as the JAX package runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.manual_seed(seed)
        dev = env.device
        self.actor = SquashedGaussianActor(env.num_obs, env.num_acts, units, act,
                                           (float(bounds[0]), float(bounds[1]))).to(dev)
        self.critic = TwinQ(env.num_obs, env.num_acts, units, act).to(dev)
        self.target = copy.deepcopy(self.critic)
        for p in self.target.parameters():
            p.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(math.log(self.cfg.init_alpha), device=dev))
        self.target_entropy = -float(env.num_acts)

    def init(self) -> SACTrainState:
        env, dev, cfg = self.env, self.env.device, self.cfg
        env_state, obs = env.reset(self.seed)
        n, no, na = env.num_envs, env.num_obs, env.num_acts
        cap = min(cfg.replay_buffer_size, 4_000_000 // max(no, 1) * 256)
        cap = max(cap, n * 4)
        buf = ReplayBuffer(cap, {"obs": (no,), "action": (na,), "reward": (), "next_obs": (no,), "done": ()}, dev)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
        adam = lambda params, lr: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return SACTrainState(
            env_state=env_state,
            obs=obs,
            obs_rms=RunningMeanStd.create((no,), dev),
            buffer=buf,
            ep_return=torch.zeros(n, device=dev),
            ep_len=torch.zeros(n, dtype=torch.int32, device=dev),
            total_steps=0,
            generator=torch.Generator(device=dev).manual_seed(self.seed + 1),
            actor_opt=adam(self.actor.parameters(), cfg.actor_lr),
            critic_opt=adam(self.critic.parameters(), cfg.critic_lr),
            alpha_opt=adam([self.log_alpha], cfg.alpha_lr),
        )

    def _norm(self, rms, obs):
        return rms_normalize(rms, obs) if self.cfg.normalize_input else obs

    @staticmethod
    def _step(opt, loss, params):
        """One optimizer step on the gradient of `loss` with respect to `params` only."""
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    # ------------------------------------------------------------------
    def _update(self, ts: SACTrainState, noise_next=None, noise_pi=None, idx=None) -> Dict[str, torch.Tensor]:
        """One gradient update from a batch of the buffer. `idx` (B,) gives
        the batch's indices, `noise_next` and `noise_pi` (B, num_acts) the
        standard-normal noise of the target's and the actor step's action
        samples; each is otherwise drawn from `ts.generator`."""
        cfg, gen = self.cfg, ts.generator
        batch = ts.buffer.sample(cfg.batch_size, gen, idx)
        nobs = self._norm(ts.obs_rms, batch["obs"])
        nnext = self._norm(ts.obs_rms, batch["next_obs"])
        shape = (cfg.batch_size, self.env.num_acts)
        draw = lambda given: given if given is not None else torch.randn(shape, generator=gen, device=nobs.device)
        eps_next, eps_pi = draw(noise_next), draw(noise_pi)
        alpha = torch.exp(self.log_alpha.detach())

        # critic step, on targets from the current actor and the target critics
        with torch.no_grad():
            mu_n, ls_n = self.actor(nnext)
            a_next, logp_next = _squashed_sample(eps_next, mu_n, ls_n)
            q1_t, q2_t = self.target(nnext, a_next)
            target_v = torch.minimum(q1_t, q2_t) - alpha * logp_next
            target_q = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * target_v
        with torch.enable_grad():
            q1, q2 = self.critic(nobs, batch["action"])
            c_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
            self._step(ts.critic_opt, c_loss, list(self.critic.parameters()))

            # actor step, against the updated critic
            mu, ls = self.actor(nobs)
            a, logp = _squashed_sample(eps_pi, mu, ls)
            q1, q2 = self.critic(nobs, a)
            a_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
            self._step(ts.actor_opt, a_loss, list(self.actor.parameters()))

            # temperature step, on the actor step's log-probs
            if cfg.learnable_temperature:
                l_loss = torch.mean(torch.exp(self.log_alpha) * (-logp.detach() - self.target_entropy))
                self._step(ts.alpha_opt, l_loss, [self.log_alpha])

        # Polyak average of the targets
        with torch.no_grad():
            for t, c in zip(self.target.parameters(), self.critic.parameters()):
                t.copy_((1.0 - cfg.critic_tau) * t + cfg.critic_tau * c)
        return {"c_loss": c_loss.detach(), "a_loss": a_loss.detach(), "alpha": alpha}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def train_epoch(self, ts: SACTrainState, noise: Dict[str, torch.Tensor] | None = None,
                    idx: torch.Tensor | None = None):
        """`num_steps_per_episode` env steps, each followed by one update
        once past the warm-up. `noise` replaces the draws of `ts.generator`
        per env step t: "act" (T, N, num_acts) the policy's standard-normal
        noise, "rand" (T, N, num_acts) the uniform seed actions in [-1, 1],
        "next" and "pi" (T, B, num_acts) the update's noise (see `_update`);
        `idx` (T, B) the update's buffer indices. Returns (ts, metrics as
        Python floats)."""
        cfg, env = self.cfg, self.env
        n, na, dev = env.num_envs, env.num_acts, env.device
        noise = noise or {}
        pick = lambda k, t: noise[k][t] if k in noise else None
        obs_rms, ep_ret, ep_len = ts.obs_rms, ts.ep_return, ts.ep_len
        outs, losses, env_metrics = [], [], []
        for t in range(cfg.num_steps_per_episode):
            if cfg.normalize_input:
                obs_rms = rms_update(obs_rms, ts.obs)
            mu, ls = self.actor(self._norm(obs_rms, ts.obs))
            # both draws every step, whichever the gate below takes
            eps = pick("act", t)
            if eps is None:
                eps = torch.randn((n, na), generator=ts.generator, device=dev)
            a_rand = pick("rand", t)
            if a_rand is None:
                a_rand = torch.rand((n, na), generator=ts.generator, device=dev) * 2.0 - 1.0
            a_pol, _ = _squashed_sample(eps, mu, ls)
            action = a_rand if ts.total_steps < cfg.num_seed_steps else a_pol
            env_state, next_obs, reward, done, extras = env.step(ts.env_state, action)
            # timeouts are not terminal for bootstrapping
            terminal = done & ~extras["time_outs"]
            ts.buffer.add_batch({"obs": ts.obs, "action": action, "reward": reward * cfg.reward_scale,
                                 "next_obs": next_obs, "done": terminal.to(torch.float32)})
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            env_metrics.append({
                k: torch.mean(v.to(torch.float32))
                for k, v in extras.items()
                if k not in ("states", "time_outs") and isinstance(v, torch.Tensor) and v.dim() == 1
            })
            outs.append((torch.sum(torch.where(done, ep_ret, torch.zeros_like(ep_ret))),
                         torch.sum(torch.where(done, ep_len, torch.zeros_like(ep_len))), torch.sum(done)))
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            ts = dataclasses.replace(ts, env_state=env_state, obs=next_obs, obs_rms=obs_rms,
                                     ep_return=ep_ret, ep_len=ep_len, total_steps=ts.total_steps + 1)
            # one gradient update per env step, after the warm-up
            if ts.total_steps > cfg.num_warmup_steps:
                losses.append(self._update(ts, pick("next", t), pick("pi", t), None if idx is None else idx[t]))
            else:
                zero = torch.zeros((), device=dev)
                losses.append({"c_loss": zero, "a_loss": zero, "alpha": torch.exp(self.log_alpha.detach())})
        ret_sum, len_sum, n_done = (torch.stack(x) for x in zip(*outs))
        metrics = {
            "ep_return_sum": torch.sum(ret_sum),
            "ep_len_sum": torch.sum(len_sum),
            "n_episodes": torch.sum(n_done),
            "c_loss": torch.mean(torch.stack([x["c_loss"] for x in losses])),
            "a_loss": torch.mean(torch.stack([x["a_loss"] for x in losses])),
            "alpha": losses[-1]["alpha"],
            **{f"env/{k}": torch.mean(torch.stack([m[k] for m in env_metrics])) for k in env_metrics[0]},
        }
        return ts, {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def train(self, max_epochs: int | None = None, log_every: int = 50, logger=None, train_dir: str | None = None,
              name: str = "run", checkpoint: str | None = None, on_epoch=None):
        """Host training loop; the checkpoint goes to
        `<train_dir>/<name>/nn/<name>.pth` at the end. Returns (ts, the last
        metrics)."""
        cfg = self.cfg
        ts = self.init()
        if checkpoint:
            ts = self.restore(checkpoint, ts)
        max_epochs = max_epochs or cfg.max_epochs
        steps_per_epoch = cfg.num_steps_per_episode * self.env.num_envs
        game_returns: list = []
        last: Dict[str, float] = {}
        for epoch in range(1, max_epochs + 1):
            te = time.time()
            ts, metrics = self.train_epoch(ts)
            n_eps = metrics["n_episodes"]
            if n_eps > 0:
                game_returns.append(metrics["ep_return_sum"] / n_eps)
                game_returns = game_returns[-100:]
            mean_ret = float(np.mean(game_returns)) if game_returns else float("nan")
            last = {**metrics, "mean_episode_return": mean_ret, "epoch": epoch,
                    "frames": epoch * steps_per_epoch, "fps": steps_per_epoch / (time.time() - te)}
            if logger is not None:
                logger.log({"rewards/frame": mean_ret, "losses/c_loss": last["c_loss"],
                            "losses/a_loss": last["a_loss"], "info/alpha": last["alpha"],
                            "performance/total_fps": last["fps"]}, epoch * steps_per_epoch)
            if epoch % log_every == 0 or epoch == 1:
                print(f"epoch {epoch:6d} | return {mean_ret:10.2f} | fps {last['fps']:9.0f} | "
                      f"alpha {last['alpha']:.3f}")
            self.env.set_train_info(last["frames"])
            if on_epoch is not None and on_epoch(ts, last):
                break
            if mean_ret == mean_ret and mean_ret >= cfg.score_to_win:
                break
        if train_dir is not None:
            self.save(os.path.join(train_dir, name, "nn", f"{name}.pth"), ts)
        return ts, last

    # ------------------------------------------------------------------
    def save(self, path: str, ts: SACTrainState) -> None:
        save_checkpoint(path, {
            "actor_params": self.actor.state_dict(),
            "critic_params": self.critic.state_dict(),
            "target_params": self.target.state_dict(),
            "log_alpha": self.log_alpha.detach().clone(),
            "obs_rms": {"mean": ts.obs_rms.mean, "var": ts.obs_rms.var, "count": ts.obs_rms.count},
        })

    def load_state(self, ts: SACTrainState, state: Dict[str, Any]) -> SACTrainState:
        """Put a checkpoint's contents (the dict `save` writes, or the one
        `convert.sac_state_from_jax` makes) into the networks, log alpha and
        the observation normalizer."""
        dev = self.env.device
        self.actor.load_state_dict(state["actor_params"])
        self.critic.load_state_dict(state["critic_params"])
        self.target.load_state_dict(state["target_params"])
        with torch.no_grad():
            self.log_alpha.copy_(torch.as_tensor(state["log_alpha"], device=dev))
        return dataclasses.replace(ts, obs_rms=RunningMeanStd(**{k: v.to(dev) for k, v in state["obs_rms"].items()}))

    def restore(self, path: str, ts: SACTrainState) -> SACTrainState:
        return self.load_state(ts, load_checkpoint(path, self.env.device))

    @torch.no_grad()
    def act(self, ts: SACTrainState, obs):
        """Deterministic eval action: tanh(mu)."""
        mu, _ = self.actor(self._norm(ts.obs_rms, obs))
        return torch.tanh(mu)

    def play(self, checkpoint: str | None = None, num_episodes: int = 32) -> float:
        """Inference loop: the deterministic squashed policy, mean finished-episode return."""
        ts = self.init()
        if checkpoint:
            ts = self.restore(checkpoint, ts)
        env_state, obs = self.env.reset(self.seed + 1)
        ep_ret = torch.zeros(self.env.num_envs, device=self.env.device)
        finished, total = 0, 0.0
        while finished < num_episodes:
            env_state, obs, rew, done, _ = self.env.step(env_state, self.act(ts, obs))
            ep_ret = ep_ret + rew
            n_done = int(done.sum())
            if n_done:
                total += float(ep_ret[done].sum())
                finished += n_done
                ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
        mean_ret = total / max(finished, 1)
        print(f"played {finished} episodes | mean return {mean_ret:.2f}")
        return mean_ret
