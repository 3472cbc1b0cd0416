"""PPO (port of isaacgymenvs_tpu/learn/ppo.py).

Semantics follow the rl_games agent the train yamls configure
(`params.config`):
  * rollout of `horizon_length` steps over all envs, then `mini_epochs` x
    minibatched clipped-surrogate updates;
  * running-mean-std obs and value normalization (normalize_input /
    normalize_value);
  * GAE(gamma, tau) with timeout value-bootstrap: shaped reward +=
    gamma * V(s_t) * time_out;
  * adaptive-KL learning-rate schedule: lr adjusted after every minibatch
    from the analytic Gaussian KL against the rollout policy; or `linear`;
  * clipped value loss, bounds loss on mu (soft bound 1.1), entropy bonus;
  * reward shaping by scale_value;
  * with `env.num_states > 0` the asymmetric central value net
    (`CriticNet` on the privileged states, `central_value_config`), trained
    in the same loss and optimizer as the policy, its states normalized by
    `state_rms`;
  * per-episode sums of `extras['episode_cumulative']` terms, logged as
    `episode_cumulative/<k>` (mean over the episodes finished in the
    rollout) and its `_min` / `_max`;
  * `capture_extras`: the env extras a subclass names are kept per step in
    the rollout (`traj.extras[k]`, (T, N, ...)), for its hooks
    `shape_rollout_rewards`, `extra_dataset` (entries that go through the
    same minibatch permutation as the base ones) and `extra_loss` (AMP's
    discriminator, `amp.AMPAgent`).

The rollout runs under `torch.no_grad()`, the update under autograd. All
of it is float32; TF32 is switched off, as the JAX package runs its matrix
products at the highest precision. `mixed_precision` in the yaml is
ignored, as there. The policy's parameters live in `PPO.network` (an
`nn.Module`): a `PPOTrainState` does not own them, it carries the
optimizer bound to them, the learning rate, the normalizers and the env.

Under a process group (`parallel/distributed.py`) every rank steps its
block of the env axis (`parallel/sharding.py`) and the epoch computes what
one process computes over all the envs: the normalizers merge the global
batch moments, the advantages are normalized by the global mean and std,
every rank draws the same permutation of the global batch from the shared
`shuffle_generator`, adds the loss terms of the rows of each minibatch it
holds divided by the global minibatch size, and the gradient is summed over
the ranks before the norm clip, so that every rank takes the same Adam step
and the parameters stay bit-equal; the KL, the losses and the episode
sums are reduced alike. `local_shuffle` permutes rows within shards of the
env axis (one shard per rank, or `_shuffle_shards` in one process), the
same permutation on every shard, each minibatch taking minibatch_size / S
rows of each shard, as the JAX package's sharded epoch does. The action
noise comes from `generator`, a stream of the rank's own.

A recurrent network (`network.rnn`) is `rnn.PPORecurrent`'s; `PPO`
refuses it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..envcore.vec_task import EnvState, VecTask
from ..parallel import distributed, sharding
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .networks import ActorCritic, CriticNet
from .running_stats import RunningMeanStd, rms_denormalize, rms_normalize, rms_update

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2PI_E = math.log(2.0 * math.pi * math.e)


class PPOConfig(NamedTuple):
    """Static hyperparameters; names follow the train-yaml keys."""

    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_schedule: str = "adaptive"
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    horizon_length: int = 16
    minibatch_size: int = 32768
    mini_epochs: int = 4
    critic_coef: float = 2.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    truncate_grads: bool = True
    clip_value: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = False
    reward_scale: float = 1.0  # reward_shaper.scale_value
    max_epochs: int = 500
    score_to_win: float = 1e9
    save_frequency: int = 0
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    # permute rollout rows only within each env shard, the same permutation
    # on every shard (the JAX package's local_shuffle)
    local_shuffle: bool = False

    @classmethod
    def from_train_cfg(cls, params: Dict[str, Any]) -> "PPOConfig":
        """Build from the train dict (`params.config`)."""
        c = params.get("config", params)
        shaper = c.get("reward_shaper", {})
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            learning_rate=float(c.get("learning_rate", 3e-4)),
            lr_schedule=str(c.get("lr_schedule", "adaptive")),
            kl_threshold=float(c.get("kl_threshold", 0.008)),
            e_clip=float(c.get("e_clip", 0.2)),
            horizon_length=int(c.get("horizon_length", 16)),
            minibatch_size=int(c.get("minibatch_size", 32768)),
            mini_epochs=int(c.get("mini_epochs", 4)),
            critic_coef=float(c.get("critic_coef", 2.0)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 0.0) or 0.0),
            grad_norm=float(c.get("grad_norm", 1.0)),
            truncate_grads=bool(c.get("truncate_grads", True)),
            clip_value=bool(c.get("clip_value", True)),
            normalize_input=bool(c.get("normalize_input", True)),
            normalize_value=bool(c.get("normalize_value", True)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            value_bootstrap=bool(c.get("value_bootstrap", False)),
            reward_scale=float(shaper.get("scale_value", 1.0)),
            max_epochs=int(c.get("max_epochs", 500)),
            score_to_win=float(c.get("score_to_win", 1e9)),
            save_frequency=int(c.get("save_frequency", 0)),
            local_shuffle=bool(c.get("local_shuffle", False)),
        )


@dataclasses.dataclass
class PPOTrainState:
    """What evolves across epochs, except the policy's parameters: those
    live in `PPO.network`, and `optimizer` is bound to them."""

    env_state: EnvState
    obs: torch.Tensor  # (N, num_obs) last observation
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    ep_return: torch.Tensor  # (N,) running episode return (raw rewards)
    ep_len: torch.Tensor  # (N,) int32
    generator: torch.Generator  # action noise (and AMP's demo windows): the rank's own stream
    shuffle_generator: torch.Generator  # minibatch permutations: the same stream on every rank
    optimizer: torch.optim.Adam
    lr: float  # dynamic (adaptive KL schedule)
    states: torch.Tensor | None = None  # (N, num_states) privileged state (central value)
    state_rms: RunningMeanStd | None = None
    # per-env running sums of extras['episode_cumulative'] terms, from the
    # first step that emits them
    ep_cum: Dict[str, torch.Tensor] | None = None
    carry: Any = None  # the recurrent policy's (c, h) (rnn.PPORecurrent)


class Transition(NamedTuple):
    """Rollout buffers, time-leading (T, N, ...)."""

    obs: torch.Tensor
    action: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor  # log-sigma, as in the JAX package
    logp: torch.Tensor
    value: torch.Tensor  # raw (denormalized)
    reward: torch.Tensor  # shaped + bootstrapped
    done: torch.Tensor
    ep_ret_done: torch.Tensor  # (T,) sum of returns of episodes finished
    ep_len_done: torch.Tensor
    n_done: torch.Tensor
    # {"_env_metrics": {name: (T,) step means}, "_ep_cum": {name: (sum, min, max) (T,) each},
    #  and each of `capture_extras`: (T, N, ...)}
    extras: Dict[str, Any]
    states: torch.Tensor | None = None  # (T, N, num_states) with the central value


def _gaussian_logp(x, mu, log_sigma):
    return torch.sum(
        -0.5 * ((x - mu) / torch.exp(log_sigma)) ** 2 - log_sigma - _LOG_SQRT_2PI, dim=-1
    )


def _policy_kl(mu0, log_s0, mu1, log_s1, mean=torch.mean):
    """Analytic KL(N0 || N1), summed over action dims, `mean` over the batch."""
    s0sq = torch.exp(2.0 * log_s0)
    s1sq = torch.exp(2.0 * log_s1)
    kl = log_s1 - log_s0 + (s0sq + (mu1 - mu0) ** 2) / (2.0 * s1sq) - 0.5
    return mean(torch.sum(kl, dim=-1))


def _rms_state(rms: RunningMeanStd) -> Dict[str, torch.Tensor]:
    return {"mean": rms.mean, "var": rms.var, "count": rms.count}


class PPO:
    """PPO trainer bound to a VecTask env."""

    # env-extras keys captured into the rollout (AMP observations)
    capture_extras: tuple = ()
    # True in rnn.PPORecurrent, which builds its own network from network.rnn
    recurrent: bool = False

    def __init__(self, env: VecTask, train_params: Dict[str, Any], seed: int = 0):
        self.env = env
        self.cfg = PPOConfig.from_train_cfg(train_params)
        net_cfg = train_params.get("network", {})
        mlp = net_cfg.get("mlp", {})
        if net_cfg.get("rnn") and not self.recurrent:
            raise NotImplementedError("network.rnn: a recurrent network trains with rnn.PPORecurrent, not PPO")
        self.seed = seed
        # float32 matrix products in full precision, as the JAX package runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.manual_seed(seed)
        self.network = self.build_network(env, net_cfg).to(env.device)
        # asymmetric actor-critic: the central value net on privileged states
        self.use_central_value = bool(getattr(env, "num_states", 0))
        self.central_net = None
        if self.use_central_value:
            cv_cfg = train_params.get("config", {}).get("central_value_config", {})
            cv_mlp = cv_cfg.get("network", {}).get("mlp", {})
            self.central_net = CriticNet(
                env.num_states,
                units=tuple(cv_mlp.get("units", mlp.get("units", (256, 128, 64)))),
                act=str(cv_mlp.get("activation", "elu")),
            ).to(env.device)
        # the env holds the rank's block; the batch and its minibatches are global.
        # Under a process group (even of one rank) the update goes through its collectives
        self.world, self.rank = distributed.process_count(), distributed.rank()
        self.sharded = distributed.is_initialized()
        self.batch_size = self.cfg.horizon_length * env.num_envs * self.world
        self.minibatch_size = min(self.cfg.minibatch_size, self.batch_size)
        if self.batch_size % self.minibatch_size:
            raise ValueError(
                f"batch {self.batch_size} not divisible by minibatch {self.minibatch_size}"
            )
        self.num_minibatches = self.batch_size // self.minibatch_size
        # local_shuffle's shard count in one process (the JAX package's
        # `_shuffle_shards`); under a process group the ranks are the shards
        self._shuffle_shards = 1

    def build_network(self, env, net_cfg) -> torch.nn.Module:
        """The policy network of `params.network`; a recurrent agent builds its own."""
        mlp = net_cfg.get("mlp", {})
        space = net_cfg.get("space", {}).get("continuous", {})
        return ActorCritic(
            env.num_obs,
            env.num_acts,
            units=tuple(mlp.get("units", (256, 128, 64))),
            act=str(mlp.get("activation", "elu")),
            d2rl=bool(mlp.get("d2rl", False)),
            sigma_init=float(space.get("sigma_init", {}).get("val", 0.0)),
            separate=bool(net_cfg.get("separate", False)),
            learn_sigma=bool(space.get("learn_sigma", True)),
        )

    def named_trainables(self):
        """(name, parameter) in the optimizer's order: the policy's, then the
        central value net's under `central.`."""
        yield from self.network.named_parameters()
        if self.central_net is not None:
            for n, p in self.central_net.named_parameters():
                yield f"central.{n}", p

    # ------------------------------------------------------------------
    def init(self) -> PPOTrainState:
        env, dev = self.env, self.env.device
        env_state, obs = env.reset(self.seed)
        sharding.broadcast_params([p for _, p in self.named_trainables()])
        states = state_rms = None
        if self.use_central_value:
            states = env.states_of(env_state)
            state_rms = RunningMeanStd.create((env.num_states,), dev)
        return PPOTrainState(
            env_state=env_state,
            obs=obs,
            obs_rms=RunningMeanStd.create((env.num_obs,), dev),
            value_rms=RunningMeanStd.create((), dev),
            ep_return=torch.zeros(env.num_envs, device=dev),
            ep_len=torch.zeros(env.num_envs, dtype=torch.int32, device=dev),
            generator=torch.Generator(device=dev).manual_seed(distributed.rank_seed(self.seed + 1)),
            shuffle_generator=torch.Generator(device=dev).manual_seed(self.seed + 2),
            # Adam as optax.scale_by_adam(eps=1e-8) followed by -lr * u: the
            # group's lr is set to the current lr before every step
            optimizer=torch.optim.Adam(
                [p for _, p in self.named_trainables()], lr=self.cfg.learning_rate, eps=1e-8
            ),
            lr=self.cfg.learning_rate,
            states=states,
            state_rms=state_rms,
        )

    # ------------------------------------------------------------------
    def _norm_obs(self, rms, obs):
        return rms_normalize(rms, obs) if self.cfg.normalize_input else obs

    def _denorm_value(self, rms, v_norm):
        return rms_denormalize(rms, v_norm) if self.cfg.normalize_value else v_norm

    def _norm_states(self, rms, states):
        return rms_normalize(rms, states) if self.cfg.normalize_input else states

    def _value_of(self, v_pol, state_rms, states):
        """Critic value (normalized space): the central net on the privileged
        states when asymmetric, otherwise the policy's value head."""
        return self.central_net(self._norm_states(state_rms, states)) if self.use_central_value else v_pol

    def env_step(self, env_state, obs, action):
        """One (macro-)transition of the env as seen by the learner; a
        hierarchical agent overrides it to expand a latent action."""
        return self.env.step(env_state, action)

    @torch.no_grad()
    def rollout(self, ts: PPOTrainState, noise: torch.Tensor | None = None):
        """Collect one horizon. `noise` (T, N, num_acts) replaces the
        standard-normal action noise drawn from `ts.generator`.

        Returns (ts, traj: Transition, last_value).
        """
        cfg = self.cfg
        env_state, obs, obs_rms = ts.env_state, ts.obs, ts.obs_rms
        states, state_rms, ep_cum = ts.states, ts.state_rms, ts.ep_cum
        ep_ret, ep_len = ts.ep_return, ts.ep_len
        steps, env_metrics, ep_cum_steps, states_seen = [], [], [], []
        captured = {k: [] for k in self.capture_extras}
        for t in range(cfg.horizon_length):
            if cfg.normalize_input:
                obs_rms = rms_update(obs_rms, obs)
                if self.use_central_value:
                    state_rms = rms_update(state_rms, states)
            mu, log_sigma, v_pol = self.network(self._norm_obs(obs_rms, obs))
            value = self._denorm_value(ts.value_rms, self._value_of(v_pol, state_rms, states))
            eps = (
                noise[t]
                if noise is not None
                else torch.randn(mu.shape, generator=ts.generator, device=mu.device)
            )
            action = mu + torch.exp(log_sigma) * eps
            logp = _gaussian_logp(action, mu, log_sigma)

            env_state, next_obs, reward, done, extras = self.env_step(env_state, obs, action)
            if self.use_central_value:
                states_seen.append(states)
                states = extras["states"]
            for k in self.capture_extras:
                captured[k].append(extras[k])
            # every per-env numeric extra is logged as its mean over the envs
            env_metrics.append({
                k: torch.mean(v.to(torch.float32))
                for k, v in extras.items()
                if k not in ("states", "time_outs") and isinstance(v, torch.Tensor) and v.dim() == 1
            })
            shaped = reward * cfg.reward_scale
            if cfg.value_bootstrap:
                shaped = shaped + cfg.gamma * value * extras["time_outs"].to(value.dtype)
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            if "episode_cumulative" in extras:
                ep_cum, captured = self._ep_cum_step(ep_cum, extras["episode_cumulative"], done)
                ep_cum_steps.append(captured)
            steps.append((
                obs, action, mu, log_sigma, logp, value, shaped, done,
                torch.sum(torch.where(done, ep_ret, torch.zeros_like(ep_ret))),
                torch.sum(torch.where(done, ep_len, torch.zeros_like(ep_len))),
                torch.sum(done),
            ))
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            obs = next_obs
        extras = {"_env_metrics": {k: torch.stack([m[k] for m in env_metrics]) for k in env_metrics[0]},
                  **{k: torch.stack(v) for k, v in captured.items()}}
        if ep_cum_steps:
            extras["_ep_cum"] = {k: tuple(torch.stack([c[k][i] for c in ep_cum_steps]) for i in range(3))
                                 for k in ep_cum_steps[0]}
        traj = Transition(
            *(torch.stack(x) for x in zip(*steps)),
            extras=extras,
            states=torch.stack(states_seen) if self.use_central_value else None,
        )
        ts = dataclasses.replace(
            ts, env_state=env_state, obs=obs, obs_rms=obs_rms, ep_return=ep_ret, ep_len=ep_len,
            states=states, state_rms=state_rms, ep_cum=ep_cum,
        )
        # bootstrap value for the state after the last transition
        _, _, v_pol = self.network(self._norm_obs(obs_rms, obs))
        return ts, traj, self._denorm_value(ts.value_rms, self._value_of(v_pol, state_rms, states))

    @staticmethod
    def _ep_cum_step(ep_cum, terms, done):
        """Add one step's `episode_cumulative` terms to the per-env sums;
        returns (the sums, reset where done, {k: (sum, min, max) over the
        envs done this step}). The term names stay those of the first step."""
        if ep_cum is None:
            ep_cum = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in sorted(terms.items())}
        if set(terms) != set(ep_cum):
            raise ValueError(f"extras['episode_cumulative'] changed its terms from {sorted(ep_cum)} "
                             f"to {sorted(terms)}")
        ep_cum = {k: ep_cum[k] + terms[k] for k in ep_cum}
        inf = torch.tensor(float("inf"), device=done.device)
        captured = {k: (torch.sum(torch.where(done, v, 0.0)), torch.min(torch.where(done, v, inf)),
                        torch.max(torch.where(done, v, -inf))) for k, v in ep_cum.items()}
        return {k: torch.where(done, 0.0, v) for k, v in ep_cum.items()}, captured

    def _gae(self, traj: Transition, last_value):
        cfg = self.cfg
        not_done = 1.0 - traj.done.to(torch.float32)
        adv = torch.zeros_like(last_value)
        value_next = last_value
        advantages = [None] * traj.reward.shape[0]
        for t in reversed(range(traj.reward.shape[0])):
            delta = traj.reward[t] + cfg.gamma * value_next * not_done[t] - traj.value[t]
            adv = delta + cfg.gamma * cfg.tau * not_done[t] * adv
            advantages[t] = adv
            value_next = traj.value[t]
        advantages = torch.stack(advantages)
        return advantages, advantages + traj.value

    # ------------------------------------------------------------------
    def extra_dataset(self, ts, traj, flat) -> tuple:
        """Hook: extra per-sample tensors appended to the minibatch tuple."""
        return ()

    def extra_loss(self, batch_extra, share=None):
        """Hook: additional loss terms from the extra dataset entries, and a
        dict of metrics (means over the epoch's minibatches); under a process
        group `share` (`sharding.RowShare`) says which rows of the global
        minibatch the rank holds."""
        return 0.0, {}

    def shape_rollout_rewards(self, ts, traj):
        """Hook for subclasses to modify rollout rewards (style rewards)
        before GAE. Returns (ts, traj, aux_metrics)."""
        return ts, traj, {}

    def _loss(self, batch, value_rms=None, share=None):
        """Loss of one minibatch under the current `self.network`.

        batch = (nobs, action, old_mu, old_log_sigma, old_logp, old_vnorm,
        adv, ret_norm, [nstates with the central value,] *extra). Returns
        (total, (a_loss, c_loss, entropy, b_loss, kl, extra_loss's metrics)).
        With `share` (a `sharding.RowShare`) the batch is the rank's rows of
        a global minibatch, and each mean is the rank's part of the global one.
        """
        cfg = self.cfg
        mean = torch.mean if share is None else share.mean
        nobs, action, old_mu, old_log_sigma, old_logp, old_vnorm, adv, ret_norm = batch[:8]
        mu, log_sigma, v_norm = self.network(nobs)
        n_base = 8
        if self.use_central_value:
            v_norm = self.central_net(batch[8])
            n_base = 9
        logp = _gaussian_logp(action, mu, log_sigma)
        ratio = torch.exp(logp - old_logp)
        surr1 = adv * ratio
        surr2 = adv * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -mean(torch.minimum(surr1, surr2))

        if cfg.clip_value:
            v_clipped = old_vnorm + torch.clamp(v_norm - old_vnorm, -cfg.e_clip, cfg.e_clip)
            c_loss = torch.maximum((v_norm - ret_norm) ** 2, (v_clipped - ret_norm) ** 2)
        else:
            c_loss = (v_norm - ret_norm) ** 2
        c_loss = mean(c_loss)

        entropy = mean(torch.sum(log_sigma + 0.5 * _LOG_2PI_E, dim=-1))
        # bounds loss, soft bound 1.1
        b_loss = mean(torch.sum(
            torch.clamp(mu - 1.1, min=0.0) ** 2 + torch.clamp(mu + 1.1, max=0.0) ** 2, dim=-1
        ))
        total = (
            a_loss
            + 0.5 * cfg.critic_coef * c_loss
            - cfg.entropy_coef * entropy
            + cfg.bounds_loss_coef * b_loss
        )
        xloss, xaux = self.extra_loss(batch[n_base:], share)
        total = total + xloss
        kl = _policy_kl(old_mu, old_log_sigma, mu, log_sigma, mean)
        return total, (a_loss, c_loss, entropy, b_loss, kl, xaux)

    def _update_lr(self, lr: float, kl: float) -> float:
        cfg = self.cfg
        if cfg.lr_schedule != "adaptive":
            return lr
        if kl > 2.0 * cfg.kl_threshold:
            lr = lr / 1.5
        if kl < 0.5 * cfg.kl_threshold:
            lr = lr * 1.5
        return min(max(lr, cfg.min_lr), cfg.max_lr)

    def _clip_grads(self) -> None:
        """Scale the gradients by max_norm / max(global_norm, max_norm), as
        optax.clip_by_global_norm does (no epsilon in the denominator)."""
        grads = [p.grad for _, p in self.named_trainables() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(self.cfg.grad_norm / norm, max=1.0)
        for g in grads:
            g.mul_(scale)

    def _minibatch_step(self, ts: PPOTrainState, mb, value_rms, share=None):
        """One optimizer step at `ts.lr`; returns the loss's aux tuple and
        the extra loss's metrics. With `share` the rank's gradient and its
        parts of the metrics are summed over the ranks first."""
        opt = ts.optimizer
        with torch.enable_grad():
            total, aux = self._loss(mb, value_rms, share)
        opt.zero_grad(set_to_none=True)
        total.backward()
        xaux = aux[5] if len(aux) > 5 else {}
        aux, xaux = tuple(a.detach() for a in aux[:5]), {k: v.detach() for k, v in xaux.items()}
        if share is not None:
            aux, xaux = self._all_reduce(aux, xaux)
        if self.cfg.truncate_grads:
            self._clip_grads()
        for group in opt.param_groups:
            group["lr"] = ts.lr
        opt.step()
        return aux, xaux

    def _all_reduce(self, aux, xaux):
        """Sum the gradients and the metrics' parts over the ranks, in one
        all-reduce; a parameter without a gradient (no row of the minibatch
        on the rank) adds zeros."""
        params = [p for _, p in self.named_trainables()]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        keys = sorted(xaux)
        scalars = torch.stack([*aux, *(xaux[k] for k in keys)]).to(grads[0].dtype)
        flat = sharding.all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads] + [scalars]))
        off = 0
        for p, g in zip(params, grads):
            p.grad = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
        vals = flat[off:]
        return tuple(vals[:len(aux)]), {k: vals[len(aux) + i] for i, k in enumerate(keys)}

    # ------------------------------------------------------------------
    def train_epoch(self, ts: PPOTrainState, noise=None, perms=None):
        """One full PPO epoch: rollout + mini_epochs of minibatch updates.

        `noise` (T, N, num_acts) replaces the action noise of the rollout
        (N the env's envs: the rank's block) and `perms` (mini_epochs, B)
        int64 the minibatch shuffles of the global batch (mini_epochs,
        B / S under local_shuffle's S shards), both otherwise drawn from
        `ts.generator` and `ts.shuffle_generator`. Returns (new_ts,
        metrics), the metrics as Python floats, the same on every rank.
        """
        cfg = self.cfg
        ts, traj, last_value = self.rollout(ts, noise)
        ts, traj, aux_metrics = self.shape_rollout_rewards(ts, traj)
        S = self._shards(self.minibatch_size, self.env.num_envs * self.world, "minibatch_size", "num_envs")
        with torch.no_grad():
            advantages, returns = self._gae(traj, last_value)
            # the value normalizer trains on the fresh values, then the returns;
            # the loss sees the normalizer after this update
            value_rms = ts.value_rms
            if cfg.normalize_value:
                value_rms = rms_update(value_rms, traj.value)
                value_rms = rms_update(value_rms, returns)
                old_vnorm = rms_normalize(value_rms, traj.value, clip=np.inf)
                ret_norm = rms_normalize(value_rms, returns, clip=np.inf)
            else:
                old_vnorm, ret_norm = traj.value, returns
            ts = dataclasses.replace(ts, value_rms=value_rms)

            if S > 1:
                Sl = S // self.world  # the shards this process holds

                def flat(x):  # (T, N, ...) -> (Sl, T N / Sl, ...): shard s holds env block s, time-major
                    T, N = x.shape[:2]
                    y = x.reshape((T, Sl, N // Sl) + x.shape[2:]).transpose(0, 1)
                    return y.reshape((Sl, T * (N // Sl)) + x.shape[2:])
            else:
                flat = lambda x: x.reshape((-1,) + x.shape[2:])
            adv = flat(advantages)
            if cfg.normalize_advantage:
                mean, var, _ = sharding.batch_moments(adv)
                adv = (adv - mean) / (torch.sqrt(var) + 1e-8)
            dataset = (
                flat(self._norm_obs(ts.obs_rms, traj.obs)),
                flat(traj.action),
                flat(traj.mu),
                flat(traj.sigma),
                flat(traj.logp),
                flat(old_vnorm),
                adv,
                flat(ret_norm),
            )
            if self.use_central_value:
                dataset += (flat(self._norm_states(ts.state_rms, traj.states)),)
            dataset += self.extra_dataset(ts, traj, flat)

        auxs, xauxs = self._updates(ts, dataset, value_rms, perms, self.batch_size, self.minibatch_size, S)
        a_loss, c_loss, entropy, b_loss, kl = (torch.stack(x) for x in zip(*auxs))
        ep_cum = traj.extras.get("_ep_cum", {})
        metrics = {
            "a_loss": torch.mean(a_loss),
            "c_loss": torch.mean(c_loss),
            "entropy": torch.mean(entropy),
            "b_loss": torch.mean(b_loss),
            "kl": torch.mean(kl[-self.num_minibatches:]),  # the last mini-epoch
            "lr": ts.lr,
            **self._rollout_metrics(traj, aux_metrics, ep_cum),
            **{k: torch.mean(torch.stack([x[k] for x in xauxs])) for k in xauxs[0]},
        }
        n_done = metrics["n_episodes"]
        for k in ep_cum:  # per-episode cumulative terms over the episodes finished in this rollout
            metrics[f"episode_cumulative/{k}"] = metrics[f"episode_cumulative/{k}"] / torch.clamp(n_done, min=1)
        return ts, {k: float(v) for k, v in metrics.items()}

    @staticmethod
    def _rollout_metrics(traj, aux_metrics, ep_cum) -> Dict[str, torch.Tensor]:
        """The rollout's metrics over all the ranks' envs: the episode sums,
        the env extras' and the reward's means, a subclass's `aux_metrics`
        (means) and the sum, min and max of each `episode_cumulative` term."""
        values = {
            "ep_return_sum": torch.sum(traj.ep_ret_done),
            "ep_len_sum": torch.sum(traj.ep_len_done),
            "n_episodes": torch.sum(traj.n_done),
            **{f"env/{k}": torch.mean(v) for k, v in traj.extras.get("_env_metrics", {}).items()},
            "reward_mean_step": torch.mean(traj.reward),
            **aux_metrics,
        }
        ops = {k: "sum" if k in ("ep_return_sum", "ep_len_sum", "n_episodes") else "mean" for k in values}
        for k, (sm, mn, mx) in ep_cum.items():
            for name, stat, op in ((f"episode_cumulative/{k}", torch.sum(sm), "sum"),
                                   (f"episode_cumulative_min/{k}_min", torch.min(mn), "min"),
                                   (f"episode_cumulative_max/{k}_max", torch.max(mx), "max")):
                values[name], ops[name] = stat, op
        return sharding.reduce_metrics(values, ops)

    def _shards(self, mb_rows: int, units: int, mb_name: str, unit_name: str) -> int:
        """local_shuffle's shard count S: the ranks of a process group, or
        `_shuffle_shards` in one process; 1 without local_shuffle. Raises
        where S does not divide the minibatch's `mb_rows` and the `units`
        the shards split."""
        if not self.cfg.local_shuffle:
            return 1
        S = self.world if self.sharded else self._shuffle_shards
        if mb_rows % S or units % S:
            raise ValueError(f"local_shuffle needs {mb_name} {mb_rows} and {unit_name} {units} divisible by the "
                             f"env-shard count {S}")
        return S

    def _held_rows(self, n_rows: int, device) -> torch.Tensor:
        """(n_rows,) the local row of each row of the global batch, -1 where
        another rank holds it: global row t N + n is env n's step t, and
        the rank holds its block's envs, time-major."""
        N, block = self.env.num_envs * self.world, self.env.env_block
        g = torch.arange(n_rows, device=device)
        t, n = g // N, g % N
        mine = (n >= block.start) & (n < block.stop)
        return torch.where(mine, t * self.env.num_envs + n - block.start, -1)

    def _updates(self, ts, dataset, value_rms, perms, n_rows: int, mb_rows: int, S: int):
        """mini_epochs of minibatch steps over `dataset`, which holds the
        rank's rows of a global batch of `n_rows` in minibatches of
        `mb_rows`: flat, or (shards held, rows per shard, ...) under
        local_shuffle's S shards. Returns the steps' aux tuples and extra
        metrics."""
        cfg, W = self.cfg, self.world
        dev = dataset[0].device
        nmb = n_rows // mb_rows
        held = self._held_rows(n_rows, dev) if self.sharded and S == 1 else None
        auxs, xauxs = [], []
        for e in range(cfg.mini_epochs):
            perm = (perms[e].to(dev) if perms is not None
                    else torch.randperm(n_rows // S, generator=ts.shuffle_generator, device=dev))
            for idx in perm.reshape(nmb, mb_rows // S):
                share = None
                if S > 1:  # the same rows of every shard; minibatches are contiguous slices of the permutation
                    mb = tuple(x[:, idx].reshape((-1,) + x.shape[2:]) for x in dataset)
                    if self.sharded:
                        part = mb_rows // W
                        share = sharding.RowShare(mb_rows, self.rank * part + torch.arange(part, device=dev),
                                                  self.rank == 0)
                elif self.sharded:  # the rank's rows of the global minibatch, in minibatch order
                    local = held[idx]
                    pos = torch.nonzero(local >= 0)[:, 0]
                    mb = tuple(x[local[pos]] for x in dataset)
                    share = sharding.RowShare(mb_rows, pos, self.rank == 0)
                else:
                    mb = tuple(x[idx] for x in dataset)
                aux, xaux = self._minibatch_step(ts, mb, value_rms, share)
                ts.lr = self._update_lr(ts.lr, float(aux[4]))
                auxs.append(aux)
                xauxs.append(xaux)
        return auxs, xauxs

    # ------------------------------------------------------------------
    def save(self, path: str, ts: PPOTrainState, epoch: int = 0, frames: int = 0, extra=None):
        """Write the checkpoint; `extra` (a dict) adds a subclass's entries.
        Under a process group every rank calls it: the per-env task state
        and ADR's worker assignment are gathered over the ranks, and rank 0
        writes the global state."""
        n = self.env.num_envs
        entries = dict(extra or {})
        if self.use_central_value:
            entries.update(central=self.central_net.state_dict(), state_rms=_rms_state(ts.state_rms))
        if ts.env_state.adr is not None:  # ADR's ranges, queues and worker assignment
            entries["env_adr_state"] = sharding.gather_env_rows(ts.env_state.adr.as_dict(), n)
        save_checkpoint(
            path,
            {
                **entries,
                "params": self.network.state_dict(),
                "obs_rms": _rms_state(ts.obs_rms),
                "value_rms": _rms_state(ts.value_rms),
                "lr": float(ts.lr),
                "opt_state": ts.optimizer.state_dict(),
                "epoch": int(epoch),
                "frames": int(frames),
                # env-side curriculum / task state round-trips with the checkpoint
                "env_task_state": sharding.gather_env_rows(ts.env_state.task, n),
            },
        )

    def load_state(self, ts: PPOTrainState, state: Dict[str, Any]) -> PPOTrainState:
        """Put a checkpoint's contents (the dict `save` writes, or the one
        `convert.train_state_from_jax` makes) into the network, the
        optimizer and `ts`. Of the optimizer only the per-parameter moments
        and step counts are taken: its hyperparameters are the config's."""
        dev = self.env.device
        self.network.load_state_dict(state["params"])
        if self.use_central_value:
            self.central_net.load_state_dict(state["central"])
        opt_sd = ts.optimizer.state_dict()
        # the step counts stay on the host, where Adam reads them
        opt_sd["state"] = {
            i: {k: (v.cpu() if k == "step" else v) for k, v in st.items()}
            for i, st in state["opt_state"]["state"].items()
        }
        ts.optimizer.load_state_dict(opt_sd)
        rms = lambda d: RunningMeanStd(**{k: v.to(dev) for k, v in d.items()})
        env_state = ts.env_state
        # the per-env entries hold every env; the rank takes its block
        rows = lambda x: sharding.env_rows(x, self.env.env_block, self.env.global_num_envs)
        task = state.get("env_task_state")
        if task is not None and env_state.task is not None:
            env_state = dataclasses.replace(env_state, task=rows(task))
        adr = state.get("env_adr_state")
        if adr is not None and env_state.adr is not None and getattr(self.env, "adr_load_from_checkpoint", False):
            # ADR's evolved ranges come back only where the task cfg asks for them
            env_state = dataclasses.replace(env_state, adr=type(env_state.adr)(**rows(adr)))
        # every rank reads the same file; rank 0's parameters stand
        sharding.broadcast_params([p for _, p in self.named_trainables()])
        return dataclasses.replace(
            ts,
            obs_rms=rms(state["obs_rms"]),
            value_rms=rms(state["value_rms"]),
            lr=float(state["lr"]),
            env_state=env_state,
            state_rms=rms(state["state_rms"]) if self.use_central_value else ts.state_rms,
        )

    def restore(self, path: str, ts: PPOTrainState) -> Tuple[PPOTrainState, int]:
        """Re-hydrate the network, the optimizer, the normalizers, the
        learning rate and the env-side task state from a checkpoint; ADR's
        state too where the env's `adr_load_from_checkpoint` is set."""
        ck = load_checkpoint(path, self.env.device)
        return self.load_state(ts, ck), int(ck.get("epoch", 0))

    def override_sigma(self, ts: PPOTrainState, sigma: float) -> PPOTrainState:
        """Fixed-sigma override (the `sigma=` CLI flag): replace the
        policy's learned log-std with log(sigma)."""
        if isinstance(self.network.log_sigma, torch.nn.Parameter):
            with torch.no_grad():
                self.network.log_sigma.fill_(math.log(sigma))
        return ts

    @torch.no_grad()
    def act(self, ts: PPOTrainState, obs, deterministic: bool = True, generator=None):
        """Policy action for eval/play."""
        mu, log_sigma, _ = self.network(self._norm_obs(ts.obs_rms, obs))
        if deterministic:
            return mu
        return mu + torch.exp(log_sigma) * torch.randn(
            mu.shape, generator=generator, device=mu.device
        )

    def _play_step(self, ts, obs, prev_done):
        """One eval policy step; stateful players override this to thread
        their carry through `ts` and reset it for done envs."""
        return self.act(ts, obs), ts

    def play(self, checkpoint: str | None = None, num_episodes: int = 32) -> float:
        """Inference loop: deterministic policy, mean finished-episode return."""
        ts = self.init()
        if checkpoint:
            ts, _ = self.restore(checkpoint, ts)
        env_state, obs = self.env.reset(self.seed + 1)
        n = self.env.num_envs
        ep_ret = torch.zeros(n, device=self.env.device)
        done = torch.zeros(n, dtype=torch.bool, device=self.env.device)
        finished, total = 0, 0.0
        stat_sums: Dict[str, float] = {}
        succ_hist: Dict[int, int] = {}
        while finished < num_episodes:
            a, ts = self._play_step(ts, obs, done)
            env_state, obs, rew, done, extras = self.env_step(env_state, obs, a)
            ep_ret = ep_ret + rew
            n_done = int(done.sum())
            if n_done:
                total += float(ep_ret[done].sum())
                finished += n_done
                ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
                # end-of-episode env stats
                for k, v in extras.items():
                    if k in ("states", "time_outs") or not isinstance(v, torch.Tensor):
                        continue
                    if v.dim() == 1 and v.shape[0] == n:
                        stat_sums[k] = stat_sums.get(k, 0.0) + float(v[done].double().sum())
                        if k == "successes":
                            for s in v[done].tolist():
                                succ_hist[int(s)] = succ_hist.get(int(s), 0) + 1
        mean_ret = total / max(finished, 1)
        print(f"played {finished} episodes | mean return {mean_ret:.2f}")
        for k, v in sorted(stat_sums.items()):
            print(f"  {k}: {v / max(finished, 1):.3f} (mean at episode end)")
        if succ_hist:
            tot = sum(succ_hist.values())
            print(f"  max successes: {max(succ_hist)}")
            print("  successes distribution: "
                  + ", ".join(f"{k}: {100.0 * v / tot:.1f}%" for k, v in sorted(succ_hist.items())))
        return mean_ret

    # ------------------------------------------------------------------
    def _saves_states(self) -> bool:
        """The initial-state bank is written by rank 0 (of its block's envs)."""
        return bool(getattr(self.env, "save_states", False) and getattr(self.env, "save_states_file", "")
                    and distributed.is_main_process())

    def train(
        self,
        max_epochs: int | None = None,
        log_every: int = 10,
        on_epoch=None,
        checkpoint: str | None = None,
        train_dir: str | None = None,
        name: str = "run",
        save_best_after: int = 100,
        logger=None,
    ) -> Tuple[PPOTrainState, Dict[str, float]]:
        """Host training loop. Returns the final state and the last metrics.

        Checkpoints go to <train_dir>/<name>/nn: `last_<name>_ep_<n>.pth`
        every `save_frequency` epochs, `<name>.pth` at each new best mean
        return from `save_best_after` on, `last_<name>.pth` at the end.
        Under a process group every rank trains and restores `checkpoint`;
        the files, the logger and the prints are rank 0's.
        """
        cfg = self.cfg
        main = distributed.is_main_process()
        if not main:
            logger = None
        ts = self.init()
        start_epoch = 0
        if checkpoint:
            ts, start_epoch = self.restore(checkpoint, ts)
        nn_dir = None
        if train_dir:  # every rank saves (the per-env state is gathered); rank 0 writes
            nn_dir = os.path.join(train_dir, name, "nn")
            if main:
                os.makedirs(nn_dir, exist_ok=True)
        best_ret = -float("inf")
        epoch = start_epoch
        max_epochs = max_epochs or cfg.max_epochs
        steps_per_epoch = self.batch_size
        game_returns: list = []  # mean over the last 100 epochs that finished episodes
        last_metrics: Dict[str, float] = {}
        t_start = time.time()
        for epoch in range(start_epoch + 1, max_epochs + 1):
            t0 = time.time()
            if cfg.lr_schedule == "linear":
                # the lr decays to ~0 over max_epochs
                ts.lr = cfg.learning_rate * max(0.0, 1.0 - (epoch - 1) / max(1, max_epochs))
            ts, metrics = self.train_epoch(ts)
            dt_epoch = time.time() - t0
            n_eps = metrics["n_episodes"]
            if n_eps > 0:
                game_returns.append(metrics["ep_return_sum"] / n_eps)
                game_returns = game_returns[-100:]
            mean_ret = float(np.mean(game_returns)) if game_returns else float("nan")
            frames = epoch * steps_per_epoch
            last_metrics = {
                **metrics,
                "mean_episode_return": mean_ret,
                "epoch": epoch,
                "frames": frames,
                "fps": steps_per_epoch / dt_epoch,
                "time": time.time() - t_start,
            }
            if logger is not None:
                logger.log(
                    {
                        # rl_games scalar names
                        "rewards/frame": mean_ret,
                        "rewards/iter": mean_ret,
                        "episode_lengths/frame": metrics["ep_len_sum"] / max(n_eps, 1),
                        "losses/a_loss": metrics["a_loss"],
                        "losses/c_loss": metrics["c_loss"],
                        "losses/entropy": metrics["entropy"],
                        "losses/bounds_loss": metrics["b_loss"],
                        "info/last_lr": metrics["lr"],
                        "info/kl": metrics["kl"],
                        "performance/total_fps": last_metrics["fps"],
                        "performance/step_fps": last_metrics["fps"],
                        **{k: v for k, v in metrics.items() if k.startswith("env/")
                           # only once episodes finished
                           or (k.startswith("episode_cumulative") and np.isfinite(v))},
                    },
                    frames,
                )
            # the initial-state bank (AllegroKuka's saveStates): one (q, qd)
            # snapshot per epoch, a host pull; dumped every 50 epochs and at exit
            if self._saves_states():
                self.env.accumulate_env_states(ts.env_state)
                if epoch % 50 == 0:
                    self.env.dump_env_states()
            self.env.set_train_info(frames)
            stop_requested = bool(on_epoch(ts, last_metrics)) if on_epoch is not None else False
            if main and (epoch % log_every == 0 or epoch == 1):
                print(
                    f"epoch {epoch:5d} | return {mean_ret:10.2f} | "
                    f"fps {last_metrics['fps']:9.0f} | kl {metrics['kl']:.4f} "
                    f"| lr {metrics['lr']:.2e}"
                )
            if nn_dir is not None:
                if cfg.save_frequency and epoch % cfg.save_frequency == 0:
                    self.save(os.path.join(nn_dir, f"last_{name}_ep_{epoch}.pth"), ts, epoch, frames)
                if epoch >= save_best_after and game_returns and mean_ret > best_ret:
                    best_ret = mean_ret
                    self.save(os.path.join(nn_dir, f"{name}.pth"), ts, epoch, frames)
            if stop_requested:
                break
            if mean_ret == mean_ret and mean_ret >= cfg.score_to_win:
                if main:
                    print(f"score_to_win {cfg.score_to_win} reached at epoch {epoch}")
                break
        if self._saves_states():
            self.env.dump_env_states()
        if nn_dir is not None:
            self.save(
                os.path.join(nn_dir, f"last_{name}.pth"), ts, epoch, epoch * steps_per_epoch
            )
        return ts, last_metrics
