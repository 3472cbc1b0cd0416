"""Recurrent (LSTM) actor-critic and recurrent PPO (port of
isaacgymenvs_tpu/learn/rnn.py).

The rl_games LSTM networks the train yamls configure under
`params.network.rnn` (units, before_mlp, layer_norm), trained with
truncated BPTT over `seq_length` windows: the rollout stores each step's
pre-step carry; the update re-runs the cell over each window from the
carry stored at its start, without resetting inside the window, and
minibatches over windows. The carry of an env that is done is zeroed after
the step.

As in the JAX package, the recurrent critic is the LSTM's own value head
on the policy observations: a central value net on privileged states is
the feed-forward `PPO`'s only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel import sharding
from .networks import MLP
from .ppo import PPO, PPOTrainState, Transition, _gaussian_logp, _policy_kl
from .running_stats import rms_normalize, rms_update

_LOG_2PI_E = math.log(2.0 * math.pi * math.e)


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell`: gates i, f, g, o from input kernels
    without bias and hidden kernels with bias (here four of each side by
    side, in that order); sigmoid, sigmoid, tanh, sigmoid;
    c' = f c + i g, h' = o tanh(c'). The carry is (c, h)."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.ih = nn.Linear(in_dim, 4 * units, bias=False)
        self.hh = nn.Linear(units, 4 * units)

    def forward(self, carry, x):
        c, h = carry
        i, f, g, o = torch.chunk(self.ih(x) + self.hh(h), 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class LSTMActorCritic(nn.Module):
    """MLP/LSTM actor-critic, the LSTM before or after the MLP trunk, an
    optional LayerNorm on its output (`rnn_ln`), mu and value heads and a
    state-independent log-sigma."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 256, 128), act: str = "elu",
                 rnn_units: int = 1024, before_mlp: bool = True, layer_norm: bool = True, sigma_init: float = 0.0,
                 learn_sigma: bool = True):
        super().__init__()
        self.rnn_units, self.before_mlp = rnn_units, before_mlp
        if before_mlp:
            self.lstm = LSTMCell(num_obs, rnn_units)
            self.mlp = MLP(rnn_units, units, act)
            head = self.mlp.out_dim
        else:
            self.mlp = MLP(num_obs, units, act)
            self.lstm = LSTMCell(self.mlp.out_dim, rnn_units)
            head = rnn_units
        # flax's LayerNorm: epsilon 1e-6
        self.rnn_ln = nn.LayerNorm(rnn_units, eps=1e-6) if layer_norm else None
        self.mu = nn.Linear(head, num_actions)
        self.value = nn.Linear(head, 1)
        sigma = torch.full((num_actions,), float(sigma_init))
        if learn_sigma:
            self.log_sigma = nn.Parameter(sigma)
        else:
            self.register_buffer("log_sigma", sigma, persistent=False)

    def forward(self, obs, carry):
        """obs (..., d), carry (c, h) each (..., rnn_units) -> (carry, (mu, log_sigma, value))."""
        if self.before_mlp:
            carry, x = self.lstm(carry, obs)
            if self.rnn_ln is not None:
                x = self.rnn_ln(x)
            x = self.mlp(x)
        else:
            carry, x = self.lstm(carry, self.mlp(obs))
            if self.rnn_ln is not None:
                x = self.rnn_ln(x)
        mu = self.mu(x)
        return carry, (mu, self.log_sigma.expand_as(mu), self.value(x)[..., 0])

    def initial_carry(self, batch_shape):
        """(c, h) of zeros on the module's device."""
        z = torch.zeros(tuple(batch_shape) + (self.rnn_units,), device=self.mu.weight.device)
        return (z, z.clone())


class PPORecurrent(PPO):
    """PPO with an LSTM policy (truncated BPTT over seq_length windows)."""

    recurrent = True

    def __init__(self, env, train_params: Dict[str, Any], seed: int = 0):
        c = train_params.get("config", {})
        self.seq_length = int(c.get("seq_length", c.get("seq_len", 4)))
        super().__init__(env, train_params, seed)
        # the recurrent critic reads the policy observations (module docstring)
        self.use_central_value, self.central_net = False, None
        L, H = self.seq_length, self.cfg.horizon_length
        if H % L:
            raise ValueError(f"horizon_length {H} is not a multiple of seq_length {L}")
        self.seqs_per_env = H // L
        self.num_seqs = self.seqs_per_env * env.num_envs * self.world  # over all the ranks' envs
        # minibatch_size counts transitions; a minibatch holds whole windows
        if self.minibatch_size % L:
            raise ValueError(f"minibatch_size {self.minibatch_size} is not a multiple of seq_length {L}")
        self.seq_minibatch = self.minibatch_size // L
        if self.num_seqs % self.seq_minibatch:
            raise ValueError(f"{self.num_seqs} windows do not split into minibatches of {self.seq_minibatch}")

    def build_network(self, env, net_cfg) -> nn.Module:
        rnn = net_cfg.get("rnn", {})
        mlp = net_cfg.get("mlp", {})
        space = net_cfg.get("space", {}).get("continuous", {})
        return LSTMActorCritic(
            env.num_obs,
            env.num_acts,
            units=tuple(mlp.get("units", (512, 256, 128))),
            act=str(mlp.get("activation", "elu")),
            rnn_units=int(rnn.get("units", 1024)),
            before_mlp=bool(rnn.get("before_mlp", True)),
            layer_norm=bool(rnn.get("layer_norm", False)),
            sigma_init=float(space.get("sigma_init", {}).get("val", 0.0)),
            learn_sigma=bool(space.get("learn_sigma", True)),
        )

    # ------------------------------------------------------------------
    def init(self) -> PPOTrainState:
        ts = super().init()
        return dataclasses.replace(ts, carry=self.network.initial_carry((self.env.num_envs,)))

    @torch.no_grad()
    def rollout(self, ts: PPOTrainState, noise: torch.Tensor | None = None):
        """One horizon; `noise` (T, N, num_acts) replaces the action noise.
        The transitions' `states` hold the pre-step carry (c, h), each (T, N, H)."""
        cfg = self.cfg
        env_state, obs, obs_rms, carry = ts.env_state, ts.obs, ts.obs_rms, ts.carry
        ep_ret, ep_len = ts.ep_return, ts.ep_len
        steps, carries = [], []
        for t in range(cfg.horizon_length):
            if cfg.normalize_input:
                obs_rms = rms_update(obs_rms, obs)
            new_carry, (mu, log_sigma, v_norm) = self.network(self._norm_obs(obs_rms, obs), carry)
            value = self._denorm_value(ts.value_rms, v_norm)
            eps = noise[t] if noise is not None else torch.randn(mu.shape, generator=ts.generator, device=mu.device)
            action = mu + torch.exp(log_sigma) * eps
            logp = _gaussian_logp(action, mu, log_sigma)
            env_state, next_obs, reward, done, extras = self.env.step(env_state, action)
            shaped = reward * cfg.reward_scale
            if cfg.value_bootstrap:
                shaped = shaped + cfg.gamma * value * extras["time_outs"].to(value.dtype)
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            carries.append(carry)  # the pre-step carry: where a BPTT window starts
            steps.append((
                obs, action, mu, log_sigma, logp, value, shaped, done,
                torch.sum(torch.where(done, ep_ret, torch.zeros_like(ep_ret))),
                torch.sum(torch.where(done, ep_len, torch.zeros_like(ep_len))),
                torch.sum(done),
            ))
            # zero the carry of done envs
            keep = (~done).to(torch.float32)[:, None]
            carry = tuple(x * keep for x in new_carry)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            obs = next_obs
        traj = Transition(*(torch.stack(x) for x in zip(*steps)), extras={},
                          states=tuple(torch.stack(x) for x in zip(*carries)))
        ts = dataclasses.replace(ts, env_state=env_state, obs=obs, obs_rms=obs_rms, ep_return=ep_ret, ep_len=ep_len,
                                 carry=carry)
        _, (_, _, v_norm) = self.network(self._norm_obs(obs_rms, obs), carry)
        return ts, traj, self._denorm_value(ts.value_rms, v_norm)

    # ------------------------------------------------------------------
    def train_epoch(self, ts: PPOTrainState, noise=None, perms=None):
        """One epoch: rollout, then mini_epochs over minibatches of whole
        windows. `noise` (T, N, num_acts) and `perms` (mini_epochs,
        num_seqs; num_seqs / S under local_shuffle's S shards) replace the
        draws of `ts.generator` and `ts.shuffle_generator`. Windows are
        env-major (row = env * windows per env + window), so a rank's
        block of envs holds a contiguous block of the global windows, as a
        shard does. Returns (ts, metrics as Python floats)."""
        cfg = self.cfg
        ts, traj, last_value = self.rollout(ts, noise)
        S, L, N = self.seqs_per_env, self.seq_length, self.env.num_envs
        Sh = self._shards(self.seq_minibatch, self.num_seqs, "seq_minibatch", "num_seqs")
        with torch.no_grad():
            advantages, returns = self._gae(traj, last_value)
            value_rms = ts.value_rms
            if cfg.normalize_value:
                value_rms = rms_update(value_rms, traj.value)
                value_rms = rms_update(value_rms, returns)
                old_vnorm = rms_normalize(value_rms, traj.value, clip=np.inf)
                ret_norm = rms_normalize(value_rms, returns, clip=np.inf)
            else:
                old_vnorm, ret_norm = traj.value, returns
            ts = dataclasses.replace(ts, value_rms=value_rms)
            adv = advantages
            if cfg.normalize_advantage:
                mean, var, _ = sharding.batch_moments(adv)
                adv = (adv - mean) / (torch.sqrt(var) + 1e-8)

            def to_seq(x):  # (T, N, ...) -> (N S, L, ...), row = env * S + window
                x = x.reshape((S, L, N) + x.shape[2:])
                return torch.movedim(x, 2, 0).reshape((N * S, L) + x.shape[3:])

            def seq_starts(x):  # (T, N, H) -> (N S, H): the carry stored at each window's start
                x = x.reshape((S, L, N) + x.shape[2:])[:, 0]
                return torch.movedim(x, 1, 0).reshape((N * S,) + x.shape[2:])

            dataset = (
                to_seq(self._norm_obs(ts.obs_rms, traj.obs)),
                to_seq(traj.action), to_seq(traj.mu), to_seq(traj.sigma), to_seq(traj.logp),
                to_seq(old_vnorm), to_seq(adv), to_seq(ret_norm),
                *(seq_starts(c) for c in traj.states),
            )
            if Sh > 1:  # (shards held, windows per shard, ...): the shards are contiguous blocks of windows
                dataset = tuple(x.reshape((Sh // self.world, -1) + x.shape[1:]) for x in dataset)
        auxs, _ = self._updates(ts, dataset, value_rms, perms, self.num_seqs, self.seq_minibatch, Sh)
        num_mb = self.num_seqs // self.seq_minibatch
        a_loss, c_loss, entropy, b_loss, kl = (torch.stack(x) for x in zip(*auxs))
        metrics = {
            "a_loss": torch.mean(a_loss),
            "c_loss": torch.mean(c_loss),
            "entropy": torch.mean(entropy),
            "b_loss": torch.mean(b_loss),
            "kl": torch.mean(kl[-num_mb:]),  # the last mini-epoch
            "lr": ts.lr,
            **self._rollout_metrics(traj, {}, {}),
        }
        return ts, {k: float(v) for k, v in metrics.items()}

    def _held_rows(self, n_rows: int, device) -> torch.Tensor:
        """(n_rows,) the local row of each global window, -1 where another
        rank holds it: the rank's envs' windows are one contiguous block."""
        lo = self.env.env_block.start * self.seqs_per_env
        g = torch.arange(n_rows, device=device)
        return torch.where((g >= lo) & (g < lo + self.env.num_envs * self.seqs_per_env), g - lo, -1)

    def _loss(self, batch, value_rms=None, share=None):
        """Loss of one minibatch of windows: the cell re-run over each
        window from its stored start carry, no reset inside a window.
        batch = (nobs, action, old_mu, old_log_sigma, old_logp, old_vnorm,
        adv, ret_norm, c0, h0), the first eight (B, L, ...); with `share`
        the rank's windows of a global minibatch (`PPO._loss`)."""
        cfg = self.cfg
        mean = torch.mean if share is None else share.mean
        nobs, action, old_mu, old_log_sigma, old_logp, old_vnorm, adv, ret_norm, c0, h0 = batch
        carry, outs = (c0, h0), []
        for t in range(nobs.shape[1]):
            carry, out = self.network(nobs[:, t], carry)
            outs.append(out)
        mu, log_sigma, v_norm = (torch.stack(x, dim=1) for x in zip(*outs))
        logp = _gaussian_logp(action, mu, log_sigma)
        ratio = torch.exp(logp - old_logp)
        a_loss = -mean(torch.minimum(adv * ratio, adv * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)))
        if cfg.clip_value:
            v_clip = old_vnorm + torch.clamp(v_norm - old_vnorm, -cfg.e_clip, cfg.e_clip)
            c_loss = torch.maximum((v_norm - ret_norm) ** 2, (v_clip - ret_norm) ** 2)
        else:
            c_loss = (v_norm - ret_norm) ** 2
        c_loss = mean(c_loss)
        entropy = mean(torch.sum(log_sigma + 0.5 * _LOG_2PI_E, dim=-1))
        b_loss = mean(torch.sum(
            torch.clamp(mu - 1.1, min=0.0) ** 2 + torch.clamp(mu + 1.1, max=0.0) ** 2, dim=-1))
        total = a_loss + 0.5 * cfg.critic_coef * c_loss - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss
        kl = _policy_kl(old_mu, old_log_sigma, mu, log_sigma, mean)
        return total, (a_loss, c_loss, entropy, b_loss, kl)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, ts: PPOTrainState, obs, deterministic: bool = True, generator=None):
        """One policy step from the state's carry (the carry is not advanced;
        `play` threads it through `_play_step`)."""
        _, (mu, _, _) = self.network(self._norm_obs(ts.obs_rms, obs), ts.carry)
        return mu

    @torch.no_grad()
    def _play_step(self, ts, obs, prev_done):
        """Eval step threading the carry: zero it for the envs that were
        done, step the cell, keep the new carry in `ts`."""
        keep = (~prev_done).to(torch.float32)[:, None]
        carry = tuple(x * keep for x in ts.carry)
        carry, (mu, _, _) = self.network(self._norm_obs(ts.obs_rms, obs), carry)
        return mu, dataclasses.replace(ts, carry=carry)
