"""Hierarchical RL (port of isaacgymenvs_tpu/learn/hrl.py): a high-level
policy emits latent commands, and a frozen low-level controller (LLC) turns
(LLC observation, latent) into motor actions for `llc_steps` env steps per
macro action.

The high-level action space is the latent (`latent_dim`). Each macro action
is clamped to [-1, 1], L2-normalized for the LLC, and held for `llc_steps`
env steps of the LLC's deterministic action; the learner sees their mean
reward and the OR of their dones, with the last step's extras. The LLC is
an `AMPLatentActor` (`llc_style: amp_latent`, the latent embedded and
joined after the first observation layer) or an `ActorCritic` on the
observation and latent side by side (`concat`), loaded from a port
checkpoint (`llc_checkpoint`) or made from `seed + 101` when none is given.
Its parameters take no gradient and are in no optimizer.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.checkpoint import load_checkpoint
from .networks import ActorCritic
from .ppo import PPO


class AMPLatentActor(nn.Module):
    """A latent-conditioned LLC actor: the latent z is embedded
    (`latent_embed`, elu) and joined to the first observation layer's output
    (`fc0`, elu); further layers `fc1` ... (elu) and the action head `mu`."""

    def __init__(self, num_obs: int, latent_dim: int, num_actions: int, units: Sequence[int] = (256, 128, 64),
                 latent_units: int = 64):
        super().__init__()
        self.latent_embed = nn.Linear(latent_dim, latent_units)
        self.fc0 = nn.Linear(num_obs, units[0])
        d = units[0] + latent_units
        self.n = len(units)
        for i, u in enumerate(units[1:]):
            self.add_module(f"fc{i + 1}", nn.Linear(d, u))
            d = u
        self.mu = nn.Linear(d, num_actions)

    def forward(self, obs, z):
        x = torch.cat([F.elu(self.fc0(obs)), F.elu(self.latent_embed(z))], dim=-1)
        for i in range(1, self.n):
            x = F.elu(getattr(self, f"fc{i}")(x))
        return self.mu(x)


class HRL(PPO):
    """PPO over latent macro actions with a frozen LLC.

    train config keys: `llc_steps` (env steps per macro action),
    `latent_dim`, `llc_checkpoint` (empty: an LLC made from the seed),
    `llc_obs_dim` (the leading observation entries the LLC reads; default
    all), `llc_style` (`amp_latent` or `concat`), `llc_latent_units` and
    `llc_network.mlp.units` (must match the checkpoint).
    """

    def __init__(self, env, train_params: Dict[str, Any], seed: int = 0):
        cfg = train_params.get("config", {})
        self._llc_steps = int(cfg.get("llc_steps", 5))
        self._latent_dim = int(cfg.get("latent_dim", 8))
        self._llc_obs_dim = int(cfg.get("llc_obs_dim", env.num_obs))
        super().__init__(env, train_params, seed=seed)
        units = tuple(cfg.get("llc_network", {}).get("mlp", {}).get("units", (256, 128, 64)))
        self._llc_style = str(cfg.get("llc_style", "amp_latent"))
        # the LLC's fresh weights come from their own seed, not the global stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 101)
            if self._llc_style == "amp_latent":
                llc = AMPLatentActor(self._llc_obs_dim, self._latent_dim, env.num_acts, units,
                                     int(cfg.get("llc_latent_units", 64)))
            else:
                llc = ActorCritic(self._llc_obs_dim + self._latent_dim, env.num_acts, units)
        ckpt = str(cfg.get("llc_checkpoint", "") or "")
        if ckpt:
            llc.load_state_dict(load_checkpoint(ckpt, "cpu")["params"])
        self.llc_network = llc.to(env.device).requires_grad_(False).eval()

    def build_network(self, env, net_cfg) -> nn.Module:
        """The high-level policy: its actions are latents."""
        mlp = net_cfg.get("mlp", {})
        space = net_cfg.get("space", {}).get("continuous", {})
        return ActorCritic(
            env.num_obs,
            self._latent_dim,
            units=tuple(mlp.get("units", (256, 128, 64))),
            act=str(mlp.get("activation", "elu")),
            d2rl=bool(mlp.get("d2rl", False)),
            sigma_init=float(space.get("sigma_init", {}).get("val", 0.0)),
            separate=bool(net_cfg.get("separate", False)),
            learn_sigma=bool(space.get("learn_sigma", True)),
        )

    @torch.no_grad()
    def _llc_action(self, obs, latent):
        """The LLC's deterministic action for the latent put on the unit sphere."""
        z = latent / torch.clamp(torch.linalg.vector_norm(latent, dim=-1, keepdim=True), min=1e-8)
        llc_obs = obs[..., :self._llc_obs_dim]
        if self._llc_style == "amp_latent":
            return self.llc_network(llc_obs, z)
        return self.llc_network(torch.cat([llc_obs, z], dim=-1))[0]

    def env_step(self, env_state, obs, latent):
        """`llc_steps` env steps under one macro action: (state, obs, mean
        reward, OR of the dones, the last step's extras)."""
        latent = torch.clamp(latent, -1.0, 1.0)
        rew_sum = torch.zeros(obs.shape[0], device=obs.device)
        done_any = torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)
        for _ in range(self._llc_steps):
            env_state, obs, r, d, extras = self.env.step(env_state, self._llc_action(obs, latent))
            rew_sum = rew_sum + r
            done_any = done_any | d
        return env_state, obs, rew_sum / self._llc_steps, done_any, extras
