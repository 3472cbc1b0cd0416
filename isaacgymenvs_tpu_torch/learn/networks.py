"""Policy / value networks (port of isaacgymenvs_tpu/learn/networks.py).

The rl_games `actor_critic` layout of cfg/train/AntPPO.yaml: shared elu
MLP trunk, mu head, state-independent learned log-sigma, value head.
Submodule and parameter names follow the flax modules (actor_mlp.fc0, mu,
value, log_sigma) so that `convert.actor_critic_from_flax` maps one onto
the other.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    def __init__(self, in_dim: int, units: Sequence[int]):
        super().__init__()
        self.n = len(units)
        d = in_dim
        for i, u in enumerate(units):
            self.add_module(f"fc{i}", nn.Linear(d, u))
            d = u
        self.out_dim = d

    def forward(self, x):
        for i in range(self.n):
            x = F.elu(getattr(self, f"fc{i}")(x))
        return x


class ActorCritic(nn.Module):
    """Shared-trunk continuous actor-critic (`separate: False`,
    `fixed_sigma: True`, cfg/train/AntPPO.yaml)."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (256, 128, 64),
                 sigma_init: float = 0.0):
        super().__init__()
        self.actor_mlp = MLP(num_obs, units)
        self.mu = nn.Linear(self.actor_mlp.out_dim, num_actions)
        self.value = nn.Linear(self.actor_mlp.out_dim, 1)
        self.log_sigma = nn.Parameter(torch.full((num_actions,), float(sigma_init)))

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        trunk = self.actor_mlp(obs)
        mu = self.mu(trunk)
        return mu, self.log_sigma.expand_as(mu), self.value(trunk)[..., 0]
