"""Policy / value networks (port of isaacgymenvs_tpu/learn/networks.py).

The rl_games `actor_critic` layout the train yamls configure under
`params.network`: an MLP trunk (optionally the d2rl dense-skip variant),
a mu head, a state-independent log-sigma (learned, or fixed when
`learn_sigma` is False), a value head on the shared trunk or on a separate
critic trunk. Submodule and parameter names follow the flax modules
(actor_mlp.fc0, critic_mlp.fc0, mu, value, log_sigma) so that
`convert.actor_critic_from_flax` maps one onto the other.

Initialisation is torch's default for `nn.Linear` (Kaiming-uniform weights,
uniform biases), not flax's lecun-normal with zero biases; the parity tests
carry weights across, so only fresh training runs differ.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

_ACT = {
    "elu": F.elu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "selu": F.selu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default is the tanh form
    "sigmoid": torch.sigmoid,
    "None": lambda x: x,
}


def activation(name: str) -> Callable:
    return _ACT[name]


class MLP(nn.Module):
    def __init__(self, in_dim: int, units: Sequence[int], act: str = "elu", d2rl: bool = False):
        super().__init__()
        self.n = len(units)
        self.act = _ACT[act]
        self.d2rl = d2rl
        d = in_dim
        for i, u in enumerate(units):
            if d2rl and i > 0:
                d += in_dim  # the input is concatenated again before every later layer
            self.add_module(f"fc{i}", nn.Linear(d, u))
            d = u
        self.out_dim = d

    def forward(self, x):
        inp = x
        for i in range(self.n):
            if self.d2rl and i > 0:
                x = torch.cat([x, inp], dim=-1)
            x = self.act(getattr(self, f"fc{i}")(x))
        return x


class ActorCritic(nn.Module):
    """Continuous actor-critic with a state-independent log-sigma."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (256, 128, 64),
                 act: str = "elu", d2rl: bool = False, sigma_init: float = 0.0,
                 separate: bool = False, learn_sigma: bool = True):
        super().__init__()
        self.actor_mlp = MLP(num_obs, units, act, d2rl)
        if separate:
            self.critic_mlp = MLP(num_obs, units, act, d2rl)
        self.separate = separate
        self.mu = nn.Linear(self.actor_mlp.out_dim, num_actions)
        self.value = nn.Linear(self.actor_mlp.out_dim, 1)
        sigma = torch.full((num_actions,), float(sigma_init))
        if learn_sigma:
            self.log_sigma = nn.Parameter(sigma)
        else:  # fixed log-std: a constant of the config, neither trained nor saved
            self.register_buffer("log_sigma", sigma, persistent=False)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        trunk = self.actor_mlp(obs)
        ctrunk = self.critic_mlp(obs) if self.separate else trunk
        mu = self.mu(trunk)
        return mu, self.log_sigma.expand_as(mu), self.value(ctrunk)[..., 0]


class CriticNet(nn.Module):
    """Standalone value network on privileged states: the asymmetric
    central value net (rl_games `central_value_config`), an MLP `cv_mlp`
    and a `value` head."""

    def __init__(self, num_states: int, units: Sequence[int] = (256, 128, 64), act: str = "elu"):
        super().__init__()
        self.cv_mlp = MLP(num_states, units, act)
        self.value = nn.Linear(self.cv_mlp.out_dim, 1)

    def forward(self, states) -> torch.Tensor:
        return self.value(self.cv_mlp(states))[..., 0]
