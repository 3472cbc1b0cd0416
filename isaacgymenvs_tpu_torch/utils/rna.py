"""Random Network Adversary (port of isaacgymenvs_tpu/utils/rna.py): a
fixed random MLP that perturbs the policy's actions, batched over envs.

Each env carries a dropout mask (drawn at its reset) over the two hidden
layers; the network maps an observation to `num_actions` softmaxes over
`num_bins` bins in [-1, 1] and reads out their expectations. The weights
are drawn on the host from `np.random.default_rng(seed)` exactly as the
JAX package draws them, so the two packages' networks are bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class RandomNetworkAdversary:
    """obs (n, in_dim) and per-env dropout masks (n, 2, hidden) ->
    adversarial actions (n, num_actions) in [-1, 1].

        rna = RandomNetworkAdversary(in_dim, num_actions, device=dev)
        mask = rna.sample_mask(generator, n)   # at env reset, kept in the task state
        a_rna = rna(mask, obs)                 # every step
        a = (1 - alpha) * a_policy + alpha * a_rna
    """

    def __init__(self, in_dim: int, num_actions: int, hidden: int = 64, num_bins: int = 32,
                 dropout: float = 0.5, seed: int = 0, device="cuda"):
        self.in_dim, self.num_actions, self.hidden = in_dim, num_actions, hidden
        self.num_bins, self.dropout = num_bins, dropout
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)

        def glorot(shape):
            w = rng.normal(0.0, np.sqrt(2.0 / sum(shape)), shape).astype(np.float32)
            return torch.as_tensor(w, device=self.device)

        self.w1 = glorot((in_dim, hidden))
        self.b1 = glorot((hidden,))
        self.w2 = glorot((hidden, hidden))
        self.b2 = glorot((hidden,))
        self.w3 = glorot((hidden, num_actions * num_bins))
        self.bin_centers = torch.as_tensor(np.linspace(-1.0, 1.0, num_bins).astype(np.float32), device=self.device)

    def mask_from_draws(self, u: torch.Tensor) -> torch.Tensor:
        """(n, 2, hidden) masks from uniform draws u in [0, 1) of that shape:
        kept units scaled by 1 / (1 - dropout)."""
        keep = 1.0 - self.dropout
        return (u < keep).to(torch.float32) / keep

    def sample_mask(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, 2, hidden) per-env dropout masks (drawn at an env's reset)."""
        return self.mask_from_draws(torch.rand(n, 2, self.hidden, generator=generator, device=self.device))

    def __call__(self, mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1) * mask[:, 0]
        h = torch.relu(h @ self.w2 + self.b2) * mask[:, 1]
        logits = (h @ self.w3).reshape(x.shape[0], self.num_actions, self.num_bins)
        return torch.softmax(logits, dim=-1) @ self.bin_centers
