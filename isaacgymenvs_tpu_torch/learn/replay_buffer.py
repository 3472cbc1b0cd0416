"""Fixed-size replay buffer on the env's device (port of
isaacgymenvs_tpu/learn/replay_buffer.py).

A ring of preallocated `(capacity, ...)` tensors, one per field: a batch of
n transitions goes to positions idx, idx + 1, ... modulo the capacity, and
sampling draws uniform indices below the fill level.
"""
from __future__ import annotations

from typing import Dict

import torch


class ReplayBuffer:
    def __init__(self, capacity: int, specs: Dict[str, tuple], device):
        self.capacity = int(capacity)
        self.data = {k: torch.zeros((self.capacity,) + tuple(shape), device=device) for k, shape in specs.items()}
        self.idx = 0  # next write position
        self.size = 0  # fill level

    def add_batch(self, batch: Dict[str, torch.Tensor]) -> None:
        """Insert a batch of n transitions (n <= capacity), wrapping at the end."""
        n = next(iter(batch.values())).shape[0]
        if n > self.capacity:
            raise ValueError(f"a batch of {n} transitions does not fit a buffer of {self.capacity}")
        dev = next(iter(self.data.values())).device
        pos = (self.idx + torch.arange(n, device=dev)) % self.capacity
        for k, v in batch.items():
            self.data[k][pos] = v.to(self.data[k].dtype)
        self.idx = (self.idx + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch_size: int, generator: torch.Generator | None = None,
               idx: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
        """`batch_size` transitions at uniform indices below the fill level
        drawn from `generator`, or at the given indices `idx`."""
        if idx is None:
            dev = next(iter(self.data.values())).device
            idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator, device=dev)
        return {k: v[idx] for k, v in self.data.items()}
