"""Running mean/std normalizers (port of isaacgymenvs_tpu/learn/running_stats.py).

Parallel Welford/Chan merge of a batch's moments into the running ones.
Under a process group the batch is the rank's block of the global batch,
and its moments are merged over the ranks first (`parallel.sharding.
batch_moments`, the JAX package's `pmean`), so every rank keeps the
normalizer one process would.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel.sharding import batch_moments


@dataclasses.dataclass
class RunningMeanStd:
    mean: torch.Tensor  # (d,) or ()
    var: torch.Tensor
    count: torch.Tensor  # () float

    @classmethod
    def create(cls, shape, device):
        """Zero mean, unit variance and a count of 1e-4, on `device`."""
        return cls(
            mean=torch.zeros(shape, device=device),
            var=torch.ones(shape, device=device),
            count=torch.tensor(1e-4, device=device),
        )


def rms_update(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Merge the moments of `batch` (reduced over ALL leading axes, and
    over the ranks of a process group) into rms."""
    batch_mean, batch_var, batch_count = batch_moments(batch, rms.mean.dim())

    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta * delta * rms.count * batch_count / tot
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def rms_normalize(rms: RunningMeanStd, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    y = (x - rms.mean) / torch.sqrt(rms.var + 1e-5)
    return torch.clamp(y, -clip, clip)


def rms_denormalize(rms: RunningMeanStd, y: torch.Tensor) -> torch.Tensor:
    return y * torch.sqrt(rms.var + 1e-5) + rms.mean
