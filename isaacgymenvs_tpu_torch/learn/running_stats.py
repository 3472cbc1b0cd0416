"""Running mean/std normalizers (port of isaacgymenvs_tpu/learn/running_stats.py).

Parallel Welford/Chan merge of a batch's moments into the running ones.
"""
from __future__ import annotations

import dataclasses

import torch


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
    """Merge the moments of `batch` (reduced over ALL leading axes) into rms."""
    d = rms.mean.dim()
    red = tuple(range(batch.dim() - d))
    batch_mean = torch.mean(batch, dim=red)
    batch_var = torch.var(batch, dim=red, unbiased=False)
    batch_count = batch.numel() / max(rms.mean.numel(), 1)

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
