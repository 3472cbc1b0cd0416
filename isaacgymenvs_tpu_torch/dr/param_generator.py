"""External physics-parameter generators for domain randomization (port of
isaacgymenvs_tpu/dr/param_generator.py).

The reference's `actor_params_generator` hook lets a user draw the physics
parameters from a joint distribution (full-covariance posteriors of NPDR /
BayesSim) instead of independently per parameter. Here a generator is a
callable `(generator, n) -> (n, P)` tensor, where `generator` is the env's
`torch.Generator`, `P = DomainRandomizer.num_extern_params()` and the slice
layout is `DomainRandomizer.param_info()`. Values are factors or offsets
under each spec's `operation`: they replace the independent draw, not the
absolute property value.
"""
from __future__ import annotations

import numpy as np
import torch


class FullCovarianceParamGenerator:
    """Gaussian with full covariance over the flat param vector.

    mean: (P,) vector; cov: (P, P) PSD matrix (or chol: (P, P) lower
    Cholesky factor directly). Optional lo/hi clip vectors keep samples
    inside physical bounds (e.g. from param_info()'s YAML ranges).
    """

    def __init__(self, mean, cov=None, chol=None, lo=None, hi=None):
        f32 = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32))
        self.mean = f32(mean)
        if chol is None:
            if cov is None:
                raise ValueError("need cov or chol")
            cov = np.asarray(cov, np.float64)
            try:
                chol = np.linalg.cholesky(cov)
            except np.linalg.LinAlgError:
                # positive SEMI-definite covariances (zero-variance dims)
                # get an eigen factor F with F F^T = cov
                w, v = np.linalg.eigh(cov)
                chol = v * np.sqrt(np.clip(w, 0.0, None))
        self.chol = f32(chol)
        self.lo, self.hi = f32(lo), f32(hi)

    def transform(self, z: torch.Tensor) -> torch.Tensor:
        """Standard-normal draws z (n, P) -> samples (n, P)."""
        on = lambda a: a.to(z.device)
        x = on(self.mean)[None, :] + z @ on(self.chol).T
        if self.lo is not None:
            x = torch.maximum(x, on(self.lo)[None, :])
        if self.hi is not None:
            x = torch.minimum(x, on(self.hi)[None, :])
        return x

    def __call__(self, generator: torch.Generator, n: int) -> torch.Tensor:
        z = torch.randn(n, self.mean.shape[0], generator=generator, device=generator.device)
        return self.transform(z)


class MixtureParamGenerator:
    """Mixture of full-covariance Gaussians (the shape of BayesSim's MDN
    posteriors): weights (K,), means (K, P), chols (K, P, P)."""

    def __init__(self, weights, means, chols, lo=None, hi=None):
        f32 = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32))
        w = f32(weights)
        self.weights = w / w.sum()
        self.means, self.chols = f32(means), f32(chols)
        self.lo, self.hi = f32(lo), f32(hi)

    def transform(self, comp: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Component indices comp (n,) and standard-normal draws z (n, P) -> samples (n, P)."""
        on = lambda a: a.to(z.device)
        x = on(self.means)[comp] + torch.einsum("npq,nq->np", on(self.chols)[comp], z)
        if self.lo is not None:
            x = torch.maximum(x, on(self.lo)[None, :])
        if self.hi is not None:
            x = torch.minimum(x, on(self.hi)[None, :])
        return x

    def __call__(self, generator: torch.Generator, n: int) -> torch.Tensor:
        dev = generator.device
        comp = torch.multinomial(self.weights.to(dev), n, replacement=True, generator=generator)
        z = torch.randn(n, self.means.shape[1], generator=generator, device=dev)
        return self.transform(comp, z)
