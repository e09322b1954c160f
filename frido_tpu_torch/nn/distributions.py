"""Diagonal Gaussian posterior of the KL-VAE first stage (port of
``frido_tpu/nn/distributions.py``), over NHWC moment tensors
[B, H, W, 2C]: mean, then log-variance, on the last axis.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _normal(shape, dtype, device,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal noise; every posterior draw goes through here, so a
    test can feed it another package's draws."""
    n = torch.randn(shape, generator=generator,
                    device=device if generator is None else generator.device)
    return n.to(device, dtype)


class DiagonalGaussianDistribution:
    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        if deterministic:
            self.std = self.var = torch.zeros_like(self.mean)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        return self.mean + self.std * _normal(
            self.mean.shape, self.mean.dtype, self.mean.device, generator)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None
           ) -> torch.Tensor:
        """KL to N(0, I), or to ``other``, summed per sample."""
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        if other is None:
            terms = self.mean ** 2 + self.var - 1.0 - self.logvar
        else:
            terms = ((self.mean - other.mean) ** 2 / other.var
                     + self.var / other.var - 1.0 - self.logvar
                     + other.logvar)
        return 0.5 * terms.sum(dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor,
            dims: Sequence[int] = (1, 2, 3)) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        return 0.5 * (math.log(2.0 * math.pi) + self.logvar
                      + (sample - self.mean) ** 2 / self.var).sum(
                          dim=tuple(dims))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, elementwise; tensors or floats."""
    logvar1, logvar2 = torch.as_tensor(logvar1), torch.as_tensor(logvar2)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))
