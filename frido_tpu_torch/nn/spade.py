"""SPADE: spatially-adaptive normalization (port of
``frido_tpu/nn/spade.py``), channel-first.

A GroupNorm followed by gamma/beta predicted from the previous pyramid
stage's feature map by 3x3 convs; this is how the fine stages are
conditioned on the already-denoised coarse stages.

A SPADE that never sees a feature map (``label_nc=None``: a stage-0
expert trunk's, or a one-stage model's) has only its parameter-free norm,
as the JAX package creates the modulation convs on their first call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv2d, GroupNorm
from frido_tpu_torch.ops.image import interpolate_nearest


class SPADE(nn.Module):
    def __init__(self, norm_nc: int, label_nc: Optional[int],
                 norm_eps: float = 1e-5, kernel_size: int = 3,
                 nhidden: int = 128, device=None):
        super().__init__()
        pw = kernel_size // 2
        self.param_free_norm = GroupNorm(norm_nc, eps=norm_eps, device=device)
        if label_nc is None:
            return
        # original: mlp_shared = Sequential(Conv2d, ReLU) -> key mlp_shared.0
        self.mlp_shared = nn.ModuleDict({"0": Conv2d(
            label_nc, nhidden, kernel_size, padding=pw, device=device)})
        self.mlp_gamma = Conv2d(nhidden, norm_nc, kernel_size, padding=pw,
                                device=device)
        self.mlp_beta = Conv2d(nhidden, norm_nc, kernel_size, padding=pw,
                               device=device)

    def gamma_beta(self, cond: torch.Tensor, hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The modulation tables at resolution ``hw``; during sampling they
        depend only on the frozen previous-stage channels, so the sampler
        computes them once per stage."""
        if not hasattr(self, "mlp_gamma"):
            raise ValueError("this SPADE has no modulation convs: its trunk "
                             "never sees a previous stage's feature map")
        cond = interpolate_nearest(cond, hw)
        actv = F.relu(self.mlp_shared["0"](cond))
        return self.mlp_gamma(actv), self.mlp_beta(actv)

    def _tables(self, x, cond, pre):
        if pre is None and cond is None:
            return None
        return pre if pre is not None else self.gamma_beta(
            cond, tuple(x.shape[-2:]))

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor],
                pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        normalized = self.param_free_norm(x)
        tables = self._tables(x, cond, pre)
        if tables is None:
            return normalized
        gamma, beta = tables
        return normalized * (1 + gamma) + beta

    def fused_args(self, x: torch.Tensor, cond: Optional[torch.Tensor],
                   pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> dict:
        """This norm as :class:`Conv2d`'s ``fused_norm``: the
        parameter-free norm's affine, groups and eps, and the (gamma, beta)
        tables, or none without ``cond`` and ``pre`` (stage 0)."""
        gamma, beta = self._tables(x, cond, pre) or (None, None)
        return self.param_free_norm.fused_args(gamma, beta)
