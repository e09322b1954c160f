"""GroupNorm on channel-first tensors, mirroring ``group_norm_jnp``
(``frido_tpu/ops/norm.py:60-141``).

One-pass fp32 statistics E[x^2] - E[x]^2 with the variance clamped at 0,
the group stats and the affine folded into per-channel vectors, then an
optional SiLU, and the result cast back to the input dtype. Two epsilon
conventions coexist: 1e-5 in the UNet (guided-diffusion ``GroupNorm32``)
and 1e-6 in the VQGAN decoder and the SpatialTransformer norm.

This is the plain version of the group-norm kernel
(``ops/cuda/norm.py``), which computes the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               fuse_silu: bool = False) -> torch.Tensor:
    """GroupNorm over (group channels, spatial) of an [N, C, ...] tensor."""
    orig_dtype = x.dtype
    x = x.float()
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cg = c // num_groups
    spatial = tuple(range(2, x.ndim))
    count = cg
    for s in x.shape[2:]:
        count *= s
    s1 = x.sum(dim=spatial)                      # [N, C]
    s2 = (x * x).sum(dim=spatial)                # [N, C]
    mean = s1.view(n, num_groups, cg).sum(-1) / count   # [N, G]
    m2 = s2.view(n, num_groups, cg).sum(-1) / count
    var = torch.clamp(m2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(cg, dim=1)     # [N, C]
    mean_c = mean.repeat_interleave(cg, dim=1)
    w = inv_c * weight.float()[None, :]
    b = bias.float()[None, :] - mean_c * w
    bshape = (n, c) + (1,) * len(spatial)
    x = x * w.view(bshape) + b.view(bshape)
    if fuse_silu:
        x = F.silu(x)
    return x.to(orig_dtype)
