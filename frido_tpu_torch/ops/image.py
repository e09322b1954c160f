"""Image resampling primitives on NCHW tensors (port of
``frido_tpu/ops/image.py``, which works on NHWC).

Semantics are those of ``F.interpolate(mode='nearest')`` and
``F.avg_pool2d(2, 2)``, which the original code calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous NCHW (the port's public tensors are NHWC)."""
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> an NHWC view."""
    return x.permute(0, 2, 3, 1)


def interpolate_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def interpolate_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize to (H, W): source index ``floor(dst * in / out)``,
    clipped, as the JAX package and torch's ``mode='nearest'`` compute."""
    h, w = x.shape[-2:]
    out_h, out_w = size
    if (out_h, out_w) == (h, w):
        return x
    rows = torch.floor(torch.arange(out_h, dtype=torch.float64) * (h / out_h))
    cols = torch.floor(torch.arange(out_w, dtype=torch.float64) * (w / out_w))
    rows = rows.long().clamp(0, h - 1).to(x.device)
    cols = cols.long().clamp(0, w - 1).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 2, 2)``."""
    return F.avg_pool2d(x, 2, 2)
