"""Image resampling primitives (port of ``frido_tpu/ops/image.py``, which
works on NHWC).

``interpolate_nearest*`` and ``avg_pool_2x`` work on NCHW with the
semantics of ``F.interpolate(mode='nearest')`` and ``F.avg_pool2d(2, 2)``,
which the original code calls.

:func:`resize` is ``jax.image.resize`` (``linear`` / ``bilinear`` and
``cubic`` / ``bicubic``, ``antialias=True``), which the JAX package's
``SpatialRescaler`` and ``clip_preprocess`` call: per resized axis a weight
matrix as ``jax.image.scale_and_translate`` builds it, applied as one
product per axis. When it downsamples, the kernel is stretched by the
inverse scale (an antialiasing low-pass): bilinear x0.5 is a 4-tap
triangle, not ``F.interpolate``'s 2-tap; the cubic is Keys' with a = -0.5.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

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


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in_size, out_size] fp32 weights of one axis, in
    ``jax.image.scale_and_translate``'s order of fp32 operations: sample
    positions ``(i + 0.5) / scale - 0.5``, the kernel over the distances
    divided by ``max(1 / scale, 1)``, columns normalised to sum 1 (0 where
    the sum is below 1000 eps), 0 outside the input."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0) - np.float32(0.5))
    dist = np.abs(sample[None, :]
                  - np.arange(in_size, dtype=np.float32)[:, None])
    w = kernel(dist / kernel_scale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def resize(x: torch.Tensor, shape: Sequence[int],
           method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialiased): each axis
    whose size changes is contracted with its :func:`resize_weights`, in
    the input's dtype (integer inputs are resized in fp32)."""
    if method not in _KERNELS:
        raise NotImplementedError(f"resize method {method!r}")
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} for a {x.ndim}-d input")
    if not x.is_floating_point():
        x = x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(resize_weights(n_in, n_out, method)).to(
            x.device, x.dtype)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x
