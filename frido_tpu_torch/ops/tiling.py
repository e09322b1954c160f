"""Tiled (patched) application of a spatial function (port of
``frido_tpu/ops/tiling.py``): run the UNet or the first-stage decoder on
latents larger than the training size, tile by overlapping tile, and blend
the tiles by their overlap count (``split_input_params``).

Tiles are NHWC slices at fixed positions; the last tile of each axis is
clamped flush to the edge.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def tile_positions(size: int, ks: int, stride: int) -> List[int]:
    """1-D tile starts covering [0, size); the last tile is clamped flush to
    the edge."""
    if ks >= size:
        return [0]
    pos = list(range(0, size - ks + 1, stride))
    if pos[-1] != size - ks:
        pos.append(size - ks)
    return pos


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                ks: Tuple[int, int], stride: Tuple[int, int],
                out_ch: Optional[int] = None,
                scale: int = 1) -> torch.Tensor:
    """Apply ``fn`` to each overlapping tile of NHWC ``x`` and average the
    overlaps.

    fn: [B, ks_h, ks_w, C] -> [B, ks_h*scale, ks_w*scale, out_ch]; its
    output width is taken from the first tile's result (``out_ch``, where
    given, must agree). Returns [B, H*scale, W*scale, out_ch] in x's dtype,
    blended in fp32.
    """
    b, h, w, _ = x.shape
    (kh, kw), (sh, sw) = ks, stride
    out = norm = None
    for y0 in tile_positions(h, kh, sh):
        for x0 in tile_positions(w, kw, sw):
            res = fn(x[:, y0:y0 + kh, x0:x0 + kw, :]).float()
            if out is None:
                if out_ch is not None and res.shape[-1] != out_ch:
                    raise ValueError(f"tile function gave {res.shape[-1]} "
                                     f"channels, not {out_ch}")
                out = res.new_zeros((b, h * scale, w * scale, res.shape[-1]))
                norm = res.new_zeros((h * scale, w * scale, 1))
            oy, ox = y0 * scale, x0 * scale
            oh, ow = kh * scale, kw * scale
            out[:, oy:oy + oh, ox:ox + ow, :] += res
            norm[oy:oy + oh, ox:ox + ow, :] += 1.0
    return (out / norm).to(x.dtype)
