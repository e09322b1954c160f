"""The image pipeline: crop and flip plans on the host, pixels on the
image's device (port of ``frido_tpu/data/transforms.py``).

:class:`ImagePipeline` draws the JAX package's crop rectangle and flip
coin from its ``random.Random`` in the JAX call order (``spec``: the crop
first, then the flip), so crop boxes and flips are the JAX package's
exactly. :meth:`ImagePipeline.apply` then does the pixel work on the
device the decoded uint8 image lies on: PIL's antialiased bilinear resize
(the shorter side to the target, or straight to a square), the crop, the
flip and ``x / 127.5 - 1``, in float32 throughout.

The resize is the triangle filter that PIL's ``Image.resize(...,
BILINEAR)`` and ``native/frido_native.cpp`` (``triangle_coeffs``) use:
support ``max(in / out, 1)``, the i-th output centred at
``(i + 0.5) * in / out``, taps normalised, written here as two separable
weight matrices applied by matmuls (horizontal pass, then vertical). Only
the rows and columns of the crop are computed. PIL rounds to uint8 after
each pass; this pipeline does not, like the native loader.

``random-2d`` crops in the source image and then resizes the crop, as
PIL's path does (the native loader's fused crop-and-resize reads pixels
outside the crop at its edges).
"""

from __future__ import annotations

import functools
import random
from typing import Optional, Tuple

import numpy as np
import torch

from frido_tpu_torch.data.helper_types import BoundingBox

# rw, rh, cx, cy, cw, ch, flip
Spec = Tuple[int, int, int, int, int, int, int]


def shorter_side_size(width: int, height: int, size: int) -> Tuple[int, int]:
    """torchvision ``Resize(int)``: the shorter side to ``size``, aspect
    kept -> (new width, new height)."""
    if width <= height:
        return size, max(int(round(size * height / width)), size)
    return max(int(round(size * width / height)), size), size


def center_crop_coords(width: int, height: int) -> BoundingBox:
    """The relative box of a centred square crop."""
    if width > height:
        w = height / width
        return 0.5 - w / 2, 0.0, w, 1.0
    h = width / height
    return 0.0, 0.5 - h / 2, 1.0, h


@functools.lru_cache(maxsize=512)
def pil_weights(in_size: int, out_size: int) -> np.ndarray:
    """float32 [out_size, in_size]: row i holds the normalised triangle
    taps of output i, computed in float32 as the native loader does."""
    f32 = np.float32
    scale = f32(in_size) / f32(out_size)
    support = max(scale, f32(1.0))
    center = (np.arange(out_size, dtype=f32) + f32(0.5)) * scale
    lo = np.maximum((center - support + f32(0.5)).astype(np.int64), 0)
    hi = np.minimum((center + support + f32(0.5)).astype(np.int64), in_size)
    j = np.arange(in_size)
    x = (j.astype(f32)[None, :] + f32(0.5) - center[:, None]) / support
    w = np.maximum(f32(1.0) - np.abs(x), f32(0.0))
    w *= (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    safe = np.where(total > 0, total, f32(1.0))
    return np.where(total > 0, w / safe, w).astype(f32)


@functools.lru_cache(maxsize=512)
def _weights_on(in_size: int, out_size: int, lo: int, n: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pil_weights(in_size, out_size)[lo:lo + n]).to(
        device)


def resize_crop(img: torch.Tensor, out_w: int, out_h: int, x0: int = 0,
                y0: int = 0, w: Optional[int] = None,
                h: Optional[int] = None) -> torch.Tensor:
    """The window [y0, y0 + h) x [x0, x0 + w) of ``img`` (uint8 or float
    [H, W, 3]) resized to (out_w, out_h) -> float32 [h, w, 3]."""
    in_h, in_w = img.shape[:2]
    w = out_w if w is None else w
    h = out_h if h is None else h
    x = img.to(torch.float32).permute(2, 0, 1)                # [3, H, W]
    if (in_w, in_h) == (out_w, out_h):
        x = x[:, y0:y0 + h, x0:x0 + w]
    else:
        wx = _weights_on(in_w, out_w, x0, w, img.device)
        wy = _weights_on(in_h, out_h, y0, h, img.device)
        x = torch.matmul(wy, torch.matmul(x, wx.t()))
    return x.permute(1, 2, 0)


class ImagePipeline:
    """crop_method in {'none', 'center', 'random-1d', 'random-2d', None};
    ``__call__`` returns (crop_bbox, flipped, float32 [S, S, 3] in
    [-1, 1]) on the image's device."""

    def __init__(self, target_image_size: int, crop_method: Optional[str],
                 random_flip: bool, seed: Optional[int] = None):
        assert crop_method in (None, "none", "center", "random-1d",
                               "random-2d")
        self.size = target_image_size
        self.crop_method = crop_method
        self.random_flip = random_flip
        self.rng = random.Random(seed)

    def spec(self, width: int, height: int):
        """The plan for a width x height image: (rw, rh, cx, cy, cw, ch,
        flip) as the JAX package's ``spec`` gives it (rw = 0: no
        shorter-side resize; cw = 0: no crop), the relative crop box and
        the flip (None without ``random_flip``)."""
        size = self.size
        crop_bbox = None
        m = self.crop_method
        rw = rh = cx = cy = cw = ch = 0
        if m in ("center", "random-1d"):
            rw, rh = shorter_side_size(width, height, size)
            if m == "center":
                crop_bbox = center_crop_coords(rw, rh)
                cx = int(round((rw - size) / 2))
                cy = int(round((rh - size) / 2))
            else:
                cx = self.rng.randint(0, max(rw - size, 0))
                cy = self.rng.randint(0, max(rh - size, 0))
                crop_bbox = (cx / rw, cy / rh, size / rw, size / rh)
            cw = ch = size
        elif m == "random-2d":
            max_size = min(width, height)
            csize = (max_size if max_size <= size
                     else self.rng.randint(size, max_size))
            cy = self.rng.randint(0, height - csize)
            cx = self.rng.randint(0, width - csize)
            crop_bbox = (cx / width, cy / height,
                         csize / width, csize / height)
            cw = ch = csize
        flipped = None
        if self.random_flip:
            flipped = self.rng.random() < 0.5
        return (rw, rh, cx, cy, cw, ch, int(bool(flipped))), crop_bbox, \
            flipped

    def apply(self, img: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The pixel work of ``spec`` on uint8 [H, W, 3] ``img``, on its
        device -> float32 [S, S, 3] in [-1, 1]."""
        rw, rh, cx, cy, cw, ch, flip = spec
        size = self.size
        if rw:                          # shorter side, then the crop
            out = resize_crop(img, rw, rh, cx, cy, cw, ch)
        elif cw:                        # random-2d: the crop, then resize
            out = resize_crop(img[cy:cy + ch, cx:cx + cw], size, size)
        else:                           # none: straight to the square
            out = resize_crop(img, size, size)
        if flip:
            out = out.flip(1)
        return out / 127.5 - 1.0

    def __call__(self, img: torch.Tensor):
        """Plan and apply at once (the JAX ``__call__``)."""
        h, w = img.shape[:2]
        spec, crop_bbox, flipped = self.spec(w, h)
        return crop_bbox, flipped, self.apply(img, spec)
