"""The precisions the reference computes in.

:func:`exact` is the reference's own: float32 with TF32 off for matmuls
and cuDNN convolutions. The controls put the reference in the program's
place one step below what the configuration states: :func:`tf32` for a
float32 part (TF32 on), bfloat16 for a part the program runs in float32
with TF32 allowed, and :func:`unet_fp8` for a bfloat16 part (every
product's input and weight rounded to float8 e4m3 with a per-tensor
scale, the product then taken in bfloat16)."""

from __future__ import annotations

import contextlib

import torch

from reference.layers import Quant, linear_layers

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest, back in ``t``'s dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn)
    return (q.float() / scale).to(t.dtype)


def unet_fp8(model) -> None:
    """Round every product of ``model``'s UNet through :func:`fp8`."""
    q = Quant()
    q.fn = fp8
    for layer in linear_layers(model.unet):
        layer.quant = q


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def exact():
    """float32 products in float32: TF32 off."""
    return _tf32(False)


def tf32():
    """float32 products in TF32."""
    return _tf32(True)
