"""GroupNorm (+ SiLU): the hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``frido_tpu/ops/pallas/norm_pallas.py:130``
``group_norm_pallas`` (``_gn_forward`` :85, ``_gn_kernel`` :38). Source:
``frido_tpu_torch/csrc/group_norm.cu``, which says what bounds it on the
card (device-memory bytes) and how one block per (sample, group) reads its
contiguous NCHW run.

The plain version is :func:`frido_tpu_torch.ops.norm.group_norm`: one-pass
fp32 statistics with the variance clamped at 0, the affine folded into
per-channel vectors, optional SiLU, one cast back. The kernel computes the
same; the Pallas kernel does not clamp (``norm_pallas.py:58``), which
differs only where E[x^2] - E[x]^2 < 0 in fp32, e.g. a constant group.

:func:`group_norm` launches the kernel for CUDA tensors (fp32 or bf16) and
raises on anything it cannot take; for CPU tensors it computes the plain
version. Its backward recomputes through the plain version, as ``_gn_bwd``
does (``norm_pallas.py:142-147``): there is no backward kernel.
``group_norm.calls`` counts calls on any device, ``group_norm.launches``
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frido_tpu_torch.ops.cuda.build import library
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain


def _lib() -> ctypes.CDLL:
    lib = library("group_norm")
    if not getattr(lib, "_frido_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.frido_group_norm_f32, lib.frido_group_norm_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.frido_group_norm_error_string.argtypes = [ctypes.c_int]
        lib.frido_group_norm_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, fuse_silu: bool) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm kernel takes a non-empty [N, C, ...] "
                         f"tensor, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine of shape {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)} for {c} channels")
    for t in (weight, bias):
        if t.device != x.device:
            raise ValueError("x, weight and bias must share a device")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned tensor")
    w32 = weight.detach().float().contiguous()
    b32 = bias.detach().float().contiguous()
    out = torch.empty_like(xc)
    hw = xc.numel() // (n * c)
    lib = _lib()
    fn = (lib.frido_group_norm_f32 if x.dtype == torch.float32
          else lib.frido_group_norm_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xc.data_ptr(), w32.data_ptr(), b32.data_ptr(), out.data_ptr(),
                n, c, num_groups, hw, float(eps), int(fuse_silu), stream)
    if rc != 0:
        raise RuntimeError("group_norm kernel launch failed: "
                           + lib.frido_group_norm_error_string(rc).decode())
    group_norm.launches += 1
    return out


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, fuse_silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, fuse_silu)
        return _launch(x, weight, bias, num_groups, eps, fuse_silu)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww, bb = (t.detach().requires_grad_() for t in
                          (x, weight, bias))
            out = group_norm_plain(xx, ww, bb, *ctx.args)
            dx, dw, db = torch.autograd.grad(out, (xx, ww, bb), grad)
        return dx, dw, db, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               fuse_silu: bool = False) -> torch.Tensor:
    """GroupNorm over (group channels, spatial) of an [N, C, ...] tensor,
    fp32 compute, optional SiLU, result in x's dtype.

    CUDA tensors go to the kernel (or raise); CPU tensors take
    :func:`group_norm_plain`.
    """
    group_norm.calls += 1
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, fuse_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    return _GroupNorm.apply(x, weight, bias, int(num_groups), float(eps),
                            bool(fuse_silu))


group_norm.calls = 0
group_norm.launches = 0
