"""3x3 / stride-1 / pad-1 convolution, plain and with the GroupNorm ->
SPADE -> SiLU prologue: the hand-written Hopper kernels and their plain
versions.

Replaces the TPU kernels ``frido_tpu/ops/pallas/conv_pallas.py:177``
``conv3x3_pallas`` (``_conv_kernel`` :74) and ``:376``
``conv3x3_norm_silu_pallas`` (``_fused_kernel`` :199). Source: one
implicit-GEMM kernel with a prologue template parameter,
``frido_tpu_torch/csrc/conv3x3.cu``, which says what bounds it on the card
(arithmetic) and how the prologue is applied as the input is staged, with
the zero padding after it. The fused op is two launches (statistics, then
the conv); it counts as one call.

Layouts are the port's: x [N, Cin, H, W], weight [Cout, Cin, 3, 3], bias
[Cout], all in the activation dtype (the caller casts, as ``Conv2d`` does);
the GroupNorm affine [Cin] and SPADE's gamma and beta [N, Cin, H, W].

The plain versions compute in fp32 and round once to the activation
dtype, as the kernels do: :func:`conv3x3_plain` adds the bias in fp32, and
:func:`conv3x3_norm_silu_plain` rounds the prologue's output once before
the conv (the Pallas kernel's single rounding, not ``_reference_fused``'s
three; in fp32 they are the same).

:func:`conv3x3` and :func:`conv3x3_norm_silu` launch the kernel for CUDA
tensors (fp32 or bf16) and raise on anything they cannot take; for CPU
tensors they compute the plain versions. Their backward recomputes through
the plain versions, as ``_conv_bwd`` and ``_make_fused``'s ``bwd`` do: there
is no backward kernel. ``.calls`` counts calls on any device,
``.launches`` the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from frido_tpu_torch.ops.cuda.build import library
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 conv + bias in fp32, rounded to x's dtype."""
    y = F.conv2d(x.float(), weight.float(), bias.float(), 1, 1)
    return y.to(x.dtype)


def conv3x3_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, nscale: torch.Tensor,
                            nbias: torch.Tensor, num_groups: int, eps: float,
                            gamma: Optional[torch.Tensor] = None,
                            beta: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """GroupNorm -> (SPADE x * (1 + gamma) + beta) -> SiLU in fp32, one
    rounding to x's dtype, then :func:`conv3x3_plain` (zero padding after
    the prologue)."""
    xn = group_norm_plain(x.float(), nscale, nbias, num_groups, eps)
    if gamma is not None:
        xn = xn * (1.0 + gamma.float()) + beta.float()
    return conv3x3_plain(F.silu(xn).to(x.dtype), weight, bias)


def _lib() -> ctypes.CDLL:
    lib = library("conv3x3")
    if not getattr(lib, "_frido_typed", False):
        for fn in (lib.frido_conv3x3_f32, lib.frido_conv3x3_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.frido_conv3x3_norm_silu_f32,
                   lib.frido_conv3x3_norm_silu_bf16):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.frido_conv3x3_error_string.argtypes = [ctypes.c_int]
        lib.frido_conv3x3_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _operands(x, weight, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or x.numel() == 0:
        raise ValueError(f"conv3x3 kernel takes x [N, Cin, H, W] and weight "
                         f"[Cout, Cin, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[0]
    if bias is None or tuple(weight.shape[1:]) != (x.shape[1], 3, 3) \
            or tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3 kernel: weight {tuple(weight.shape)} and "
                         f"bias {bias if bias is None else tuple(bias.shape)}"
                         f" do not fit x {tuple(x.shape)}")
    for t in (weight, bias):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("x, weight and bias must share dtype and device")
    xc, wc, bc = (t.detach().contiguous() for t in (x, weight, bias))
    n, _, h, w = xc.shape
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    return xc, wc, bc, out


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.frido_conv3x3_error_string(rc).decode())


def _launch_conv(x, weight, bias):
    xc, wc, bc, out = _operands(x, weight, bias)
    n, cin, h, w = xc.shape
    lib = _lib()
    fn = (lib.frido_conv3x3_f32 if x.dtype == torch.float32
          else lib.frido_conv3x3_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
                n, cin, h, w, out.shape[1], stream)
    _raise_on(lib, rc, "conv3x3")
    conv3x3.launches += 1
    return out


def _launch_fused(x, weight, bias, nscale, nbias, num_groups, eps, gamma,
                  beta):
    xc, wc, bc, out = _operands(x, weight, bias)
    n, cin, h, w = xc.shape
    if cin % num_groups:
        raise ValueError(f"channels {cin} not divisible by groups "
                         f"{num_groups}")
    if xc.data_ptr() % 16:
        raise ValueError("conv3x3_norm_silu kernel needs a 16-byte aligned "
                         "input")
    if nscale.shape != (cin,) or nbias.shape != (cin,):
        raise ValueError(f"norm affine {tuple(nscale.shape)}, "
                         f"{tuple(nbias.shape)} for {cin} channels")
    spade = () if gamma is None else (gamma, beta)
    for t in (nscale, nbias, *spade):
        if t.device != x.device:
            raise ValueError("x, the norm affine and the SPADE tables must "
                             "share a device")
    nw, nb = (t.detach().float().contiguous() for t in (nscale, nbias))
    tables = (0, 0)
    if spade:
        if gamma.shape != xc.shape or beta.shape != xc.shape:
            raise ValueError(f"SPADE tables {tuple(gamma.shape)}, "
                             f"{tuple(beta.shape)} for x {tuple(xc.shape)}")
        gc, bt = (t.detach().to(x.dtype).contiguous() for t in spade)
        tables = (gc.data_ptr(), bt.data_ptr())
    stats = torch.empty((2, n, cin), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = (lib.frido_conv3x3_norm_silu_f32 if x.dtype == torch.float32
          else lib.frido_conv3x3_norm_silu_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xc.data_ptr(), wc.data_ptr(), bc.data_ptr(), nw.data_ptr(),
                nb.data_ptr(), *tables, stats[0].data_ptr(),
                stats[1].data_ptr(), out.data_ptr(), n, cin, h, w,
                out.shape[1], num_groups, float(eps), stream)
    _raise_on(lib, rc, "conv3x3_norm_silu")
    conv3x3_norm_silu.launches += 1
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _launch_conv(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = conv3x3_plain(*inputs)
            return torch.autograd.grad(out, inputs, grad)


class _Conv3x3NormSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, nscale, nbias, gamma, beta, num_groups,
                eps):
        ctx.save_for_backward(x, weight, bias, nscale, nbias, gamma, beta)
        ctx.args = (num_groups, eps)
        return _launch_fused(x, weight, bias, nscale, nbias, num_groups, eps,
                             gamma, beta)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        with torch.enable_grad():
            x, weight, bias, nscale, nbias, gamma, beta = inputs
            out = conv3x3_norm_silu_plain(x, weight, bias, nscale, nbias,
                                          *ctx.args, gamma=gamma, beta=beta)
            live = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, live, grad))
        return (*(None if t is None else next(grads) for t in inputs),
                None, None)


def _device_of(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 conv + bias of NCHW ``x``, fp32 accumulate,
    result in x's dtype. CUDA tensors go to the kernel (or raise); CPU
    tensors take :func:`conv3x3_plain`."""
    conv3x3.calls += 1
    if _device_of(x, "conv3x3") == "cpu":
        return conv3x3_plain(x, weight, bias)
    return _Conv3x3.apply(x, weight, bias)


conv3x3.calls = 0
conv3x3.launches = 0


def conv3x3_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, nscale: torch.Tensor,
                      nbias: torch.Tensor, num_groups: int, eps: float,
                      gamma: Optional[torch.Tensor] = None,
                      beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm (affine ``nscale``, ``nbias``) -> optional SPADE
    modulation by per-pixel ``gamma``, ``beta`` (both or neither) -> SiLU
    -> 3x3 conv + bias, as one op. CUDA tensors go to the kernels (or
    raise); CPU tensors take :func:`conv3x3_norm_silu_plain`."""
    if (gamma is None) != (beta is None):
        raise ValueError("SPADE gamma and beta come together")
    conv3x3_norm_silu.calls += 1
    if _device_of(x, "conv3x3_norm_silu") == "cpu":
        return conv3x3_norm_silu_plain(x, weight, bias, nscale, nbias,
                                       num_groups, eps, gamma, beta)
    return _Conv3x3NormSilu.apply(x, weight, bias, nscale, nbias, gamma, beta,
                                  int(num_groups), float(eps))


conv3x3_norm_silu.calls = 0
conv3x3_norm_silu.launches = 0
