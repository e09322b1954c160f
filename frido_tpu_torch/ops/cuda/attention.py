"""Flash attention: the hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``frido_tpu/ops/pallas/attention.py:301``
``flash_attention`` (``_flash_forward`` :127, ``_flash_kernel`` :49).
Source: ``frido_tpu_torch/csrc/flash_attention.cu``, which says what bounds
it on the card (fp32 arithmetic at the decoder's d = 512 site) and how its
tiling handles d up to 512 in shared memory.

:func:`flash_attention` launches the kernel for CUDA tensors (fp32 or
bf16, d a multiple of 4 up to 512) and raises on anything it cannot take;
for CPU tensors it computes :func:`attention_plain`. Its backward
recomputes through :func:`attention_plain`, as ``_flash_bwd`` does
(``attention.py:177-181``): there is no backward kernel.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frido_tpu_torch.ops.cuda.build import library

_MAX_D = 512


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d]: fp32 scores and softmax,
    probabilities cast to q's dtype for the second product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v.to(q.dtype)).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    if not getattr(lib, "_frido_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.frido_flash_attention_f32,
                   lib.frido_flash_attention_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.frido_flash_error_string.argtypes = [ctypes.c_int]
        lib.frido_flash_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _check(q, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes fp32 or bf16, "
                        f"got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
    if q.dim() < 2 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [..., N, d] alike")
    d = q.shape[-1]
    if d % 4 or d > _MAX_D:
        raise ValueError(f"flash_attention kernel takes d % 4 == 0 and "
                         f"d <= {_MAX_D}, got d={d}")
    if q.shape[-2] == 0 or k.shape[-2] == 0:
        raise ValueError("flash_attention kernel needs N >= 1")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    _check(q, k, v)
    lead = q.shape[:-2]
    nq, d = q.shape[-2:]
    nk = k.shape[-2]
    q3 = q.reshape(-1, nq, d).contiguous()
    k3 = k.reshape(-1, nk, d).contiguous()
    v3 = v.reshape(-1, nk, d).contiguous()
    bh = q3.shape[0]
    if bh > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 "
                         f"batch*heads, got {bh}")
    for t in (q3, k3, v3):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs 16-byte aligned "
                             "tensors")
    out = torch.empty_like(q3)
    lib = _lib()
    fn = (lib.frido_flash_attention_f32 if q.dtype == torch.float32
          else lib.frido_flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                bh, nq, nk, d, float(scale), stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.frido_flash_error_string(rc).decode())
    flash_attention.launches += 1
    return out.reshape(*lead, nq, d)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_plain(qq, kk, vv, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), grad)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d] without the score matrix.

    CUDA tensors go to the kernel (or raise); CPU tensors take
    :func:`attention_plain`.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, float(scale))


flash_attention.launches = 0
