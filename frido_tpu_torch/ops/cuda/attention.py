"""Flash and short-sequence attention: the hand-written Hopper kernels
and their plain version.

- :func:`flash_attention` replaces the TPU kernel
  ``frido_tpu/ops/pallas/attention.py:301`` ``flash_attention``
  (``_flash_forward`` :127, ``_flash_kernel`` :49). Source:
  ``frido_tpu_torch/csrc/flash_attention.cu``, which says what bounds it on
  the card (fp32 arithmetic at the decoder's d = 512 site) and how its
  tiling handles d up to 512 in shared memory. It takes fp32 or bf16 and d
  a multiple of 4 up to 512.
- :func:`smalls_attention` replaces the TPU kernel
  ``frido_tpu/ops/pallas/attention.py:282`` ``smalls_attention``
  (``_smalls_forward`` :233, ``_smalls_kernel`` :187): an exact softmax
  over whole score rows of at most 512 keys. Source:
  ``frido_tpu_torch/csrc/smalls_attention.cu``, which says how it streams
  q, k and v through shared memory in d chunks so that d = 960 fits. It
  takes fp32 or bf16 and any d.

Both launch their kernel for CUDA tensors and raise on anything they cannot
take; for CPU tensors they compute :func:`attention_plain`, whose rounding
of the probabilities to the inputs' dtype is the kernels' own. Their
backward recomputes through :func:`attention_plain`, as ``_flash_bwd`` and
``_smalls_bwd`` do (``attention.py:177-181``, ``:272-276``): there is no
backward kernel. ``.launches`` on each counts kernel launches;
``smalls_attention.calls`` counts its calls on any device.
"""

from __future__ import annotations

import ctypes

import torch

from frido_tpu_torch.ops.cuda.build import library

_MAX_D = 512
_SMALLS_MAX_NK = 512


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d]: fp32 scores and softmax,
    probabilities cast to q's dtype for the second product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v.to(q.dtype)).to(q.dtype)


def _lib(name: str, prefix: str) -> ctypes.CDLL:
    lib = library(name)
    if not getattr(lib, "_frido_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        for fn in (getattr(lib, f"frido_{name}_f32"),
                   getattr(lib, f"frido_{name}_bf16")):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        err = getattr(lib, f"frido_{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _check(name, q, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes fp32 or bf16, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
    if q.dim() < 2 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [..., N, d] alike")
    if q.shape[-2] == 0 or k.shape[-2] == 0 or q.shape[-1] == 0:
        raise ValueError(f"{name} kernel needs N >= 1 and d >= 1")


def _launch(name: str, prefix: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, scale: float) -> torch.Tensor:
    lead = q.shape[:-2]
    nq, d = q.shape[-2:]
    nk = k.shape[-2]
    q3 = q.reshape(-1, nq, d).contiguous()
    k3 = k.reshape(-1, nk, d).contiguous()
    v3 = v.reshape(-1, nk, d).contiguous()
    bh = q3.shape[0]
    if bh > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 batch*heads, "
                         f"got {bh}")
    for t in (q3, k3, v3):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned tensors")
    out = torch.empty_like(q3)
    lib = _lib(name, prefix)
    fn = getattr(lib, f"frido_{name}_"
                 f"{'f32' if q.dtype == torch.float32 else 'bf16'}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                bh, nq, nk, d, float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + getattr(lib, f"frido_{prefix}_error_string")(rc).decode())
    return out.reshape(*lead, nq, d)


def _launch_flash(q, k, v, scale):
    _check("flash_attention", q, k, v)
    d = q.shape[-1]
    if d % 4 or d > _MAX_D:
        raise ValueError(f"flash_attention kernel takes d % 4 == 0 and "
                         f"d <= {_MAX_D}, got d={d}")
    out = _launch("flash_attention", "flash", q, k, v, scale)
    flash_attention.launches += 1
    return out


def _launch_smalls(q, k, v, scale):
    _check("smalls_attention", q, k, v)
    if k.shape[-2] > _SMALLS_MAX_NK:
        raise ValueError(f"smalls_attention kernel takes at most "
                         f"{_SMALLS_MAX_NK} keys, got {k.shape[-2]}")
    out = _launch("smalls_attention", "smalls", q, k, v, scale)
    smalls_attention.launches += 1
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, launch):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_plain(qq, kk, vv, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), grad)
        return dq, dk, dv, None, None


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
    return _Attention.apply(q, k, v, float(scale), _launch_flash)


flash_attention.launches = 0


def smalls_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d] for at most 512 keys, in
    one pass with the whole score rows on chip.

    CUDA tensors go to the kernel (or raise); CPU tensors take
    :func:`attention_plain`.
    """
    smalls_attention.calls += 1
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"smalls_attention: unsupported device {q.device}")
    return _Attention.apply(q, k, v, float(scale), _launch_smalls)


smalls_attention.calls = 0
smalls_attention.launches = 0
