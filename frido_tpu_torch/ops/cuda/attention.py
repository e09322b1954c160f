"""Flash and short-sequence attention: the hand-written Hopper kernels
and their plain version.

- :func:`flash_attention` replaces the TPU kernel
  ``frido_tpu/ops/pallas/attention.py:301`` ``flash_attention``
  (``_flash_forward`` :127, ``_flash_kernel`` :49). Source:
  ``frido_tpu_torch/csrc/flash_attention.cu``, which says what bounds it on
  the card (arithmetic at the decoder's d = 512 site: 3xTF32 in fp32, bf16
  mma in bf16) and how its tiling holds d up to 512. It takes fp32 or bf16
  and d a multiple of 4 up to 512.
- :func:`smalls_attention` replaces the TPU kernel
  ``frido_tpu/ops/pallas/attention.py:282`` ``smalls_attention``
  (``_smalls_forward`` :233, ``_smalls_kernel`` :187): an exact softmax
  over whole score rows of at most 512 keys. Source:
  ``frido_tpu_torch/csrc/smalls_attention.cu``, which says how it splits
  the output columns over blocks to fill the card and streams q, k and v
  through shared memory in d chunks so that d = 960 fits. It takes fp32 or
  bf16 and any d.

:func:`flash_plan` and :func:`smalls_plan` choose each launch's grid,
output tile, copy width and shared memory on the host; the kernels' C
launchers check what they are given against their own layout.

Both launch their kernel for CUDA tensors and raise on anything they cannot
take; for CPU tensors they compute :func:`attention_plain`, whose rounding
of the probabilities to the inputs' dtype is the kernels' own. Their
backward recomputes through :func:`attention_plain`, as ``_flash_bwd`` and
``_smalls_bwd`` do (``attention.py:177-181``, ``:272-276``): there is no
backward kernel. ``.launches`` on each counts kernel launches;
``smalls_attention.calls`` counts its calls on any device.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from frido_tpu_torch.ops.cuda.build import library

_MAX_D = 512
_SMALLS_MAX_NK = 512
SM_COUNT = 132           # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448        # shared memory one block may opt in to (227 KB)


class Plan(NamedTuple):
    """One launch: grid (x: query tiles, y: output-column chunks, z: batch
    * heads), the [rows, cols] output tile of a block, the copy width in
    bytes (0: element by element) and the dynamic shared memory in bytes."""
    grid: Tuple[int, int, int]
    rows: int
    cols: int
    copy_bytes: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _copy_bytes(d: int, itemsize: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides a row."""
    return next((b for b in (16, 8, 4) if d * itemsize % b == 0), 0)


@functools.lru_cache(maxsize=1024)
def flash_plan(bh: int, nq: int, nk: int, d: int, itemsize: int) -> Plan:
    """All d columns a block, 8 warps; 64 query rows where that still gives
    a block for every SM (half the L2 traffic of 32 rows), else 32.

    The layout is ``flash_attention.cu``'s ``Layout``: the Q tile and a K
    tile of BK keys (32, or 16 in fp32 at 64 rows) with row stride dp + 4
    (fp32) or dp + 8 (bf16), a V tile with dp + 8, where dp is d padded to
    the mma depth (8 tf32, 16 bf16); four fp32 [rows, BK + 4] partial-score
    tiles and two [rows] rows of softmax state."""
    rows = 64 if bh * _cdiv(nq, 64) >= SM_COUNT else 32
    bk = 16 if itemsize == 4 and rows == 64 else 32
    dp = _round_up(d, 8 if itemsize == 4 else 16)
    ldqk = dp + (4 if itemsize == 4 else 8)
    ldv = dp + 8
    smem = (itemsize * ((rows + bk) * ldqk + bk * ldv)
            + 4 * (4 * rows * (bk + 4) + 2 * rows))
    return Plan((_cdiv(nq, rows), 1, bh), rows, d,
                _copy_bytes(d, itemsize), smem)


@functools.lru_cache(maxsize=1024)
def smalls_plan(bh: int, nq: int, nk: int, d: int, itemsize: int) -> Plan:
    """16 query rows and ``cols`` output columns a block, 4 warps.

    ``cols`` is the widest of 256, 128, 64, 32 (at most d rounded up to
    32) whose grid has a block for every SM; else 32. Each column chunk
    recomputes its rows' scores, so wider is cheaper once the card is
    full. The layout is ``smalls_attention.cu``'s ``Layout``: [16, nk
    rounded up to 32, + 4] fp32 score rows, then two stages, each the
    larger of a q + k d-chunk ((16 + nk rounded up to 8) rows of 36 fp32 /
    72 bf16) and a v tile (32 rows of cols + 8)."""
    tiles = bh * _cdiv(nq, 16)
    widths = [c for c in (256, 128, 64, 32) if c <= _round_up(d, 32)]
    cols = next((c for c in widths if tiles * _cdiv(d, c) >= SM_COUNT), 32)
    ldc = 36 if itemsize == 4 else 72
    stage = max((16 + _round_up(nk, 8)) * ldc, 32 * (cols + 8))
    smem = 4 * 16 * (_round_up(nk, 32) + 4) + 2 * stage * itemsize
    return Plan((_cdiv(nq, 16), _cdiv(d, cols), bh), 16, cols,
                _copy_bytes(d, itemsize), smem)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d]: fp32 scores and softmax,
    probabilities cast to q's dtype for the second product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v.to(q.dtype)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(name: str, prefix: str, fp32: bool, n_plan: int):
    """(kernel entry point, error-string function) of a built library."""
    lib = library(name)
    fn = getattr(lib, f"frido_{name}_{'f32' if fp32 else 'bf16'}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * n_plan + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"frido_{prefix}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


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


def _launch(name: str, prefix: str, planner, q: torch.Tensor,
            k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
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
    plan = planner(bh, nq, nk, d, q.element_size())
    # flash takes (rows, grid x, copy, smem); smalls (grid x, grid y,
    # cols, copy, smem)
    args = ((plan.rows, plan.grid[0]) if planner is flash_plan else
            (plan.grid[0], plan.grid[1], plan.cols)) + (
        plan.copy_bytes, plan.smem)
    fn, err = _entry(name, prefix, q.dtype == torch.float32, len(args))
    # the launch goes to the runtime's current device: switch only if q
    # lies on another one
    same = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                bh, nq, nk, d, float(scale), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err(rc).decode())
    return out.reshape(*lead, nq, d)


def _launch_flash(q, k, v, scale):
    _check("flash_attention", q, k, v)
    d = q.shape[-1]
    if d % 4 or d > _MAX_D:
        raise ValueError(f"flash_attention kernel takes d % 4 == 0 and "
                         f"d <= {_MAX_D}, got d={d}")
    out = _launch("flash_attention", "flash", flash_plan, q, k, v, scale)
    flash_attention.launches += 1
    return out


def _launch_smalls(q, k, v, scale):
    _check("smalls_attention", q, k, v)
    if k.shape[-2] > _SMALLS_MAX_NK:
        raise ValueError(f"smalls_attention kernel takes at most "
                         f"{_SMALLS_MAX_NK} keys, got {k.shape[-2]}")
    out = _launch("smalls_attention", "smalls", smalls_plan, q, k, v,
                  scale)
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


def _apply(q, k, v, scale, launch):
    """The kernel under autograd where a gradient is wanted, else the
    launch alone (the autograd node costs host time on every call)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, scale, launch)
    return launch(q, k, v, scale)


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
    return _apply(q, k, v, float(scale), _launch_flash)


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
    return _apply(q, k, v, float(scale), _launch_smalls)


smalls_attention.calls = 0
smalls_attention.launches = 0
