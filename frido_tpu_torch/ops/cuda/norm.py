"""GroupNorm (+ SiLU): the hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``frido_tpu/ops/pallas/norm_pallas.py:130``
``group_norm_pallas`` (``_gn_forward`` :85, ``_gn_kernel`` :38). Source:
``frido_tpu_torch/csrc/group_norm.cu``, which says what bounds it on the
card (device-memory bytes) and how each (sample, group) run is read from
device memory once: held in one CTA's registers, or cut into slices held
in shared memory by the CTAs of one thread block cluster, which add their
partial sums through distributed shared memory. :func:`group_norm_plan`
picks the path, the cluster, the slice, the threads and the shared memory
on the host; the C launcher checks the plan against its own layout. One
launch per call.

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
kernel launches. Without a gradient to record, a call skips the autograd
function and launches directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from frido_tpu_torch.ops.cuda.build import (device_context, library,
                                            raw_stream)
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain

MAX_SMEM = 232448        # shared memory one block may opt in to (227 KB)
MAX_SLICE_BYTES = 65536  # a CTA's slice in shared memory, at most
SLICE_BYTES = 32768      # the slice aimed at where a cluster allows
EXTRA_SMEM = 64          # the mbarriers and two partial sums
MAX_CLUSTER = 16         # CTAs a cluster (above 8: non-portable)
STREAM_THREADS = 512
# (threads, 4-element vectors a thread) of the register kernel, by size
REGS = ((256, 1), (512, 1), (512, 4), (512, 8), (1024, 8))


class GroupNormPlan(NamedTuple):
    """One launch of ``csrc/group_norm.cu``. ``vpt`` > 0: one CTA of
    ``threads`` threads per (sample, group) run, the run in registers,
    ``vpt`` 4-element vectors a thread. ``vpt`` 0: each run cut into
    ``cluster`` slices of ``slice`` elements, one CTA per slice with
    ``smem`` bytes of dynamic shared memory, the run's CTAs one thread
    block cluster. ``cluster`` 0: the run does not fit a cluster's shared
    memory, and one CTA per run streams it twice. ``ctas``: CTAs of work
    (the shared-memory launch runs as many clusters as the card holds,
    each looping over runs)."""
    cluster: int
    slice: int
    threads: int
    vpt: int
    smem: int
    ctas: int

    @property
    def args(self):
        """The C launcher's plan arguments, in order."""
        return self.cluster, self.slice, self.threads, self.vpt, self.smem


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def group_norm_plan(n: int, c: int, groups: int, hw: int,
                    itemsize: int) -> GroupNormPlan:
    """Registers where one CTA holds the run (H*W % 4 == 0, up to 1024
    threads x 8 vectors): the fewest threads and vectors that hold it.
    Else shared memory: the smallest cluster (1 to 16, a power of 2) whose
    slices (multiples of 8 elements, 16 bytes in both dtypes) fit 32 KB,
    or 64 KB at 16; 512 threads above 32 KB. A run over 16 x 64 KB takes
    the streaming path."""
    count = (c // groups) * hw
    runs = n * groups
    if hw % 4 == 0:
        for threads, vpt in REGS:
            if count <= threads * 4 * vpt:
                return GroupNormPlan(1, count, threads, vpt, 0, runs)
    for cluster in (1, 2, 4, 8, 16):
        slice_ = _cdiv(_cdiv(count, cluster), 8) * 8
        limit = MAX_SLICE_BYTES if cluster == MAX_CLUSTER else SLICE_BYTES
        if slice_ * itemsize <= limit:
            threads = 512 if slice_ * itemsize > SLICE_BYTES else 256
            return GroupNormPlan(cluster, slice_, threads, 0,
                                 slice_ * itemsize + EXTRA_SMEM,
                                 runs * cluster)
    return GroupNormPlan(0, 0, STREAM_THREADS, 0, 0, runs)


def _lib() -> ctypes.CDLL:
    lib = library("group_norm")
    if not getattr(lib, "_frido_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for fn in (lib.frido_group_norm_f32, lib.frido_group_norm_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.frido_group_norm_error_string.argtypes = [ctypes.c_int]
        lib.frido_group_norm_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _affine(t: torch.Tensor) -> torch.Tensor:
    """The affine vector as the kernel reads it: fp32, contiguous (as it is
    already, a parameter of the model, at no cost)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.detach().float().contiguous()


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
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must share a device")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned tensor")
    w32, b32 = _affine(weight), _affine(bias)
    out = torch.empty_like(xc)
    hw = xc.numel() // (n * c)
    plan = group_norm_plan(n, c, num_groups, hw, xc.element_size())
    lib = _lib()
    fn = (lib.frido_group_norm_f32 if x.dtype == torch.float32
          else lib.frido_group_norm_bf16)
    with device_context(x.device):
        rc = fn(xc.data_ptr(), w32.data_ptr(), b32.data_ptr(), out.data_ptr(),
                n, c, num_groups, hw, float(eps), int(fuse_silu), *plan.args,
                raw_stream(x.device))
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
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, int(num_groups), float(eps),
                                bool(fuse_silu))
    return _launch(x, weight, bias, int(num_groups), float(eps),
                   bool(fuse_silu))


group_norm.calls = 0
group_norm.launches = 0
