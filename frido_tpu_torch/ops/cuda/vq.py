"""VQ nearest-codebook argmin: the hand-written Hopper kernel and its plain
version.

Replaces the TPU kernel ``frido_tpu/ops/pallas/vq_pallas.py:74``
``vq_argmin`` (``_vq_kernel`` :30). Source:
``frido_tpu_torch/csrc/vq_argmin.cu``, which says what bounds it on the
card (fp32 arithmetic: 2*D+1 operations per row and code, a few bytes per
row), how the codebook is split across warps and the CTAs of a thread
block cluster, and how the parts' (distance, index) pairs are merged so
that the lowest index wins a tie. :func:`vq_plan` picks the rows a thread,
the warps a CTA, the CTAs a cluster and the codes a part on the host; the
C launcher checks the plan against its own layout. One launch per call.

Both versions use the kernel's formula, argmin_k(|e_k|^2 - 2 z.e_k) in
fp32, ties to the lowest index. :func:`vq_argmin` launches the kernel for
CUDA tensors (D of 3 or 4, the embed dims of the repo's configs) and raises on anything else it cannot
take; for CPU tensors it computes :func:`vq_argmin_plain`.
``vq_argmin.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from frido_tpu_torch.ops.cuda.build import (device_context, library,
                                            raw_stream)

_KERNEL_D = (3, 4)
MAX_SMEM = 232448        # shared memory one block may opt in to (227 KB)
CHUNK = 16               # codes between the scan's index updates
WARPS = 8                # warps a CTA, each scanning its own part
WAVE = 128               # CTAs a launch aims at: one an SM, a power of 2
MIN_PART = 64            # codes a part, where K allows


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor
                    ) -> torch.Tensor:
    """int32 [N] index of the nearest codebook row by |e|^2 - 2 z.e."""
    z32 = z_flat.float()
    e32 = codebook.float()
    esq = (e32 * e32).sum(dim=1)
    dist = esq[None, :] - 2.0 * torch.matmul(z32, e32.t())
    return dist.argmin(dim=1).to(torch.int32)


class VQPlan(NamedTuple):
    """One launch of ``csrc/vq_argmin.cu``: ``rows`` rows in each thread's
    registers (a warp owns 32 * rows rows, and so does the CTA); the
    codebook cut into ``warps`` x ``cluster`` parts of ``ks`` codes, part
    rank * warps + warp, staged in rounds of ``kr`` codes a part; ``smem``
    bytes of dynamic shared memory; ``grid`` CTAs in clusters of
    ``cluster``."""
    rows: int
    warps: int
    cluster: int
    ks: int
    kr: int
    smem: int
    grid: int

    @property
    def args(self):
        """The C launcher's plan arguments, in order."""
        return self.rows, self.warps, self.cluster, self.ks, self.kr, \
            self.smem


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem(d: int, warps: int, kr: int, rows: int) -> int:
    """As ``vq_argmin.cu``: the staged codes (16 bytes each for D = 3, 20
    for D = 4), the warps' (distance, index) per row, the CTA's."""
    return warps * kr * (16 if d == 3 else 20) + (warps + 1) * 32 * rows * 8


@functools.lru_cache(maxsize=256)
def vq_plan(n: int, k: int, d: int) -> VQPlan:
    """One CTA of 8 warps on each of 128 SMs, each thread scanning as many
    codes as that leaves (measured on the card: longer scans beat more
    CTAs, whose staging, re-scans and merges cost more than the last 4 SMs
    give): the fewest rows a thread (2, 4 or 8) whose row tiles do not
    exceed 128 CTAs, then the codebook over a cluster of up to 8 CTAs
    until the launch reaches 128 (parts of at least 64 codes where K
    allows). Parts are whole 16-code chunks; a part that does not fit the
    shared memory is staged in rounds."""
    if d not in _KERNEL_D or n < 1 or k < 1:
        raise ValueError(f"vq_plan: N {n}, K {k}, D {d}")
    rows = next((r for r in (2, 4) if _cdiv(n, 32 * r) <= WAVE), 8)
    tiles = _cdiv(n, 32 * rows)
    cluster = 1
    while (cluster < 8 and tiles * cluster < WAVE
           and k // (2 * cluster * WARPS) >= MIN_PART):
        cluster *= 2
    ks = _cdiv(_cdiv(k, cluster * WARPS), CHUNK) * CHUNK
    kr = ks
    while _smem(d, WARPS, kr, rows) > MAX_SMEM:
        kr = _cdiv(_cdiv(ks, _cdiv(ks, kr) + 1), CHUNK) * CHUNK
    ks = _cdiv(ks, kr) * kr
    return VQPlan(rows, WARPS, cluster, ks, kr, _smem(d, WARPS, kr, rows),
                  tiles * cluster)


def _lib() -> ctypes.CDLL:
    lib = library("vq_argmin")
    if not getattr(lib, "_frido_typed", False):
        lib.frido_vq_argmin.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.frido_vq_argmin.restype = ctypes.c_int
        lib.frido_vq_error_string.argtypes = [ctypes.c_int]
        lib.frido_vq_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def vq_argmin(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the L2-nearest codebook row for each latent: z [N, D],
    codebook [K, D] -> int32 [N]."""
    if z_flat.dim() != 2 or codebook.dim() != 2 \
            or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"vq_argmin takes z [N, D] and codebook [K, D], got "
                         f"{tuple(z_flat.shape)} and {tuple(codebook.shape)}")
    if z_flat.device.type == "cpu":
        return vq_argmin_plain(z_flat, codebook)
    if z_flat.device.type != "cuda" or codebook.device != z_flat.device:
        raise ValueError(f"vq_argmin: z on {z_flat.device}, codebook on "
                         f"{codebook.device}")
    n, d = z_flat.shape
    k = codebook.shape[0]
    if d not in _KERNEL_D:
        raise ValueError(f"vq_argmin kernel takes D in {_KERNEL_D}, got {d}")
    if n == 0 or k == 0:
        raise ValueError("vq_argmin kernel needs N >= 1 and K >= 1")
    z32 = z_flat.float().contiguous()
    e32 = codebook.float().contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=z_flat.device)
    plan = vq_plan(n, k, d)
    lib = _lib()
    with device_context(z_flat.device):
        rc = lib.frido_vq_argmin(z32.data_ptr(), e32.data_ptr(),
                                 idx.data_ptr(), n, k, d, *plan.args,
                                 raw_stream(z_flat.device))
    if rc != 0:
        raise RuntimeError("vq_argmin kernel launch failed: "
                           + lib.frido_vq_error_string(rc).decode())
    vq_argmin.launches += 1
    return idx


vq_argmin.launches = 0
