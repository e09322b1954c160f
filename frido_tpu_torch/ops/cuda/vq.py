"""VQ nearest-codebook argmin: the hand-written Hopper kernel and its plain
version.

Replaces the TPU kernel ``frido_tpu/ops/pallas/vq_pallas.py:74``
``vq_argmin`` (``_vq_kernel`` :30). Source:
``frido_tpu_torch/csrc/vq_argmin.cu``, which says what bounds it on the
card (fp32 arithmetic: 2*D+1 operations per row and code, a few bytes per
row) and why one thread per row scanning codes in order needs no merge.

Both versions use the kernel's formula, argmin_k(|e_k|^2 - 2 z.e_k) in
fp32, ties to the lowest index. :func:`vq_argmin` launches the kernel for
CUDA tensors (D of 3 or 4, the embed dims of the repo's configs) and raises on anything else it cannot
take; for CPU tensors it computes :func:`vq_argmin_plain`.
``vq_argmin.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frido_tpu_torch.ops.cuda.build import library

_KERNEL_D = (3, 4)


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor
                    ) -> torch.Tensor:
    """int32 [N] index of the nearest codebook row by |e|^2 - 2 z.e."""
    z32 = z_flat.float()
    e32 = codebook.float()
    esq = (e32 * e32).sum(dim=1)
    dist = esq[None, :] - 2.0 * torch.matmul(z32, e32.t())
    return dist.argmin(dim=1).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = library("vq_argmin")
    if not getattr(lib, "_frido_typed", False):
        lib.frido_vq_argmin.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    lib = _lib()
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.frido_vq_argmin(z32.data_ptr(), e32.data_ptr(),
                                 idx.data_ptr(), n, k, d, stream)
    if rc != 0:
        raise RuntimeError("vq_argmin kernel launch failed: "
                           + lib.frido_vq_error_string(rc).decode())
    vq_argmin.launches += 1
    return idx


vq_argmin.launches = 0
