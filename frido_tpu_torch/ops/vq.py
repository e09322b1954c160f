"""Vector-quantization codebook lookup (port of ``frido_tpu/ops/vq.py``).

For every latent vector find the nearest codebook entry and gather it. The
argmin is the hand-written kernel on CUDA (``ops/cuda/vq.py``) for every
call: at the decode lookup (K = 8192) each call is far above the size where
the JAX package switches to its Pallas kernel. On the CPU it is the
kernel's plain version. The gather stays outside the kernel, and the
argmin's inputs are detached, as at ``ops/vq.py:59-64``: the argmin is
piecewise constant and no gradient flows through it. ``FRIDO_PALLAS=0``
(``ops/cuda/dispatch.py``) takes the plain version everywhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [..., D], codebook [K, D] -> (z_q of z's shape and dtype, int32
    indices of shape z.shape[:-1])."""
    d = z.shape[-1]
    argmin = vq_argmin if dispatch.kernels_on() else vq_argmin_plain
    idx = argmin(z.detach().reshape(-1, d), codebook.detach())
    z_q = codebook.index_select(0, idx.long()).to(z.dtype)
    return z_q.reshape(z.shape), idx.reshape(z.shape[:-1])
