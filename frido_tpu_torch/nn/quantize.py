"""Codebook vector quantizer on its lookup path (port of
``frido_tpu/nn/quantize.py::VectorQuantizer``).

Latents here are channel-last [..., e_dim], as the lookup takes them. The
commitment loss and the Gumbel / EMA variants are training-side and not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from frido_tpu_torch.nn.layers import Embed
from frido_tpu_torch.ops.vq import vq_lookup


class VectorQuantizer(nn.Module):
    def __init__(self, n_e: int, e_dim: int, device=None):
        super().__init__()
        self.embedding = Embed(n_e, e_dim, device=device)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_q with the straight-through estimator, int32 indices)."""
        z_q, idx = vq_lookup(z, self.embedding.weight)
        return z + (z_q - z).detach(), idx
