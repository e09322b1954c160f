"""MS-VQGAN first stage, decode side (port of
``frido_tpu/models/msvqgan.py``: ``decoder``, ``post_quant_conv``,
``ms_quantize``, ``decode_interface``).

The diffusion latent is stacked [coarse f16 | fine f8] (stage 0 is the
coarse block, quantized by ``ms_quantize.0``) while the trained decoder
consumes [fine | coarse]: ``decode_interface`` quantizes each block through
its own codebook and flips the order (``models/msvqgan.py:185-202``).

The encoder and the cross-scale fusion heads (``shared_decoder``,
``upsample``, ``shared_post_quant_conv``, ``ms_quant_conv``) are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn as nn

from frido_tpu_torch.nn.layers import Conv2d
from frido_tpu_torch.nn.quantize import VectorQuantizer
from frido_tpu_torch.nn.vqgan import Decoder


class DummyLoss:
    """Placeholder loss of a frozen first stage (config target
    ``taming.modules.losses.DummyLoss``)."""

    def __init__(self, *args, **kwargs):
        pass


class VQModelInterface(nn.Module):
    """Decode side of the MS-VQGAN in the diffusion convention (config
    target ``taming.models.msvqgan.VQModelInterface``); parameter names
    follow the torch tree. ``edconfig``, ``lossconfig`` and ``ckpt_path``
    are accepted and not used: the encoder is not ported, and the weights
    come from ``io/jax_weights.py`` or a seed."""

    def __init__(self, ddconfig: Dict[str, Any], n_embed: Sequence[int],
                 embed_dim: Sequence[int], device=None, **unused: Any):
        super().__init__()
        if len(n_embed) != len(embed_dim):
            raise ValueError("n_embed and embed_dim need one entry per scale")
        self.embed_dim = list(embed_dim)
        self.decoder = Decoder(**dict(ddconfig), device=device)
        self.ms_quantize = nn.ModuleList([
            VectorQuantizer(n, d, device=device)
            for n, d in zip(n_embed, embed_dim)])
        self.post_quant_conv = Conv2d(sum(embed_dim), ddconfig["z_channels"],
                                      1, device=device)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """NCHW [fine | coarse] quantized latent -> NCHW image."""
        return self.decoder(self.post_quant_conv(quant))

    def decode_interface(self, h: torch.Tensor, return_code: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Per-scale re-quantization, then decode.

        h: NHWC [B, H, W, sum(embed_dim)] diffusion latent [coarse | fine].
        Returns the NHWC image (and the per-scale int32 code grids).
        """
        quants, codes = [], []
        start = 0
        for quantizer, d in zip(self.ms_quantize, self.embed_dim):
            q, idx = quantizer(h[..., start:start + d])
            quants.append(q)
            codes.append(idx)
            start += d
        quant = torch.cat(quants[::-1], dim=-1)  # [fine | coarse]
        img = self.decode(quant.permute(0, 3, 1, 2).contiguous())
        img = img.permute(0, 2, 3, 1)
        return (img, codes) if return_code else img
