"""MS-VQGAN: the multi-scale feature-pyramid VQGAN first stage (port of
``frido_tpu/models/msvqgan.py``), one module (``MSFPNVQModel``, also the
``VQModelInterface`` config target) with two calling conventions:

* ``encode`` / ``decode`` / ``forward`` / ``forward_with_aux``, training
  semantics: per-scale quantization with cross-scale fusion, the quantized
  latent stacked **[fine | coarse]** on the finest grid;
* ``encode_interface`` / ``decode_interface``, diffusion semantics: encode
  gives the **pre-quantization** per-scale latents on the finest grid,
  stacked **[coarse | fine]** (with the JAX package's double reverse and
  ``channel_range``); decode quantizes each block through its own codebook,
  flips the stack to [fine | coarse], then post_quant_conv + Decoder.

The channel-order asymmetry is load-bearing: the diffusion latent is
[coarse | fine] (stage 0 is the coarse block, ``ms_quantize.0``) while the
trained decoder consumes [fine | coarse].

Cross-scale fusion (``_fused_prequant``): going coarse to fine, every
coarser quantized latent is upsampled by ``upsample.i`` (ConvTranspose2d,
k4 s2 p1) and ``shared_post_quant_conv.i`` (1x1), concatenated with this
scale's encoder output and run through ``shared_decoder.i`` (a one-level
Decoder at ``ch=128`` whose mid attention runs over this scale's grid)
before ``ms_quant_conv.i`` and the codebook.

Public tensors are NHWC, as in the JAX package; the convs run NCHW inside.
Parameter names follow the torch tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, seed_init_
from frido_tpu_torch.nn.quantize import VectorQuantizer
from frido_tpu_torch.nn.vqgan import Decoder, MSEncoder
from frido_tpu_torch.ops.image import interpolate_nearest_2x, to_nchw, to_nhwc

# the shared decoder of each fusion head (``models/msvqgan.py:90-95``)
SHARED_DECODER = dict(ch=128, ch_mult=(1,), num_res_blocks=2,
                      attn_resolutions=(2, 4, 8, 16, 32, 64), resolution=256,
                      dropout=0.0)


class DummyLoss:
    """Placeholder loss of a frozen first stage (config target
    ``taming.modules.losses.DummyLoss``)."""

    def __init__(self, *args, **kwargs):
        pass


class MSFPNVQModel(nn.Module):
    """The MS-VQGAN, built from a config node's ``params`` (config target
    ``taming.models.msvqgan.MSFPNVQModel``). ``lossconfig``, ``ckpt_path``,
    ``monitor`` and the other keys the JAX wrapper pops are accepted and not
    built: the weights come from ``io/jax_weights.py`` or from ``seed``
    (``None``: left for the caller, as ``FridoDiffusion`` does). It lives on
    ``device``: the card unless the caller passes another."""

    def __init__(self, edconfig: Dict[str, Any], ddconfig: Dict[str, Any],
                 n_embed: Sequence[int], embed_dim: Sequence[int],
                 quant_beta: float = 0.25, legacy: bool = True,
                 channel_range: Sequence[int] = (),
                 device: DeviceLike = None, seed: Optional[int] = 0,
                 **unused: Any):
        super().__init__()
        device = resolve_device(device)
        ed = dict(edconfig)
        n = len(n_embed)
        if n != ed["multiscale"] or n != len(embed_dim):
            raise ValueError("multiscale mode: n_embed and embed_dim need "
                             "one entry per scale")
        self.embed_dim = list(embed_dim)
        self.channel_range = tuple(channel_range or ())
        z_ch = list(ed["z_channels"])
        self.encoder = MSEncoder(**{**ed, "double_z": ed.get("double_z",
                                                             False)},
                                 device=device)
        self.decoder = Decoder(**dict(ddconfig), device=device)
        self.ms_quantize = nn.ModuleList([
            VectorQuantizer(k, d, quant_beta, legacy, device=device)
            for k, d in zip(n_embed, embed_dim)])
        # scale 0 quantizes the coarsest encoder head; every finer scale the
        # shared decoder's embed_dim[0] channels
        self.ms_quant_conv = nn.ModuleList([
            Conv2d(z_ch[-1] if i == 0 else embed_dim[0], embed_dim[i], 1,
                   device=device) for i in range(n)])
        self.post_quant_conv = Conv2d(sum(embed_dim), ddconfig["z_channels"],
                                      1, device=device)
        # as in the JAX package, the heads take the coarser scales at
        # embed_dim[0] channels (every config has two equal scales)
        self.upsample = nn.ModuleList([
            ConvTranspose2d(embed_dim[0], embed_dim[0], 4, 2, 1,
                            device=device) for _ in range(n - 1)])
        self.shared_post_quant_conv = nn.ModuleList([
            Conv2d(embed_dim[0], z_ch[0], 1, device=device)
            for _ in range(n - 1)])
        self.shared_decoder = nn.ModuleList([
            Decoder(**SHARED_DECODER, z_channels=sum(embed_dim[:i + 2]),
                    out_ch=embed_dim[0], device=device)
            for i in range(n - 1)])
        seed_init_(self, seed, device)
        self.eval()

    # ---- shared pre-quant pipeline -------------------------------------
    def _fused_prequant(self, x: torch.Tensor
                        ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]]:
        """NCHW image -> per-scale (pre-quant latent, quantized latent,
        both NCHW; loss; int32 indices), coarsest first."""
        h_ms = self.encoder(x)[::-1]          # coarse -> fine
        prev_h: List[torch.Tensor] = []
        per_scale = []
        for ii, h_enc in enumerate(h_ms):
            fused = h_enc
            if prev_h:
                for j in range(ii):           # overwritten at every scale
                    prev_h[j] = self.shared_post_quant_conv[ii - 1](
                        self.upsample[ii - 1](prev_h[j]))
                fused = self.shared_decoder[ii - 1](
                    torch.cat(prev_h + [h_enc], dim=1))
            h = self.ms_quant_conv[ii](fused)
            q, loss, idx = self.ms_quantize[ii](to_nhwc(h))
            quant = to_nchw(q)
            per_scale.append((h, quant, loss, idx))
            prev_h.append(quant)
        return per_scale

    @staticmethod
    def _to_finest(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Blocks ordered fine -> coarse: block i upsampled 2x, i times."""
        out = []
        for i, b in enumerate(blocks):
            for _ in range(i):
                b = interpolate_nearest_2x(b)
            out.append(b)
        return out

    # ---- training convention (MSFPNVQModel) ----------------------------
    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """NHWC image -> (NHWC [fine | coarse] quantized latent at the
        finest grid, the summed codebook loss, per-scale indices coarsest
        first)."""
        per_scale = self._fused_prequant(to_nchw(x))
        quants = self._to_finest([q for _, q, _, _ in per_scale][::-1])
        loss = sum(l for _, _, l, _ in per_scale)
        return (to_nhwc(torch.cat(quants, dim=1)), loss,
                [idx for *_, idx in per_scale])

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """NHWC [fine | coarse] quantized latent -> NHWC image."""
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(quant))))

    def forward(self, x: torch.Tensor):
        quant, diff, indices = self.encode(x)
        return self.decode(quant), diff, indices

    def forward_with_aux(self, x: torch.Tensor):
        """(image, [image of the coarse group alone, image of the fine group
        alone], loss, indices): the training forward with the two aux
        decodes, each with the other channel group zeroed."""
        quant, diff, indices = self.encode(x)
        fine_ch = quant.shape[-1] - self.embed_dim[-1]
        aux1 = quant.clone()
        aux1[..., :fine_ch] = 0.0       # keep the coarse group only
        aux2 = quant.clone()
        aux2[..., self.embed_dim[-1]:] = 0.0    # keep the fine group only
        return (self.decode(quant), [self.decode(aux1), self.decode(aux2)],
                diff, indices)

    # ---- diffusion convention (VQModelInterface) -----------------------
    def encode_interface(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> the pre-quantization per-scale latents upsampled
        to the finest grid, NHWC [coarse | fine]."""
        h_out = [h for h, *_ in self._fused_prequant(to_nchw(x))]
        if len(self.channel_range) == 2:
            lo, hi = (c // self.embed_dim[0] for c in self.channel_range)
            h_out = h_out[lo:hi]
        h_out = self._to_finest(h_out[::-1])[::-1]
        return to_nhwc(torch.cat(h_out, dim=1))

    def _quantize_blocks(self, h: torch.Tensor):
        """Each embed_dim block of an NHWC [coarse | fine] latent through
        its own codebook: (quantized blocks, int32 code grids)."""
        quants, codes = [], []
        start = 0
        for quantizer, d in zip(self.ms_quantize, self.embed_dim):
            q, _, idx = quantizer(h[..., start:start + d])
            quants.append(q)
            codes.append(idx)
            start += d
        return quants, codes

    def decode_interface(self, h: torch.Tensor, return_code: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Per-scale re-quantization, then decode.

        h: NHWC [B, H, W, sum(embed_dim)] diffusion latent [coarse | fine].
        Returns the NHWC image (and the per-scale int32 code grids).
        """
        quants, codes = self._quantize_blocks(h)
        img = self.decode(torch.cat(quants[::-1], dim=-1))  # [fine | coarse]
        return (img, codes) if return_code else img

    def quantize_latent(self, h: torch.Tensor) -> torch.Tensor:
        """Quantize an NHWC [coarse | fine] diffusion latent per scale, in
        place in the stack (quantize-denoised sampling)."""
        return torch.cat(self._quantize_blocks(h)[0], dim=-1)


# the diffusion-convention config target, the same network
VQModelInterface = MSFPNVQModel
