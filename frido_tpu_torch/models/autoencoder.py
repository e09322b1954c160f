"""Single-scale first stages: VQModel, VQModelInterface, AutoencoderKL and
IdentityFirstStage (port of ``frido_tpu/models/autoencoder.py``).

No shipped Frido config uses them (all take the multi-scale
``taming.models.msvqgan.*``); they complete the LDM-style first-stage
surface. Public tensors are NHWC, as in the JAX package; the convs run
NCHW inside. ``lossconfig``, ``ckpt_path`` and the other keys the JAX
wrapper pops are accepted and not built. Each model lives on ``device``
(the card unless the caller passes another) and draws its weights from
``seed`` (``None``: left for the caller).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.nn.distributions import DiagonalGaussianDistribution
from frido_tpu_torch.nn.layers import Conv2d, seed_init_
from frido_tpu_torch.nn.quantize import VectorQuantizer
from frido_tpu_torch.nn.vqgan import Decoder, Encoder
from frido_tpu_torch.ops.image import to_nchw, to_nhwc


class VQModel(nn.Module):
    """Single-scale VQGAN: Encoder, quant_conv, codebook, post_quant_conv,
    Decoder."""

    def __init__(self, ddconfig: Dict[str, Any], n_embed: int, embed_dim: int,
                 device: DeviceLike = None, seed: Optional[int] = 0,
                 **unused: Any):
        super().__init__()
        device = resolve_device(device)
        self.encoder = Encoder(**ddconfig, device=device)
        self.decoder = Decoder(**ddconfig, device=device)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=0.25,
                                        device=device)
        z_out = ddconfig["z_channels"] * (
            2 if ddconfig.get("double_z", True) else 1)
        self.quant_conv = Conv2d(z_out, embed_dim, 1, device=device)
        self.post_quant_conv = Conv2d(embed_dim, ddconfig["z_channels"], 1,
                                      device=device)
        seed_init_(self, seed, device)
        self.eval()

    def encode_prequant(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> NHWC pre-quantization latent."""
        return to_nhwc(self.quant_conv(self.encoder(to_nchw(x))))

    def encode(self, x: torch.Tensor):
        """NHWC image -> (NHWC quantized latent, loss, indices)."""
        return self.quantize(self.encode_prequant(x))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(quant))))

    def forward(self, x: torch.Tensor):
        quant, diff, idx = self.encode(x)
        return self.decode(quant), diff, idx

    # the diffusion convention: encode stops before the codebook, decode
    # quantizes first
    def encode_interface(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_prequant(x)

    def decode_interface(self, h: torch.Tensor,
                         force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            h = self.quantize(h)[0]
        return self.decode(h)


# the diffusion-convention config target, the same network
VQModelInterface = VQModel


class AutoencoderKL(nn.Module):
    """KL-VAE: Encoder (double_z), quant_conv to the moments of a diagonal
    Gaussian, post_quant_conv, Decoder."""

    def __init__(self, ddconfig: Dict[str, Any], embed_dim: int,
                 device: DeviceLike = None, seed: Optional[int] = 0,
                 **unused: Any):
        super().__init__()
        device = resolve_device(device)
        if not ddconfig.get("double_z", True):
            raise ValueError("AutoencoderKL needs double_z")
        self.encoder = Encoder(**ddconfig, device=device)
        self.decoder = Decoder(**ddconfig, device=device)
        self.quant_conv = Conv2d(2 * ddconfig["z_channels"], 2 * embed_dim, 1,
                                 device=device)
        self.post_quant_conv = Conv2d(embed_dim, ddconfig["z_channels"], 1,
                                      device=device)
        seed_init_(self, seed, device)
        self.eval()

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """NHWC image -> the posterior over NHWC latents."""
        return DiagonalGaussianDistribution(
            to_nhwc(self.quant_conv(self.encoder(to_nchw(x)))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(z))))

    def forward(self, x: torch.Tensor, sample_posterior: bool = True,
                generator: Optional[torch.Generator] = None):
        posterior = self.encode(x)
        z = posterior.sample(generator) if sample_posterior \
            else posterior.mode()
        return self.decode(z), posterior


class IdentityFirstStage:
    """Pass-through first stage."""

    def __init__(self, *args, vq_interface: bool = False, **kwargs):
        self.vq_interface = vq_interface

    def encode(self, x):
        return x

    def decode(self, x):
        return x

    def quantize(self, x):
        if self.vq_interface:
            return x, None, [None, None, None]
        return x

    def __call__(self, x):
        return x
