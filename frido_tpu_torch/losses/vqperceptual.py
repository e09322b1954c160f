"""VQ-GAN training loss: L1 + LPIPS + PatchGAN with the adaptive weight
(port of ``frido_tpu/losses/vqperceptual.py``).

``VQLPIPSWithDiscriminator`` holds the hyperparameters, the discriminator
and (with weights at ``FRIDO_TPU_VGG16`` / ``FRIDO_TPU_LPIPS``) the LPIPS
network; ``training/vqgan_trainer.py`` assembles the generator and
discriminator phases and the adaptive weight from its pieces:
``nll_loss`` (L1 + perceptual + the aux reconstructions' L1) and
``logits``. Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.losses.discriminator import NLayerDiscriminator
from frido_tpu_torch.losses.lpips import (LPIPS, load_lpips_weights,
                                          lpips_available)
from frido_tpu_torch.nn.layers import seed_init_
from frido_tpu_torch.ops.image import to_nchw, to_nhwc


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    """``value`` before ``threshold`` steps, ``weight`` from then on."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


class VQLPIPSWithDiscriminator(nn.Module):
    """Config target ``taming.modules.losses.vqperceptual.
    VQLPIPSWithDiscriminator``. The module holds ``discriminator`` and,
    when ``perceptual_weight > 0`` and the LPIPS weights are available,
    ``perceptual_loss`` (loaded from the local paths); without them it
    warns and trains with ``perceptual_weight = 0``, as the JAX package
    does. Lives on ``device`` (the card unless the caller passes another);
    ``seed`` initialises the discriminator."""

    def __init__(self, disc_start, codebook_weight=1.0, pixelloss_weight=1.0,
                 disc_num_layers=3, disc_in_channels=3, disc_factor=1.0,
                 disc_weight=1.0, perceptual_weight=1.0, use_actnorm=False,
                 disc_conditional=False, disc_ndf=64, disc_loss="hinge",
                 aux_downscale=4.0,
                 aux_loss_weight: Sequence[float] = (1.0, 0.0),
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r}")
        if disc_conditional:
            raise NotImplementedError("a conditional discriminator is not "
                                      "ported (no config sets it)")
        device = resolve_device(device)
        self.disc_start = disc_start
        self.codebook_weight = codebook_weight
        self.pixel_weight = pixelloss_weight
        self.disc_factor = disc_factor
        self.discriminator_weight = disc_weight
        self.perceptual_weight = perceptual_weight
        self.disc_loss = (hinge_d_loss if disc_loss == "hinge"
                          else vanilla_d_loss)
        self.aux_loss_weight = list(aux_loss_weight)
        self.use_lpips = perceptual_weight > 0 and lpips_available()
        if perceptual_weight > 0 and not self.use_lpips:
            warnings.warn(
                "LPIPS weights unavailable (set FRIDO_TPU_VGG16 / "
                "FRIDO_TPU_LPIPS); training with perceptual_weight=0.")
        self.discriminator = NLayerDiscriminator(
            disc_in_channels, disc_ndf, disc_num_layers, use_actnorm,
            device=device)
        seed_init_(self.discriminator, seed, device)
        if self.use_lpips:
            self.perceptual_loss = load_lpips_weights(LPIPS(device=device))

    def nll_loss(self, inputs: torch.Tensor, recons: torch.Tensor,
                 xrec_aux: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean of |x - x_rec| (+ perceptual_weight * LPIPS, + half the
        weighted aux L1s); returns (loss, logs)."""
        rec = (inputs - recons).abs()
        p_loss = torch.zeros((), device=inputs.device)
        if self.use_lpips:
            p = self.perceptual_loss(inputs, recons)
            rec = rec + self.perceptual_weight * p
            p_loss = p.mean()
        aux_loss = torch.zeros((), device=inputs.device)
        if xrec_aux is not None:
            for w, xa in zip(self.aux_loss_weight, xrec_aux):
                aux_loss = aux_loss + (inputs - xa).abs().mean() * w
            rec = rec + 0.5 * aux_loss
        loss = rec.mean()
        return loss, {"rec_loss": loss, "p_loss": p_loss,
                      "rec_aux_loss": aux_loss}

    def logits(self, x: torch.Tensor, update_stats: bool = True
               ) -> torch.Tensor:
        """Patch logits (NHWC) of NHWC images; in training mode the
        BatchNorms use this batch's statistics and, with ``update_stats``,
        update their running ones."""
        return to_nhwc(self.discriminator(to_nchw(x), update_stats))
