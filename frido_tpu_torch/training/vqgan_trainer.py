"""MS-VQGAN GAN training step: a generator phase and a discriminator phase
(port of ``frido_tpu/training/vqgan_trainer.py``).

Generator phase: the MS-VQGAN in training mode (``forward_with_aux`` with
``use_aux_loss``; the straight-through VQ), the reconstruction loss, and
the discriminator's logits of the reconstruction with this batch's
BatchNorm statistics, its running statistics left alone and its weights
out of the graph. The adaptive weight

    d_weight = clip(|grad_W(nll + cb q)| / (|grad_W(g)| + 1e-4), 0, 1e4)
               * disc_weight,   W = decoder.conv_out.weight

comes from two ``torch.autograd.grad`` calls on the kept graph and is
detached; then one backward of ``nll + cb q + d_weight * disc_factor * g``
and the generator's AdamW call. Discriminator phase: logits of the real
images, then of the detached reconstruction, each updating the running
statistics in that order, and the discriminator's AdamW call on
``disc_factor * d_loss``. ``disc_factor`` is 0 while ``step <
disc_start``. ``compute_dtype`` covers the encoder and the decoder only;
the losses, the discriminator and ``d_weight`` stay fp32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.nn as nn

from frido_tpu_torch.losses.discriminator import ActNorm
from frido_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
from frido_tpu_torch.training.optim import AdamW


@contextlib.contextmanager
def _frozen(module: nn.Module) -> Iterator[None]:
    """``module``'s parameters out of the autograd graph for the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


class VQGANTrainer:
    """The JAX package's ``VQGANTrainState`` with its step.

    ``opt_g`` is an :class:`AdamW` over every parameter of ``model``,
    ``opt_d`` over every parameter of ``loss`` (the discriminator, and the
    LPIPS network, which takes zero gradients there as in the JAX
    package). ``sample_images`` (NHWC) initialise the discriminator's
    ActNorms, as the JAX package's init batch does; without them the
    ActNorms not yet initialised stay at the identity, which is what a
    zero init batch gives. ``step`` starts at ``start_step``."""

    def __init__(self, model: nn.Module, loss: VQLPIPSWithDiscriminator,
                 opt_g: AdamW, opt_d: AdamW, use_aux_loss: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 sample_images: Optional[torch.Tensor] = None,
                 start_step: int = 0):
        self.model, self.loss = model, loss
        self.opt_g, self.opt_d = opt_g, opt_d
        self.use_aux_loss = use_aux_loss
        self.compute_dtype = compute_dtype
        self.step = start_step
        model.train()
        loss.train()
        if sample_images is not None:
            device = next(loss.discriminator.parameters()).device
            with torch.no_grad():
                loss.logits(sample_images.to(device), update_stats=False)
        for m in loss.modules():
            if isinstance(m, ActNorm):
                m.initialized = True

    def _generator(self, x: torch.Tensor):
        cd = self.compute_dtype
        xin = x if cd is None else x.to(cd)
        if self.use_aux_loss:
            dec, aux, qloss, _ = self.model.forward_with_aux(xin)
        else:
            (dec, qloss, _), aux = self.model(xin), None
        dec, qloss = dec.float(), qloss.float()
        if aux is not None:
            aux = [a.float() for a in aux]
        return dec, aux, qloss

    def train_step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on NHWC images ``x`` in [-1, 1]; returns the logs as
        detached tensors."""
        loss = self.loss
        cb = loss.codebook_weight
        disc_factor = 0.0 if self.step < loss.disc_start else loss.disc_factor

        # ---- generator phase ------------------------------------------
        with _frozen(loss):
            dec, aux, qloss = self._generator(x)
            nll, nll_logs = loss.nll_loss(x, dec, aux)
            g_loss = -loss.logits(dec, update_stats=False).mean()
            last = self.model.decoder.conv_out.weight
            nll_cb = nll + cb * qloss
            gn, = torch.autograd.grad(nll_cb, last, retain_graph=True)
            gg, = torch.autograd.grad(g_loss, last, retain_graph=True)
            d_weight = (torch.linalg.vector_norm(gn)
                        / (torch.linalg.vector_norm(gg) + 1e-4))
            d_weight = (d_weight.clamp(0.0, 1e4)
                        * loss.discriminator_weight).detach()
            total = nll_cb + d_weight * disc_factor * g_loss
            total.backward()
        self.opt_g.step()
        self.opt_g.zero_grad(set_to_none=True)

        # ---- discriminator phase --------------------------------------
        logits_real = loss.logits(x)
        logits_fake = loss.logits(dec.detach())
        d_loss = disc_factor * loss.disc_loss(logits_real, logits_fake)
        d_loss.backward()
        self.opt_d.step()
        self.opt_d.zero_grad(set_to_none=True)
        self.step += 1

        logs = {"aeloss": total, "nll_loss": nll, "quant_loss": qloss,
                "g_loss": g_loss, "d_weight": d_weight, "discloss": d_loss,
                "logits_real": logits_real.mean(),
                "logits_fake": logits_fake.mean()}
        logs.update(nll_logs)
        return {k: torch.as_tensor(v).detach() for k, v in logs.items()}
