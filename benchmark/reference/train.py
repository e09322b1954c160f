"""The diffusion training step of the reference: a frozen copy of the
port's ``training/trainer.py`` (one step: t and the noise drawn from the
step's generator, the frozen first stage's encode, the conditioning and
the stage-weighted loss with a gradient), ``training/optim.py`` (optax's
AdamW: eps outside the square root, bias corrections in fp32, the
learning rate taken at the count before the update, decoupled weight
decay) and ``training/ema.py`` (the shadow of the denoiser wrapper with
the ramp ``min(decay, (1 + n) / (10 + n))``), written per tensor.

The trainable set is every parameter outside ``first_stage_model``."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reference.frido import Frido

f32 = np.float32


def draws(generator: torch.Generator, batch: int, model: Frido
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t uniform in [0, T) and the NHWC fp32 noise, in that order, from
    ``generator`` (on its own device)."""
    t = torch.randint(0, model.schedule.num_timesteps, (batch,),
                      generator=generator, device=generator.device)
    shape = (batch, model.image_size, model.image_size, model.channels)
    noise = torch.randn(shape, generator=generator, device=generator.device)
    return t, noise


class Trainer:
    def __init__(self, model: Frido, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, ema_decay: float = 0.9999,
                 compute_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, \
            weight_decay
        self.ema_decay = ema_decay
        self.compute_dtype = compute_dtype
        model.first_stage_model.requires_grad_(False)
        self.params: List[Tuple[str, torch.nn.Parameter]] = [
            (n, p) for n, p in model.named_parameters()
            if not n.startswith("first_stage_model.")]
        self.mu = {n: torch.zeros_like(p) for n, p in self.params}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params}
        self.count = 0
        self.ema = {n: p.detach().clone()
                    for n, p in model.model.named_parameters()}
        self.ema_updates = 0

    def step(self, images: torch.Tensor, tokens: torch.Tensor,
             generator: torch.Generator) -> Dict[str, object]:
        """One step; returns the loss (a float) and the gradients (a dict
        of tensors, as the optimizer got them)."""
        m, cd = self.model, self.compute_dtype
        t, noise = draws(generator, images.shape[0], m)
        z = m.encode(images if cd is None else images.to(cd)).float()
        ctx = m.conditioning(tokens)
        loss, _ = m.training_loss(z, ctx, t, noise, cd)
        for _, p in self.params:
            p.grad = None
        loss.backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in self.params}
        self._adam(grads)
        self._ema()
        return {"loss": float(loss.detach()), "grads": grads}

    @torch.no_grad()
    def _adam(self, grads: Dict[str, torch.Tensor]) -> None:
        n = self.count + 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(n))
        bc2 = float(f32(1) - f32(self.b2) ** f32(n))
        lr = self.lr
        for name, p in self.params:
            g = grads[name]
            mu = self.mu[name].mul_(self.b1).add_(g * (1 - self.b1))
            nu = self.nu[name].mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + self.wd * p
            p.add_(-lr * upd)
        self.count = n

    @torch.no_grad()
    def _ema(self) -> None:
        self.ema_updates += 1
        k = f32(self.ema_updates)
        d = min(f32(self.ema_decay), (f32(1) + k) / (f32(10) + k))
        w = float(f32(1) - d)
        for name, p in self.model.model.named_parameters():
            s = self.ema[name]
            s.sub_((s - p) * w)
