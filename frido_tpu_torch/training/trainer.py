"""Training and eval steps for FridoDiffusion (port of
``frido_tpu/training/trainer.py``).

One ``train_step`` draws t and the noise, encodes the batch through the
frozen first stage (no gradient, in ``compute_dtype``), runs the
conditioning and the per-stage windowed losses with a gradient, takes one
AdamW call and updates the EMA of the denoiser wrapper ``model.model``.

The trainable set is every parameter outside ``first_stage_model``: the
denoiser and the cond stage, whatever ``cond_stage_trainable`` says (the
JAX package never reads that field either). The first stage gets
``requires_grad=False`` and stays in eval mode.

Every random number of a step comes from :func:`_draw`, from the caller's
``torch.Generator`` (drawn on the generator's device and moved to the
model's), so a test can feed it another package's draws.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from frido_tpu_torch.training.ema import EMA
from frido_tpu_torch.training.optim import AdamW


def trainable_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) for everything outside ``first_stage_model``."""
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("first_stage_model.")]


def _draw(generator: Optional[torch.Generator], batch: int, timesteps: int,
          noise_shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """t uniform in [0, timesteps) per sample and fp32 NHWC standard normal
    noise; every random number of a step comes from here."""
    src = generator.device if generator is not None else device
    t = torch.randint(0, timesteps, (batch,), generator=generator,
                      device=src)
    noise = torch.randn(noise_shape, generator=generator, device=src)
    return t.to(device), noise.to(device)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device, dtype)


class DiffusionTrainer:
    """The JAX package's ``TrainState`` with its train and eval steps.

    ``optimizer`` is an :class:`AdamW` over :func:`trainable_parameters`
    (``training/optim.py``'s ``build_optimizer``). ``use_ema`` updates the
    shadow after every call, also the calls that only accumulate; ``remat``
    recomputes the diffusion loss's activations in the backward
    (``torch.utils.checkpoint``); ``compute_dtype`` runs the encode and the
    UNet in that dtype with fp32 weights, optimizer state and loss math.
    """

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 use_ema: bool = True, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.optimizer = optimizer
        self.use_ema = use_ema
        self.remat = remat
        self.compute_dtype = compute_dtype
        model.first_stage_model.requires_grad_(False)
        model.train()
        self.ema = EMA(model.model)
        self.step = 0

    @torch.no_grad()
    def load_state(self, state: Dict[str, object]) -> None:
        """Continue from a state carried across by
        ``io/jax_weights.jax_train_state_to_port``: weights, EMA and its
        counter, the optimizer's moments and counts, the step."""
        def tensors(sd):
            return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

        self.model.load_state_dict(tensors(state["params"]), strict=True)
        ema = tensors(state["ema"])
        if set(ema) != set(self.ema.shadow):
            raise KeyError("the EMA state does not cover the denoiser")
        for k, s in self.ema.shadow.items():
            s.copy_(ema[k])
        self.ema.num_updates = state["ema_updates"]
        adam, opt = state["adam"], self.optimizer
        mu, nu = tensors(adam["mu"]), tensors(adam["nu"])
        acc = tensors(adam["acc"]) if adam["acc"] is not None else None
        named = dict(self.model.named_parameters())
        params = [p for g in opt.param_groups for p in g["params"]]
        names = {id(p): n for n, p in named.items()}
        if set(mu) != {names[id(p)] for p in params}:
            raise KeyError("the Adam state does not cover the optimizer's "
                           "parameters")
        for p in params:
            st, n = opt._state(p), names[id(p)]
            st["mu"].copy_(mu[n])
            st["nu"].copy_(nu[n])
            if acc is not None:
                st["acc"].copy_(acc[n])
        opt.count = adam["count"]
        opt.mini_step = adam["mini_step"] or 0
        self.step = state["step"]

    def _batch(self, batch: Dict[str, object], dtype=None):
        m = self.model
        image = _as_tensor(batch["image"], m.device, torch.float32)
        if dtype is not None:
            image = image.to(dtype)
        tokens = batch.get("tokens")
        return image, tokens

    def _draws(self, batch: int, generator):
        m = self.model
        shape = (batch, m.image_size, m.image_size, m.channels)
        return _draw(generator, batch, m.timesteps, shape, m.device)

    def _context(self, tokens):
        if tokens is None:
            return None
        return self.model.get_learned_conditioning(tokens)

    def train_step(self, batch: Dict[str, object],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (``image``: NHWC [B, H, W, 3] in [-1, 1];
        ``tokens``: int [B, L], absent for an unconditional model); returns
        the logs as detached tensors."""
        m, cd = self.model, self.compute_dtype
        image, tokens = self._batch(batch, cd)
        t, noise = self._draws(image.shape[0], generator)
        z = m.encode_first_stage(image).float()
        ctx = self._context(tokens)

        def diffusion_loss(z, ctx, t, noise):
            return m.training_loss(z, ctx, t, noise, compute_dtype=cd)

        if self.remat:
            loss, logs = checkpoint(diffusion_loss, z, ctx, t, noise,
                                    use_reentrant=False)
        else:
            loss, logs = diffusion_loss(z, ctx, t, noise)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.use_ema:
            self.ema.update()
        self.step += 1
        return {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, object],
                  generator: Optional[torch.Generator] = None,
                  ema: bool = False) -> torch.Tensor:
        """The validation loss on ``batch`` in fp32 (``val/loss``), or with
        the EMA denoiser (``val/loss_ema``); t and the noise from
        ``generator`` alone."""
        m = self.model
        image, tokens = self._batch(batch)
        t, noise = self._draws(image.shape[0], generator)
        with self.ema.scope() if ema else contextlib.nullcontext():
            z = m.encode_first_stage(image)
            loss, _ = m.training_loss(z, self._context(tokens), t, noise)
        return loss
