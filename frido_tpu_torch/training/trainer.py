"""Training and eval steps for FridoDiffusion (port of
``frido_tpu/training/trainer.py``).

One ``train_step`` draws t and the noise, encodes the batch through the
frozen first stage (no gradient, in ``compute_dtype``), runs the
conditioning and the per-stage windowed losses with a gradient, takes one
AdamW call and updates the EMA of the denoiser wrapper ``model.model``.

The trainable set is every parameter outside ``first_stage_model``: the
denoiser and the cond stage, whatever ``cond_stage_trainable`` says (the
JAX package never reads that field either). The first stage gets
``requires_grad=False`` and stays in eval mode. A pixel-space ``DDPM`` has
no first stage: its ``encode_first_stage`` is the (scaled) identity, so
the batch's ``image`` is the latent.

Every random number of a step comes from :func:`_draw`, from the caller's
``torch.Generator`` (drawn on the generator's device and moved to the
model's), so a test can feed it another package's draws.

Data parallelism (``world_size`` > 1, a process group joined by
``parallel/dist.py``): each rank's batch is its rows of the global batch;
every rank draws t and the noise of the whole global batch from the same
generator and keeps its own rows, so the ranks together draw what one
process would. After the backward, and before AdamW, the trainable
gradients are averaged over the ranks by explicit bucketed ``all_reduce``
calls (``dist.all_reduce_mean_``): the step calls
``model.training_loss``, not a wrapped module's ``forward``, so
``DistributedDataParallel``'s hooks would never fire. The logs are
averaged over the ranks too. Every rank then takes the same AdamW update
and the same EMA update, so weights and EMA stay equal on every rank.

Sharded training (``n_model`` > 1, ``fsdp``): the ranks form the JAX
package's data x model layout (``parallel/mesh.py``); the model is
sharded by ``parallel/fsdp.shard_model_`` before the EMA and AdamW's
moments are made, so both live on the same parts as the parameters. The
batch and the draws are the data index's rows (model ranks of a data row
see the same rows); a tensor-parallel layer all-gathers its output
channels in the forward (``parallel/tp.py``); with ``fsdp`` each unit of
the model (a block) gathers its parameters when it is called and
reduce-scatters its mean gradients inside the backward
(``parallel/fsdp.py``), so no rank holds every full parameter or gradient
at once; after the backward the step averages the replicated leaves'
gradients (``Sharding.finish_grads_``). The gradient means and the logs
run over the data ranks. Every forward of a sharded model (an eval, a
sample, the image log) goes through the units, so every rank of a data
group runs it alike; :meth:`weights` swaps the EMA's parts in for one.
``io/checkpoint.train_state`` gathers the full state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from frido_tpu_torch.parallel import dist, mesh
from frido_tpu_torch.parallel.fsdp import (MIN_SHARD_SIZE, resident_bytes,
                                           shard_model_)
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
    UNet in that dtype with fp32 weights, optimizer state and loss math;
    ``rank`` of ``world_size`` makes the step data-parallel, ``n_model``
    model ranks a data row make it tensor-parallel, ``fsdp`` shards the
    train state over the data ranks (leaves of ``min_size`` elements or
    more). Every rank builds it on a replicated model, before any step.
    """

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 use_ema: bool = True, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 rank: int = 0, world_size: int = 1, n_model: int = 1,
                 fsdp: bool = False, min_size: int = MIN_SHARD_SIZE):
        self.model = model
        self.rank = rank
        self.world_size = world_size
        self.layout = mesh.make_layout(world_size, rank, n_model)
        self.optimizer = optimizer
        self.use_ema = use_ema
        self.remat = remat
        self.compute_dtype = compute_dtype
        if model.first_stage_model is not None:
            model.first_stage_model.requires_grad_(False)
        model.train()
        self.sharding = (shard_model_(model, self.layout, fsdp, min_size)
                         if fsdp or world_size > 1 else None)
        self.ema = EMA(model.model)
        self.step = 0

    def weights(self, ema: bool = False):
        """The model with the EMA denoiser's weights (with ``ema``) inside
        the block; the FSDP units gather whatever is called in it."""
        return self.ema.scope() if ema else contextlib.nullcontext()

    def fsdp_counters(self) -> Dict[str, int]:
        """The FSDP units' gathers, reduce-scatters and peak full bytes
        since the last step began (empty without units)."""
        if self.sharding is None or not self.sharding.units:
            return {}
        return self.sharding.counters.as_dict()

    def state_bytes(self) -> int:
        """Bytes of the train state this rank holds at rest: the model's
        parameters, AdamW's moments (and accumulator) and the EMA."""
        opt = [t for st in self.optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor)]
        return resident_bytes(list(self.model.parameters()) + opt
                              + list(self.ema.shadow.values()))

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return (full if self.sharding is None
                else self.sharding.local(name, full))

    @torch.no_grad()
    def load_state(self, state: Dict[str, object]) -> None:
        """Continue from a state carried across by
        ``io/jax_weights.jax_train_state_to_port`` (numpy arrays) or saved
        by ``io/checkpoint.save_train_state`` (tensors): weights, EMA and
        its counter, the optimizer's moments and counts, the step."""
        def tensors(sd):
            return {k: v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v)) for k, v in sd.items()}

        self.model.load_state_dict(
            {k: self._local(k, v) for k, v in tensors(
                state["params"]).items()}, strict=True)
        ema = tensors(state["ema"])
        if set(ema) != set(self.ema.shadow):
            raise KeyError("the EMA state does not cover the denoiser")
        for k, s in self.ema.shadow.items():
            s.copy_(self._local("model." + k, ema[k]))
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
            st["mu"].copy_(self._local(n, mu[n]))
            st["nu"].copy_(self._local(n, nu[n]))
            if acc is not None:
                st["acc"].copy_(self._local(n, acc[n]))
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
        """This data index's rows of the global batch's t and noise."""
        m, lay = self.model, self.layout
        n = batch * lay.n_data
        shape = (n, m.image_size, m.image_size, m.channels)
        t, noise = _draw(generator, n, m.timesteps, shape, m.device)
        if lay.n_data == 1:
            return t, noise
        rows = dist.rank_rows(n, lay.data_index, lay.n_data)
        return t[rows], noise[rows]

    def _mean_over_ranks(self, logs: Dict[str, torch.Tensor]):
        if self.layout.n_data == 1:
            return logs
        keys = sorted(logs)
        flat = torch.stack([logs[k].detach().float() for k in keys])
        dist.all_reduce_mean_([flat], group=self.layout.data_group)
        return dict(zip(keys, flat.unbind()))

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
        if self.sharding is not None:
            self.sharding.counters.reset()
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
        if self.sharding is not None:
            self.sharding.finish_grads_(
                [p for g in self.optimizer.param_groups for p in g["params"]])
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.use_ema:
            self.ema.update()
        self.step += 1
        return self._mean_over_ranks({k: v.detach() for k, v in logs.items()})

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
        with self.weights(ema):
            z = m.encode_first_stage(image)
            loss, _ = m.training_loss(z, self._context(tokens), t, noise)
        return self._mean_over_ranks({"loss": loss})["loss"]
