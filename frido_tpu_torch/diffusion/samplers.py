"""PLMS sampling of the pyramid latent (port of
``frido_tpu/diffusion/samplers.py``, PLMS only).

The latent is NHWC, [B, H, W, C], as at the JAX package's entry points.
Stages run coarse to fine; each samples only its channel window
[start, end), with the frozen channels below it (``prefix``) and the
untouched noise above it (``suffix``) reassembled around the window for
every model call, exactly as the JAX package does. Classifier-free
guidance runs either as one 2B-batched call (``cfg_mode='batched'``) or as
two calls back to back (``'sequential'``); both give the same numbers.
The JAX package's ``lax.scan`` over steps is a Python loop here.

DDIM, DPM-Solver++ and the vanilla ancestral chain are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from frido_tpu_torch.ops.image import avg_pool_2x, interpolate_nearest_2x
from frido_tpu_torch.schedules import DDIMSchedule, DiffusionSchedule

EpsModel = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    schedule: DiffusionSchedule
    num_steps: int = 200
    guidance_scale: float = 1.0
    embed_dim_list: Sequence[int] = (4, 4)
    specify_channels: Sequence[int] = ()
    num_stage: int = 2
    cfg_mode: str = "batched"

    @property
    def offset(self) -> int:
        return self.specify_channels[0] if self.specify_channels else 0

    def window(self, stage: int) -> Tuple[int, int]:
        start = self.offset + sum(self.embed_dim_list[:stage])
        end = self.offset + sum(self.embed_dim_list[:stage + 1])
        return start, end


def _doubled(aux: Any) -> Any:
    """Precomputed tables tiled along the batch for the 2B CFG call."""
    if aux is None:
        return None
    if isinstance(aux, torch.Tensor):
        return torch.cat([aux, aux], dim=0)
    if isinstance(aux, dict):
        return {k: _doubled(v) for k, v in aux.items()}
    return type(aux)(_doubled(v) for v in aux)


def _make_eps_window(cfg: SamplerConfig, eps_model: EpsModel, context,
                     uncond_context, stage: int, prefix: torch.Tensor,
                     suffix: torch.Tensor, aux: Any = None):
    """eps(x_w, t) -> window-width eps with guidance folded in; the
    split-head UNet already returns only the stage's window."""
    off = cfg.offset
    gs = cfg.guidance_scale
    aux2 = _doubled(aux) if cfg.cfg_mode == "batched" else None

    def call(x_in, tb, ctx, a):
        if a is None:
            return eps_model(x_in, tb, ctx, stage)
        return eps_model(x_in, tb, ctx, stage, a)

    def eps(x_w, tb):
        x = torch.cat([prefix, x_w, suffix], dim=-1)
        x_in = x[..., off:] if off else x
        if gs != 1.0:
            if uncond_context is None:
                raise ValueError("guidance_scale != 1 requires "
                                 "unconditional conditioning")
            if cfg.cfg_mode == "sequential":
                e_u = call(x_in, tb, uncond_context, aux)
                e_c = call(x_in, tb, context, aux)
            else:
                out2 = call(torch.cat([x_in, x_in]), torch.cat([tb, tb]),
                            torch.cat([uncond_context, context]), aux2)
                e_u, e_c = out2.chunk(2, dim=0)
            return e_u + gs * (e_c - e_u)
        return call(x_in, tb, context, aux)

    return eps


def _stage_smooth(cfg: SamplerConfig, x: torch.Tensor, stage: int
                  ) -> torch.Tensor:
    """End-of-stage avg-pool -> nearest-upsample smoothing of the finished
    channel block."""
    if cfg.num_stage == 1:
        return x
    start, end = cfg.window(stage)
    k = cfg.num_stage - stage - 1
    blk = x[..., start:end].permute(0, 3, 1, 2)
    for _ in range(k):
        blk = avg_pool_2x(blk)
    for _ in range(k):
        blk = interpolate_nearest_2x(blk)
    return torch.cat([x[..., :start], blk.permute(0, 2, 3, 1), x[..., end:]],
                     dim=-1)


def _ddim_update(x_w, e_w, a_t, a_prev, sqrt_1ma):
    """One deterministic (sigma = 0) DDIM update on the window. The
    per-step coefficients are fp32 numpy scalars, computed in fp32 as the
    JAX package does."""
    f32 = np.float32
    sqrt_a_t = float(np.sqrt(f32(a_t)))
    dir_coef = float(np.sqrt(f32(1.0) - f32(a_prev)))
    sqrt_a_prev = float(np.sqrt(f32(a_prev)))
    pred_x0 = (x_w - float(sqrt_1ma) * e_w) / sqrt_a_t
    return sqrt_a_prev * pred_x0 + dir_coef * e_w


def _plms_combine(order: int, e_t, h1, h2, h3):
    """Adams-Bashforth combination by history length."""
    if order == 0:
        return (3 * e_t - h1) / 2
    if order == 1:
        return (23 * e_t - 16 * h1 + 5 * h2) / 12
    return (55 * e_t - 59 * h1 + 37 * h2 - 9 * h3) / 24


def _sample_stage_plms(dd: DDIMSchedule, eps, x_w: torch.Tensor
                       ) -> torch.Tensor:
    b = x_w.shape[0]
    S = dd.num_steps
    ts = dd.timesteps[::-1]
    a_t = dd.alphas[::-1]
    a_prev = dd.alphas_prev[::-1]
    sqrt_1ma = dd.sqrt_one_minus_alphas[::-1]

    def tb(i):
        return torch.full((b,), int(ts[i]), dtype=torch.long,
                          device=x_w.device)

    def update(x, e, i):
        return _ddim_update(x, e, a_t[i], a_prev[i], sqrt_1ma[i])

    # step 0: pseudo improved Euler, two model calls (plms.py:286-290)
    e_t = eps(x_w, tb(0))
    x_half = update(x_w, e_t, 0)
    e_next = eps(x_half, tb(min(1, S - 1)))
    x_w = update(x_w, (e_t + e_next) / 2, 0)
    zeros = torch.zeros_like(e_t)
    h1, h2, h3 = e_t, zeros, zeros
    for i in range(1, S):
        e_t = eps(x_w, tb(i))
        e_prime = _plms_combine(min(i, 3) - 1, e_t, h1, h2, h3)
        x_w = update(x_w, e_prime, i)
        h1, h2, h3 = e_t, h1, h2
    return x_w


def sample(cfg: SamplerConfig, eps_model: EpsModel, shape: Tuple[int, ...],
           context=None, uncond_context=None,
           x_init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           device=None, stage_invariants=None) -> torch.Tensor:
    """The coarse-to-fine chain; returns the final latent z_0 (still
    scaled; callers decode it).

    ``x_init``: the initial noise (else drawn from ``generator`` on
    ``device``). ``stage_invariants``: optional ``f(stage, x_cond) -> aux``
    computing per-stage loop-invariant model state (the SPADE tables) once
    per stage; ``aux`` is passed to ``eps_model`` as a 5th argument.
    """
    dd = DDIMSchedule.create(cfg.schedule, cfg.num_steps)
    if x_init is not None:
        x = x_init
    else:
        x = torch.randn(shape, generator=generator, device=device)
    for s in range(cfg.num_stage):
        start, end = cfg.window(s)
        prefix, suffix = x[..., :start], x[..., end:]
        aux = None
        if stage_invariants is not None:
            aux = stage_invariants(s, prefix[..., cfg.offset:])
        eps = _make_eps_window(cfg, eps_model, context, uncond_context, s,
                               prefix, suffix, aux)
        x_w = _sample_stage_plms(dd, eps, x[..., start:end])
        x = _stage_smooth(cfg, torch.cat([prefix, x_w, suffix], dim=-1), s)
    return x
