"""Samplers of the pyramid latent (port of
``frido_tpu/diffusion/samplers.py``): PLMS, DDIM, DPM-Solver++(2M) and the
full-T vanilla ancestral chain.

The latent is NHWC, [B, H, W, C], as at the JAX package's entry points.
Stages run coarse to fine; each samples only its channel window
[start, end), with the frozen channels below it (``prefix``) and the
untouched noise above it (``suffix``) reassembled around the window for
every model call, exactly as the JAX package does. Classifier-free
guidance runs either as one 2B-batched call (``cfg_mode='batched'``) or as
two calls back to back (``'sequential'``); both give the same numbers.
The JAX package's ``lax.scan`` over steps is a Python loop here, and the
per-step coefficients are fp32 numpy scalars computed as the JAX package
computes them.

Random numbers come from the caller's ``torch.Generator`` through
:func:`_noise` alone: the initial latent, then one draw per sampled stage
(``[S, *window]`` for DDIM with eta > 0, ``[T, *window]`` for the vanilla
chain; none for PLMS, DPM-Solver++ or eta = 0), in that order. Each is
drawn on the generator's own device and moved to the latent's, so a CPU
generator gives a run on the card the numbers of a run on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from frido_tpu_torch.ops.image import avg_pool_2x, interpolate_nearest_2x
from frido_tpu_torch.schedules import DDIMSchedule, DiffusionSchedule

EpsModel = Callable[..., torch.Tensor]
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    schedule: DiffusionSchedule
    num_steps: int = 200
    eta: float = 1.0
    guidance_scale: float = 1.0
    embed_dim_list: Sequence[int] = (4, 4)
    use_split_head: bool = True
    specify_channels: Sequence[int] = ()
    num_stage: int = 2
    kind: str = "plms"   # 'plms' | 'ddim' | 'dpmpp' | 'vanilla' (full-T)
    temperature: float = 1.0
    discretize: str = "uniform"
    keep_intermediates: bool = False
    cfg_mode: str = "batched"

    @property
    def offset(self) -> int:
        return self.specify_channels[0] if self.specify_channels else 0

    def window(self, stage: int) -> Tuple[int, int]:
        start = self.offset + sum(self.embed_dim_list[:stage])
        end = self.offset + sum(self.embed_dim_list[:stage + 1])
        return start, end


def _noise(generator: Optional[torch.Generator], shape: Tuple[int, ...],
           temperature: float, device) -> torch.Tensor:
    """Standard normal ``shape`` times ``temperature``, drawn on the
    generator's device and moved to ``device``; every random number of the
    sampler comes from here."""
    src = generator.device if generator is not None else device
    x = torch.randn(shape, generator=generator, device=src) * temperature
    return x.to(device)


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
    split-head UNet already returns only the stage's window, another UNet's
    full-width output is cut to it."""
    start, end = cfg.window(stage)
    off = cfg.offset
    gs = cfg.guidance_scale
    aux2 = _doubled(aux) if cfg.cfg_mode == "batched" else None

    def call(x_in, tb, ctx, a):
        if a is None:
            return eps_model(x_in, tb, ctx, stage)
        return eps_model(x_in, tb, ctx, stage, a)

    def guided(x_in, tb):
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

    def eps(x_w, tb):
        x = torch.cat([prefix, x_w, suffix], dim=-1)
        out = guided(x[..., off:] if off else x, tb)
        return out if cfg.use_split_head else out[..., start - off:end - off]

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


class _Steps:
    """The DDIM schedule in descending time, and the stage's noise: a
    [S, *window] draw when any sigma is non-zero; with eta = 0 every sigma
    is exactly 0 and nothing is drawn (``_scan_inputs``)."""

    def __init__(self, dd: DDIMSchedule, x_w: torch.Tensor, generator,
                 temperature: float):
        self.t = dd.timesteps[::-1]
        self.a_t = dd.alphas[::-1]
        self.a_prev = dd.alphas_prev[::-1]
        self.sqrt_1ma = dd.sqrt_one_minus_alphas[::-1]
        self.sigma = dd.sigmas[::-1]
        self.noise = None
        if float(np.max(np.abs(dd.sigmas))) != 0.0:
            self.noise = _noise(generator, (dd.num_steps,) + tuple(x_w.shape),
                                temperature, x_w.device)

    def tb(self, i: int, x_w: torch.Tensor) -> torch.Tensor:
        return torch.full((x_w.shape[0],), int(self.t[i]), dtype=torch.long,
                          device=x_w.device)

    def update(self, x_w: torch.Tensor, e_w: torch.Tensor, i: int
               ) -> torch.Tensor:
        return _ddim_update(x_w, e_w, self.a_t[i], self.a_prev[i],
                            self.sqrt_1ma[i], self.sigma[i],
                            None if self.noise is None else self.noise[i])


def _ddim_update(x_w, e_w, a_t, a_prev, sqrt_1ma, sigma, noise):
    """One DDIM x_t -> x_{t-1} update on the window (``ddim.py:242-263``),
    the scalar coefficients in fp32."""
    sigma = f32(sigma)
    pred_x0 = (x_w - float(sqrt_1ma) * e_w) / float(np.sqrt(f32(a_t)))
    dir_coef = float(np.sqrt(f32(1.0) - f32(a_prev) - sigma ** 2))
    x_prev = float(np.sqrt(f32(a_prev))) * pred_x0 + dir_coef * e_w
    if noise is not None:
        x_prev = x_prev + float(sigma) * noise
    return x_prev


def _plms_combine(order: int, e_t, h1, h2, h3):
    """Adams-Bashforth combination by history length."""
    if order == 0:
        return (3 * e_t - h1) / 2
    if order == 1:
        return (23 * e_t - 16 * h1 + 5 * h2) / 12
    return (55 * e_t - 59 * h1 + 37 * h2 - 9 * h3) / 24


def _sample_stage_plms(cfg, dd, eps, x_w, generator, emit):
    st = _Steps(dd, x_w, generator, cfg.temperature)
    S = dd.num_steps
    # step 0: pseudo improved Euler, two model calls (plms.py:286-290)
    e_t = eps(x_w, st.tb(0, x_w))
    x_half = st.update(x_w, e_t, 0)
    e_next = eps(x_half, st.tb(min(1, S - 1), x_w))
    x_w = st.update(x_w, (e_t + e_next) / 2, 0)
    zeros = torch.zeros_like(e_t)
    h1, h2, h3 = e_t, zeros, zeros
    for i in range(1, S):
        e_t = eps(x_w, st.tb(i, x_w))
        e_prime = _plms_combine(min(i, 3) - 1, e_t, h1, h2, h3)
        x_w = st.update(x_w, e_prime, i)
        h1, h2, h3 = e_t, h1, h2
        emit(x_w)
    return x_w


def _sample_stage_ddim(cfg, dd, eps, x_w, generator, emit):
    st = _Steps(dd, x_w, generator, cfg.temperature)
    for i in range(dd.num_steps):
        x_w = st.update(x_w, eps(x_w, st.tb(i, x_w)), i)
        emit(x_w)
    return x_w


def _sample_stage_vanilla(cfg, dd, eps, x_w, generator, emit):
    """Full-T ancestral p_sample chain on the stage window
    (``frido.py:1391-1418``): every timestep of the training schedule, x0
    clipped to [-1, 1], the posterior mean and log-variance, no noise at
    t = 0. ``emit`` gets the x0 composites (the progressive gallery)."""
    s = cfg.schedule
    T = s.num_timesteps
    noise = _noise(generator, (T,) + tuple(x_w.shape), cfg.temperature,
                   x_w.device)
    for i, t in enumerate(range(T - 1, -1, -1)):
        tb = torch.full((x_w.shape[0],), t, dtype=torch.long,
                        device=x_w.device)
        e_w = eps(x_w, tb)
        x0 = (float(s.sqrt_recip_alphas_cumprod[t]) * x_w
              - float(s.sqrt_recipm1_alphas_cumprod[t]) * e_w)
        x0 = x0.clamp(-1.0, 1.0)
        mean = (float(s.posterior_mean_coef1[t]) * x0
                + float(s.posterior_mean_coef2[t]) * x_w)
        if t > 0:
            std = np.exp(f32(0.5) * f32(s.posterior_log_variance_clipped[t]))
            x_w = mean + float(std) * noise[i]
        else:
            x_w = mean
        emit(x0)
    return x_w


def _sample_stage_dpmpp(cfg, dd, eps, x_w, generator, emit):
    """DPM-Solver++(2M) on the stage window: deterministic second-order
    multistep in the data-prediction (x0) form (Lu et al. 2022,
    arXiv:2211.01095, Algorithm 2). The first step is first order, and so
    is the last one when S < 15 (lower_order_final)."""
    S = dd.num_steps
    st = _Steps(dd, x_w, generator, cfg.temperature)   # eta = 0: no draw
    a_t = st.a_t.astype(f32)
    a_prev = st.a_prev.astype(f32)
    sig_t = np.sqrt(f32(1.0) - a_t)
    sig_prev = np.sqrt(f32(1.0) - a_prev)
    # half-log-SNR lambda = log(alpha_hat / sigma)
    lam_t = f32(0.5) * np.log(a_t / (f32(1.0) - a_t))
    lam_prev = f32(0.5) * np.log(a_prev / (f32(1.0) - a_prev))
    x0_prev = torch.zeros_like(x_w)
    h_prev = f32(0.0)
    for i in range(S):
        e_w = eps(x_w, st.tb(i, x_w))
        x0 = (x_w - float(sig_t[i]) * e_w) / float(np.sqrt(a_t[i]))
        h = f32(lam_prev[i] - lam_t[i])
        c = f32(1.0) / (f32(2.0) * (h_prev / h)) if h_prev > 0 else f32(0.0)
        if S < 15 and i == S - 1:
            c = f32(0.0)
        d = float(f32(1.0) + c) * x0 - float(c) * x0_prev
        x_w = (float(sig_prev[i] / sig_t[i]) * x_w
               - float(np.sqrt(a_prev[i]) * np.expm1(-h)) * d)
        x0_prev, h_prev = x0, h
        emit(x_w)
    return x_w


_STAGE_FNS = {"plms": _sample_stage_plms, "ddim": _sample_stage_ddim,
              "dpmpp": _sample_stage_dpmpp, "vanilla": _sample_stage_vanilla}


def sample(cfg: SamplerConfig, eps_model: EpsModel, shape: Tuple[int, ...],
           context=None, uncond_context=None,
           x_T: Optional[torch.Tensor] = None,
           x_init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           device=None, stage_invariants=None):
    """The coarse-to-fine chain; returns the final latent z_0 (still
    scaled; callers decode it), or with ``cfg.keep_intermediates`` the pair
    (z_0, [per sampled stage, the composites of every step stacked:
    [steps, *shape]]) (PLMS: steps 1..S-1; vanilla: the x0 composites).

    ``x_T``: adopted as a finished stage 0, whose sampling is skipped.
    ``x_init``: the initial noise, every stage sampled. Without either the
    initial noise is drawn from ``generator`` (on ``device``).
    ``stage_invariants``: optional ``f(stage, x_cond) -> aux`` computing
    per-stage loop-invariant model state (the SPADE tables) once per stage;
    ``aux`` is passed to ``eps_model`` as a 5th argument.
    """
    if cfg.kind not in _STAGE_FNS:
        raise ValueError(f"sampler {cfg.kind!r} is not one of "
                         f"{tuple(_STAGE_FNS)}")
    if cfg.kind in ("plms", "dpmpp") and cfg.eta != 0.0:
        raise ValueError("ddim_eta must be 0 for PLMS (plms.py:25-26) "
                         "and DPM-Solver++ (deterministic solver)")
    if x_T is not None and x_init is not None:
        raise ValueError("pass x_T or x_init, not both")
    dd = None
    if cfg.kind != "vanilla":  # vanilla runs the full training schedule
        dd = DDIMSchedule.create(cfg.schedule, cfg.num_steps, eta=cfg.eta,
                                 discretize=cfg.discretize)
    if x_T is not None:
        x = x_T
    elif x_init is not None:
        x = x_init
    else:
        x = _noise(generator, tuple(shape), 1.0, device)

    stage_fn = _STAGE_FNS[cfg.kind]
    intermediates: List[torch.Tensor] = []
    for s in range(cfg.num_stage):
        if x_T is not None and s == 0:
            continue  # adopt x_T as the finished stage 0 (plms.py:151-153)
        start, end = cfg.window(s)
        prefix, suffix = x[..., :start], x[..., end:]

        def assemble(x_w, _p=prefix, _s=suffix):
            return torch.cat([_p, x_w, _s], dim=-1)

        frames: List[torch.Tensor] = []
        emit = ((lambda x_w: frames.append(assemble(x_w)))
                if cfg.keep_intermediates else (lambda x_w: None))
        aux = None
        if stage_invariants is not None:
            aux = stage_invariants(s, prefix[..., cfg.offset:])
        eps = _make_eps_window(cfg, eps_model, context, uncond_context, s,
                               prefix, suffix, aux)
        x_w = stage_fn(cfg, dd, eps, x[..., start:end], generator, emit)
        if frames:
            intermediates.append(torch.stack(frames))
        x = _stage_smooth(cfg, assemble(x_w), s)
    if cfg.keep_intermediates:
        return x, intermediates
    return x
