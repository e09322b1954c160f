"""FridoDiffusion: coarse-to-fine feature-pyramid latent diffusion, serving
side (port of ``frido_tpu/models/frido.py``).

One ``nn.Module`` whose children carry the original Lightning key tree:
``model.diffusion_model`` (the PyUNet), ``first_stage_model`` (the
MS-VQGAN) and ``cond_stage_model`` (the BERT encoder), so a state dict
made by ``frido_tpu_torch/io/jax_weights.py`` loads with ``strict=True``.

Public methods keep the JAX package's layout: latents NHWC
[B, H, W, C] (t2i f16f8: [B, 32, 32, 8]; layout2i f8f4: [B, 64, 64, 6]),
images NHWC [B, 256, 256, 3]. The model lives on
``device``: ``cuda`` unless the caller passes another (``"cpu"`` in the
tests, ``"meta"`` for shapes only).

``sample`` runs the JAX package's four samplers (PLMS, DDIM,
DPM-Solver++(2M), the full-T vanilla chain); ``encode_first_stage`` and
``decode_first_stage`` map images to scaled latents and back. With
``split_input_params`` (``ks``, ``stride``, optional ``vqf``) the UNet and
the decoder run tile by tile on latents wider than ``ks``
(``ops/tiling.py``).

Training (``models/frido.py:463-543`` of the JAX package):
``q_sample_stage`` noises one stage's channel window, ``p_losses`` is one
stage's eps loss, ``training_loss`` the ``stage_loss_ratio``-weighted sum
over the stages, ``init_scale_by_std`` sets each stage's scale factor to
1/std of one batch's latents. The first stage is frozen: it stays in eval
mode whatever ``train()`` is told, and encodes without a gradient. The
per-timestep ``logvar`` is a buffer, or a parameter with ``learn_logvar``.
``training/trainer.py`` runs the step. Not ported yet: pixel-space DDPM,
checkpoint loading and the image-log galleries.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.diffusion import samplers
from frido_tpu_torch.nn.layers import seed_init_
from frido_tpu_torch.ops.image import to_nchw, to_nhwc
from frido_tpu_torch.ops.tiling import tiled_apply
from frido_tpu_torch.schedules import DiffusionSchedule

_FRIDO_DEFAULTS: Dict[str, Any] = dict(
    timesteps=1000,
    beta_schedule="linear",
    image_size=32,
    channels=8,
    linear_start=1e-4,
    linear_end=2e-2,
    cosine_s=8e-3,
    given_betas=None,
    v_posterior=0.0,
    conditioning_key=None,
    parameterization="eps",
    scale_factor=1.0,
    adopted_scale_factor=False,
    adopted_scale_factor_value=None,
    specify_channels=(),
    loss_type="l2",
    original_elbo_weight=0.0,
    l_simple_weight=1.0,
    noise_mix_ratio=0.0,
    stage_loss_ratio=(0.5, 0.5),
    scale_by_std=False,
    cond_stage_trainable=False,
    num_timesteps_cond=1,
    use_ema=True,
    learn_logvar=False,
    logvar_init=0.0,
)


class DiffusionWrapper(nn.Module):
    """Holds the denoiser as ``diffusion_model`` (key ``model.diffusion_
    model.*``) and routes cross-attention conditioning into it."""

    def __init__(self, unet_config: Dict[str, Any], device=None):
        super().__init__()
        self.diffusion_model = instantiate_from_config(unet_config,
                                                       device=device)

    def forward(self, x, t, context=None, stage=0, spade_pre=None):
        return self.diffusion_model(x, t, context, stage, spade_pre)


class FridoDiffusion(nn.Module):
    """Built from a reference-format config node's ``params``; unknown keys
    (``plot_*``, ``monitor``, training settings) are kept in ``extra``.

    ``seed`` seeds the ``torch.Generator`` that initialises the weights
    (skipped on the ``meta`` device).
    """

    def __init__(self, first_stage_config: Optional[Dict[str, Any]] = None,
                 cond_stage_config: Any = "__is_unconditional__",
                 unet_config: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None, seed: int = 0, **kwargs: Any):
        super().__init__()
        if unet_config is None:
            raise ValueError("unet_config is required")
        if first_stage_config is None:
            raise NotImplementedError("pixel-space DDPM is not ported yet")
        self.device = resolve_device(device)
        for k, v in _FRIDO_DEFAULTS.items():
            setattr(self, k, kwargs.pop(k, v))
        self.extra = kwargs
        if cond_stage_config == "__is_unconditional__":
            self.conditioning_key = None
        elif self.conditioning_key is None:
            self.conditioning_key = "crossattn"
        if self.conditioning_key not in (None, "crossattn"):
            raise NotImplementedError(
                f"conditioning_key {self.conditioning_key!r} is not ported")

        self.schedule = DiffusionSchedule.create(
            given_betas=self.given_betas, beta_schedule=self.beta_schedule,
            timesteps=self.timesteps, linear_start=self.linear_start,
            linear_end=self.linear_end, cosine_s=self.cosine_s,
            v_posterior=self.v_posterior,
            parameterization=self.parameterization)

        self.first_stage_ddconfig = first_stage_config["params"]["ddconfig"]
        self.embed_dim_list: List[int] = list(
            first_stage_config["params"]["embed_dim"])
        self.num_stage = len(self.embed_dim_list)
        if len(self.stage_loss_ratio) != self.num_stage \
                and self.num_stage == 1:
            # the two-stage default ratio does not apply to one stage
            self.stage_loss_ratio = (1.0,)
        if self.loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type {self.loss_type!r}")
        self.model = DiffusionWrapper(unet_config, device=self.device)
        self.first_stage_model = instantiate_from_config(
            first_stage_config, device=self.device, seed=None)
        if isinstance(cond_stage_config, dict):
            self.cond_stage_model = instantiate_from_config(
                cond_stage_config, device=self.device)
        else:
            self.cond_stage_model = None

        if self.adopted_scale_factor_value is not None:
            self.scale_factors = np.asarray(self.adopted_scale_factor_value,
                                            np.float32)
        elif self.adopted_scale_factor:
            self.scale_factors = np.full((self.num_stage,), self.scale_factor,
                                         np.float32)
        else:
            self.scale_factors = np.asarray(self.scale_factor, np.float32)

        # per-timestep log-variance of the loss; a parameter (the optimizer
        # sees it, as the JAX package puts it in the params tree) only with
        # learn_logvar, else a buffer outside the state dict
        logvar = torch.full((self.timesteps,), float(self.logvar_init),
                            device=self.device)
        if self.learn_logvar:
            self.logvar = nn.Parameter(logvar)
        else:
            self.register_buffer("logvar", logvar, persistent=False)
        self._tables = {}

        seed_init_(self, seed, self.device)
        self.eval()

    def train(self, mode: bool = True) -> "FridoDiffusion":
        """Training mode for the denoiser and the cond stage; the frozen
        first stage stays in eval mode (no codebook EMA update, no Gumbel
        noise), as the JAX trainer encodes it deterministically."""
        super().train(mode)
        self.first_stage_model.eval()
        return self

    def _table(self, name: str) -> torch.Tensor:
        """A schedule array as an fp32 tensor on the model's device."""
        if name not in self._tables:
            self._tables[name] = torch.as_tensor(
                np.asarray(getattr(self.schedule, name), np.float32),
                device=self.device)
        return self._tables[name]

    # ------------------------------------------------------------------
    def _scale_latent(self, z: torch.Tensor, invert: bool) -> torch.Tensor:
        """Per-stage channel-block scaling (``models/frido.py:367-380``), in
        fp32 at least: a bf16 latent is promoted, as the JAX package's fp32
        factors promote it."""
        z = z.to(torch.promote_types(z.dtype, torch.float32))
        sf = self.scale_factors
        if sf.ndim == 0:
            return z / float(sf) if invert else z * float(sf)
        parts, start = [], 0
        for i, d in enumerate(self.embed_dim_list):
            if start + d <= z.shape[-1]:
                f = float(np.float32(1.0) / sf[i]) if invert else float(sf[i])
                parts.append(z[..., start:start + d] * f)
                start += d
        if start < z.shape[-1]:
            parts.append(z[..., start:])
        return torch.cat(parts, dim=-1)

    def get_learned_conditioning(self, tokens) -> torch.Tensor:
        """int token ids [B, T] -> per-token context [B, T, n_embed]. Under
        autograd, as the cond stage trains with the denoiser."""
        if self.cond_stage_model is None:
            raise ValueError("unconditional model has no cond stage")
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device, torch.long)
        return self.cond_stage_model(tokens)

    def _tiling(self, side: int) -> Optional[Dict[str, Any]]:
        """``split_input_params`` when a latent of this side is tiled."""
        sip = self.extra.get("split_input_params")
        return sip if sip and side > sip["ks"][0] else None

    def apply_model(self, x: torch.Tensor, t: torch.Tensor,
                    context: Optional[torch.Tensor], stage: int,
                    spade_pre=None) -> torch.Tensor:
        """eps-hat for NHWC ``x`` at timesteps ``t``; NHWC out. Under
        tiling each tile recomputes its SPADE tables (``spade_pre`` holds
        full-grid tables and is not used)."""
        if self.conditioning_key is None:
            context = None
        sip = self._tiling(x.shape[1])
        if sip:
            return tiled_apply(
                lambda tile: self.apply_model(tile, t, context, stage), x,
                ks=tuple(sip["ks"]), stride=tuple(sip["stride"]))
        out = self.model(to_nchw(x), t, context, stage, spade_pre)
        return to_nhwc(out)

    def spade_tables(self, x_cond: torch.Tensor, stage: int):
        """Stage-invariant SPADE tables from the frozen NHWC channels."""
        return self.model.diffusion_model.spade_tables(to_nchw(x_cond), stage)

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> the scaled NHWC diffusion latent [coarse | fine]."""
        return self._scale_latent(
            self.first_stage_model.encode_interface(x), invert=False)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor,
                           chunk: Optional[int] = None) -> torch.Tensor:
        """NHWC latent -> NHWC image, ``chunk`` samples at a time when
        ``chunk`` divides the batch (``models/frido.py:389-420``); otherwise
        the whole batch at once, with a warning. A latent wider than the
        tiling's ``ks`` decodes tile by tile, each tile to ``ks * vqf``
        pixels; chunking wraps the tiled decode."""
        z = self._scale_latent(z, invert=True)
        decode = self.first_stage_model.decode_interface
        sip = self._tiling(z.shape[1])
        if sip:
            dd = self.first_stage_ddconfig
            vqf = int(sip.get("vqf", 2 ** (len(dd["ch_mult"]) - 1)))
            decode = functools.partial(
                tiled_apply, decode, ks=tuple(sip["ks"]),
                stride=tuple(sip["stride"]), out_ch=dd["out_ch"], scale=vqf)
        b = z.shape[0]
        if chunk and b > chunk:
            if b % chunk == 0:
                return torch.cat([decode(z[i:i + chunk])
                                  for i in range(0, b, chunk)])
            warnings.warn(f"decode chunk {chunk} does not divide batch {b}; "
                          f"decoding the whole batch at once (peak device "
                          f"memory grows with the batch)")
        return decode(z)

    @torch.no_grad()
    def decode_first_stage_with_codes(self, z: torch.Tensor):
        """(NHWC images, per-scale int32 code grids) of a scaled latent, for
        codebook analysis."""
        return self.first_stage_model.decode_interface(
            self._scale_latent(z, invert=True), return_code=True)

    @torch.no_grad()
    def quantize_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Each stage's channel block of an unscaled NHWC latent through its
        codebook."""
        return self.first_stage_model.quantize_latent(z)

    # ------------------------------------------------------------------
    # training (models/frido.py:463-543)
    # ------------------------------------------------------------------
    def _window(self, stage: int):
        return (sum(self.embed_dim_list[:stage]),
                sum(self.embed_dim_list[:stage + 1]))

    def q_sample_stage(self, x_start: torch.Tensor, t: torch.Tensor,
                       stage: int, noise: torch.Tensor) -> torch.Tensor:
        """Channel-windowed forward noising of an NHWC latent: below the
        stage's window the channels are clean (with the noise_mix_ratio
        leak), inside it noised at t, above it pure noise."""
        start, end = self._window(stage)
        sqrt_ac = self._table("sqrt_alphas_cumprod")[t][:, None, None, None]
        sqrt_1mac = self._table("sqrt_one_minus_alphas_cumprod")[t][
            :, None, None, None]
        parts = []
        if start > 0:
            clean = x_start[..., :start]
            if self.noise_mix_ratio != 0.0:
                tau = self.noise_mix_ratio
                clean = (1 - tau) * clean + tau * noise[..., :start]
            parts.append(clean)
        parts.append(sqrt_ac * x_start[..., start:end]
                     + sqrt_1mac * noise[..., start:end])
        if end < x_start.shape[-1]:
            parts.append(noise[..., end:])
        return torch.cat(parts, dim=-1)

    def p_losses(self, z: torch.Tensor, context: Optional[torch.Tensor],
                 t: torch.Tensor, stage: int, noise: torch.Tensor,
                 compute_dtype=None):
        """One stage's eps loss over its channel window: (loss, logs).
        ``compute_dtype`` runs the UNet in that dtype; the loss math stays
        fp32."""
        start, end = self._window(stage)
        x_noisy = self.q_sample_stage(z, t, stage, noise)
        if compute_dtype is not None:
            x_noisy = x_noisy.to(compute_dtype)
            if context is not None:
                context = context.to(compute_dtype)
        model_out = self.apply_model(x_noisy, t, context, stage).float()
        target = noise if self.parameterization == "eps" else z
        target = target[..., start:end]   # the split head gives the window
        if self.loss_type == "l1":
            per = (model_out - target).abs()
        else:
            per = (model_out - target).square()
        loss_simple = per.mean(dim=(1, 2, 3))
        logvar_t = self.logvar[t]
        loss = loss_simple / torch.exp(logvar_t) + logvar_t
        loss = self.l_simple_weight * loss.mean()
        lvlb = (self._table("lvlb_weights")[t] * loss_simple).mean()
        loss = loss + self.original_elbo_weight * lvlb
        return loss, {f"loss_simple_stage{stage}": loss_simple.mean(),
                      f"loss_vlb_stage{stage}": lvlb}

    def training_loss(self, z: torch.Tensor, context: Optional[torch.Tensor],
                      t: torch.Tensor, noise: torch.Tensor,
                      compute_dtype=None):
        """The per-stage losses weighted by ``stage_loss_ratio``:
        (loss, logs)."""
        if len(self.stage_loss_ratio) != self.num_stage:
            raise ValueError(f"stage_loss_ratio {self.stage_loss_ratio} for "
                             f"{self.num_stage} stages")
        total, logs = 0.0, {}
        for s, ratio in enumerate(self.stage_loss_ratio):
            loss, d = self.p_losses(z, context, t, s, noise, compute_dtype)
            total = total + loss * ratio
            logs.update({k: v * ratio for k, v in d.items()})
        logs["loss"] = total
        return total, logs

    @torch.no_grad()
    def init_scale_by_std(self, images: torch.Tensor) -> np.ndarray:
        """Each stage's scale factor set to 1/std (the population std) of
        its channel block of one batch's unscaled latents; returns the new
        factors. A training script calls it before the first step."""
        if not self.scale_by_std:
            raise ValueError("init_scale_by_std needs scale_by_std")
        z = self.first_stage_model.encode_interface(
            images.to(self.device))
        factors, start = [], 0
        for d in self.embed_dim_list:
            std = z[..., start:start + d].float().std(correction=0)
            factors.append(1.0 / float(std))
            start += d
        self.scale_factors = np.asarray(factors, np.float32)
        return self.scale_factors

    @torch.no_grad()
    def sample(self, batch_size: int, context=None, uncond_context=None,
               steps: int = 200, eta: float = 1.0,
               guidance_scale: float = 1.0, sampler: str = "plms",
               x_T: Optional[torch.Tensor] = None,
               x_init: Optional[torch.Tensor] = None, compute_dtype=None,
               cfg_mode: str = "batched",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The coarse-to-fine chain (``models/frido.py:548-599``); returns
        the scaled NHWC latent.

        ``sampler``: ``plms``, ``ddim``, ``dpmpp`` or ``vanilla`` (the
        full-T chain; ``steps`` is then unused). ``eta`` must be 0 for PLMS
        and DPM-Solver++. ``x_T`` is adopted as a finished stage 0;
        ``x_init`` is the initial noise. Every random number comes from
        ``generator`` (``diffusion/samplers.py``). ``compute_dtype``
        (``torch.bfloat16`` on the card) runs the UNet in that dtype while
        the update math and schedule stay fp32; the SPADE tables are
        computed once per stage (per UNet call under tiling).
        """
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        cfg = samplers.SamplerConfig(
            schedule=self.schedule, num_steps=steps, eta=eta,
            guidance_scale=guidance_scale,
            embed_dim_list=tuple(self.embed_dim_list),
            specify_channels=tuple(self.specify_channels),
            num_stage=self.num_stage, kind=sampler, cfg_mode=cfg_mode)
        cd = compute_dtype
        if cd is not None:
            context = None if context is None else context.to(cd)
            uncond_context = (None if uncond_context is None
                              else uncond_context.to(cd))

        def eps_model(x, t, ctx, stage, spade_pre=None):
            x = x if cd is None else x.to(cd)
            return self.apply_model(x, t, ctx, stage, spade_pre).float()

        # the SPADE tables are full-grid: none under tiling
        stage_invariants = None
        if self.num_stage > 1 and not self.extra.get("split_input_params"):
            def stage_invariants(stage, x_cond):
                if stage == 0:
                    return None
                x_cond = x_cond if cd is None else x_cond.to(cd)
                return self.spade_tables(x_cond, stage)

        def on_device(t):
            return None if t is None else t.to(self.device, torch.float32)

        return samplers.sample(cfg, eps_model, shape, context, uncond_context,
                               x_T=on_device(x_T), x_init=on_device(x_init),
                               generator=generator, device=self.device,
                               stage_invariants=stage_invariants)
