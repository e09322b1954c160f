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
``training/trainer.py`` runs the step.

Checkpoints: ``tokenize`` runs the cond stage's host tokenizer;
``load_torch_checkpoint`` loads a reference Lightning ``.ckpt`` in place
(``ignore_keys`` dropped first, the scalar ``scale_factor`` made a vector
under ``adopted_scale_factor``), as ``models/frido.py:344-362`` of the JAX
package.

Pixel-space DDPM (``first_stage_config`` None, ``models/frido.py:243-247``
of the JAX package; :class:`DDPM` is its config name): the pyramid is one
stage of ``channels``, encode and decode are the identity (with the scale
factor), the batch's ``image`` is the latent. Conditioning
(``conditioning_key``): none, ``crossattn`` or ``concat`` (an NHWC map
joined to the latent); ``hybrid`` and ``adm`` work through
:class:`DiffusionWrapper` and are refused here, where the JAX package
fails on them (see the messages).

Image logs (``models/frido.py:605-770`` of the JAX package):
``log_images`` gives the inputs, their reconstruction, the conditioning
drawn as an image (``utils/visualize.py``: captions and ``objects`` label
lists as text, ``objects_bbox`` as boxes) and, behind the config's
``plot_*`` gates (``extra``), samples (DDIM, or PLMS at eta 0), their
codebook-quantized decode, the diffusion and denoise galleries
(``log_rows``) and the progressive gallery of the full-T chain
(``log_progressive_rows``); every array NHWC float32 in [-1, 1] on the
host. Their random numbers come from the caller's generator through
``samplers._noise``, so a test can feed the JAX package's draws.
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
from frido_tpu_torch.parallel import fsdp
from frido_tpu_torch.schedules import DiffusionSchedule

_FRIDO_DEFAULTS: Dict[str, Any] = dict(
    timesteps=1000,
    first_stage_key="image",
    cond_stage_key="caption",
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
    ignore_keys=(),
)


CONDITIONING_KEYS = (None, "concat", "crossattn", "hybrid", "adm")


class DiffusionWrapper(nn.Module):
    """Holds the denoiser as ``diffusion_model`` (key ``model.diffusion_
    model.*``) and routes conditioning into it by ``conditioning_key``
    (``models/frido.py:40-92``): ``None`` none; ``concat`` the
    ``c_concat`` maps on the channels; ``crossattn`` the ``c_crossattn``
    token sequences, joined, as the context; ``hybrid`` both; ``adm`` the
    first ``c_crossattn`` entry as the class labels ``y``. NCHW."""

    def __init__(self, unet_config: Dict[str, Any],
                 conditioning_key: Optional[str] = "crossattn", device=None):
        super().__init__()
        if conditioning_key not in CONDITIONING_KEYS:
            raise ValueError(f"conditioning_key {conditioning_key!r} is not "
                             f"one of {CONDITIONING_KEYS}")
        self.conditioning_key = conditioning_key
        self.diffusion_model = instantiate_from_config(unet_config,
                                                       device=device)

    def forward(self, x, t, c_concat=None, c_crossattn=None, stage=0,
                spade_pre=None):
        ck, unet = self.conditioning_key, self.diffusion_model
        if ck in ("concat", "hybrid"):
            x = torch.cat([x] + list(c_concat), dim=1)
        context = None
        if ck in ("crossattn", "hybrid"):
            context = torch.cat(list(c_crossattn), dim=1)
        if ck == "adm":
            return unet(x, t, stage=stage, spade_pre=spade_pre,
                        y=c_crossattn[0])
        return unet(x, t, context, stage, spade_pre)

    def spade_tables(self, x_cond: torch.Tensor, stage: int):
        """The UNet's SPADE tables, each block gathered for its read where
        the model is sharded (``parallel/fsdp.py``)."""
        return self.diffusion_model.spade_tables(x_cond, stage,
                                                 scope=fsdp.gathered)


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
        self.device = resolve_device(device)
        for k, v in _FRIDO_DEFAULTS.items():
            setattr(self, k, kwargs.pop(k, v))
        self.extra = kwargs
        if cond_stage_config == "__is_unconditional__":
            self.conditioning_key = None
        elif self.conditioning_key is None:
            self.conditioning_key = "crossattn"
        if self.conditioning_key == "adm":
            raise ValueError(
                "conditioning_key 'adm' through FridoDiffusion: the JAX "
                "package feeds the cond stage's float embedding to the "
                "UNet's label_emb as class ids and fails in init_params "
                "('indices must have an integer type', frido_tpu/nn/"
                "pyunet.py:580); class labels work through "
                "DiffusionWrapper('adm') with integer y")
        if self.conditioning_key == "hybrid":
            raise ValueError(
                "conditioning_key 'hybrid' through FridoDiffusion: the JAX "
                "package's apply_model passes its one context as c_concat "
                "alone (frido_tpu/models/frido.py:125), so the token "
                "context is joined to the latent's channels and the concat "
                "fails in init_params; use DiffusionWrapper('hybrid') with "
                "both inputs")

        self.schedule = DiffusionSchedule.create(
            given_betas=self.given_betas, beta_schedule=self.beta_schedule,
            timesteps=self.timesteps, linear_start=self.linear_start,
            linear_end=self.linear_end, cosine_s=self.cosine_s,
            v_posterior=self.v_posterior,
            parameterization=self.parameterization)

        if first_stage_config is None:
            # pixel-space DDPM: no first stage, encode and decode are the
            # identity and the pyramid is one stage of every channel
            self.first_stage_ddconfig = None
            self.embed_dim_list: List[int] = [self.channels]
        else:
            self.first_stage_ddconfig = first_stage_config["params"][
                "ddconfig"]
            self.embed_dim_list = list(
                first_stage_config["params"]["embed_dim"])
        unet_params = unet_config.get("params", {})
        self.use_split_head = bool(unet_params.get("use_split_head", False))
        self.use_spade = bool(unet_params.get("use_SPADE_norm", False))
        self.num_stage = len(self.embed_dim_list)
        if len(self.stage_loss_ratio) != self.num_stage \
                and self.num_stage == 1:
            # the two-stage default ratio does not apply to one stage
            self.stage_loss_ratio = (1.0,)
        if self.loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type {self.loss_type!r}")
        self.model = DiffusionWrapper(unet_config, self.conditioning_key,
                                      device=self.device)
        self.first_stage_model = (
            None if first_stage_config is None else instantiate_from_config(
                first_stage_config, device=self.device, seed=None))
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
        if self.first_stage_model is not None:
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
                # JAX clamps an index past the end: a 1-vector (a scalar
                # checkpoint factor under adopted_scale_factor) scales
                # every stage
                s = sf[min(i, sf.shape[0] - 1)]
                f = float(np.float32(1.0) / s) if invert else float(s)
                parts.append(z[..., start:start + d] * f)
                start += d
        if start < z.shape[-1]:
            parts.append(z[..., start:])
        return torch.cat(parts, dim=-1)

    def get_learned_conditioning(self, tokens) -> torch.Tensor:
        """The cond stage's output for what ``tokenize`` gives: int token
        ids [B, T] (as int64), or float inputs such as the CLIP image
        embedder's images (as fp32). Under autograd, as the cond stage
        trains with the denoiser."""
        if self.cond_stage_model is None:
            raise ValueError("unconditional model has no cond stage")
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens)
        dtype = torch.float32 if tokens.is_floating_point() else torch.long
        return self.cond_stage_model(tokens.to(self.device, dtype))

    def tokenize(self, cond):
        """The cond stage's host tokenizer: captions, class ids, token ids
        or images -> the array ``get_learned_conditioning`` takes."""
        if self.cond_stage_model is None:
            raise ValueError("unconditional model has no cond stage")
        return self.cond_stage_model.tokenize(cond)

    def load_torch_checkpoint(self, path: str, strict: bool = False
                              ) -> Dict[str, Any]:
        """Load a reference Lightning ``.ckpt`` into this model in place:
        keys under ``ignore_keys`` prefixes are dropped; a ``scale_factor``
        sets the latent scale factors (a scalar becomes a 1-vector under
        ``adopted_scale_factor``); every tensor of the model is filled from
        its key (``io/torch_import.load_state_dict``; a missing key keeps
        the tensor's value unless ``strict``). Returns the report: ``used``
        and ``missing`` keys, and the checkpoint itself under
        ``state_dict`` (the caller may want its ``model_ema.*``)."""
        from frido_tpu_torch.io.torch_import import (load_state_dict,
                                                     load_torch_checkpoint)

        sd = load_torch_checkpoint(path)
        for ik in self.ignore_keys:
            sd = {k: v for k, v in sd.items() if not k.startswith(ik)}
        if "scale_factor" in sd:
            sf = sd["scale_factor"].float().numpy()
            if sf.ndim == 0 and self.adopted_scale_factor:
                sf = sf[None]
            self.scale_factors = sf
        report: Dict[str, Any] = {}
        load_state_dict(self, sd, strict=strict, report=report)
        report["state_dict"] = sd
        return report

    def _tiling(self, side: int) -> Optional[Dict[str, Any]]:
        """``split_input_params`` when a latent of this side is tiled."""
        sip = self.extra.get("split_input_params")
        return sip if sip and side > sip["ks"][0] else None

    def apply_model(self, x: torch.Tensor, t: torch.Tensor,
                    context: Optional[torch.Tensor], stage: int,
                    spade_pre=None) -> torch.Tensor:
        """eps-hat for NHWC ``x`` at timesteps ``t``; NHWC out. ``context``
        is the cross-attention context, or with ``concat`` an NHWC map
        joined to ``x`` on the channels (``models/frido.py:116-126``).
        Under tiling each tile recomputes its SPADE tables (``spade_pre``
        holds full-grid tables and is not used)."""
        sip = self._tiling(x.shape[1])
        if sip:
            return tiled_apply(
                lambda tile: self.apply_model(tile, t, context, stage), x,
                ks=tuple(sip["ks"]), stride=tuple(sip["stride"]))
        ck = self.conditioning_key
        kw = {}
        if ck == "crossattn":
            kw["c_crossattn"] = [context]
        elif ck == "concat":
            kw["c_concat"] = [to_nchw(context)]
        out = self.model(to_nchw(x), t, stage=stage, spade_pre=spade_pre,
                         **kw)
        return to_nhwc(out)

    def spade_tables(self, x_cond: torch.Tensor, stage: int):
        """Stage-invariant SPADE tables from the frozen NHWC channels."""
        return self.model.spade_tables(to_nchw(x_cond), stage)

    def _first_stage(self, what: str):
        if self.first_stage_model is None:
            raise ValueError(f"{what}: a pixel-space DDPM has no first "
                             f"stage")
        return self.first_stage_model

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> the scaled NHWC diffusion latent [coarse | fine]
        (the scaled image itself without a first stage)."""
        if self.first_stage_model is not None:
            x = self.first_stage_model.encode_interface(x)
        return self._scale_latent(x, invert=False)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor,
                           chunk: Optional[int] = None) -> torch.Tensor:
        """NHWC latent -> NHWC image, ``chunk`` samples at a time when
        ``chunk`` divides the batch (``models/frido.py:389-420``); otherwise
        the whole batch at once, with a warning. A latent wider than the
        tiling's ``ks`` decodes tile by tile, each tile to ``ks * vqf``
        pixels; chunking wraps the tiled decode. Without a first stage,
        the unscaled latent is the image."""
        z = self._scale_latent(z, invert=True)
        if self.first_stage_model is None:
            return z
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
        return self._first_stage("decode_first_stage_with_codes").\
            decode_interface(
            self._scale_latent(z, invert=True), return_code=True)

    @torch.no_grad()
    def quantize_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Each stage's channel block of an unscaled NHWC latent through its
        codebook."""
        return self._first_stage("quantize_latent").quantize_latent(z)

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
        target = target[..., start:end]
        if not self.use_split_head:   # the split head gives the window
            model_out = model_out[..., start:end]
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
        z = images.to(self.device)
        if self.first_stage_model is not None:
            z = self.first_stage_model.encode_interface(z)
        factors, start = [], 0
        for d in self.embed_dim_list:
            std = z[..., start:start + d].float().std(correction=0)
            factors.append(1.0 / float(std))
            start += d
        self.scale_factors = np.asarray(factors, np.float32)
        return self.scale_factors

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
        return self._sample(batch_size, context, uncond_context, steps, eta,
                            guidance_scale, sampler, x_T, x_init,
                            compute_dtype, cfg_mode, generator)

    @torch.no_grad()
    def _sample(self, batch_size, context=None, uncond_context=None,
                steps=200, eta=1.0, guidance_scale=1.0, sampler="plms",
                x_T=None, x_init=None, compute_dtype=None,
                cfg_mode="batched", generator=None,
                keep_intermediates=False):
        """:meth:`sample`; ``keep_intermediates`` returns ``(z, [per
        sampled stage, its steps' composites])`` (the image log's
        galleries)."""
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        cfg = samplers.SamplerConfig(
            schedule=self.schedule, num_steps=steps, eta=eta,
            guidance_scale=guidance_scale,
            embed_dim_list=tuple(self.embed_dim_list),
            use_split_head=self.use_split_head,
            specify_channels=tuple(self.specify_channels),
            num_stage=self.num_stage, kind=sampler, cfg_mode=cfg_mode,
            keep_intermediates=keep_intermediates)
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
        if (self.use_split_head and self.use_spade and self.num_stage > 1
                and not self.extra.get("split_input_params")):
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

    # ------------------------------------------------------------------
    # image logs (models/frido.py:605-770)
    # ------------------------------------------------------------------
    def _host(self, t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    def _images(self, batch, n: int) -> torch.Tensor:
        image = batch["image"]
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image))
        return image[:n].to(self.device, torch.float32)

    def _tokens(self, batch, n: int) -> np.ndarray:
        key = self.cond_stage_key
        cond = batch[key] if key in batch else batch
        if isinstance(cond, list):
            cond = cond[:n]
        return np.asarray(self.tokenize(cond))[:n]

    @torch.no_grad()
    def log_images(self, batch, generator: Optional[torch.Generator] = None,
                   n: int = 8, ddim_steps: int = 200, ddim_eta: float = 1.0,
                   sample_flag: bool = True, dataset=None) -> Dict[str, Any]:
        """``inputs``, ``reconstruction``, ``conditioning`` and (behind the
        ``plot_*`` gates) ``samples``, ``samples_x0_quantized``,
        ``diffusion_row``, ``denoise_row``, ``progressive_row`` of the
        first ``n`` samples of ``batch``, and their ``file_name``."""
        from frido_tpu_torch.utils import visualize as vz

        log: Dict[str, Any] = {}
        x = self._images(batch, n)
        log["inputs"] = self._host(x)
        if "file_name" in batch:
            log["file_name"] = batch["file_name"][:n]
        z = self.encode_first_stage(x)
        log["reconstruction"] = self._host(self.decode_first_stage(z))

        ctx = None
        key = self.cond_stage_key
        if self.cond_stage_model is not None:
            tokens = self._tokens(batch, n)
            ctx = self.get_learned_conditioning(tokens)
            wh = (x.shape[2], x.shape[1])
            if key == "caption":
                log["conditioning"] = vz.log_txt_as_img(
                    wh, batch["caption"][:n])
            elif key == "objects" and dataset is not None:
                none = dataset.conditional_builders["objects"].none
                labels = [[dataset.get_textual_label_for_category_no(int(t))
                           for t in row if t != none] for row in tokens]
                log["conditioning"] = vz.log_txt_as_img(wh, labels)
            elif key == "objects_bbox" and dataset is not None:
                builder = dataset.conditional_builders["objects_bbox"]
                log["conditioning"] = np.stack([
                    vz.plot_bbox_conditioning(
                        builder, row,
                        dataset.get_textual_label_for_category_no, wh)
                    for row in tokens])

        gate = self.extra.get
        if sample_flag and gate("plot_sample", True):
            samples = self.sample(
                x.shape[0], context=ctx, steps=ddim_steps, eta=ddim_eta,
                sampler="ddim" if ddim_eta > 0 else "plms",
                generator=generator)
            log["samples"] = self._host(self.decode_first_stage(samples))
            if gate("plot_quantize_denoised", False):
                zq = self.quantize_latent(
                    self._scale_latent(samples, invert=True))
                log["samples_x0_quantized"] = self._host(
                    self.first_stage_model.decode_interface(zq))
        if sample_flag and (gate("plot_diffusion_rows", False)
                            or gate("plot_denoise_rows", False)):
            rows = self.log_rows(batch, generator=generator,
                                 ddim_steps=min(ddim_steps, 50))
            if gate("plot_diffusion_rows", False):
                log["diffusion_row"] = rows["diffusion_row"]
            if gate("plot_denoise_rows", False):
                log["denoise_row"] = rows["denoise_row"]
        if sample_flag and gate("plot_progressive_rows", False):
            log["progressive_row"] = self.log_progressive_rows(
                ctx, generator, n_row=min(2, x.shape[0]))
        return log

    def _decode_intermediates_row(self, inters, final, stride: int
                                  ) -> np.ndarray:
        """Every ``stride``-th composite of each sampled stage and the
        final latent, decoded in one batched call, as one grid a sample
        (the galleries' shared tail)."""
        from frido_tpu_torch.utils import visualize as vz

        frames = [si[::stride] for si in inters] + [final[None]]
        stacked = torch.cat(frames, dim=0)
        k, b = stacked.shape[:2]
        imgs = self._host(self.decode_first_stage(
            stacked.reshape((k * b,) + tuple(stacked.shape[2:]))))
        row = np.swapaxes(imgs.reshape((k, b) + imgs.shape[1:]), 0, 1)
        return np.stack([vz.make_grid(r, nrow=k) for r in row])

    @torch.no_grad()
    def log_progressive_rows(self, ctx, generator=None,
                             n_row: int = 2) -> np.ndarray:
        """The full-T ancestral chain's x0 composites decoded every
        ``timesteps // 5`` steps (``frido.py:1576-1582``)."""
        if ctx is not None:
            ctx = ctx[:n_row]
        final, inters = self._sample(n_row, context=ctx, eta=1.0,
                                     sampler="vanilla", generator=generator,
                                     keep_intermediates=True)
        return self._decode_intermediates_row(
            inters, final, max(self.timesteps // 5, 1))

    @torch.no_grad()
    def log_rows(self, batch, generator=None, n_row: int = 2,
                 ddim_steps: int = 50, log_every_t: int = 10
                 ) -> Dict[str, np.ndarray]:
        """``diffusion_row``: the latent noised every ``log_every_t``
        timesteps in each stage's window (coarse stage last), decoded;
        ``denoise_row``: PLMS's composites decoded
        (``frido.py:1526-1583``)."""
        from frido_tpu_torch.utils import visualize as vz

        z = self.encode_first_stage(self._images(batch, n_row))
        noise = samplers._noise(generator, tuple(z.shape), 1.0, self.device)
        snaps = []
        for s in range(self.num_stage - 1, -1, -1):
            for t_val in range(0, self.timesteps, max(log_every_t, 1)):
                t = torch.full((z.shape[0],), t_val, dtype=torch.long,
                               device=self.device)
                zn = self.q_sample_stage(z, t, s, noise)
                snaps.append(self._host(self.decode_first_stage(zn)))
        row = np.stack(snaps, axis=1)
        log = {"diffusion_row": np.stack(
            [vz.make_grid(r, nrow=len(snaps)) for r in row])}
        ctx = None
        if self.cond_stage_model is not None:
            ctx = self.get_learned_conditioning(self._tokens(batch, n_row))
        final, inters = self._sample(n_row, context=ctx, steps=ddim_steps,
                                     eta=0.0, sampler="plms",
                                     generator=generator,
                                     keep_intermediates=True)
        log["denoise_row"] = self._decode_intermediates_row(
            inters, final, max(ddim_steps // 5, 1))
        return log


class DDPM(FridoDiffusion):
    """The single-stage classic DDPM entry point (``models/frido.py:772``),
    kept for config compatibility; with no ``first_stage_config`` it runs
    in pixel space."""
