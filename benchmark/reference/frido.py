"""The diffusion chain of the reference: a frozen copy of the port's
``schedules.py`` (linear betas), ``diffusion/samplers.py`` (PLMS and
DPM-Solver++(2M), eta 0, classifier-free guidance as one doubled call)
and ``models/frido.py`` (the channel-windowed pyramid, its latent
scaling, the per-stage l1/l2 eps loss), over the reference's UNet, text
encoder and first stage.

Every array and state-dict key is the port's: the denoiser under
``model.diffusion_model``, the first stage under ``first_stage_model``,
the text encoder under ``cond_stage_model``. Latents and images are NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from reference.blocks import BERTEmbedder
from reference.layers import (avg_pool_2x, interpolate_nearest_2x, to_nchw,
                              to_nhwc)
from reference.pyunet import PyUNetModel
from reference.vqgan import MSFPNVQModel

f32 = np.float32


class Schedule:
    """The DDPM buffers the chain and the loss read (linear betas, float64
    math stored as float32), and the strided DDIM steps."""

    def __init__(self, timesteps: int, linear_start: float,
                 linear_end: float):
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        self.num_timesteps = timesteps
        self.alphas_cumprod = ac.astype(f32)
        self.sqrt_alphas_cumprod = np.sqrt(ac).astype(f32)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - ac).astype(f32)

    def ddim(self, num_steps: int):
        """(timesteps, alphas, alphas_prev, sqrt(1 - alphas)) of the
        uniform DDIM steps, ascending (``util.py:46-74``: the +1 shift,
        eta 0)."""
        c = self.num_timesteps // num_steps
        ts = np.asarray(list(range(0, self.num_timesteps, c))) + 1
        acs = self.alphas_cumprod.astype(np.float64)
        alphas = acs[ts]
        prev = np.asarray([acs[0]] + acs[ts[:-1]].tolist())
        return (ts.astype(np.int32), alphas.astype(f32), prev.astype(f32),
                np.sqrt(1.0 - alphas).astype(f32))


class _Wrapper(nn.Module):
    def __init__(self, unet_params, device):
        super().__init__()
        self.diffusion_model = PyUNetModel(**unet_params, device=device)


class Frido(nn.Module):
    """The configuration's ``model.params`` as the reference runs them."""

    def __init__(self, params: Dict[str, Any], device=None):
        super().__init__()
        p = dict(params)
        unsupported = [k for k, v in (("parameterization", "eps"),
                                      ("beta_schedule", "linear"),
                                      ("conditioning_key", "crossattn"),
                                      ("original_elbo_weight", 0.0),
                                      ("learn_logvar", False))
                       if p.get(k, v) != v]
        if unsupported:
            raise NotImplementedError(f"reference: {unsupported}")
        self.image_size = p["image_size"]
        self.channels = p["channels"]
        self.loss_type = p.get("loss_type", "l2")
        self.noise_mix_ratio = p.get("noise_mix_ratio", 0.0)
        self.l_simple_weight = p.get("l_simple_weight", 1.0)
        self.stage_loss_ratio = tuple(p.get("stage_loss_ratio", (0.5, 0.5)))
        self.schedule = Schedule(p.get("timesteps", 1000),
                                 p.get("linear_start", 1e-4),
                                 p.get("linear_end", 2e-2))
        fs = p["first_stage_config"]["params"]
        self.embed_dim_list = list(fs["embed_dim"])
        self.num_stage = len(self.embed_dim_list)
        self.model = _Wrapper(p["unet_config"]["params"], device)
        self.first_stage_model = MSFPNVQModel(**fs, device=device)
        self.cond_stage_model = BERTEmbedder(
            **p["cond_stage_config"]["params"], device=device)
        if p.get("adopted_scale_factor", False):
            self.scale_factors = np.full((self.num_stage,),
                                         p.get("scale_factor", 1.0), f32)
        else:
            self.scale_factors = np.asarray(p.get("scale_factor", 1.0), f32)

    @property
    def unet(self) -> PyUNetModel:
        return self.model.diffusion_model

    def window(self, stage: int) -> Tuple[int, int]:
        return (sum(self.embed_dim_list[:stage]),
                sum(self.embed_dim_list[:stage + 1]))

    # ---- latents ------------------------------------------------------
    def scale_latent(self, z, invert: bool):
        z = z.to(torch.promote_types(z.dtype, torch.float32))
        sf = self.scale_factors
        if sf.ndim == 0:
            return z / float(sf) if invert else z * float(sf)
        parts = []
        for i in range(self.num_stage):
            a, b = self.window(i)
            s = sf[min(i, sf.shape[0] - 1)]
            f = float(f32(1.0) / s) if invert else float(s)
            parts.append(z[..., a:b] * f)
        return torch.cat(parts, dim=-1)

    @torch.no_grad()
    def encode(self, x):
        return self.scale_latent(self.first_stage_model.encode_interface(x),
                                 invert=False)

    @torch.no_grad()
    def decode(self, z, dtype=None):
        return self.first_stage_model.decode_interface(
            self.scale_latent(z, invert=True), dtype)

    @torch.no_grad()
    def decode_judged(self, z, target, dtype=None, tie: float = 1e-6,
                      most: int = 6):
        """The decode of ``z`` whose codes are the nearest, except where two
        codes tie within float32's reach (``VectorQuantizer.nearest``):
        there either is right, and each image takes the choice of its ties
        (its ``most`` closest ties, every combination) whose decode lies
        nearest to that image of ``target``."""
        fs = self.first_stage_model
        dtype = dtype or torch.float32
        best, second, gaps = fs.nearest_codes(
            self.scale_latent(z, invert=True), tie)
        image = fs.decode_codes(best, dtype).float()
        for b in range(z.shape[0]):
            sites = sorted(
                (float(g[b][tuple(p)]), k, tuple(p))
                for k, g in enumerate(gaps)
                for p in torch.isfinite(g[b]).nonzero().tolist())[:most]
            if not sites:
                continue
            variants = []
            for mask in range(1, 2 ** len(sites)):
                codes = [c[b:b + 1].clone() for c in best]
                for j, (_, k, p) in enumerate(sites):
                    if mask >> j & 1:
                        codes[k][(0,) + p] = second[k][(b,) + p]
                variants.append(codes)
            cand = torch.cat([image[b:b + 1]] + [
                fs.decode_codes(v, dtype).float() for v in variants])
            err = (cand - target[b:b + 1].float()).flatten(1).norm(dim=1)
            image[b] = cand[int(err.argmin())]
        return image

    @torch.no_grad()
    def scale_by_std(self, images) -> np.ndarray:
        """Each stage's factor 1/std (population) of its unscaled latent
        block of ``images``."""
        z = self.first_stage_model.encode_interface(images)
        factors = []
        for s in range(self.num_stage):
            a, b = self.window(s)
            factors.append(1.0 / float(z[..., a:b].float().std(correction=0)))
        self.scale_factors = np.asarray(factors, f32)
        return self.scale_factors

    def conditioning(self, tokens):
        return self.cond_stage_model(tokens.long())

    # ---- the denoiser -------------------------------------------------
    def apply(self, x, t, context, stage: int, spade_pre=None):
        return to_nhwc(self.unet(to_nchw(x), t, context, stage, spade_pre))

    @torch.no_grad()
    def sample(self, x_init, context, uncond_context, steps: int,
               sampler: str, guidance_scale: float, compute_dtype=None):
        """The coarse-to-fine chain from the initial noise ``x_init``;
        returns the scaled latent (fp32)."""
        cd = compute_dtype
        ctx = context if cd is None else context.to(cd)
        uctx = uncond_context if cd is None else uncond_context.to(cd)
        ts, a_t, a_prev, s1m = (v[::-1] for v in self.schedule.ddim(steps))
        x = x_init
        for s in range(self.num_stage):
            start, end = self.window(s)
            prefix, suffix = x[..., :start], x[..., end:]
            aux = None
            if s > 0:
                xc = prefix if cd is None else prefix.to(cd)
                aux = self.unet.spade_tables(to_nchw(xc), s)
                aux = _doubled(aux)

            def eps(x_w, i, _p=prefix, _s=suffix, _aux=aux, _st=s):
                xx = torch.cat([_p, x_w, _s], dim=-1)
                xx = xx if cd is None else xx.to(cd)
                tb = torch.full((xx.shape[0],), int(ts[i]), dtype=torch.long,
                                device=xx.device)
                out = self.apply(torch.cat([xx, xx]), torch.cat([tb, tb]),
                                 torch.cat([uctx, ctx]), _st, _aux).float()
                e_u, e_c = out.chunk(2, dim=0)
                return e_u + guidance_scale * (e_c - e_u)

            x_w = x[..., start:end]
            if sampler == "plms":
                x_w = _plms(eps, x_w, a_t, a_prev, s1m)
            elif sampler == "dpmpp":
                x_w = _dpmpp(eps, x_w, a_t, a_prev)
            else:
                raise NotImplementedError(f"reference sampler {sampler!r}")
            x = self._stage_smooth(torch.cat([prefix, x_w, suffix], dim=-1), s)
        return x

    def _stage_smooth(self, x, stage: int):
        if self.num_stage == 1:
            return x
        start, end = self.window(stage)
        k = self.num_stage - stage - 1
        blk = x[..., start:end].permute(0, 3, 1, 2)
        for _ in range(k):
            blk = avg_pool_2x(blk)
        for _ in range(k):
            blk = interpolate_nearest_2x(blk)
        return torch.cat([x[..., :start], blk.permute(0, 2, 3, 1),
                          x[..., end:]], dim=-1)

    # ---- training -----------------------------------------------------
    def q_sample_stage(self, z, t, stage, noise):
        start, end = self.window(stage)
        sac = torch.as_tensor(self.schedule.sqrt_alphas_cumprod,
                              device=z.device)[t][:, None, None, None]
        s1m = torch.as_tensor(self.schedule.sqrt_one_minus_alphas_cumprod,
                              device=z.device)[t][:, None, None, None]
        parts = []
        if start > 0:
            clean = z[..., :start]
            if self.noise_mix_ratio != 0.0:
                tau = self.noise_mix_ratio
                clean = (1 - tau) * clean + tau * noise[..., :start]
            parts.append(clean)
        parts.append(sac * z[..., start:end] + s1m * noise[..., start:end])
        if end < z.shape[-1]:
            parts.append(noise[..., end:])
        return torch.cat(parts, dim=-1)

    def training_loss(self, z, context, t, noise, compute_dtype=None):
        """The stage-weighted eps loss and each stage's ``loss_simple``."""
        total, logs = 0.0, {}
        for s, ratio in enumerate(self.stage_loss_ratio):
            start, end = self.window(s)
            x_noisy = self.q_sample_stage(z, t, s, noise)
            ctx = context
            if compute_dtype is not None:
                x_noisy, ctx = x_noisy.to(compute_dtype), ctx.to(compute_dtype)
            out = self.apply(x_noisy, t, ctx, s).float()
            target = noise[..., start:end]
            per = ((out - target).abs() if self.loss_type == "l1"
                   else (out - target).square())
            loss_simple = per.mean(dim=(1, 2, 3))
            loss = self.l_simple_weight * loss_simple.mean()
            total = total + loss * ratio
            logs[f"loss_simple_stage{s}"] = loss_simple.mean() * ratio
        logs["loss"] = total
        return total, logs


def _doubled(aux):
    if aux is None:
        return None
    if isinstance(aux, torch.Tensor):
        return torch.cat([aux, aux], dim=0)
    if isinstance(aux, dict):
        return {k: _doubled(v) for k, v in aux.items()}
    return type(aux)(_doubled(v) for v in aux)


def _ddim_update(x_w, e_w, a_t, a_prev, sqrt_1ma):
    """x_t -> x_{t-1} at eta 0, the scalar coefficients in fp32."""
    pred_x0 = (x_w - float(sqrt_1ma) * e_w) / float(np.sqrt(f32(a_t)))
    dir_coef = float(np.sqrt(f32(1.0) - f32(a_prev)))
    return float(np.sqrt(f32(a_prev))) * pred_x0 + dir_coef * e_w


def _plms(eps, x_w, a_t, a_prev, s1m):
    S = len(a_t)
    e_t = eps(x_w, 0)
    x_half = _ddim_update(x_w, e_t, a_t[0], a_prev[0], s1m[0])
    e_next = eps(x_half, min(1, S - 1))
    x_w = _ddim_update(x_w, (e_t + e_next) / 2, a_t[0], a_prev[0], s1m[0])
    zeros = torch.zeros_like(e_t)
    h1, h2, h3 = e_t, zeros, zeros
    for i in range(1, S):
        e_t = eps(x_w, i)
        order = min(i, 3) - 1
        if order == 0:
            e_p = (3 * e_t - h1) / 2
        elif order == 1:
            e_p = (23 * e_t - 16 * h1 + 5 * h2) / 12
        else:
            e_p = (55 * e_t - 59 * h1 + 37 * h2 - 9 * h3) / 24
        x_w = _ddim_update(x_w, e_p, a_t[i], a_prev[i], s1m[i])
        h1, h2, h3 = e_t, h1, h2
    return x_w


def _dpmpp(eps, x_w, a_t, a_prev):
    """DPM-Solver++(2M), first order at the first step (and the last one
    below 15 steps)."""
    S = len(a_t)
    a_t, a_prev = a_t.astype(f32), a_prev.astype(f32)
    sig_t = np.sqrt(f32(1.0) - a_t)
    sig_prev = np.sqrt(f32(1.0) - a_prev)
    lam_t = f32(0.5) * np.log(a_t / (f32(1.0) - a_t))
    lam_prev = f32(0.5) * np.log(a_prev / (f32(1.0) - a_prev))
    x0_prev = torch.zeros_like(x_w)
    h_prev = f32(0.0)
    for i in range(S):
        e_w = eps(x_w, i)
        x0 = (x_w - float(sig_t[i]) * e_w) / float(np.sqrt(a_t[i]))
        h = f32(lam_prev[i] - lam_t[i])
        c = f32(1.0) / (f32(2.0) * (h_prev / h)) if h_prev > 0 else f32(0.0)
        if S < 15 and i == S - 1:
            c = f32(0.0)
        d = float(f32(1.0) + c) * x0 - float(c) * x0_prev
        x_w = (float(sig_prev[i] / sig_t[i]) * x_w
               - float(np.sqrt(a_prev[i]) * np.expm1(-h)) * d)
        x0_prev, h_prev = x0, h
    return x_w


def build(config: Dict[str, Any], device=None) -> Frido:
    """The reference model of a benchmark configuration (its ``model``
    node), with uninitialised weights on ``device``."""
    return Frido(config["model"]["params"], device=device)

