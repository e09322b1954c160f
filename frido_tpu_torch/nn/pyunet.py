"""PyUNet: the coarse-to-fine pyramid denoiser (port of
``frido_tpu/nn/pyunet.py``), channel-first.

Sinusoidal t-embedding + MLP plus the stage embedding; split-head input
(per-stage ``pre_input_blocks`` over the stage's channel window, previous
stages' channels feeding SPADE through ``pre_input_cond_blocks``); a shared
trunk of ResBlocks and SpatialTransformers with skip concatenation; per-stage
output heads. ``spade_tables`` precomputes every SPADE site's (gamma, beta)
once per stage (``:518-567``).

Module names follow the original torch key tree (``input_blocks.1.0.
in_layers.2.weight``), so the JAX params map onto this module mechanically
(``frido_tpu_torch/io/jax_weights.py``).

Only the split-head SPADE form is ported, the one every Frido config
uses. Not ported yet, and refused: the single-head and non-SPADE forms,
the plain ``AttentionBlock`` trunk (``use_spatial_transformer: false``; the
t2i config takes the SpatialTransformer branch, ``:323-329``), class
labels, stage experts, resblock up/down resampling, scale-shift norm,
position embeddings, the mscond branch and the codebook-id head.
``dropout > 0`` raises in training mode (every config sets 0); in eval mode
dropout is the identity, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv2d, Dense, Embed, GroupNorm
from frido_tpu_torch.nn.spade import SPADE
from frido_tpu_torch.nn.transformer import SpatialTransformer
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.image import avg_pool_2x, interpolate_nearest_2x


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, **cos first** (``pyunet.py:37-49``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class UNetUpsample(nn.Module):
    """nearest 2x + optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = True, device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, padding=1, device=device)
                     if use_conv else None)

    def forward(self, x):
        x = interpolate_nearest_2x(x)
        return self.conv(x) if self.conv is not None else x


class UNetDownsample(nn.Module):
    """stride-2 conv with symmetric pad 1, or 2x average pool."""

    def __init__(self, channels: int, use_conv: bool = True, device=None):
        super().__init__()
        self.op = (Conv2d(channels, channels, 3, stride=2, padding=1,
                          device=device) if use_conv else None)

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class ResBlock(nn.Module):
    """guided-diffusion ResBlock with SPADE norms on the sampling path
    (``_norm_silu_conv``, ``:130-153``, and its call sites ``:181-195``):
    SPADE -> SiLU -> conv twice, emb added before the second norm. Under
    ``FRIDO_CONV_MODE=pallas_fused`` each prologue is folded into its conv
    (one kernel per prologue); otherwise the ops run one by one."""

    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 spade_channels: int, device=None):
        super().__init__()
        cout = out_channels
        self.in_layers = nn.ModuleDict({
            "0": SPADE(channels, spade_channels, device=device),
            "2": Conv2d(channels, cout, 3, padding=1, device=device)})
        # emb_layers = Sequential(SiLU, Linear) -> key emb_layers.1
        self.emb_layers = nn.ModuleDict({"1": Dense(emb_channels, cout,
                                                    device=device)})
        self.out_layers = nn.ModuleDict({
            "0": SPADE(cout, spade_channels, device=device),
            "3": Conv2d(cout, cout, 3, padding=1, zero_init=True,
                        device=device)})
        self.skip_connection = (Conv2d(channels, cout, 1, device=device)
                                if cout != channels else None)

    def spade_tables(self, cond, hw):
        return (self.in_layers["0"].gamma_beta(cond, hw),
                self.out_layers["0"].gamma_beta(cond, hw))

    @staticmethod
    def _norm_silu_conv(norm, conv, x, feat_cond, pre):
        if dispatch.use_fused_prologue():
            return conv(x, fused_norm=norm.fused_args(x, feat_cond, pre))
        return conv(F.silu(norm(x, feat_cond, pre)))

    def forward(self, x, emb, feat_cond=None, spade_pre=None):
        pre_in, pre_out = spade_pre if spade_pre is not None else (None, None)
        h = self._norm_silu_conv(self.in_layers["0"], self.in_layers["2"], x,
                                 feat_cond, pre_in)
        emb_out = self.emb_layers["1"](F.silu(emb)).to(h.dtype)
        h = h + emb_out[:, :, None, None]
        skip = (self.skip_connection(x) if self.skip_connection is not None
                else x)
        return skip + self._norm_silu_conv(
            self.out_layers["0"], self.out_layers["3"], h, feat_cond, pre_out)


def _heads_for(ch: int, num_heads: int, num_head_channels: int,
               legacy: bool) -> Tuple[int, int]:
    """The SpatialTransformer's head count and width (``pyunet.py:271-281``):
    with ``legacy`` (the default) one head of width ``ch``."""
    if legacy:
        return 1, ch
    if num_head_channels == -1:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


_UNPORTED = {"num_classes": None, "use_scale_shift_norm": False,
             "resblock_updown": False, "use_pos_embed": False,
             "use_mscond": False, "use_stage_expert": False, "n_embed": None,
             "use_spatial_transformer": True}


class PyUNetModel(nn.Module):
    """Config fields mirror the reference yaml params
    (``configs/frido/t2i/frido_f16f8_coco.yaml:22-46``). Inputs and outputs
    are NCHW; ``stage`` is a Python int."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = -1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 num_stage: int = 1, use_new_attention_order: bool = False,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = None, legacy: bool = True,
                 use_split_head: bool = False,
                 split_embed_dim_list: Sequence[int] = (),
                 use_SPADE_norm: bool = False, device=None,
                 **unported: Any):
        super().__init__()
        for key in ("use_checkpoint", "use_fp16", "dims", "use_embed"):
            unported.pop(key, None)
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"PyUNetModel: unknown option {key!r}")
            if value != _UNPORTED[key]:
                raise NotImplementedError(
                    f"PyUNetModel option {key}={value!r} is not ported yet")
        if not (use_split_head and use_SPADE_norm):
            raise NotImplementedError(
                "only the split-head SPADE PyUNet (use_split_head and "
                "use_SPADE_norm, as in every Frido config) is ported")
        if context_dim is None:
            raise ValueError("context_dim required with the spatial "
                             "transformer")
        mc = model_channels
        ted = mc * 4
        self.model_channels = mc
        self.dropout = dropout
        self.num_stage = num_stage
        self.split = list(split_embed_dim_list)
        if sum(self.split) != in_channels:
            raise ValueError("split_embed_dim_list must sum to in_channels")

        self.time_embed = nn.ModuleDict({"0": Dense(mc, ted, device=device),
                                         "2": Dense(ted, ted, device=device)})
        if num_stage > 1:
            self.stage_emb = Embed(num_stage, ted, device=device)
        # stage s reads its own channel window; the previous stages'
        # channels feed SPADE through pre_input_cond_blocks[s - 1]
        self.pre_input_cond_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(sum(self.split[:i + 1]), mc, 3, padding=1,
                                  device=device)])
            for i in range(len(self.split) - 1)])
        self.pre_input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(d, mc, 3, padding=1, device=device)])
            for d in self.split])

        def attn(ch):
            heads, dim_head = _heads_for(ch, num_heads, num_head_channels,
                                         legacy)
            return SpatialTransformer(ch, heads, dim_head, transformer_depth,
                                      context_dim, mc, device=device)

        def res(cin, cout):
            return ResBlock(cin, cout, ted, mc, device)

        input_blocks = []
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                input_blocks.append(nn.ModuleList([
                    UNetDownsample(ch, conv_resample, device)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(input_blocks)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch),
                                           res(ch, ch)])
        output_blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(UNetUpsample(ch, conv_resample, device))
                    ds //= 2
                output_blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(output_blocks)
        self.out = nn.ModuleList([nn.ModuleDict({
            "0": GroupNorm(ch, eps=1e-5, device=device),
            "2": Conv2d(ch, c, 3, padding=1, zero_init=True, device=device)})
            for c in self.split])

    def _trunk(self):
        """(site name, layer) in execution order, with block boundaries."""
        for group in ("input_blocks", "middle_block", "output_blocks"):
            blocks = getattr(self, group)
            if group == "middle_block":
                yield group, [(f"{group}.{j}", m) for j, m in
                              enumerate(blocks)]
                continue
            for i, layers in enumerate(blocks):
                yield group, [(f"{group}.{i}.{j}", m) for j, m in
                              enumerate(layers)]

    def spade_tables(self, x_cond: torch.Tensor, stage: int
                     ) -> Optional[Dict[str, Any]]:
        """Every SPADE site's (gamma, beta) from the previous stages'
        channels ``x_cond`` [N, sum(split[:stage]), H, W], keyed by site.

        Those channels are frozen for the whole stage during sampling, so
        the sampler computes the tables once per stage; the result equals
        the in-line computation."""
        if stage == 0:
            return None
        h_cond = self.pre_input_cond_blocks[stage - 1][0](x_cond)
        hw = tuple(x_cond.shape[-2:])
        tables = {}
        for _, layers in self._trunk():
            for site, mod in layers:
                if isinstance(mod, (ResBlock, SpatialTransformer)):
                    tables[site] = mod.spade_tables(h_cond, hw)
                elif isinstance(mod, UNetDownsample):
                    hw = (hw[0] // 2, hw[1] // 2)
                elif isinstance(mod, UNetUpsample):
                    hw = (hw[0] * 2, hw[1] * 2)
        return tables

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, stage: int = 0,
                spade_pre: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        if self.dropout > 0.0 and self.training:
            raise NotImplementedError("PyUNet dropout in training is not "
                                      "ported")
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](emb)))
        if self.num_stage > 1:
            ids = torch.full((x.shape[0],), stage, dtype=torch.long,
                             device=x.device)
            emb = emb + self.stage_emb(ids)

        cond_dim = sum(self.split[:stage])
        h = self.pre_input_blocks[stage][0](
            x[:, cond_dim:cond_dim + self.split[stage]])
        h_cond = None
        if cond_dim and spade_pre is None:
            h_cond = self.pre_input_cond_blocks[stage - 1][0](x[:, :cond_dim])
        hs = [h]

        for group, layers in self._trunk():
            if group == "output_blocks":
                h = torch.cat([h, hs.pop()], dim=1)
            for site, mod in layers:
                pre = spade_pre.get(site) if spade_pre is not None else None
                if isinstance(mod, ResBlock):
                    h = mod(h, emb, h_cond, pre)
                elif isinstance(mod, SpatialTransformer):
                    h = mod(h, context, h_cond, pre)
                else:
                    h = mod(h)
            if group == "input_blocks":
                hs.append(h)

        head = self.out[stage]
        return head["2"](head["0"](h, fuse_silu=True))
