"""The PyUNet of the reference: a frozen copy of the port's
``nn/pyunet.py`` restricted to what the benchmark's configurations build
(the split head with SPADE conditioning on the previous stages, spatial
transformers with legacy heads, a stage embedding, resampling by conv),
on the plain layers of ``reference/layers.py``. Another option raises."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.blocks import SPADE, SpatialTransformer
from reference.layers import (Conv2d, Dense, Embed, GroupNorm,
                              interpolate_nearest_2x)


def timestep_embedding(timesteps, dim, max_period=10000):
    """Sinusoidal embedding, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class UNetUpsample(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv(interpolate_nearest_2x(x))


class UNetDownsample(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1,
                         device=device)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """SPADE -> SiLU -> 3x3 conv, + time embedding, SPADE -> SiLU -> 3x3
    conv, + skip (1x1 conv where the channels change)."""

    def __init__(self, channels, out_channels, emb_channels,
                 cond_channels=None, device=None):
        super().__init__()
        cout = out_channels
        self.in_layers = nn.ModuleDict({
            "0": SPADE(channels, cond_channels, device=device),
            "2": Conv2d(channels, cout, 3, padding=1, device=device)})
        self.emb_layers = nn.ModuleDict({"1": Dense(emb_channels, cout,
                                                    device=device)})
        self.out_layers = nn.ModuleDict({
            "0": SPADE(cout, cond_channels, device=device),
            "3": Conv2d(cout, cout, 3, padding=1, device=device)})
        self.skip_connection = (None if cout == channels else
                                Conv2d(channels, cout, 1, device=device))

    def spade_tables(self, cond, hw):
        return (self.in_layers["0"].gamma_beta(cond, hw),
                self.out_layers["0"].gamma_beta(cond, hw))

    def forward(self, x, emb, feat_cond=None, spade_pre=None):
        pre_in, pre_out = spade_pre if spade_pre is not None else (None, None)
        h = self.in_layers["2"](F.silu(self.in_layers["0"](x, feat_cond,
                                                           pre_in)))
        emb_out = self.emb_layers["1"](F.silu(emb)).to(h.dtype)[
            :, :, None, None]
        h = self.out_layers["3"](F.silu(self.out_layers["0"](
            h + emb_out, feat_cond, pre_out)))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class UNetBlock(nn.ModuleList):
    def forward(self, h, emb, context=None, h_cond=None, pres=None):
        for j, mod in enumerate(self):
            pre = pres[j] if pres is not None else None
            if isinstance(mod, ResBlock):
                h = mod(h, emb, h_cond, pre)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context, h_cond, pre)
            else:
                h = mod(h)
        return h


class PyUNetModel(nn.Module):
    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 num_head_channels: int = -1, num_stage: int = 1,
                 use_spatial_transformer: bool = False,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = None,
                 use_split_head: bool = False,
                 split_embed_dim_list: Sequence[int] = (),
                 use_SPADE_norm: bool = False, legacy: bool = True,
                 device=None, **other: Any):
        super().__init__()
        if (not (use_split_head and use_SPADE_norm and use_spatial_transformer
                 and legacy and num_stage == len(split_embed_dim_list))
                or other):
            raise NotImplementedError(
                f"the reference PyUNet builds the split-head SPADE "
                f"spatial-transformer UNet only (other options: {other})")
        mc = model_channels
        ted = mc * 4
        split = list(split_embed_dim_list)
        self.model_channels = mc
        self.context_dim = context_dim
        self.split = split
        self.num_stage = num_stage
        self.time_embed = nn.ModuleDict({"0": Dense(mc, ted, device=device),
                                         "2": Dense(ted, ted, device=device)})
        self.stage_emb = Embed(num_stage, ted, device=device)
        self.pre_input_cond_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(sum(split[:i + 1]), mc, 3, padding=1,
                                  device=device)])
            for i in range(len(split) - 1)])
        self.pre_input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(d, mc, 3, padding=1, device=device)])
            for d in split])
        cond_ch = mc if num_stage > 1 else None

        def res(cin, cout):
            return ResBlock(cin, cout, ted, cond_ch, device=device)

        def attn(ch):
            # legacy heads: one head as wide as the channels
            return SpatialTransformer(ch, 1, ch, transformer_depth,
                                      context_dim, cond_ch, device=device)

        input_blocks, chans = [], [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                input_blocks.append(UNetBlock(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                input_blocks.append(UNetBlock([UNetDownsample(ch, device)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(input_blocks)
        self.middle_block = UNetBlock([res(ch, ch), attn(ch), res(ch, ch)])
        output_blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(UNetUpsample(ch, device))
                    ds //= 2
                output_blocks.append(UNetBlock(layers))
        self.output_blocks = nn.ModuleList(output_blocks)
        self.out = nn.ModuleList([nn.ModuleDict({
            "0": GroupNorm(ch, eps=1e-5, device=device),
            "2": Conv2d(ch, c, 3, padding=1, device=device)})
            for c in split])

    def _sites(self):
        for i, layers in enumerate(self.input_blocks):
            yield "input_blocks", layers, [f"input_blocks.{i}.{j}"
                                           for j in range(len(layers))]
        yield "middle_block", self.middle_block, [
            f"middle_block.{j}" for j in range(len(self.middle_block))]
        for i, layers in enumerate(self.output_blocks):
            yield "output_blocks", layers, [f"output_blocks.{i}.{j}"
                                            for j in range(len(layers))]

    def spade_tables(self, x_cond, stage: int) -> Optional[Dict[str, Any]]:
        """Every SPADE site's (gamma, beta) from the previous stages'
        channels; None at stage 0."""
        if stage == 0:
            return None
        h_cond = self.pre_input_cond_blocks[stage - 1][0](x_cond)
        hw = tuple(x_cond.shape[-2:])
        tables = {}
        for _, block, names in self._sites():
            for name, mod in zip(names, block):
                if isinstance(mod, (ResBlock, SpatialTransformer)):
                    tables[name] = mod.spade_tables(h_cond, hw)
                elif isinstance(mod, UNetDownsample):
                    hw = (hw[0] // 2, hw[1] // 2)
                elif isinstance(mod, UNetUpsample):
                    hw = (hw[0] * 2, hw[1] * 2)
        return tables

    def forward(self, x, timesteps, context=None, stage: int = 0,
                spade_pre=None):
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](emb)))
        ids = torch.full((x.shape[0],), stage, dtype=torch.long,
                         device=x.device)
        emb = emb + self.stage_emb(ids)
        cond_dim = sum(self.split[:stage])
        h = self.pre_input_blocks[stage][0](
            x[:, cond_dim:sum(self.split[:stage + 1])])
        h_cond = None
        if cond_dim and spade_pre is None:
            h_cond = self.pre_input_cond_blocks[stage - 1][0](x[:, :cond_dim])
        hs = [h]
        for group, block, names in self._sites():
            if group == "output_blocks":
                h = torch.cat([h, hs.pop()], dim=1)
            pres = (None if spade_pre is None
                    else [spade_pre.get(n) for n in names])
            h = block(h, emb, context, h_cond, pres)
            if group == "input_blocks":
                hs.append(h)
        head = self.out[stage]
        return head["2"](head["0"](h, fuse_silu=True))
