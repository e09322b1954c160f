"""VQGAN decoder (port of ``frido_tpu/nn/vqgan.py:26-103, 278-335``),
channel-first.

Module names follow the original torch attribute tree (``up.3.attn.0.q``),
so the JAX params map onto it mechanically. The encoders are not ported
yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from frido_tpu_torch.nn.layers import Conv2d, GroupNorm
from frido_tpu_torch.nn.transformer import dot_attention
from frido_tpu_torch.ops.image import interpolate_nearest_2x


class ResnetBlock(nn.Module):
    """GN(1e-6) + swish + conv, twice; 1x1 shortcut on a channel change."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, eps=1e-6, device=device)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            device=device)
        self.norm2 = GroupNorm(out_channels, eps=1e-6, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            device=device)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1,
                                    device=device)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, fuse_silu=True))
        h = self.conv2(self.norm2(h, fuse_silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention, scale C**-0.5. At the decoder's
    32x32 sites (1024 tokens) :func:`dot_attention` sends it to the flash
    kernel on CUDA."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6, device=device)
        self.q = Conv2d(channels, channels, 1, device=device)
        self.k = Conv2d(channels, channels, 1, device=device)
        self.v = Conv2d(channels, channels, 1, device=device)
        self.proj_out = Conv2d(channels, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(conv):
            return conv(hn).reshape(b, c, h * w).transpose(1, 2)

        out = dot_attention(tokens(self.q), tokens(self.k), tokens(self.v),
                            c ** -0.5)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class Upsample(nn.Module):
    """nearest 2x + 3x3 conv."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(interpolate_nearest_2x(x))


class Decoder(nn.Module):
    """VQGAN decoder: conv_in, mid (block, attn, block), up levels from the
    coarsest, norm_out + swish + conv_out."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: int, out_ch: int = 3, device=None, **unused):
        super().__init__()
        nres = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (nres - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1,
                              device=device)
        self.mid = nn.ModuleDict({
            "block_1": ResnetBlock(block_in, block_in, device),
            "attn_1": AttnBlock(block_in, device),
            "block_2": ResnetBlock(block_in, block_in, device)})
        up = [None] * nres
        for i in reversed(range(nres)):
            block_out = ch * ch_mult[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, device))
            level = nn.ModuleDict({"block": nn.ModuleList(blocks),
                                   "attn": nn.ModuleList(attns)})
            if i != 0:
                level["upsample"] = Upsample(block_in, device)
                curr_res *= 2
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid["block_1"](h)
        h = self.mid["attn_1"](h)
        h = self.mid["block_2"](h)
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level["block"]):
                h = block(h)
                if len(level["attn"]):
                    h = level["attn"][j](h)
            if "upsample" in level:
                h = level["upsample"](h)
        return self.conv_out(self.norm_out(h, fuse_silu=True))
