"""VQGAN conv backbone: Encoder, MSEncoder, Decoder (port of
``frido_tpu/nn/vqgan.py``), channel-first.

Module names follow the original torch attribute tree (``up.3.attn.0.q``,
``mid_ms.0.block_1``, ``down.2.downsample.conv``), so the JAX params map
onto it mechanically. Dropout is not ported: a ``dropout > 0`` block
raises in training mode (every config sets ``dropout: 0.0``); in eval mode
it is the identity, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv2d, GroupNorm
from frido_tpu_torch.nn.transformer import dot_attention
from frido_tpu_torch.ops.image import avg_pool_2x, interpolate_nearest_2x


class ResnetBlock(nn.Module):
    """GN(1e-6) + swish + conv, twice; 1x1 shortcut on a channel change."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
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
        if self.dropout > 0.0 and self.training:
            raise NotImplementedError(
                "ResnetBlock dropout in training: the JAX package raises "
                "flax.errors.AssignSubModuleError there (nn.Dropout built "
                "in __call__ of a setup module, frido_tpu/nn/vqgan.py:"
                "52-53), so there is no reference to port")
        h = self.conv1(self.norm1(x, fuse_silu=True))
        h = self.conv2(self.norm2(h, fuse_silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention, scale C**-0.5. From 32x32 up
    (1024 tokens and more) :func:`dot_attention` sends it to the flash
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
    """nearest 2x + optional 3x3 conv."""

    def __init__(self, channels: int, with_conv: bool = True, device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, padding=1, device=device)
                     if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = interpolate_nearest_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """Pad one row and column at the bottom and right, then a stride-2
    3x3 conv (plain ``F.conv2d``, as the JAX package leaves it to XLA); or
    a 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = True, device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, stride=2, padding=0,
                            device=device) if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is None:
            return avg_pool_2x(x)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(channels: int, dropout: float, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "block_1": ResnetBlock(channels, channels, dropout, device),
        "attn_1": AttnBlock(channels, device),
        "block_2": ResnetBlock(channels, channels, dropout, device)})


def _run_mid(mid: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    return mid["block_2"](mid["attn_1"](mid["block_1"](h)))


def _level(block_in: int, block_out: int, n_blocks: int, attn: bool,
           dropout: float, device) -> nn.ModuleDict:
    """``n_blocks`` ResnetBlocks to ``block_out`` channels, each followed
    by an AttnBlock if ``attn``."""
    return nn.ModuleDict({
        "block": nn.ModuleList([
            ResnetBlock(block_out if j else block_in, block_out, dropout,
                        device) for j in range(n_blocks)]),
        "attn": nn.ModuleList([AttnBlock(block_out, device)
                               for _ in range(n_blocks if attn else 0)])})


def _run_level(level: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    """A level's ResnetBlocks, each followed by its AttnBlock if any."""
    for j, block in enumerate(level["block"]):
        h = block(h)
        if len(level["attn"]):
            h = level["attn"][j](h)
    return h


class _DownTrunk(nn.Module):
    """conv_in and the down levels, the base of Encoder and MSEncoder; each
    level holds ``num_res_blocks`` ResnetBlocks (each followed by an
    AttnBlock at the attention resolutions) and, but the last, a
    Downsample."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 in_channels: int, dropout: float, resamp_with_conv: bool,
                 device):
        super().__init__()
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, device=device)
        curr_res = resolution
        down = []
        for i, mult in enumerate(ch_mult):
            level = _level(ch * in_ch_mult[i], ch * mult, num_res_blocks,
                           curr_res in attn_resolutions, dropout, device)
            if i != len(ch_mult) - 1:
                level["downsample"] = Downsample(ch * mult, resamp_with_conv,
                                                 device)
                curr_res //= 2
            down.append(level)
        self.down = nn.ModuleList(down)
        self.block_out = ch * ch_mult[-1]

    def levels(self, x: torch.Tensor):
        """Yield the last block's output of each level, top down; the
        caller takes the last one as the trunk's output."""
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            yield h
            if "downsample" in level:
                h = level["downsample"](h)


class Encoder(_DownTrunk):
    """Single-scale VQGAN encoder: the down trunk, mid (block, attn,
    block), norm_out + swish + conv_out to ``z_channels`` (twice that with
    ``double_z``)."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: int, in_channels: int = 3, double_z: bool = True,
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 device=None, **unused):
        super().__init__(ch, ch_mult, num_res_blocks, attn_resolutions,
                         resolution, in_channels, dropout, resamp_with_conv,
                         device)
        block_in = self.block_out
        self.mid = _mid(block_in, dropout, device)
        self.norm_out = GroupNorm(block_in, eps=1e-6, device=device)
        out_c = 2 * z_channels if double_z else z_channels
        self.conv_out = Conv2d(block_in, out_c, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *_, h = self.levels(x)
        h = _run_mid(self.mid, h)
        return self.conv_out(self.norm_out(h, fuse_silu=True))


class MSEncoder(_DownTrunk):
    """Multi-scale encoder: the shared down trunk, tapped at the last
    ResnetBlock (and its AttnBlock) of each of the final ``multiscale``
    levels; each tap runs its own mid, norm_out and conv_out head.

    Returns the latents ordered finer -> coarser: head ``i`` runs on tap
    ``-(multiscale - i)``, as in the JAX package."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: Sequence[int], in_channels: int = 3,
                 double_z: bool = True, multiscale: int = 2,
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 device=None, **unused):
        if len(z_channels) != multiscale:
            raise ValueError("multiscale encoder: z_channels must have one "
                             "entry per scale")
        super().__init__(ch, ch_mult, num_res_blocks, attn_resolutions,
                         resolution, in_channels, dropout, resamp_with_conv,
                         device)
        self.multiscale = multiscale
        ms_mult = ((1,) + tuple(ch_mult))[-multiscale:]
        self.mid_ms = nn.ModuleList(
            [_mid(ch * m, dropout, device) for m in ms_mult])
        self.norm_out_ms = nn.ModuleList(
            [GroupNorm(ch * m, eps=1e-6, device=device) for m in ms_mult])
        self.conv_out_ms = nn.ModuleList([
            Conv2d(ch * m, 2 * z if double_z else z, 3, padding=1,
                   device=device) for m, z in zip(ms_mult, z_channels)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = list(self.levels(x))
        out = []
        for i in range(self.multiscale):
            h = _run_mid(self.mid_ms[i], taps[-(self.multiscale - i)])
            out.append(self.conv_out_ms[i](
                self.norm_out_ms[i](h, fuse_silu=True)))
        return out


class Decoder(nn.Module):
    """VQGAN decoder: conv_in, mid (block, attn, block), up levels from the
    coarsest, norm_out + swish + conv_out (or, with ``give_pre_end``, the
    features before norm_out)."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int,
                 z_channels: int, out_ch: int = 3, dropout: float = 0.0,
                 resamp_with_conv: bool = True, give_pre_end: bool = False,
                 device=None, **unused):
        super().__init__()
        self.give_pre_end = give_pre_end
        nres = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (nres - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1,
                              device=device)
        self.mid = _mid(block_in, dropout, device)
        up = [None] * nres
        for i in reversed(range(nres)):
            level = _level(block_in, ch * ch_mult[i], num_res_blocks + 1,
                           curr_res in attn_resolutions, dropout, device)
            block_in = ch * ch_mult[i]
            if i != 0:
                level["upsample"] = Upsample(block_in, resamp_with_conv,
                                             device)
                curr_res *= 2
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            h = _run_level(level, h)
            if "upsample" in level:
                h = level["upsample"](h)
        if self.give_pre_end:
            return h
        return self.conv_out(self.norm_out(h, fuse_silu=True))
