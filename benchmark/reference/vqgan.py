"""The MS-VQGAN first stage of the reference: frozen copies of the port's
``nn/vqgan.py``, ``nn/quantize.py`` (``VectorQuantizer``) and
``models/msvqgan.py`` (``MSFPNVQModel``'s diffusion interface) on the
plain layers of ``reference/layers.py``.

The codebook lookup takes the nearest code by squared distance computed
in float64, so the reference's choice is the exact one; the program's
fp32 argmin may differ from it only on a near tie."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import (Conv2d, ConvTranspose2d, Embed, GroupNorm,
                              dot_attention, interpolate_nearest_2x, to_nchw,
                              to_nhwc)

SHARED_DECODER = dict(ch=128, ch_mult=(1,), num_res_blocks=2,
                      attn_resolutions=(2, 4, 8, 16, 32, 64), resolution=256,
                      dropout=0.0)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, device=None):
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

    def forward(self, x):
        h = self.conv1(self.norm1(x, fuse_silu=True))
        h = self.conv2(self.norm2(h, fuse_silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6, device=device)
        self.q = Conv2d(channels, channels, 1, device=device)
        self.k = Conv2d(channels, channels, 1, device=device)
        self.v = Conv2d(channels, channels, 1, device=device)
        self.proj_out = Conv2d(channels, channels, 1, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(conv):
            return conv(hn).reshape(b, c, h * w).transpose(1, 2)

        out = dot_attention(tokens(self.q), tokens(self.k), tokens(self.v),
                            c ** -0.5)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class Upsample(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv(interpolate_nearest_2x(x))


class Downsample(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0,
                           device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(channels, device):
    return nn.ModuleDict({
        "block_1": ResnetBlock(channels, channels, device),
        "attn_1": AttnBlock(channels, device),
        "block_2": ResnetBlock(channels, channels, device)})


def _run_mid(mid, h):
    return mid["block_2"](mid["attn_1"](mid["block_1"](h)))


def _level(block_in, block_out, n_blocks, attn, device):
    return nn.ModuleDict({
        "block": nn.ModuleList([
            ResnetBlock(block_out if j else block_in, block_out, device)
            for j in range(n_blocks)]),
        "attn": nn.ModuleList([AttnBlock(block_out, device)
                               for _ in range(n_blocks if attn else 0)])})


def _run_level(level, h):
    for j, block in enumerate(level["block"]):
        h = block(h)
        if len(level["attn"]):
            h = level["attn"][j](h)
    return h


class MSEncoder(nn.Module):
    """The shared down trunk, tapped at the last block of each of the
    final ``multiscale`` levels, each tap with its own mid and head;
    latents finer -> coarser."""

    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions,
                 resolution, z_channels, in_channels=3, double_z=False,
                 multiscale=2, device=None, **unused):
        super().__init__()
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, device=device)
        curr_res = resolution
        down = []
        for i, mult in enumerate(ch_mult):
            level = _level(ch * in_ch_mult[i], ch * mult, num_res_blocks,
                           curr_res in attn_resolutions, device)
            if i != len(ch_mult) - 1:
                level["downsample"] = Downsample(ch * mult, device)
                curr_res //= 2
            down.append(level)
        self.down = nn.ModuleList(down)
        self.multiscale = multiscale
        ms_mult = ((1,) + tuple(ch_mult))[-multiscale:]
        self.mid_ms = nn.ModuleList([_mid(ch * m, device) for m in ms_mult])
        self.norm_out_ms = nn.ModuleList(
            [GroupNorm(ch * m, eps=1e-6, device=device) for m in ms_mult])
        self.conv_out_ms = nn.ModuleList([
            Conv2d(ch * m, 2 * z if double_z else z, 3, padding=1,
                   device=device) for m, z in zip(ms_mult, z_channels)])

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            taps.append(h)
            if "downsample" in level:
                h = level["downsample"](h)
        out = []
        for i in range(self.multiscale):
            h = _run_mid(self.mid_ms[i], taps[-(self.multiscale - i)])
            out.append(self.conv_out_ms[i](
                self.norm_out_ms[i](h, fuse_silu=True)))
        return out


class Decoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions,
                 resolution, z_channels, out_ch=3, device=None, **unused):
        super().__init__()
        nres = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (nres - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1,
                              device=device)
        self.mid = _mid(block_in, device)
        up = [None] * nres
        for i in reversed(range(nres)):
            level = _level(block_in, ch * ch_mult[i], num_res_blocks + 1,
                           curr_res in attn_resolutions, device)
            block_in = ch * ch_mult[i]
            if i != 0:
                level["upsample"] = Upsample(block_in, device)
                curr_res *= 2
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, device=device)

    def forward(self, z):
        h = _run_mid(self.mid, self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            h = _run_level(level, h)
            if "upsample" in level:
                h = level["upsample"](h)
        return self.conv_out(self.norm_out(h, fuse_silu=True))


class VectorQuantizer(nn.Module):
    def __init__(self, n_e, e_dim, device=None):
        super().__init__()
        self.embedding = Embed(n_e, e_dim, device=device)

    def lookup(self, z):
        """z [..., D] -> the nearest codes (z's dtype)."""
        idx, _, _ = self.nearest(z)
        return self.codes(idx).to(z.dtype)

    def nearest(self, z, tie: float = 0.0):
        """The nearest code of each vector of z [..., D] by float64 squared
        distances, the second nearest, and the gap between their
        distances over |z|^2 + |e|^2 where it is at most ``tie`` (a tie
        that float32 arithmetic cannot resolve at ``tie`` of some 1e-6),
        else inf. Indices and gaps of shape z.shape[:-1]."""
        e64 = self.embedding.weight.detach().double()
        flat = z.detach().reshape(-1, z.shape[-1]).double()
        zz = (flat * flat).sum(1, keepdim=True)
        dist = zz + (e64 * e64).sum(1)[None, :] - 2.0 * flat @ e64.t()
        two = dist.topk(2, dim=1, largest=False)
        scale = zz[:, 0] + (e64 * e64).sum(1)[two.indices[:, 0]]
        gap = (two.values[:, 1] - two.values[:, 0]) / scale
        gap = torch.where(gap <= tie, gap, torch.full_like(gap, float("inf")))
        shape = z.shape[:-1]
        return (two.indices[:, 0].reshape(shape),
                two.indices[:, 1].reshape(shape), gap.reshape(shape))

    def codes(self, idx):
        """The code vectors of indices ``idx``."""
        e = self.embedding.weight
        return e.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (e.shape[1],))


class MSFPNVQModel(nn.Module):
    """``encode_interface``: NHWC image -> pre-quantization latents at the
    finest grid [coarse | fine]; ``decode_interface``: per-scale
    re-quantization, then the decoder."""

    def __init__(self, edconfig: Dict[str, Any], ddconfig: Dict[str, Any],
                 n_embed: Sequence[int], embed_dim: Sequence[int],
                 device=None, **unused):
        super().__init__()
        n = len(n_embed)
        self.embed_dim = list(embed_dim)
        z_ch = list(edconfig["z_channels"])
        self.encoder = MSEncoder(**dict(edconfig), device=device)
        self.decoder = Decoder(**dict(ddconfig), device=device)
        self.ms_quantize = nn.ModuleList([
            VectorQuantizer(k, d, device=device)
            for k, d in zip(n_embed, embed_dim)])
        self.ms_quant_conv = nn.ModuleList([
            Conv2d(z_ch[-1] if i == 0 else embed_dim[0], embed_dim[i], 1,
                   device=device) for i in range(n)])
        self.post_quant_conv = Conv2d(sum(embed_dim), ddconfig["z_channels"],
                                      1, device=device)
        self.upsample = nn.ModuleList([
            ConvTranspose2d(embed_dim[0], embed_dim[0], 4, 2, 1,
                            device=device) for _ in range(n - 1)])
        self.shared_post_quant_conv = nn.ModuleList([
            Conv2d(embed_dim[0], z_ch[0], 1, device=device)
            for _ in range(n - 1)])
        self.shared_decoder = nn.ModuleList([
            Decoder(**SHARED_DECODER, z_channels=sum(embed_dim[:i + 2]),
                    out_ch=embed_dim[0], device=device)
            for i in range(n - 1)])

    def encode_interface(self, x):
        h_ms = self.encoder(to_nchw(x))[::-1]          # coarse -> fine
        prev_h, h_out = [], []
        for ii, h_enc in enumerate(h_ms):
            fused = h_enc
            if prev_h:
                for j in range(ii):
                    prev_h[j] = self.shared_post_quant_conv[ii - 1](
                        self.upsample[ii - 1](prev_h[j]))
                fused = self.shared_decoder[ii - 1](
                    torch.cat(prev_h + [h_enc], dim=1))
            h = self.ms_quant_conv[ii](fused)
            quant = to_nchw(self.ms_quantize[ii].lookup(to_nhwc(h)))
            h_out.append(h)
            prev_h.append(quant)
        fine_first = h_out[::-1]
        up = []
        for i, b in enumerate(fine_first):
            for _ in range(i):
                b = interpolate_nearest_2x(b)
            up.append(b)
        return to_nhwc(torch.cat(up[::-1], dim=1))

    def decode_interface(self, h, dtype=None):
        """NHWC [coarse | fine] latent -> NHWC image; the codes are chosen
        on ``h`` as given, the decoder runs in ``dtype`` (h's by
        default)."""
        return self.decode_codes(self.nearest_codes(h)[0], dtype or h.dtype)

    def nearest_codes(self, h, tie: float = 0.0):
        """Per block of the latent: (nearest, second nearest, tie gaps), as
        :meth:`VectorQuantizer.nearest` gives them."""
        out, start = [], 0
        for quantizer, d in zip(self.ms_quantize, self.embed_dim):
            out.append(quantizer.nearest(h[..., start:start + d], tie))
            start += d
        return tuple(zip(*out))

    def decode_codes(self, codes, dtype=torch.float32):
        """The image of each block's code indices (coarse first), the
        decoder in ``dtype``."""
        quants = [q.codes(c) for q, c in zip(self.ms_quantize, codes)]
        quant = torch.cat(quants[::-1], dim=-1).to(dtype)   # [fine | coarse]
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(quant))))
