"""Spatial transformer for cross-attention conditioning (port of
``frido_tpu/nn/transformer.py``), channel-first around token-major attention.

:func:`dot_attention` is the one dispatch point for every attention of the
port (``frido_tpu/nn/transformer.py:67-98``), under the switches of
``ops/cuda/dispatch.py``. An attention over at least 512 keys goes to the
hand-written flash kernel: on the t2i path that is the VQGAN decoder's
1024-token ``AttnBlock``, the site set where the JAX package uses its
Pallas flash kernel (``nn/transformer.py:87-90``). Under
``FRIDO_SMALLS_ATTN=1`` every other attention of at most 512 tokens (UNet
self-attention over 256/64/16 tokens, cross-attention and the BERT encoder
over 77) goes to the short-sequence kernel; without it they take the plain
matmul-softmax-matmul form, as the JAX package leaves those sites to XLA.
The gates are the JAX package's site sets, not measurements on the card.
On CPU tensors every kernel wrapper computes the plain form.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv2d, Dense, LayerNorm
from frido_tpu_torch.nn.spade import SPADE
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.attention import (attention_plain,
                                                flash_attention,
                                                smalls_attention)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d], fp32 softmax."""
    nq, nk = q.shape[-2], k.shape[-2]
    if dispatch.use_flash(nk):
        return flash_attention(q, k, v, scale)
    if dispatch.use_smalls(nq, nk):
        return smalls_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


class CrossAttention(nn.Module):
    """Multi-head attention; context defaults to x."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, device=device)
        self.to_k = Dense(context_dim, inner, bias=False, device=device)
        self.to_v = Dense(context_dim, inner, bias=False, device=device)
        # original: to_out = Sequential(Linear, Dropout) -> key to_out.0
        self.to_out = nn.ModuleDict({"0": Dense(inner, query_dim,
                                                device=device)})

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.to_k(context).reshape(b, m, h, d).transpose(1, 2)
        v = self.to_v(context).reshape(b, m, h, d).transpose(1, 2)
        out = dot_attention(q, k, v, d ** -0.5)
        return self.to_out["0"](out.transpose(1, 2).reshape(b, n, h * d))


class GEGLUFeedForward(nn.Module):
    """GEGLU projection + Linear (keys ff.net.0.proj, ff.net.2)."""

    def __init__(self, dim: int, mult: int = 4, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleDict({
            "0": nn.ModuleDict({"proj": Dense(dim, inner * 2, device=device)}),
            "2": Dense(inner, dim, device=device),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, gate = self.net["0"]["proj"](x).chunk(2, dim=-1)
        return self.net["2"](x1 * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LayerNorm."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, device=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, device=device)
        self.ff = GEGLUFeedForward(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head,
                                    device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """SPADE pre-norm (eps 1e-6, ``nn/transformer.py:208``) -> 1x1 proj-in
    -> tokens -> transformer blocks -> 1x1 proj-out, residual. ``proj_out``
    starts at zero, as the original's ``zero_module``.

    The plain GroupNorm pre-norm (no Frido config uses it), the learned
    position embedding and the previous-stage cross-attention branch
    (``use_mscond``) are off on the t2i path and not ported yet."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int, context_dim: Optional[int],
                 spade_channels: int, device=None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = SPADE(in_channels, spade_channels, norm_eps=1e-6,
                          device=device)
        self.proj_in = Conv2d(in_channels, inner, 1, device=device)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  device=device)
            for _ in range(depth)])
        self.proj_out = Conv2d(inner, in_channels, 1, zero_init=True,
                               device=device)

    def spade_tables(self, cond, hw):
        return self.norm.gamma_beta(cond, hw)

    def forward(self, x, context=None, feat_cond=None, spade_pre=None):
        b, _, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x, feat_cond, spade_pre))
        c = x.shape[1]
        x = x.reshape(b, c, h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            x = block(x, context=context)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(x) + x_in
