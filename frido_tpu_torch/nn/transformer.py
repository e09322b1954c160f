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
The PyUNet's plain ``AttentionBlock`` (``nn/pyunet.py``) routes through
the same gates, one head per batch row: in the pixel-space DDPM its
1024-token self-attention takes flash, its 256- and 64-token ones smalls.
The gates are the JAX package's site sets, not measurements on the card.
On CPU tensors every kernel wrapper computes the plain form.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import (Conv2d, Dense, Embed, GroupNorm,
                                      LayerNorm)
from frido_tpu_torch.nn.spade import SPADE
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.attention import (attention_plain,
                                                flash_attention,
                                                smalls_attention)
from frido_tpu_torch.ops.image import interpolate_nearest


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., N, d], fp32 softmax, in q's
    dtype. Inputs of mixed dtypes (fp32 tokens promoted by a position
    embedding attending to a bf16 context) are promoted to their common
    dtype first, as ``jnp.einsum`` promotes them."""
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    if (q.dtype, k.dtype, v.dtype) != (dtype,) * 3:
        return dot_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                             scale).to(q.dtype)
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
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LayerNorm.

    ``use_mscond`` adds the previous-stage branch (``nn/transformer.py:
    150-187``): self-attention over the previous stage's tokens, then the
    block's tokens attending to them, between the self- and the
    cross-attention."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, use_mscond: bool = False,
                 device=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, device=device)
        self.ff = GEGLUFeedForward(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head,
                                    device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)
        self.use_mscond = use_mscond
        if use_mscond:
            self.attn_prev = CrossAttention(dim, None, n_heads, d_head,
                                            device=device)
            self.norm_prev = LayerNorm(dim, device=device)
            self.attn_cross = CrossAttention(dim, dim, n_heads, d_head,
                                             device=device)
            self.norm_cross = LayerNorm(dim, device=device)

    def forward(self, x, context=None, x_prev_stage=None):
        x = self.attn1(self.norm1(x)) + x
        if x_prev_stage is not None and self.use_mscond:
            prev = self.attn_prev(self.norm_prev(x_prev_stage)) + x_prev_stage
            x = self.attn_cross(self.norm_cross(x), context=prev) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Pre-norm -> 1x1 proj-in -> tokens (+ position embedding) ->
    transformer blocks -> 1x1 proj-out, residual (``nn/transformer.py:
    190-265``). ``proj_out`` starts at zero, as the original's
    ``zero_module``.

    The pre-norm is SPADE (eps 1e-6) with ``use_spade``, else GroupNorm
    (eps 1e-6). ``cond_channels``: the channels of the previous stage's
    feature map this site is given, or None where it never gets one (a
    stage-0 expert trunk, a one-stage model); SPADE's modulation convs and
    the ``use_mscond`` branch (``cond_proj_in`` on the feature map
    resized to this grid, then ``attn_prev``/``attn_cross`` in each block)
    exist only with it, as the JAX package creates them on their first
    call. ``pos_embed_size`` > 0 adds a learned position embedding: token
    ``t`` of an h x w grid takes ``(pos_embed[t // h] + pos_embed[t % h])
    / 2``, the original's transposed ``meshgrid`` (``nn/transformer.py:
    249-258``), which is not row / column on a grid that is not square."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int, context_dim: Optional[int],
                 cond_channels: Optional[int], use_spade: bool = True,
                 pos_embed_size: int = -1, use_mscond: bool = False,
                 device=None):
        super().__init__()
        inner = n_heads * d_head
        self.use_spade = use_spade
        if use_spade:
            self.norm = SPADE(in_channels, cond_channels, norm_eps=1e-6,
                              device=device)
        else:
            self.norm = GroupNorm(in_channels, eps=1e-6, device=device)
        self.pos_embed = (Embed(pos_embed_size, in_channels, device=device)
                          if pos_embed_size > 0 else None)
        self.proj_in = Conv2d(in_channels, inner, 1, device=device)
        mscond = use_mscond and cond_channels is not None
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  mscond, device=device)
            for _ in range(depth)])
        self.proj_out = Conv2d(inner, in_channels, 1, zero_init=True,
                               device=device)
        self.cond_proj_in = (Conv2d(cond_channels, inner, 1, device=device)
                             if mscond else None)

    def spade_tables(self, cond, hw):
        return self.norm.gamma_beta(cond, hw) if self.use_spade else None

    def forward(self, x, context=None, feat_cond=None, spade_pre=None):
        b, _, h, w = x.shape
        x_in = x
        x = self.norm(x, feat_cond, spade_pre) if self.use_spade \
            else self.norm(x)
        prev = None
        if feat_cond is not None and self.cond_proj_in is not None:
            fc = self.cond_proj_in(interpolate_nearest(feat_cond, (h, w)))
            prev = fc.reshape(b, fc.shape[1], h * w).transpose(1, 2)
        x = self.proj_in(x)
        c = x.shape[1]
        x = x.reshape(b, c, h * w).transpose(1, 2)
        if self.pos_embed is not None:
            t = torch.arange(h * w, device=x.device)
            # an fp32 table promotes bf16 tokens, as jnp does
            x = x + ((self.pos_embed(t // h) + self.pos_embed(t % h))
                     / 2.0)[None]
        for block in self.transformer_blocks:
            x = block(x, context=context, x_prev_stage=prev)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(x) + x_in
