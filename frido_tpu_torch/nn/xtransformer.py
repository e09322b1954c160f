"""x-transformer text encoder, the BERTEmbedder trunk (port of
``frido_tpu/nn/xtransformer.py:25-120``).

Token + absolute-position embeddings, pre-norm [self-attn, FF] stacks with
exact GELU, final LayerNorm, per-token embeddings out. No mask: the
original never passes one, so padded positions take part in attention.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Dense, Embed, LayerNorm
from frido_tpu_torch.nn.transformer import dot_attention


class XAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False, device=device)
        self.to_k = Dense(dim, inner, bias=False, device=device)
        self.to_v = Dense(dim, inner, bias=False, device=device)
        self.to_out = Dense(inner, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.to_k(x).reshape(b, n, h, d).transpose(1, 2)
        v = self.to_v(x).reshape(b, n, h, d).transpose(1, 2)
        out = dot_attention(q, k, v, d ** -0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class XFeedForward(nn.Module):
    """Linear -> GELU -> Linear (keys net.0.0 and net.2)."""

    def __init__(self, dim: int, mult: int = 4, device=None):
        super().__init__()
        self.net = nn.ModuleDict({
            "0": nn.ModuleDict({"0": Dense(dim, dim * mult, device=device)}),
            "2": Dense(dim * mult, dim, device=device),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net["2"](F.gelu(self.net["0"]["0"](x)))


class XEncoderLayers(nn.Module):
    """``layers.{2i}`` = (norm, attention), ``layers.{2i+1}`` = (norm, FF)."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 64, device=None):
        super().__init__()
        layers = []
        for _ in range(depth):
            layers.append(nn.ModuleList([
                LayerNorm(dim, device=device),
                XAttention(dim, heads, dim_head, device=device)]))
            layers.append(nn.ModuleList([
                LayerNorm(dim, device=device),
                XFeedForward(dim, device=device)]))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for norm, block in self.layers:
            x = block(norm(x)) + x
        return x


class PositionEmbedding(nn.Module):
    """AbsolutePositionalEmbedding (key pos_emb.emb.weight)."""

    def __init__(self, max_seq_len: int, dim: int, device=None):
        super().__init__()
        self.emb = Embed(max_seq_len, dim, device=device)

    def forward(self, n: int) -> torch.Tensor:
        return self.emb(torch.arange(n, device=self.emb.weight.device))


class TransformerWrapper(nn.Module):
    """return_embeddings=True: tokens [B, T] -> [B, T, dim]."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int,
                 depth: int, heads: int = 8, dim_head: int = 64, device=None):
        super().__init__()
        self.token_emb = Embed(num_tokens, dim, device=device)
        self.pos_emb = PositionEmbedding(max_seq_len, dim, device=device)
        self.attn_layers = XEncoderLayers(dim, depth, heads, dim_head,
                                          device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_emb(tokens) + self.pos_emb(tokens.shape[1])[None]
        return self.norm(self.attn_layers(x))
