"""SPADE, the spatial transformer and the x-transformer text encoder of
the reference: frozen copies of the port's ``nn/spade.py``,
``nn/transformer.py`` and ``nn/xtransformer.py`` / ``nn/encoders.py``
(``BERTEmbedder``) on the plain layers of ``reference/layers.py``. Only
what the benchmark's configurations build is kept: the SPADE pre-norm,
no position embedding and no multi-scale conditioning branch."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import (Conv2d, Dense, Embed, GroupNorm, LayerNorm,
                              dot_attention, interpolate_nearest)


class SPADE(nn.Module):
    def __init__(self, norm_nc, label_nc, norm_eps=1e-5, kernel_size=3,
                 nhidden=128, device=None):
        super().__init__()
        pw = kernel_size // 2
        self.param_free_norm = GroupNorm(norm_nc, eps=norm_eps, device=device)
        if label_nc is None:
            return
        self.mlp_shared = nn.ModuleDict({"0": Conv2d(
            label_nc, nhidden, kernel_size, padding=pw, device=device)})
        self.mlp_gamma = Conv2d(nhidden, norm_nc, kernel_size, padding=pw,
                                device=device)
        self.mlp_beta = Conv2d(nhidden, norm_nc, kernel_size, padding=pw,
                               device=device)

    def gamma_beta(self, cond, hw):
        cond = interpolate_nearest(cond, hw)
        actv = F.relu(self.mlp_shared["0"](cond))
        return self.mlp_gamma(actv), self.mlp_beta(actv)

    def forward(self, x, cond, pre=None):
        normalized = self.param_free_norm(x)
        if pre is None and cond is None:
            return normalized
        gamma, beta = pre if pre is not None else self.gamma_beta(
            cond, tuple(x.shape[-2:]))
        return normalized * (1 + gamma) + beta


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, device=device)
        self.to_k = Dense(context_dim, inner, bias=False, device=device)
        self.to_v = Dense(context_dim, inner, bias=False, device=device)
        self.to_out = nn.ModuleDict({"0": Dense(inner, query_dim,
                                                device=device)})

    def forward(self, x, context=None):
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
    def __init__(self, dim, mult=4, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleDict({
            "0": nn.ModuleDict({"proj": Dense(dim, inner * 2, device=device)}),
            "2": Dense(inner, dim, device=device)})

    def forward(self, x):
        x1, gate = self.net["0"]["proj"](x).chunk(2, dim=-1)
        return self.net["2"](x1 * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None, device=None):
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
    """SPADE pre-norm (eps 1e-6) -> 1x1 proj-in -> tokens -> transformer
    blocks -> 1x1 proj-out, residual."""

    def __init__(self, in_channels, n_heads, d_head, depth, context_dim,
                 cond_channels, device=None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = SPADE(in_channels, cond_channels, norm_eps=1e-6,
                          device=device)
        self.proj_in = Conv2d(in_channels, inner, 1, device=device)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  device=device) for _ in range(depth)])
        self.proj_out = Conv2d(inner, in_channels, 1, device=device)

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


class XAttention(nn.Module):
    def __init__(self, dim, heads=8, dim_head=64, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False, device=device)
        self.to_k = Dense(dim, inner, bias=False, device=device)
        self.to_v = Dense(dim, inner, bias=False, device=device)
        self.to_out = Dense(inner, dim, device=device)

    def forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.to_k(x).reshape(b, n, h, d).transpose(1, 2)
        v = self.to_v(x).reshape(b, n, h, d).transpose(1, 2)
        out = dot_attention(q, k, v, d ** -0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class XFeedForward(nn.Module):
    def __init__(self, dim, mult=4, device=None):
        super().__init__()
        self.net = nn.ModuleDict({
            "0": nn.ModuleDict({"0": Dense(dim, dim * mult, device=device)}),
            "2": Dense(dim * mult, dim, device=device)})

    def forward(self, x):
        return self.net["2"](F.gelu(self.net["0"]["0"](x)))


class XEncoderLayers(nn.Module):
    def __init__(self, dim, depth, heads=8, dim_head=64, device=None):
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

    def forward(self, x):
        for norm, block in self.layers:
            x = block(norm(x)) + x
        return x


class PositionEmbedding(nn.Module):
    def __init__(self, max_seq_len, dim, device=None):
        super().__init__()
        self.emb = Embed(max_seq_len, dim, device=device)

    def forward(self, n: int):
        return self.emb(torch.arange(n, device=self.emb.weight.device))


class TransformerWrapper(nn.Module):
    def __init__(self, num_tokens, max_seq_len, dim, depth, heads=8,
                 dim_head=64, device=None):
        super().__init__()
        self.token_emb = Embed(num_tokens, dim, device=device)
        self.pos_emb = PositionEmbedding(max_seq_len, dim, device=device)
        self.attn_layers = XEncoderLayers(dim, depth, heads, dim_head,
                                          device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tokens):
        x = self.token_emb(tokens) + self.pos_emb(tokens.shape[1])[None]
        return self.norm(self.attn_layers(x))


class BERTEmbedder(nn.Module):
    """tokens [B, T] -> per-token embeddings [B, T, n_embed] (no mask:
    padded positions take part in attention, as in the original)."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, device=None, **unused):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.transformer = TransformerWrapper(
            num_tokens=vocab_size, max_seq_len=max_seq_len, dim=n_embed,
            depth=n_layer, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)
