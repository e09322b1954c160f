"""CLIP text and vision towers (port of ``frido_tpu/nn/clip.py``).

The encoders behind the original FrozenCLIPEmbedder,
FrozenCLIPTextEmbedder and FrozenClipImageEmbedder. The modules carry the
HF/torch key tree that the JAX names encode
(``transformer.text_model.embeddings.token_embedding``,
``transformer.text_model.encoder.layers.N.self_attn.q_proj``,
``text_projection``, ``model.visual.embeddings.class_embedding``, ...), so
a JAX tree maps onto them through ``io/jax_weights.py`` and a Lightning
checkpoint's ``cond_stage_model.*`` loads name for name.

The math is the JAX package's: quick-GELU, pre-LN blocks, fp32 scores
scaled by 1/sqrt(d), the text tower's causal mask filled with -1e9 (not
-inf), an fp32 softmax cast to x's dtype, EOT pooling at the ``argmax`` of
the token ids (the first maximum), L2 normalisation, ``repeat``. The JAX
package computes this attention with plain einsums outside any Pallas
kernel (``clip.py:49-65``), so it stays ``torch.matmul`` here in every
kernel configuration: the short-sequence kernel takes no mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from frido_tpu_torch.nn.layers import Conv2d, Dense, Embed, LayerNorm
from frido_tpu_torch.ops.image import resize, to_nchw, to_nhwc

# CLIP pixel normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head attention, HF CLIP key names (q/k/v/out_proj)."""

    def __init__(self, hidden: int, heads: int, device=None):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.q_proj = Dense(hidden, hidden, device=device)
        self.k_proj = Dense(hidden, hidden, device=device)
        self.v_proj = Dense(hidden, hidden, device=device)
        self.out_proj = Dense(hidden, hidden, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.heads
        d = self.hidden // h

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = (heads(p(x)) for p in (self.q_proj, self.k_proj,
                                         self.v_proj))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(d)
        if causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~mask, -1e9)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.matmul(p.float(), v.float()).to(x.dtype)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, self.hidden))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, device=None):
        super().__init__()
        self.fc1 = Dense(hidden, intermediate, device=device)
        self.fc2 = Dense(intermediate, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 device=None):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, device=device)
        self.self_attn = CLIPAttention(hidden, heads, device=device)
        self.layer_norm2 = LayerNorm(hidden, device=device)
        self.mlp = CLIPMLP(hidden, intermediate, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal=causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    """``encoder.layers.N``."""

    def __init__(self, hidden: int, layers: int, heads: int,
                 intermediate: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(hidden, heads, intermediate, device=device)
            for _ in range(layers)])

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal=causal)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_positions: int,
                 device=None):
        super().__init__()
        self.token_embedding = Embed(vocab_size, hidden, device=device)
        self.position_embedding = Embed(max_positions, hidden, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return self.token_embedding(tokens) + self.position_embedding(pos)[None]


class CLIPTextTower(nn.Module):
    """HF ``CLIPTextModel.text_model``: embeddings -> causal encoder ->
    final LayerNorm. Defaults are clip-vit-large-patch14's text tower."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 77, device=None):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(vocab_size, hidden,
                                             max_positions, device=device)
        self.encoder = CLIPEncoder(hidden, layers, heads, intermediate,
                                   device=device)
        self.final_layer_norm = LayerNorm(hidden, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.encoder(self.embeddings(tokens), causal=True)
        return self.final_layer_norm(x)


class _TextTransformer(nn.Module):
    """The ``transformer`` node of the key tree (HF's ``CLIPTextModel``)."""

    def __init__(self, **tower):
        super().__init__()
        self.text_model = CLIPTextTower(**tower)


def _tower_args(vocab_size, hidden, layers, heads, intermediate,
                max_positions, device):
    return dict(vocab_size=vocab_size, hidden=hidden, layers=layers,
                heads=heads, intermediate=intermediate,
                max_positions=max_positions, device=device)


class CLIPTextModule(nn.Module):
    """Per-token last hidden state for cross-attention (FrozenCLIPEmbedder);
    keys ``transformer.text_model.*``."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 77, device=None):
        super().__init__()
        self.transformer = _TextTransformer(**_tower_args(
            vocab_size, hidden, layers, heads, intermediate, max_positions,
            device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer.text_model(tokens)


class CLIPTextPooledModule(nn.Module):
    """The projected, normalised pooled text embedding, repeated
    ``n_repeat`` times (FrozenCLIPTextEmbedder): [B, n_repeat, proj]. The
    pooled position is the EOT token's, the ``argmax`` of the ids (EOT
    has the largest id of the CLIP vocab; the first maximum is taken)."""

    def __init__(self, vocab_size: int = 49408, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 77, projection_dim: int = 768,
                 n_repeat: int = 1, normalize: bool = True, device=None):
        super().__init__()
        self.transformer = _TextTransformer(**_tower_args(
            vocab_size, hidden, layers, heads, intermediate, max_positions,
            device))
        self.text_projection = Dense(hidden, projection_dim, bias=False,
                                     device=device)
        self.n_repeat = n_repeat
        self.normalize = normalize

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.transformer.text_model(tokens)
        # torch.argmax documents no tie rule: the first maximum explicitly
        is_max = tokens == tokens.max(dim=1, keepdim=True).values
        eot = is_max.int().argmax(dim=1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eot]
        z = self.text_projection(pooled)
        if self.normalize:
            z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
        return z[:, None, :].repeat(1, self.n_repeat, 1)


class CLIPVisionEmbeddings(nn.Module):
    """Patch conv, class embedding (a direct parameter, N(0, 0.02) at
    init) and position embedding."""

    def __init__(self, hidden: int, patch: int, n_pos: int, device=None):
        super().__init__()
        self.patch_embedding = Conv2d(3, hidden, patch, stride=patch,
                                      bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(hidden,
                                                        device=device))
        self.position_embedding = Embed(n_pos, hidden, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.class_embedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        p = to_nhwc(self.patch_embedding(to_nchw(images)))
        p = p.reshape(b, -1, p.shape[-1])
        cls = self.class_embedding.to(p.dtype).expand(b, 1, -1)
        x = torch.cat([cls, p], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class CLIPVisionTower(nn.Module):
    """CLIP ViT image tower (FrozenClipImageEmbedder): patch conv ->
    [CLS | patches] + position embedding -> pre-LN transformer -> post LN
    on CLS -> projection. Defaults are ViT-L/14. ``pre_layrnorm`` is HF's
    key, typo included."""

    def __init__(self, hidden: int = 1024, layers: int = 24, heads: int = 16,
                 intermediate: int = 4096, patch: int = 14,
                 image_size: int = 224, projection_dim: int = 768,
                 device=None):
        super().__init__()
        n_pos = (image_size // patch) ** 2 + 1
        self.embeddings = CLIPVisionEmbeddings(hidden, patch, n_pos,
                                               device=device)
        self.pre_layrnorm = LayerNorm(hidden, device=device)
        self.encoder = CLIPEncoder(hidden, layers, heads, intermediate,
                                   device=device)
        self.post_layernorm = LayerNorm(hidden, device=device)
        self.visual_projection = Dense(hidden, projection_dim, bias=False,
                                       device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC [B, H, W, 3], CLIP-normalised -> [B, proj]."""
        x = self.pre_layrnorm(self.embeddings(images))
        x = self.encoder(x, causal=False)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


def clip_preprocess(x: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC images -> bicubic (antialiased, ``jax.image.resize``)
    to ``image_size``, then CLIP-normalised."""
    b, _, _, c = x.shape
    x = resize(x, (b, image_size, image_size, c), method="bicubic")
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
