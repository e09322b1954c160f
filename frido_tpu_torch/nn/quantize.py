"""Codebook quantizers (port of ``frido_tpu/nn/quantize.py``):
``VectorQuantizer`` (the MS-VQGAN's), ``GumbelQuantize`` and
``EMAVectorQuantizer``.

Latents are channel-last [..., e_dim] (``GumbelQuantize``: NHWC
[B, H, W, num_hiddens]), as the JAX modules take them. Each ``forward``
returns ``(z_q, loss, indices)`` with the straight-through estimator baked
into ``z_q``. Training behaviour (Gumbel noise, the EMA update) follows
``self.training`` where the JAX modules take ``deterministic=False``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv2d, Embed
from frido_tpu_torch.ops.vq import vq_lookup

Quantized = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer with the commitment loss: ``legacy``
    gives ``|sg(z_q) - z|^2 + beta |z_q - sg(z)|^2``, else beta weighs the
    first term; both means over every element, in fp32."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 legacy: bool = True, device=None):
        super().__init__()
        self.beta, self.legacy = beta, legacy
        self.embedding = Embed(n_e, e_dim, device=device)

    def forward(self, z: torch.Tensor) -> Quantized:
        z_q, idx = vq_lookup(z, self.embedding.table())
        z32, zq32 = z.float(), z_q.float()
        codebook_term = (zq32.detach() - z32).square().mean()
        commit_term = (zq32 - z32.detach()).square().mean()
        if self.legacy:
            loss = codebook_term + self.beta * commit_term
        else:
            loss = self.beta * codebook_term + commit_term
        return z + (z_q - z).detach(), loss, idx

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding(indices)


def _gumbel(shape, dtype, device,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard Gumbel noise: -log(-log U), U in (0, 1). Every Gumbel draw
    goes through here, so a test can feed it another package's draws."""
    u = torch.rand(shape, generator=generator,
                   device=device if generator is None else generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return (-torch.log(-torch.log(u.clamp(min=tiny)))).to(device, dtype)


class GumbelQuantize(nn.Module):
    """Gumbel-softmax relaxed quantizer: a 1x1 conv to ``n_e`` logits; the
    hard argmax in eval, the noisy soft mixture in training (straight
    through a one-hot if ``straight_through``); a KL to the uniform prior
    weighted by ``kl_weight``."""

    def __init__(self, n_e: int, e_dim: int, num_hiddens: int,
                 straight_through: bool = True, kl_weight: float = 5e-4,
                 temperature: float = 1.0, device=None):
        super().__init__()
        self.n_e = n_e
        self.straight_through = straight_through
        self.kl_weight = kl_weight
        self.temperature = temperature
        self.proj = Conv2d(num_hiddens, n_e, 1, device=device)
        self.embed = Embed(n_e, e_dim, device=device)

    def forward(self, z: torch.Tensor, temperature: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> Quantized:
        temp = self.temperature if temperature is None else temperature
        logits = self.proj(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if not self.training:
            idx = logits.argmax(dim=-1)
            one_hot = F.one_hot(idx, self.n_e).to(z.dtype)
        else:
            g = _gumbel(logits.shape, logits.dtype, logits.device, generator)
            soft = torch.softmax((logits + g) / temp, dim=-1)
            idx = soft.argmax(dim=-1)
            one_hot = soft
            if self.straight_through:
                hard = F.one_hot(idx, self.n_e).to(soft.dtype)
                one_hot = hard + soft - soft.detach()
        z_q = one_hot @ self.embed.table()
        probs = torch.softmax(logits.float(), dim=-1)
        kl = self.kl_weight * (probs * torch.log(probs * self.n_e + 1e-10)
                               ).sum(-1).mean()
        return z_q, kl, idx.to(torch.int32)

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embed(indices)


class EMAVectorQuantizer(nn.Module):
    """Codebook kept by exponential moving averages of the assignments
    instead of gradients. Its state is three buffers named as the JAX
    ``ema`` collection's variables: ``embedding`` [n_e, e_dim],
    ``cluster_size`` [n_e], ``embed_avg`` [n_e, e_dim]. In training mode
    each call updates them from this batch's assignments; the returned
    ``z_q`` comes from the codebook before the update."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 decay: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.n_e, self.e_dim = n_e, e_dim
        self.beta, self.decay, self.eps = beta, decay, eps
        self.register_buffer("embedding",
                             torch.empty(n_e, e_dim, device=device))
        self.register_buffer("cluster_size", torch.empty(n_e, device=device))
        self.register_buffer("embed_avg",
                             torch.empty(n_e, e_dim, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 0.02) codebook, zero counts, the averages at the codebook,
        as the JAX module initialises."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=gen)
            self.cluster_size.zero_()
            self.embed_avg.copy_(self.embedding)

    def forward(self, z: torch.Tensor) -> Quantized:
        z_q, idx = vq_lookup(z, self.embedding)
        if self.training:
            self._update(z.detach().reshape(-1, self.e_dim).float(),
                         idx.reshape(-1))
        commit = self.beta * (z.float() - z_q.float().detach()
                              ).square().mean()
        return z + (z_q - z).detach(), commit, idx

    @torch.no_grad()
    def _update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        one_hot = F.one_hot(idx.long(), self.n_e).float()
        d = self.decay
        self.cluster_size.mul_(d).add_((1 - d) * one_hot.sum(0))
        self.embed_avg.mul_(d).add_((1 - d) * (one_hot.t() @ flat))
        n = self.cluster_size.sum()
        smoothed = ((self.cluster_size + self.eps)
                    / (n + self.n_e * self.eps) * n)
        self.embedding.copy_(self.embed_avg / smoothed[:, None])

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding[indices.long()]
