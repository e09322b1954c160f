"""Primitive layers (port of ``frido_tpu/nn/layers.py``), channel-first.

Parameters are stored in torch layouts and fp32: ``Conv2d.weight``
[O, I, kH, kW], ``Conv1d.weight`` [O, I, k], ``Dense.weight`` [O, I],
``Embed.weight`` [N, D], norms ``weight``/``bias``.

Dtype policy, the JAX package's (``nn/layers.py:221, 404-409, 447-453``):
each conv and matmul casts its weights to the activation dtype, and norms
compute in fp32 and cast back. It is applied per layer, not through
``torch.autocast``.

Initialisers follow the JAX package too: convs and dense layers draw
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (flax ``variance_scaling(1/3, fan_in,
uniform)``), biases start at 0, ``zero_init`` layers at 0, embeddings from
N(0, 0.02), norms at (1, 0). :func:`init_module_` applies them from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.ops.norm import group_norm


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class _Linearish(nn.Module):
    """Shared parameter handling for Conv2d / Conv1d / Dense."""

    def _make(self, shape, fan_in: int, bias: bool, zero_init: bool, device):
        self.fan_in = fan_in
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = (nn.Parameter(torch.empty(shape[0], device=device))
                     if bias else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                _uniform_(self.weight, 1.0 / math.sqrt(self.fan_in), gen)
            if self.bias is not None:
                self.bias.zero_()

    def _wb(self, dtype):
        b = None if self.bias is None else self.bias.to(dtype)
        return self.weight.to(dtype), b


class Conv2d(_Linearish):
    """torch-style Conv2d; weights cast to the input dtype."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 zero_init: bool = False, device=None):
        super().__init__()
        k = kernel_size
        self._make((cout, cin, k, k), cin * k * k, bias, zero_init, device)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._wb(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding)


class Conv1d(_Linearish):
    """torch-style Conv1d on [N, C, T]."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 padding: int = 0, bias: bool = True, zero_init: bool = False,
                 device=None):
        super().__init__()
        k = kernel_size
        self._make((cout, cin, k), cin * k, bias, zero_init, device)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._wb(x.dtype)
        return F.conv1d(x, w, b, 1, self.padding)


class Dense(_Linearish):
    """torch-style Linear over the last axis."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 zero_init: bool = False, device=None):
        super().__init__()
        self._make((cout, cin), cin, bias, zero_init, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self._wb(x.dtype)
        return F.linear(x, w, b)


class Embed(nn.Module):
    """torch-style Embedding; ``weight`` [num, dim]."""

    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


class _Affine(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class GroupNorm(_Affine):
    """GroupNorm over dim 1 (channels), fp32 compute, optional fused SiLU."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 device=None):
        super().__init__(channels, device)
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor, fuse_silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, fuse_silu)


class LayerNorm(_Affine):
    """LayerNorm over the last axis (eps 1e-5), fp32 compute."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__(channels, device)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def init_module_(root: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every layer under ``root`` (in module order) from ``gen``."""
    for mod in root.modules():
        if isinstance(mod, (_Linearish, Embed, _Affine)):
            mod.reset_parameters(gen)
    return root
