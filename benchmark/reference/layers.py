"""Plain layers of the benchmark's reference: a frozen copy of the port's
plain paths (``frido_tpu_torch/nn/layers.py``, ``ops/image.py``,
``ops/cuda/attention.py::attention_plain``), with no kernel routing, no
tensor parallelism and no initialisers (weights come from the benchmark's
seeded state dict). Parameter names and layouts are the port's, so one
state dict loads into both.

Dtype policy, as the port's: each conv and matmul casts its weights to
the activation dtype; norms compute in fp32 and cast back. GroupNorm is
``F.group_norm`` on fp32 (two-pass statistics), attention an fp32 softmax
between two products.

A layer's ``quant`` (a :class:`Quant`, set by ``reference/precision.py``
for the control) rounds each product's input and weight before the
product; without it the layer computes as given.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class Quant:
    """Where a control rounds the products' operands: ``fn(t)`` applied to
    the input and the weight of every layer whose ``quant`` is this
    object and ``fn`` is set."""

    def __init__(self):
        self.fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.fn is None else self.fn(t)


class _Linearish(nn.Module):
    quant: Optional[Quant] = None

    def _make(self, shape, bias: bool, device, features: Optional[int] = None):
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        n = shape[0] if features is None else features
        self.bias = (nn.Parameter(torch.empty(n, device=device)) if bias
                     else None)

    def _xwb(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return x, w, b


class Conv2d(_Linearish):
    fan_axis = 0

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 bias=True, device=None):
        super().__init__()
        k = kernel_size
        self._make((cout, cin, k, k), bias, device)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w, b = self._xwb(x)
        return F.conv2d(x, w, b, self.stride, self.padding)


class ConvTranspose2d(_Linearish):
    fan_axis = 1

    def __init__(self, cin, cout, kernel_size=4, stride=2, padding=1,
                 bias=True, device=None):
        super().__init__()
        k = kernel_size
        self._make((cin, cout, k, k), bias, device, features=cout)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w, b = self._xwb(x)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding)


class Conv1d(_Linearish):
    fan_axis = 0

    def __init__(self, cin, cout, kernel_size=1, padding=0, bias=True,
                 device=None):
        super().__init__()
        self._make((cout, cin, kernel_size), bias, device)
        self.padding = padding

    def forward(self, x):
        x, w, b = self._xwb(x)
        return F.conv1d(x, w, b, 1, self.padding)


class Dense(_Linearish):
    fan_axis = 0

    def __init__(self, cin, cout, bias=True, device=None):
        super().__init__()
        self._make((cout, cin), bias, device)

    def forward(self, x):
        x, w, b = self._xwb(x)
        return F.linear(x, w, b)


class Embed(nn.Module):
    def __init__(self, num_embeddings, features, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight)


class _Affine(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))


class GroupNorm(_Affine):
    def __init__(self, channels, num_groups=32, eps=1e-6, device=None):
        super().__init__(channels, device)
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x, fuse_silu=False):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        if fuse_silu:
            y = F.silu(y)
        return y.to(x.dtype)


class LayerNorm(_Affine):
    def __init__(self, channels, eps=1e-5, device=None):
        super().__init__(channels, device)
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def dot_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v over [..., N, d] in the inputs' common
    dtype, fp32 scores and softmax."""
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.matmul(p, v)


def to_nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def interpolate_nearest_2x(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def interpolate_nearest(x, size: Tuple[int, int]):
    """Nearest resize, source index ``floor(dst * in / out)``."""
    h, w = x.shape[-2:]
    out_h, out_w = size
    if (out_h, out_w) == (h, w):
        return x
    rows = torch.floor(torch.arange(out_h, dtype=torch.float64) * (h / out_h))
    cols = torch.floor(torch.arange(out_w, dtype=torch.float64) * (w / out_w))
    rows = rows.long().clamp(0, h - 1).to(x.device)
    cols = cols.long().clamp(0, w - 1).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def avg_pool_2x(x):
    return F.avg_pool2d(x, 2, 2)


def linear_layers(root: nn.Module) -> Sequence[_Linearish]:
    return [m for m in root.modules() if isinstance(m, _Linearish)]
