"""Primitive layers (port of ``frido_tpu/nn/layers.py``), channel-first.

Parameters are stored in torch layouts and fp32: ``Conv2d.weight``
[O, I, kH, kW], ``ConvTranspose2d.weight`` [I, O, kH, kW],
``Conv1d.weight`` [O, I, k], ``Dense.weight`` [O, I], ``Embed.weight``
[N, D], norms ``weight``/``bias``.

Dtype policy, the JAX package's (``nn/layers.py:221, 404-409, 447-453``):
each conv and matmul casts its weights to the activation dtype, and norms
compute in fp32 and cast back. It is applied per layer, not through
``torch.autocast``.

Kernel routing, the JAX package's (``nn/layers.py:223-296``,
``ops/norm.py:53``) under the switches of ``ops/cuda/dispatch.py``:
``GroupNorm`` takes the group-norm kernel under ``FRIDO_GN_PALLAS=1``;
``Conv2d`` takes the conv kernel at every 3x3 / stride-1 / pad-1 site
under ``FRIDO_CONV_MODE=pallas`` or ``pallas_fused``, and its
``fused_norm`` route (the ResBlock prologue folded into the conv) runs the
prologue variant. Elsewhere both keep their plain PyTorch form.

Tensor parallelism (``parallel/tp.py``): each layer declares where its
weight's JAX axes went (``jax_axes``). A layer whose weight
``tp.shard_module_`` cut to this rank's output channels (vocab rows for
``Embed``) holds its :class:`~frido_tpu_torch.parallel.tp.Shard` in
``tp``: it computes its own channels (the same kernels at cout / n_model)
with its slice of the replicated bias and gathers them along the channel
axis; ``Embed`` looks up its own rows and all-reduces, and
:meth:`Embed.table` gives the whole table. ``tp`` is None otherwise.

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

from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.parallel import tp as tp_ops
from frido_tpu_torch.ops.cuda.conv import conv3x3, conv3x3_norm_silu
from frido_tpu_torch.ops.cuda.norm import group_norm, group_norm_plain


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class _Linearish(nn.Module):
    """Shared parameter handling for Conv2d, ConvTranspose2d, Conv1d and
    Dense: ``jax_axes`` (the JAX kernel axis of each torch dim of the
    weight), ``out_dim`` (the output's channel axis) and ``tp`` (the
    weight's model shard, or None)."""

    tp: Optional[tp_ops.Shard] = None
    out_dim = 1

    def _make(self, shape, fan_in: int, bias: bool, zero_init: bool, device,
              features: Optional[int] = None):
        """``features``: the bias length, by default ``shape[0]``."""
        self.fan_in = fan_in
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        n = shape[0] if features is None else features
        self.bias = (nn.Parameter(torch.empty(n, device=device))
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
        b = self.bias
        if b is not None and self.tp is not None:
            b = tp_ops.bias(b, self.tp)
        b = None if b is None else b.to(dtype)
        return self.weight.to(dtype), b

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else tp_ops.enter(x, self.tp)

    def _leave(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.tp is None else tp_ops.gather(y, self.out_dim,
                                                       self.tp)


class Conv2d(_Linearish):
    """torch-style Conv2d; weights cast to the input dtype.

    ``fused_norm`` (the arguments of :meth:`GroupNorm.fused_args`) asks for
    GroupNorm -> SPADE modulation -> SiLU -> this conv as one kernel; only
    a 3x3 / stride-1 / pad-1 conv takes it."""

    jax_axes = (3, 2, 0, 1)       # HWIO

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 zero_init: bool = False, device=None):
        super().__init__()
        k = kernel_size
        self._make((cout, cin, k, k), cin * k * k, bias, zero_init, device)
        self.stride = stride
        self.padding = padding

    @property
    def is_3x3_same(self) -> bool:
        return (self.weight.shape[-1] == 3 and self.stride == 1
                and self.padding == 1)

    def forward(self, x: torch.Tensor,
                fused_norm: Optional[dict] = None) -> torch.Tensor:
        x = self._enter(x)
        w, b = self._wb(x.dtype)
        if fused_norm is None and not (self.is_3x3_same
                                       and dispatch.use_conv_kernel()):
            return self._leave(F.conv2d(x, w, b, self.stride, self.padding))
        if not self.is_3x3_same:
            raise ValueError("fused_norm needs a 3x3 / stride-1 / pad-1 conv")
        if fused_norm is not None:
            if self.tp is not None:
                fused_norm = {k: self._enter(v) if isinstance(
                    v, torch.Tensor) else v for k, v in fused_norm.items()}
            return self._leave(conv3x3_norm_silu(x, w, b, **fused_norm))
        return self._leave(conv3x3(x, w, b))


class ConvTranspose2d(_Linearish):
    """torch-style ConvTranspose2d (the JAX package's ``ConvTranspose2d``,
    an input-dilated conv over ``kernel_t``); weight [Cin, Cout, k, k].

    The JAX package computes it in XLA, outside any Pallas kernel, so it
    stays on ``F.conv_transpose2d`` in every configuration. It initialises
    as the flax layer does: U(+-1/sqrt(k*k*Cin)), bias 0."""

    jax_axes = (2, 3, 0, 1)       # kernel_t is HWIO

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, bias: bool = True,
                 device=None):
        super().__init__()
        k = kernel_size
        self._make((cin, cout, k, k), cin * k * k, bias, False, device,
                   features=cout)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._enter(x)
        w, b = self._wb(x.dtype)
        return self._leave(F.conv_transpose2d(x, w, b, self.stride,
                                              self.padding))


class Conv1d(_Linearish):
    """torch-style Conv1d on [N, C, T]."""

    jax_axes = (2, 1, 0)          # kIO

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 padding: int = 0, bias: bool = True, zero_init: bool = False,
                 device=None):
        super().__init__()
        k = kernel_size
        self._make((cout, cin, k), cin * k, bias, zero_init, device)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._enter(x)
        w, b = self._wb(x.dtype)
        return self._leave(F.conv1d(x, w, b, 1, self.padding))


class Dense(_Linearish):
    """torch-style Linear over the last axis."""

    jax_axes = (1, 0)             # [I, O]
    out_dim = -1

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 zero_init: bool = False, device=None):
        super().__init__()
        self._make((cout, cin), cin, bias, zero_init, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._enter(x)
        w, b = self._wb(x.dtype)
        return self._leave(F.linear(x, w, b))


class Embed(nn.Module):
    """torch-style Embedding; ``weight`` [num, dim] (the JAX
    ``embedding``, as-is); under tensor parallelism its rows are split
    over the model ranks."""

    jax_axes = (0, 1)
    embedding = True
    tp: Optional[tp_ops.Shard] = None

    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        # the table's rows, also when the weight holds a TP or FSDP part
        self.num_embeddings = num_embeddings
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return tp_ops.embed(ids.long(), self.weight, self.tp)
        return F.embedding(ids.long(), self.weight)

    def table(self) -> torch.Tensor:
        """The whole table (gathered from the model ranks when split)."""
        if self.tp is None:
            return self.weight
        return tp_ops.gather(self.weight, 0, self.tp)


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
    """GroupNorm over dim 1 (channels), fp32 compute, optional fused SiLU;
    the group-norm kernel under ``FRIDO_GN_PALLAS=1``."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 device=None):
        super().__init__(channels, device)
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor, fuse_silu: bool = False) -> torch.Tensor:
        norm = (group_norm if dispatch.use_group_norm_kernel()
                else group_norm_plain)
        return norm(x, self.weight, self.bias, self.num_groups, self.eps,
                    fuse_silu)

    def fused_args(self, gamma: Optional[torch.Tensor] = None,
                   beta: Optional[torch.Tensor] = None) -> dict:
        """This norm's parameters as :class:`Conv2d`'s ``fused_norm``, with
        optional SPADE tables (the JAX package's ``GroupNorm(raw=True)``
        accessor)."""
        return dict(nscale=self.weight, nbias=self.bias,
                    num_groups=self.num_groups, eps=self.eps, gamma=gamma,
                    beta=beta)


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


def seed_init_(root: nn.Module, seed: Optional[int],
               device: torch.device) -> nn.Module:
    """:func:`init_module_` from a generator on ``device`` seeded with
    ``seed``; nothing for ``seed=None`` or on the ``meta`` device."""
    if seed is not None and device.type != "meta":
        init_module_(root, torch.Generator(device=device).manual_seed(seed))
    return root


def init_module_(root: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every module under ``root`` that has a
    ``reset_parameters(gen)`` (the layers here, the EMA codebook), in
    module order, from ``gen``."""
    for mod in root.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return root
