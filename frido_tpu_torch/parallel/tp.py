"""Tensor parallelism over the layout's model ranks (port of
``frido_tpu/parallel/tp.py``).

The JAX rule, per parameter leaf: a conv, conv-transpose or dense kernel
has its output features (its last axis) sharded over ``model`` when they
divide by the model axis; an ``embedding`` [vocab, dim] has its vocab
rows sharded; 1-D leaves (biases, norm scales) and anything that does not
divide stay replicated. The port stores torch layouts, so each layer
declares where the JAX axes went (``jax_axes``: the JAX axis of each
torch dim, from ``io/jax_weights.py``'s transposes) and the rule runs in
JAX axis order:

==================  ======================  ==========================
layer               torch weight            sharded torch dim
==================  ======================  ==========================
``Conv2d``          [O, I, kH, kW]          0 (cout)
``Dense``           [O, I]                  0 (cout)
``Conv1d``          [O, I, k]               0 (cout)
``ConvTranspose2d`` [I, O, kH, kW]          1 (cout)
``Embed``           [N, D]                  0 (vocab)
==================  ======================  ==========================

The PyUNet's options add no layer of their own: the
``AttentionBlock``'s ``qkv``/``proj_out`` are ``Conv1d``, ``label_emb``
an ``Embed`` (vocab rows) or a ``Dense``, ``pos_embed`` an ``Embed``, the
mscond branch, the expert trunks and the id head convs and dense layers,
so the rule covers every leaf, as ``tests/test_torch_pyunet_options.py``
holds against the JAX rule.

At run time (``nn/layers.py``) a sharded conv, dense or conv-transpose
computes its own output channels with its slice of the (replicated) bias
and all-gathers them along the channel axis, so every consumer sees the
whole tensor, as the JAX package's replicated consumers do. The gradients
follow Megatron's pair: each input enters through :func:`enter`
(identity forward, all-reduce of the gradient over the model ranks), the
output leaves through :func:`gather` (all-gather forward, this rank's
slice of the gradient backward). A vocab-sharded embedding looks up its
own rows, zeroes the others' and all-reduces (:func:`embed`); whoever
needs the whole table (the VQ codebook) takes :func:`gather` of it.

Later work: head-sharded attention that skips the gather.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as tdist
import torch.nn.functional as F


class Shard(NamedTuple):
    """Where a parameter's model shard sits: ``dim`` of the full weight
    cut in ``size`` equal parts over ``group``, this rank's part
    ``index``."""
    group: Any
    size: int
    index: int
    dim: int


def leaf_spec(shape: Sequence[int], jax_axes: Sequence[int],
              embedding: bool, n_model: int) -> Optional[int]:
    """The torch dim the JAX rule shards over ``model`` for a leaf of torch
    ``shape`` whose dim ``i`` is JAX axis ``jax_axes[i]``; None when it
    stays replicated (``frido_tpu/parallel/tp.py:30-43``)."""
    if n_model <= 1 or len(shape) < 2:
        return None
    jshape = [shape[jax_axes.index(j)] for j in range(len(shape))]
    axis = 0 if embedding else len(shape) - 1
    if jshape[axis] % n_model:
        return None
    return jax_axes.index(axis)


def owner_axes(module: torch.nn.Module, pname: str, ndim: int):
    """(jax_axes, embedding) of ``module``'s parameter ``pname``: the
    layer's declared layout for its ``weight``, else the identity (the
    JAX leaf is stored as-is)."""
    if pname == "weight" and hasattr(module, "jax_axes"):
        return tuple(module.jax_axes), bool(getattr(module, "embedding",
                                                    False))
    return tuple(range(ndim)), False


def param_specs(model: torch.nn.Module, n_model: int):
    """{parameter name: (torch dim or None, jax_axes, embedding)} under the
    rule, on the full shapes."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            axes, emb = owner_axes(mod, pname, p.ndim)
            name = f"{mname}.{pname}" if mname else pname
            out[name] = (leaf_spec(tuple(p.shape), axes, emb, n_model),
                         axes, emb)
    return out


def local(full: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's part of a full tensor (a view)."""
    n = full.shape[shard.dim] // shard.size
    return full.narrow(shard.dim, shard.index * n, n)


@torch.no_grad()
def gather_full(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The full tensor from every rank's part (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    tdist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts, dim=shard.dim)


def shard_module_(model: torch.nn.Module, layout) -> dict:
    """Cut every weight the rule shards to this rank's part, in place
    (the same ``Parameter``: an optimizer built before keeps it), and give
    its layer the :class:`Shard`. Returns {parameter name: Shard}."""
    specs = param_specs(model, layout.n_model)
    shards = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            dim = specs[name][0]
            if dim is None:
                continue
            if pname != "weight" or not hasattr(mod, "jax_axes"):
                raise NotImplementedError(
                    f"tensor parallelism of {name} ({type(mod).__name__}): "
                    f"only the layers of nn/layers.py shard")
            shard = Shard(layout.model_group, layout.n_model,
                          layout.model_index, dim)
            with torch.no_grad():
                p.data = local(p.data, shard).clone()
            mod.tp = shard
            shards[name] = shard
    return shards


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard, ctx.n = dim, shard, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        tdist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g.narrow(ctx.dim, ctx.shard.index * n, n), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(t: Optional[torch.Tensor], shard: Shard):
    """A replicated input of a sharded layer (its gradient summed over the
    model ranks); None passes."""
    return None if t is None else _Enter.apply(t, shard.group)


def gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """The whole tensor from every model rank's part along ``dim``."""
    return _Gather.apply(t, dim % t.ndim, shard)


def bias(b: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's slice of a replicated bias."""
    n = b.shape[0] // shard.size
    return enter(b, shard).narrow(0, shard.index * n, n)


def embed(ids: torch.Tensor, weight: torch.Tensor,
          shard: Shard) -> torch.Tensor:
    """Rows ``ids`` of a vocab-sharded table: this rank's rows looked up,
    the others zero, summed over the model ranks."""
    rows = weight.shape[0]
    local_ids = ids - shard.index * rows
    outside = (local_ids < 0) | (local_ids >= rows)
    out = F.embedding(local_ids.masked_fill(outside, 0), weight)
    return _Reduce.apply(out.masked_fill(outside[..., None], 0.0),
                         shard.group)
