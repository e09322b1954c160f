"""Sharded train state over the layout's data ranks, ZeRO-3 style (port of
``frido_tpu/parallel/fsdp.py``), and the whole model's sharding.

The JAX rule, per leaf of the train state: take the tensor-parallel spec
(``parallel/tp.py``), then shard the largest axis that is still free and
divides by ``n_data`` over ``data``; leaves under ``min_size`` elements
(``MIN_SHARD_SIZE`` = 2**15 by default) and 1-D leaves stay as they are.
Axes are compared in JAX order (ties go to the first), on the full
shapes. The parameters, both AdamW moments and the EMA shadow are
sharded alike, since they share the parameters' shapes.

:class:`Sharding` (made by :func:`shard_model_`) holds where every
parameter lives and does the step's collectives over the layout's groups:

- at rest each parameter holds this rank's part (its model shard, then of
  that its data shard), so AdamW (its moments made from the parameters)
  and the EMA (its shadow copied from them) live on the same parts;
- :meth:`Sharding.gather_` puts the data-gathered parameters in place for
  a forward and backward (a whole-model gather before the forward: the
  simplest form; per-module gathers through forward pre-hooks are later
  work), :meth:`Sharding.reduce_grads_` then reduce-scatters the mean of
  each data-sharded gradient (``reduce_scatter_tensor``), averages the
  others over the data ranks (``all_reduce``), and puts the parts back,
  so AdamW and the EMA update the local parts only;
- :meth:`Sharding.full` and :meth:`Sharding.local` map a tensor between
  its part and the full tensor (checkpoints, ``EMA.scope``).

Numerics: those of replicated data parallelism up to the order of the
reductions, as ``frido_tpu/parallel/fsdp.py:18-21`` states. The data
group's mean is a sum over the ranks then a division, as
``dist.all_reduce_mean_``'s.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, Optional, Sequence

import torch
import torch.distributed as tdist

from frido_tpu_torch.parallel import dist, tp

MIN_SHARD_SIZE = 2 ** 15


def leaf_spec(shape: Sequence[int], jax_axes: Sequence[int],
              embedding: bool, n_data: int, n_model: int,
              min_size: int = MIN_SHARD_SIZE):
    """(model dim, data dim) in torch dims for a leaf of full torch
    ``shape`` (``frido_tpu/parallel/fsdp.py:37-54``); None where an axis
    is not sharded."""
    model_dim = tp.leaf_spec(shape, jax_axes, embedding, n_model)
    if n_data <= 1 or len(shape) < 2 or math.prod(shape) < min_size:
        return model_dim, None
    free = [j for j in range(len(shape))
            if jax_axes.index(j) != model_dim
            and shape[jax_axes.index(j)] % n_data == 0]
    if not free:
        return model_dim, None
    j = max(free, key=lambda j: shape[jax_axes.index(j)])
    return model_dim, jax_axes.index(j)


def _chunk(full: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    m = full.shape[dim] // n
    return full.narrow(dim, i * m, m)


class Sharding:
    """Where each parameter of ``model`` lives under ``layout``; see the
    module docstring. ``data_dims``: {name: the torch dim sharded over the
    data ranks}; ``model_shards``: {name: ``tp.Shard``}."""

    def __init__(self, model: torch.nn.Module, layout,
                 model_shards: Dict[str, tp.Shard],
                 data_dims: Dict[str, int]):
        self.layout = layout
        self.params = dict(model.named_parameters())
        self.model_shards = model_shards
        self.data_dims = data_dims
        self._parts: Dict[str, torch.Tensor] = {}

    @property
    def n_data(self) -> int:
        return self.layout.n_data

    # ---- one tensor ------------------------------------------------------
    @torch.no_grad()
    def _gather_data(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim, n = self.data_dims[name], self.n_data
        buf = t.new_empty(n * t.numel())
        tdist.all_gather_into_tensor(buf, t.contiguous().view(-1),
                                     group=self.layout.data_group)
        return torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0), dim=dim)

    def data_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A part gathered over the data ranks (still a model shard)."""
        return self._gather_data(name, t) if name in self.data_dims else t

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter ``name``'s part ``t`` (or of a
        moment or EMA shadow of it; any other tensor as it is); every rank
        must call it."""
        t = self.data_full(name, t)
        if name in self.model_shards:
            t = tp.gather_full(t, self.model_shards[name])
        return t

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a full tensor of parameter ``name`` (any
        other tensor as it is)."""
        if name in self.model_shards:
            full = tp.local(full, self.model_shards[name])
        if name in self.data_dims:
            full = _chunk(full, self.data_dims[name], self.n_data,
                          self.layout.data_index)
        return full

    # ---- the step --------------------------------------------------------
    @torch.no_grad()
    def gather_(self) -> None:
        """Every data-sharded parameter gathered in place for a forward
        and backward; :meth:`reshard_` (or :meth:`reduce_grads_`) puts the
        parts back."""
        for name in self.data_dims:
            if name in self._parts:
                continue
            p = self.params[name]
            self._parts[name] = p.data
            p.data = self._gather_data(name, p.data)

    def reshard_(self) -> None:
        for name, part in self._parts.items():
            self.params[name].data = part
        self._parts.clear()

    @torch.no_grad()
    def reduce_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """The mean gradient over the data ranks of each of ``params``
        (a missing gradient counts as zero): reduce-scattered to this
        rank's part where the parameter is data-sharded, all-reduced
        elsewhere; then the parts are put back."""
        names = {id(p): n for n, p in self.params.items()}
        group, n = self.layout.data_group, self.n_data
        scattered, rest = {}, []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            name = names[id(p)]
            if name in self.data_dims and n > 1:
                dim = self.data_dims[name]
                chunks = p.grad.chunk(n, dim)
                stacked = torch.cat([c.reshape(-1) for c in chunks])
                part = stacked.new_empty(chunks[0].numel())
                tdist.reduce_scatter_tensor(part, stacked, group=group)
                scattered[name] = part.div_(n).view(chunks[0].shape)
                p.grad = None
            else:
                rest.append(p.grad)
        if n > 1:
            dist.all_reduce_mean_(rest, group=group)
        self.reshard_()
        for name, g in scattered.items():
            self.params[name].grad = g

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The data-gathered parameters in place inside the block (an
        eval, a sample, the image log); the parts after it."""
        self.gather_()
        try:
            yield
        finally:
            self.reshard_()


def shard_model_(model: torch.nn.Module, layout, fsdp: bool = False,
                 min_size: int = MIN_SHARD_SIZE) -> Sharding:
    """Apply the layout to ``model`` in place: the tensor-parallel rule
    (``tp.shard_module_``) and, with ``fsdp``, the data rule on top; the
    specs come from the full shapes. Every rank calls it on a replicated
    model."""
    params = dict(model.named_parameters())
    specs = {name: leaf_spec(tuple(params[name].shape), axes, emb,
                             layout.n_data if fsdp else 1, layout.n_model,
                             min_size)
             for name, (_, axes, emb) in tp.param_specs(
                 model, layout.n_model).items()}
    model_shards = tp.shard_module_(model, layout)
    data_dims = {}
    for name, (_, data_dim) in specs.items():
        if data_dim is None:
            continue
        with torch.no_grad():
            p = params[name]
            p.data = _chunk(p.data, data_dim, layout.n_data,
                            layout.data_index).clone()
        data_dims[name] = data_dim
    return Sharding(model, layout, model_shards, data_dims)


def resident_bytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    """Bytes held by ``tensors`` (parameters, moments, shadows)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
