"""Sharded train state over the layout's data ranks, ZeRO-3 style (port of
``frido_tpu/parallel/fsdp.py``), with each block's parameters gathered
just in time and its gradients reduce-scattered inside the backward.

The JAX rule, per leaf of the train state: take the tensor-parallel spec
(``parallel/tp.py``), then shard the largest axis that is still free and
divides by ``n_data`` over ``data``; leaves under ``min_size`` elements
(``MIN_SHARD_SIZE`` = 2**15 by default) and 1-D leaves stay as they are.
Axes are compared in JAX order (ties go to the first), on the full
shapes. The parameters, both AdamW moments and the EMA shadow are
sharded alike, since they share the parameters' shapes.

:class:`Sharding` (made by :func:`shard_model_`) holds where every
parameter lives and does the collectives over the layout's groups. At
rest each parameter holds this rank's part (its model shard, then of that
its data shard), so AdamW and the EMA live on the parts. The data-sharded
leaves are grouped in units: a module whose ``forward`` runs as one call
and whose class is in :data:`UNIT_CLASSES` (a PyUNet block, the PyUNet
itself for its time embedding, heads and SPADE inputs, a BERT attention
or feed-forward layer, the BERT embeddings' wrapper, a first-stage block,
encoder or decoder, a quantizer); a leaf belongs to the innermost such
module above it, else to the layer that holds it. Each call of a unit:

- a forward pre-hook packs the unit's parts into one buffer, runs one
  ``all_gather_into_tensor`` over the data group and puts the full
  tensors in place of the parameters (``module._parameters``) for the
  call; the forward hook puts the parameters back;
- under autograd the full tensors come out of one autograd node
  (``_Gather``) whose inputs are the parts. The convs and matmuls of the
  call save the full tensors themselves (in fp32 ``_Linearish._wb``'s
  cast is a no-op), so after the call the unit frees their storage in
  place (``untyped_storage().resize_(0)``): the saved references stay
  valid objects and nothing holds the bytes. A hook on the call's outputs
  (``register_multi_grad_hook``) gathers into the same storage again
  before the call's backward; reading it while freed raises. In bf16 the
  saved tensor is the cast copy, which autograd keeps until the backward,
  as an activation;
- ``_Gather``'s backward gets the call's full gradients once autograd has
  them all, runs one ``reduce_scatter_tensor`` of them packed, divides by
  ``n_data`` (sum, then divide, as ``dist.all_reduce_mean_``) and hands
  the parts' gradients to autograd, which accumulates them on the parts;
  then the full tensors are freed. A unit called twice in a step (the
  PyUNet at each stage) reduce-scatters once per call.

Under ``torch.utils.checkpoint`` the recompute in the backward calls each
unit again; that call gathers anew, is matched (in order) to the forward
call it replays, frees its storage after the recompute and is gathered
again with that call before its backward. So a call gathers once in the
forward and once before its backward (once more with remat) and
reduce-scatters once. Replicated leaves keep their gradients whole; the
step averages them afterwards in buckets (:meth:`Sharding.finish_grads_`).
:func:`gathered` gathers a unit for reads outside its forward (the
sampler's SPADE tables). With one data rank the units form all the
same (over a group of one: the collectives become copies) and the step
is the replicated one bit for bit.

:attr:`Sharding.counters` keeps this rank's gathers, reduce-scatters and
bytes of full parameters (the gathered tensors and the gather's staging
buffer) and of full gradients (what a reduce-scatter holds: the call's
gradients and its packed buffer), current and peak; the train step resets
them. :meth:`Sharding.full` and :meth:`Sharding.local` map a tensor
between its part and the full tensor (checkpoints).

Numerics: those of replicated data parallelism up to the order of the
reductions, as ``frido_tpu/parallel/fsdp.py:18-21`` states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as tdist

from frido_tpu_torch.nn import pyunet, quantize, vqgan, xtransformer
from frido_tpu_torch.parallel import dist, tp

MIN_SHARD_SIZE = 2 ** 15
# the modules whose forward runs as one call and forms a unit
UNIT_CLASSES = (pyunet.UNetBlock, pyunet.PyUNetModel,
                xtransformer.XAttention, xtransformer.XFeedForward,
                xtransformer.TransformerWrapper, vqgan.ResnetBlock,
                vqgan.AttnBlock, vqgan._DownTrunk, vqgan.Decoder,
                quantize.VectorQuantizer, quantize.GumbelQuantize)


def _data_dim(shape: Sequence[int], jax_axes: Sequence[int],
              model_dim: Optional[int], n_data: int,
              min_size: int) -> Optional[int]:
    """The torch dim the data rule shards for ``n_data`` ranks (>= 1)."""
    if len(shape) < 2 or math.prod(shape) < min_size:
        return None
    free = [j for j in range(len(shape))
            if jax_axes.index(j) != model_dim
            and shape[jax_axes.index(j)] % n_data == 0]
    if not free:
        return None
    j = max(free, key=lambda j: shape[jax_axes.index(j)])
    return jax_axes.index(j)


def leaf_spec(shape: Sequence[int], jax_axes: Sequence[int],
              embedding: bool, n_data: int, n_model: int,
              min_size: int = MIN_SHARD_SIZE):
    """(model dim, data dim) in torch dims for a leaf of full torch
    ``shape`` (``frido_tpu/parallel/fsdp.py:37-54``); None where an axis
    is not sharded."""
    model_dim = tp.leaf_spec(shape, jax_axes, embedding, n_model)
    if n_data <= 1:
        return model_dim, None
    return model_dim, _data_dim(shape, jax_axes, model_dim, n_data,
                                min_size)


def _chunk(full: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    m = full.shape[dim] // n
    return full.narrow(dim, i * m, m)


def _split(shape, dim: int, n: int):
    """``shape`` with ``dim`` split into (n, shape[dim] // n)."""
    return tuple(shape[:dim]) + (n, shape[dim] // n) + tuple(shape[dim + 1:])


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


class Counters:
    """This rank's unit collectives and full bytes (see the module
    docstring)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.gathers = 0
        self.reduce_scatters = 0
        self.full_param_bytes = 0
        self.peak_full_param_bytes = 0
        self.full_grad_bytes = 0
        self.peak_full_grad_bytes = 0

    def params(self, delta: int) -> None:
        self.full_param_bytes += delta
        self.peak_full_param_bytes = max(self.peak_full_param_bytes,
                                         self.full_param_bytes)

    def grads(self, delta: int) -> None:
        self.full_grad_bytes += delta
        self.peak_full_grad_bytes = max(self.peak_full_grad_bytes,
                                        self.full_grad_bytes)

    def as_dict(self) -> Dict[str, int]:
        return dict(vars(self))


class _Call:
    """One call of a unit: its full tensors and where its backward is."""

    def __init__(self, unit: "_Unit"):
        self.unit = unit
        self.fulls: List[torch.Tensor] = []
        self.saved: List[object] = []
        self.graph = False          # the fulls came out of a _Gather node
        self.resident = False       # the fulls hold their bytes
        self.refilled = False       # gathered again for the backward
        self.orig: Optional[_Call] = None       # a recompute: the call
        self.recompute: Optional[_Call] = None  # it replays, and back


class _Gather(torch.autograd.Function):
    """Parts in, the call's full tensors out; backward: one reduce-scatter
    of the call's full gradients to the parts' gradients."""

    @staticmethod
    def forward(ctx, call, *parts):
        ctx.call = call
        ctx.set_materialize_grads(False)
        call.unit._fill(call)
        frozen = [f for f, p in zip(call.fulls, parts)
                  if not p.requires_grad]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(call.fulls)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        unit = call.unit
        part_grads = unit._reduce_scatter(grads)
        unit._free(call)
        if call.recompute is not None:
            unit._free(call.recompute)
        if call in unit.open_calls:
            unit.open_calls.remove(call)
        return (None,) + tuple(part_grads)


class _Unit:
    """The data-sharded leaves of one module and their collectives."""

    def __init__(self, sharding: "Sharding", name: str,
                 module: torch.nn.Module, entries):
        self.sharding = sharding
        self.name = name
        self.module = module
        self.owners = [(mod, pname) for mod, pname, _, _ in entries]
        self.params = [p for _, _, p, _ in entries]
        self.dims = [d for _, _, _, d in entries]
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) != 1:
            raise ValueError(f"FSDP unit {name!r} mixes dtypes {dtypes}")
        n = sharding.n_data
        self.part_shapes = [tuple(p.shape) for p in self.params]
        self.full_shapes = [s[:d] + (n * s[d],) + s[d + 1:]
                            for s, d in zip(self.part_shapes, self.dims)]
        self.split_shapes = [_split(s, d, n) for s, d in
                             zip(self.full_shapes, self.dims)]
        self.offsets, off = [], 0
        for s in self.part_shapes:
            self.offsets.append(off)
            off += math.prod(s)
        self.part_numel = off
        self.full_bytes = n * off * self.params[0].element_size()
        self.open_calls: List[_Call] = []
        self.hooks = [
            module.register_forward_pre_hook(self._pre_forward),
            module.register_forward_hook(self._post_forward,
                                         always_call=True)]
        module._fsdp_unit = self

    # ---- collectives -----------------------------------------------------
    @torch.no_grad()
    def _fill(self, call: _Call) -> None:
        """Gather the parts (the parameters' current data: the weights,
        or the EMA shadow under ``EMA.scope``) into ``call.fulls``."""
        s, c = self.sharding, self.sharding.counters
        n = s.n_data
        c.gathers += 1
        parts = [p.detach() for p in self.params]
        if not call.fulls:
            call.fulls = [parts[0].new_empty(shape)
                          for shape in self.full_shapes]
        else:
            for f in call.fulls:
                f.untyped_storage().resize_(f.numel() * f.element_size())
        c.params(self.full_bytes)
        # through .data: no version bump on a tensor autograd saved
        dsts = [f.data for f in call.fulls]
        if n == 1:
            torch._foreach_copy_(dsts, parts)
        else:
            c.params(self.full_bytes)         # the gather's buffer
            send = torch.cat([t.reshape(-1) for t in parts])
            recv = send.new_empty(n * send.numel())
            tdist.all_gather_into_tensor(recv, send, group=s.group)
            rows = recv.view(n, -1)
            torch._foreach_copy_(
                [d.view(sp) for d, sp in zip(dsts, self.split_shapes)],
                [rows[:, off:off + math.prod(shape)].unflatten(1, shape)
                 .movedim(0, dim) for shape, dim, off in zip(
                     self.part_shapes, self.dims, self.offsets)])
            c.params(-self.full_bytes)
        call.resident = True

    def _free(self, call: _Call) -> None:
        if not call.resident:
            return
        for f in call.fulls:
            f.untyped_storage().resize_(0)
        call.resident = False
        self.sharding.counters.params(-self.full_bytes)

    @torch.no_grad()
    def _reduce_scatter(self, grads) -> List[Optional[torch.Tensor]]:
        """The parts' mean gradients over the data ranks from one call's
        full gradients (None stays None)."""
        s, c = self.sharding, self.sharding.counters
        n = s.n_data
        have = [i for i, g in enumerate(grads) if g is not None]
        if not have:
            return [None] * len(grads)
        sizes = [math.prod(self.part_shapes[i]) for i in have]
        held = sum(grads[i].numel() * grads[i].element_size() for i in have)
        c.grads(2 * held)                     # the gradients and the send
        # rank r's row: its chunk of every gradient, in order
        send = torch.cat([
            grads[i].reshape(self.split_shapes[i]).movedim(
                self.dims[i], 0).reshape(n, m)
            for i, m in zip(have, sizes)], dim=1).view(-1)
        if n > 1:
            recv = send.new_empty(send.numel() // n)
            tdist.reduce_scatter_tensor(recv, send, group=s.group)
        else:
            recv = send
        recv.div_(n)
        c.reduce_scatters += 1
        c.grads(-2 * held)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        off = 0
        for i, m in zip(have, sizes):
            out[i] = recv[off:off + m].view(self.part_shapes[i])
            off += m
        return out

    # ---- a call ----------------------------------------------------------
    def _install(self, call: _Call) -> None:
        call.saved = [mod._parameters[pname] for mod, pname in self.owners]
        for (mod, pname), f in zip(self.owners, call.fulls):
            mod._parameters[pname] = f

    def _uninstall(self, call: _Call) -> None:
        for (mod, pname), t in zip(self.owners, call.saved):
            mod._parameters[pname] = t
        call.saved = []

    def begin(self) -> _Call:
        call = _Call(self)
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.params):
            call.graph = True
            _Gather.apply(call, *self.params)
            if torch._C._current_graph_task_id() != -1:
                # the recompute of a checkpointed forward: it replays the
                # first forward call that has no recompute yet
                call.orig = next((c for c in self.open_calls
                                  if c.recompute is None), None)
                if call.orig is not None:
                    call.orig.recompute = call
        else:
            self._fill(call)
        self._install(call)
        return call

    def end(self, call: _Call, output) -> None:
        self._uninstall(call)
        if not call.graph:
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in _tensors(output)):
                raise NotImplementedError(
                    f"FSDP unit {self.name!r} has no trainable parameter "
                    f"and is differentiated through")
            self._free(call)
            return
        if call.orig is not None:
            # a recompute: its saved tensors wait for the call it replays
            if not call.orig.refilled:
                self._free(call)
            return
        if torch._C._current_graph_task_id() != -1:
            return                # no matching forward call: kept whole
        outs = [t for t in _tensors(output) if t.requires_grad]
        if not outs:
            return                # no backward reaches it: kept for autograd
        self._free(call)
        self.open_calls.append(call)
        torch.autograd.graph.register_multi_grad_hook(
            outs, lambda _: self._refill(call), mode="any")

    def _refill(self, call: _Call) -> None:
        """Before the call's backward: gather into the storage its saved
        tensors hold (the recompute's, under remat)."""
        if call.refilled:
            return
        call.refilled = True
        target = call.recompute if call.recompute is not None else call
        if not target.resident:
            self._fill(target)

    @contextlib.contextmanager
    def scope(self) -> Iterator[None]:
        """The unit gathered inside the block (see :func:`gathered`)."""
        call = self.begin()
        try:
            yield
        finally:
            self._uninstall(call)
            if not call.graph:
                self._free(call)

    def _pre_forward(self, module, args):
        self.sharding._stack.append(self.begin())

    def _post_forward(self, module, args, output):
        self.end(self.sharding._stack.pop(), output)


def unit_plan(model: torch.nn.Module, data_dims: Dict[str, int]):
    """{unit module name: [(layer, parameter name, parameter, data dim),
    ...]}: each data-sharded leaf under the innermost module that is a
    :data:`UNIT_CLASSES`, else under the layer holding it; in module
    order."""
    modules = dict(model.named_modules())
    marked = {name for name, m in modules.items()
              if name and isinstance(m, UNIT_CLASSES)}
    plan: Dict[str, list] = {}
    for mname, mod in modules.items():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if name not in data_dims:
                continue
            owner, parts = mname, mname.split(".")
            for k in range(len(parts), 0, -1):
                if ".".join(parts[:k]) in marked:
                    owner = ".".join(parts[:k])
                    break
            if not owner:
                raise ValueError(f"FSDP: {name} has no module to gather it")
            plan.setdefault(owner, []).append((mod, pname, p,
                                               data_dims[name]))
    return plan


def data_dims_for(model: torch.nn.Module, n_data: int, n_model: int = 1,
                  min_size: int = MIN_SHARD_SIZE) -> Dict[str, int]:
    """{parameter name: data dim} of the leaves the data rule shards over
    ``n_data`` ranks (with one rank, those it would shard), on the full
    shapes."""
    params = dict(model.named_parameters())
    out = {}
    for name, (model_dim, axes, _) in tp.param_specs(model, n_model).items():
        dim = _data_dim(tuple(params[name].shape), axes, model_dim, n_data,
                        min_size)
        if dim is not None:
            out[name] = dim
    return out


class Sharding:
    """Where each parameter of ``model`` lives under ``layout``, and the
    units that gather and reduce-scatter the data-sharded ones; see the
    module docstring. ``data_dims``: {name: the torch dim sharded over
    the data ranks}; ``model_shards``: {name: ``tp.Shard``}."""

    def __init__(self, model: torch.nn.Module, layout,
                 model_shards: Dict[str, tp.Shard],
                 data_dims: Dict[str, int]):
        self.layout = layout
        self.params = dict(model.named_parameters())
        self.model_shards = model_shards
        self.data_dims = data_dims
        self.counters = Counters()
        self._stack: List[_Call] = []
        self.units = self._make_units(model)
        self._sharded = {id(self.params[n]) for n in data_dims}

    @property
    def n_data(self) -> int:
        return self.layout.n_data

    @property
    def group(self):
        return self.layout.data_group

    def _make_units(self, model: torch.nn.Module) -> List[_Unit]:
        modules = dict(model.named_modules())
        return [_Unit(self, owner, modules[owner], ents)
                for owner, ents in unit_plan(model, self.data_dims).items()]

    # ---- one tensor ------------------------------------------------------
    @torch.no_grad()
    def _gather_data(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim, n = self.data_dims[name], self.n_data
        if n == 1:
            return t
        buf = t.new_empty(n * t.numel())
        tdist.all_gather_into_tensor(buf, t.contiguous().view(-1),
                                     group=self.group)
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
    def finish_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """After the backward: the mean over the data ranks of each
        replicated leaf's gradient, in buckets; the data-sharded leaves'
        parts already hold theirs. A missing gradient counts as zero, as
        in the JAX step: AdamW still decays that leaf and its moments."""
        rest = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if id(p) not in self._sharded:
                rest.append(p.grad)
        if self.n_data > 1:
            dist.all_reduce_mean_(rest, group=self.group)
        for u in self.units:
            u.open_calls.clear()

    def close(self) -> None:
        """Take the units' hooks off the model (the parts stay)."""
        for u in self.units:
            for h in u.hooks:
                h.remove()
            del u.module._fsdp_unit
        self.units = []


@contextlib.contextmanager
def gathered(module: torch.nn.Module) -> Iterator[None]:
    """``module``'s FSDP unit gathered inside the block, for a read of its
    parameters outside its forward; nothing where ``module`` is no unit
    (or the model is not sharded). Under autograd the full tensors stay
    with autograd until the backward."""
    unit = getattr(module, "_fsdp_unit", None)
    if unit is None:
        yield
        return
    with unit.scope():
        yield


def shard_model_(model: torch.nn.Module, layout, fsdp: bool = False,
                 min_size: int = MIN_SHARD_SIZE) -> Sharding:
    """Apply the layout to ``model`` in place: the tensor-parallel rule
    (``tp.shard_module_``) and, with ``fsdp``, the data rule on top (with
    one data rank the leaves it would shard still form the units); the
    specs come from the full shapes. Every rank calls it on a replicated
    model."""
    params = dict(model.named_parameters())
    data_dims = (data_dims_for(model, layout.n_data, layout.n_model,
                               min_size) if fsdp else {})
    model_shards = tp.shard_module_(model, layout)
    if layout.n_data > 1:
        with torch.no_grad():
            for name, dim in data_dims.items():
                p = params[name]
                p.data = _chunk(p.data, dim, layout.n_data,
                                layout.data_index).clone()
    return Sharding(model, layout, model_shards, data_dims)


def resident_bytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    """Bytes held by ``tensors`` (parameters, moments, shadows)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
