"""The data x model layout of the ranks (port of
``frido_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh,
``np.reshape(devices, (n_data, n_model))``: the batch is sharded over
``data``, tensor-parallel leaves over ``model``. The port runs one process
a card (``parallel/dist.py``), so rank ``r`` of ``n_data * n_model`` sits
at data index ``r // n_model`` and model index ``r % n_model``, the same
order. :func:`make_layout` builds the process subgroups:

- one per data row (the ``n_model`` ranks of one data index): the
  tensor-parallel collectives run in it (``parallel/tp.py``);
- one per model column (the ``n_data`` ranks of one model index): the
  gradient mean and the FSDP gathers and reduce-scatters run in it
  (``parallel/fsdp.py``, ``training/trainer.py``).

:func:`shard_batch` takes a data index's rows of a global batch (every
model rank of a data row sees the same rows), :func:`replicate` gives
every rank rank 0's parameters and buffers, :func:`fold_rng_per_device`
is each data index's seed (``dist.rank_seed``: one seed per data shard).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch
import torch.distributed as tdist

from frido_tpu_torch.parallel import dist


class Layout(NamedTuple):
    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    data_group: Any = None        # the ranks of this model index
    model_group: Any = None       # the ranks of this data index


def make_layout(world_size: int = 1, rank: int = 0,
                n_model: int = 1) -> Layout:
    """The layout of ``rank`` among ``world_size`` ranks with ``n_model``
    model ranks a data row. Every rank of the process group must call it
    (the subgroups are made collectively); without a process group the
    world must be one rank."""
    if n_model < 1 or world_size % n_model:
        raise ValueError(f"n_model {n_model} does not divide the world of "
                         f"{world_size}")
    n_data = world_size // n_model
    data_group = model_group = None
    if world_size > 1:
        if not (tdist.is_available() and tdist.is_initialized()):
            raise RuntimeError(f"a layout of {world_size} ranks needs a "
                               f"process group")
        for d in range(n_data):       # data rows: the model groups
            g = tdist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):      # model columns: the data groups
            g = tdist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    return Layout(n_data, n_model, rank, rank // n_model, rank % n_model,
                  data_group, model_group)


def shard_batch(batch: Any, layout: Layout) -> Any:
    """This data index's rows of every [B, ...] tensor, array or list in
    ``batch`` (a dict, or one of them)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, layout) for k, v in batch.items()}
    rows = dist.rank_rows(len(batch), layout.data_index, layout.n_data)
    return batch[rows]


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank."""
    dist.broadcast_(module)
    return module


def fold_rng_per_device(seed: int, layout: Layout) -> List[int]:
    """One seed per data shard, ``seed + data index``: the JAX package's
    per-device keys, the reference's rank-shifted seeds."""
    return [dist.rank_seed(seed, i) for i in range(layout.n_data)]

