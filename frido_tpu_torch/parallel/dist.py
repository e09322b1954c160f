"""Data parallelism over ``torch.distributed`` (port of
``frido_tpu/parallel/mesh.py``).

The JAX package trains data-parallel on a device mesh: the batch sharded
over its ``data`` axis, the parameters and optimizer state replicated, the
gradients summed by XLA. The port runs one process a card, launched by
``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``:

- :func:`init_from_env` joins the process group (NCCL for ``cuda``, gloo
  for ``cpu``), also at world size 1 under ``torchrun``; without that
  environment it makes no group and the world is one process;
- :func:`rank_rows` is a rank's rows of a global batch (the mesh's
  ``shard_batch``): rank r of n takes ``[r * B / n, (r + 1) * B / n)``;
- :func:`rank_seed` is a rank's sampling seed, ``seed + rank`` (the JAX
  package's ``fold_rng_per_device``, and ``seed + shard_idx`` of its
  sampling script);
- :func:`all_reduce_mean_` averages tensors over the ranks (or a
  subgroup of them) in buckets (one collective per bucket, not per
  tensor), for the gradients;
- :func:`broadcast_` gives every rank rank 0's parameters and buffers.

On top of this process-group layer, ``mesh.py`` lays the ranks out as the
JAX package's data x model mesh, ``tp.py`` shards layers over the model
ranks and ``fsdp.py`` shards the train state over the data ranks.
"""

from __future__ import annotations

import os
from typing import Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20


class World(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    backend: Optional[str]        # None: no process group

    @property
    def main(self) -> bool:
        return self.rank == 0


def init_from_env(device_type: str) -> World:
    """Join the process group ``torchrun`` describes; a world of one
    without it."""
    if "WORLD_SIZE" not in os.environ:
        return World(0, 1, 0, None)
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world_size)
    return World(rank, world_size, local_rank, backend)


def shutdown(world: World) -> None:
    if world.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(n: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s rows of a batch of ``n``."""
    return slice(n * rank // world_size, n * (rank + 1) // world_size)


def rank_seed(seed: int, rank: int) -> int:
    return seed + rank


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES, group=None) -> None:
    """Each tensor replaced by its mean over the ranks of ``group`` (all
    ranks by default), in place: the tensors are packed, in order, into
    flat buckets of up to ``bucket_bytes`` of one dtype, one
    ``all_reduce`` each."""
    if not _active() or dist.get_world_size(group) == 1:
        return
    n = dist.get_world_size(group)
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket, size = [], 0

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or size + t.numel() * t.element_size() > bucket_bytes):
            flush()
        bucket.append(t)
        size += t.numel() * t.element_size()
    flush()


@torch.no_grad()
def broadcast_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if not _active() or dist.get_world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
