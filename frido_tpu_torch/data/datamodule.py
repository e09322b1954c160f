"""Batching and the data module (port of ``frido_tpu/data/datamodule.py``).

:func:`collate` stacks tensors (the images, on their device) with
``torch.stack`` and numpy arrays (the builders' token rows) with
``np.stack``, and passes ragged values (annotation lists, captions, file
names) through as lists. :func:`split_indices_deterministic` is the JAX
package's seeded split of the test set into shards.

:class:`DataLoader` shuffles with ``random.Random(seed + epoch)``, drops a
short last batch under ``drop_last`` and resumes mid-epoch from
``set_cursor``, as the JAX loader does. Three things are its own:

- the plans of every sample of a global batch (crop, flip, builder rows:
  ``dataset.plan``) are drawn in index order on one thread, the producer's,
  whatever ``num_workers``; only the decodes and the pixel work
  (``dataset.load``) go to the worker threads. So the draws do not depend
  on thread timing, and equal the JAX package's where it runs at most one
  worker (its workers share one ``random.Random``);
- under data parallelism (``world_size`` ranks) each rank takes rows
  ``[r * B / n, (r + 1) * B / n)`` of each global batch of B and decodes
  only those, after drawing the plans of the whole batch, so that the
  ranks together see the one-process run's batch. The global batch must
  split evenly; a last batch without ``drop_last`` that does not loses
  its last ``len % world_size`` samples on every rank, with a warning
  that names them, since the data-parallel step's draws and its mean
  over the ranks take every rank's rows to be equal in number.
- a resume (``set_cursor``) draws the plans of every batch before the
  cursor again, earlier epochs included, in the uninterrupted run's
  order and without decoding their pixels, before the first batch it
  yields. A dataset whose plan draws (``pipeline.rng``, ``rng``) stood
  at their seed when the run began then stands where the uninterrupted
  run's stands, so the resumed run's crops, flips and builder shuffles
  are the uninterrupted run's. The JAX loader skips the batches and
  replays nothing; it seeds its draws from the OS.

With ``num_workers`` > 1 a producer thread runs ahead by at most
:data:`PREFETCH` batches (the batches lie on the device) and hands on any
error it meets.
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.parallel.dist import rank_rows

PREFETCH = 2        # batches the producer thread runs ahead


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, torch.Tensor):
            out[key] = torch.stack(vals)
        elif isinstance(v0, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(v0, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def split_indices_deterministic(n: int, n_split: int, idx: int,
                                seed: int = 42) -> List[int]:
    """A permutation from ``np.random.RandomState(seed)`` cut into
    ``n_split`` near-equal chunks (the first ``n % n_split`` one longer);
    the sorted indices of chunk ``idx``."""
    lengths = [n // n_split] * n_split
    for i in range(n - sum(lengths)):
        lengths[i] += 1
    perm = np.random.RandomState(seed).permutation(n)
    start = sum(lengths[:idx])
    return sorted(perm[start:start + lengths[idx]].tolist())


class DataLoader:
    """A prefetching loader over a map-style dataset; ``batch_size`` is the
    global batch, of which this rank yields its rows."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 0, indices: Optional[Sequence[int]] = None,
                 rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of {world_size}")
        if batch_size % world_size:
            raise ValueError(f"a global batch of {batch_size} does not split "
                             f"over {world_size} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.indices = (list(indices) if indices is not None
                        else list(range(len(dataset))))
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self._skip_batches = 0
        self._replay = False

    def __len__(self):
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_cursor(self, epoch: int, batch_in_epoch: int = 0) -> None:
        """The next ``__iter__`` replays epoch ``epoch``'s order and skips
        its first ``batch_in_epoch`` batches (a mid-epoch resume), after
        drawing the plans of every batch before them (epochs ``0 ..
        epoch - 1`` and the skipped ones) as a loader iterated from the
        start would have drawn them."""
        self.epoch = epoch
        self._skip_batches = batch_in_epoch
        self._replay = True

    def _epoch_batches(self, epoch: int,
                       warn_from: Optional[int] = 0) -> List[List[int]]:
        """Epoch ``epoch``'s global batches: its order, a short last batch
        dropped under ``drop_last``, a last batch that does not split over
        the ranks cut (with a warning if its index is ``warn_from`` or
        more; ``None``: none)."""
        order = list(self.indices)
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        for k, b in enumerate(batches):
            cut = len(b) % self.world_size
            if cut:
                if warn_from is not None and k >= warn_from:
                    warnings.warn(
                        f"a last batch of {len(b)} does not split over "
                        f"{self.world_size} ranks: its samples at dataset "
                        f"indices {b[-cut:]} are skipped")
                del b[-cut:]
        return batches

    def _batches(self) -> List[List[int]]:
        epoch, skip = self.epoch, self._skip_batches
        batches = self._epoch_batches(epoch, warn_from=skip)
        if self._replay and hasattr(self.dataset, "plan"):
            done = [b for e in range(epoch)
                    for b in self._epoch_batches(e, warn_from=None)]
            for b in done + batches[:skip]:
                for i in b:
                    self.dataset.plan(i)
        self._replay = False
        self._skip_batches = 0
        self.epoch += 1
        return [b for b in batches[skip:] if b]

    def _plan(self, batch: List[int]) -> List[Any]:
        """This rank's work for a global batch: plans of the whole batch in
        order (or, for a dataset without ``plan``, its own indices)."""
        mine = rank_rows(len(batch), self.rank, self.world_size)
        if hasattr(self.dataset, "plan"):
            return [self.dataset.plan(i) for i in batch][mine]
        return batch[mine]

    def _load(self, item):
        if hasattr(self.dataset, "plan"):
            return self.dataset.load(item)
        return self.dataset[item]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        if self.num_workers <= 1:
            for b in batches:
                yield collate([self._load(x) for x in self._plan(b)])
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        items = list(pool.map(self._load, self._plan(b)))
                        if not put(collate(items)):
                            return
                put(None)
            except BaseException as e:      # handed to the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()


class DataModuleFromConfig:
    """The config's ``data`` section: datasets built on ``device``, one
    persistent train loader (its epoch counter drives the shuffle), and
    the test split optionally cut into ``n_split_dataset`` deterministic
    shards (``idx_split_dataset`` picks one). ``rank`` and ``world_size``
    give each loader's rows under data parallelism."""

    def __init__(self, batch_size: int, train: Optional[Dict] = None,
                 validation: Optional[Dict] = None,
                 test: Optional[Dict] = None, wrap: bool = False,
                 num_workers: Optional[int] = None,
                 n_split_dataset: int = -1, idx_split_dataset: int = -1,
                 device=None, rank: int = 0, world_size: int = 1,
                 **unused):
        self.batch_size = batch_size
        self.num_workers = (num_workers if num_workers is not None
                            else batch_size * 2)
        self.dataset_configs = {}
        if train is not None:
            self.dataset_configs["train"] = train
        if validation is not None:
            self.dataset_configs["validation"] = validation
        if test is not None:
            self.dataset_configs["test"] = test
        self.n_split_dataset = n_split_dataset
        self.idx_split_dataset = idx_split_dataset
        self.device = device
        self.rank = rank
        self.world_size = world_size
        self.datasets: Dict[str, Any] = {}
        self._train_loader: Optional[DataLoader] = None

    def setup(self):
        for k, cfg in self.dataset_configs.items():
            if k not in self.datasets:
                self.datasets[k] = instantiate_from_config(
                    cfg, device=self.device)
        return self

    def _dataset(self, split):
        if split not in self.datasets:
            self.setup()
        return self.datasets[split]

    def _loader(self, split, **kw) -> DataLoader:
        return DataLoader(self._dataset(split), self.batch_size,
                          num_workers=self.num_workers, rank=self.rank,
                          world_size=self.world_size, **kw)

    def train_dataloader(self) -> DataLoader:
        if self._train_loader is None:
            self._train_loader = self._loader("train", shuffle=True,
                                              drop_last=True)
        return self._train_loader

    def val_dataloader(self) -> DataLoader:
        return self._loader("validation", shuffle=False)

    def test_dataloader(self) -> DataLoader:
        indices = None
        if self.n_split_dataset != -1:
            assert 0 <= self.idx_split_dataset < self.n_split_dataset
            indices = split_indices_deterministic(
                len(self._dataset("test")), self.n_split_dataset,
                self.idx_split_dataset)
        return self._loader("test", shuffle=False, indices=indices)
