"""Tracing and timing helpers (port of ``frido_tpu/utils/profiling.py``).

- :func:`trace` records the block with ``torch.profiler`` and writes a
  Chrome trace into the directory given (the JAX one wraps
  ``jax.profiler``); ``tools/profile_step.py`` and ``profile_train.py``
  read its events;
- :func:`annotate` names a region of that trace (``torch.profiler.
  record_function``), and an NVTX range on CUDA;
- :func:`device_sync` is the timing barrier: it waits for the device of
  the first leaf of a nested structure and reads that leaf's first element
  back, as the JAX helper does;
- :class:`ThroughputMeter` counts items a second over timed batches after
  the warm-up ones, the JAX meter's accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str], record_shapes: bool = False):
    """``torch.profiler`` over the block (host, and the card when CUDA is
    available), exported to ``<logdir>/trace.json``; the block gets the
    profiler (its events for a caller that reads them, with the operators'
    input shapes under ``record_shapes``). Nothing, and ``None``, when
    ``logdir`` is empty."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``with annotate('decode'): ...``. It shows in a
    :func:`trace` as a ``record_function`` span, and on CUDA as an NVTX
    range."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _first_leaf(x: Any) -> Any:
    """The first leaf of ``x`` in ``jax.tree_util``'s order: dict values
    by sorted key, list and tuple items in order, ``None`` an empty
    node."""
    if isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        items = list(x)
    elif x is None:
        return None
    else:
        return x
    for item in items:
        leaf = _first_leaf(item)
        if leaf is not None:
            return leaf
    return None


def device_sync(x: Any) -> float:
    """Wait until the device has produced the first leaf of ``x`` (a
    tensor, an array or a number, or a dict, list or tuple of them); return
    that leaf's first element as a float, cast to fp32 first as the JAX
    helper does."""
    import numpy as np
    import torch

    leaf = _first_leaf(x)
    if leaf is None:
        raise ValueError("device_sync: no leaf in the structure given")
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        return float(leaf.reshape(-1)[0].to(torch.float32).item())
    return float(np.ravel(np.asarray(leaf))[0].astype(np.float32))


class ThroughputMeter:
    """Items a second over timed batches, skipping the first ``warmup``
    (``frido_tpu/utils/profiling.py``'s accounting)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._seen = 0
        self._items = 0
        self._secs = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_items: int) -> float:
        """Record a batch of ``n_items``; returns this batch's items a
        second."""
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._items += n_items
            self._secs += dt
        return n_items / dt if dt > 0 else float("inf")

    @property
    def items_per_sec(self) -> float:
        return self._items / self._secs if self._secs > 0 else 0.0
