"""Device tracing for the CLIs (port of ``frido_tpu/utils/profiling.py:29``,
which wraps ``jax.profiler``): :func:`trace` records the block with
``torch.profiler`` and writes a Chrome trace into the directory given.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` over the block (host, and the card when CUDA is
    available), exported to ``<logdir>/trace.json``; nothing when
    ``logdir`` is empty."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
