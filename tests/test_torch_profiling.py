"""The port's profiling helpers (``frido_tpu_torch/utils/profiling.py``)
against the JAX package's (``frido_tpu/utils/profiling.py``), exactly:

- ``ThroughputMeter`` on a scripted clock (``time.perf_counter`` replaced
  in both), every batch's rate and the running items a second, for
  several warm-up counts, a zero-length batch included;
- ``device_sync`` on nested structures (dicts with unsorted keys, lists,
  tuples, ``None``, bf16, int and fp32 leaves) against the JAX function on
  the same values as ``jnp`` arrays;
- ``annotate`` names a span of ``trace``'s Chrome trace.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.utils import profiling as jax_profiling
from frido_tpu_torch.utils import profiling

# (start, stop, items) of each batch, in seconds
BATCHES = [(0.0, 2.5, 4), (3.0, 3.5, 4), (4.0, 4.0, 8), (5.0, 5.25, 2),
           (6.0, 7.75, 3), (8.0, 8.125, 16)]


def _drive(meter_cls, warmup, monkeypatch):
    clock = iter(t for start, stop, _ in BATCHES for t in (start, stop))
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    meter = meter_cls(warmup=warmup)
    out = []
    for _, _, n in BATCHES:
        meter.start()
        out.append((meter.stop(n), meter.items_per_sec))
    return out


@pytest.mark.parametrize("warmup", [0, 1, 2, 6])
def test_throughput_meter_matches_jax(warmup, monkeypatch):
    got = _drive(profiling.ThroughputMeter, warmup, monkeypatch)
    want = _drive(jax_profiling.ThroughputMeter, warmup, monkeypatch)
    assert got == want
    assert got[2][0] == float("inf")


def _trees():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.integers(-5, 5, (2, 2)).astype(np.int32)
    c = (1.0 + rng.standard_normal(5)).astype(np.float32)
    return [
        {"z": a, "b": b, "m": [c]},
        {"y": None, "x": [None, (c, a)], "w": {"q": b}},
        [{"k": c}, a],
        {"only": c[2:]},
    ]


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("bf16", [False, True])
def test_device_sync_matches_jax(index, bf16):
    tree = _trees()[index]

    def convert(x, to):
        if isinstance(x, dict):
            return {k: convert(v, to) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v, to) for v in x)
        return None if x is None else to(x)

    def to_torch(x):
        t = torch.from_numpy(x)
        return t.to(torch.bfloat16) if bf16 and t.is_floating_point() else t

    def to_jax(x):
        a = jnp.asarray(x)
        return a.astype(jnp.bfloat16) if bf16 and x.dtype.kind == "f" else a

    got = profiling.device_sync(convert(tree, to_torch))
    want = jax_profiling.device_sync(convert(tree, to_jax))
    assert isinstance(got, float) and got == want


def test_annotate_names_a_trace_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("decode_region"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "decode_region" in names
