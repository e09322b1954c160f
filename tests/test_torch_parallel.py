"""``frido_tpu_torch/parallel/dist.py`` on two gloo ranks (one
``torch.multiprocessing`` spawn, with a timeout).

- ``all_reduce_mean_`` with buckets of 64 bytes over tensors of fp32, fp64,
  fp16 and bf16: the means exact (the values are multiples of 1/4 small
  enough for every dtype), and the ``all_reduce`` calls the ones the
  bucket rule gives, a boundary by size and by dtype among them; with the
  default buckets, one call for each run of one dtype.
- ``broadcast_``: every rank holds rank 0's parameters and buffers.
"""

import datetime
import json
import os
import socket
import time

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from frido_tpu_torch.parallel import dist

WORLD = 2
TIMEOUT_S = 120
SHAPES = [((3, 5), torch.float32), ((40,), torch.float32),
          ((7,), torch.float64), ((2, 2), torch.float32),
          ((2,), torch.float32), ((10,), torch.float16),
          ((3,), torch.float16), ((6,), torch.bfloat16)]
# the bucket rule at 64 bytes: (dtype, elements) of each all_reduce
SMALL_CALLS = [("float32", 15), ("float32", 40), ("float64", 7),
               ("float32", 6), ("float16", 13), ("bfloat16", 6)]
DEFAULT_CALLS = [("float32", 55), ("float64", 7), ("float32", 6),
                 ("float16", 13), ("bfloat16", 6)]


def _tensors(rank):
    g = torch.Generator().manual_seed(0)
    base = [torch.randint(-8, 9, shape, generator=g).to(dtype) / 4
            for shape, dtype in SHAPES]
    return base, [b * (rank + 1) for b in base]


def _worker(rank, port, out):
    tdist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    calls = []
    real = tdist.all_reduce

    def counting(t, *a, **k):
        calls.append((str(t.dtype).split(".")[-1], t.numel()))
        return real(t, *a, **k)

    tdist.all_reduce = counting
    result = {}
    for name, bucket in (("small", 64), ("default", dist.BUCKET_BYTES)):
        calls.clear()
        base, mine = _tensors(rank)
        dist.all_reduce_mean_(mine, bucket_bytes=bucket)
        # ranks hold base * 1 and base * 2: the mean is base * 1.5
        result[name] = {"calls": list(calls),
                        "exact": all(torch.equal(m, b * 1.5)
                                     for m, b in zip(mine, base))}
    tdist.all_reduce = real

    torch.manual_seed(rank)
    module = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        module.weight.normal_()
        module.running_mean.normal_()
    dist.broadcast_(module)
    torch.manual_seed(0)
    want = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        want.weight.normal_()
        want.running_mean.normal_()
    result["broadcast"] = all(
        torch.equal(a, b) for a, b in zip(module.state_dict().values(),
                                          want.state_dict().values()))
    tdist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.json"), "w") as f:
        json.dump(result, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bucketed_mean_and_broadcast_on_two_gloo_ranks(tmp_path):
    ctx = mp.start_processes(_worker, (_free_port(), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for rank in range(WORLD):
        r = json.load(open(tmp_path / f"{rank}.json"))
        assert r["small"]["exact"] and r["default"]["exact"]
        assert [tuple(c) for c in r["small"]["calls"]] == SMALL_CALLS
        assert [tuple(c) for c in r["default"]["calls"]] == DEFAULT_CALLS
        assert r["broadcast"]
