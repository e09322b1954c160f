"""Time the attention kernels against an earlier version of their sources,
on one card, in one process.

    python -m frido_tpu_torch.tools.attention_ab --old DIR [--out FILE]

DIR holds the earlier ``flash_attention.cu`` and ``smalls_attention.cu``
(and the headers they include), for example ``frido_tpu_torch/csrc`` of an
unpacked ``git archive`` of the parent commit. Both are built here with the
port's nvcc flags and called through their C entry points of that version,
``(q, k, v, o, bh, nq, nk, d, scale, stream)``; the current kernels go
through the port's wrappers. At every main-path site each is checked
against the plain version (the same tolerances as ``chip_smoke.py``), then
timed by CUDA events in the order old, new, new, old, beside
``F.scaled_dot_product_attention``: that is the time a caller sees, host
overhead included. The device time alone comes from 20 launches captured
in a CUDA graph and replayed (``*_device_ms``). One JSON line per site,
and all of them in FILE when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from frido_tpu_torch.ops.cuda import build
from frido_tpu_torch.ops.cuda.attention import (attention_plain,
                                                flash_attention,
                                                smalls_attention)

# (kernel, [bh, nq, nk, d], dtype): every site the main path gives them
SITES = [
    ("flash_attention", (32, 1024, 1024, 512), torch.float32),
    ("flash_attention", (4, 1024, 1024, 512), torch.float32),
    ("flash_attention", (32, 1024, 1024, 512), torch.bfloat16),
    ("smalls_attention", (4, 256, 256, 384), torch.bfloat16),
    ("smalls_attention", (4, 256, 77, 384), torch.bfloat16),
    ("smalls_attention", (4, 64, 64, 576), torch.bfloat16),
    ("smalls_attention", (4, 64, 77, 576), torch.bfloat16),
    ("smalls_attention", (4, 16, 16, 960), torch.bfloat16),
    ("smalls_attention", (4, 16, 77, 960), torch.bfloat16),
    ("smalls_attention", (32, 77, 77, 64), torch.float32),
]
NEW = {"flash_attention": flash_attention,
       "smalls_attention": smalls_attention}


def build_old(src: pathlib.Path, out: pathlib.Path):
    """{name: ctypes library} of the earlier sources, built in parallel."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NEW:
        lib = out / f"lib{name}_old.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(src / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"old {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for suffix in ("f32", "bf16"):
            fn = getattr(libs[name], f"frido_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return libs


def old_call(libs, name, q, k, v, scale):
    bh, nq, d = q.shape
    nk = k.shape[1]
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    fn = getattr(libs[name], f"frido_{name}_{suffix}")
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, nq,
            nk, d, float(scale), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old {name} launch failed with {rc}")
    return out


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Device time of one ``fn``: ``reps`` calls captured in a CUDA graph,
    the replay timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / reps


def seeded(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def max_err(got, want, v, dtype):
    """max |got - want|, after checking it against the card tests'
    tolerance: 5e-5, and in bf16 + 2^-9 max|v| + 2^-8 |want|."""
    atol = 5e-5 + (0.0 if dtype == torch.float32 else
                   2.0 ** -9 * v.float().abs().max().item())
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -8
    diff = (got.float() - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"|kernel - plain| max {diff.max().item()} "
                             f"exceeds {atol} + {rtol} |plain|")
    return diff.max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("attention_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build(list(NEW))
    libs = build_old(args.old.resolve(), build.BUILD_DIR / "old")
    rows = []
    for name, (bh, nq, nk, d), dtype in SITES:
        q = seeded((bh, nq, d), 1, dtype)
        k = seeded((bh, nk, d), 2, dtype)
        v = seeded((bh, nk, d), 3, dtype)
        scale = d ** -0.5
        want = attention_plain(q.float(), k.float(), v.float(), scale)
        new = lambda: NEW[name](q, k, v, scale)  # noqa: E731
        old = lambda: old_call(libs, name, q, k, v, scale)  # noqa: E731
        err_new = max_err(new(), want, v, dtype)
        err_old = max_err(old(), want, v, dtype)
        old_a, new_a, new_b, old_b = (cuda_ms(f) for f in (old, new, new,
                                                           old))
        sdpa_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, scale=scale)
        sdpa = cuda_ms(sdpa_call)
        row = dict(kernel=name, site=[bh, nq, nk, d],
                   dtype=str(dtype).split(".")[1], card=card,
                   old_ms=[old_a, old_b], new_ms=[new_a, new_b],
                   sdpa_ms=sdpa, old_device_ms=graph_ms(old),
                   new_device_ms=graph_ms(new),
                   sdpa_device_ms=graph_ms(sdpa_call),
                   speedup=(old_a + old_b) / (new_a + new_b),
                   max_abs_err_new=err_new, max_abs_err_old=err_old)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
