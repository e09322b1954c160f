"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is a workload of ``BENCHMARK.json``;
its configuration, traffic mix, limits and metric readers are files under
``benchmark/`` found by name (``harness/registry.py``). The run builds
the program (``frido_tpu_torch``) with seeded weights, warms the cell's
shapes, measures for ``--seconds`` seconds, compares what the window
produced with the plain reference (``reference/``), and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
from a profiled sub-window after the window), ``device`` and, traced,
``breakdown``, then the compared numbers with their limits under
``checks``.

Exit codes: 0 a result was printed (correct or not); 2 bad arguments;
3 no card, or fewer cards than the cell asks for; 4 a forbidden module
(JAX, flax, orbax or the JAX package) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def parse(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program's kernel caches live in the checkout, at fixed paths
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda-cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch-extensions"))
    import torch

    from harness import common, registry

    cell = registry.cell(args.workload, registry.benchmark(ROOT))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    common.print_result(result, checks)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START):
    """One run on ``device``: (the result line's dict, the checks)."""
    from harness import common, compare, registry, sample, train
    from harness import trace as tr

    spans = common.Spans(device)
    runner = {"sample": sample.run, "train": train.run}[cell.traffic["kind"]]
    rec, checks, failed = runner(cell, seed, seconds, trace, device, t_start,
                                 spans)
    metrics = common.read_metrics(
        rec, cell.per_layer if trace else cell.end_to_end, registry.reader)
    dev = common.device_info(device, cell.chips)
    dev["memory_peak_bytes"] = rec.peak_bytes
    result = {"correct": compare.verdict(checks), "attempted": rec.images,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None and rec.trace.window is not None:
        w = rec.trace.window
        dev["busy_s"] = tr.busy_seconds(rec.trace, w)
        dev["window_s"] = w[1] - w[0]
        result["breakdown"] = {"device_ops": tr.top_kernels(rec.trace),
                               "idle_gaps": tr.idle_gaps(rec.trace)}
        print("device time by category: " + repr(
            sorted(tr.by_category(rec.trace).items(),
                   key=lambda kv: -kv[1])), flush=True)
    print(f"window: {rec.units} units, {rec.images} images in "
          f"{rec.window_s!r} s; set-up {rec.setup_s!r} s; "
          f"{rec.extra}", flush=True)
    return result, checks


if __name__ == "__main__":
    sys.exit(main())
