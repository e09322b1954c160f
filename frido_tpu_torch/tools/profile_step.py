"""Device time of each unit of the t2i sampling step, by category and by
kernel (port of ``scripts/profile_step.py``).

    python -m frido_tpu_torch.tools.profile_step [--batch 128] [--iters 5]
        [--top 15] [--units stage0,stage1] [--params-dtype bfloat16]
        [--tiny] [--device cpu]

Captures a ``torch.profiler`` trace (``utils/profiling.trace`` with the
operators' input shapes, each call inside ``annotate(unit)``) of the step
units the sampling chain runs, after a warm-up call:

- ``stage0``: one eps call on stage 0 (one of the two sequential-CFG
  calls; batch B, bf16);
- ``stage1``: one stage-1 eps call with the SPADE tables made beforehand,
  as ``FridoDiffusion.sample`` runs it;
- ``cond``: the BERT encode (once a batch, not a step);
- ``decode``: one 32-image MS-VQGAN decode chunk (once a batch).

For each unit it prints the device milliseconds a call (the kernels'
durations summed), the host's wall milliseconds a call (ending in a
synchronise), the device time by category (each of the port's six
kernels by name, the two conv kernels' weight pack and split-K reduce,
GEMM, cuDNN conv, elementwise, reduction/norm, copy/cast, other), the top
kernels with the input shapes of the operator that launched them, and the
tensor-core time by (kind, shape) in place of the JAX script's
``mxu_by_shape``: cuBLAS GEMMs, cuDNN convs and the port's ``mma.sync``
kernels (flash, smalls, both convs). The JAX script's "% HBM-bound"
line is left out: ``torch.profiler`` gives no bytes a kernel. The
kernels' own bounds are ``chip_smoke.py``'s ``bound_ms``.

On the CPU (``--device cpu``, the tests) there are no device kernels: the
operators' own host times stand in for them, so the plumbing runs end to
end; its numbers are not the card's. ``--tiny`` runs the tiny model. The
kernel switches are the environment's (``ops/cuda/dispatch.py``): the
default runs flash and the VQ argmin in ``decode``, ``FRIDO_CONV_MODE=
pallas_fused FRIDO_GN_PALLAS=1 FRIDO_SMALLS_ATTN=1`` all six kernels.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from frido_tpu_torch.device import resolve_device
from frido_tpu_torch.tools import flagship
from frido_tpu_torch.utils.profiling import annotate, device_sync, trace

# the port's kernels (``csrc/*.cu``) by their __global__ functions
PORT_KERNELS = (
    ("flash_attention", r"\bflash_kernel\b"),
    ("smalls_attention", r"\bsmalls_kernel\b"),
    ("group_norm", r"\bgroup_norm_(regs|cluster|stream)_kernel\b"),
    ("vq_argmin", r"\bvq_kernel\b"),
    ("conv3x3_norm_silu",
     r"\bconv3x3_kernel<.*\btrue>|\bgroup_affine_kernel\b"),
    ("conv3x3", r"\bconv3x3_kernel<.*\bfalse>"),
    ("conv3x3 pack/reduce", r"\b(pack_weight|splitk_reduce)_kernel\b"),
)
PORT_KERNEL_NAMES = ("flash_attention", "vq_argmin", "group_norm",
                     "smalls_attention", "conv3x3", "conv3x3_norm_silu")
OTHER_CATEGORIES = (
    ("copy/cast", r"copy|Copy|Memcpy|Memset|_to_copy|\bto\b|\bcast|CatArray"
                  r"|\bclone\b|\bcat\b|contiguous"),
    # cuDNN's FFT convolution runs complex (cf32) GEMMs
    ("cuDNN conv", r"fprop|dgrad|wgrad|convolution|conv2d|cudnn|fft"
                   r"|_cf32|winograd|implicit_convolve|nchwToNhwc"
                   r"|nhwcToNchw|flip_filter"),
    ("GEMM", r"gemm|gemv|nvjet|cublas|cutlass|xmma|Kernel2"
             r"|\b(addmm|mm|bmm|baddbmm|matmul|linear)\b"),
    # PyTorch's elementwise kernels (their functors may say "norm", as the
    # normal distribution's), then reductions, then the CPU's operators
    ("elementwise", r"elementwise|Elementwise"),
    ("reduction/norm", r"reduce|Reduce|norm|Norm|softmax|SoftMax|Moments"
                       r"|FusedParams|argmin|argmax|welford|Welford"
                       r"|\b(sum|mean|std|var|max|min)\b"),
    ("elementwise", r"\b(add|add_|mul|mul_|sub|div|silu|gelu|sigmoid|tanh"
                    r"|exp|rsub|neg|where|clamp|pow|sqrt|rsqrt|cos|sin"
                    r"|fill_|zero_|copysign|abs)\b"),
)
TENSOR_CORE = {"GEMM": "gemm", "cuDNN conv": "conv",
               "flash_attention": "flash", "smalls_attention": "smalls",
               "conv3x3": "conv3x3", "conv3x3_norm_silu": "conv3x3 fused"}
# a cuBLAS or cuDNN kernel runs on the tensor cores when its name gives a
# tensor-core type or instruction; fp32 ones (``f32f32_f32f32_f32``,
# ``ffma``, ``sgemm``) run on the CUDA cores
LIBRARY_TENSOR_CORE = r"bf16|f16|tf32|hmma|16816|1688|tensorop|nvjet"
UNITS = ("stage0", "stage1", "cond", "decode")
DECODE_CHUNK = 32


@functools.lru_cache(maxsize=None)
def categorize(name: str) -> str:
    """The category of a device kernel (or, on the CPU, an operator) by
    its name."""
    for cat, pattern in PORT_KERNELS + OTHER_CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _shapes(op) -> str:
    if op is None:
        return ""
    dims = [list(d) for d in (op.input_shapes or []) if d]
    return f"{op.name} {dims}" if dims else op.name


def device_events(prof) -> List[Dict[str, Any]]:
    """The profiled block's device kernels as ``{name, us, shapes}``, in
    start order. The device-side ranges of annotations (``annotate``,
    the optimizer's ``record_function``) carry the name of their host
    event and span kernels: they are left out. ``shapes`` is the
    launching operator and its input shapes: each operator lists the
    kernels it launched, and the kernels of one name run in the order
    they were launched, so each name's launches take its operators'
    shapes in turn (``""`` where none is linked). Without device kernels
    (a CPU run) the operators' own host times stand in for them."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = {e.name for e in cpu}
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.name not in spans),
                     key=lambda e: e.time_range.start)
    if not kernels:
        return [{"name": e.name, "us": e.self_cpu_time_total,
                 "shapes": _shapes(e)}
                for e in cpu if e.name.startswith("aten::")]
    launched = collections.defaultdict(collections.deque)
    for op in sorted(cpu, key=lambda e: e.time_range.start):
        for k in op.kernels:
            launched[k.name].append(_shapes(op))
    return [{"name": e.name, "us": e.time_range.elapsed_us(),
             "shapes": launched[e.name].popleft() if launched[e.name]
             else ""} for e in kernels]


def capture(fn: Callable[[], Any], iters: int, label: str):
    """``iters`` calls of ``fn`` under the profiler after one warm-up
    call: (device events, wall seconds of the calls)."""
    device_sync(fn())
    with tempfile.TemporaryDirectory() as td:
        with trace(td, record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                with annotate(label):
                    out = fn()
            device_sync(out)
            wall = time.perf_counter() - t0
        return device_events(prof), wall


def summarize(events: List[Dict[str, Any]], iters: int, label: str,
              top: int, wall: Optional[float] = None) -> Dict[str, Any]:
    """Print a unit's device ms a call, its time by category and its top
    kernels (with shapes); return them: ``ms``, ``wall_ms``,
    ``categories`` (ms a call, largest first), ``shares`` (percent of the
    device time) and ``top`` [(name, ms a call, shapes)]."""
    by_cat: Dict[str, float] = collections.Counter()
    by_op: Dict[str, float] = collections.defaultdict(float)
    shapes: Dict[str, str] = {}
    total = 0.0
    for e in events:
        total += e["us"]
        by_cat[categorize(e["name"])] += e["us"]
        by_op[e["name"]] += e["us"]
        shapes.setdefault(e["name"], e["shapes"])
    ms = total / iters / 1e3
    wall_ms = None if wall is None else wall / iters * 1e3
    wall_txt = "" if wall is None else f", {wall_ms:.2f} ms/call wall"
    print(f"\n== {label}: {ms:.3f} ms/call device time{wall_txt} "
          f"({iters} iters, {len(events)} kernels) ==")
    cats = sorted(by_cat.items(), key=lambda kv: -kv[1])
    shares = {}
    for cat, us in cats:
        shares[cat] = us / total * 100 if total else 0.0
        print(f"  {cat:28s} {us / iters / 1e3:8.3f} ms  {shares[cat]:5.1f}%")
    print(f"  top {top} kernels:")
    tops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    for name, us in tops:
        print(f"    {us / iters / 1e3:8.3f} ms  {us / total * 100:5.1f}%  "
              f"{name[:80]}  {shapes[name][:120]}")
    return {"ms": ms, "wall_ms": wall_ms,
            "categories": {c: us / iters / 1e3 for c, us in cats},
            "shares": shares,
            "top": [(n, us / iters / 1e3, shapes[n]) for n, us in tops]}


def tensor_core_by_shape(events: List[Dict[str, Any]], iters: int,
                         top: int) -> Dict[Any, float]:
    """Print and return the tensor-core kernels' ms a call by (kind,
    shape): cuBLAS GEMMs and cuDNN convs of a tensor-core type by their
    operator's input shapes, the port's ``mma.sync`` kernels by their
    template arguments."""
    agg: Dict[Any, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        kind = TENSOR_CORE.get(categorize(e["name"]))
        if kind is None or (kind in ("gemm", "conv") and (
                "ffma" in e["name"]
                or not re.search(LIBRARY_TENSOR_CORE, e["name"]))):
            continue
        args = re.search(r"<(.*)>", e["name"])
        shape = e["shapes"] or (args.group(1) if args else e["name"])[:60]
        a = agg[(kind, shape)]
        a[0] += e["us"]
        a[1] += 1
    total = sum(a[0] for a in agg.values())
    print(f"  tensor-core time by (kind, shape) - {total / iters / 1e3:.3f} "
          f"ms a call:")
    for (kind, shape), (us, n) in sorted(agg.items(),
                                         key=lambda kv: -kv[1][0])[:top]:
        print(f"    {kind:13s} {shape[:70]:70s} x{n // iters:4d}  "
              f"{us / iters / 1e3:8.3f} ms  {us / total * 100:5.1f}%")
    return {k: a[0] / iters / 1e3 for k, a in agg.items()}


def report(events: List[Dict[str, Any]], iters: int, label: str, top: int,
           wall: Optional[float] = None) -> Dict[str, Any]:
    """:func:`summarize` and, under ``tensor_cores``, the tensor-core
    table of one unit."""
    out = summarize(events, iters, label, top, wall)
    out["tensor_cores"] = tensor_core_by_shape(events, iters, top)
    return out


def step_units(model, batch: int, ctx_len: int) -> Dict[str, Callable]:
    """The sampling step's units on ``model`` (the JAX script's inputs:
    a seeded bf16 latent, t = 500, all-zero tokens)."""
    dev, bf = model.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn((batch, model.image_size, model.image_size,
                     model.channels), generator=gen, device=dev).to(bf)
    t = torch.full((batch,), 500, dtype=torch.long, device=dev)
    tokens = torch.zeros((batch, ctx_len), dtype=torch.long, device=dev)
    first = model.embed_dim_list[0]
    with torch.no_grad():
        ctx = model.get_learned_conditioning(tokens).to(bf)
        pre = model.spade_tables(z[..., :first], 1)

    @torch.no_grad()
    def stage0():
        return model.apply_model(z, t, ctx, 0).float().mean()

    @torch.no_grad()
    def stage1():
        return model.apply_model(z, t, ctx, 1, spade_pre=pre).float().mean()

    @torch.no_grad()
    def cond():
        return model.get_learned_conditioning(tokens).float().mean()

    @torch.no_grad()
    def decode():
        return model.decode_first_stage(z[:DECODE_CHUNK].float()).mean()

    return {"stage0": stage0, "stage1": stage1, "cond": cond,
            "decode": decode}


def cast_params_(model, dtype: torch.dtype) -> None:
    """Every fp32 parameter to ``dtype`` (``--params-dtype``)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)


def profile(model, units, batch: int, iters: int, top: int,
            ctx_len: int) -> Dict[str, Dict[str, Any]]:
    """Capture and summarize each unit; returns each one's summary with
    its tensor-core table (``tensor_cores``)."""
    fns = step_units(model, batch, ctx_len)
    results = {}
    for name in units:
        ev, wall = capture(fns[name], iters, name)
        results[name] = report(ev, iters, name, top, wall)
    if "stage0" in results and "stage1" in results:
        pair = results["stage0"]["ms"] + results["stage1"]["ms"]
        # sequential CFG runs each stage twice a step (cond + uncond)
        print(f"\nper-step (sequential CFG, both stages): {2 * pair:.2f} ms"
              f" -> {batch / (2 * pair * 200 / 1e3):.3f} img/s at 200 "
              f"steps (device-time bound, excludes fixed costs)")
    return results


def main(argv: Optional[list] = None, model=None) -> Dict[str, Any]:
    """The CLI; ``model`` (a built flagship) skips the build."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--units", default="stage0,stage1")
    ap.add_argument("--params-dtype", default=None,
                    help="cast the fp32 parameters to this dtype (e.g. "
                         "bfloat16): the UNet then casts no weight a call")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (a CPU smoke test)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    units = [u for u in args.units.split(",") if u]
    unknown = set(units) - set(UNITS)
    if unknown:
        raise ValueError(f"--units: unknown {sorted(unknown)}; the units "
                         f"are {', '.join(UNITS)}")
    device = resolve_device(args.device)
    print(f"device={device} batch={args.batch} "
          f"conv_mode={os.environ.get('FRIDO_CONV_MODE', 'conv')} "
          f"pallas={os.environ.get('FRIDO_PALLAS', 'auto')} "
          f"gn_pallas={os.environ.get('FRIDO_GN_PALLAS', '0')} "
          f"smalls_attn={os.environ.get('FRIDO_SMALLS_ATTN', '0')}")
    if model is None:
        model = flagship.build(args.tiny, device)
    if args.params_dtype:
        cast_params_(model, getattr(torch, args.params_dtype))
    ctx_len, _ = flagship.context_shape(args.tiny)
    return profile(model, units, args.batch, args.iters, args.top, ctx_len)


if __name__ == "__main__":
    main()
