"""What a traced sub-window's profile says: the device kernels' intervals,
the benchmark's spans, the device's busy time and idle gaps, and each
kernel's category.

:func:`categorize` and its tables are a copy of
``frido_tpu_torch/tools/profile_step.py``'s (the port's six kernels by
their ``__global__`` names, then cuDNN, cuBLAS, PyTorch's elementwise and
reduction kernels, copies and casts).

The spans are the ranges the harness opens around its calls into the
program (``harness/common.Spans``); in the traced sub-window each
launches a marker kernel at both ends on the program's stream, so stream
order places a span on the device's own timeline with the kernels it
launched inside it, and nothing waits for the device. The profiler records device activity only,
which adds next to nothing to the host's time. Times are seconds from
the profiler's start."""

from __future__ import annotations

import dataclasses
import functools
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

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
OTHER_CATEGORIES = (
    ("copy/cast", r"copy|Copy|Memcpy|Memset|_to_copy|\bto\b|\bcast|CatArray"
                  r"|\bclone\b|\bcat\b|contiguous"),
    ("cuDNN conv", r"fprop|dgrad|wgrad|convolution|conv2d|cudnn|fft"
                   r"|_cf32|winograd|implicit_convolve|nchwToNhwc"
                   r"|nhwcToNchw|flip_filter"),
    ("GEMM", r"gemm|gemv|nvjet|cublas|cutlass|xmma|Kernel2"
             r"|\b(addmm|mm|bmm|baddbmm|matmul|linear)\b"),
    ("elementwise", r"elementwise|Elementwise"),
    ("reduction/norm", r"reduce|Reduce|norm|Norm|softmax|SoftMax|Moments"
                       r"|FusedParams|argmin|argmax|welford|Welford"
                       r"|\b(sum|mean|std|var|max|min)\b"),
    ("elementwise", r"\b(add|add_|mul|mul_|sub|div|silu|gelu|sigmoid|tanh"
                    r"|exp|rsub|neg|where|clamp|pow|sqrt|rsqrt|cos|sin"
                    r"|fill_|zero_|copysign|abs)\b"),
)


@functools.lru_cache(maxsize=None)
def categorize(name: str) -> str:
    """The category of a device kernel by its name."""
    for cat, pattern in PORT_KERNELS + OTHER_CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """``kernels``: (start, end, name) of each device operation;
    ``spans``: (name, start, end) of each benchmark span, the traced
    window's own included as ``window``."""
    kernels: List[Tuple[float, float, str]]
    spans: List[Tuple[str, float, float]]

    @property
    def window(self) -> Optional[Interval]:
        w = [(a, b) for n, a, b in self.spans if n == "window"]
        return w[0] if w else None

    def spans_named(self, name: str) -> List[Interval]:
        return [(a, b) for n, a, b in self.spans if n == name]


MARKER = r"\bspin_kernel\b"


def from_profiler(prof, marks: Sequence[str]) -> Trace:
    """The kernels and spans of a ``torch.profiler.profile`` run of device
    activity. ``marks``: the span name of each marker kernel, in launch
    order (``harness/common.Spans``); each span's first marker opens it
    and its second closes it. Raises when the trace's markers and the
    marks disagree."""
    events = device_events(prof)
    markers = [e for e in events if re.search(MARKER, e[2])]
    kernels = [e for e in events if not re.search(MARKER, e[2])]
    if len(markers) != len(marks):
        raise RuntimeError(f"{len(markers)} marker kernels in the trace for "
                           f"{len(marks)} span edges")
    return Trace(kernels=kernels, spans=pair_marks(markers, marks))


def device_events(prof) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every device operation, in seconds, sorted,
    read from the profiler's raw results (building its per-event Python
    objects takes tens of seconds for a batch's 150 000 kernels)."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    out = []
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            a = e.start_ns() * 1e-9
            out.append((a, a + e.duration_ns() * 1e-9, e.name()))
    out.sort()
    return out


def pair_marks(markers: Sequence[Tuple[float, float, str]],
               marks: Sequence[str]) -> List[Tuple[str, float, float]]:
    """Spans from the marker kernels in order: each name's markers open
    and close its span in turn (a span never nests in one of its own
    name); a span runs from the end of its opening marker to the start of
    its closing one."""
    opened: Dict[str, float] = {}
    spans = []
    for (a, b, _), name in zip(markers, marks):
        if name in opened:
            spans.append((name, opened.pop(name), a))
        else:
            opened[name] = b
    return sorted(spans, key=lambda s: s[1])


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy_seconds(tr: Trace, within: Interval) -> float:
    """Seconds in ``within`` in which some device operation ran."""
    ks = clip([(a, b) for a, b, _ in tr.kernels], *within)
    return sum(b - a for a, b in union(ks))


def idle_share(tr: Trace) -> Optional[float]:
    """1 - busy / wall over the traced window; None without kernels."""
    w = tr.window
    if w is None or not tr.kernels or w[1] <= w[0]:
        return None
    return 1.0 - busy_seconds(tr, w) / (w[1] - w[0])


def device_seconds_in(tr: Trace, span: str) -> Optional[float]:
    """Device-busy seconds inside every span named ``span``, summed;
    None without such spans or kernels."""
    ivs = tr.spans_named(span)
    if not ivs or not tr.kernels:
        return None
    return sum(busy_seconds(tr, iv) for iv in ivs)


def _innermost(tr: Trace, t: float) -> str:
    best = None
    for name, a, b in tr.spans:
        if name != "window" and a <= t < b and (
                best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "between spans"


def idle_gaps(tr: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` longest idle gaps of the window, each named by the
    innermost span it lies in on the device's timeline: the span whose
    kernels the host was launching while the device waited."""
    w = tr.window
    if w is None or not tr.kernels:
        return []
    busy = union(clip([(a, b) for a, b, _ in tr.kernels], *w))
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return [(_innermost(tr, a), b - a) for a, b in gaps[:n]]


def top_kernels(tr: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` kernel names that took most device time in the window,
    each as ``<category>: <name>`` (cut to 160 characters)."""
    w = tr.window
    totals: Dict[str, float] = {}
    for a, b, name in tr.kernels:
        if w is not None:
            a, b = max(a, w[0]), min(b, w[1])
        if b > a:
            totals[name] = totals.get(name, 0.0) + (b - a)
    ranked = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [(f"{categorize(k)}: {k}"[:160], v) for k, v in ranked]


def by_category(tr: Trace) -> Dict[str, float]:
    w = tr.window
    out: Dict[str, float] = {}
    for a, b, name in tr.kernels:
        if w is not None:
            a, b = max(a, w[0]), min(b, w[1])
        if b > a:
            cat = categorize(name)
            out[cat] = out.get(cat, 0.0) + (b - a)
    return out


def capture(unit, n: int, spans, device, attempts: int = 2
            ) -> Tuple[Trace, int]:
    """``n`` units under the profiler (device activity only), inside the
    ``window`` span, every span of ``spans`` (``harness/common.Spans``)
    marked on the device's timeline. The device is settled with a few
    unmarked kernels before the first mark and after the last, so no
    marker is launched while the profiler starts or stops; a profile
    whose markers still disagree with the marks is taken again, up to
    ``attempts`` times. Off the card there is nothing to trace: an empty
    trace."""
    import sys

    import torch

    if device.type != "cuda":
        return Trace(kernels=[], spans=[]), n

    def settle():
        pad = torch.zeros(1, device=device)
        for _ in range(3):
            pad.add_(1)
        torch.cuda.synchronize(device)
        time.sleep(0.05)

    for attempt in range(attempts):
        spans.marking, spans.marks = True, []
        t0 = time.perf_counter()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                settle()
                t1 = time.perf_counter()
                with spans("window"):
                    for k in range(n):
                        unit(attempt * n + k)
                        # as the measured window does after each unit
                        torch.cuda.synchronize(device)
                t2 = time.perf_counter()
                settle()
        finally:
            spans.marking = False
        t3 = time.perf_counter()
        try:
            trace = from_profiler(prof, spans.marks)
        except RuntimeError as e:
            print(f"traced window {attempt}: {e}", file=sys.stderr)
            continue
        print(f"traced window: start {t1 - t0!r} s, {n} units {t2 - t1!r} "
              f"s, stop {t3 - t2!r} s, reading {time.perf_counter() - t3!r} "
              f"s, {len(trace.kernels)} kernels", flush=True)
        return trace, n
    raise RuntimeError(f"no traced window in {attempts} attempts")
