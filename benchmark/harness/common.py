"""What every kind of cell shares: the run record the metric readers
read, the spans the harness opens around its calls into the program,
the measured window, the device's description and the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "frido_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``frido_tpu_torch`` passes,
    ``frido_tpu`` and ``frido_tpu.ops`` do not."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Record:
    """One run, as the metric readers see it.

    ``setup_s``: process start to the window's start. ``units``: the
    batches or steps completed inside the window, ``images`` their
    images, ``window_s`` the time from the window's start to the end of
    the last of them. ``peak_bytes``: the device allocator's peak over the
    window. ``trace``: the traced sub-window (``harness/trace.Trace``) in a
    ``--trace 1`` run, else None; ``traced_units`` the batches or steps it
    holds. ``work``: the reference's counts of operations and bytes
    (``harness/flops.py``) in a traced run. ``kind``: ``sample`` or
    ``train``."""
    kind: str
    setup_s: float = math.nan
    units: int = 0
    images: int = 0
    window_s: float = math.nan
    peak_bytes: int = 0
    trace: Any = None
    traced_units: int = 0
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Spans:
    """Named ranges around the harness's calls into the program. While
    ``marking`` is set (the traced sub-window) each range launches a
    marker kernel at both ends (``torch.cuda._sleep``, which the program
    never calls) on the stream the program runs on, without waiting for
    the device, and records its name in ``marks``: the n-th marker in the
    device trace is the n-th mark, and stream order places every range
    on the device's own timeline around the kernels launched inside it,
    without the profiler recording host operations."""

    def __init__(self, device):
        self.device = device
        self.marking = False
        self.marks: List[str] = []

    def _edge(self, name: str) -> None:
        if self.marking and self.device.type == "cuda":
            import torch

            torch.cuda._sleep(1)
            self.marks.append(name)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._edge(name)
        try:
            yield
        finally:
            self._edge(name)

    def wrap(self, obj, method: str, name: str,
             keep: Optional[Callable[[Any], None]] = None) -> None:
        """Replace ``obj.method`` on the instance by a call inside the
        range ``name``; ``keep(result)`` sees each result."""
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            with self(name):
                out = inner(*args, **kwargs)
            if keep is not None:
                keep(out)
            return out

        setattr(obj, method, wrapped)


class Phases:
    """Host seconds of each phase of a run, printed on one line."""

    def __init__(self, t0: float):
        self.t = t0
        self.seconds: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


def synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def measure(unit: Callable[[int], int], seconds: float, device
            ) -> Dict[str, float]:
    """Run ``unit(i)`` (returning its images; the device synchronised
    after it) for i = 0, 1, ... while the window is open. Only units that
    end inside the window count: ``units``, ``images`` and ``window_s``
    (the window's start to the end of the last one). A unit that begins
    inside the window and ends after it is finished but not counted; if
    not even the first one ends inside the window, it alone counts."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done: List[tuple] = []
    ends = [t0]
    i = 0
    while True:
        n = unit(i)
        synchronize(device)
        t = time.perf_counter()
        ends.append(t)
        i += 1
        if t <= deadline or not done:
            done.append((n, t))
        if t >= deadline:
            break
    counted = [d for d in done if d[1] <= deadline] or done[:1]
    return {"units": len(counted), "images": sum(n for n, _ in counted),
            "window_s": counted[-1][1] - t0, "started": i,
            "unit_s": [b - a for a, b in zip(ends, ends[1:])]}


def rate(images: int, window_s: float) -> Optional[float]:
    return images / window_s if window_s > 0 and images > 0 else None


def device_info(device, count: int) -> Dict[str, Any]:
    import torch

    info: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda"
                            else device.type, "count": count}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
        info["power_limit_w"] = power_limit()
    else:
        info["kind"] = "cpu"
    return info


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def read_metrics(record: Record, metrics: List[Dict[str, Any]],
                 reader) -> Dict[str, Dict[str, Any]]:
    """Each metric's value by its reader; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def print_result(result: Dict[str, Any], checks: List[Dict[str, Any]]
                 ) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the checks under the last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)
