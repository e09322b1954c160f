"""Everything a cell needs, found by name: the cell in ``BENCHMARK.json``,
its configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its limits ``limits/<cell>.json`` and each
metric's reader ``metrics/<metric>.py`` (one function, ``read(run)``).
Adding any of them is adding files and entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[Dict[str, Any]] = None,
         bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The workload ``name`` and what it names; KeyError if it is not in
    ``BENCHMARK.json``."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_json(bench_dir.parent / cfg["file"]),
        traffic_name=w["traffic"],
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR
           ) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``: the run record -> the value,
    or None where the run holds nothing to read."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
