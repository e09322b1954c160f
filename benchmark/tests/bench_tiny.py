"""Tiny cells for the CPU tests: the benchmark's own configurations cut
by the overrides the port's CPU tests use (``tests/test_torch_sample_cli
.py``'s ``TOY``), written with their traffic mixes, limits and a
``BENCHMARK.json`` under a temporary directory laid out as the
benchmark's folder, so the registry finds them by name."""

from __future__ import annotations

import copy
import json
import pathlib
import shutil
from typing import Any, Dict

BENCH = pathlib.Path(__file__).resolve().parents[1]

UNET = {"image_size": 16, "model_channels": 32, "channel_mult": [1, 2],
        "num_res_blocks": 1, "attention_resolutions": [2], "context_dim": 32}
FIRST_STAGE = {
    "n_embed": [16, 16],
    "edconfig": {"ch": 32, "ch_mult": [1, 1, 2], "resolution": 32,
                 "num_res_blocks": 1, "attn_resolutions": [8]},
    "ddconfig": {"ch": 32, "ch_mult": [1, 1], "resolution": 32,
                 "num_res_blocks": 1, "attn_resolutions": [16]}}
COND = {"n_embed": 32, "n_layer": 1}


def tiny_config(name: str) -> Dict[str, Any]:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    p = cfg["model"]["params"]
    p["timesteps"] = 20
    p["image_size"] = 16
    p["unet_config"]["params"].update(UNET)
    fs = p["first_stage_config"]["params"]
    fs["n_embed"] = FIRST_STAGE["n_embed"]
    fs["edconfig"].update(FIRST_STAGE["edconfig"])
    fs["ddconfig"].update(FIRST_STAGE["ddconfig"])
    p["cond_stage_config"]["params"].update(COND)
    return cfg


def tiny_traffic(name: str, **over) -> Dict[str, Any]:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t = copy.deepcopy(t)
    t["batch"] = 2
    t.pop("reference_rows", None)
    if t["kind"] == "sample":
        t["steps"] = 3
    else:
        t["pool"], t["image_size"] = 8, 32
    t.update(over)
    return t


def write_bench(root: pathlib.Path, cells: Dict[str, Dict[str, Any]]
                ) -> pathlib.Path:
    """A checkout-like tree under ``root``: ``BENCHMARK.json`` with the
    real metrics and the given cells (each: ``config``, ``traffic``,
    ``limits``), and ``benchmark/`` with the real metric readers and the
    tiny files. Returns the benchmark folder."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bdir = root / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (bdir / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", bdir / "metrics", dirs_exist_ok=True)
    bench["configs"], bench["workloads"] = [], []
    for name, c in cells.items():
        cfg_name, mix = f"{name}-config", f"{name}-traffic"
        (bdir / "configs" / f"{cfg_name}.json").write_text(
            json.dumps(c["config"]))
        (bdir / "traffic" / f"{mix}.json").write_text(json.dumps(c["traffic"]))
        (bdir / "limits" / f"{name}.json").write_text(json.dumps(c["limits"]))
        bench["configs"].append({"name": cfg_name, "source": "tiny",
                                 "file": f"benchmark/configs/{cfg_name}.json",
                                 "reduced": [], "why": "CPU test"})
        bench["workloads"].append({"name": name, "config": cfg_name,
                                   "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bdir
