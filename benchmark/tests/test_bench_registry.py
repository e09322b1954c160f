"""The harness finds every piece by name, and BENCHMARK.json keeps to the
contract's shape."""

import json
import re

import pytest

from harness import registry
import bench_tiny as tiny

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = registry.cell(name, BENCH)
    assert cell.config["model"]["params"]["unet_config"]
    assert cell.traffic["kind"] in ("sample", "train")
    assert set(cell.limits) >= ({"cond_rel", "latent_rel", "image_rel"}
                                if cell.traffic["kind"] == "sample"
                                else {"loss_gap", "grad_gap", "grad_err_med",
                                      "update_gap"})
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        registry.cell("no.such.cell", BENCH)


def test_contract_shape():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new cell, configuration, traffic mix and limits: files and
    entries only; the registry finds them with no code change."""
    cfg = tiny.tiny_config("frido-t2i-f16f8-coco")
    bdir = tiny.write_bench(tmp_path, {"new.cell": {
        "config": cfg, "traffic": tiny.tiny_traffic("captions-plms20-b32"),
        "limits": {"cond_rel": 1, "latent_rel": 1, "image_rel": 1}}})
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = registry.cell("new.cell", bench, bench_dir=bdir)
    assert cell.config == cfg and cell.traffic["batch"] == 2
    assert {m["name"] for m in cell.per_layer} >= {"mfu.sample", "mfu.train"}


def test_a_metric_is_added_by_a_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "units.any.py").write_text(
        "def read(run):\n    return run.units or None\n")
    read = registry.reader("units.any", bench_dir=tmp_path)

    class Run:
        units = 3

    assert read(Run()) == 3
    Run.units = 0
    assert read(Run()) is None
