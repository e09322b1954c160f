"""The run's own check that no JAX module was loaded, compared by whole
top-level names, and the refusals of run.py without a card."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from harness import common

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mods,bad", [
    (["frido_tpu_torch", "frido_tpu_torch.models.frido", "torch"], []),
    (["frido_tpu", "frido_tpu_torch"], ["frido_tpu"]),
    (["frido_tpu.ops.pallas"], ["frido_tpu.ops.pallas"]),
    (["jax.numpy", "jaxlib", "flax.linen", "orbax.checkpoint"],
     ["flax.linen", "jax.numpy", "jaxlib", "orbax.checkpoint"]),
    (["jaxtyping", "flaxen", "frido_tpux"], []),
])
def test_forbidden_by_whole_top_level_name(mods, bad):
    assert common.forbidden_modules(dict.fromkeys(mods)) == bad


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        src = path.read_text()
        assert "frido_tpu" not in src.replace("frido_tpu_torch/", ""), path
        assert "import jax" not in src and "from jax" not in src


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result(card_free=None):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(ROOT, "--workload", "t2i.sample", "--seed", str(2 ** 31 + 5),
             "--seconds", "1", "--trace", "0")
    assert r.returncode == 3 and "CUDA" in r.stderr
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    cannot run a cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", "t2i.sample", "--seed", "7",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert not any(line.startswith("{") and "correct" in json.loads(line)
                   for line in r.stdout.splitlines() if line.startswith("{"))
