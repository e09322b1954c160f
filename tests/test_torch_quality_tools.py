"""The port's DPM-Solver++-vs-PLMS agreement check
(``frido_tpu_torch/tools/quality_dpmpp_vs_plms.py``) against the JAX
script (``scripts/quality_dpmpp_vs_plms.py``), on the CPU, tiny model:

- ``liven_`` picks the JAX script's leaves: the all-zero parameters of two
  or more dimensions of the JAX tiny model's initial tree (its jitted
  ``init_params``), mapped to the port's names by ``io/jax_weights.py``'s
  name map, are the ones the port livens on the port's tiny model; each
  gets 0.02 x the normal draw of a generator seeded by the CRC32 of its
  name;
- ``psnr`` and ``pearson`` equal the JAX script's functions on the same
  arrays within 1e-12 (an equal pair's infinite PSNR included);
- a ``--tiny --device cpu`` run at cut step counts prints one JSON line
  with every key of the JAX script's output (and ``steps``), finite;
  without a card and ``--device cpu`` the tool raises.

The JAX init compiles the tiny model once (about 30 s on this CPU), most
of this file's time.
"""

import ast
import importlib.util
import json
import pathlib
import zlib

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frido_tpu.models.frido import FridoDiffusion as JaxFrido
from frido_tpu_torch.io.jax_weights import torch_key
from frido_tpu_torch.tools import flagship
from frido_tpu_torch.tools import quality_dpmpp_vs_plms as quality

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "quality_dpmpp_vs_plms.py"


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_quality", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_zero_leaves(tree, path=()):
    """The JAX script's ``liven`` test (``:89-104``): a leaf of two or
    more dimensions whose largest |value| is 0."""
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            yield from _jax_zero_leaves(v, p)
        elif v.ndim >= 2 and float(np.abs(np.asarray(v)).max()) == 0.0:
            yield p


def test_liven_picks_the_jax_scripts_leaves():
    jmodel = JaxFrido(first_stage_config=graft._TINY_FIRST,
                      cond_stage_config=graft._TINY_COND,
                      unet_config=graft._TINY_UNET, **graft._TINY_MODEL)
    params = jax.jit(lambda r: jmodel.init_params(r, context_len=12))(
        jax.random.PRNGKey(0))
    want = {torch_key(p) for p in _jax_zero_leaves(params["params"])}
    assert len(want) > 5
    port = flagship.build(True, "cpu", seed=0)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    names = quality.liven_(port)
    assert set(names) == want and len(names) == len(want)
    for name, p in port.named_parameters():
        if name in want:
            gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
            assert torch.equal(p, 0.02 * torch.randn(p.shape, generator=gen))
        else:
            assert torch.equal(p, before[name]), name
    assert quality.liven_(port) == []


def test_psnr_and_pearson_equal_the_jax_scripts():
    jax_script = _jax_script()
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    for x, y, r in ((a, b, 2.0), (a, b, float(a.max() - a.min())),
                    (a, a, 1.0), (a.astype(np.float64), -b, 3.0)):
        got, want = quality.psnr(x, y, r), jax_script.psnr(x, y, r)
        assert got == want or abs(got - want) <= 1e-12 * abs(want)
        assert abs(quality.pearson(x, y) - jax_script.pearson(x, y)) <= 1e-12
    assert quality.psnr(a, a, 1.0) == float("inf")


def _jax_output_keys():
    """The keys of the JAX script's output dict (``out = {...}``)."""
    tree = ast.parse(SCRIPT.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "out":
            return {k.value for k in node.value.keys}
    raise AssertionError("no output dict in the JAX script")


def test_tiny_cpu_run_prints_every_key(capsys, monkeypatch):
    out = quality.main(["--tiny", "--device", "cpu", "--batch", "2",
                        "--steps", "4,2,2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(out) == _jax_output_keys() | {"steps"}
    assert out["steps"] == {"plms": 4, "dpmpp": 2, "control": 2}
    assert out["backend"] == "cpu" and out["model"] == "tiny"
    for k, v in out.items():
        if k.endswith(("_db", "_pearson")):
            assert np.isfinite(v), (k, v)
    assert quality.STEPS["tiny"] == (50, 10, 25)
    assert quality.STEPS["full"] == (200, 25, 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality.main(["--tiny"])
