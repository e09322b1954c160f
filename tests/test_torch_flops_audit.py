"""The port's FLOP audit (``frido_tpu_torch/tools/flops_audit.py``) against
the JAX package's functions, on the CPU, on the JAX script's tiny model.

The toy ``FridoDiffusion`` is built in both packages from the same seeded
numpy weights (the JAX tree's shapes from ``jax.eval_shape``; the port's
loaded through ``io/jax_weights.py``). For each unit the
audit counts (each stage's UNet call, stage 1 given its SPADE tables; each
stage's sequential CFG pair; the SPADE tables; the MS-VQGAN decode; the
conditioning encode) the port's product FLOPs (``FlopCounterMode``, every
kernel site on its plain version) must EQUAL the FLOPs of the
``dot_general`` and ``conv_general_dilated`` equations of the JAX
function's ``jax.make_jaxpr``, after dead-code elimination (the JAX
stage call computes the SPADE feature map it then ignores for the given
tables; XLA drops it, the port never computes it), counted as 2 x
multiply-adds (a scan's
body times its length; an input-dilated conv, the JAX
``ConvTranspose2d``, by its input pixels, as ``FlopCounterMode`` counts a
transposed conv). The report's keys are the JAX script's (read from its
source) and ``counted``; its numbers are composed as the JAX script
composes them. The tool's models are ``__graft_entry__.py``'s.
"""

import ast
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.interpreters import partial_eval as pe

import __graft_entry__ as graft
from frido_tpu.models.frido import FridoDiffusion as JaxFrido
from frido_tpu_torch.io.jax_weights import load_jax_params
from frido_tpu_torch.models.frido import FridoDiffusion as PortFrido
from frido_tpu_torch.tools import flagship
from frido_tpu_torch.tools import flops_audit

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
BATCH = 2
CTX_LEN = 12
STEPS = 7


def _conv_flops(eqn) -> int:
    lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
    out = eqn.outvars[0].aval.shape
    lhs_spec, rhs_spec, out_spec = eqn.params["dimension_numbers"]
    kernel = math.prod(rhs[i] for i in rhs_spec[2:])
    cout, cin = rhs[rhs_spec[0]], rhs[rhs_spec[1]]
    if any(d > 1 for d in eqn.params["lhs_dilation"]):
        pixels = math.prod(lhs[i] for i in lhs_spec[2:])
    else:
        pixels = math.prod(out[i] for i in out_spec[2:])
    return 2 * out[out_spec[0]] * pixels * cout * cin * kernel


def _dot_flops(eqn) -> int:
    lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    lfree = [i for i in range(len(lhs)) if i not in lc and i not in lb]
    rfree = [i for i in range(len(rhs)) if i not in rc and i not in rb]
    return 2 * math.prod(lhs[i] for i in (*lb, *lc, *lfree)) * math.prod(
        rhs[i] for i in rfree)


def jaxpr_flops(jaxpr) -> int:
    """2 x multiply-adds of every dot_general and conv_general_dilated,
    sub-jaxprs included (a scan's body times its length)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += _dot_flops(eqn)
        elif name == "conv_general_dilated":
            total += _conv_flops(eqn)
        assert name not in ("while", "cond", "pallas_call"), name
        times = eqn.params["length"] if name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    total += times * jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    total += times * jaxpr_flops(sub)
    return total


@pytest.fixture(scope="module")
def models():
    jmodel = JaxFrido(first_stage_config=graft._TINY_FIRST,
                      cond_stage_config=graft._TINY_COND,
                      unet_config=graft._TINY_UNET, **graft._TINY_MODEL)
    shapes = jax.eval_shape(lambda r: jmodel.init_params(
        r, context_len=CTX_LEN), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.02 * rng.standard_normal(a.shape), a.dtype),
        shapes)
    port = flagship.build(True, "cpu")
    load_jax_params(port, params)
    return jmodel, params, port


def _jax_units(jmodel, params):
    """The JAX script's units (``scripts/flops_audit.py:84-127``) as
    jaxprs, on its inputs at BATCH."""
    lat = jmodel.image_size
    z = jnp.zeros((BATCH, lat, lat, jmodel.channels))
    t = jnp.zeros((BATCH,), jnp.int32)
    dim = graft._TINY_UNET["params"]["context_dim"]
    ctx = jnp.zeros((BATCH, CTX_LEN, dim))
    uctx = jnp.ones((BATCH, CTX_LEN, dim))
    tokens = jnp.zeros((BATCH, CTX_LEN), jnp.int32)
    splits = list(jmodel.embed_dim_list)
    out = {}
    for s in range(jmodel.num_stage):
        aux = None
        if s > 0:
            aux = jmodel.spade_tables(params, z[..., :sum(splits[:s])], s)
            out[f"stage{s}_tables"] = jax.make_jaxpr(
                lambda p, zz, _s=s: jmodel.spade_tables(
                    p, zz[..., :sum(splits[:_s])], _s))(params, z)

        def call(p, x, tt, c, _s=s, _aux=aux):
            return jmodel.apply_model(p, x, tt, c, _s, spade_pre=_aux)

        def pair(p, x, tt, c, u, _call=call):
            e_u = _call(p, x, tt, u)
            e_c = _call(p, x, tt, c)
            return e_u + 1.5 * (e_c - e_u)

        out[f"stage{s}"] = jax.make_jaxpr(call)(params, z, t, ctx)
        out[f"stage{s}_pair"] = jax.make_jaxpr(pair)(params, z, t, ctx, uctx)
    out["decode"] = jax.make_jaxpr(
        lambda p, zz: jmodel.decode_first_stage(p, zz))(params, z)
    out["cond"] = jax.make_jaxpr(
        lambda p, tk: jmodel.get_learned_conditioning(p, tk))(params, tokens)
    return {k: jaxpr_flops(pe.dce_jaxpr(v.jaxpr, [True] * len(
        v.jaxpr.outvars))[0]) for k, v in out.items()}


def test_the_tools_models_are_the_jax_scripts():
    for name in ("_TINY_ED", "_TINY_DD", "_TINY_MODEL", "_TINY_UNET",
                 "_TINY_FIRST", "_TINY_COND"):
        assert getattr(flagship, name) == getattr(graft, name), name
    assert pathlib.Path(flagship.FLAGSHIP_CONFIG) == pathlib.Path(
        graft.FLAGSHIP_CONFIG)


@pytest.fixture(scope="module")
def counts(models):
    jmodel, params, port = models
    got = flops_audit.unit_flops(port, BATCH)
    return _jax_units(jmodel, params), got


@pytest.mark.parametrize("unit", ["stage0", "stage1", "stage0_pair",
                                  "stage1_pair", "stage1_tables", "decode",
                                  "cond"])
def test_unit_flops_equal_the_jax_jaxpr(counts, unit):
    want, got = counts
    assert set(got["flops"]) == set(want)
    assert got["devices"][unit] == "cpu"
    assert want[unit] > 0
    assert got["flops"][unit] * BATCH == want[unit], (unit, got, want)


def _jax_report_keys(num_stage):
    """The keys ``scripts/flops_audit.py`` puts in its report, read from
    its source (its f-strings over the stage index expanded)."""
    tree = ast.parse((REPO / "scripts" / "flops_audit.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "report":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and \
                getattr(node.value, "id", "") == "report" and \
                isinstance(node.ctx, ast.Store):
            key = ast.unparse(node.slice)
            if key.startswith("f"):
                keys |= {re.sub(r"\{s\}", str(s), key[2:-1])
                         for s in range(num_stage)}
            else:
                keys.add(key[1:-1])
    return keys


def test_report_keys_and_composition(counts):
    """The report: the JAX script's keys and ``counted``; the total is
    (steps + 1) pairs a stage, each stage's tables, a decode and two
    encodes; the eager pair is twice a call."""
    _, got = counts
    report = flops_audit.compose(got["flops"], 2, STEPS)
    assert set(report) == _jax_report_keys(2) | {"counted"}
    f = got["flops"]
    want = sum((STEPS + 1) * f[f"stage{s}_pair"] for s in range(2)) + \
        f["stage1_tables"] + f["decode"] + 2 * f["cond"]
    assert report["total_tflop_per_image"] == pytest.approx(want / 1e12,
                                                            rel=1e-12)
    assert report["stage0_cfg_pair_vs_2x_single"] == 1.0
    assert report["stage1_cfg_pair_vs_2x_single"] == 1.0
    assert report["model_calls_per_image"] == 2 * (STEPS + 1) * 2
    assert "products" in report["counted"]


def test_audit_runs_on_meta_and_needs_the_card(counts, capsys, monkeypatch):
    """The CLI counts every tiny unit on ``meta`` (equal to the CPU
    counts), and without a card it raises unless given ``--device cpu``;
    a unit that refuses ``meta`` is counted on ``--device`` instead."""
    _, got = counts
    report = flops_audit.main(["--tiny", "--steps", str(STEPS),
                               "--device", "cpu"])
    assert set(report["devices"].values()) == {"meta"}
    assert report == dict(flops_audit.compose(got["flops"], 2, STEPS),
                          devices=report["devices"])
    assert '"total_tflop_per_image"' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flops_audit.main(["--tiny"])
    decode = PortFrido.decode_first_stage

    def refuse_meta(self, z, chunk=None):
        if z.device.type == "meta":
            raise NotImplementedError("data-dependent on meta")
        return decode(self, z, chunk)

    monkeypatch.setattr(PortFrido, "decode_first_stage", refuse_meta)
    report = flops_audit.audit(tiny=True, steps=STEPS, device="cpu")
    assert report["devices"]["decode"] == "cpu"
    assert report["decode_tflop_per_image"] * 1e12 == got["flops"]["decode"]
