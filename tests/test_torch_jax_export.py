"""JAX-trained checkpoints onto the port: ``tools/export_jax_checkpoint.py``
(orbax -> numpy, run where orbax is), ``frido_tpu_torch/io/jax_export.py``
(the export read with numpy and torch) and
``frido_tpu_torch/tools/import_jax_run.py`` (the export as a port run).

The model is the one of ``tools/make_jax_export_fixture.py`` (the toy t2i
of the committed fixture ``frido_tpu_torch/data/fixtures/jax_export_toy``).
The committed fixture (AdamW with a bfloat16 first moment, made by that
tool) is imported and stepped as ``chip_smoke.py`` does on the card
(``tools/jax_import_check.py``), against the JAX numbers it carries, and
its structure is held to a fresh export of the same settings. A fresh JAX
run (one jitted ``make_train_step``) with ``MultiSteps`` over 3 calls and
a bfloat16 first moment takes two steps, is saved by
``frido_tpu.io.checkpoint.save_train_state`` (also in the legacy layout
whose EMA shadows the whole params tree, and as a ``best`` tag), exported,
imported, and stepped once in the port on the third batch with the JAX
step's draws of t and the noise; the result is held to the JAX step 3.

Tolerances, those of ``tests/test_torch_training.py``:

- the imported state: every tensor bit for bit the exported array in the
  port's layout (bf16 leaves through their fp32 values), counts equal;
- the step's loss and logs: 3e-4 absolute;
- weights: 2 lr (an element whose gradient is at the rounding level moves
  by up to lr either way);
- gradients, the scale of the moments' bounds: per leaf 1e-3 of its
  largest JAX magnitude, floored at 1e-3 of the largest over all leaves.
  The JAX gradient's magnitude is read off its second moments,
  ``|g| = sqrt((nu_3 - b2 nu_2) / (1 - b2))`` (the mean over the
  accumulated calls under ``MultiSteps``); with that bound delta, the first
  moment within (1 - b1) delta (plus 2^-7 relative, two bf16 roundings,
  when it is bf16), the second within (1 - b2) (2 |g| delta + delta^2)
  plus 1e-6 relative, the ``MultiSteps`` accumulator within delta;
- the EMA within (1 - d) 2 lr + 1e-7, d the decay at the new count;
- the params-only export's UNet call against the JAX one: 3e-4 absolute
  (``tests/test_torch_models.py``'s golden tolerance); the MS-VQGAN
  generator's reconstruction: 3e-4 absolute
  (``tests/test_torch_vqgan_training.py``'s).
"""

import concurrent.futures
import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.io import checkpoint as jax_ckpt
from frido_tpu.models.msvqgan import msvqgan_from_config
from frido_tpu.training import optim as jax_optim
from frido_tpu.training import trainer as jax_trainer
from frido_tpu.training.vqgan_trainer import VQGANTrainState
from frido_tpu_torch.cli import main as cli
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io import jax_weights
from frido_tpu_torch.io.jax_export import read_export, to_port
from frido_tpu_torch.io.jax_weights import to_torch_layout
from frido_tpu_torch.models.msvqgan import MSFPNVQModel
from frido_tpu_torch.tools import jax_import_check
from frido_tpu_torch.tools.import_jax_run import import_run
from frido_tpu_torch.training import optim, trainer
from frido_tpu_torch.training.vqgan_trainer import VQGANTrainer
from frido_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
from tests.test_torch_models import _random_params
from tests.test_torch_train_cli import COMMON, workspace  # noqa: F401

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "frido_tpu_torch" / "data" / "fixtures" / "jax_export_toy"
LOSS_ATOL = 3e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-3
B1, B2 = 0.9, 0.999
MULTI = dict(accumulate_grad_batches=3, mu_bf16=True)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fx = _load_tool("make_jax_export_fixture")
exporter = _load_tool("export_jax_checkpoint")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run (``MultiSteps`` over 3 calls, bf16 first moment): the
    state after two steps, its exports (current layout, legacy layout,
    ``best`` tag) and ``after()``, the JAX state and logs after the third
    step; and the fixture's AdamW state at step 0, exported."""
    root = tmp_path_factory.mktemp("jax_runs")
    cfg = fx.model_config()
    rng = jax.random.PRNGKey(fx.SEED)
    jmodel, _, state, step = fx.build(cfg, **MULTI)
    b0 = {k: jnp.asarray(v) for k, v in fx.batch(0).items()}
    # XLA compiles the step on another thread while the exports run
    pool = concurrent.futures.ThreadPoolExecutor(1)
    compiled = pool.submit(step.lower(state, b0, rng).compile)
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state.params)
    _, _, adamw, _ = fx.build(cfg, shapes=shapes)
    fx.save_run(str(root / "adamw"), adamw, cfg)
    exporter.export(str(root / "adamw"), str(root / "adamw-export"))
    state, _ = fx.run_steps(state, compiled.result(), 2, rng)
    pool.shutdown()
    exports = {"current": root / "export", "legacy": root / "legacy-export",
               "best": root / "best-export", "adamw": root / "adamw-export"}
    fx.save_run(str(root / "run"), state, cfg)
    exporter.export(str(root / "run"), str(exports["current"]))
    legacy = state.replace(ema_params=jax_trainer.ema_full_params(state))
    fx.save_run(str(root / "legacy"), legacy, cfg)
    exporter.export(str(root / "legacy"), str(exports["legacy"]))
    best = fx.save_run(str(root / "run"), state, cfg, tag="best",
                       meta={"monitor": 0.5})
    exporter.export(best, str(exports["best"]))
    return dict(jmodel=jmodel, state=state, exports=exports,
                draws=fx.draws(jmodel, 2, rng),
                after=functools.cache(functools.partial(
                    fx.run_steps, state, compiled.result(), 1, rng,
                    start=2)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _imported_trainer(export_dir, out_dir):
    done = import_run(str(export_dir), str(out_dir))
    assert done["step"] == 2 and done["meta"] == fx.CURSOR
    step3 = {"lr": fx.LR, "mu_dtype": "bfloat16",
             "accumulate_grad_batches": MULTI["accumulate_grad_batches"]}
    return jax_import_check.imported_trainer(str(out_dir), "cpu", step3)


def _feed(monkeypatch, draws):
    t, noise = draws

    def fake(generator, batch, timesteps, noise_shape, device):
        assert noise.shape == tuple(noise_shape)
        return (torch.from_numpy(t.astype(np.int64)),
                torch.from_numpy(noise.copy()))

    monkeypatch.setattr(trainer, "_draw", fake)


def _sd(tree):
    """A JAX tree's arrays in the port's layout, fp32; optax's
    ``MaskedNode`` leaves (the frozen first stage's moments) dropped."""
    return jax_weights._state_dict(tree)


def _adam(opt_state):
    """(Adam state, MultiSteps state) of the JAX run's opt_state."""
    multi = opt_state.inner_states["train"].inner_state
    return multi.inner_opt_state[0], multi


# ---------------------------------------------------------------------------
def test_committed_fixture_has_the_fresh_export_structure(run):
    """The committed fixture has the structure, dtypes and shapes of an
    export that the JAX package makes today with its settings, and its
    meta."""
    fresh = json.loads((run["exports"]["adamw"] / "tree.json").read_text())
    committed = json.loads((FIXTURE / "tree.json").read_text())
    assert committed["tree"] == fresh["tree"]
    assert committed["kind"] == fresh["kind"] == "train_state"
    assert not committed["legacy_ema"]
    assert json.loads((FIXTURE / "meta.json").read_text()) == {
        "step": 2, **fx.CURSOR}
    step3 = json.loads((FIXTURE / "step3.json").read_text())
    assert step3["step"] == step3["count"] == step3["ema_updates"] == 3
    export = read_export(str(FIXTURE))
    assert any(d == "bfloat16" and "/mu/" in k
               for k, d in export.dtypes.items())


def test_committed_fixture_steps_as_jax_did(tmp_path):
    """``chip_smoke.py``'s jax-import phase on the CPU: the fixture
    imported bit for bit, its third step held to the JAX numbers (loss,
    sampled weights and EMA), PLMS from the EMA."""
    out = jax_import_check.run(torch.device("cpu"), str(tmp_path / "run"))
    assert out["step"] == 2 and out["meta"] == fx.CURSOR
    errs = out["errors"]
    assert errs["loss"] <= LOSS_ATOL
    assert 0 < errs["weight"] <= 2 * fx.LR


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_imported_state_equals_the_arrays(run, layout, tmp_path):
    """Every tensor of the imported trainer, bit for bit the JAX arrays in
    the port's layout (the bf16 first moment included); the legacy
    export's EMA is the denoiser's slice."""
    export = read_export(str(run["exports"][layout]))
    assert export.legacy_ema == (layout == "legacy")
    assert export.meta == {"step": 2, **fx.CURSOR}
    tr = _imported_trainer(run["exports"][layout], tmp_path / "run")
    assert jax_import_check.exact_mismatches(tr, export) == []
    got = ckpt_io.train_state(tr)
    jstate = _np_tree(run["state"])
    adam, multi = _adam(jstate.opt_state)
    want = {"params": _sd(jstate.params), "ema": _sd(jstate.ema_params),
            "mu": _sd(adam.mu), "nu": _sd(adam.nu),
            "acc": _sd(multi.acc_grads)}
    for name, tensors in (("params", got["params"]), ("ema", got["ema"]),
                          ("mu", got["adam"]["mu"]),
                          ("nu", got["adam"]["nu"]),
                          ("acc", got["adam"]["acc"])):
        assert set(tensors) == set(want[name]), name
        for k, v in tensors.items():
            assert np.array_equal(v.float().numpy(), want[name][k]), (name, k)
    assert all(v.dtype == torch.bfloat16 for v in got["adam"]["mu"].values())
    assert got["step"] == got["ema_updates"] == 2
    assert got["adam"]["count"] == int(adam.count) == 0
    assert got["adam"]["mini_step"] == int(multi.mini_step) == 2
    assert all(np.abs(a).max() > 0 for a in want["acc"].values())
    # the JAX layout -> port layout of one kernel, checked by hand
    leaf = jstate.params["params"]["model"]["diffusion_model"][
        "out__2"]["kernel"]
    np.testing.assert_array_equal(
        got["params"]["model.diffusion_model.out.2.weight"].numpy(),
        to_torch_layout(leaf, "kernel"))


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_third_step_equals_jax(run, layout, tmp_path, monkeypatch):
    """The third call applies the update of the three accumulated
    gradients: weights, moments, EMA, accumulator and counts against the
    JAX step."""
    tr = _imported_trainer(run["exports"][layout], tmp_path / "run")
    _feed(monkeypatch, run["draws"])
    logs = tr.train_step(fx.batch(2))
    after, jlogs = run["after"]()
    for k, v in jlogs.items():
        assert abs(float(logs[k]) - v) <= LOSS_ATOL, (k, float(logs[k]), v)
    before, after = _np_tree(run["state"]), _np_tree(after)
    adam0, _ = _adam(before.opt_state)
    adam1, multi1 = _adam(after.opt_state)
    got = ckpt_io.train_state(tr)
    nu0, nu1 = _sd(adam0.nu), _sd(adam1.nu)
    g = {k: np.sqrt(np.maximum((nu1[k] - B2 * nu0[k]) / (1 - B2), 0))
         for k in nu1}
    floor = GRAD_FLOOR * max(v.max() for v in g.values())
    delta = {k: GRAD_RTOL * max(v.max(), floor) for k, v in g.items()}
    for k, want in _sd(adam1.mu).items():
        np.testing.assert_allclose(got["adam"]["mu"][k].float().numpy(),
                                   want, rtol=2.0 ** -7,
                                   atol=(1 - B1) * delta[k], err_msg=k)
    for k, want in nu1.items():
        tol = (1 - B2) * (2 * g[k].max() * delta[k] + delta[k] ** 2)
        np.testing.assert_allclose(got["adam"]["nu"][k].numpy(), want,
                                   rtol=1e-6, atol=tol, err_msg=k)
    for k, want in _sd(multi1.acc_grads).items():
        np.testing.assert_allclose(got["adam"]["acc"][k].numpy(), want,
                                   rtol=0, atol=delta[k], err_msg=k)
    weights = _sd(after.params)
    assert set(got["params"]) == set(weights)
    moved = 0
    for k, want in weights.items():
        err = np.abs(got["params"][k].numpy() - want).max()
        assert err <= 2 * fx.LR, (k, err)
        moved += not np.array_equal(want, _sd(before.params)[k])
    assert moved > 0
    n = int(after.ema_updates)
    d = min(0.9999, (1 + n) / (10 + n))
    for k, want in _sd(after.ema_params).items():
        err = np.abs(got["ema"][k].numpy() - want).max()
        assert err <= (1 - d) * 2 * fx.LR + 1e-7, (k, err)
    assert got["step"] == int(after.step) == 3
    assert got["ema_updates"] == n == 3
    assert got["adam"]["count"] == int(adam1.count) == 1
    assert got["adam"]["mini_step"] == int(multi1.mini_step) == 0


def test_best_tag_exports_without_a_cursor(run, tmp_path, capsys):
    r = run
    export = read_export(str(r["exports"]["best"]))
    assert export.meta == {"step": 2, "monitor": 0.5}
    done = import_run(str(r["exports"]["best"]), str(tmp_path / "run"))
    assert "no loader cursor" in capsys.readouterr().out
    assert done["meta"] == {}
    last = ckpt_io.read_last_meta(str(tmp_path / "run" / "checkpoints"))
    assert last["step"] == 2 and "batch_in_epoch" not in last
    current = to_port(read_export(str(r["exports"]["current"])))
    state = ckpt_io.restore_raw(done["path"])
    for k, v in current["params"].items():
        assert np.array_equal(state["params"][k].numpy(), v), k


def test_params_only_export_gives_the_jax_unet_output(run, tmp_path):
    """``save_params`` -> export -> ``params.pt`` -> ``restore_params``:
    one UNet call equals the JAX model's."""
    r = run
    params = _np_tree(r["state"].params)
    jax_ckpt.save_params(str(tmp_path / "params"), params)
    exporter.export(str(tmp_path / "params"), str(tmp_path / "export"))
    export = read_export(str(tmp_path / "export"))
    assert export.kind == "params" and export.meta is None
    done = import_run(str(tmp_path / "export"), str(tmp_path / "run"))
    assert done["kind"] == "params"
    model = instantiate_from_config(fx.model_config(), device="cpu")
    ckpt_io.restore_params(str(tmp_path / "run"), model)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    t = np.asarray([17])
    tokens = rng.integers(0, fx.VOCAB, (1, fx.CTX_LEN))
    jmodel = r["jmodel"]

    @jax.jit
    def unet(p, x, t, tokens):
        ctx = jmodel.module.apply(p, tokens, method="encode_cond")
        return jmodel.apply_model(p, x, t, ctx, 0)

    want = np.asarray(unet(params, x, t, tokens.astype(np.int32)))
    with torch.no_grad():
        ctx = model.get_learned_conditioning(tokens)
        got = model.apply_model(torch.from_numpy(x), torch.from_numpy(t),
                                ctx, 0).numpy()
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)


def test_msvqgan_state_carries_across(tmp_path):
    """A ``VQGANTrainState`` saved as ``scripts/train_msvqgan.py`` saves
    it: the generator's params file gives the JAX generator's
    reconstruction; the whole state loads into a ``VQGANTrainer``."""
    from tests.test_torch_vqgan_training import LOSS, TINY_FIRST, _disc_vars
    from frido_tpu.losses import vqperceptual as jax_vqp

    mod = msvqgan_from_config(TINY_FIRST["params"], name=None)
    jloss = jax_vqp.VQLPIPSWithDiscriminator(**LOSS)
    tx = optax.adam(1e-4, b1=0.5, b2=0.9)
    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3))).astype(np.float32)
    rng = np.random.default_rng(4)
    pg = _random_params(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x),
                        rng)
    vd = _disc_vars(jax.eval_shape(
        lambda r: jloss.init_params(r, x.shape), jax.random.PRNGKey(1)), rng)

    def seeded_adam(params):
        """Adam at count 7 with seeded moments, built in numpy."""
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(7, a.dtype) if a.ndim == 0 else
                       np.abs(rng.standard_normal(a.shape)).astype(a.dtype)),
            jax.eval_shape(tx.init, params))

    state = VQGANTrainState(params_g=pg, vars_d=vd, opt_g=seeded_adam(pg),
                            opt_d=seeded_adam({"params": vd["params"]}),
                            step=np.asarray(7, np.int32))
    jax_ckpt.save_train_state(str(tmp_path / "run" / "checkpoints"), 7,
                              state)
    (tmp_path / "run" / "config.yaml").write_text("model: {}\n")
    exporter.export(str(tmp_path / "run"), str(tmp_path / "export"))
    assert read_export(str(tmp_path / "export")).kind == "vqgan_state"
    done = import_run(str(tmp_path / "export"), str(tmp_path / "port"))
    assert done["kind"] == "vqgan_state" and done["step"] == 7
    assert (tmp_path / "port" / "config.yaml").exists()
    model = MSFPNVQModel(**TINY_FIRST["params"], device="cpu", seed=None)
    ckpt_io.restore_params(str(tmp_path / "port" / "generator"), model)
    loss = VQLPIPSWithDiscriminator(**LOSS, device="cpu")
    ckpt_io.restore_params(str(tmp_path / "port" / "discriminator"), loss)
    want = np.asarray(jax.jit(lambda p, x: mod.apply(p, x)[0])(
        state.params_g, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    opts = [optim.AdamW(list(m.parameters()), 1e-4, b1=0.5, b2=0.9,
                        weight_decay=0.0) for m in (model, loss)]
    tr = VQGANTrainer(model, loss, *opts)
    tr.load_state(ckpt_io.restore_raw(done["path"]))
    assert tr.step == 7 and tr.opt_g.count == tr.opt_d.count == 7
    got = tr.state()
    for name, opt, module in (("opt_g", state.opt_g, state.params_g),
                              ("opt_d", state.opt_d, state.vars_d)):
        mu, nu = _sd(opt[0].mu), _sd(opt[0].nu)
        names = {n for n, _ in (model if name == "opt_g" else loss)
                 .named_parameters()}
        assert set(got[name]["mu"]) == set(mu) == names
        for k in mu:
            assert np.array_equal(got[name]["mu"][k].numpy(), mu[k]), k
            assert np.array_equal(got[name]["nu"][k].numpy(), nu[k]), k
    for k, v in _sd(state.vars_d).items():
        assert np.array_equal(got["loss"][k].numpy(), v), k


def test_cli_resumes_an_imported_run(workspace, tmp_path, capsys):  # noqa: F811
    """A JAX train state at step 5 saved mid-epoch (epoch 1, batch 1) of
    ``tests/test_torch_train_cli.py``'s toy run, exported and imported:
    ``cli/main.py -r`` restores it, takes step 6 on the next batch of that
    epoch and moves the cursor on by one; the scale factors come along."""
    root, _, cfg = workspace
    jmodel = jax_instantiate(cfg["model"])
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r, context_len=8),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, _random_params(shapes, np.random.default_rng(1)))
    state, _ = jax_trainer.create_train_state(
        jmodel, params, jax_optim.build_optimizer(1e-4, None))
    state = state.replace(
        opt_state=jax.tree_util.tree_map(
            lambda a: jnp.asarray(5, a.dtype) if a.ndim == 0 else a,
            state.opt_state),
        ema_updates=jnp.asarray(5, jnp.int32),
        step=jnp.asarray(5, jnp.int32))
    run = tmp_path / "jax_run"
    (run / "configs").mkdir(parents=True)
    (run / "configs" / "tiny-project.yaml").write_text(yaml.safe_dump(cfg))
    jax_ckpt.save_train_state(str(run / "checkpoints"), 5, state,
                              meta={"epoch": 1, "batch_in_epoch": 1})
    (run / "checkpoints" / "scale_factors.json").write_text("[0.75, 1.25]")
    exporter.export(str(run), str(tmp_path / "export"))
    port_run = tmp_path / "port_run"
    done = import_run(str(tmp_path / "export"), str(port_run))
    assert done["meta"] == {"epoch": 1, "batch_in_epoch": 1}
    summary = cli.main(["-r", str(port_run), "-t", "--max_steps", "6",
                        "--no_test", "True", *COMMON])
    out = capsys.readouterr().out
    assert "Restored training state at step 5 (epoch 1, batch 1)" in out
    assert "step 6 loss" in out and "step 5 loss" not in out
    assert summary["steps"] == 1
    last = ckpt_io.read_last_meta(str(port_run / "checkpoints"))
    assert (last["step"], last["epoch"], last["batch_in_epoch"]) == (6, 1, 2)
    state = ckpt_io.restore_raw(str(port_run / "checkpoints" / "step_6"))
    assert state["step"] == state["ema_updates"] == 6
    assert state["adam"]["count"] == 6
    sf = json.loads((port_run / "checkpoints" / "scale_factors.json")
                    .read_text())
    assert sf == [0.75, 1.25]
