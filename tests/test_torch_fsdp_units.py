"""The port's per-unit FSDP (``parallel/fsdp.py``) on 4 gloo ranks.

One spawn of 4 gloo processes trains the dry run's toy
(``tools/dryrun_multichip.TOY``) and its 64-channel variant (``WIDE`` of
``tests/test_torch_sharding.py``) with ``fsdp=True`` and ``min_size`` 1 on
a 4 x 1 and a 2 x 2 data x model layout, in fp32, in bf16, with ``remat``
and with ``accumulate_grad_batches=2`` (two calls), from the dry run's
seeded weights on a global batch of 8; the main process takes the same
steps on one process (no FSDP) meanwhile. Checked:

(a) every run's losses equal one process's within the dry run's
    ``FSDP_ATOL``. On the 64-channel model every train state (weights,
    EMA, both Adam moments, counts) equals one process's within
    ``tests/test_torch_sharding.py::_close``; in bf16 one process rounds
    the activations of 8 rows where a rank rounds those of its own (the
    CPU's convs block by batch), which flips the first Adam step (+-lr)
    of small gradients, so there the state is held at ``_close``'s
    tolerances to the data-parallel step (``fsdp=False``, replicated
    state) on the same ranks. On the toy (whose conv biases in front of a
    one-channel GroupNorm group have rounding for a gradient, which no
    relative bound to one process holds) every mode's train state equals
    that data-parallel step on the same ranks within a few float32 ulps
    (``NEAR_RTOL`` = 1e-6; they differ only in the order of the ranks'
    sums: about 3e-7 is seen). And the 4 x 1 fp32 step from the JAX
    package's weights equals the JAX package's own step under
    ``frido_tpu.parallel.fsdp.shard_state`` (``min_size`` 1) on a
    4-device CPU mesh, run in a subprocess (the draws fed to the port),
    within ``tests/test_torch_training.py``'s tolerances: the loss within
    3e-4, each first moment (so each gradient) within 1e-3 of its leaf's
    largest JAX value (floored at 1e-3 of the largest over all leaves)
    plus 3 times the FSDP step's own move from weights perturbed by 1e-6
    relative, each weight within 2 lr, the EMA within (1 - d) 2 lr. The
    perturbation term is there for the kinks of SPADE's ReLU MLPs: one
    hidden channel of ``input_blocks.0.0.in_layers.0.mlp_shared`` switches
    under any 1e-6 perturbation, which moves that layer's gradient by
    3.4% of its largest. The first moments of the two leaves of
    ``KINKS`` are left out: one pre-activation of their ReLU lies within
    rounding of zero, and one process and 4 data ranks, FSDP or not,
    round it to either side, which moves their gradients by 0.76% of
    their largest, the gap to JAX; the comparisons with one process and
    with the data-parallel step above still hold them;
(b) each rank's peak bytes of full parameters and of full gradients (the
    units' counters) stay at or below the rank's parameters at rest plus
    twice the largest unit's full bytes. The parent's design gathered
    every data-sharded leaf before the forward and held every full
    gradient until the backward ended: on the toy at 4 x 1 that is
    ``WHOLE_TOY_4X1`` = 27 431 360 bytes of full parameters a rank (the
    sum of the units' full bytes; as many of gradients, less the frozen
    first stage's), against a bound of 16 346 796 bytes (6 958 764 at
    rest plus twice the largest unit's 4 694 016; the units peaked at
    4 800 000 bytes of parameters and 9 388 032 of gradients): the test
    asserts the whole-model figure breaks the bound;
(c) the collectives, counted by wrapping ``torch.distributed``'s
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` in each
    rank, and the unit calls, counted by forward pre-hooks on the unit
    modules: each call of a trainable unit gathers once in the forward
    and once before its backward (and once more in ``remat``'s
    recompute, which calls the unit again) and reduce-scatters exactly
    once; a frozen unit's call (the first stage) gathers once. The
    PyUNet runs once a stage, so its units are called twice a step. The
    parent ran one gather and one reduce-scatter a data-sharded leaf;
(d) after the fp32 step on the toy, PLMS-4 sampling with decoding and
    ``log_images`` (DDIM 4) under ``EMA.scope`` on the sharded state,
    each data index on its rows, equal one process on the same rows
    within the dry run's ``SAMPLE_ATOL`` (1e-4).

On ``meta``, the t2i config's units at 4 data ranks: every block of
the trunk is one, and parts plus two units in flight stay under half of
the full parameters.
"""

import datetime
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_weights import load_jax_params
from frido_tpu_torch.parallel import dist, fsdp, mesh
from frido_tpu_torch.tools import dryrun_multichip as dryrun
from frido_tpu_torch.training import optim, trainer
from tests.test_torch_train_cli import workspace

assert workspace  # the training CLI's toy workspace, a module fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2I = os.path.join(REPO, "configs", "frido", "t2i", "frido_f16f8_coco.yaml")
WORLD = 4
TIMEOUT_S = 400
GLOBAL_BATCH = 8
LAYOUTS = {"4x1": 1, "2x2": 2}
WIDE = dryrun.config(False)
WIDE["params"]["unet_config"]["params"]["model_channels"] = 64
CONFIGS = {"toy": dryrun.config(False), "wide": WIDE}
MODES = {"fp32": {}, "bf16": {"compute_dtype": torch.bfloat16},
         "remat": {"remat": True}, "accum": {"accumulate": 2}}
WHOLE_TOY_4X1 = 27431360
JAX_SEED = 0
JAX_RNG = 7
LOSS_ATOL = 3e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-3
B1 = 0.9
PERTURB = 1e-6
PERTURB_SEED = 1
SENSITIVITY = 3.0
# FSDP against the replicated step on the same ranks: a few float32 ulps
NEAR_RTOL = 1e-6
MU_FLOOR = 1e-3
# SPADE's ReLU MLP at output_blocks.2.0 (stage 1): one pre-activation
# lies within rounding of zero, and one process and 4 data ranks, FSDP or
# not, round it to either side, which moves these leaves' gradients by
# 0.76% of their largest; left out of the JAX comparison by name
KINKS = tuple(f"model.diffusion_model.output_blocks.2.0.in_layers.0."
              f"mlp_shared.0.{w}" for w in ("weight", "bias"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _trainer(model, world, n_model, fsdp_on, mode):
    kw = dict(MODES[mode])
    opt = optim.build_optimizer(
        [p for _, p in trainer.trainable_parameters(model)], dryrun.LR,
        accumulate_grad_batches=kw.pop("accumulate", 1))
    return trainer.DiffusionTrainer(
        model, opt, use_ema=True, rank=world.rank,
        world_size=world.world_size, n_model=n_model, fsdp=fsdp_on,
        min_size=1, **kw)


def _batch(model, i):
    return dryrun.make_batch(GLOBAL_BATCH, i, dryrun.shapes(model))


def _steps(tr, mode, batches):
    """The mode's calls (two with accumulation); the losses."""
    calls = MODES[mode].get("accumulate", 1)
    return [dryrun.step(tr, batches[i], i) for i in range(calls)]


def _sample_inputs(model, dims):
    tokens = np.random.RandomState(4).randint(
        0, dims["vocab"], (4, dims["ctx"])).astype(np.int64)
    x_init = np.random.RandomState(5).standard_normal(
        (4, model.image_size, model.image_size, model.channels)).astype(
            np.float32)
    batch = dryrun.make_batch(4, 9, dims)
    # the toy's BERT takes ids as they are, under its cond key (captions)
    batch[model.cond_stage_key] = batch.pop("tokens")
    return tokens, x_init, batch


@torch.no_grad()
def _galleries(tr, rows, dims):
    """PLMS-4 + decode and ``log_images`` (DDIM 4) of ``rows`` of the
    sample inputs under the EMA (``dims``: ``dryrun.shapes``)."""
    model = tr.model
    tokens, x_init, batch = _sample_inputs(model, dims)
    with tr.weights(ema=True):
        model.eval()
        img = dryrun.sample_pipeline(model, torch.from_numpy(tokens[rows]),
                                     x_init[rows])
        logs = model.log_images(
            {k: v[rows] for k, v in batch.items()},
            generator=torch.Generator().manual_seed(5), n=2, ddim_steps=4,
            sample_flag=True)
        model.train()
    return img, {k: v for k, v in logs.items() if isinstance(v, np.ndarray)}


def _counting():
    """Wrap the two unit collectives; returns the live counts."""
    counts = {"gather": 0, "reduce_scatter": 0, "rs_numel": []}
    ag, rs = tdist.all_gather_into_tensor, tdist.reduce_scatter_tensor

    def all_gather_into_tensor(*a, **k):
        counts["gather"] += 1
        return ag(*a, **k)

    def reduce_scatter_tensor(out, inp, *a, **k):
        counts["reduce_scatter"] += 1
        counts["rs_numel"].append(inp.numel())
        return rs(out, inp, *a, **k)

    tdist.all_gather_into_tensor = all_gather_into_tensor
    tdist.reduce_scatter_tensor = reduce_scatter_tensor
    return counts


def _unit_calls(sharding):
    """Forward calls of each unit (and of them, recomputes in a
    backward), by pre-hooks on the unit modules."""
    calls = {}

    def hook(name):
        def count(module, args):
            c = calls.setdefault(name, [0, 0])
            c[torch._C._current_graph_task_id() != -1] += 1
        return count

    handles = [u.module.register_forward_pre_hook(hook(u.name))
               for u in sharding.units]
    return calls, handles


def _perturbed(tree, rng):
    """``tree`` with every leaf scaled by 1 + 1e-6 N(0, 1)."""
    return {k: _perturbed(v, rng) if isinstance(v, dict) else
            (v * (1 + PERTURB * rng.standard_normal(v.shape))).astype(
                np.float32) for k, v in tree.items()}


def _wait_for(path):
    """``path`` once another process has written it."""
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.5)
    return path


def _save(obj, path):
    torch.save(obj, str(path) + ".tmp")
    os.replace(str(path) + ".tmp", path)


def _close_misses(name, got, want):
    """``tests/test_torch_sharding.py::_close``'s first failure, if any."""
    from tests.test_torch_sharding import _close

    try:
        _close(name, got, want, steps=True)
    except AssertionError as e:
        return [e.args]
    return []


def _carried_step(world, jax_path, perturb=False):
    """The fp32 step from the JAX package's weights (perturbed by 1e-6
    relative with ``perturb``) and draws, on ``world``'s data ranks."""
    with open(_wait_for(jax_path), "rb") as f:
        jax_run = pickle.load(f)
    model = instantiate_from_config(dryrun.config(False), device="cpu")
    params = jax_run["np_params"]
    if perturb:
        params = _perturbed(params, np.random.default_rng(PERTURB_SEED))
    load_jax_params(model, params)
    tr = _trainer(model, world, 1, True, "fp32")
    t, noise = jax_run["draws"]
    real = trainer._draw

    def draws(generator, n, timesteps, shape, device):
        assert n == len(t) and tuple(shape) == noise.shape
        return (torch.from_numpy(t.astype(np.int64)),
                torch.from_numpy(noise.copy()))

    trainer._draw = draws
    try:
        batch = jax_run["batch"]
        logs = tr.train_step(mesh.shard_batch(batch, tr.layout))
    finally:
        trainer._draw = real
    return float(logs["loss"]), ckpt_io.train_state(tr)


def _worker(rank, port, out, jax_path):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world = dist.World(rank, WORLD, rank, "gloo")
    counts = _counting()
    res = {}
    try:
        for lname, n_model in LAYOUTS.items():
            for cname, cfg in CONFIGS.items():
                for mode in MODES:
                    model = dryrun.build(cfg, torch.device("cpu"))
                    dims = dryrun.shapes(model)
                    batches = [_batch(model, i) for i in range(2)]
                    tr = _trainer(model, world, n_model, True, mode)
                    sh = tr.sharding
                    calls, handles = _unit_calls(sh)
                    counts.update(gather=0, reduce_scatter=0, rs_numel=[])
                    losses = _steps(tr, mode, batches)
                    for h in handles:
                        h.remove()
                    r = {"losses": losses, "counters": tr.fsdp_counters(),
                         "gathers": counts["gather"],
                         "reduce_scatters": counts["reduce_scatter"],
                         "rs_numel": list(counts["rs_numel"]),
                         "calls": calls,
                         "trainable": {u.name: any(p.requires_grad
                                                   for p in u.params)
                                       for u in sh.units},
                         "part_numel": {u.name: u.part_numel
                                        for u in sh.units},
                         "n_sharded": len(sh.data_dims),
                         "rest_bytes": fsdp.resident_bytes(
                             tr.model.parameters()),
                         "max_unit": max(u.full_bytes for u in sh.units),
                         "whole": sum(u.full_bytes for u in sh.units)}
                    state = ckpt_io.train_state(tr)   # rank 0's, else None
                    if cname == "toy" or mode == "bf16":
                        dp = _trainer(dryrun.build(cfg, torch.device("cpu")),
                                      world, n_model, False, mode)
                        _steps(dp, mode, batches)
                        dp_state = ckpt_io.train_state(dp)
                    # rank 0 compares the states here: they stay off disk
                    if state is not None and cname == "toy":
                        r["misses"] = _near_misses(state, dp_state)
                    elif state is not None:
                        want = dp_state if mode == "bf16" else torch.load(
                            _wait_for(os.path.join(out, f"ref_{mode}.pt")),
                            weights_only=False)
                        r["misses"] = _close_misses(f"{lname} wide {mode}",
                                                    state, want)
                    if mode == "fp32" and cname == "toy":
                        rows = dist.rank_rows(4, tr.layout.data_index,
                                              tr.layout.n_data)
                        r["rows"] = rows
                        r["galleries"] = _galleries(tr, rows, dims)
                    sh.close()
                    res[(lname, cname, mode)] = r
        res["jax"] = _carried_step(world, jax_path)
        res["jax_perturbed"] = _carried_step(world, jax_path, True)
    finally:
        tdist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _jax_side(out_path):
    """The JAX package's step on the toy under FSDP (``min_size`` 1) on a
    4-device CPU mesh; writes the weights, the batch, the step's draws,
    its loss and its new state (as ``jax_train_state_to_port`` gives it).
    Run in a subprocess (``XLA_FLAGS`` sets the device count)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from frido_tpu.config import instantiate_from_config as jax_instantiate
    from frido_tpu.parallel import fsdp as jax_fsdp
    from frido_tpu.parallel import mesh as jax_mesh
    from frido_tpu.training import optim as jax_optim
    from frido_tpu.training import trainer as jax_trainer
    from frido_tpu_torch.io.jax_weights import jax_train_state_to_port
    from tests.test_torch_models import _random_params

    cfg = dryrun.config(False)
    jmodel = jax_instantiate(cfg)
    dims = {"side": cfg["params"]["first_stage_config"]["params"][
        "ddconfig"]["resolution"], "ctx": cfg["params"]["cond_stage_config"][
        "params"]["max_seq_len"], "vocab": cfg["params"]["cond_stage_config"][
        "params"]["vocab_size"]}
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=dims["ctx"]),
        jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(JAX_SEED))
    state, tx = jax_trainer.create_train_state(
        jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
        jax_optim.build_optimizer(dryrun.LR))
    m = jax_mesh.make_mesh(n_model=1)
    assert dict(m.shape) == {"data": WORLD, "model": 1}
    state = jax_fsdp.shard_state(m, state, min_size=1)
    batch = dryrun.make_batch(GLOBAL_BATCH, 0, dims)
    jbatch = dict(batch, tokens=batch["tokens"].astype(np.int32))
    rng = jax.random.PRNGKey(JAX_RNG)
    new, logs = jax.jit(jax_trainer.make_train_step(jmodel, tx))(
        state, jax_mesh.shard_batch(m, jbatch), rng)
    t_key, n_key = jax.random.split(jax.random.fold_in(rng, 0))
    t = jax.random.randint(t_key, (GLOBAL_BATCH,), 0, jmodel.timesteps)
    noise = jax.random.normal(n_key, (GLOBAL_BATCH, jmodel.image_size,
                                      jmodel.image_size, jmodel.channels))
    result = {"np_params": np_params, "batch": batch,
              "draws": (np.asarray(t), np.asarray(noise)),
              "loss": float(logs["loss"]),
              "state": jax_train_state_to_port(jax.device_get(new))}
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


def _start_jax(tmp_path):
    path = str(tmp_path / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_fsdp_units import _jax_side; "
            "_jax_side(sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, REPO, path],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path


def _reference(cname, mode, out_dir):
    """One process (no FSDP) on the whole global batch; the 64-channel
    model's train state goes to ``out_dir`` for the ranks."""
    model = dryrun.build(CONFIGS[cname], torch.device("cpu"))
    batches = [_batch(model, i) for i in range(2)]
    tr = _trainer(model, dist.World(0, 1, 0, None), 1, False, mode)
    losses = _steps(tr, mode, batches)
    out = {"losses": losses}
    if cname == "wide":
        _save(ckpt_io.train_state(tr), out_dir / f"ref_{mode}.pt")
    if mode == "fp32" and cname == "toy":
        out["tr"], out["dims"] = tr, dryrun.shapes(model)
    return out


def _check_counts(name, r, remat):
    """(c): the wrapped collectives against the unit calls."""
    fwd = sum(c[0] for c in r["calls"].values())
    recomputed = sum(c[1] for c in r["calls"].values())
    train_calls = sum(c[0] for u, c in r["calls"].items()
                      if r["trainable"][u])
    assert r["gathers"] == fwd + train_calls + recomputed, name
    assert r["reduce_scatters"] == train_calls, name
    assert recomputed == 0 or remat, name
    per_call = (r["gathers"]) / fwd
    assert per_call <= (3 if remat else 2), (name, per_call)
    for u, (n_fwd, n_re) in r["calls"].items():
        assert n_re <= n_fwd, (name, u)
    # one packed buffer a call: a reduce-scatter moves at most a unit
    n_data = WORLD // LAYOUTS[name[0]]
    unit = max(n for u, n in r["part_numel"].items() if r["trainable"][u])
    assert all(0 < n <= n_data * unit for n in r["rs_numel"]), name
    assert r["reduce_scatters"] < r["n_sharded"], name
    if name[2] != "accum":        # the counters are the last call's
        assert r["counters"]["gathers"] == r["gathers"], name
        assert (r["counters"]["reduce_scatters"]
                == r["reduce_scatters"]), name


def _check_carried(jax_run, port_loss, port_state, perturbed):
    """(a), the JAX side: ``tests/test_torch_training.py``'s rules for a
    step from zero moments (mu = (1 - b1) g), each first moment's bound
    widened by ``SENSITIVITY`` times the FSDP step's own move from
    weights perturbed by 1e-6 relative (``perturbed``'s state); the
    ``KINKS`` leaves' first moments left out."""
    want = jax_run["state"]
    assert abs(port_loss - jax_run["loss"]) <= LOSS_ATOL
    jmu = {k: np.asarray(v) for k, v in want["adam"]["mu"].items()}
    top = max(np.abs(v).max() for v in jmu.values())
    for k, v in jmu.items():
        if k in KINKS:
            continue
        mu = port_state["adam"]["mu"][k]
        noise = (perturbed["adam"]["mu"][k] - mu).abs().max().item()
        tol = GRAD_RTOL * max(np.abs(v).max(), GRAD_FLOOR * top)
        err = np.abs(mu.numpy() - v).max()
        assert err <= tol + SENSITIVITY * noise + 1e-9, (k, err, noise)
    lr = dryrun.LR
    for k, v in want["params"].items():
        err = np.abs(port_state["params"][k].numpy() - np.asarray(v)).max()
        assert err <= 2 * lr, (k, err)
    d = min(0.9999, 2 / 11)
    for k, v in want["ema"].items():
        err = np.abs(port_state["ema"][k].numpy() - np.asarray(v)).max()
        assert err <= (1 - d) * 2 * lr + 1e-7, (k, err)
    assert port_state["adam"]["count"] == want["adam"]["count"] == 1


def _near_misses(got, want):
    """Where two train states are more than a few ulps apart: weights and
    EMA beyond NEAR_RTOL of the largest weight; a moment beyond NEAR_RTOL
    of its leaf's largest, floored at MU_FLOOR of the largest over its
    leaves; the counts unequal. A list of (part, leaf, error)."""
    misses = [(part, None, None) for part in ("params", "ema")
              if set(got[part]) != set(want[part])]
    top = max(v.abs().max().item() for v in want["params"].values()
              if v.is_floating_point() and v.numel())
    for part in ("params", "ema"):
        for k, v in want[part].items():
            if v.is_floating_point() and k in got[part]:
                err = (got[part][k] - v).abs().max().item()
                if err > NEAR_RTOL * top:
                    misses.append((part, k, err))
    for m in ("mu", "nu"):
        ref = want["adam"][m]
        floor = MU_FLOOR * max(v.abs().max().item() for v in ref.values())
        for k, v in ref.items():
            err = (got["adam"][m][k] - v).abs().max().item()
            if err > NEAR_RTOL * max(v.abs().max().item(), floor):
                misses.append((m, k, err))
    for k in ("ema_updates", "step"):
        if got[k] != want[k]:
            misses.append((k, got[k], want[k]))
    if got["adam"]["count"] != want["adam"]["count"]:
        misses.append(("count", got["adam"]["count"], want["adam"]["count"]))
    return misses


def test_fsdp_units_on_four_gloo_ranks(tmp_path):
    torch.set_num_threads(2)
    proc, jax_path = _start_jax(tmp_path)
    ctx = mp.start_processes(_worker, (_free_port(), str(tmp_path),
                                       jax_path),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        refs = {(c, m): _reference(c, m, tmp_path) for c in CONFIGS
                for m in MODES}
        jax_out, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, jax_out[-3000:]
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        if proc.poll() is None:
            proc.kill()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    for f in tmp_path.glob("ref_*.pt"):
        f.unlink()

    for key, r0 in ranks[0].items():
        if key in ("jax", "jax_perturbed"):
            continue
        lname, cname, mode = key
        ref = refs[(cname, mode)]
        name = f"{lname} {cname} {mode}"
        # (a) one process on the whole batch
        np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=0,
                                   atol=dryrun.FSDP_ATOL, err_msg=name)
        # the train state: see (a)
        assert not r0["misses"], (name, r0["misses"][:5])
        for rank, res in enumerate(ranks):
            r = res[key]
            # (b) the peak full bytes
            bound = r["rest_bytes"] + 2 * r["max_unit"]
            c = r["counters"]
            assert 0 < c["peak_full_param_bytes"] <= bound, (name, rank)
            assert 0 < c["peak_full_grad_bytes"] <= bound, (name, rank)
            assert c["full_param_bytes"] == 0, (name, rank)
            assert c["full_grad_bytes"] == 0, (name, rank)
            # (c) the collectives
            _check_counts(key, r, mode == "remat")
        if key == ("4x1", "toy", "fp32"):
            assert r0["whole"] == WHOLE_TOY_4X1 > bound
        # (d) sampling and the image log under the EMA
        if "galleries" in r0:
            for res in ranks:
                img, logs = res[key]["galleries"]
                rows = res[key]["rows"]
                want_img, want_logs = _galleries(ref["tr"], rows,
                                                 ref["dims"])
                assert (img - want_img).abs().max() <= dryrun.SAMPLE_ATOL
                assert set(logs) == set(want_logs)
                for k, v in want_logs.items():
                    err = np.abs(logs[k].astype(np.float64)
                                 - v.astype(np.float64)).max()
                    assert err <= dryrun.SAMPLE_ATOL, (name, k, err)

    with open(jax_path, "rb") as f:
        jax_run = pickle.load(f)
    loss, state = ranks[0]["jax"]
    _check_carried(jax_run, loss, state, ranks[0]["jax_perturbed"][1])


def test_units_of_the_t2i_config():
    """The units of the t2i config at 4 data ranks (the default
    ``min_size``), built on ``meta``: the UNet itself and each block of
    its trunk are units, every other unit lies in the BERT or the first
    stage, each data-sharded leaf is in exactly one, and a rank's
    parameters at rest plus two of the largest unit in flight stay under
    half of the full parameters a whole-model gather held."""
    cfg = load_yaml(T2I)["model"]
    cfg["params"]["first_stage_config"]["params"].pop("ckpt_path", None)
    model = instantiate_from_config(cfg, device="meta")
    dims = fsdp.data_dims_for(model, WORLD)
    plan = fsdp.unit_plan(model, dims)
    unet, pre = model.model.diffusion_model, "model.diffusion_model"
    trunk = ({f"{pre}.input_blocks.{i}" for i in range(len(
        unet.input_blocks))} | {f"{pre}.middle_block"} | {
        f"{pre}.output_blocks.{i}" for i in range(len(unet.output_blocks))})
    assert trunk | {pre} <= set(plan)
    assert all(u in trunk | {pre} or u.startswith(
        ("cond_stage_model.", "first_stage_model.")) for u in plan), plan
    leaves = [p for ents in plan.values() for _, _, p, _ in ents]
    assert len(leaves) == len({id(p) for p in leaves}) == len(dims)
    params = dict(model.named_parameters())
    whole = fsdp.resident_bytes(params.values())
    rest = sum(p.numel() * p.element_size() // (WORLD if n in dims else 1)
               for n, p in params.items())
    largest = max(fsdp.resident_bytes(p for _, _, p, _ in ents)
                  for ents in plan.values())
    assert rest + 2 * largest < whole / 2


def test_a_leaf_without_a_gradient_gets_a_zero_one():
    """``Sharding.finish_grads_`` gives every optimizer leaf the step did
    not reach a zero gradient of its part's shape, data-sharded or
    replicated, as the JAX step's zero gradient: AdamW still decays it."""
    model = dryrun.build(CONFIGS["toy"], torch.device("cpu"))
    sh = fsdp.shard_model_(model, mesh.make_layout(1, 0, 1), fsdp=True,
                           min_size=1)
    named = dict(trainer.trainable_parameters(model))
    assert set(named) & set(sh.data_dims) and set(named) - set(sh.data_dims)
    for p in named.values():
        p.grad = None
    sh.finish_grads_(named.values())
    for name, p in named.items():
        assert p.grad is not None and p.grad.shape == p.shape, name
        assert not p.grad.any(), name
    sh.close()


def test_fsdp_cli_runs_the_image_log_and_the_test_pass(workspace):
    """The training CLI with ``--fsdp`` on 2 gloo ranks: one step, the
    validation and the image log at step 1 (every rank computes the log
    through the units, rank 0 writes it) and the test pass (DDIM 4) over
    the 8-image split, every rank on its rows; every sample is written
    once and the summary gives each rank's peak full bytes."""
    from tests.test_torch_train_cli import COMMON, _run_dir, run_cli

    root, cfg_path, _ = workspace
    logdir = root / "fsdp_test_pass"
    r = run_cli(["-b", str(cfg_path), "-t", "-l", str(logdir), "--max_steps",
                 "1", "--fsdp", "True", "--val_every_steps", "1",
                 "--val_batches", "1", "--test_steps", "4", *COMMON,
                 "--img_log_every_steps", "1"], root,
                launcher=("-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2"))
    run = _run_dir(logdir)
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("train summary")]
    summary = __import__("json").loads(line[0].split(": ", 1)[1])
    assert summary["fsdp"] and summary["world_size"] == 2
    assert 0 < summary["peak_full_param_gib"]
    assert 0 < summary["peak_full_grad_gib"]
    for split in ("train", "val"):
        assert len(os.listdir(os.path.join(run, "images", split))) == 3
    samples = sorted(os.listdir(os.path.join(run, "test", "sample")))
    assert samples == [f"{i:012d}.png" for i in range(8)]
    assert r.stdout.count("test pass: ") == 2   # one line a rank
