"""Sharded training in the port (``parallel/mesh.py``, ``tp.py``,
``fsdp.py``, ``tools/dryrun_multichip.py``, the training CLI's
``--fsdp``), on the CPU with gloo ranks.

- The leaf rules: for every parameter of the toy t2i model of
  ``tests/test_torch_models.py``, the port's tensor-parallel and FSDP
  specs (``tp.param_specs`` + ``fsdp.leaf_spec``, on the torch layouts the
  layers declare) shard the torch dims that the JAX package's
  ``tp._leaf_spec`` and ``fsdp._leaf_spec`` shard, carried to the torch
  layout by ``io/jax_weights.to_torch_layout``'s transposes, for n_model
  and n_data in {1, 2, 4} and min_size in {1, 2**15}.
- One spawn of 4 gloo ranks runs the dry run's four checks
  (``dryrun_multichip.run``) at the JAX dry run's tolerances (1e-4 FSDP
  against replicated, 1e-6 resumed against uninterrupted, 1e-4 sharded
  sampling against one process, distinct per-rank seeds) on a 2 x 2 data
  x model layout, then again on the toy with 64 model channels (``WIDE``),
  whose train states after the DP x TP and FSDP x TP steps (gathered by
  ``io/checkpoint.train_state``) are held to one process's step on the
  whole batch with the tolerances of
  ``tests/test_torch_train_cli.py::test_two_gloo_ranks_equal_one_process``:
  every Adam moment within 1e-5 of its leaf's largest (that floored at
  1e-3 of the largest over all leaves), every weight and EMA element
  within 1e-5 of the largest weight, the loss within 1e-6 relative. The
  toy of the JAX dry run has 32 channels, one a GroupNorm group, so the
  conv biases in front of a GroupNorm have no gradient but rounding (6e-8
  of the largest): the 64-channel toy has two a group and no such leaf.
  An Adam step moves an element by lr g / (|g| + eps): where |g| is near
  eps (1e-8) the gradient's rounding decides its step, so the weights
  and the EMA are held where the one-process gradient is at least
  ``STEP_FLOOR`` (100 eps: a relative gradient error d moves the step by
  at most lr d / 100 there) and through their moments elsewhere.
- The training CLI under ``torch.distributed.run`` on 2 gloo ranks: 3
  steps with ``--fsdp`` against 3 steps without it, the same
  tolerances, each logging its train and val images at step 3; ``--fsdp``
  holds less train state a rank; the ``--fsdp``
  run's ``last`` resumed without ``--fsdp`` (one process) and the
  replicated run's resumed with ``--fsdp`` (2 ranks) both restore step 3
  and agree at step 4 within the same tolerances.
"""

import datetime
import json
import os
import shutil
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.parallel import fsdp as jax_fsdp
from frido_tpu.parallel import tp as jax_tp
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_weights import (leaf_name, to_torch_layout,
                                            torch_key)
from frido_tpu_torch.parallel import dist, fsdp, tp
from frido_tpu_torch.tools import dryrun_multichip as dryrun
from tests.test_torch_models import CONFIG, CTX_LEN
from tests.test_torch_train_cli import (COMMON, DP_RTOL, MU_FLOOR, _run_dir,
                                        _state, run_cli, workspace)

torch.set_num_threads(2)

WORLD = 4
TIMEOUT_S = 240
STEP_FLOOR = 100 * 1e-8     # |g| where AdamW's step is set by the gradient
B1 = 0.9
WIDE = dryrun.config(False)
WIDE["params"]["unet_config"]["params"]["model_channels"] = 64
LAUNCH = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node")
assert workspace  # the training CLI's toy workspace, a module fixture


@pytest.fixture(scope="module")
def leaves():
    """(JAX path string, JAX shape, torch key, perm) of every JAX param
    leaf of the toy t2i model; ``perm[i]`` is the JAX axis of torch dim
    ``i``, from ``to_torch_layout``'s transpose."""
    jmodel = jax_instantiate(CONFIG)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))["params"]
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            p = path + (k,)
            sizes = (2, 3, 5, 7, 11)[:len(v.shape)]
            moved = to_torch_layout(np.empty(sizes), leaf_name(p)).shape
            perm = tuple(sizes.index(m) for m in moved)
            out.append(("/".join(("params",) + p), tuple(v.shape),
                        torch_key(p), perm))

    walk(shapes, ())
    return out


@pytest.fixture(scope="module")
def port_specs():
    model = instantiate_from_config(CONFIG, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return model, shapes


def _axis(spec, name):
    entries = tuple(spec)
    return entries.index(name) if name in entries else None


@pytest.mark.parametrize("min_size", [1, 2 ** 15])
@pytest.mark.parametrize("n_data", [1, 2, 4])
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_leaf_specs_match_jax(leaves, port_specs, n_model, n_data,
                              min_size):
    model, shapes = port_specs
    specs = tp.param_specs(model, n_model)
    assert {key for _, _, key, _ in leaves} == set(specs)
    sharded = 0
    for path, jshape, key, perm in leaves:
        jt = _axis(jax_tp._leaf_spec(path, jshape, n_model), "model")
        jf = jax_fsdp._leaf_spec(path, jshape, n_data, n_model, min_size)
        want = (None if jt is None else perm.index(jt),
                None if _axis(jf, "data") is None
                else perm.index(_axis(jf, "data")))
        assert _axis(jf, "model") == jt, path
        model_dim, axes, emb = specs[key]
        got = fsdp.leaf_spec(shapes[key], axes, emb, n_data, n_model,
                             min_size)
        assert got == want and model_dim == want[0], (path, got, want)
        sharded += want != (None, None)
    assert sharded or (n_model == 1 and n_data == 1)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_worker(rank, port, out):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world = dist.World(rank, WORLD, rank, "gloo")
    try:
        res = dryrun.run(world, torch.device("cpu"), log=lambda *a: None)
        wide = dryrun.run(world, torch.device("cpu"), log=lambda *a: None,
                          cfg=WIDE)
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        torch.save({"toy": res, "wide": wide},
                   os.path.join(out, "result.pt"))


def _close(name, got, want, steps=None):
    """``test_two_gloo_ranks_equal_one_process``'s rule on two train
    states: weights and EMA within DP_RTOL of the largest weight (with
    ``steps``, only where ``want``'s first moment marks a gradient of at
    least STEP_FLOOR); each moment within DP_RTOL of its leaf's largest,
    floored at MU_FLOOR of the largest over its leaves."""
    top = max(v.abs().max().item() for v in want["params"].values()
              if v.is_floating_point() and v.numel())
    mu = want["adam"]["mu"]
    for part in ("params", "ema"):
        assert set(got[part]) == set(want[part]), (name, part)
        prefix = "model." if part == "ema" else ""
        for k, v in want[part].items():
            if not v.is_floating_point():
                continue
            d = (got[part][k] - v).abs()
            if steps and prefix + k in mu:
                d = d[(mu[prefix + k] / (1 - B1)).abs() >= STEP_FLOOR]
            err = d.max().item() if d.numel() else 0.0
            assert err <= DP_RTOL * top, (name, part, k, err)
    for m in ("mu", "nu"):
        ref = want["adam"][m]
        floor = MU_FLOOR * max(v.abs().max().item() for v in ref.values())
        for k, v in ref.items():
            err = (got["adam"][m][k] - v).abs().max().item()
            assert err <= DP_RTOL * max(v.abs().max().item(), floor), (
                name, m, k, err)
    assert got["ema_updates"] == want["ema_updates"]
    assert got["adam"]["count"] == want["adam"]["count"]


def test_four_gloo_ranks_pass_the_dry_run(tmp_path):
    ctx = mp.start_processes(_dryrun_worker, (_free_port(), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = torch.load(tmp_path / "result.pt", weights_only=False)
    for res in results.values():
        assert (res["n_data"], res["n_model"]) == (2, 2)
        assert abs(res["loss_fsdp"] - res["loss"]) < dryrun.FSDP_ATOL
        assert abs(res["loss_res"] - res["loss_cont"]) < dryrun.RESUME_ATOL
        assert res["sample_err"] <= dryrun.SAMPLE_ATOL
        assert len(set(res["seeds"])) == WORLD

    # one process on the whole global batch, from the same weights
    res = results["wide"]
    model = dryrun.build(WIDE, torch.device("cpu"))
    tr = dryrun.make_trainer(model, dist.World(0, 1, 0, None), 1, False)
    batch = dryrun.make_batch(2 * res["n_data"], 0, dryrun.shapes(model))
    loss = dryrun.step(tr, batch, 0)
    want = ckpt_io.train_state(tr)
    assert all(v.abs().max() > 0 for v in want["adam"]["mu"].values())
    assert abs(res["loss"] - loss) <= 1e-6 * abs(loss)
    _close("DP x TP", res["dp_tp_state"], want, steps=True)
    _close("FSDP x TP", res["fsdp_tp_state"], want, steps=True)


def _cli_state_gib(out):
    line = [ln for ln in out.splitlines() if ln.startswith("train summary")]
    return json.loads(line[0].split(": ", 1)[1])["state_gib_per_rank"]


def test_fsdp_cli_equals_data_parallel_and_resumes_across(workspace):
    """2 gloo ranks, 3 steps with and without ``--fsdp`` (random-1d crops
    and flips, validation at 3), then each run's ``last`` resumed for a
    fourth step the other way."""
    root, cfg_path, _ = workspace
    q = "data.params.train.params."
    base = ["-b", str(cfg_path), "-t", "--val_every_steps", "3",
            "--val_batches", "1", "--no_test", "True",
            q + "crop_method=random-1d", q + "random_flip=true", *COMMON,
            "--img_log_every_steps", "3"]
    runs, gib = {}, {}
    for fsdp_flag in (True, False):
        logdir = root / f"fsdp_{fsdp_flag}"
        r = run_cli([*base, "-l", str(logdir), "--max_steps", "3",
                     "--fsdp", str(fsdp_flag)], root,
                    launcher=(*LAUNCH, "2"))
        assert "step 3 loss" in r.stdout
        runs[fsdp_flag] = _run_dir(logdir)
        gib[fsdp_flag] = _cli_state_gib(r.stdout)
        # rank 0 logged the train and val images at step 3 (every rank
        # gathers the EMA weights for it under --fsdp)
        for split in ("train", "val"):
            assert len(os.listdir(os.path.join(runs[fsdp_flag], "images",
                                               split))) == 3, split
    assert gib[True] < gib[False]
    _close("--fsdp at step 3", _state(runs[True], 3), _state(runs[False], 3))

    resumed = {}
    for fsdp_flag, launcher in ((True, ()), (False, (*LAUNCH, "2"))):
        # the --fsdp run's last without --fsdp (one process), and the
        # replicated run's with --fsdp (2 ranks)
        logdir = root / f"resume_from_fsdp_{fsdp_flag}"
        src = runs[fsdp_flag]
        shutil.copytree(src, logdir / os.path.basename(src))
        r = run_cli([*base, "-l", str(logdir), "--max_steps", "4",
                     "--auto_resume", "True", "--fsdp",
                     str(not fsdp_flag)], root, launcher=launcher)
        assert "Restored training state at step 3" in r.stdout
        resumed[fsdp_flag] = _state(_run_dir(logdir), 4)
    _close("resumed across --fsdp", resumed[True], resumed[False])
