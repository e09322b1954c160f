"""The port's MS-VQGAN training CLI (``python -m
frido_tpu_torch.cli.train_msvqgan``) against the JAX package's step, on
the CPU.

``configs/msvqgan/msvqgan_f16f8_coco.yaml`` shrunk by dot-list overrides
to the toy MS-VQGAN of ``tests/test_training.py`` (32^2, codebooks of
32), no LPIPS, its loss otherwise the config's (``disc_start`` 30001: at
the first step the discriminator's loss is off, as in the config's own
first step; ``tests/test_torch_vqgan_training.py`` holds a step after
``disc_start`` to the JAX package), its ``data:`` section pointed at a
mini-COCO-2014 tree
(``tools/make_mini_coco.write_tree``) at 32^2 and batches of 2. The CLI's
model and discriminator are given seeded numpy weights carried by
``io/jax_weights.py`` before its first step; that step, on the CLI's own
first batch, is held to ONE jitted JAX ``make_vqgan_train_step`` built as
``scripts/train_msvqgan.py`` builds it (``optax.adam(lr, 0.5, 0.9)`` for
both phases, no auxiliary loss) from the same weights:

- the logged ``aeloss`` and ``disc`` within 3e-4 (the GAN tests'
  tolerance of losses);
- the generator's Adam first moments in the step's checkpoint (half the
  step's gradients) per leaf within 1e-3 of the leaf's largest JAX
  magnitude, floored at 1e-3 of the largest over the leaves
  (``tests/test_torch_vqgan_training.py``'s gradient tolerance); the
  discriminator's 0 on both sides;
- every generator and discriminator weight within 2 lr of JAX's (an
  Adam step moves each by about lr whatever its gradient, so a gradient
  near 0 may move the two the opposite ways) plus 4 float32 ulps of the
  leaf's largest weight (the rounding of w +- lr), the BatchNorm running
  statistics within 3e-4 (that test's tolerances).

The run writes ``config.yaml`` and its checkpoints (every step, and the
last), and the last loads back into a fresh ``VQGANTrainer`` equal to the
one in memory, Adam moments included.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.models.msvqgan import msvqgan_from_config
from frido_tpu.training.vqgan_trainer import (VQGANTrainState,
                                              make_vqgan_train_step)
from frido_tpu_torch.cli import train_msvqgan as cli
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.tools.make_mini_coco import write_tree
from frido_tpu_torch.training import optim
from frido_tpu_torch.training.vqgan_trainer import VQGANTrainer
from tests.test_torch_models import _random_params
from tests.test_torch_vqgan_training import _disc_vars
from tests.test_training import TINY_DD, TINY_ED

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "msvqgan", "msvqgan_f16f8_coco.yaml")
ATOL = 3e-4
ULPS = 4 * float(np.finfo(np.float32).eps)
GRAD_RTOL = 1e-3


def _sd(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(tree).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI (``build`` then ``fit``, as ``main`` runs them) for 3 steps
    with a checkpoint every step, its weights set before the first; the
    JAX step from the same weights on the CLI's first batch."""
    root = tmp_path_factory.mktemp("msvq")
    tree = write_tree(str(root / "coco2014"), n=6, seed=3)
    dots = [f"model.params.edconfig={json.dumps(TINY_ED)}",
            f"model.params.ddconfig={json.dumps(TINY_DD)}",
            "model.params.n_embed=[32,32]",
            "model.params.lossconfig.params.perceptual_weight=0.0",
            "data.params.batch_size=2", "data.params.num_workers=2"]
    for split in ("train", "validation", "test"):
        q = f"data.params.{split}.params."
        dots += [q + f"data_path={tree}", q + "target_image_size=32"]
    argv = ["-b", CONFIG, "-l", str(root / "logs"), "--device", "cpu",
            "--max_steps", "3", "--log_every_steps", "1",
            "--ckpt_every_steps", "1", *dots]
    args, unknown = cli.get_parser().parse_known_args(argv)
    built = cli.build(args, unknown)

    mp = built["cfg"]["model"]["params"]
    mod = msvqgan_from_config(mp, name=None)
    loss = jax_instantiate(mp["lossconfig"])
    x0 = np.zeros((2, 32, 32, 3), np.float32)
    pg = _random_params(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x0),
                        np.random.default_rng(0))
    vd = _disc_vars(jax.eval_shape(
        lambda r: loss.init_params(r, x0.shape), jax.random.PRNGKey(1)),
        np.random.default_rng(1))
    load_jax_params(built["model"], pg)
    load_jax_params(built["loss"], vd)
    out = cli.fit(args, built, 0.0)

    lr = built["lr"]
    tx_g = optax.adam(lr, b1=0.5, b2=0.9)
    tx_d = optax.adam(lr, b1=0.5, b2=0.9)
    jpg = jax.tree_util.tree_map(jnp.asarray, pg)
    jvd = jax.tree_util.tree_map(jnp.asarray, vd)
    state = VQGANTrainState(params_g=jpg, vars_d=jvd, opt_g=tx_g.init(jpg),
                            opt_d=tx_d.init({"params": jvd["params"]}),
                            step=jnp.asarray(0, jnp.int32))
    step = jax.jit(make_vqgan_train_step(mod, loss, tx_g, tx_d))
    jstate, jlogs = step(state, jnp.asarray(out["first_batch"].numpy()))
    return dict(out=out, built=built, jstate=jstate, jlogs=jlogs, lr=lr,
                root=root)


def test_first_step_equals_jax(run):
    out, lr = run["out"], run["lr"]
    assert out["steps"] == 3 and tuple(out["first_batch"].shape) == \
        (2, 32, 32, 3)
    assert lr == pytest.approx(2 * 4.5e-6)
    ck = os.path.join(out["logdir"], "checkpoints")
    state = torch.load(os.path.join(ck, "step_1", "state.pt"),
                       weights_only=True)
    jstate = run["jstate"]
    for part, want in (("model", _sd(jstate.params_g)),
                       ("loss", _sd(jstate.vars_d))):
        got = state[part]
        assert set(got) == set(want)
        for k, w in want.items():
            tol = (ATOL if "running" in k else
                   2 * lr + ULPS * np.abs(w).max())
            err = np.abs(got[k].numpy() - w).max()
            assert err <= tol, (part, k, err, tol)
    want = _sd(jstate.opt_g[0].mu)
    got = state["opt_g"]["mu"]
    assert set(got) == set(want) and state["opt_g"]["count"] == 1
    floor = GRAD_RTOL * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        tol = GRAD_RTOL * max(np.abs(w).max(), floor)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= tol, ("opt_g", k, err, tol)
    # before disc_start the discriminator's loss and gradients are 0
    want = _sd(jstate.opt_d[0].mu)
    assert set(state["opt_d"]["mu"]) == set(want)
    assert not any(w.any() for w in want.values())
    assert not any(v.any() for v in state["opt_d"]["mu"].values())
    assert state["step"] == 1


def test_logged_losses_equal_jax(run):
    jlogs = run["jlogs"]
    first = run["out"]["logs"][0]
    assert first["step"] == 1 and len(run["out"]["logs"]) == 3
    for k in ("aeloss", "discloss"):
        assert abs(first[k] - float(jlogs[k])) <= ATOL, k
    assert float(jlogs["discloss"]) == first["discloss"] == 0.0


def test_checkpoints_and_config_load_back(run):
    out, built = run["out"], run["built"]
    logdir = out["logdir"]
    cfg = yaml.safe_load(open(os.path.join(logdir, "config.yaml")))
    assert cfg == built["cfg"]
    ck = os.path.join(logdir, "checkpoints")
    assert sorted(d for d in os.listdir(ck) if d.startswith("step_")) == \
        ["step_1", "step_2", "step_3"]
    assert ckpt_io.read_last_meta(ck)["step"] == 3
    tr = out["trainer"]
    model = instantiate_from_config(cfg["model"], device="cpu", seed=1)
    loss = instantiate_from_config(cfg["model"]["params"]["lossconfig"],
                                   device="cpu", seed=1)
    opts = [optim.AdamW(list(m.parameters()), run["lr"], b1=0.5, b2=0.9,
                        weight_decay=0.0) for m in (model, loss)]
    fresh = VQGANTrainer(model, loss, *opts)
    assert ckpt_io.restore_train_state(ck, fresh) == 3
    want, got = ckpt_io.train_state(tr), ckpt_io.train_state(fresh)
    assert got["step"] == want["step"] == 3
    for part in ("model", "loss"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for opt in ("opt_g", "opt_d"):
        assert got[opt]["count"] == want[opt]["count"] == 3
        for m in ("mu", "nu"):
            for k, v in want[opt][m].items():
                assert torch.equal(got[opt][m][k], v), (opt, m, k)
