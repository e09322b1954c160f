"""The port's checkpoints against the JAX package, on the CPU.

- A Lightning-format ``.ckpt`` written from seeded values (a
  ``state_dict`` with the model's tensors, ``model_ema.*`` flat names
  that differ from them, a scalar ``scale_factor``, schedule buffers,
  ignored keys; ``hyper_parameters``) goes through the port's
  ``FridoDiffusion.load_torch_checkpoint`` + ``training.ema.import_ema``
  and the JAX package's ``load_torch_checkpoint`` + ``import_ema``: every
  leaf, the EMA, the scale factors and the used/missing reports equal,
  exactly.
- The port's train-state checkpoints (``io/checkpoint.py``): a
  ``DiffusionTrainer`` resumed from ``step_1`` gives bitwise the weights,
  EMA and Adam state of one trained straight through 2 steps; keep-3
  pruning, the ``best`` tag, ``last.json`` with its meta, params-only
  directories.
- ``find_resume`` and the CLI's ``resolve_resume`` against the JAX
  functions on the same directories.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.io import checkpoint as jax_ckpt
from frido_tpu.io.torch_import import load_torch_checkpoint as jax_load
from frido_tpu.training.ema import import_ema as jax_import_ema
from frido_tpu_torch.cli.sample_diffusion import resolve_resume
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_weights import jax_params_to_state_dict
from frido_tpu_torch.io.torch_import import (load_state_dict,
                                             load_torch_checkpoint, subdict)
from frido_tpu_torch.training import optim, trainer
from frido_tpu_torch.training.ema import import_ema

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CTX_LEN = 8
UNET = dict(use_split_head=True, split_embed_dim_list=[4, 4],
            use_SPADE_norm=True, image_size=8, in_channels=8,
            out_channels=8, model_channels=32, attention_resolutions=[2],
            num_res_blocks=1, channel_mult=[1, 2], num_head_channels=16,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=16, num_stage=2)
ED = dict(multiscale=2, double_z=False, z_channels=[4, 4], resolution=16,
          in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 2],
          num_res_blocks=1, attn_resolutions=[4], dropout=0.0)
DD = dict(double_z=False, z_channels=8, resolution=16, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
          attn_resolutions=[8], dropout=0.0)
IGNORED = "first_stage_model.decoder.conv_out."


def _config(**params):
    return {
        "target": "frido.models.diffusion.frido.FridoDiffusion",
        "params": dict(
            adopted_scale_factor=True, linear_start=0.0015,
            linear_end=0.0155, timesteps=20, image_size=8, channels=8,
            conditioning_key="crossattn",
            unet_config=dict(target="frido.modules.diffusionmodules.pyunet."
                                    "PyUNetModel", params=UNET),
            first_stage_config=dict(
                target="taming.models.msvqgan.VQModelInterface",
                params=dict(embed_dim=[4, 4], n_embed=[16, 16], edconfig=ED,
                            ddconfig=DD,
                            lossconfig={"target":
                                        "taming.modules.losses.DummyLoss"})),
            cond_stage_config=dict(
                target="frido.modules.encoders.modules.BERTEmbedder",
                params=dict(n_embed=16, n_layer=1, vocab_size=50,
                            max_seq_len=CTX_LEN, use_tokenizer=False)),
            **params),
    }


def _flat(name):
    """LitEma's flat buffer name of ``model.<name>``."""
    return "model_ema." + ("model." + name).replace(".", "")[len("model"):]


def write_lightning_ckpt(path, model, seed, scale_factor=0.7):
    """A Lightning checkpoint of seeded values for every tensor of
    ``model``, EMA buffers (other values) for every denoiser parameter, a
    scalar scale factor, schedule buffers and keys to be ignored; returns
    its state dict."""
    rng = np.random.default_rng(seed)

    def draw(t):
        return torch.from_numpy(
            (0.1 * rng.standard_normal(tuple(t.shape))).astype(np.float32))

    sd = {k: draw(v) for k, v in model.state_dict().items()}
    sd.update({_flat(k): draw(p) for k, p in model.model.named_parameters()})
    sd["model_ema.num_updates"] = torch.tensor(7)
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["scale_factor"] = torch.tensor(scale_factor)
    sd["betas"] = torch.linspace(1e-4, 2e-2, 20)
    # Lightning pickles its hyper-parameters as an object that torch.load's
    # weights_only default refuses; a Namespace stands in for it
    torch.save({"state_dict": sd, "epoch": 3, "global_step": 1234,
                "hyper_parameters": argparse.Namespace(
                    base_learning_rate=1e-6)}, path)
    return sd


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Both packages' imports of one synthetic checkpoint."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    cfg = _config(ignore_keys=[IGNORED])
    port = instantiate_from_config(cfg, device="cpu")
    sd = write_lightning_ckpt(path, port, seed=1)
    report = port.load_torch_checkpoint(path)
    ema_report = {}
    ema = import_ema(port.model, report["state_dict"], report=ema_report)

    jmodel = jax_instantiate(cfg)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    jparams = jmodel.load_torch_checkpoint(path, template)
    jsd = jax_load(path)
    jema_report = {}
    jema = jax_import_ema(jparams["params"]["model"], jsd,
                          report=jema_report)
    return dict(port=port, report=report, ema=ema, ema_report=ema_report,
                jmodel=jmodel, jparams=jparams, jema=jema,
                jema_report=jema_report, sd=sd, path=path, cfg=cfg)


def test_ckpt_import_equals_jax_leaf_for_leaf(imported):
    port, jparams = imported["port"], imported["jparams"]
    want = jax_params_to_state_dict(jparams)
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith(IGNORED):
            continue        # ignored: each package keeps its own init
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
        assert np.array_equal(got[k].numpy(), imported["sd"][k].numpy()), k


def test_ckpt_scale_factor_and_reports_equal_jax(imported):
    port, jmodel = imported["port"], imported["jmodel"]
    assert port.scale_factors.shape == (1,)        # scalar -> vector
    np.testing.assert_array_equal(port.scale_factors, jmodel.scale_factors)
    np.testing.assert_array_equal(port.scale_factors,
                                  np.float32([0.7]))
    report = imported["report"]
    assert sorted(report["missing"]) == sorted(
        k for k in port.state_dict() if k.startswith(IGNORED))
    assert report["used"] == set(port.state_dict()) - set(report["missing"])


def test_ckpt_scalar_scale_factor_scales_every_stage(imported):
    """The JAX package indexes a 1-vector past its end by clamping, so the
    scalar checkpoint factor scales both stages; the port does the same."""
    z = torch.ones(1, 2, 2, 8)
    got = imported["port"]._scale_latent(z, invert=False)
    assert torch.equal(got, torch.full_like(z, np.float32(0.7)))


def test_ema_import_equals_jax(imported):
    ema, jema = imported["ema"], imported["jema"]
    want = jax_params_to_state_dict(jema)
    assert set(ema) == set(want)
    for k, v in want.items():
        assert np.array_equal(ema[k].numpy(), np.asarray(v)), k
        assert np.array_equal(ema[k].numpy(),
                              imported["sd"][_flat(k)].numpy()), k
    assert imported["ema_report"]["used"] == imported["jema_report"]["used"]
    assert imported["ema_report"]["missing"] == []
    assert imported["jema_report"]["missing"] == []


def test_ema_import_keeps_what_is_missing(imported):
    sd = dict(imported["report"]["state_dict"])
    name = next(iter(dict(imported["port"].model.named_parameters())))
    del sd[_flat(name)]
    report = {}
    ema = import_ema(imported["port"].model, sd, report=report)
    assert report["missing"] == [_flat(name)]
    assert torch.equal(ema[name],
                       dict(imported["port"].model.named_parameters())[name])


def test_strict_import_raises_on_missing_keys_and_shapes(imported):
    port = imported["port"]
    sd = {k: v for k, v in imported["sd"].items()
          if not k.startswith(IGNORED)}
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(port, sd, strict=True)
    bad = dict(imported["sd"])
    key = next(k for k in bad if k.startswith("model.diffusion_model.")
               and k.endswith(".weight"))
    bad[key] = bad[key][:1]
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state_dict(port, bad, strict=False)


def test_load_torch_checkpoint_and_subdict(imported):
    with pytest.raises(Exception, match="weights_only"):
        torch.load(imported["path"], weights_only=True)
    sd = load_torch_checkpoint(imported["path"])
    jsd = jax_load(imported["path"])
    assert set(sd) == set(jsd)
    for k in sd:
        assert np.array_equal(sd[k].numpy(), np.asarray(jsd[k])), k
    sub = subdict(sd, "cond_stage_model.")
    assert set(sub) == set(imported["port"].cond_stage_model.state_dict())
    bare = os.path.join(os.path.dirname(imported["path"]), "bare.pt")
    torch.save({"a.b": torch.ones(2)}, bare)      # no state_dict wrapper
    assert set(load_torch_checkpoint(bare)) == {"a.b"}


# ---------------------------------------------------------------------------
# train-state checkpoints
# ---------------------------------------------------------------------------

def _trainer(seed_model, accumulate=1):
    model = instantiate_from_config(_config(), device="cpu", seed=seed_model)
    params = [p for _, p in trainer.trainable_parameters(model)]
    opt = optim.build_optimizer(params, 1e-3,
                                accumulate_grad_batches=accumulate)
    return trainer.DiffusionTrainer(model, opt)


def _batch():
    rng = np.random.default_rng(7)
    return {"image": np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(
                np.float32),
            "tokens": rng.integers(0, 50, (2, CTX_LEN))}


def _step(tr, n):
    return tr.train_step(_batch(), torch.Generator().manual_seed(100 + n))


def test_resume_from_step_1_is_bitwise_two_straight_steps(tmp_path):
    straight = _trainer(0)
    _step(straight, 0)
    _step(straight, 1)

    first = _trainer(0)
    _step(first, 0)
    ckpt_dir = str(tmp_path / "checkpoints")
    ckpt_io.save_train_state(ckpt_dir, 1, ckpt_io.train_state(first),
                             meta={"epoch": 0, "cursor": 1})
    resumed = _trainer(5)             # other initial weights: all restored
    assert ckpt_io.restore_train_state(ckpt_dir, resumed) == 1
    assert resumed.step == 1 and resumed.optimizer.count == 1
    _step(resumed, 1)

    a, b = ckpt_io.train_state(straight), ckpt_io.train_state(resumed)
    for part in ("params", "ema"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for part in ("mu", "nu"):
        for k in a["adam"][part]:
            assert torch.equal(a["adam"][part][k], b["adam"][part][k]), k
    assert (a["step"], a["ema_updates"], a["adam"]["count"]) == (
        b["step"], b["ema_updates"], b["adam"]["count"]) == (2, 2, 2)
    assert ckpt_io.read_last_meta(ckpt_dir)["cursor"] == 1


def test_accumulator_round_trips(tmp_path):
    tr = _trainer(0, accumulate=2)
    _step(tr, 0)                        # one call accumulated, no update
    state = ckpt_io.train_state(tr)
    assert state["adam"]["mini_step"] == 1 and state["adam"]["acc"]
    ckpt_io.save_train_state(str(tmp_path), 1, state)
    other = _trainer(3, accumulate=2)
    ckpt_io.restore_train_state(str(tmp_path), other)
    back = ckpt_io.train_state(other)
    assert back["adam"]["mini_step"] == 1
    for k, v in state["adam"]["acc"].items():
        assert torch.equal(back["adam"]["acc"][k], v), k


def test_keep_three_best_tag_and_params_dirs(tmp_path):
    ckpt_dir = str(tmp_path / "checkpoints")
    state = {"params": {"w": torch.arange(3.0)}, "ema": {}, "step": 0}
    for step in range(1, 6):
        path = ckpt_io.save_train_state(ckpt_dir, step, state)
        assert path == os.path.join(ckpt_dir, f"step_{step}")
    best = ckpt_io.save_train_state(ckpt_dir, 2, state, tag="best",
                                    meta={"val/loss_ema": 0.25})
    kept = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    assert kept == ["step_3", "step_4", "step_5"]
    assert ckpt_io.read_last_meta(ckpt_dir)["step"] == 5
    with open(os.path.join(ckpt_dir, "best.json")) as f:
        assert json.load(f) == {"step": 2, "path": best,
                                "val/loss_ema": 0.25}
    assert torch.equal(ckpt_io.restore_raw(best)["params"]["w"],
                       torch.arange(3.0))

    module = torch.nn.Linear(3, 2)
    ckpt_io.save_params(str(tmp_path / "params"), module.state_dict())
    other = torch.nn.Linear(3, 2)
    ckpt_io.restore_params(str(tmp_path / "params"), other)
    assert torch.equal(other.weight, module.weight)
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_raw(str(tmp_path))


def _jax_resolve_resume():
    spec = importlib.util.spec_from_file_location(
        "jax_sample_diffusion", REPO / "scripts" / "sample_diffusion.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.resolve_resume


def test_find_resume_and_resolve_resume_equal_jax(tmp_path):
    logs = tmp_path / "logs"
    state = {"params": {}, "ema": {}, "step": 0}
    for i, name in enumerate(["2024-01-01T00-00-00_t2i",
                              "2024-01-02T00-00-00_t2i",
                              "2024-01-03T00-00-00_layout"]):
        run = logs / name
        ckpt_io.save_train_state(str(run / "checkpoints"), 10 * (i + 1),
                                 state)
        stamp = time.time() - 100 + 10 * i
        os.utime(run, (stamp, stamp))
    (logs / "2024-01-04T00-00-00_t2i").mkdir()     # no checkpoint: skipped
    for name in ("t2i", "layout", "sg2i"):
        assert ckpt_io.find_resume(str(logs), name) == \
            jax_ckpt.find_resume(str(logs), name)
    assert ckpt_io.find_resume(str(logs), "t2i").endswith("02T00-00-00_t2i")
    assert ckpt_io.find_resume(str(tmp_path / "none"), "t2i") is None

    jax_resolve = _jax_resolve_resume()
    run = logs / "2024-01-02T00-00-00_t2i"
    moved = tmp_path / "moved"
    (moved / "checkpoints" / "step_7").mkdir(parents=True)
    with open(moved / "checkpoints" / "last.json", "w") as f:
        json.dump({"step": 7, "path": "/elsewhere/checkpoints/step_7"}, f)
    ckpt_file = tmp_path / "model.ckpt"
    ckpt_file.write_bytes(b"")
    forms = [None, "", str(run), str(run) + "/", str(run / "checkpoints"),
             str(run / "checkpoints" / "step_20"), str(ckpt_file),
             str(moved)]
    for form in forms:
        assert resolve_resume(form) == jax_resolve(form), form
    assert resolve_resume(str(moved))[0] == str(
        moved / "checkpoints" / "step_7")
