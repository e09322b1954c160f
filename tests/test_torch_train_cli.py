"""The port's training CLI (``python -m frido_tpu_torch.cli.main``) on the
CPU, at the toy size of ``tests/test_cli.py`` (its model and its synthetic
COCO-2017 tree, copied here).

- A run of 3 steps (``--scale_lr False``: the learning rate does not
  depend on the world size) validates, keeps ``best``, writes its
  checkpoints and ``scale_factors.json``, and its test pass writes PNGs
  of the samples and inputs by file name.
- A run of 2 steps resumed for two more (``--auto_resume``), on a tree
  of non-square images with several boxes each, random-1d crops and
  flips, ends with the uninterrupted run's weights, EMA and Adam moments,
  bit for bit: the resumed loader replays the same batches (the cursor in
  ``last.json``) with the same crops, flips and builder shuffles (it
  draws the skipped batches' plans again), and each step draws from a
  generator seeded by the step.
- Two gloo ranks under ``torch.distributed.run`` for three steps against
  one process on the same global batches of 2, random-1d crops and
  flips (by the third step every trainable leaf has had a gradient; see
  the test): the third step's logged loss within 1e-6 relative, every
  updated weight within 1e-5 of the largest weight (an Adam step moves
  each element by about lr whatever the size of its gradient, so the
  weights alone carry little signal of the gradient), and every Adam
  first moment (the averaged gradients' running mean) within 1e-5 of its
  leaf's largest, that floored at 1e-3 of the largest over all leaves
  (fp32 sums over one row per rank against two rows, in another order).
- The ``scale_by_std`` peek leaves the first training batch as it was.
- The port's first batch (files, token rows exact; pixels within the data
  tests' PIL bounds) and its first step against the JAX package's
  ``make_train_step`` on the same batch, weights carried by
  ``io/jax_weights.py``, the port's draws fed the JAX step's: the loss
  and its logs within 3e-4, ``init_scale_by_std`` within 1e-5 relative
  (``tests/test_torch_training.py``'s tolerances).
- ``--fsdp`` and ``--img_log_every_steps`` (at 1) run in process: the
  ``--fsdp`` run writes its checkpoint, the image-logging run writes the
  train and val grids of ``log_images`` (``inputs``, ``reconstruction``,
  ``conditioning``) under ``images/``; without ``--device`` and CUDA the
  CLI raises.
"""

import csv
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.training import optim as jax_optim
from frido_tpu.training import trainer as jax_trainer
from frido_tpu_torch.cli import main as cli
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io.jax_weights import load_jax_params
from frido_tpu_torch.training import optim, trainer
from frido_tpu_torch.utils.visualize import read_png
from tests.test_torch_models import _random_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ED = dict(multiscale=2, double_z=False, z_channels=[4, 4], resolution=32,
               in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 2],
               num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
TINY_DD = dict(double_z=False, z_channels=8, resolution=32, in_channels=3,
               out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
               attn_resolutions=[8], dropout=0.0)
LOSS_ATOL = 3e-4
SCALE_RTOL = 1e-5
DP_RTOL = 1e-5
MU_FLOOR = 1e-3
MAX_LEVELS, MEAN_LEVELS = 3 / 127.5, 1 / 127.5
COMMON = ["-n", "tiny", "--log_every_steps", "1", "--img_log_every_steps",
          "0", "--device", "cpu", "--scale_lr", "False"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """``tests/test_cli.py``'s toy t2i-style model (objects tokens through
    a one-layer BERT) and its 8-image COCO-2017 tree."""
    root = tmp_path_factory.mktemp("ws")
    coco = root / "coco2017"
    (coco / "annotations").mkdir(parents=True)
    (coco / "train2017").mkdir()
    (coco / "val2017").mkdir()
    rng = np.random.RandomState(0)
    imgs, anns, caps = [], [], []
    for i in range(8):
        fn = f"{i:012d}.jpg"
        for sub in ["train2017", "val2017"]:
            Image.fromarray(rng.randint(0, 255, (48, 48, 3), np.uint8)).save(
                coco / sub / fn)
        imgs.append({"id": i, "file_name": fn, "width": 48, "height": 48,
                     "coco_url": ""})
        anns.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "bbox": [4, 4, 20, 20]})
        caps.append({"image_id": i, "id": 100 + i, "caption": f"img {i}."})
    payload = {"images": imgs, "annotations": anns,
               "categories": [{"id": 1, "name": "cat", "supercategory": "a"}]}
    for split in ["train2017", "val2017"]:
        json.dump(payload,
                  open(coco / "annotations" / f"instances_{split}.json", "w"))
        json.dump({"images": imgs, "annotations": [], "categories": []},
                  open(coco / "annotations" / f"stuff_{split}.json", "w"))
        json.dump({"annotations": caps},
                  open(coco / "annotations" / f"captions_{split}.json", "w"))

    ds = dict(
        target="taming.data.annotated_objects_coco.AnnotatedObjectsCoco",
        params=dict(
            data_path=str(coco), split="train",
            keys=["image", "objects", "file_name"], target_image_size=32,
            min_object_area=1e-5, min_objects_per_image=0,
            max_objects_per_image=4, crop_method="center", random_flip=False,
            no_tokens=64, use_group_parameter=True, encode_crop=False,
            use_stuff=False))
    test_ds = {**ds, "params": {**ds["params"], "split": "validation"}}
    cfg = {
        "model": {
            "base_learning_rate": 1e-4,
            "target": "frido.models.diffusion.frido.FridoDiffusion",
            "params": dict(
                adopted_scale_factor=True, noise_mix_ratio=0.1,
                first_stage_key="image", cond_stage_key="objects",
                linear_start=0.0015, linear_end=0.0155, timesteps=40,
                loss_type="l1", image_size=16, channels=8,
                cond_stage_trainable=True, conditioning_key="crossattn",
                scale_by_std=True,
                unet_config=dict(
                    target="frido.modules.diffusionmodules.pyunet.PyUNetModel",
                    params=dict(
                        use_split_head=True, split_embed_dim_list=[4, 4],
                        use_SPADE_norm=True, image_size=16, in_channels=8,
                        out_channels=8, model_channels=32,
                        attention_resolutions=[2], num_res_blocks=1,
                        channel_mult=[1, 2], num_head_channels=16,
                        use_spatial_transformer=True, transformer_depth=1,
                        context_dim=32, num_stage=2)),
                first_stage_config=dict(
                    target="taming.models.msvqgan.VQModelInterface",
                    params=dict(embed_dim=[4, 4], n_embed=[32, 32],
                                edconfig=TINY_ED, ddconfig=TINY_DD,
                                lossconfig={
                                    "target": "taming.modules.losses.DummyLoss"})),
                cond_stage_config=dict(
                    target="frido.modules.encoders.modules.BERTEmbedder",
                    params=dict(n_embed=32, n_layer=1, vocab_size=64,
                                max_seq_len=8, use_tokenizer=False,
                                cond_key="objects")),
            ),
        },
        "data": {
            "target": "main.DataModuleFromConfig",
            "params": {"batch_size": 2, "train": ds, "validation": test_ds,
                       "test": test_ds, "num_workers": 2},
        },
    }
    cfg_path = root / "tiny.yaml"
    yaml.safe_dump(cfg, open(cfg_path, "w"))
    return root, cfg_path, cfg


def run_cli(args, cwd, launcher=()):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, *launcher, "-m",
                        "frido_tpu_torch.cli.main", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300,
                       stdin=subprocess.DEVNULL)
    if r.returncode != 0:
        raise AssertionError(f"CLI failed:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return r


def _run_dir(logdir):
    runs = glob.glob(os.path.join(str(logdir), "*tiny"))
    assert len(runs) == 1, runs
    return runs[0]


def _state(run, step):
    return torch.load(os.path.join(run, "checkpoints", f"step_{step}",
                                   "state.pt"), weights_only=True)


@pytest.fixture(scope="module")
def straight(workspace):
    """The uninterrupted run: 3 steps, validation at step 2, the test
    pass."""
    root, cfg_path, _ = workspace
    r = run_cli(["-b", str(cfg_path), "-t", "-l", str(root / "straight"),
                 "--max_steps", "3", "--val_every_steps", "2",
                 "--ckpt_every_steps", "1", "--val_batches", "1",
                 "--test_steps", "2",
                 "--test_batches", "1", *COMMON], root)
    return r, _run_dir(root / "straight")


def test_cli_trains_validates_checkpoints_and_tests(straight):
    r, run = straight
    out = r.stdout
    assert "step 3 loss" in out and "val/loss_ema" in out
    assert "testing time" in out
    ck = os.path.join(run, "checkpoints")
    for name in ("last.json", "best.json", "scale_factors.json"):
        assert os.path.exists(os.path.join(ck, name)), name
    meta = json.load(open(os.path.join(ck, "last.json")))
    assert (meta["step"], meta["epoch"], meta["batch_in_epoch"]) == (3, 0, 3)
    sf = json.load(open(os.path.join(ck, "scale_factors.json")))
    assert len(sf) == 2 and all(np.isfinite(sf)) and all(s > 0 for s in sf)
    for step in (1, 2, 3):
        assert os.path.isdir(os.path.join(ck, f"step_{step}"))
    rows = open(os.path.join(run, "metrics.csv")).read().splitlines()
    assert rows[0].startswith("step,") and "data_wait_share" in rows[0]
    samples = sorted(os.listdir(os.path.join(run, "test", "sample")))
    assert samples == ["000000000000.png", "000000000001.png"]
    for name in samples:
        img = read_png(os.path.join(run, "test", "sample", name))
        assert img.shape == (32, 32, 3) and img.std() > 0
        assert read_png(os.path.join(run, "test", "inputs", name)).shape == \
            (32, 32, 3)
    assert os.listdir(os.path.join(run, "configs"))


def test_resume_replays_the_uninterrupted_run(workspace):
    """Four steps straight against two steps resumed for two more
    (``--auto_resume``), on a mini-COCO-2014 tree of six non-square
    images with 2-5 boxes each (``tools/make_mini_coco.write_tree``),
    random-1d crops, flips and the objects builder's shuffles: batches of
    2, so the resume skips two batches of epoch 0, takes its third and
    then epoch 1's first. The fourth step's weights, EMA and Adam moments
    equal the uninterrupted run's bit for bit: the resumed loader draws
    the plans of the batches it skips again (``DataLoader.set_cursor``)
    and each step draws from a generator seeded by the step."""
    from frido_tpu_torch.tools.make_mini_coco import write_tree

    root, cfg_path, _ = workspace
    tree = write_tree(str(root / "replay" / "coco2014"), n=6, seed=5)
    dots = []
    for split in ("train", "validation", "test"):
        q = f"data.params.{split}.params."
        dots += [q + f"data_path={tree}", q + "max_objects_per_image=5"]
    q = "data.params.train.params."
    dots += [q + "crop_method=random-1d", q + "random_flip=true"]
    base = ["-b", str(cfg_path), "-t", "--val_every_steps", "0",
            "--no_test", "True", *dots, *COMMON]
    run_cli([*base, "-l", str(root / "replay" / "straight"), "--max_steps",
             "4"], root)
    logdir = root / "replay" / "resumed"
    run_cli([*base, "-l", str(logdir), "--max_steps", "2"], root)
    r = run_cli([*base, "-l", str(logdir), "--max_steps", "4",
                 "--auto_resume", "True"], root)
    assert "Restored training state at step 2 (epoch 0, batch 2)" in r.stdout
    want = _state(_run_dir(root / "replay" / "straight"), 4)
    got = _state(_run_dir(logdir), 4)
    for part in ("params", "ema"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for k, v in want["adam"]["mu"].items():
        assert torch.equal(got["adam"]["mu"][k], v), k
    assert got["ema_updates"] == want["ema_updates"] == 4


def test_two_gloo_ranks_equal_one_process(workspace):
    """Three steps of two gloo ranks against one process, with the train
    split's random-1d crop and flip (the CLI seeds the plans alike on
    every rank, so the ranks together see the one-process batch). The
    third step is compared: the UNet's output convolution, and each of
    its residual and transformer branches, ends in a convolution that
    starts at zero, so the first step's loss does not depend on the batch
    and only that output convolution has a gradient; the branches behind
    the zero convolutions have theirs from the third step on."""
    root, cfg_path, _ = workspace
    q = "data.params.train.params."
    common = ["-b", str(cfg_path), "-t", "--max_steps", "3",
              "--val_every_steps", "3", "--val_batches", "1", "--no_test",
              "True", q + "crop_method=random-1d", q + "random_flip=true",
              *COMMON]
    runs = {}
    for ranks in (1, 2):
        logdir = root / f"ddp{ranks}"
        r = run_cli([*common, "-l", str(logdir)], root,
                    launcher=("-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", str(ranks)))
        assert "step 3 loss" in r.stdout
        runs[ranks] = _run_dir(logdir)
    sfs = [json.load(open(os.path.join(runs[n], "checkpoints",
                                       "scale_factors.json")))
           for n in (1, 2)]
    assert sfs[0] == sfs[1]
    want, got = _state(runs[1], 3), _state(runs[2], 3)
    mus = want["adam"]["mu"]
    assert all(v.abs().max() > 0 for v in mus.values()), \
        [k for k, v in mus.items() if not v.abs().max() > 0]
    top = max(v.abs().max().item() for v in want["params"].values()
              if v.is_floating_point() and v.numel())
    for k, v in want["params"].items():
        if v.is_floating_point():
            err = (got["params"][k] - v).abs().max().item()
            assert err <= DP_RTOL * top, (k, err)
    floor = MU_FLOOR * max(v.abs().max().item() for v in mus.values())
    for k, v in mus.items():
        err = (got["adam"]["mu"][k] - v).abs().max().item()
        assert err <= DP_RTOL * max(v.abs().max().item(), floor), (k, err)
    # the logged loss is the ranks' mean: the one-process step's loss
    loss = {}
    for n, path in runs.items():
        with open(os.path.join(path, "metrics.csv")) as f:
            rows = [r for r in csv.DictReader(f)
                    if r["step"] == "3" and r["loss"]]
        loss[n] = float(rows[0]["loss"])
    assert abs(loss[1] - loss[2]) <= 1e-6 * abs(loss[1])


def test_scale_by_std_peek_leaves_the_first_batch(workspace):
    """The first training batch after the ``scale_by_std`` peek is the
    peeked batch, flips included (the tree's images are square, so the
    crops are not drawn), although the peek drew its plans. One batch of
    all 8 images: 8 flips."""
    _, _, cfg = workspace
    dcfg = json.loads(json.dumps(cfg["data"]))
    dcfg["params"]["batch_size"] = 8
    dcfg["params"]["train"]["params"].update(crop_method="random-1d",
                                             random_flip=True)
    data = instantiate_from_config(dcfg, device="cpu").setup()
    cli.seed_data(data, 23)
    first = cli.peek_first_batch(data, 23)
    again = next(iter(data.train_dataloader()))
    assert set(again) == set(first) and "image" in first
    for k, v in first.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[k], v), k
        else:
            np.testing.assert_array_equal(np.asarray(again[k]),
                                          np.asarray(v), err_msg=k)


def _jax_draws(jmodel, step, rng, b):
    t_key, n_key = jax.random.split(jax.random.fold_in(rng, step))
    t = jax.random.randint(t_key, (b,), 0, jmodel.timesteps)
    noise = jax.random.normal(n_key, (b, jmodel.image_size,
                                      jmodel.image_size, jmodel.channels))
    return np.asarray(t), np.asarray(noise)


def test_first_batch_and_step_equal_jax(workspace, monkeypatch):
    """The first training batch of both packages' data modules, then one
    fp32 step of both trainers from the same weights on the port's batch
    (the JAX step's draws fed to the port's)."""
    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    _, _, cfg = workspace
    jdata = jax_instantiate(cfg["data"]).setup()
    pdata = instantiate_from_config(cfg["data"], device="cpu").setup()
    jfirst = next(iter(jdata.train_dataloader()))
    pfirst = next(iter(pdata.train_dataloader()))
    assert pfirst["file_name"] == jfirst["file_name"]
    np.testing.assert_array_equal(pfirst["objects"], jfirst["objects"])
    d = np.abs(pfirst["image"].numpy() - jfirst["image"])
    assert d.max() <= MAX_LEVELS and d.mean() <= MEAN_LEVELS

    jmodel = jax_instantiate(cfg["model"])
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    port = instantiate_from_config(cfg["model"], device="cpu")
    load_jax_params(port, np_params)
    image = pfirst["image"].numpy()
    sf = jmodel.init_scale_by_std(np_params, jnp.asarray(image))
    got_sf = port.init_scale_by_std(pfirst["image"])
    np.testing.assert_allclose(got_sf, np.asarray(sf), rtol=SCALE_RTOL)
    jmodel.scale_factors = port.scale_factors = np.asarray(sf, np.float32)

    lr = 1e-4
    batch = cli.batch_to_arrays(port, pfirst)
    state, tx = jax_trainer.create_train_state(
        jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
        jax_optim.build_from_config(lr, None))
    rng = jax.random.PRNGKey(23)
    _, jlogs = jax.jit(jax_trainer.make_train_step(jmodel, tx))(
        state, {"image": jnp.asarray(image),
                "tokens": jnp.asarray(batch["tokens"])}, rng)
    draws = _jax_draws(jmodel, 0, rng, 2)

    def fake(generator, b, timesteps, noise_shape, device):
        assert b == 2 and tuple(noise_shape) == draws[1].shape
        return (torch.from_numpy(draws[0].astype(np.int64)),
                torch.from_numpy(draws[1].copy()))

    monkeypatch.setattr(trainer, "_draw", fake)
    params = [p for _, p in trainer.trainable_parameters(port)]
    tr = trainer.DiffusionTrainer(port, optim.build_optimizer(params, lr))
    logs = tr.train_step(batch)
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        assert abs(float(logs[k]) - float(v)) <= LOSS_ATOL, k


@pytest.mark.parametrize("flag", [["--fsdp"], ["--img_log_every_steps", "1"]])
def test_flags_run(workspace, flag, tmp_path):
    """The two flags the CLI refused before run: 2 steps in process, one
    validation batch at step 2; with image logging every step, the train
    grids of both steps and the val grids of step 2 are written."""
    _, cfg_path, _ = workspace
    summ = cli.main(["-b", str(cfg_path), "-t", "-l", str(tmp_path), "-n",
                     "tiny", "--device", "cpu", "--img_log_every_steps", "0",
                     "--max_steps", "2", "--val_every_steps", "2",
                     "--val_batches", "1", "--no_test", "True",
                     "--log_every_steps", "1", *flag])
    assert summ["steps"] == 2
    run = _run_dir(tmp_path)
    assert json.load(open(os.path.join(run, "checkpoints",
                                       "last.json")))["step"] == 2
    if flag[0] == "--fsdp":
        assert summ["fsdp"] and not summ["image_log_seconds"]
        return
    assert len(summ["image_log_seconds"]) == 3
    keys = ("inputs", "reconstruction", "conditioning")
    want = {"train": [f"{k}_gs-{s:06}.png" for k in keys for s in (1, 2)],
            "val": [f"{k}_gs-000002.png" for k in keys]}
    for split, names in want.items():
        d = os.path.join(run, "images", split)
        assert sorted(os.listdir(d)) == sorted(names), split
        for name in names:
            img = read_png(os.path.join(d, name))
            # a grid of 2 images of 32^2, 4 a row, 2 pixels apart
            assert img.shape == (36, 70, 3) and img.std() > 0, name


def test_cli_runs_on_the_card_by_default(workspace, monkeypatch, tmp_path):
    _, cfg_path, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-b", str(cfg_path), "-t", "-l", str(tmp_path),
                  "--img_log_every_steps", "0"])


def test_parser_takes_the_jax_flags():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_main", os.path.join(REPO, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_parser = mod.get_parser()
    port = {a.dest: a.default for a in cli.get_parser()._actions}
    for a in jax_parser._actions:
        assert a.dest in port and port[a.dest] == a.default, a.dest
