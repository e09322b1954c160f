"""The port's sampling CLI (``python -m frido_tpu_torch.cli.sample_diffusion``)
at toy size on the CPU.

The t2i BERT config ``configs/frido/t2i/frido_f16f8_coco.yaml`` is cut to
toy widths by dot-list overrides on the command line, as a user would.
A Lightning-format ``.ckpt`` written from seeded weights (``model_ema.*``
flat names that differ from the raw weights, a scalar ``scale_factor``)
is sampled from a prompt with the WordPiece vocab written from the
fallback vocabulary, under the CLI's strict-vocab default. Checked: the
PNGs read back equal ``to_uint8`` of the images the CLI returns; those
images equal a direct ``sample`` + ``decode`` under the EMA weights with
the same generator (exactly: the same operations on the same CPU);
``--no_ema`` gives other images; ``--get_codebook`` writes the codes npz;
a run directory of the port's own checkpoints samples its EMA, a
params-only directory its weights; strict mode refuses the fallback
vocab; with ``--prompt``, ``-n`` and ``-ngpu`` are refused.
Without ``--prompt`` the CLI samples the config's test split, here a
mini-COCO-2014 tree over the committed JPEG fixtures: the ``-ngpu 2``
shards are disjoint, cover the split and are the JAX data module's; the
captions tokenize as in the JAX package; the ``*-samples.npz`` holds
each shard's samples; a batch's images are a direct ``sample`` +
``decode`` on its tokens with the CLI's generator, bit for bit; ``-n``
caps the count; a dataset the port lacks raises.
``dummy_tokens_like`` equals the JAX script's on the BERT and CLIP
configs.
"""

import copy
import glob
import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.config import load_configs as jax_load_configs
from frido_tpu_torch.cli import sample_diffusion as cli
from frido_tpu_torch.config import instantiate_from_config, load_configs
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.models.frido import FridoDiffusion
from frido_tpu_torch.text.wordpiece import fallback_vocab
from frido_tpu_torch.tools.make_mini_coco import write_tree
from frido_tpu_torch.training.ema import import_ema
from frido_tpu_torch.utils.visualize import read_png, to_uint8

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
T2I = str(REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml")
CLIP_T2I = str(REPO / "configs" / "frido" / "t2i" /
               "frido_f16f8_coco_clip.yaml")
P = "model.params."
TOY = [P + "timesteps=20", P + "image_size=16",
       P + "unet_config.params.image_size=16",
       P + "unet_config.params.model_channels=32",
       P + "unet_config.params.channel_mult=[1,2]",
       P + "unet_config.params.num_res_blocks=1",
       P + "unet_config.params.attention_resolutions=[2]",
       P + "unet_config.params.context_dim=32",
       P + "first_stage_config.params.n_embed=[16,16]",
       P + "first_stage_config.params.edconfig.ch=32",
       P + "first_stage_config.params.edconfig.ch_mult=[1,1,2]",
       P + "first_stage_config.params.edconfig.resolution=32",
       P + "first_stage_config.params.edconfig.num_res_blocks=1",
       P + "first_stage_config.params.edconfig.attn_resolutions=[8]",
       P + "first_stage_config.params.ddconfig.ch=32",
       P + "first_stage_config.params.ddconfig.ch_mult=[1,1]",
       P + "first_stage_config.params.ddconfig.resolution=32",
       P + "first_stage_config.params.ddconfig.num_res_blocks=1",
       P + "first_stage_config.params.ddconfig.attn_resolutions=[16]",
       P + "cond_stage_config.params.n_embed=32",
       P + "cond_stage_config.params.n_layer=1"]
PROMPT = "a red bus on a wet street"
BATCH = 2
SAMPLE = ["-plms", "-c", "4", "-G", "-gs", "1.5", "-bs", str(BATCH),
          "--device", "cpu", "--prompt", PROMPT]


def _flat(name):
    return "model_ema." + ("model." + name).replace(".", "")[len("model"):]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The toy model's Lightning ``.ckpt`` (seeded weights, other EMA
    values, a scalar scale factor) and a WordPiece vocab.txt written from
    the fallback vocabulary."""
    d = tmp_path_factory.mktemp("cli")
    v = fallback_vocab()
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(sorted(v, key=v.get)) + "\n",
                     encoding="utf-8")
    cfg = load_configs([T2I], dotlist=TOY)
    model = FridoDiffusion(device="cpu", seed=3, **cfg["model"]["params"])
    gen = torch.Generator().manual_seed(4)
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    for k, p in model.model.named_parameters():
        sd[_flat(k)] = p.detach() + 0.05 * torch.randn(
            p.shape, generator=gen)
    sd["scale_factor"] = torch.tensor(0.9)
    ckpt = d / "model.ckpt"
    torch.save({"state_dict": sd, "global_step": 10,
                "hyper_parameters": {"base_learning_rate": 1e-6}}, ckpt)
    return dict(dir=d, ckpt=str(ckpt), vocab=str(vocab), sd=sd)


def _unset(monkeypatch, var):
    """Unset ``var`` so that the undo restores it (or unsets what the CLI
    set): monkeypatch records a delenv only of a variable that is set."""
    monkeypatch.setenv(var, "")
    monkeypatch.delenv(var)


@pytest.fixture
def vocab_env(monkeypatch, files):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", files["vocab"])
    _unset(monkeypatch, "FRIDO_TPU_STRICT_VOCAB")
    return monkeypatch


def _main(out, *extra):
    return cli.main(["-cfg", T2I, "-o", str(out), *SAMPLE, *extra, *TOY])


@pytest.fixture(scope="module")
def ema_run(files, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    mp.setenv("FRIDO_TPU_BERT_VOCAB", files["vocab"])
    _unset(mp, "FRIDO_TPU_STRICT_VOCAB")
    try:
        out = tmp_path_factory.mktemp("out")
        res = _main(out, "-r", files["ckpt"], "--get_codebook")
        strict = os.environ.get("FRIDO_TPU_STRICT_VOCAB")
    finally:
        mp.undo()
    return dict(res, out=out, strict=strict)


def test_cli_writes_pngs_of_its_images(ema_run):
    res = ema_run
    imgs = res["images"]
    assert imgs.shape == (BATCH, 32, 32, 3) and np.isfinite(imgs).all()
    assert res["out_dir"] == os.path.join(str(res["out"]), "v0")
    names = sorted(os.listdir(os.path.join(res["out_dir"], "sample")))
    assert names == [f"sample_{i:06}.png" for i in range(BATCH)]
    for i, name in enumerate(names):
        png = read_png(os.path.join(res["out_dir"], "sample", name))
        np.testing.assert_array_equal(png, to_uint8(imgs[i]))
    codes = np.load(os.path.join(res["out_dir"], "codes_000000.npz"))
    assert sorted(codes) == ["scale_0", "scale_1"]
    assert codes["scale_0"].shape[0] == BATCH
    assert res["strict"] == "1"        # a .ckpt turns strict vocab mode on


def test_cli_images_equal_direct_sampling_under_the_ema(ema_run, files,
                                                       vocab_env):
    """A fresh model with the checkpoint's weights and its EMA, sampled
    and decoded directly with the CLI's generator, gives the same images;
    the scalar scale factor was adopted."""
    model = ema_run["model"]
    np.testing.assert_array_equal(model.scale_factors, np.float32([0.9]))
    cfg = load_configs([T2I], dotlist=TOY)
    fresh = FridoDiffusion(device="cpu", seed=11, **cfg["model"]["params"])
    fresh.load_torch_checkpoint(files["ckpt"])
    ema = import_ema(fresh.model, files["sd"])
    with torch.no_grad():
        for name, p in fresh.model.named_parameters():
            p.copy_(ema[name])
    for name, p in fresh.model.named_parameters():
        assert torch.equal(p, dict(model.model.named_parameters())[name])
    tokens = fresh.tokenize([PROMPT] * BATCH)
    utokens = fresh.tokenize([""] * BATCH)
    gen = torch.Generator().manual_seed(42)
    with torch.no_grad():
        ctx = fresh.get_learned_conditioning(tokens)
        uctx = fresh.get_learned_conditioning(utokens)
        z = fresh.sample(BATCH, context=ctx, uncond_context=uctx, steps=4,
                         eta=0.0, guidance_scale=1.5, sampler="plms",
                         compute_dtype=torch.bfloat16, generator=gen)
        img = fresh.decode_first_stage(z).numpy()
    np.testing.assert_array_equal(img, ema_run["images"])


def test_cli_no_ema_gives_other_images(ema_run, files, vocab_env, tmp_path):
    res = _main(tmp_path, "-r", files["ckpt"], "--no_ema")
    assert np.abs(res["images"] - ema_run["images"]).max() > 1e-3
    raw = dict(res["model"].model.named_parameters())
    for k, v in files["sd"].items():
        if k.startswith("model.") and k[len("model."):] in raw:
            assert torch.equal(raw[k[len("model."):]], v), k


def test_cli_samples_a_run_dir_of_port_checkpoints(ema_run, files,
                                                   vocab_env, tmp_path):
    """``-r <run>`` resolves ``checkpoints/last.json``; the train state's
    weights load and its EMA is swapped in (here the .ckpt's weights and
    EMA, so the model is the .ckpt run's); ``-l`` relocates the output
    under the run's name."""
    model = ema_run["model"]
    names = [n for n, _ in model.model.named_parameters()]
    state = {"params": {k: files["sd"][k] for k in model.state_dict()},
             "ema": {n: files["sd"][_flat(n)] for n in names},
             "ema_updates": 3, "step": 3, "adam": {}}
    run = tmp_path / "2024-01-01T00-00-00_t2i"
    ckpt_io.save_train_state(str(run / "checkpoints"), 3, state)
    res = cli.main(["-cfg", T2I, "-r", str(run), "-l",
                    str(tmp_path / "moved"), *SAMPLE, *TOY])
    assert res["out_dir"] == str(tmp_path / "moved" / run.name / "samples"
                                 / "v0")
    assert len(os.listdir(os.path.join(res["out_dir"], "sample"))) == BATCH
    got, want = res["model"].state_dict(), model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_cli_samples_a_params_only_dir(ema_run, vocab_env, tmp_path):
    """``-r`` a directory of ``save_params``: the model is those weights,
    loaded strictly (here the .ckpt run's, EMA included)."""
    want = ema_run["model"].state_dict()
    ckpt_io.save_params(str(tmp_path / "params"), want)
    res = _main(tmp_path, "-r", str(tmp_path / "params"))
    assert len(os.listdir(os.path.join(res["out_dir"], "sample"))) == BATCH
    got = res["model"].state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_strict_vocab_refuses_the_fallback(files, monkeypatch, tmp_path):
    from frido_tpu_torch.text import vendor

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for var in ("FRIDO_TPU_BERT_VOCAB", "FRIDO_TPU_BERT_TOKENIZER",
                "FRIDO_TPU_STRICT_VOCAB"):
        _unset(monkeypatch, var)
    monkeypatch.setattr(vendor, "VENDOR_DIR", str(tmp_path / "vendored"))
    with pytest.raises(RuntimeError, match="strict mode"):
        _main(tmp_path, "-r", files["ckpt"])


def test_dataset_mode_is_not_ported(files, coco2014, vocab_env, tmp_path):
    """Dataset mode over the OpenImages target, which the port refused
    until it had the dataset, now builds the port's OpenImages dataset:
    given the COCO tree's parameters it raises that class's own
    ``TypeError`` (no ``use_additional_parameters``), as the JAX class
    does."""
    with pytest.raises(TypeError, match="use_additional_parameters"):
        cli.main(["-cfg", T2I, "-o", str(tmp_path), "--device", "cpu",
                  "-r", files["ckpt"], *TOY, *coco2014,
                  "data.params.test.target=taming.data.annotated_objects_"
                  "open_images.AnnotatedObjectsOpenImages"])


@pytest.fixture(scope="module")
def coco2014(tmp_path_factory):
    """A mini-COCO-2014 tree of 7 records a split over the committed JPEG
    fixtures (``tools/make_mini_coco.write_tree``), and the dot-list that
    points the t2i config's data section at it (32^2 images, batches of
    2, one worker)."""
    # not "coco": pytest would number it after a "coco2017N" directory of
    # another test file in the same worker, putting "2017" in the path,
    # which the dataset reads as the COCO year
    root = str(tmp_path_factory.mktemp("tree") / "2014")
    write_tree(root, n=7, seed=1)
    dots = ["data.params.batch_size=2", "data.params.num_workers=1"]
    for split, ann in (("train", "train2014"), ("validation", "val2014"),
                       ("test", "val2014")):
        q = f"data.params.{split}.params."
        dots += [q + f"data_path={root}", q + "target_image_size=32",
                 q + f"caption_ann_path={root}/annotations/"
                     f"captions_{ann}.json"]
    return dots


def _dataset_run(files, out, coco2014, shard, *extra):
    return cli.main(["-cfg", T2I, "-o", str(out), "-r", files["ckpt"],
                     "-name", f"shard{shard}", "-plms", "-c", "4", "-G",
                     "-gs", "1.5", "-bs", "4", "--device", "cpu", "-ngpu",
                     "2", "-igpu", str(shard), *extra, *TOY, *coco2014])


@pytest.fixture(scope="module")
def dataset_runs(files, coco2014, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    mp.setenv("FRIDO_TPU_BERT_VOCAB", files["vocab"])
    _unset(mp, "FRIDO_TPU_STRICT_VOCAB")
    out = tmp_path_factory.mktemp("dataset")
    try:
        runs = [_dataset_run(files, out, coco2014, s, "--get_codebook")
                for s in range(2)]
    finally:
        mp.undo()
    return runs


def test_dataset_shards_equal_the_jax_split(dataset_runs, coco2014,
                                            vocab_env):
    """``-ngpu 2``: the shards are disjoint, cover the test split and are
    the JAX data module's shards, file for file; each shard's npz holds
    its samples; the PNGs and the inputs are named by file."""
    cfg = jax_load_configs([T2I], TOY + coco2014)
    names = []
    for shard, res in enumerate(dataset_runs):
        dcfg = copy.deepcopy(cfg["data"])
        dcfg["params"].update(n_split_dataset=2, idx_split_dataset=shard)
        jdata = jax_instantiate(dcfg).setup()
        want = [n for b in jdata.test_dataloader() for n in b["file_name"]]
        assert res["file_names"] == want
        names += want
        imgs = res["images"]
        assert imgs.dtype == np.uint8 and imgs.shape == (len(want), 32, 32, 3)
        npz = glob.glob(os.path.join(res["out_dir"], "*-samples.npz"))
        assert [os.path.basename(f) for f in npz] == [
            f"{len(want)}x32x32x3-samples.npz"]
        np.testing.assert_array_equal(np.load(npz[0])["arr_0"], imgs)
        for key in ("sample", "inputs"):
            pngs = sorted(os.listdir(os.path.join(res["out_dir"], key)))
            assert pngs == sorted(os.path.splitext(n)[0] + ".png"
                                  for n in want)
        for i, n in enumerate(want):
            png = read_png(os.path.join(res["out_dir"], "sample",
                                        os.path.splitext(n)[0] + ".png"))
            np.testing.assert_array_equal(png, imgs[i])
        assert len(glob.glob(os.path.join(res["out_dir"], "codes_*.npz"))) \
            == res["batches"] == (len(want) + 1) // 2
    assert len(names) == len(set(names)) == 7


def test_dataset_batch_equals_direct_sampling(dataset_runs, coco2014,
                                              vocab_env):
    """Shard 1's first batch: its captions tokenized as the JAX package
    tokenizes them, and the CLI's images those of a direct ``sample`` +
    ``decode`` on those tokens with the CLI's generator (seed + shard),
    bit for bit."""
    res = dataset_runs[1]
    model = res["model"]
    cfg = load_configs([T2I], TOY + coco2014)
    dcfg = copy.deepcopy(cfg["data"])
    dcfg["params"].update(n_split_dataset=2, idx_split_dataset=1)
    batch = next(iter(instantiate_from_config(dcfg, device="cpu")
                      .setup().test_dataloader()))
    assert batch["file_name"] == res["file_names"][:2]
    tokens = model.tokenize(batch["caption"])
    jmodel = jax_instantiate(jax_load_configs([T2I], TOY)["model"])
    np.testing.assert_array_equal(tokens, jmodel.tokenize(batch["caption"]))
    utokens = cli.dummy_tokens_like(model, tokens, "caption")
    gen = torch.Generator().manual_seed(42 + 1)
    with torch.no_grad():
        ctx = model.get_learned_conditioning(tokens)
        uctx = model.get_learned_conditioning(utokens)
        z = model.sample(2, context=ctx, uncond_context=uctx, steps=4,
                         eta=0.0, guidance_scale=1.5, sampler="plms",
                         compute_dtype=torch.bfloat16, generator=gen)
        img = model.decode_first_stage(z).numpy()
    np.testing.assert_array_equal(to_uint8(img), res["images"][:2])


def test_dataset_mode_caps_at_n(files, coco2014, vocab_env, tmp_path):
    res = _dataset_run(files, tmp_path, coco2014, 0, "-n", "1")
    assert res["batches"] == 1 and res["images"].shape == (1, 32, 32, 3)
    assert os.path.exists(os.path.join(res["out_dir"],
                                       "1x32x32x3-samples.npz"))


@pytest.mark.parametrize("flag", [["-n", "8"], ["-ngpu", "2"]])
def test_prompt_refuses_dataset_flags(flag, tmp_path):
    """``-n`` and ``-ngpu`` pick and split a dataset's samples: with
    ``--prompt`` they are refused, not ignored."""
    with pytest.raises(ValueError, match="-bs copies"):
        cli.main(["-cfg", T2I, "-o", str(tmp_path), "--device", "cpu",
                  "--prompt", PROMPT, *flag, *TOY])


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_sample_diffusion", REPO / "scripts" / "sample_diffusion.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dummy_tokens_like_equals_jax(vocab_env):
    """BERT with its tokenizer: ``tokenize([""])`` rows; the CLIP wrappers
    (no ``use_tokenizer``): zeros, not ``tokenize("")``."""
    jax_script = _jax_script()
    tokens = np.random.default_rng(0).integers(0, 500, (3, 77)).astype(
        np.int32)
    for path, dotlist in ((T2I, TOY), (CLIP_T2I, [])):
        jmodel = jax_instantiate(jax_load_configs([path], dotlist)["model"])
        port = instantiate_from_config(load_configs([path], dotlist)["model"],
                                       device="meta")
        want = jax_script.dummy_tokens_like(jmodel, tokens, "caption")
        got = cli.dummy_tokens_like(port, tokens, "caption")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_parser_takes_the_jax_flags():
    jax_parser = _jax_script().get_parser()
    port = {a.dest for a in cli.get_parser()._actions}
    assert {a.dest for a in jax_parser._actions} <= port


def test_cli_runs_on_the_card_by_default(files, vocab_env, monkeypatch,
                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-cfg", T2I, "-o", str(tmp_path), "--prompt", PROMPT,
                  *TOY])


def test_load_configs_equals_jax(tmp_path):
    """Left-to-right merge of YAML files and dot-list overrides, as the
    JAX package's (new keys, nested dicts, lists and scalars)."""
    extra = tmp_path / "extra.yaml"
    extra.write_text("model:\n  params:\n    timesteps: 50\n    new: {a: 1}\n"
                     "lightning: {trainer: {max_epochs: 2}}\n")
    dotlist = TOY + ["model.params.new.b=[1, 2]", "data.params.batch_size=3",
                     "fresh.key=text"]
    got = load_configs([T2I, str(extra)], dotlist=dotlist)
    assert got == jax_load_configs([T2I, str(extra)], dotlist=dotlist)
    assert got["model"]["params"]["timesteps"] == 20
    assert got["model"]["params"]["new"] == {"a": 1, "b": [1, 2]}
    with pytest.raises(ValueError, match="key=value"):
        load_configs([T2I], dotlist=["model.params.timesteps"])
