"""The port's acceptance chain (``frido_tpu_torch/tools/acceptance.py``, the
counterpart of ``tools/acceptance.sh``) in process at toy size on the CPU,
the cases of ``tests/test_acceptance_chain.py``:

- ``nogate``: a seeded toy t2i Lightning ``.ckpt`` (the t2i config cut to
  toy widths by ``EXTRA_OVERRIDES``, the mini-val config's own dot-list
  route) over a synthetic COCO-2014 tree (``tools/make_mini_coco.
  write_tree``, its test split narrowed by an id file of 12-digit ids),
  the strict vocab from a vocab.txt written from the fallback vocabulary,
  seeded Inception weights as an ``.npz``: exit 0, the samples and inputs
  written, ``RESULT.json`` with the runbook's keys; its FID equals
  ``cli/eval_fid.py``'s on the same two folders;
- ``pass`` and ``fail``: the gate alone on the measured FID, with a band
  around it (exit 0) and an expectation the toy cannot meet (exit 1);
- missing assets: exit 2, each one named.

The mini-val config's id list is read from the port's copy (the config
loader maps it). Each FID
takes a 2048^2 ``sqrtm`` on the host (10-25 s on this CPU), most of this
file's time.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from frido_tpu_torch.cli import eval_fid
from frido_tpu_torch.config import load_configs
from frido_tpu_torch.eval import inception
from frido_tpu_torch.models.frido import FridoDiffusion
from frido_tpu_torch.text import vendor
from frido_tpu_torch.text.wordpiece import fallback_vocab
from frido_tpu_torch.tools import acceptance
from frido_tpu_torch.tools.make_mini_coco import write_tree

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
MINI = "configs/frido/t2i/frido_f16f8_coco_mini.yaml"
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
IDS = 6
ASSETS = ("CKPT", "FRIDO_TPU_INCEPTION", "FRIDO_TPU_BERT_VOCAB")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The assets and knobs of a toy run."""
    root = tmp_path_factory.mktemp("acceptance")
    tree = str(root / "2014")
    write_tree(tree, n=8, seed=2)
    ids = root / "ids_mini.txt"
    ids.write_text("".join(f"{i:012d}\n" for i in range(1, IDS + 1)))
    q = "data.params.test.params."
    extra = TOY + ["data.params.batch_size=4", "data.params.num_workers=1",
                   q + "target_image_size=32", q + f"img_id_file={ids}"]
    for split, ann in (("train", "train2014"), ("validation", "val2014"),
                       ("test", "val2014")):
        extra.append(f"data.params.{split}.params.caption_ann_path={tree}/"
                     f"annotations/captions_{ann}.json")
    cfg = load_configs([str(REPO / MINI)], dotlist=TOY)
    model = FridoDiffusion(device="cpu", seed=5, **cfg["model"]["params"])
    ckpt = root / "toy_t2i.ckpt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    v = fallback_vocab()
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(sorted(v, key=v.get)) + "\n",
                     encoding="utf-8")
    weights = root / "inception.npz"
    np.savez(weights, **inception.random_state_dict(0))
    return dict(root=root, env={
        "CFG": str(REPO / MINI), "CKPT": str(ckpt), "STEPS": "4",
        "N": str(IDS), "FRIDO_TPU_INCEPTION": str(weights),
        "FRIDO_TPU_BERT_VOCAB": str(vocab), "DATA_PATH": tree,
        "EXTRA_OVERRIDES": " ".join(extra)})


def _chain(monkeypatch, env, out):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for name, value in dict(env, OUT=str(out)).items():
        monkeypatch.setenv(name, value)
    rc = acceptance.main(["--device", "cpu"])
    result = out / "acceptance" / "RESULT.json"
    return rc, (json.loads(result.read_text()) if result.exists() else None)


@pytest.fixture(scope="module")
def nogate(ws):
    mp = pytest.MonkeyPatch()
    out = ws["root"] / "out"
    try:
        rc, res = _chain(mp, dict(ws["env"], EXPECTED_FID=""), out)
    finally:
        mp.undo()
    return rc, res, out


def test_chain_without_a_gate(nogate):
    rc, res, out = nogate
    assert rc == 0
    samples = sorted(os.listdir(out / "acceptance" / "sample"))
    inputs = sorted(os.listdir(out / "acceptance" / "inputs"))
    # the id file narrows the test split to its IDS images
    assert len(samples) == IDS and samples == inputs
    assert sorted(res) == ["cfg", "expected_fid", "fid", "seed", "status",
                           "steps", "tol"]
    assert res["status"] == "nogate" and res["expected_fid"] is None
    assert res["steps"] == 4 and res["seed"] == 42 and res["tol"] == 8
    assert np.isfinite(res["fid"]) and res["fid"] >= 0
    assert os.environ.get("FRIDO_TPU_STRICT_VOCAB") is None


def test_chain_fid_equals_eval_fid(nogate, ws, monkeypatch):
    _, res, out = nogate
    monkeypatch.setenv("FRIDO_TPU_INCEPTION",
                       ws["env"]["FRIDO_TPU_INCEPTION"])
    got = eval_fid.main(["--real", str(out / "acceptance" / "inputs"),
                         "--fake", str(out / "acceptance" / "sample"),
                         "--device", "cpu"])
    assert got["fid"] == res["fid"]


def _gate(out, monkeypatch, fid, expected, tol=None):
    monkeypatch.setenv("OUT", str(out))
    monkeypatch.setenv("EXPECTED_FID", expected)
    if tol is None:
        monkeypatch.delenv("TOL", raising=False)
    else:
        monkeypatch.setenv("TOL", tol)
    return acceptance.gate(acceptance.knobs(), fid)


@pytest.mark.parametrize("case", ["pass", "fail"])
def test_gate_on_the_measured_fid(nogate, tmp_path, monkeypatch, capsys,
                                  case):
    """The gate alone on the chain's FID (the chain's ``main`` returns the
    gate's code): a band around it passes (exit 0; its edge counts as
    inside); an expectation the toy cannot meet fails (exit 1) - a
    random-weight Inception is a degenerate FID oracle, so this checks the
    comparison, not the metric. RESULT.json and the printed line agree."""
    _, res, _ = nogate
    out = tmp_path / case
    if case == "pass":
        rc = _gate(out, monkeypatch, res["fid"], repr(res["fid"] + 8))
    else:
        rc = _gate(out, monkeypatch, res["fid"], "12345", "1")
    text = capsys.readouterr()
    got = json.loads((out / "acceptance" / "RESULT.json").read_text())
    assert json.loads(text.out.strip().splitlines()[-1]) == got
    assert got["fid"] == res["fid"] and got["status"] == case
    if case == "pass":
        assert rc == 0 and "PASS: FID" in text.err
        assert got["expected_fid"] == res["fid"] + 8 and got["tol"] == 8
    else:
        assert rc == 1 and "FAIL: FID" in text.err
        assert got["expected_fid"] == 12345 and got["tol"] == 1


def test_missing_assets_are_named(monkeypatch, tmp_path, capsys):
    for name in ASSETS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(vendor, "VENDOR_DIR", str(tmp_path / "vendored"))
    assert acceptance.main(["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "MISSING: CKPT" in err and "FRIDO_TPU_INCEPTION" in err
    assert "python -m frido_tpu_torch.text.vendor" in err
    monkeypatch.setenv("CKPT", str(tmp_path / "nowhere.ckpt"))
    monkeypatch.setenv("FRIDO_TPU_INCEPTION", str(tmp_path / "none.npz"))
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", str(tmp_path / "vocab.txt"))
    assert acceptance.main(["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "nowhere.ckpt does not exist" in err
    assert "none.npz does not exist" in err and "vendor" not in err


def test_chain_needs_the_card(ws, monkeypatch, tmp_path):
    for name, value in dict(ws["env"], OUT=str(tmp_path)).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        acceptance.main([])


def test_mini_val_ids_are_the_ports_copy():
    """The mini-val config names the JAX package's id list; the config
    loader, through which the chain reads it, gives the port's copy, byte
    for byte the same, and the chain adds no id override of its own."""
    cfg = load_configs([str(REPO / MINI)])
    path = cfg["data"]["params"]["test"]["params"]["img_id_file"]
    assert path.startswith(str(REPO / "frido_tpu_torch" / "data"))
    assert pathlib.Path(path).read_bytes() == (
        REPO / "frido_tpu" / "data" / "eval_ids" /
        "image_ids_t2i_coco_mini.txt").read_bytes()
    k = acceptance.knobs({"DATA_PATH": "/d", "EXTRA_OVERRIDES": "a.b=1 c=2"})
    assert acceptance.overrides(k) == [
        f"data.params.{s}.params.data_path=/d"
        for s in ("train", "validation", "test")] + ["a.b=1", "c=2"]
