"""The port's runbooks (``frido_tpu_torch/runbooks/``) against the JAX
package's (``tools/frido/``, ``tools/msvqgan/``), the shipped configs' id
lists read from the port's own copies, and the quickstart notebook
(``frido_tpu_torch/demo.ipynb``), on the CPU.

- Structural: one port runbook for each JAX runbook, of the same name;
  ``bash -n`` on each; none names ``scripts/``, ``main.py`` or anything
  under ``frido_tpu``, none ends a step in ``|| true``. Each pair runs
  with ``python3`` and ``torchrun`` replaced on ``PATH`` by a stub that
  records its arguments (and ``nvidia-smi`` by one listing the cards):
  the port's commands are the JAX runbook's with the entry points
  mapped, plus ``--device`` under ``DEVICE`` and the extra arguments of a
  training runbook; ``scripts/sample_diffusion.py``'s
  and ``main.py``'s parsers read the same values as the port's. A stub
  reporting two cards shows the training runbooks' rank count and the
  multishard runbooks' card pinning; a failing stub, that the JAX
  multishard runbook exits 0 and the port's does not.
- End to end, in working directories holding a toy t2i config at the
  runbooks' config path, a seeded toy ``.ckpt`` at the default ``CKPT``
  and a mini-COCO-2014 tree, ``DEVICE=cpu``, all started at once:
  ``eval_t2i_multishard.sh 2`` writes each test record once across the
  shards, under ``split_indices_deterministic``'s names; with ``CKPT``
  missing it exits non-zero before sampling; ``train_t2i_f16f8_coco.sh
  --max_steps 1`` trains through ``torchrun`` at one rank and leaves a
  checkpoint.
- The id lists: the port's copies are byte-equal to the JAX package's;
  no shipped config, loaded through the port's loader, names a path under
  ``frido_tpu/``; an unknown id file is named; the layout2i mini-val test
  split builds over a synthetic COCO-2017 tree while ``open`` refuses
  every path under the JAX package.
- The notebook: its code cells run in order in one namespace on the toy
  config at 4 steps on the CPU; no cell imports ``jax``, ``frido_tpu`` or
  ``PIL``; an empty ``CKPT`` (the default) means random weights, one that
  names no file raises.
"""

import ast
import builtins
import importlib.util
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import yaml

from frido_tpu_torch.cli import main as train_cli
from frido_tpu_torch.cli import sample_diffusion as sample_cli
from frido_tpu_torch.config import (EVAL_IDS, instantiate_from_config,
                                     load_configs)
from frido_tpu_torch.data.datamodule import split_indices_deterministic
from frido_tpu_torch.models.frido import FridoDiffusion
from frido_tpu_torch.text.wordpiece import fallback_vocab
from frido_tpu_torch.tools.make_mini_coco import FIXTURES, write_tree
from frido_tpu_torch.utils.visualize import read_png

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_BOOKS = REPO / "tools"
PORT_BOOKS = REPO / "frido_tpu_torch" / "runbooks"
NAMES = sorted(f"{group}/{p.name}" for group in ("frido", "msvqgan")
               for p in (JAX_BOOKS / group).glob("*.sh"))
JAX_IDS = REPO / "frido_tpu" / "data" / "eval_ids"
NOTEBOOK = REPO / "frido_tpu_torch" / "demo.ipynb"
T2I = "configs/frido/t2i/frido_f16f8_coco.yaml"
CKPT = "exp/t2i/frido_f16f8_coco/model.ckpt"
ENTRY = {"scripts/sample_diffusion.py": "frido_tpu_torch.cli.sample_diffusion",
         "scripts/eval_fid.py": "frido_tpu_torch.cli.eval_fid",
         "scripts/train_msvqgan.py": "frido_tpu_torch.cli.train_msvqgan",
         "main.py": "frido_tpu_torch.cli.main"}
EXTRA = ["--max_steps", "7"]
P = "model.params."
# the acceptance test's toy t2i (BERT cond stage), without attention in
# the UNet: the runbooks sample at their own PLMS 200
TOY = [P + "image_size=16",
       P + "unet_config.params.image_size=16",
       P + "unet_config.params.model_channels=32",
       P + "unet_config.params.channel_mult=[1,2]",
       P + "unet_config.params.num_res_blocks=1",
       P + "unet_config.params.attention_resolutions=[]",
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
RECORDS = 2
RUN_TIMEOUT = 240
STUB = """#!/bin/sh
f=$(mktemp "$STUB_LOG/call.XXXXXX")
printf '%s\\0' "${CUDA_VISIBLE_DEVICES-unset}" "$(basename "$0")" "$@" > "$f"
exit "${STUB_EXIT:-0}"
"""


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def parsers():
    """Entry point -> (the JAX script's parser, the port's), where the JAX
    script exposes ``get_parser``."""
    jax_sample = _load("jax_sample_diffusion",
                       REPO / "scripts" / "sample_diffusion.py")
    jax_main = _load("jax_main", REPO / "main.py")
    return {ENTRY["scripts/sample_diffusion.py"]:
            (jax_sample.get_parser(), sample_cli.get_parser()),
            ENTRY["main.py"]: (jax_main.get_parser(), train_cli.get_parser())}


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    """A working directory with ``python3`` and ``torchrun`` stubs in its
    ``bin/``, and an ``nvidia-smi`` listing STUB_CARDS cards."""
    work = tmp_path_factory.mktemp("stubs")
    (work / "bin").mkdir()
    for name in ("python3", "torchrun"):
        (work / "bin" / name).write_text(STUB)
        (work / "bin" / name).chmod(0o755)
    smi = work / "bin" / "nvidia-smi"
    smi.write_text('#!/bin/sh\n[ "$STUB_CARDS" -gt 0 ] && '
                   'seq 0 $((STUB_CARDS - 1))\nexit 0\n')
    smi.chmod(0o755)
    return work


def record(script, args, work, env):
    """Run ``script`` with the stubs first on ``PATH``; returns the process
    and the stubs' calls as sorted (program, arguments, the call's
    CUDA_VISIBLE_DEVICES) tuples."""
    log = pathlib.Path(tempfile.mkdtemp(dir=work))
    full = {"PATH": f"{work / 'bin'}:{os.environ['PATH']}",
            "STUB_LOG": str(log), "STUB_CARDS": "0", **env}
    proc = subprocess.run(["bash", str(script), *args], cwd=work, env=full,
                          capture_output=True, text=True, timeout=60)
    calls = []
    for f in log.iterdir():
        cvd, prog, *argv = f.read_text().split("\0")[:-1]
        calls.append((prog, argv, cvd))
    return proc, sorted(calls, key=lambda c: c[1])


def jax_command(call):
    prog, argv, _ = call
    assert prog == "python3"
    return ENTRY[argv[0]], argv[1:]


def port_command(call):
    """(entry point, its arguments, torchrun's rank count or None)."""
    prog, argv, _ = call
    nproc = None
    if prog == "torchrun":
        assert argv[0] == "--standalone"
        assert argv[1].startswith("--nproc_per_node=")
        nproc, argv = argv[1].split("=", 1)[1], argv[2:]
    else:
        assert prog == "python3"
    assert argv[0] == "-m"
    return argv[1], argv[2:], nproc


def shard(args):
    return int(args[args.index("-igpu") + 1]) if "-igpu" in args else None


def test_one_port_runbook_for_each_jax_runbook():
    port = sorted(f"{group}/{p.name}" for group in ("frido", "msvqgan")
                  for p in (PORT_BOOKS / group).glob("*.sh"))
    assert len(NAMES) == 26 and port == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_runbook_runs_the_jax_commands_on_the_port(name, stubs, parsers):
    book = PORT_BOOKS / name
    text = book.read_text()
    assert subprocess.run(["bash", "-n", str(book)]).returncode == 0
    assert not re.search(r"scripts/|main\.py|\bfrido_tpu[./]", text)
    assert "|| true" not in text
    train = "/train_" in f"/{pathlib.Path(name).name}"
    args = ["3"] if "multi" in name else EXTRA if train else []
    extra = EXTRA if train else []
    _, jax_calls = record(JAX_BOOKS / name, args, stubs, {})
    assert jax_calls
    jax = sorted(jax_command(c) for c in jax_calls)
    for env, device, cards in (({"DEVICE": "cpu"}, ["--device", "cpu"], 1),
                               ({"STUB_CARDS": "2"}, [], 2)):
        proc, calls = record(book, args, stubs, env)
        assert proc.returncode == 0, proc.stderr
        port = sorted(port_command(c) + (c[2],) for c in calls)
        assert [(e, a) for e, a, _, _ in port] == [
            (e, a + device + extra) for e, a in jax]
        for (entry, a, nproc, cvd), (_, ja) in zip(port, jax):
            assert nproc == (str(cards) if entry.endswith(".cli.main")
                             else None)
            i = shard(a)
            assert cvd == ("unset" if i is None or device
                           else str(i % cards))
            if entry in parsers:
                jax_parser, port_parser = parsers[entry]
                jv = vars(jax_parser.parse_known_args(ja)[0])
                pv = vars(port_parser.parse_known_args(a[:len(ja)])[0])
                common = jv.keys() & pv.keys()
                assert {k: pv[k] for k in common} == {k: jv[k]
                                                      for k in common}


def test_training_runbook_needs_a_card_or_device(stubs):
    proc, calls = record(PORT_BOOKS / "frido" / "train_t2i_f16f8_coco.sh",
                         [], stubs, {"STUB_CARDS": "0"})
    assert proc.returncode != 0 and not calls
    assert "DEVICE=cpu" in proc.stderr


def test_runbooks_go_round_cuda_visible_devices(stubs):
    """Under CUDA_VISIBLE_DEVICES its list is the cards: the shards go
    round it, the training ranks are as many."""
    env = {"CUDA_VISIBLE_DEVICES": "5,7", "STUB_CARDS": "8"}
    _, calls = record(PORT_BOOKS / "frido" / "eval_t2i_multishard.sh",
                      ["3"], stubs, env)
    assert sorted((shard(c[1]), c[2]) for c in calls) == [
        (0, "5"), (1, "7"), (2, "5")]
    _, calls = record(PORT_BOOKS / "frido" / "train_t2i_f16f8_coco.sh", [],
                      stubs, env)
    assert [port_command(c)[2] for c in calls] == ["2"]


@pytest.mark.parametrize("name", ["frido/eval_t2i_multishard.sh",
                                  "frido/eval_layout2i_multiGPU.sh"])
def test_multishard_exit_status_when_a_shard_fails(name, stubs):
    """Every shard fails: the JAX runbook's bare ``wait`` gives 0, the
    port's runbook waits on each shard and fails, naming them."""
    env = {"STUB_EXIT": "3", "DEVICE": "cpu"}
    jax, jax_calls = record(JAX_BOOKS / name, ["2"], stubs, env)
    port, port_calls = record(PORT_BOOKS / name, ["2"], stubs, env)
    assert len(jax_calls) == len(port_calls) == 2
    assert jax.returncode == 0
    assert port.returncode != 0
    assert "shard 0 of 2 failed" in port.stderr
    assert "shard 1 of 2 failed" in port.stderr


# ---- end to end on the CPU ----------------------------------------------

def toy_config(root):
    """The t2i config at toy widths over a mini-COCO-2014 tree of RECORDS
    images a split, batches of one, its test split narrowed by an id
    file to every record."""
    tree = root / "coco" / "2014"
    write_tree(str(tree), n=RECORDS, seed=0)
    ids = root / "ids.txt"
    ids.write_text("".join(f"{i:012d}\n" for i in range(1, RECORDS + 1)))
    dots = TOY + ["data.params.batch_size=1", "data.params.num_workers=1",
                  f"data.params.test.params.img_id_file={ids}"]
    for split, ann in (("train", "train2014"), ("validation", "val2014"),
                       ("test", "val2014")):
        q = f"data.params.{split}.params."
        dots += [q + f"data_path={tree}", q + "target_image_size=32",
                 q + "min_objects_per_image=0",
                 q + f"caption_ann_path={tree}/annotations/"
                     f"captions_{ann}.json"]
    return load_configs([str(REPO / T2I)], dotlist=dots)


def workspace(path, cfg, ckpt=None):
    """A working directory holding ``cfg`` at the runbooks' t2i config
    path (and ``ckpt`` at their default ``CKPT``)."""
    (path / "configs" / "frido" / "t2i").mkdir(parents=True)
    (path / T2I).write_text(yaml.safe_dump(cfg))
    if ckpt is not None:
        (path / CKPT).parent.mkdir(parents=True)
        shutil.copyfile(ckpt, path / CKPT)
    return path


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("runbooks")
    cfg = toy_config(root)
    model = FridoDiffusion(device="cpu", seed=5, **cfg["model"]["params"])
    ckpt = root / "toy_t2i.ckpt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    v = fallback_vocab()
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(sorted(v, key=v.get)) + "\n",
                     encoding="utf-8")
    config = root / "toy_t2i.yaml"
    config.write_text(yaml.safe_dump(cfg))
    return dict(root=root, cfg=cfg, ckpt=ckpt, vocab=vocab, config=config)


@pytest.fixture(scope="module")
def runs(toy):
    """The three runbook runs, started together: ``eval_t2i_multishard.sh
    2``, the same with ``CKPT`` missing, ``train_t2i_f16f8_coco.sh
    --max_steps 1`` (without its test pass)."""
    root = toy["root"]
    env = dict(os.environ, PYTHONPATH=str(REPO), DEVICE="cpu",
               OMP_NUM_THREADS="1", FRIDO_TPU_BERT_VOCAB=str(toy["vocab"]),
               HF_HUB_OFFLINE="1")
    env.pop("CKPT", None)
    sampling = workspace(root / "sampling", toy["cfg"], toy["ckpt"])
    failing = workspace(root / "failing", toy["cfg"], toy["ckpt"])
    training = workspace(root / "training", toy["cfg"])
    books = PORT_BOOKS / "frido"
    jobs = {
        "sampling": (sampling, [books / "eval_t2i_multishard.sh", "2"],
                     env),
        "failing": (failing, [books / "eval_t2i_multishard.sh", "2"],
                    dict(env, CKPT=str(failing / "missing.ckpt"))),
        "training": (training, [
            books / "train_t2i_f16f8_coco.sh", "--max_steps", "1",
            "--no_test", "True", "--img_log_every_steps", "0",
            "--log_every_steps", "1"], env)}
    procs = {k: subprocess.Popen(["bash", *map(str, cmd)], cwd=cwd, env=e,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 start_new_session=True)
             for k, (cwd, cmd, e) in jobs.items()}
    out = {}
    try:
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=RUN_TIMEOUT)
            out[k] = dict(cwd=jobs[k][0], rc=proc.returncode, out=stdout,
                          err=stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
    return out


def summaries(text, prefix):
    return [json.loads(ln[len(prefix):]) for ln in text.splitlines()
            if ln.startswith(prefix)]


def test_multishard_writes_each_test_record_once(runs, toy):
    run = runs["sampling"]
    assert run["rc"] == 0, run["err"][-3000:]
    cfg = toy["cfg"]
    ds = instantiate_from_config(cfg["data"]["params"]["test"],
                                 device="cpu")
    got = summaries(run["out"], "sampling summary: ")
    assert sorted(s["shard"] for s in got) == [0, 1]
    names = []
    for s in got:
        assert s["device"] == "cpu" and s["num_shards"] == 2
        idx = split_indices_deterministic(len(ds), 2, s["shard"])
        assert s["images"] == len(idx)
        names += [os.path.splitext(
            ds.image_descriptions[ds.image_ids[i]].file_name)[0] + ".png"
            for i in idx]
    assert len(names) == len(set(names)) == RECORDS
    out = run["cwd"] / "exp" / "t2i" / "samples" / "full"
    for sub in ("sample", "inputs"):
        assert sorted(os.listdir(out / sub)) == sorted(names)
    img = read_png(str(out / "sample" / names[0]))
    assert img.shape == (32, 32, 3)


def test_multishard_fails_when_the_checkpoint_is_missing(runs):
    run = runs["failing"]
    assert run["rc"] != 0
    assert "missing.ckpt: no such file or directory" in run["err"]
    assert "shard 0 of 2 failed" in run["err"]
    assert "shard 1 of 2 failed" in run["err"]
    assert not (run["cwd"] / "exp" / "t2i" / "samples").exists()


def test_training_runbook_through_torchrun(runs):
    run = runs["training"]
    assert run["rc"] == 0, run["err"][-3000:]
    (summ,) = summaries(run["out"], "train summary: ")
    assert summ["steps"] == 1 and summ["world_size"] == 1
    assert summ["device"] == "cpu"
    (logdir,) = (run["cwd"] / "exp_my" / "frido" / "t2i").iterdir()
    assert logdir.name.endswith("_frido_f16f8_coco")
    assert (logdir / "checkpoints" / "step_1").is_dir()
    assert json.loads((logdir / "checkpoints" / "last.json").read_text())[
        "step"] == 1


# ---- the id lists --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in JAX_IDS.iterdir()))
def test_port_id_lists_are_byte_equal(name):
    assert (pathlib.Path(EVAL_IDS) / name).read_bytes() == \
        (JAX_IDS / name).read_bytes()


def strings(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from strings(v)
    elif isinstance(node, list):
        for v in node:
            yield from strings(v)
    elif isinstance(node, str):
        yield node


@pytest.mark.parametrize("config", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml")))
def test_shipped_config_names_no_jax_path(config):
    raw = (REPO / config).read_text()
    cfg = load_configs([str(REPO / config)])
    for s in strings(cfg):
        assert "frido_tpu/" not in s, s
    mapped = [s for s in strings(cfg) if s.startswith(EVAL_IDS)]
    assert len(mapped) == raw.count("frido_tpu/data/eval_ids/")
    assert all(os.path.isfile(s) for s in mapped)


def test_unknown_id_file_is_named():
    with pytest.raises(FileNotFoundError, match="image_ids_nowhere.txt"):
        load_configs([str(REPO / T2I)], dotlist=[
            "data.params.test.params.img_id_file="
            "frido_tpu/data/eval_ids/image_ids_nowhere.txt"])


def coco2017_tree(root):
    """A COCO-2017 validation tree of three images named in the layout2i
    mini-val id list and one not, three person/dog boxes each."""
    jpeg = sorted(p for p in pathlib.Path(FIXTURES).iterdir()
                  if p.suffix == ".jpg")[0]
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    images, anns = [], []
    for k, image_id in enumerate((1000, 100238, 100274, 999)):
        name = f"{image_id:012d}.jpg"
        shutil.copyfile(jpeg, root / "val2017" / name)
        images.append({"id": image_id, "file_name": name, "width": 64,
                       "height": 48, "coco_url": ""})
        for j in range(3):
            anns.append({"id": 10 * k + j, "image_id": image_id,
                         "category_id": 1 + 17 * (j % 2), "iscrowd": 0,
                         "bbox": [4 * j, 4, 24, 20]})
    cats = [{"id": 1, "name": "person", "supercategory": "person"},
            {"id": 18, "name": "dog", "supercategory": "animal"}]
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    with open(root / "annotations" / "stuff_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": [], "categories": []},
                  f)
    return root


def test_layout2i_mini_test_split_reads_no_jax_file(tmp_path, monkeypatch):
    tree = coco2017_tree(tmp_path / "coco" / "2017")
    jax_root = str(REPO / "frido_tpu") + os.sep
    opened = []

    def guarded(real):
        def open_(file, *args, **kwargs):
            if isinstance(file, (str, bytes, os.PathLike)):
                path = os.path.realpath(os.fsdecode(file))
                if path.startswith(jax_root):
                    raise PermissionError(f"opened {path}")
                opened.append(path)
            return real(file, *args, **kwargs)
        return open_

    monkeypatch.setattr(builtins, "open", guarded(builtins.open))
    monkeypatch.setattr(io, "open", guarded(io.open))
    cfg = load_configs(
        [str(REPO / "configs/frido/layout2i/frido_f8f4_coco_seg_mini.yaml")],
        dotlist=[f"data.params.test.params.data_path={tree}",
                 "data.params.test.params.target_image_size=32"])
    ds = instantiate_from_config(cfg["data"]["params"]["test"],
                                 device="cpu")
    assert sorted(ds.image_ids) == ["1000", "100238", "100274"]
    sample = ds.load(ds.plan(0))
    assert tuple(sample["image"].shape) == (32, 32, 3)
    assert os.path.join(EVAL_IDS, "image_ids_layout2i_coco_mini.txt") \
        in opened
    assert os.path.join(EVAL_IDS, "classes_coco.csv") in opened


# ---- the notebook ----------------------------------------------------------

def notebook_cells():
    nb = json.loads(NOTEBOOK.read_text())
    return nb["cells"]


def test_notebook_imports_neither_jax_nor_pil():
    codes = [c for c in notebook_cells() if c["cell_type"] == "code"]
    for cell in codes:
        for node in ast.walk(ast.parse("".join(cell["source"]))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "frido_tpu", "PIL")
    # the first code cell is the settings, as plain assignments
    first = ast.parse("".join(codes[0]["source"]))
    assert all(isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
               for n in first.body)
    assert {n.targets[0].id for n in first.body} >= {
        "CONFIG", "CKPT", "PROMPT", "BATCH", "STEPS", "DEVICE"}
    last = notebook_cells()[-1]
    text = "".join(last["source"])
    assert last["cell_type"] == "markdown"
    assert "python -m frido_tpu_torch.cli.sample_diffusion" in text
    assert "--prompt" in text


def test_notebook_cells_on_the_cpu(toy, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", str(toy["vocab"]))
    codes = ["".join(c["source"]) for c in notebook_cells()
             if c["cell_type"] == "code"]
    ns = {}
    exec(codes[0], ns)
    ns.update(CONFIG=str(toy["config"]), CKPT="", STEPS=4, DEVICE="cpu",
              OUT=str(tmp_path / "demo"))
    for code in codes[1:]:
        exec(code, ns)
    samples, grid = ns["samples"], ns["grid"]
    batch = ns["BATCH"]
    assert samples.shape == (batch, 32, 32, 3)
    assert np.isfinite(samples).all()
    assert grid.shape == (32, 32 * batch, 3) and grid.dtype == np.uint8
    assert np.array_equal(read_png(str(tmp_path / "demo" / "grid.png")),
                          grid)


def test_notebook_refuses_a_missing_checkpoint(toy, tmp_path, monkeypatch):
    """An empty CKPT means random weights; one that names no file stops
    the build cell, as the sampling CLI's ``-r`` does."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    codes = ["".join(c["source"]) for c in notebook_cells()
             if c["cell_type"] == "code"]
    ns = {}
    exec(codes[0], ns)
    assert ns["CKPT"] == ""
    ns.update(CONFIG=str(toy["config"]), CKPT=str(tmp_path / "none.ckpt"),
              DEVICE="cpu")
    with pytest.raises(FileNotFoundError, match="none.ckpt"):
        exec(codes[1], ns)
    assert "model" not in ns
