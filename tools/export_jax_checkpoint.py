#!/usr/bin/env python
"""Export a JAX package checkpoint (orbax) as numpy files that the PyTorch
port reads without orbax, zstd or JAX.

    python tools/export_jax_checkpoint.py SRC OUT

Run it where the JAX package and orbax are installed (the TPU host). SRC
is one of:

- a run directory of ``main.py`` or ``scripts/train_msvqgan.py`` (it holds
  ``checkpoints/last.json``), or its ``checkpoints/`` directory: the
  checkpoint that ``last.json`` names;
- a ``step_N/`` or a tagged (``best/``) train-state directory;
- a ``save_params`` directory (params only).

Each is read with ``frido_tpu.io.checkpoint.restore_raw`` (no template:
nested dicts and lists of numpy arrays, ``None`` for optax's empty states
and for ``MaskedNode`` leaves). OUT receives:

- ``arrays.npz``: every array leaf under its ``/``-joined path, list
  indices included (``opt_state/inner_states/train/inner_state/0/mu/...``);
- ``tree.json``: ``kind`` (``train_state``, ``vqgan_state`` or
  ``params``), ``legacy_ema`` (a train state whose ``ema_params`` is the
  whole params tree, the layout ``restore_train_state`` still reads), and
  ``tree``, the structure: each node ``{"type": "dict", "items": {...}}``,
  ``{"type": "list" | "tuple", "items": [...]}``, ``{"type": "none"}``
  or ``{"type": "array", "key": path, "dtype": name, "shape": [...]}``;
- ``meta.json``: the pointer file's fields (``last.json``, or
  ``<tag>.json`` for a tag) without its ``path``: ``step``, and the
  loader's ``epoch`` and ``batch_in_epoch`` where the pointer has them (a
  ``best.json`` has no cursor); ``{"step": N}`` from ``step_N``'s name
  when the pointer names another checkpoint;
- ``configs/``: the run's ``configs/*.yaml`` (``main.py``) or its
  ``config.yaml`` (the MS-VQGAN script), when SRC is in a run;
- ``scale_factors.json`` when the checkpoint directory has one.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit patterns
(the upper half of each fp32 word) with ``"dtype": "bfloat16"`` in
``tree.json``; the reader shifts them back into fp32, which is lossless.

This file imports numpy and the JAX package's checkpoint module only; it
imports neither torch nor the port.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

FORMAT = 1
TRAIN_STATE_KEYS = {"params", "opt_state", "ema_params", "ema_updates",
                    "step"}
VQGAN_STATE_KEYS = {"params_g", "vars_d", "opt_g", "opt_d", "step"}


def _is_orbax_dir(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f))
        for f in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"))


def resolve(src: str) -> Tuple[str, Optional[str], Optional[dict]]:
    """(checkpoint directory, run directory or None, pointer meta or
    None) for any of the accepted forms of ``src``."""
    src = os.path.abspath(src.rstrip("/"))
    for cdir in (os.path.join(src, "checkpoints"), src):
        pointer = os.path.join(cdir, "last.json")
        if not _is_orbax_dir(src) and os.path.exists(pointer):
            with open(pointer) as f:
                meta = json.load(f)
            ckpt = os.path.join(cdir, os.path.basename(
                meta["path"].rstrip("/")))
            if not os.path.isdir(ckpt):
                ckpt = meta["path"]
            return ckpt, os.path.dirname(cdir), meta
    if not _is_orbax_dir(src):
        raise FileNotFoundError(f"{src} is neither an orbax checkpoint nor "
                                f"a run with checkpoints/last.json")
    cdir, name = os.path.split(src)
    for pointer in (f"{name}.json", "last.json"):
        file = os.path.join(cdir, pointer)
        if os.path.exists(file):
            with open(file) as f:
                meta = json.load(f)
            if os.path.basename(meta.get("path", "").rstrip("/")) == name:
                break
    else:
        m = re.match(r"step_(\d+)$", name)
        meta = {"step": int(m.group(1))} if m else None
    run = os.path.dirname(cdir) if os.path.basename(cdir) == \
        "checkpoints" else None
    return src, run, meta


def kind_of(tree: Any) -> str:
    if isinstance(tree, dict) and TRAIN_STATE_KEYS <= set(tree):
        return "train_state"
    if isinstance(tree, dict) and VQGAN_STATE_KEYS <= set(tree):
        return "vqgan_state"
    return "params"


def is_legacy_ema(tree: dict) -> bool:
    """``ema_params`` as the whole params tree (``{"params": {"model":
    ...}}``) rather than the denoiser wrapper's subtree."""
    ema = tree.get("ema_params")
    return (isinstance(ema, dict) and isinstance(ema.get("params"), dict)
            and "model" in ema["params"])


def encode(tree: Any, arrays: Dict[str, np.ndarray],
           path: Tuple[str, ...] = ()) -> dict:
    """``tree``'s structure node; its arrays go into ``arrays``."""
    if isinstance(tree, dict):
        return {"type": "dict", "items": {
            str(k): encode(v, arrays, path + (str(k),))
            for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"type": "list" if isinstance(tree, list) else "tuple",
                "items": [encode(v, arrays, path + (str(i),))
                          for i, v in enumerate(tree)]}
    if tree is None:
        return {"type": "none"}
    a = np.asarray(tree)
    key = "/".join(path)
    dtype = a.dtype.name
    if dtype == "bfloat16":
        a = a.view(np.uint16)
    arrays[key] = np.asarray(a, order="C")
    return {"type": "array", "key": key, "dtype": dtype,
            "shape": list(a.shape)}


def config_files(run: Optional[str]) -> List[str]:
    if run is None:
        return []
    files = sorted(glob.glob(os.path.join(run, "configs", "*.yaml")))
    single = os.path.join(run, "config.yaml")
    return files or ([single] if os.path.exists(single) else [])


def export(src: str, out: str) -> dict:
    """Export ``src`` into ``out``; returns the ``tree.json`` dict."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from frido_tpu.io import checkpoint as ckpt_io

    ckpt, run, meta = resolve(src)
    tree = ckpt_io.restore_raw(ckpt)
    kind = kind_of(tree)
    arrays: Dict[str, np.ndarray] = {}
    doc = {"format": FORMAT, "kind": kind,
           "legacy_ema": kind == "train_state" and is_legacy_ema(tree),
           "source": os.path.relpath(ckpt, run) if run
           else os.path.basename(ckpt),
           "tree": encode(tree, arrays)}
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(os.path.join(out, "arrays.npz"), **arrays)
    with open(os.path.join(out, "tree.json"), "w") as f:
        json.dump(doc, f)
    if meta is not None:
        with open(os.path.join(out, "meta.json"), "w") as f:
            json.dump({k: v for k, v in meta.items() if k != "path"}, f)
    files = config_files(run)
    if files:
        os.makedirs(os.path.join(out, "configs"), exist_ok=True)
        for file in files:
            shutil.copy(file, os.path.join(out, "configs",
                                           os.path.basename(file)))
    sf = os.path.join(os.path.dirname(ckpt), "scale_factors.json")
    if os.path.exists(sf):
        shutil.copy(sf, os.path.join(out, "scale_factors.json"))
    return doc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="run dir, checkpoints/, step_N/, best/ or a "
                               "save_params dir")
    p.add_argument("out", help="the export directory")
    args = p.parse_args(argv)
    doc = export(args.src, args.out)
    n = len(np.load(os.path.join(args.out, "arrays.npz")).files)
    print(f"exported {doc['kind']} from {doc['source']}: {n} arrays"
          f"{' (legacy EMA layout)' if doc['legacy_ema'] else ''} -> "
          f"{args.out}")


if __name__ == "__main__":
    main()
