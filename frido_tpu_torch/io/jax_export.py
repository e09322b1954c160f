"""Read a JAX checkpoint export (``tools/export_jax_checkpoint.py``) with
numpy and torch only.

The JAX package saves orbax directories, whose data the card's machine
cannot read (no orbax, no zstd, no JAX). The export tool, run where orbax
is, writes ``arrays.npz`` (every array leaf under its ``/``-joined path),
``tree.json`` (the nesting, ``None`` and empty nodes, dtypes and shapes,
the kind of state, the legacy EMA flag), ``meta.json`` (the ``last.json``
fields: step, epoch, batch_in_epoch) and the run's ``configs/``.

:func:`read_export` rebuilds the raw tree as orbax's ``restore_raw`` gives
it (dicts, lists, tuples and ``None``; bfloat16 leaves, stored as their
uint16 bit patterns, come back as the fp32 arrays of the same values, which
is lossless), and :func:`to_port` carries it across with
``io/jax_weights.py``: a diffusion train state by
``jax_train_state_to_port``, an MS-VQGAN train state by
``jax_vqgan_state_to_port``, a params tree by ``jax_params_to_state_dict``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            jax_train_state_to_port,
                                            jax_vqgan_state_to_port)

FORMAT = 1
KINDS = ("train_state", "vqgan_state", "params")


@dataclass
class JaxExport:
    """An export directory, read: the raw JAX tree and what came with
    it."""
    path: str
    kind: str
    tree: Any
    legacy_ema: bool
    meta: Optional[dict]
    configs: List[str] = field(default_factory=list)
    dtypes: Dict[str, str] = field(default_factory=dict)
    scale_factors: Optional[str] = None


def bf16_bits_to_fp32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the fp32 array of the same values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _decode(node: dict, arrays, dtypes: Dict[str, str]) -> Any:
    kind = node["type"]
    if kind == "dict":
        return {k: _decode(v, arrays, dtypes)
                for k, v in node["items"].items()}
    if kind in ("list", "tuple"):
        items = [_decode(v, arrays, dtypes) for v in node["items"]]
        return items if kind == "list" else tuple(items)
    if kind == "none":
        return None
    if kind != "array":
        raise ValueError(f"unknown node type {kind!r} in tree.json")
    a = arrays[node["key"]]
    if node["dtype"] == "bfloat16":
        a = bf16_bits_to_fp32(a)
    elif a.dtype.name != node["dtype"]:
        raise ValueError(f"{node['key']}: {a.dtype} in arrays.npz, "
                         f"{node['dtype']} in tree.json")
    if list(a.shape) != node["shape"]:
        raise ValueError(f"{node['key']}: shape {a.shape} in arrays.npz, "
                         f"{node['shape']} in tree.json")
    dtypes[node["key"]] = node["dtype"]
    return a


def read_export(path: str) -> JaxExport:
    """The export at ``path``: its tree rebuilt, its meta and configs."""
    with open(os.path.join(path, "tree.json")) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT or doc.get("kind") not in KINDS:
        raise ValueError(f"{path}: not a JAX checkpoint export of format "
                         f"{FORMAT} (format {doc.get('format')}, kind "
                         f"{doc.get('kind')})")
    dtypes: Dict[str, str] = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        tree = _decode(doc["tree"], arrays, dtypes)
    meta = None
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    cdir = os.path.join(path, "configs")
    configs = (sorted(os.path.join(cdir, c) for c in os.listdir(cdir)
                      if c.endswith(".yaml")) if os.path.isdir(cdir) else [])
    sf = os.path.join(path, "scale_factors.json")
    return JaxExport(path=path, kind=doc["kind"], tree=tree,
                     legacy_ema=bool(doc.get("legacy_ema")), meta=meta,
                     configs=configs, dtypes=dtypes,
                     scale_factors=sf if os.path.exists(sf) else None)


def to_port(export: JaxExport) -> Dict[str, Any]:
    """The export in the port's layout, numpy arrays: a diffusion train
    state as ``DiffusionTrainer.load_state`` takes it, an MS-VQGAN state
    as ``VQGANTrainer.load_state`` takes it (after :func:`tensors`), a
    params tree as a model's state dict."""
    if export.kind == "train_state":
        return jax_train_state_to_port(export.tree)
    if export.kind == "vqgan_state":
        return jax_vqgan_state_to_port(export.tree)
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(export.tree).items()}


def tensors(tree: Any) -> Any:
    """``tree`` with every numpy array a CPU tensor (what ``torch.save``
    writes and ``torch.load(weights_only=True)`` reads back)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.asarray(tree, order="C"))
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return tree
