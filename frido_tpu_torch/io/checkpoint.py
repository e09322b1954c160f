"""Train-state checkpoints and auto-resume (port of
``frido_tpu/io/checkpoint.py``), in torch's format.

The JAX package writes orbax directories; the port writes the same
layout with ``torch.save`` inside: ``<ckpt_dir>/step_N/state.pt`` for a
train state, a ``last.json`` pointer (``{"step", "path", ...meta}``) moved
by every save, the newest ``keep`` ``step_N`` kept, and a tagged copy
(``<ckpt_dir>/<tag>/state.pt`` + ``<tag>.json``, e.g. ``best``) that is
never pruned and does not move ``last``. ``find_resume`` scans a log root
for the newest run of a name with a ``last`` pointer.

A train state (:func:`train_state`) holds a ``DiffusionTrainer``'s whole
state: the model's ``state_dict`` (``params``), the EMA of the denoiser
wrapper (``ema``, keys relative to ``model.model``) and its counter, the
AdamW moments and counts (and ``MultiSteps``' accumulator), the step; or
a ``VQGANTrainer``'s (``VQGANTrainer.state``: both networks, both Adam
states, the step). :func:`restore_train_state` puts one back into a
trainer. A params-only
checkpoint (:func:`save_params`) is ``<path>/params.pt``.

Sharded training (``DiffusionTrainer.sharding``: tensor parallelism,
FSDP): :func:`train_state` gathers every part into the full tensors on
every rank (a collective: every rank calls it) and returns the state on
rank 0 alone, so rank 0 writes the format above; ``load_state`` gives each
rank its parts of the full tensors again. The JAX package saves
``jax.device_get(state)``, full arrays, alike: an ``--fsdp`` run's
``last`` resumes without ``--fsdp``, and the reverse.

The port reads no orbax directory itself: ``tools/export_jax_checkpoint.py``
exports one to numpy files where orbax is, and
``tools/import_jax_run.py`` writes that export in this format (the legacy
layout whose EMA shadowed the whole model, ``checkpoint.py:97-111``,
included: ``io/jax_weights.denoiser_ema``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _cpu(tree: Any) -> Any:
    """``tree`` with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """A state dict (e.g. a model's) to ``<path>/params.pt``."""
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu(dict(params)), os.path.join(path, PARAMS_FILE))


def restore_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load ``<path>/params.pt`` into ``module`` strictly; returns it."""
    module.load_state_dict(restore_raw(path), strict=True)
    return module


def restore_raw(path: str) -> Dict[str, Any]:
    """What a checkpoint directory holds, without a target: a train
    state's dict (``step_N``, a tag) or a params-only state dict. The
    sampling CLI reads the EMA out of a train state this way, without
    building an optimizer."""
    for name in (STATE_FILE, PARAMS_FILE):
        file = os.path.join(path, name)
        if os.path.exists(file):
            return torch.load(file, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no {STATE_FILE} or {PARAMS_FILE} in {path}")


def train_state(trainer) -> Optional[Dict[str, Any]]:
    """A ``DiffusionTrainer``'s state as one dict of CPU tensors, in the
    layout ``DiffusionTrainer.load_state`` takes (full tensors; under
    sharded state every rank calls it and rank 0 alone gets the dict,
    the others None); a ``VQGANTrainer``'s (``VQGANTrainer.state``)
    likewise."""
    if hasattr(trainer, "state"):
        return _cpu(trainer.state())
    opt = trainer.optimizer
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    states = {names[id(p)]: opt._state(p) for p in params}
    sharding = getattr(trainer, "sharding", None)

    def full(part: Dict[str, torch.Tensor], prefix: str = ""):
        if sharding is None:
            return part
        return {k: sharding.full(prefix + k, v) for k, v in part.items()}

    acc = ({n: st["acc"] for n, st in states.items()}
           if opt.every_k > 1 else None)
    state = {
        "params": full(trainer.model.state_dict()),
        "ema": full(dict(trainer.ema.shadow), "model."),
        "ema_updates": trainer.ema.num_updates,
        "step": trainer.step,
        "adam": {
            "count": opt.count,
            "mu": full({n: st["mu"] for n, st in states.items()}),
            "nu": full({n: st["nu"] for n, st in states.items()}),
            "mini_step": opt.mini_step if acc is not None else None,
            "acc": None if acc is None else full(acc),
        },
    }
    if sharding is not None and sharding.layout.rank != 0:
        return None
    return _cpu(state)


def _save_state(path: str, state: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, STATE_FILE))


def save_train_state(ckpt_dir: str, step: int, state: Dict[str, Any],
                     keep: int = 3, tag: str = "",
                     meta: Optional[dict] = None) -> str:
    """Save ``state`` (:func:`train_state`) under ``ckpt_dir/step_N``,
    point ``last.json`` at it and prune all but the newest ``keep``
    ``step_N``; returns the path.

    ``tag``: save under ``ckpt_dir/<tag>`` instead (e.g. ``best``, the
    monitor's pick), with ``<tag>.json``; not pruned, ``last`` unmoved.
    ``meta``: extra JSON fields of the pointer file (e.g. a loader's
    epoch and cursor)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = tag or f"step_{step}"
    path = os.path.join(ckpt_dir, name)
    _save_state(path, state)
    with open(os.path.join(ckpt_dir, f"{tag or 'last'}.json"), "w") as f:
        json.dump({"step": step, "path": path, **(meta or {})}, f)
    if tag:
        return path
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.match(r"step_(\d+)$", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    return path


def read_last_meta(ckpt_dir: str) -> dict:
    """The ``last`` pointer's JSON (step, path and any extra meta)."""
    with open(os.path.join(ckpt_dir, "last.json")) as f:
        return json.load(f)


def restore_train_state(ckpt_dir: str, trainer,
                        step: Optional[int] = None) -> int:
    """Put ``ckpt_dir/step_N`` (``step``, else the ``last`` pointer's)
    back into ``trainer`` (weights, EMA and counter, AdamW state, step);
    returns the step."""
    if step is None:
        step = read_last_meta(ckpt_dir)["step"]
    trainer.load_state(restore_raw(os.path.join(ckpt_dir, f"step_{step}")))
    return step


def find_resume(log_root: str, name: str) -> Optional[str]:
    """The newest run directory under ``log_root`` whose name contains
    ``name`` and whose ``checkpoints/`` has a ``last`` pointer, else
    None."""
    if not os.path.isdir(log_root):
        return None
    candidates = [
        os.path.join(log_root, d) for d in os.listdir(log_root)
        if name in d and os.path.exists(
            os.path.join(log_root, d, "checkpoints", "last.json"))]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)
