"""JAX variables tree -> the port's ``state_dict``.

The JAX package names its flax modules after the original torch key tree
with ``__`` in place of ``.`` (``frido_tpu/io/torch_import.py:45-55``), and
the port's modules carry that torch tree, so the mapping is mechanical:

==============  ============================  ==========================
flax leaf       port tensor                   conversion
==============  ============================  ==========================
kernel (4-d)    Conv2d  [O, I, kH, kW]        HWIO -> OIHW
kernel_t        ConvTranspose2d [I, O, k, k]  flip H, W; HWIO -> IOHW
kernel (3-d)    Conv1d  [O, I, k]             kIO  -> OIk
kernel (2-d)    Dense   [O, I]                [I, O] -> [O, I]
scale           norm ``weight``               as-is
embedding       Embed ``weight``              as-is
bias            ``bias``                      as-is
logvar          FridoDiffusion ``logvar``     as-is (``learn_logvar``)
loc, scale_v    ActNorm ``loc``, ``scale``    as-is
class_embedding CLIP ``class_embedding``      as-is
==============  ============================  ==========================

A leaf may carry nesting of its own, as the CLIP vision tower's direct
parameter ``embeddings__class_embedding``: only its last segment is the
leaf name, the others are modules
(``frido_tpu/io/torch_import.py:48-52``).

``kernel_t`` is the JAX ``ConvTranspose2d``'s input-dilated conv kernel,
``kernel_t[h, w, ci, co] = W_torch[ci, co, k-1-h, k-1-w]``: a plain
transpose would give a kernel of the right shape turned by 180 degrees.

The ``ema`` variable collection (``EMAVectorQuantizer``'s ``embedding``,
``cluster_size`` and ``embed_avg``) and the ``batch_stats`` collection
(the discriminator's ``running_mean`` and ``running_var``) map onto
buffers of the same names, as-is. Every leaf is mapped; none is dropped.

:func:`jax_train_state_to_port` carries a JAX diffusion ``TrainState``
(``frido_tpu/training/trainer.py``) across: the weights, the EMA of
``params["params"]["model"]`` and its counter, the optax AdamW moments and
update count (and ``MultiSteps``' running mean), and the step;
:func:`jax_vqgan_state_to_port` an MS-VQGAN ``VQGANTrainState``. Both read
a live state or the raw tree of an orbax restore without a template (what
``io/jax_export.py`` rebuilds from an export), and the diffusion one also
the legacy layout whose EMA shadows the whole params tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

LEAF_TO_TORCH = {"kernel": "weight", "kernel_t": "weight", "scale": "weight",
                 "bias": "bias", "embedding": "weight", "logvar": "logvar",
                 "loc": "loc", "scale_v": "scale",
                 "class_embedding": "class_embedding"}
COLLECTIONS = ("params", "ema", "batch_stats")


def torch_key(path: Tuple[str, ...], collection: str = "params") -> str:
    """('down__0__block__1', 'norm1', 'scale') ->
    'down.0.block.1.norm1.weight'; leaves of the ``ema`` and
    ``batch_stats`` collections keep their names."""
    parts = []
    for comp in path[:-1]:
        parts.extend(comp.split("__"))
    *mods, leaf = path[-1].split("__")
    parts.extend(mods)
    parts.append(leaf if collection != "params" else LEAF_TO_TORCH[leaf])
    return ".".join(parts)


def leaf_name(path: Tuple[str, ...]) -> str:
    """The leaf name of a flax path: the last ``__`` segment of its last
    component."""
    return path[-1].split("__")[-1]


def to_torch_layout(value: np.ndarray, leaf: str) -> np.ndarray:
    v = np.asarray(value)
    if leaf == "kernel_t":
        return v[::-1, ::-1].transpose(2, 3, 0, 1)
    if leaf == "kernel":
        if v.ndim == 4:
            return v.transpose(3, 2, 0, 1)
        if v.ndim == 3:
            return v.transpose(2, 1, 0)
        if v.ndim == 2:
            return v.transpose(1, 0)
    return v


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(variables: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """State dict of numpy arrays in torch layout.

    ``variables`` is a flax variables dict (``{"params": ...}``, with or
    without ``"ema"``) or the bare params tree. Arrays are returned as views
    where the conversion is a transpose or a flip.
    """
    if variables and set(variables) <= set(COLLECTIONS):
        trees = [(c, variables[c]) for c in COLLECTIONS if c in variables]
    else:
        trees = [("params", variables)]
    state = {}
    for collection, tree in trees:
        for path, value in _leaves(tree):
            if collection == "params" and leaf_name(path) not in \
                    LEAF_TO_TORCH:
                raise KeyError(f"no port mapping for flax leaf "
                               f"{'/'.join(path)}")
            key = torch_key(path, collection)
            if key in state:
                raise KeyError(f"two JAX leaves map onto {key}")
            state[key] = to_torch_layout(value, leaf_name(path))
    return state


def load_jax_params(module: torch.nn.Module,
                    variables: Mapping[str, Any]) -> None:
    """Load a JAX variables tree into ``module`` with ``strict=True``: every
    leaf has its tensor, every tensor its leaf."""
    state = jax_params_to_state_dict(variables)
    tensors = {k: torch.from_numpy(np.array(v, np.float32))
               for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)


def _arrays(tree: Any) -> Any:
    """``tree`` without its non-array leaves (optax's ``MaskedNode`` at
    the frozen leaves) and the subtrees they leave empty."""
    if isinstance(tree, Mapping):
        out = {k: _arrays(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree if hasattr(tree, "shape") else None


def _get(node: Any, name: str) -> Any:
    """A field of an optax state node: an attribute of a live state (named
    tuples, flax dataclasses) or a key of the raw dict an orbax restore
    without a template gives."""
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _has(node: Any, name: str) -> bool:
    return name in node if isinstance(node, Mapping) else hasattr(node, name)


def _find(tree: Any, fields: Tuple[str, ...]) -> Any:
    """The first node of an optax state that has every field in
    ``fields``: live (nested named tuples, tuples and dicts) or raw (an
    orbax restore without a template: dicts by field name, lists for
    chains, ``None`` for empty states and ``MaskedNode`` leaves)."""
    if tree is None:
        return None
    if all(_has(tree, f) for f in fields):
        return tree
    children = (tree.values() if isinstance(tree, Mapping) else
                tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def _state_dict(tree: Any) -> Dict[str, np.ndarray]:
    """Arrays of a params-shaped tree in torch layout, fp32."""
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(_arrays(tree)).items()}


def _adam(opt_state: Any, what: str) -> Dict[str, Any]:
    adam = _find(opt_state, ("mu", "nu", "count"))
    if adam is None:
        raise ValueError(f"no Adam state in the {what}")
    return {"count": int(np.asarray(_get(adam, "count"))),
            "mu": _state_dict(_get(adam, "mu")),
            "nu": _state_dict(_get(adam, "nu"))}


def denoiser_ema(state: Any) -> Any:
    """The EMA of the denoiser wrapper. A legacy train state's EMA
    shadowed the whole params tree (``{"params": {"model": ...}}``); its
    denoiser subtree is sliced out, as ``frido_tpu/io/checkpoint.py``'s
    ``restore_train_state`` does."""
    ema = _get(state, "ema_params")
    inner = ema.get("params") if isinstance(ema, Mapping) else None
    if isinstance(inner, Mapping) and "model" in inner:
        return inner["model"]
    return ema


def jax_train_state_to_port(state: Any) -> Dict[str, Any]:
    """A JAX diffusion ``TrainState`` as plain numpy: ``params`` (the
    whole model's state dict), ``ema`` (the denoiser wrapper's, keys
    relative to ``model.model``), ``ema_updates``, ``step`` and ``adam``:
    ``count``, ``mu`` and ``nu`` (state dicts of the trainable tensors),
    and with ``MultiSteps`` ``mini_step`` and ``acc``, else None. Read
    from the optax state by field names, without importing optax.

    ``state`` is a live ``TrainState`` or the raw tree of an orbax
    restore without a template (``io/jax_export.py``), in the current
    layout or the legacy one whose EMA shadows the whole params tree."""
    multi = _find(_get(state, "opt_state"), ("mini_step", "acc_grads"))
    adam = _adam(_get(state, "opt_state"), "TrainState's opt_state")
    adam.update(
        mini_step=(None if multi is None
                   else int(np.asarray(_get(multi, "mini_step")))),
        acc=(None if multi is None
             else _state_dict(_get(multi, "acc_grads"))))
    return {
        "params": _state_dict(_get(state, "params")),
        "ema": _state_dict(denoiser_ema(state)),
        "ema_updates": int(np.asarray(_get(state, "ema_updates"))),
        "step": int(np.asarray(_get(state, "step"))),
        "adam": adam,
    }


def jax_vqgan_state_to_port(state: Any) -> Dict[str, Any]:
    """A JAX MS-VQGAN ``VQGANTrainState`` (``params_g``, ``vars_d``,
    ``opt_g``, ``opt_d``, ``step``; live or raw) as plain numpy, in the
    layout of ``VQGANTrainer.state``: ``model`` (the generator's state
    dict: its ``params``, ``ema`` and ``batch_stats`` collections),
    ``loss`` (the loss module's: the discriminator's weights and BatchNorm
    statistics), ``opt_g`` and ``opt_d`` (Adam ``count``, ``mu``,
    ``nu``), ``step``."""
    return {"model": _state_dict(_get(state, "params_g")),
            "loss": _state_dict(_get(state, "vars_d")),
            "opt_g": _adam(_get(state, "opt_g"), "generator's opt_g"),
            "opt_d": _adam(_get(state, "opt_d"), "discriminator's opt_d"),
            "step": int(np.asarray(_get(state, "step")))}
