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
==============  ============================  ==========================

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
update count (and ``MultiSteps``' running mean), and the step.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

LEAF_TO_TORCH = {"kernel": "weight", "kernel_t": "weight", "scale": "weight",
                 "bias": "bias", "embedding": "weight", "logvar": "logvar",
                 "loc": "loc", "scale_v": "scale"}
COLLECTIONS = ("params", "ema", "batch_stats")


def torch_key(path: Tuple[str, ...], collection: str = "params") -> str:
    """('down__0__block__1', 'norm1', 'scale') ->
    'down.0.block.1.norm1.weight'; leaves of the ``ema`` and
    ``batch_stats`` collections keep their names."""
    parts = []
    for comp in path[:-1]:
        parts.extend(comp.split("__"))
    leaf = path[-1]
    parts.append(leaf if collection != "params" else LEAF_TO_TORCH[leaf])
    return ".".join(parts)


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
            if collection == "params" and path[-1] not in LEAF_TO_TORCH:
                raise KeyError(f"no port mapping for flax leaf "
                               f"{'/'.join(path)}")
            key = torch_key(path, collection)
            if key in state:
                raise KeyError(f"two JAX leaves map onto {key}")
            state[key] = to_torch_layout(value, path[-1])
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


def _find(tree: Any, fields: Tuple[str, ...]) -> Any:
    """The first node of an optax state (nested named tuples, tuples and
    dicts) that has every attribute in ``fields``."""
    if all(hasattr(tree, f) for f in fields):
        return tree
    children = (tree.values() if isinstance(tree, Mapping) else
                tree if isinstance(tree, tuple) else ())
    for child in children:
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def _state_dict(tree: Any) -> Dict[str, np.ndarray]:
    """Arrays of a params-shaped tree in torch layout, fp32."""
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(_arrays(tree)).items()}


def jax_train_state_to_port(state: Any) -> Dict[str, Any]:
    """A JAX diffusion ``TrainState`` as plain numpy: ``params`` (the
    whole model's state dict), ``ema`` (the denoiser wrapper's, keys
    relative to ``model.model``), ``ema_updates``, ``step`` and ``adam``:
    ``count``, ``mu`` and ``nu`` (state dicts of the trainable tensors),
    and with ``MultiSteps`` ``mini_step`` and ``acc``, else None. Read
    from the optax state by field names, without importing optax."""
    adam = _find(state.opt_state, ("mu", "nu", "count"))
    multi = _find(state.opt_state, ("mini_step", "acc_grads"))
    if adam is None:
        raise ValueError("no Adam state in the TrainState's opt_state")
    return {
        "params": _state_dict(state.params),
        "ema": _state_dict(state.ema_params),
        "ema_updates": int(np.asarray(state.ema_updates)),
        "step": int(np.asarray(state.step)),
        "adam": {
            "count": int(np.asarray(adam.count)),
            "mu": _state_dict(adam.mu),
            "nu": _state_dict(adam.nu),
            "mini_step": (None if multi is None
                          else int(np.asarray(multi.mini_step))),
            "acc": None if multi is None else _state_dict(multi.acc_grads),
        },
    }
