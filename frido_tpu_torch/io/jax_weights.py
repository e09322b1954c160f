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
==============  ============================  ==========================

``kernel_t`` is the JAX ``ConvTranspose2d``'s input-dilated conv kernel,
``kernel_t[h, w, ci, co] = W_torch[ci, co, k-1-h, k-1-w]``: a plain
transpose would give a kernel of the right shape turned by 180 degrees.

The ``ema`` variable collection (``EMAVectorQuantizer``'s ``embedding``,
``cluster_size`` and ``embed_avg``) maps onto buffers of the same names,
as-is. Every leaf is mapped; none is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

LEAF_TO_TORCH = {"kernel": "weight", "kernel_t": "weight", "scale": "weight",
                 "bias": "bias", "embedding": "weight"}
COLLECTIONS = ("params", "ema")


def torch_key(path: Tuple[str, ...], collection: str = "params") -> str:
    """('down__0__block__1', 'norm1', 'scale') ->
    'down.0.block.1.norm1.weight'; leaves of the ``ema`` collection keep
    their names."""
    parts = []
    for comp in path[:-1]:
        parts.extend(comp.split("__"))
    leaf = path[-1]
    parts.append(leaf if collection == "ema" else LEAF_TO_TORCH[leaf])
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
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
               for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
