"""JAX params tree -> the port's ``state_dict``.

The JAX package names its flax modules after the original torch key tree
with ``__`` in place of ``.`` (``frido_tpu/io/torch_import.py:45-55``), and
the port's modules carry that torch tree, so the mapping is mechanical:

==============  =====================  ========================
flax leaf       port tensor            conversion
==============  =====================  ========================
kernel (4-d)    Conv2d  [O, I, kH, kW]  HWIO -> OIHW
kernel (3-d)    Conv1d  [O, I, k]       kIO  -> OIk
kernel (2-d)    Dense   [O, I]          [I, O] -> [O, I]
scale           norm ``weight``         as-is
embedding       Embed ``weight``        as-is
bias            ``bias``                as-is
==============  =====================  ========================

Leaves under the subtrees this slice does not build (the MS-VQGAN encoder
and cross-scale fusion heads) are returned by name as skipped, and
:func:`load_jax_params` warns with their count; no other leaf is dropped.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "embedding": "weight"}

UNBUILT_SUBTREES = (
    "first_stage_model.encoder.",
    "first_stage_model.shared_decoder.",
    "first_stage_model.upsample.",
    "first_stage_model.shared_post_quant_conv.",
    "first_stage_model.ms_quant_conv.",
)


def torch_key(path: Tuple[str, ...]) -> str:
    """('down__0__block__1', 'norm1', 'scale') -> 'down.0.block.1.norm1.weight'."""
    parts = []
    for comp in path[:-1]:
        parts.extend(comp.split("__"))
    parts.append(LEAF_TO_TORCH.get(path[-1], path[-1]))
    return ".".join(parts)


def to_torch_layout(value: np.ndarray, leaf: str) -> np.ndarray:
    v = np.asarray(value)
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


def jax_params_to_state_dict(params: Mapping[str, Any]
                             ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(state dict of numpy arrays in torch layout, skipped torch keys).

    ``params`` is the nested dict of arrays, with or without the outer
    ``{"params": ...}`` level. Arrays are returned as views where the
    conversion is a transpose.
    """
    if set(params) == {"params"}:
        params = params["params"]
    state, skipped = {}, []
    for path, value in _leaves(params):
        key = torch_key(path)
        if key.startswith(UNBUILT_SUBTREES):
            skipped.append(key)
            continue
        if path[-1] not in LEAF_TO_TORCH:
            raise KeyError(f"no port mapping for flax leaf {'/'.join(path)}")
        state[key] = to_torch_layout(value, path[-1])
    return state, skipped


def load_jax_params(module: torch.nn.Module, params: Mapping[str, Any]
                    ) -> List[str]:
    """Load a JAX params tree into ``module`` with ``strict=True``; returns
    the skipped keys (and warns with their count)."""
    state, skipped = jax_params_to_state_dict(params)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
               for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
    if skipped:
        warnings.warn(f"skipped {len(skipped)} JAX leaves of subtrees the "
                      f"port does not build: {sorted(set(UNBUILT_SUBTREES))}")
    return skipped
