"""Lightning / torch checkpoints -> the port's modules (port of
``frido_tpu/io/torch_import.py``).

A reference Lightning ``.ckpt`` holds ``state_dict`` with the key tree
``model.diffusion_model.*``, ``first_stage_model.*``,
``cond_stage_model.*``, the EMA's flat ``model_ema.*`` names, the schedule
buffers and ``scale_factor``. The port's modules carry that key tree
(``io/jax_weights.py``) in torch's layouts, so names map one to one and no
tensor is transposed: :func:`load_state_dict` copies each of a module's
tensors from ``prefix + name``, with shape checks, and reports what it
used and what was missing. The one layout the port changes is ActNorm's:
its ``loc`` and ``scale`` are [C] here and [1, C, 1, 1] in torch, and are
reshaped, as the JAX importer does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

_ACTNORM_LEAVES = ("loc", "scale")


def _to_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.asarray(value))


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The flat name -> tensor dict of a torch/Lightning ``.ckpt`` (its
    ``state_dict`` when it has one), on the CPU. Lightning pickles its
    hyper-parameters, which ``torch.load``'s ``weights_only`` default
    refuses, hence ``weights_only=False``: load only trusted files."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _to_tensor(v) for k, v in sd.items()}


def subdict(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries under ``prefix``, with the prefix stripped."""
    n = len(prefix)
    return {k[n:]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _fit(value: torch.Tensor, want: torch.Tensor, key: str) -> torch.Tensor:
    """``value`` in ``want``'s shape, or a shape error."""
    if tuple(value.shape) == tuple(want.shape):
        return value
    if (key.rsplit(".", 1)[-1] in _ACTNORM_LEAVES and want.dim() == 1
            and value.numel() == want.numel()):
        return value.reshape(want.shape)       # ActNorm [1, C, 1, 1] -> [C]
    raise ValueError(f"shape mismatch for {key}: checkpoint "
                     f"{tuple(value.shape)} vs port {tuple(want.shape)}")


@torch.no_grad()
def load_state_dict(module: nn.Module, state_dict: Mapping[str, Any],
                    prefix: str = "", strict: bool = True,
                    report: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Fill every tensor of ``module.state_dict()`` from
    ``state_dict[prefix + name]`` in place, cast to the tensor's dtype.

    Shape mismatches always raise; a missing key raises under ``strict``
    and otherwise keeps the module's value. ``report`` (a dict) gets
    ``used`` (the set of checkpoint keys consumed) and ``missing`` (the
    list of expected keys absent), as the JAX importer's."""
    used, missing = set(), []
    for name, tensor in module.state_dict(keep_vars=True).items():
        key = prefix + name
        if key not in state_dict:
            missing.append(key)
            continue
        used.add(key)
        value = _fit(_to_tensor(state_dict[key]), tensor, key)
        tensor.data.copy_(value.to(tensor.dtype))
    if report is not None:
        report["used"] = used
        report["missing"] = list(missing)
    if missing and strict:
        raise KeyError(f"{len(missing)} keys missing from state_dict: "
                       f"{missing[:10]}...")
    return module
