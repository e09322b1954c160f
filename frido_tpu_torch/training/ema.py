"""Exponential moving average of a module's parameters (port of
``frido_tpu/training/ema.py``, the reference's ``LitEma``).

The shadow holds copies (never aliases) of the parameters. Each update
increments the counter first and then moves the shadow toward the
parameters with the decay ramp ``min(decay, (1 + n) / (10 + n))``:
``s <- s - (1 - d) (s - p)``. ``scope()`` swaps the shadow into the module
for the block and restores the trained weights after it: the JAX package's
``ema_full_params``. Under sharded state the shadow lives on the same parts
as the parameters (``parallel/fsdp.py``): ``scope()`` swaps the shadow's
parts in, and each FSDP unit gathers them when it is called, block by
block; nothing gathers the whole shadow.

:func:`import_ema` reads the reference ``LitEma``'s flat buffer names out
of a Lightning checkpoint (``model_ema.`` + the denoiser wrapper's
parameter name without its dots).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


class EMA:
    """Shadow of ``module``'s parameters, keyed by their names."""

    def __init__(self, module: nn.Module, decay: float = 0.9999):
        self.module = module
        self.decay = decay
        self.num_updates = 0
        self.shadow: Dict[str, torch.Tensor] = {
            name: p.detach().clone() for name, p in module.named_parameters()}

    def _pairs(self):
        params = dict(self.module.named_parameters())
        names = list(self.shadow)
        return [self.shadow[n] for n in names], [params[n] for n in names]

    @torch.no_grad()
    def update(self) -> None:
        self.num_updates += 1
        n = np.float32(self.num_updates)
        # the ramp in fp32, as the JAX package computes it
        d = min(np.float32(self.decay), (np.float32(1) + n)
                / (np.float32(10) + n))
        shadow, params = self._pairs()
        diff = torch._foreach_sub(shadow, params)
        torch._foreach_mul_(diff, float(np.float32(1) - d))
        torch._foreach_sub_(shadow, diff)

    @contextlib.contextmanager
    def scope(self) -> Iterator[nn.Module]:
        """The module with the shadow weights inside the block; its own
        weights come back after it, also on an error."""
        shadow, params = self._pairs()
        saved = [p.data for p in params]
        for p, s in zip(params, shadow):
            p.data = s.clone()
        try:
            yield self.module
        finally:
            for p, s in zip(params, saved):
                p.data = s


def import_ema(module: nn.Module, state_dict: Mapping[str, Any],
               prefix: str = "model_ema.", torch_prefix: str = "model.",
               report: Optional[Dict[str, Any]] = None
               ) -> Dict[str, torch.Tensor]:
    """The EMA of ``module`` (the denoiser wrapper ``model.model``) from a
    checkpoint's ``model_ema.*`` buffers, as a dict of its parameter names
    -> tensors in their dtype.

    LitEma names the shadow of ``model.diffusion_model.a.0.b.weight``
    ``model_ema.diffusion_modela0bweight``: the parameter's full name
    (``torch_prefix`` + its name in ``module``) without dots, less the
    leading ``model``. A parameter without its flat name keeps its current
    value. ``report`` gets ``used`` and ``missing``, as
    ``io.torch_import.load_state_dict``'s."""
    from frido_tpu_torch.io.torch_import import _fit, _to_tensor

    used, missing, out = set(), [], {}
    for name, p in module.named_parameters():
        torch_key = torch_prefix + name
        flat = prefix + torch_key.replace(".", "")[len("model"):]
        if flat in state_dict:
            used.add(flat)
            out[name] = _fit(_to_tensor(state_dict[flat]), p, torch_key).to(
                p.dtype)
        else:
            missing.append(flat)
            out[name] = p.detach().clone()
    if report is not None:
        report["used"] = used
        report["missing"] = missing
    return out
