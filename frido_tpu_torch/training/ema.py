"""Exponential moving average of a module's parameters (port of
``frido_tpu/training/ema.py``, the reference's ``LitEma``).

The shadow holds copies (never aliases) of the parameters. Each update
increments the counter first and then moves the shadow toward the
parameters with the decay ramp ``min(decay, (1 + n) / (10 + n))``:
``s <- s - (1 - d) (s - p)``. ``scope()`` swaps the shadow into the module
for the block and restores the trained weights after it: the JAX package's
``ema_full_params``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

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
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            torch._foreach_copy_(params, shadow)
        try:
            yield self.module
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, saved)
