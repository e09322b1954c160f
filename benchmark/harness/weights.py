"""The seeded weights both sides load: one state dict made on the device
from the seed, by the reference model's own structure.

One ``torch.randn`` call draws every element; each tensor is a view of
that draw, scaled by its kind: a conv or dense weight by 1/sqrt(fan in)
(the layers the configuration starts at zero too, so every compared
tensor is non-trivial), a bias by 0.02, a norm's scale as 1 + 0.02 n and
its shift by 0.02, an embedding by 0.02, and a codebook by 1 (codes
spread as widely as the latents they quantize)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from harness.traffic import WEIGHTS, torch_seed
from reference.layers import Embed, GroupNorm, LayerNorm, _Linearish
from reference.vqgan import VectorQuantizer

BIAS_STD = 0.02
NORM_STD = 0.02
EMBED_STD = 0.02


def _rules(model: nn.Module) -> Dict[str, tuple]:
    """(std, mean) of every parameter, by the module that holds it."""
    rules = {}
    codebooks = {id(m.embedding) for m in model.modules()
                 if isinstance(m, VectorQuantizer)}
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, _Linearish):
            w = mod.weight
            fan_in = w.numel() // w.shape[mod.fan_axis]
            rules[prefix + "weight"] = (1.0 / math.sqrt(fan_in), 0.0)
            if mod.bias is not None:
                rules[prefix + "bias"] = (BIAS_STD, 0.0)
        elif isinstance(mod, (GroupNorm, LayerNorm)):
            rules[prefix + "weight"] = (NORM_STD, 1.0)
            rules[prefix + "bias"] = (NORM_STD, 0.0)
        elif isinstance(mod, Embed):
            std = 1.0 if id(mod) in codebooks else EMBED_STD
            rules[prefix + "weight"] = (std, 0.0)
    return rules


def state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` (the reference, on any device, ``meta``
    included), drawn on ``device`` from ``seed``."""
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    rules = _rules(model)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        std, mean = rules[name]
        t = flat[off:off + n].view(shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += n
    return out
