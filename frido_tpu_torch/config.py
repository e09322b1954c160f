"""Config tree + string-target factory (port of ``frido_tpu/config.py``).

YAML configs written against the original torch code name targets such as
``frido.models.diffusion.frido.FridoDiffusion``; the alias table maps the
ones the port builds onto port classes, so the diffusion configs under
``configs/frido/`` and ``configs/msvqgan/msvqgan_f16f8_coco.yaml`` read
unmodified.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import yaml

_TARGET_ALIASES: Dict[str, str] = {
    "frido.models.diffusion.frido.FridoDiffusion":
        "frido_tpu_torch.models.frido.FridoDiffusion",
    "frido.modules.diffusionmodules.pyunet.PyUNetModel":
        "frido_tpu_torch.nn.pyunet.PyUNetModel",
    "taming.models.msvqgan.MSFPNVQModel":
        "frido_tpu_torch.models.msvqgan.MSFPNVQModel",
    "taming.models.msvqgan.VQModelInterface":
        "frido_tpu_torch.models.msvqgan.VQModelInterface",
    "frido.models.autoencoder.VQModel":
        "frido_tpu_torch.models.autoencoder.VQModel",
    "frido.models.autoencoder.VQModelInterface":
        "frido_tpu_torch.models.autoencoder.VQModelInterface",
    "frido.models.autoencoder.AutoencoderKL":
        "frido_tpu_torch.models.autoencoder.AutoencoderKL",
    "frido.models.autoencoder.IdentityFirstStage":
        "frido_tpu_torch.models.autoencoder.IdentityFirstStage",
    "frido.modules.encoders.modules.BERTEmbedder":
        "frido_tpu_torch.nn.encoders.BERTEmbedder",
    "taming.modules.losses.DummyLoss":
        "frido_tpu_torch.models.msvqgan.DummyLoss",
    "taming.modules.losses.vqperceptual.DummyLoss":
        "frido_tpu_torch.models.msvqgan.DummyLoss",
}


def resolve_target(target: str) -> Any:
    """Resolve a dotted target string (aliases first) to a class."""
    target = _TARGET_ALIASES.get(target, target)
    module, _, name = target.rpartition(".")
    if not module:
        raise ValueError(f"target '{target}' is not a dotted path")
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: Any, **extra_kwargs) -> Any:
    """Build ``{target: ..., params: {...}}``; string sentinels such as
    ``__is_unconditional__`` pass through untouched."""
    if isinstance(config, str):
        return config
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    cls = resolve_target(config["target"])
    params = dict(config.get("params", {}) or {})
    params.update(extra_kwargs)
    return cls(**params)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}
