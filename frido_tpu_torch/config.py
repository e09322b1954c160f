"""Config tree + string-target factory (port of ``frido_tpu/config.py``).

YAML configs written against the original torch code name targets such as
``frido.models.diffusion.frido.FridoDiffusion``; the alias table maps the
ones the port builds onto port classes (the models, the pixel-space
``DDPM`` included, the conditioning encoders, the VQ-GAN loss, the LR
schedulers, the COCO, Visual Genome, VG-cocostyle and OpenImages datasets
and the data module), so the configs under ``configs/frido/`` and
``configs/msvqgan/`` read unmodified. :func:`load_configs` merges YAML
files left to right and applies ``a.b.c=value`` dot-list overrides on top, as
the CLIs take them.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

import yaml

_TARGET_ALIASES: Dict[str, str] = {
    "frido.models.diffusion.frido.FridoDiffusion":
        "frido_tpu_torch.models.frido.FridoDiffusion",
    "frido.models.diffusion.frido.DDPM":
        "frido_tpu_torch.models.frido.DDPM",
    # the JAX package's own target names, as its configs and tests write
    # them: the port answers them without importing that package
    "frido_tpu.models.frido.DDPM": "frido_tpu_torch.models.frido.DDPM",
    "frido_tpu.nn.pyunet.PyUNetModel": "frido_tpu_torch.nn.pyunet.PyUNetModel",
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
    "frido.modules.encoders.modules.ClassEmbedder":
        "frido_tpu_torch.nn.encoders.ClassEmbedder",
    "frido.modules.encoders.modules.TransformerEmbedder":
        "frido_tpu_torch.nn.encoders.TransformerEmbedder",
    "frido.modules.encoders.modules.SpatialRescaler":
        "frido_tpu_torch.nn.encoders.SpatialRescaler",
    "frido.modules.encoders.modules.BERTEmbedderVQTInterface":
        "frido_tpu_torch.nn.encoders.BERTEmbedderVQTInterface",
    "frido.modules.encoders.modules.FrozenCLIPEmbedder":
        "frido_tpu_torch.nn.encoders.FrozenCLIPEmbedder",
    "frido.modules.encoders.modules.FrozenCLIPTextEmbedder":
        "frido_tpu_torch.nn.encoders.FrozenCLIPTextEmbedder",
    "frido.modules.encoders.modules.FrozenClipImageEmbedder":
        "frido_tpu_torch.nn.encoders.FrozenClipImageEmbedder",
    "taming.modules.losses.DummyLoss":
        "frido_tpu_torch.models.msvqgan.DummyLoss",
    "taming.modules.losses.vqperceptual.DummyLoss":
        "frido_tpu_torch.models.msvqgan.DummyLoss",
    "taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        "frido_tpu_torch.losses.vqperceptual.VQLPIPSWithDiscriminator",
    "frido.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        "frido_tpu_torch.losses.vqperceptual.VQLPIPSWithDiscriminator",
    "frido.lr_scheduler.LambdaLinearScheduler":
        "frido_tpu_torch.training.optim.LambdaLinearScheduler",
    "frido.lr_scheduler.LambdaWarmUpCosineScheduler":
        "frido_tpu_torch.training.optim.LambdaWarmUpCosineScheduler",
    "taming.data.annotated_objects_coco.AnnotatedObjectsCoco":
        "frido_tpu_torch.data.coco.AnnotatedObjectsCoco",
    "main.DataModuleFromConfig":
        "frido_tpu_torch.data.datamodule.DataModuleFromConfig",
    "scripts.sample_diffusion.DataModuleFromConfig":
        "frido_tpu_torch.data.datamodule.DataModuleFromConfig",
    "taming.data.annotated_objects_vg.AnnotatedObjectsVg":
        "frido_tpu_torch.data.vg.AnnotatedObjectsVg",
    "taming.data.annotated_objects_vg_cocostyle.AnnotatedObjectsVg":
        "frido_tpu_torch.data.vg_cocostyle.AnnotatedObjectsVgCocoStyle",
    "taming.data.annotated_objects_open_images.AnnotatedObjectsOpenImages":
        "frido_tpu_torch.data.open_images.AnnotatedObjectsOpenImages",
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


def merge_dicts(base: Dict[str, Any], override: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Deep merge: values in ``override`` win; dicts merge recursively."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def apply_dotlist(config: Dict[str, Any], dotlist: List[str]
                  ) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides (the OmegaConf dot-list idiom); each
    value is parsed as YAML. Nodes on the way are copied, not changed."""
    out = dict(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry '{item}' is not of form "
                             f"key=value")
        key, _, raw = item.partition("=")
        parts = key.strip().split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            nxt = dict(nxt) if isinstance(nxt, dict) else {}
            node[p] = nxt
            node = nxt
        node[parts[-1]] = yaml.safe_load(raw)
    return out


def load_configs(paths: List[str], dotlist: Optional[List[str]] = None
                 ) -> Dict[str, Any]:
    """Left-to-right merge of YAML files, then dot-list overrides."""
    cfg: Dict[str, Any] = {}
    for p in paths:
        cfg = merge_dicts(cfg, load_yaml(p))
    if dotlist:
        cfg = apply_dotlist(cfg, dotlist)
    return cfg
