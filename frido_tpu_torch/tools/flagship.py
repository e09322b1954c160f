"""The models the measuring tools run: the port's copy of
``__graft_entry__.py``'s ``FLAGSHIP_CONFIG`` and ``_TINY_*`` dicts, which
the JAX package's ``scripts/flops_audit.py``, ``quality_dpmpp_vs_plms.py``,
``profile_step.py`` and ``profile_train.py`` read.

- the flagship: ``configs/frido/t2i/frido_f16f8_coco.yaml`` (the t2i f16f8
  model: PyUNet 192 x [1, 2, 3, 5], a 32^2 x 8 latent, a 32-layer BERT
  over 77 tokens, the MS-VQGAN at 256^2);
- the tiny model: the same structure at toy widths (a 16^2 x 8 latent, a
  2-layer BERT over 12 tokens of a 64-word vocabulary, 32^2 images).

:func:`build` makes either on a device with seeded weights; the tools
take ``--device`` (the card unless told otherwise, ``resolve_device``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict

from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.device import DeviceLike, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP_CONFIG = os.path.join(REPO, "configs", "frido", "t2i",
                               "frido_f16f8_coco.yaml")
MSVQGAN_CONFIG = os.path.join(REPO, "configs", "msvqgan",
                              "msvqgan_f16f8_coco.yaml")

# __graft_entry__.py:16-48
_TINY_ED = dict(multiscale=2, double_z=False, z_channels=[4, 4], resolution=32,
                in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 2],
                num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
_TINY_DD = dict(double_z=False, z_channels=8, resolution=32, in_channels=3,
                out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
                attn_resolutions=[8], dropout=0.0)
_TINY_MODEL = dict(
    adopted_scale_factor=True, noise_mix_ratio=0.1, linear_start=0.0015,
    linear_end=0.0155, timesteps=100, loss_type="l1", image_size=16,
    channels=8, cond_stage_trainable=True, conditioning_key="crossattn",
    scale_by_std=True,
)
_TINY_UNET = {
    "target": "frido.modules.diffusionmodules.pyunet.PyUNetModel",
    "params": dict(
        use_split_head=True, split_embed_dim_list=[4, 4], use_SPADE_norm=True,
        image_size=16, in_channels=8, out_channels=8, model_channels=32,
        attention_resolutions=[4, 2], num_res_blocks=1, channel_mult=[1, 2],
        num_head_channels=16, use_spatial_transformer=True,
        transformer_depth=1, context_dim=48, num_stage=2),
}
_TINY_FIRST = {
    "target": "taming.models.msvqgan.VQModelInterface",
    "params": dict(embed_dim=[4, 4], n_embed=[64, 64], edconfig=_TINY_ED,
                   ddconfig=_TINY_DD,
                   lossconfig={"target": "taming.modules.losses.DummyLoss"}),
}
_TINY_COND = {
    "target": "frido.modules.encoders.modules.BERTEmbedder",
    "params": dict(n_embed=48, n_layer=2, vocab_size=64, max_seq_len=12,
                   use_tokenizer=False),
}


def model_config(tiny: bool) -> Dict[str, Any]:
    """The model node (``target`` and ``params``) of the tiny model or of
    the flagship config (its first stage's ``ckpt_path`` dropped: the
    weights are seeded)."""
    if tiny:
        return {"target": "frido.models.diffusion.frido.FridoDiffusion",
                "params": dict(copy.deepcopy(_TINY_MODEL),
                               first_stage_config=copy.deepcopy(_TINY_FIRST),
                               cond_stage_config=copy.deepcopy(_TINY_COND),
                               unet_config=copy.deepcopy(_TINY_UNET))}
    cfg = load_yaml(FLAGSHIP_CONFIG)["model"]
    cfg["params"]["first_stage_config"]["params"].pop("ckpt_path", None)
    return cfg


def build(tiny: bool, device: DeviceLike = None, seed: int = 0):
    """The tiny or the flagship ``FridoDiffusion`` on ``device`` (the card
    by default) with weights from ``seed``."""
    return instantiate_from_config(model_config(tiny),
                                   device=resolve_device(device), seed=seed)


def context_shape(tiny: bool):
    """(context length, vocabulary) of the model's token ids."""
    if tiny:
        p = _TINY_COND["params"]
        return p["max_seq_len"], p["vocab_size"]
    return 77, 30522        # the BERT WordPiece vocabulary
