"""LPIPS perceptual distance: frozen VGG16 features and learned 1x1
weights (port of ``frido_tpu/losses/lpips.py``), channel-first inside,
NHWC images at the interface as in the JAX package.

The pretrained weights (torchvision's VGG16 and the LPIPS ``vgg.pth`` lin
layers) are read only from the local paths ``FRIDO_TPU_VGG16`` and
``FRIDO_TPU_LPIPS``; nothing is downloaded. Without them
``lpips_available()`` is False and the VQGAN loss trains with
``perceptual_weight = 0`` and a warning. Parameter names follow the torch
trees (``net.features.{i}``, ``lin{k}.model.1``), so both checkpoints and
the JAX params load mechanically.

VGG's 3x3 convs are ``nn/layers.Conv2d``: under ``FRIDO_CONV_MODE=pallas``
or ``pallas_fused`` they take the conv kernel, the first (Cin = 3) too.
"""

from __future__ import annotations

import os
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.nn.layers import Conv2d
from frido_tpu_torch.ops.image import to_nchw

# torchvision VGG16 "features"; M = 2x2 max pool. The taps follow the ReLU
# at indices 3, 8, 15, 22, 29 (relu1_2, 2_2, 3_3, 4_3, 5_3).
_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
_TAPS = {3, 8, 15, 22, 29}
LPIPS_CHNS = [64, 128, 256, 512, 512]


class VGG16Features(nn.Module):
    """The VGG16 trunk, emitting the five tap activations (NCHW)."""

    def __init__(self, device=None):
        super().__init__()
        convs, idx, cin = {}, 0, 3
        for item in _VGG_PLAN:
            if item == "M":
                idx += 1
                continue
            convs[str(idx)] = Conv2d(cin, item, 3, padding=1, device=device)
            cin = item
            idx += 2    # conv + relu
        self.features = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, idx = [], 0
        for item in _VGG_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                idx += 1
                continue
            x = F.relu(self.features[str(idx)](x))
            if idx + 1 in _TAPS:
                taps.append(x)
                if len(taps) == len(_TAPS):
                    break   # the last pool feeds no tap
            idx += 2
        return taps


class _Lin(nn.Module):
    """``lin{k}``: the reference's Sequential(Dropout, 1x1 conv); only the
    conv (``model.1``) holds weights."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.model = nn.ModuleDict(
            {"1": Conv2d(channels, 1, 1, bias=False, device=device)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model["1"](x)


class LPIPS(nn.Module):
    """scaling -> VGG taps -> unit-normalise over channels -> squared
    difference -> 1x1 lin -> spatial mean -> sum over the taps. NHWC images
    in [-1, 1] in, [N, 1, 1, 1] out. Its weights take no gradient. It lives
    on ``device``: the card unless the caller passes another."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.net = VGG16Features(device=device)
        for k, c in enumerate(LPIPS_CHNS):
            setattr(self, f"lin{k}", _Lin(c, device=device))
        self.register_buffer("shift", torch.tensor(
            [-0.030, -0.088, -0.188], device=device).view(1, 3, 1, 1),
            persistent=False)
        self.register_buffer("scale", torch.tensor(
            [0.458, 0.448, 0.450], device=device).view(1, 3, 1, 1),
            persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        f0 = self.net((to_nchw(x) - self.shift) / self.scale)
        f1 = self.net((to_nchw(y) - self.shift) / self.scale)
        total = 0.0
        for k in range(len(LPIPS_CHNS)):
            a = f0[k] / (torch.linalg.vector_norm(f0[k], dim=1, keepdim=True)
                         + 1e-10)
            b = f1[k] / (torch.linalg.vector_norm(f1[k], dim=1, keepdim=True)
                         + 1e-10)
            lin = getattr(self, f"lin{k}")((a - b).square())
            total = total + lin.mean(dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)


def lpips_available() -> bool:
    return bool(os.environ.get("FRIDO_TPU_VGG16")) and bool(
        os.environ.get("FRIDO_TPU_LPIPS"))


def load_lpips_weights(module: LPIPS) -> LPIPS:
    """Load torchvision's VGG16 state dict (``FRIDO_TPU_VGG16``: its
    ``features.*`` entries) and the LPIPS lin checkpoint
    (``FRIDO_TPU_LPIPS``: ``lin{k}.model.1.weight``) into ``module``,
    strictly: every tensor of the module gets its entry."""
    vgg = torch.load(os.environ["FRIDO_TPU_VGG16"], map_location="cpu")
    lin = torch.load(os.environ["FRIDO_TPU_LPIPS"], map_location="cpu")
    state = {"net." + k: v for k, v in vgg.items()
             if k.startswith("features.")}
    state.update({k: v for k, v in lin.items() if k.startswith("lin")})
    module.load_state_dict(state, strict=True)
    return module
