"""PatchGAN discriminator (port of ``frido_tpu/losses/discriminator.py``,
the pix2pix ``NLayerDiscriminator``), channel-first.

Parameter names follow the torch tree ``main.{i}``: the 4x4 convs at
``main.0``, ``main.2``, ``main.5``, ... with their norms one index after
them (the LeakyReLUs hold the indices between). The 4x4 stride-2 convs stay
``F.conv2d`` (``nn/layers.Conv2d`` sends only 3x3 / stride-1 / pad-1 convs
to the kernel), as the JAX package leaves them to XLA.

``TorchBatchNorm`` has ``nn.BatchNorm2d``'s semantics (momentum 0.1, eps
1e-5, batch statistics in training with an unbiased running variance, the
running statistics at eval); ``update_stats=False`` normalises with the
batch statistics and leaves the running ones alone. ``ActNorm``
initialises from the first batch it sees in training: loc = -mean,
scale = 1 / (std + 1e-6) with the unbiased std, or the identity where
std <= 1e-5 (a constant batch).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.nn.layers import Conv2d


class TorchBatchNorm(nn.Module):
    """BatchNorm2d over dim 1: ``weight``, ``bias`` and the buffers
    ``running_mean``, ``running_var``. Its weight initialises from
    N(0, 0.02), as the JAX module's."""

    def __init__(self, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=gen)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        rm, rv = ((self.running_mean, self.running_var) if update_stats
                  else (None, None))
        return F.batch_norm(x, rm, rv, self.weight, self.bias, True,
                            self.momentum, self.eps)


class ActNorm(nn.Module):
    """Per-channel ``scale * (x + loc)`` with the data-dependent init of
    the first training batch (the flow's logdet path is not used here).
    Loading a state dict marks it initialised."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels, device=device))
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.initialized = False

    def reset_parameters(self, gen: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            self.loc.zero_()
            self.scale.fill_(1.0)
        self.initialized = False

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.initialized = True

    @torch.no_grad()
    def _initialize(self, x: torch.Tensor) -> None:
        dims = (0, 2, 3)
        std = x.float().std(dim=dims, correction=1)
        real = std > 1e-5   # a constant batch -> identity, not 1/0
        self.loc.copy_(torch.where(real, -x.float().mean(dim=dims), 0.0))
        self.scale.copy_(torch.where(real, 1.0 / (std + 1e-6), 1.0))
        self.initialized = True

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if self.training and not self.initialized:
            self._initialize(x)
        shape = (1, -1, 1, 1)
        return self.scale.view(shape) * (x + self.loc.view(shape))


class NLayerDiscriminator(nn.Module):
    """``n_layers`` stride-2 4x4 convs (the first without a norm), one
    stride-1 conv with a norm, a 1-channel stride-1 conv; LeakyReLU(0.2)
    between. The convs keep their bias with ActNorm and drop it with
    BatchNorm. NCHW in, NCHW patch logits out. It lives on ``device``: the
    card unless the caller passes another."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        norm = ActNorm if use_actnorm else TorchBatchNorm
        bias = use_actnorm
        main = {"0": Conv2d(input_nc, ndf, 4, stride=2, padding=1,
                            device=device)}
        idx, nf = 2, ndf
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            main[str(idx)] = Conv2d(nf_prev, nf, 4, stride=stride, padding=1,
                                    bias=bias, device=device)
            main[str(idx + 1)] = norm(nf, device=device)
            idx += 3
        main[str(idx)] = Conv2d(nf, 1, 4, stride=1, padding=1, device=device)
        self.main = nn.ModuleDict(main)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        layers = list(self.main.values())
        for i, layer in enumerate(layers):
            if isinstance(layer, Conv2d):
                x = layer(x)
                if i + 1 < len(layers) and isinstance(layers[i + 1], Conv2d):
                    x = F.leaky_relu(x, 0.2)
            else:
                x = F.leaky_relu(layer(x, update_stats), 0.2)
        return x
