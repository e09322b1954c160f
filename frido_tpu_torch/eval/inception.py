"""The FID-standard InceptionV3 (port of ``frido_tpu/eval/inception.py``).

The feature extractor of torch-fidelity's and pytorch-fid's FID is not
torchvision's ``inception_v3`` but the TF "2015-12-05" graph:

- the 3x3 average pools of ``Mixed_5b..5d``, ``Mixed_6b..6e`` and
  ``Mixed_7b`` divide by the taps inside the image
  (``count_include_pad=False``);
- ``Mixed_7c``'s pool branch is a 3x3 **max** pool;
- the classifier has **1008** classes.

:class:`InceptionV3` is that graph as an ``nn.Module`` over NCHW, eval
only, with each BatchNorm folded at eps 1e-3 into a per-channel scale and
shift (:func:`import_torch_state_dict`, from a pytorch-fid state dict;
``AuxLogits.*`` ignored, shapes checked). Its convolutions and pools are
PyTorch's (``F.conv2d``, ``F.avg_pool2d``, ``F.max_pool2d``), as the JAX
package computes them with XLA outside any Pallas kernel. Its methods
take NHWC images in [-1, 1] at 299^2, as the JAX functions do.
:func:`preprocess` resizes [0, 1] images to 299^2 as pytorch-fid does
(bilinear, half-pixel centres, no antialias) and scales them to [-1, 1];
:func:`run_batched` runs a set in fixed-size batches, the last padded.

Weights: a pytorch-fid ``pt_inception-2015-12-05`` state dict from a
local path (``eval/fid.py``), or :func:`random_state_dict` (seeded, the
JAX package's values) for tests. :func:`run_batched` and the eval entry
points turn TF32 off for their own calls (:func:`fp32`), so the
features are fp32 on the card as on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frido_tpu_torch.device import DeviceLike, resolve_device

BN_EPS = 1e-3
NUM_CLASSES_FID = 1008  # the TF-slim label space of the 2015-12-05 weights

# name -> (c_out, (kh, kw), stride, (ph, pw)); None: the block's width
_A_BRANCHES = (
    ("branch1x1", 64, (1, 1), 1, (0, 0)),
    ("branch5x5_1", 48, (1, 1), 1, (0, 0)),
    ("branch5x5_2", 64, (5, 5), 1, (2, 2)),
    ("branch3x3dbl_1", 64, (1, 1), 1, (0, 0)),
    ("branch3x3dbl_2", 96, (3, 3), 1, (1, 1)),
    ("branch3x3dbl_3", 96, (3, 3), 1, (1, 1)),
)
_C_BRANCHES = (
    ("branch1x1", 192, (1, 1), 1, (0, 0)),
    ("branch7x7_1", None, (1, 1), 1, (0, 0)),
    ("branch7x7_2", None, (1, 7), 1, (0, 3)),
    ("branch7x7_3", 192, (7, 1), 1, (3, 0)),
    ("branch7x7dbl_1", None, (1, 1), 1, (0, 0)),
    ("branch7x7dbl_2", None, (7, 1), 1, (3, 0)),
    ("branch7x7dbl_3", None, (1, 7), 1, (0, 3)),
    ("branch7x7dbl_4", None, (7, 1), 1, (3, 0)),
    ("branch7x7dbl_5", 192, (1, 7), 1, (0, 3)),
)
_E_BRANCHES = (
    ("branch1x1", 320, (1, 1), 1, (0, 0)),
    ("branch3x3_1", 384, (1, 1), 1, (0, 0)),
    ("branch3x3_2a", 384, (1, 3), 1, (0, 1)),
    ("branch3x3_2b", 384, (3, 1), 1, (1, 0)),
    ("branch3x3dbl_1", 448, (1, 1), 1, (0, 0)),
    ("branch3x3dbl_2", 384, (3, 3), 1, (1, 1)),
    ("branch3x3dbl_3a", 384, (1, 3), 1, (0, 1)),
    ("branch3x3dbl_3b", 384, (3, 1), 1, (1, 0)),
)


def conv_specs() -> Dict[str, Tuple[int, int, Tuple[int, int], int,
                                    Tuple[int, int]]]:
    """Every BasicConv2d of the graph: name -> (cin, cout, k, stride,
    pad), in the graph's order."""
    s: Dict[str, Tuple] = {
        "Conv2d_1a_3x3": (3, 32, (3, 3), 2, (0, 0)),
        "Conv2d_2a_3x3": (32, 32, (3, 3), 1, (0, 0)),
        "Conv2d_2b_3x3": (32, 64, (3, 3), 1, (1, 1)),
        "Conv2d_3b_1x1": (64, 80, (1, 1), 1, (0, 0)),
        "Conv2d_4a_3x3": (80, 192, (3, 3), 1, (0, 0)),
    }

    def add(block, cin, branches, pool_out):
        chain_in = cin
        for name, cout, k, stride, pad in branches:
            # branch roots (...1x1 / ..._1) read the block's input; later
            # links read the previous conv of their chain
            src = cin if (name.endswith("1x1") or name.endswith("_1")) \
                else chain_in
            s[f"{block}.{name}"] = (src, cout, k, stride, pad)
            chain_in = cout
        if pool_out:
            s[f"{block}.branch_pool"] = (cin, pool_out, (1, 1), 1, (0, 0))

    for block, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                           ("Mixed_5d", 288, 64)):
        add(block, cin, _A_BRANCHES, pf)
    s["Mixed_6a.branch3x3"] = (288, 384, (3, 3), 2, (0, 0))
    s["Mixed_6a.branch3x3dbl_1"] = (288, 64, (1, 1), 1, (0, 0))
    s["Mixed_6a.branch3x3dbl_2"] = (64, 96, (3, 3), 1, (1, 1))
    s["Mixed_6a.branch3x3dbl_3"] = (96, 96, (3, 3), 2, (0, 0))
    for block, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                      ("Mixed_6d", 160), ("Mixed_6e", 192)):
        branches = tuple(
            (n, (cout if cout is not None else c7), k, st, p)
            for n, cout, k, st, p in _C_BRANCHES)
        add(block, 768, branches, 192)
    s["Mixed_7a.branch3x3_1"] = (768, 192, (1, 1), 1, (0, 0))
    s["Mixed_7a.branch3x3_2"] = (192, 320, (3, 3), 2, (0, 0))
    s["Mixed_7a.branch7x7x3_1"] = (768, 192, (1, 1), 1, (0, 0))
    s["Mixed_7a.branch7x7x3_2"] = (192, 192, (1, 7), 1, (0, 3))
    s["Mixed_7a.branch7x7x3_3"] = (192, 192, (7, 1), 1, (3, 0))
    s["Mixed_7a.branch7x7x3_4"] = (192, 192, (3, 3), 2, (0, 0))
    for block, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        add(block, cin, _E_BRANCHES, 192)
    return s


_SPECS = conv_specs()


def import_torch_state_dict(sd: Mapping[str, object],
                            num_classes: int = NUM_CLASSES_FID
                            ) -> Dict[str, Dict[str, np.ndarray]]:
    """A pytorch-fid (or torchvision) state dict -> the folded weights:
    ``{conv: {w: OIHW, a: scale, b: shift}, "fc": {w: [classes, 2048],
    b}}``, float32 numpy. Takes tensors or arrays; ``AuxLogits.*`` and
    ``num_batches_tracked`` are ignored. Raises ``KeyError`` on a missing
    conv, BN or fc entry and ``ValueError`` on a shape that differs."""
    def get(key):
        if key not in sd:
            raise KeyError(f"inception state_dict missing {key}")
        v = sd[key]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v, np.float32)

    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, (cin, cout, (kh, kw), _, _) in _SPECS.items():
        w = get(f"{name}.conv.weight")
        if w.shape != (cout, cin, kh, kw):
            raise ValueError(
                f"{name}: expected OIHW {(cout, cin, kh, kw)}, got {w.shape}")
        gamma = get(f"{name}.bn.weight")
        beta = get(f"{name}.bn.bias")
        mean = get(f"{name}.bn.running_mean")
        var = get(f"{name}.bn.running_var")
        a = gamma / np.sqrt(var + BN_EPS)
        params[name] = {"w": w, "a": a, "b": beta - mean * a}
    fw = get("fc.weight")
    if fw.shape != (num_classes, 2048):
        raise ValueError(f"fc: expected {(num_classes, 2048)}, got {fw.shape}")
    params["fc"] = {"w": fw, "b": get("fc.bias")}
    return params


def random_state_dict(seed: int = 0, num_classes: int = NUM_CLASSES_FID
                      ) -> Dict[str, np.ndarray]:
    """A pytorch-fid-layout state dict of seeded random values (the JAX
    package's, draw for draw), for tests and the card check."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, (cin, cout, (kh, kw), _, _) in _SPECS.items():
        fan_in = cin * kh * kw
        sd[f"{name}.conv.weight"] = (
            rng.randn(cout, cin, kh, kw) / np.sqrt(fan_in)).astype(np.float32)
        sd[f"{name}.bn.weight"] = 0.5 + rng.rand(cout).astype(np.float32)
        sd[f"{name}.bn.bias"] = 0.1 * rng.randn(cout).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = 0.1 * rng.randn(cout).astype(
            np.float32)
        sd[f"{name}.bn.running_var"] = 0.5 + rng.rand(cout).astype(
            np.float32)
    sd["fc.weight"] = rng.randn(num_classes, 2048).astype(np.float32) * 0.01
    sd["fc.bias"] = np.zeros(num_classes, np.float32)
    return sd


@contextlib.contextmanager
def fp32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside, the
    caller's settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class _ConvBN(nn.Module):
    """conv -> folded BN (x * a + b) -> ReLU."""

    def __init__(self, cin, cout, k, stride, pad, device):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.register_buffer("w", torch.zeros(cout, cin, *k, device=device))
        self.register_buffer("a", torch.ones(cout, device=device))
        self.register_buffer("b", torch.zeros(cout, device=device))

    def forward(self, x):
        y = F.conv2d(x, self.w, stride=self.stride, padding=self.pad)
        return F.relu(y * self.a[:, None, None] + self.b[:, None, None])


def _avg_pool_3x3_nopad(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionV3(nn.Module):
    """The FID graph on ``device`` (the card unless given), its weights
    loaded from folded parameters (:meth:`load_params`)."""

    def __init__(self, num_classes: int = NUM_CLASSES_FID,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.convs = nn.ModuleDict({
            name.replace(".", "__"): _ConvBN(cin, cout, k, st, p, device)
            for name, (cin, cout, k, st, p) in _SPECS.items()})
        self.register_buffer("fc_w", torch.zeros(num_classes, 2048,
                                                 device=device))
        self.register_buffer("fc_b", torch.zeros(num_classes, device=device))
        self.eval()

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, object],
                        device: DeviceLike = None) -> "InceptionV3":
        """Built from a pytorch-fid state dict (folded on the host)."""
        params = import_torch_state_dict(sd)
        model = cls(params["fc"]["w"].shape[0], device)
        return model.load_params(params)

    @torch.no_grad()
    def load_params(self, params: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> "InceptionV3":
        for name in _SPECS:
            m = self.convs[name.replace(".", "__")]
            for k in ("w", "a", "b"):
                getattr(m, k).copy_(torch.as_tensor(params[name][k]))
        self.fc_w.copy_(torch.as_tensor(params["fc"]["w"]))
        self.fc_b.copy_(torch.as_tensor(params["fc"]["b"]))
        return self

    @property
    def device(self) -> torch.device:
        return self.fc_w.device

    def _bc(self, block):
        def bc(x, name):
            return self.convs[f"{block}__{name}"](x)
        return bc

    def _a(self, block, x):
        bc = self._bc(block)
        b1 = bc(x, "branch1x1")
        b5 = bc(bc(x, "branch5x5_1"), "branch5x5_2")
        b3 = bc(bc(bc(x, "branch3x3dbl_1"), "branch3x3dbl_2"),
                "branch3x3dbl_3")
        bp = bc(_avg_pool_3x3_nopad(x), "branch_pool")
        return torch.cat([b1, b5, b3, bp], 1)

    def _b(self, x):
        bc = self._bc("Mixed_6a")
        b3 = bc(x, "branch3x3")
        bd = bc(bc(bc(x, "branch3x3dbl_1"), "branch3x3dbl_2"),
                "branch3x3dbl_3")
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)

    def _c(self, block, x):
        bc = self._bc(block)
        b1 = bc(x, "branch1x1")
        b7 = bc(bc(bc(x, "branch7x7_1"), "branch7x7_2"), "branch7x7_3")
        bd = x
        for i in range(1, 6):
            bd = bc(bd, f"branch7x7dbl_{i}")
        bp = bc(_avg_pool_3x3_nopad(x), "branch_pool")
        return torch.cat([b1, b7, bd, bp], 1)

    def _d(self, x):
        bc = self._bc("Mixed_7a")
        b3 = bc(bc(x, "branch3x3_1"), "branch3x3_2")
        b7 = x
        for i in range(1, 5):
            b7 = bc(b7, f"branch7x7x3_{i}")
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)

    def _e(self, block, x, pool: str):
        bc = self._bc(block)
        b1 = bc(x, "branch1x1")
        h = bc(x, "branch3x3_1")
        b3 = torch.cat([bc(h, "branch3x3_2a"), bc(h, "branch3x3_2b")], 1)
        h = bc(bc(x, "branch3x3dbl_1"), "branch3x3dbl_2")
        bd = torch.cat([bc(h, "branch3x3dbl_3a"), bc(h, "branch3x3dbl_3b")],
                       1)
        pooled = (_avg_pool_3x3_nopad(x) if pool == "avg"
                  else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([b1, b3, bd, bc(pooled, "branch_pool")], 1)

    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """pool3 features [N, 2048] of NHWC ``x`` in [-1, 1]."""
        c = self.convs
        h = x.permute(0, 3, 1, 2).to(self.device, torch.float32)
        h = c["Conv2d_2b_3x3"](c["Conv2d_2a_3x3"](c["Conv2d_1a_3x3"](h)))
        h = F.max_pool2d(h, 3, 2)
        h = c["Conv2d_4a_3x3"](c["Conv2d_3b_1x1"](h))
        h = F.max_pool2d(h, 3, 2)
        for block in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            h = self._a(block, h)
        h = self._b(h)
        for block in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            h = self._c(block, h)
        h = self._d(h)
        h = self._e("Mixed_7b", h, "avg")
        h = self._e("Mixed_7c", h, "max")       # the FID graph's max pool
        return h.mean(dim=(2, 3))

    def head(self, features: torch.Tensor) -> torch.Tensor:
        """The classifier over pool3 features: logits [N, classes]."""
        return features @ self.fc_w.t() + self.fc_b

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Classifier logits [N, classes] of NHWC ``x`` in [-1, 1]."""
        return self.head(self.features(x))

    forward = features


def preprocess(images01: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[N, H, W, 3] floats in [0, 1] -> [N, size, size, 3] in [-1, 1]:
    pytorch-fid's ``F.interpolate(..., 'bilinear', align_corners=False)``
    (half-pixel centres, no antialias, up or down), then ``x * 2 - 1``."""
    if tuple(images01.shape[1:3]) != (size, size):
        images01 = F.interpolate(
            images01.permute(0, 3, 1, 2), size=(size, size),
            mode="bilinear", align_corners=False,
            antialias=False).permute(0, 2, 3, 1)
    return images01 * 2.0 - 1.0


def run_batched(model: InceptionV3, images01, batch: int = 32,
                want_logits: bool = False) -> np.ndarray:
    """Features (or logits) of [N, H, W, 3] images in [0, 1] (an array or
    a tensor), ``batch`` at a time on the model's device, the last batch
    padded with zeros to ``batch`` as the JAX loop pads it; TF32 off.
    Returns float32 numpy [N, 2048] (or [N, classes])."""
    outs = []
    n = len(images01)
    with fp32():
        for i in range(0, n, batch):
            chunk = torch.as_tensor(images01[i:i + batch]).to(
                model.device, torch.float32)
            pad = batch - len(chunk)
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (pad,) + tuple(chunk.shape[1:]))])
            x = preprocess(chunk)
            out = model.logits(x) if want_logits else model.features(x)
            outs.append(out[:batch - pad].cpu().numpy())
    return np.concatenate(outs)
