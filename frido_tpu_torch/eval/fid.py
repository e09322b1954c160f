"""FID (port of ``frido_tpu/eval/fid.py``): the FID-standard InceptionV3
(``eval/inception.py``) and the Frechet distance of its pool3 features.

Weights come from a local file only: ``FRIDO_TPU_INCEPTION`` names a
pytorch-fid ``pt_inception-2015-12-05`` state dict (``.pth``) or an
``.npz`` of the same keys. The model is built once per resolved path and
device. :func:`frechet_distance` runs in float64 on the host through
``scipy.linalg.sqrtm``, retrying with ``eps`` on the diagonals when the
square root is not finite, as the JAX function does (its ``disp=False``,
which newer SciPy no longer takes, changes only what is returned beside
the root).

:func:`load_images` reads a folder's PNGs and JPEGs without PIL
(``data/image_io.load_rgb``: PNG through zlib, JPEG through nvJPEG on the
card) onto ``device``. They keep their size unless ``size`` is given;
then each is resized to ``size`` x ``size`` with PIL's ``BILINEAR``
resample in PIL's fixed-point arithmetic (:func:`pil_resize`), as the
JAX function resizes with PIL. The feature functions run the tower with
TF32 off (``inception.fp32``), so card features are fp32 features.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from frido_tpu_torch.device import DeviceLike, resolve_device
from frido_tpu_torch.eval import inception as inception_mod


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """FID between two Gaussians fitted to feature sets (Heusel et al.)."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(feats1),
                            *feature_statistics(feats2))


def inception_available() -> bool:
    return bool(os.environ.get("FRIDO_TPU_INCEPTION"))


def _pil_taps(in_size: int, out_size: int) -> np.ndarray:
    """float64 [out, in] of PIL's BILINEAR fixed-point coefficients
    (``Resample.c``: ``precompute_coeffs`` in double, normalised, then
    ``normalize_coeffs_8bpc`` to integers of 22 fractional bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        taps[xx, xmin:xmax] = np.where(
            w < 0, np.trunc(-0.5 + w * (1 << 22)),
            np.trunc(0.5 + w * (1 << 22)))
    return taps


def _pil_pass(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """One PIL pass along ``dim`` of a float64 [H, W, 3] image of integer
    levels: integer taps, + 2^21, >> 22, clipped to [0, 255]. Every sum
    is an integer below 2^53, so float64 holds it exactly."""
    t = torch.from_numpy(taps).to(x.device)
    y = (torch.matmul(t, x.movedim(dim, 0).reshape(x.shape[dim], -1))
         .reshape((taps.shape[0],) + tuple(np.delete(x.shape, dim))))
    y = torch.floor((y + (1 << 21)) / (1 << 22)).clamp_(0, 255)
    return y.movedim(0, dim)


def pil_resize(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """uint8 [H, W, 3] -> uint8 [height, width, 3] as PIL's
    ``Image.resize((width, height), BILINEAR)`` gives it: the horizontal
    pass, rounded to 8 bits, then the vertical one, each skipped where
    that side keeps its size."""
    h, w = img.shape[:2]
    x = img.to(torch.float64)
    if w != width:
        x = _pil_pass(x, _pil_taps(w, width), 1)
    if h != height:
        x = _pil_pass(x, _pil_taps(h, height), 0)
    return x.to(torch.uint8)


def load_images(folder: str, size: Optional[int] = None, limit: int = -1,
                device: DeviceLike = None) -> torch.Tensor:
    """A folder's PNG/JPEG files, sorted by name -> float32 [N, H, W, 3]
    in [0, 1] on ``device`` (the card unless given). Images keep their
    size (they must all have one, as Frido's eval outputs do: the resize
    to 299 is the Inception preprocess's); ``size`` resizes each with
    PIL's BILINEAR first, for folders of mixed sizes."""
    from frido_tpu_torch.data.image_io import load_rgb

    device = resolve_device(device)
    paths = sorted(
        p for p in os.listdir(folder)
        if p.lower().endswith((".png", ".jpg", ".jpeg")))
    if limit > 0:
        paths = paths[:limit]
    out = []
    for p in paths:
        img = load_rgb(os.path.join(folder, p), device)
        if size is not None and tuple(img.shape[:2]) != (size, size):
            img = pil_resize(img, size, size)
        out.append(img)
    shapes = sorted({tuple(a.shape) for a in out})
    if len(shapes) > 1:
        raise ValueError(
            f"{folder} contains {len(shapes)} different image sizes "
            f"(e.g. {shapes[:3]}); pass size= (--size in "
            "frido_tpu_torch.cli.eval_fid) to resize them with PIL's "
            "bilinear filter, a documented deviation from the "
            "native-resolution FID convention")
    return torch.stack(out).to(torch.float32) / 255.0


# keyed on the resolved weight path and the device, so that changing
# FRIDO_TPU_INCEPTION within one process reloads
_INCEPTION: dict = {}


def inception_model(device: DeviceLike = None) -> inception_mod.InceptionV3:
    """The FID Inception from ``FRIDO_TPU_INCEPTION`` on ``device`` (the
    card unless given), built once per path and device."""
    if not inception_available():
        raise RuntimeError(
            "Set FRIDO_TPU_INCEPTION to a local pytorch-fid inception "
            "state_dict (.pth or .npz) to compute FID features (nothing is "
            "downloaded).")
    device = resolve_device(device)
    path = os.path.abspath(os.environ["FRIDO_TPU_INCEPTION"])
    key = (path, str(device))
    if key not in _INCEPTION:
        if path.endswith(".npz"):
            with np.load(path) as d:
                sd = {k: d[k] for k in d.files}
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
        _INCEPTION[key] = inception_mod.InceptionV3.from_state_dict(sd,
                                                                    device)
    return _INCEPTION[key]


def inception_features(images, batch: int = 32,
                       device: DeviceLike = None) -> np.ndarray:
    """FID pool3 features [N, 2048] (float32 numpy) of [N, H, W, 3] images
    in [0, 1]; the resize to 299 and the scaling happen inside."""
    return inception_mod.run_batched(inception_model(device), images,
                                     batch=batch)


def inception_logits(images, batch: int = 32,
                     device: DeviceLike = None) -> np.ndarray:
    """Classifier logits [N, 1008] for the Inception Score."""
    return inception_mod.run_batched(inception_model(device), images,
                                     batch=batch, want_logits=True)


def logits_from_features(features: np.ndarray,
                         model: Optional[inception_mod.InceptionV3] = None,
                         device: DeviceLike = None) -> np.ndarray:
    """Logits from pool3 features already computed (the fc head is
    affine, so a FID pass gives the IS logits without a second tower
    pass); ``model`` defaults to the ``FRIDO_TPU_INCEPTION`` one."""
    model = model if model is not None else inception_model(device)
    with inception_mod.fp32():
        f = torch.as_tensor(features, dtype=torch.float32).to(model.device)
        return model.head(f).cpu().numpy()


def fid_between_folders(real_dir: str, fake_dir: str, limit: int = -1,
                        size: Optional[int] = None,
                        device: DeviceLike = None) -> float:
    real = inception_features(
        load_images(real_dir, size=size, limit=limit, device=device),
        device=device)
    fake = inception_features(
        load_images(fake_dir, size=size, limit=limit, device=device),
        device=device)
    return fid_from_features(real, fake)
