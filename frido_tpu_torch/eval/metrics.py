"""Reconstruction and generation metrics besides FID (port of
``frido_tpu/eval/metrics.py``).

- PSNR and SSIM (Gaussian window 11, sigma 1.5, the constants of Wang et
  al. 2004; the window filter in valid mode as a ``conv2d``) for the
  first stage's reconstructions;
- the Inception Score (Salimans et al. 2016) from class logits
  (``eval/fid.inception_logits``);
- improved precision and recall (Kynkaanniemi et al. 2019): k-NN radii
  over any feature set, the pairwise distances as one matmul;
- CLIPScore (Hessel et al. 2021) from CLIP embeddings (``nn/clip.py``).

Inputs are tensors (or arrays, taken to the CPU); each function computes
in float64 on its input's device and returns Python floats.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _f64(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device if device is not None else t.device, torch.float64)


def psnr(a, b, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio; the default range is [-1, 1]'s."""
    a = _f64(a)
    mse = float(torch.mean((a - _f64(b, a.device)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(data_range ** 2 / mse)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64, device=device) \
        - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    w = torch.outer(g, g)
    return w / w.sum()


def ssim(a, b, data_range: float = 2.0, window_size: int = 11,
         sigma: float = 1.5) -> float:
    """Mean SSIM over the channels of one [H, W, C] (or [H, W]) pair."""
    a = _f64(a)
    b = _f64(b, a.device)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    w = _gaussian_window(window_size, sigma, a.device)[None, None]

    def filt(img):                       # [C, H, W] -> valid-mode [C, h, w]
        return F.conv2d(img[:, None], w)[:, 0]

    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    mx, my = filt(x), filt(y)
    mxx = filt(x * x) - mx * mx
    myy = filt(y * y) - my * my
    mxy = filt(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * mxy + c2)) / (
        (mx ** 2 + my ** 2 + c1) * (mxx + myy + c2))
    return float(s.mean(dim=(1, 2)).mean())


def psnr_ssim_batch(a, b, data_range: float = 2.0) -> Tuple[float, float]:
    """Mean PSNR and SSIM over a [N, H, W, C] pair."""
    ps = [psnr(x, y, data_range) for x, y in zip(a, b)]
    ss = [ssim(x, y, data_range) for x, y in zip(a, b)]
    return (float(torch.tensor(ps, dtype=torch.float64).mean()),
            float(torch.tensor(ss, dtype=torch.float64).mean()))


def inception_score(logits, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over class logits [N, classes],
    in ``splits`` parts; (mean, std) over the parts."""
    logits = _f64(logits)
    probs = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    probs = probs / probs.sum(dim=1, keepdim=True)
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(dim=0, keepdim=True)
        kl = torch.sum(part * (torch.log(part + 1e-16)
                               - torch.log(marginal + 1e-16)), dim=1)
        scores.append(float(torch.exp(kl.mean())))
    t = torch.tensor(scores, dtype=torch.float64)
    return float(t.mean()), float(t.std(unbiased=False))


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = (a * a).sum(dim=1)[:, None]
    bb = (b * b).sum(dim=1)[None, :]
    return torch.clamp(aa + bb - 2.0 * a @ b.t(), min=0.0)


def _knn_radii(feats: torch.Tensor, k: int) -> torch.Tensor:
    d = _pairwise_sq_dists(feats, feats)
    d.fill_diagonal_(float("inf"))
    return torch.sort(d, dim=1).values[:, k - 1]


def precision_recall(real, fake, k: int = 3) -> Tuple[float, float]:
    """precision: the share of fakes inside the reals' k-NN manifold;
    recall: the share of reals inside the fakes'."""
    real = _f64(real)
    fake = _f64(fake, real.device)
    r_real = _knn_radii(real, k)
    r_fake = _knn_radii(fake, k)
    d_fr = _pairwise_sq_dists(fake, real)
    precision = (d_fr <= r_real[None, :]).any(dim=1).double().mean()
    recall = (d_fr.t() <= r_fake[None, :]).any(dim=1).double().mean()
    return float(precision), float(recall)


def clip_score(image_embeds, text_embeds, w: float = 2.5) -> float:
    """CLIPScore: ``w * max(0, cos(image, text))``, averaged; the
    embeddings are normalised here."""
    img = _f64(image_embeds)
    txt = _f64(text_embeds, img.device)
    img = img / torch.linalg.norm(img, dim=1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=1, keepdim=True)
    cos = (img * txt).sum(dim=1)
    return float((w * torch.clamp(cos, min=0.0)).mean())
