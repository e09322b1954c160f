"""Evaluation: FID with the FID-standard InceptionV3, IS, precision and
recall, PSNR, SSIM and CLIPScore (port of ``frido_tpu/eval``)."""

from frido_tpu_torch.eval.fid import (  # noqa: F401
    feature_statistics,
    fid_between_folders,
    fid_from_features,
    frechet_distance,
)
from frido_tpu_torch.eval.metrics import (  # noqa: F401
    clip_score,
    inception_score,
    precision_recall,
    psnr,
    psnr_ssim_batch,
    ssim,
)
