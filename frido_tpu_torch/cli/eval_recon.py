"""PSNR and SSIM between two image folders (port of
``scripts/eval_recon.py``), for the first stage's reconstructions.

    python -m frido_tpu_torch.cli.eval_recon --real DIR --fake DIR \\
        [--limit N] [--size 256] [--device cpu]

Images are read without PIL on the card (``--device cpu`` for the CPU),
resized to ``--size`` with PIL's bilinear filter where they differ, in
[0, 1] (``data_range`` 1.0); the metrics run in float64 there. Prints the
JAX script's line; in process, :func:`main` returns (PSNR, SSIM, n).
"""

from __future__ import annotations

import argparse
from typing import Tuple


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--real", required=True, help="ground-truth image folder")
    p.add_argument("--fake", required=True, help="reconstruction folder")
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="device of the decode and the metrics (default: "
                        "the card)")
    return p


def main(argv=None) -> Tuple[float, float, int]:
    args = get_parser().parse_args(argv)

    from frido_tpu_torch.eval.fid import load_images
    from frido_tpu_torch.eval.metrics import psnr_ssim_batch

    real = load_images(args.real, size=args.size, limit=args.limit,
                       device=args.device)
    fake = load_images(args.fake, size=args.size, limit=args.limit,
                       device=args.device)
    n = min(len(real), len(fake))
    ps, ss = psnr_ssim_batch(real[:n], fake[:n], data_range=1.0)
    print(f"PSNR: {ps:.4f}  SSIM: {ss:.4f}  (n={n})")
    return ps, ss, n


if __name__ == "__main__":
    main()
