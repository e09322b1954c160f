"""FID between two image folders (port of ``scripts/eval_fid.py``).

    FRIDO_TPU_INCEPTION=pt_inception-2015-12-05.pth \\
        python -m frido_tpu_torch.cli.eval_fid --real DIR --fake DIR \\
        [--limit N] [--size S] [--inception_score] [--device cpu]

The JAX script's flags and lines: ``FID: x`` and, with
``--inception_score``, ``IS: mean +/- std`` of ``--fake`` from the fc head
over the features already computed (no second tower pass). Without
``FRIDO_TPU_INCEPTION`` it prints the skip line, and as a program exits
with 1 and an error naming the variable (the JAX script exits 0), so a
runbook's FID step fails. Images are
read without PIL and the tower runs on the card (``--device cpu`` for
the CPU) with TF32 off, so its features are fp32 (``eval/fid.py``).
In process, :func:`main` returns the numbers and the seconds taken.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--real", required=True)
    p.add_argument("--fake", required=True)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--size", type=int, default=None,
                   help="resize images to SIZExSIZE (PIL's bilinear) before "
                        "the Inception preprocess, for folders of mixed "
                        "sizes (e.g. raw COCO val). By default images keep "
                        "their size and the 299 bilinear resize happens in "
                        "the Inception preprocess (pytorch-fid's convention)")
    p.add_argument("--inception_score", action="store_true",
                   help="also print IS of --fake (torch-fidelity's isc)")
    p.add_argument("--device", default=None,
                   help="device of the decode and the tower (default: the "
                        "card)")
    return p


def main(argv=None) -> Optional[Dict[str, Any]]:
    args = get_parser().parse_args(argv)

    from frido_tpu_torch.eval.fid import (fid_from_features,
                                          inception_available,
                                          inception_features, load_images,
                                          logits_from_features)
    from frido_tpu_torch.eval.metrics import inception_score

    if not inception_available():
        print("FID skipped: set FRIDO_TPU_INCEPTION to a local pytorch-fid "
              "inception state_dict (zero-egress environment).")
        return None
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    images = [load_images(d, size=args.size, limit=args.limit,
                          device=args.device)
              for d in (args.real, args.fake)]
    t1 = time.perf_counter()
    real, fake = (inception_features(x, device=args.device) for x in images)
    t2 = time.perf_counter()
    out["fid"] = fid_from_features(real, fake)
    print(f"FID: {out['fid']:.4f}")
    if args.inception_score:
        mean, std = inception_score(logits_from_features(fake,
                                                         device=args.device))
        out["is"] = (mean, std)
        print(f"IS: {mean:.4f} +/- {std:.4f}")
    out.update(n=(len(real), len(fake)), load_seconds=t1 - t0,
               feature_seconds=t2 - t1, features=(real, fake))
    return out


if __name__ == "__main__":
    if main() is None:
        sys.exit("eval_fid: no FID computed: FRIDO_TPU_INCEPTION (the "
                 "pytorch-fid InceptionV3 weights) is not set")
