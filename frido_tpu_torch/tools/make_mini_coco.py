"""The JPEG fixtures of the port's data checks, and a mini-COCO-2014 tree
built over them.

    python -m frido_tpu_torch.tools.make_mini_coco [--seed 0] [--out DIR]

writes, from ``--seed``, eight JPEGs at COCO-like sizes into ``DIR``
(default ``frido_tpu_torch/data/fixtures/``): smooth synthetic scenes
(gradients and flat shapes), among them one grey, one progressive, one
with 4:4:4 chroma and the rest 4:2:0, saved by PIL at quality 90; and
``pixels.npz``, each file's pixels as PIL decodes them
(``Image.open(path).convert("RGB")``, uint8), which the card's decoder is
held to, stored as differences along each row (mod 256), which deflate
packs in half the bytes; :func:`fixture_pixels` gives the pixels back.
For the 4:4:4 fixture ``pixels.npz`` also holds libjpeg's coded Y, Cb
and Cr planes (PIL's ``draft("YCbCr")``: no upsampling at 4:4:4, no
colour conversion), :func:`fixture_planes`, which the card decoder's own
planes are held to. The fixtures in the repository were written by this
command with the defaults, on a machine with Pillow (12.1); the card
machine has no PIL, so this part runs only where PIL is. It imports numpy and PIL only.

:func:`write_tree` needs neither: it lays out a COCO-2014 checkout
(``train2014/``, ``val2014/``, ``annotations/instances_*.json`` and
``captions_*.json``) of ``n`` image records whose files are copies of the
fixtures, with seeded boxes and captions, for the t2i config's data
section with ``data_path`` and ``caption_ann_path`` pointed at it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "fixtures")
# (name, width, height, mode, subsampling, progressive)
SPECS = (
    ("landscape_420.jpg", 640, 480, "RGB", 2, False),
    ("portrait_420.jpg", 480, 640, "RGB", 2, False),
    ("small_420.jpg", 500, 375, "RGB", 2, False),
    ("wide_444.jpg", 640, 427, "RGB", 0, False),
    ("progressive_420.jpg", 427, 640, "RGB", 2, True),
    ("grey.jpg", 640, 480, "L", None, False),
    ("square_420.jpg", 612, 612, "RGB", 2, False),
    ("tall_420.jpg", 333, 500, "RGB", 2, False),
)
CATEGORIES = [{"id": i + 1, "name": n, "supercategory": s} for i, (n, s) in
              enumerate([("person", "person"), ("bus", "vehicle"),
                         ("dog", "animal"), ("chair", "furniture"),
                         ("pizza", "food")])]
WORDS = ("a red bus parked on a wet street near two people with umbrellas "
         "a dog sits on a wooden chair beside a table with pizza").split()


def scene(rng: np.random.RandomState, w: int, h: int) -> np.ndarray:
    """A smooth synthetic RGB scene, uint8 [h, w, 3]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        a, b = rng.uniform(-1, 1, 2)
        fx, fy = rng.uniform(1, 6, 2) * np.pi / max(w, h)
        img[..., c] = (128 + 60 * np.sin(fx * x + 3 * a) * np.cos(fy * y + b)
                       + 40 * (x / w - 0.5) * a + 40 * (y / h - 0.5) * b)
    for _ in range(6):                              # flat shapes
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.05, 0.2) * min(w, h)
        color = rng.uniform(20, 235, 3)
        if rng.rand() < 0.5:
            mask = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        else:
            mask = (abs(x - cx) < r) & (abs(y - cy) < 0.6 * r)
        img[mask] = 0.3 * img[mask] + 0.7 * color
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def write_fixtures(out: str = FIXTURES, seed: int = 0) -> Dict[str, tuple]:
    """The JPEGs and ``pixels.npz``; returns {name: (w, h)}."""
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    pixels, sizes = {}, {}
    for name, w, h, mode, sub, prog in SPECS:
        img = Image.fromarray(scene(rng, w, h))
        if mode == "L":
            img = img.convert("L")
        kw = dict(quality=90, progressive=prog, optimize=prog)
        if sub is not None:
            kw["subsampling"] = sub
        path = os.path.join(out, name)
        img.save(path, "JPEG", **kw)
        px = np.asarray(Image.open(path).convert("RGB"))
        pixels[name] = np.diff(px, axis=1, prepend=np.uint8(0))
        sizes[name] = (w, h)
        if sub == 0:
            ycc = Image.open(path)
            ycc.draft("YCbCr", ycc.size)
            pixels[name + ":ycbcr"] = np.diff(np.asarray(ycc), axis=1,
                                              prepend=np.uint8(0))
    np.savez_compressed(os.path.join(out, "pixels.npz"), **pixels)
    return sizes


def _stored(fixtures: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(fixtures, "pixels.npz")) as d:
        return {k: np.cumsum(d[k], axis=1, dtype=np.uint8) for k in d}


def fixture_pixels(fixtures: str = FIXTURES) -> Dict[str, np.ndarray]:
    """{name: uint8 [H, W, 3]}: the PIL-decoded pixels of each fixture."""
    return {k: v for k, v in _stored(fixtures).items() if ":" not in k}


def fixture_planes(fixtures: str = FIXTURES) -> Dict[str, np.ndarray]:
    """{name: uint8 [H, W, 3]}: libjpeg's coded Y, Cb, Cr planes of the
    4:4:4 fixture."""
    return {k.split(":")[0]: v for k, v in _stored(fixtures).items()
            if k.endswith(":ycbcr")}


def fixture_sizes(fixtures: str = FIXTURES) -> Dict[str, tuple]:
    """{name: (w, h)} of the fixtures, from the table above."""
    return {name: (w, h) for name, w, h, *_ in SPECS
            if os.path.exists(os.path.join(fixtures, name))}


def write_tree(root: str, n: int = 64, seed: int = 0,
               fixtures: str = FIXTURES) -> str:
    """A COCO-2014 tree of ``n`` image records per split over the
    fixtures (copies, named as COCO names them), each with 2-5 boxes of
    the five categories and a caption; returns ``root``."""
    sizes = fixture_sizes(fixtures)
    names = sorted(sizes)
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train2014", "val2014"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        images: List[dict] = []
        anns: List[dict] = []
        caps: List[dict] = []
        for i in range(n):
            src = names[i % len(names)]
            w, h = sizes[src]
            ext = os.path.splitext(src)[1]
            fname = f"COCO_{split}_{i + 1:012d}{ext}"
            shutil.copyfile(os.path.join(fixtures, src),
                            os.path.join(d, fname))
            images.append({"id": i + 1, "file_name": fname, "width": w,
                           "height": h, "coco_url": ""})
            for j in range(rng.randint(2, 6)):
                bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
                anns.append({
                    "id": 100 * (i + 1) + j, "image_id": i + 1,
                    "category_id": int(rng.randint(1, len(CATEGORIES) + 1)),
                    "iscrowd": int(rng.rand() < 0.1),
                    "bbox": [float(rng.uniform(0, w - bw)),
                             float(rng.uniform(0, h - bh)),
                             float(bw), float(bh)]})
            words = rng.choice(WORDS, rng.randint(5, 12))
            caps.append({"image_id": i + 1, "id": 10 * (i + 1),
                         "caption": " ".join(words) + "."})
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": CATEGORIES}, f)
        with open(os.path.join(root, "annotations",
                               f"captions_{split}.json"), "w") as f:
            json.dump({"annotations": caps}, f)
    return root


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=FIXTURES)
    args = p.parse_args(argv)
    sizes = write_fixtures(args.out, args.seed)
    total = sum(os.path.getsize(os.path.join(args.out, f))
                for f in os.listdir(args.out))
    print(f"wrote {len(sizes)} JPEGs and pixels.npz to {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
