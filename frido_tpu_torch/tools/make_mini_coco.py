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
planes are held to. Four more files (``COLOR_SPECS``) carry the colour
layouts libjpeg reads besides JFIF YCbCr: CMYK at 4:4:4 (with its coded
planes) and 4:2:0, YCCK and Adobe RGB; they are not in the tree. The fixtures in the repository were written by this
command with the defaults, on a machine with Pillow (12.1); the card
machine has no PIL, so this part runs only where PIL is. It imports numpy and PIL only.

:func:`write_tree`, :func:`write_vg_tree` and
:func:`write_open_images_tree` need neither. The first lays out a
COCO-2014 checkout
(``train2014/``, ``val2014/``, ``annotations/instances_*.json`` and
``captions_*.json``) of ``n`` image records whose files are copies of the
fixtures, with seeded boxes and captions, for the t2i config's data
section with ``data_path`` and ``caption_ann_path`` pointed at it; the
others a Visual Genome checkout (with the files its preprocessing
scripts write) and an OpenImages split, for the VG, VG-cocostyle and
OpenImages configs' data sections.
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
# colour layouts other than JFIF YCbCr, not in the tree (name, width,
# height, colour space, subsampling, source): CMYK as PIL writes it (Adobe
# APP14, transform 0, inverted), YCCK and RGB made from another fixture by
# rewriting its markers (PIL writes neither): the CMYK file with its Adobe
# transform set to 2, the 4:4:4 file with its JFIF APP0 replaced by an
# Adobe APP14 of transform 0
COLOR_SPECS = (
    ("cmyk_444.jpg", 640, 480, "cmyk", 0, None),
    ("cmyk_420.jpg", 500, 375, "cmyk", 2, None),
    ("ycck_444.jpg", 640, 480, "ycck", 0, "cmyk_444.jpg"),
    ("rgb_444.jpg", 640, 427, "rgb", 0, "wide_444.jpg"),
)
_ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
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
    for name, w, h, space, sub, src in COLOR_SPECS:
        path = os.path.join(out, name)
        if src is None:                 # CMYK: the scene inverted, K a ramp
            rgb = scene(rng, w, h).astype(np.int32)
            k = (np.linspace(0, 160, w)[None, :] * np.ones((h, 1))
                 ).astype(np.int32)
            cmyk = np.concatenate([255 - rgb - k[..., None] // 2,
                                   k[..., None]], -1)
            Image.fromarray(np.clip(cmyk, 0, 255).astype(np.uint8),
                            "CMYK").save(path, "JPEG", quality=90,
                                         subsampling=sub)
            if sub == 0:                # the coded planes, Adobe-inverted
                pixels[name + ":planes"] = np.diff(
                    255 - np.asarray(Image.open(path)), axis=1,
                    prepend=np.uint8(0))
        else:
            with open(os.path.join(out, src), "rb") as f:
                data = bytearray(f.read())
            if space == "ycck":
                i = data.index(b"Adobe")
                data[i + 11] = 2
            else:                       # rgb: APP0 -> Adobe, transform 0
                n = int.from_bytes(data[4:6], "big")
                data = data[:2] + _ADOBE_RGB + data[4 + n:]
            with open(path, "wb") as f:
                f.write(bytes(data))
        pixels[name] = np.diff(np.asarray(Image.open(path).convert("RGB")),
                               axis=1, prepend=np.uint8(0))
    np.savez_compressed(os.path.join(out, "pixels.npz"), **pixels)
    return sizes


def _stored(fixtures: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(fixtures, "pixels.npz")) as d:
        return {k: np.cumsum(d[k], axis=1, dtype=np.uint8) for k in d}


def fixture_pixels(fixtures: str = FIXTURES,
                   specs=SPECS) -> Dict[str, np.ndarray]:
    """{name: uint8 [H, W, 3]}: the PIL-decoded pixels of each fixture of
    ``specs`` (``SPECS``, or ``COLOR_SPECS``)."""
    names = {s[0] for s in specs}
    return {k: v for k, v in _stored(fixtures).items() if k in names}


def fixture_planes(fixtures: str = FIXTURES) -> Dict[str, np.ndarray]:
    """{name: uint8 [H, W, C]}: libjpeg's coded planes of the 4:4:4
    fixtures: Y, Cb, Cr of the YCbCr one, C, M, Y, K of the CMYK one."""
    return {k.split(":")[0]: v for k, v in _stored(fixtures).items()
            if k.endswith((":ycbcr", ":planes"))}


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


def _fixture_cycle(fixtures: str, specs) -> List[str]:
    return sorted(name for name, *_ in specs
                  if os.path.exists(os.path.join(fixtures, name)))


def write_vg_tree(root: str, n: int = 24, seed: int = 0,
                  fixtures: str = FIXTURES) -> str:
    """A Visual Genome checkout of ``n`` images (copies of the fixtures,
    the colour layouts' included, as ``VG_100K/<id>.jpg``) with what the
    VG preprocessing scripts write from it: ``image_data.json``, the
    scene-graph caption JSONs ``{train,val}_sg.json`` (1-3 captions an
    image) and the COCO-style boxes ``{train,val}_coco_style.json`` (3-6
    boxes of four categories an image); both splits hold every image.
    Returns ``root``."""
    sizes = {name: (w, h) for name, w, h, *_ in SPECS + COLOR_SPECS}
    names = _fixture_cycle(fixtures, SPECS + COLOR_SPECS)
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "VG_100K"), exist_ok=True)
    cats = [{"id": i, "name": nm, "supercategory": nm}
            for i, nm in enumerate(("__image__", "person", "dog", "tree",
                                    "car"))]
    raw, images, caps, anns = [], [], [], []
    for i in range(n):
        src = names[i % len(names)]
        w, h = sizes[src]
        iid = i + 1
        shutil.copyfile(os.path.join(fixtures, src),
                        os.path.join(root, "VG_100K", f"{iid}.jpg"))
        raw.append({"image_id": iid, "width": w, "height": h,
                    "url": f"https://vg/VG_100K/{iid}.jpg"})
        images.append({"id": iid, "file_name": f"{iid}.jpg", "width": w,
                       "height": h, "coco_url": raw[-1]["url"]})
        for j in range(rng.randint(1, 4)):
            words = rng.choice(WORDS, rng.randint(3, 7))
            caps.append({"image_id": iid, "id": 10 * iid + j,
                         "caption": " ".join(words) + "."})
        for j in range(rng.randint(3, 7)):
            bw, bh = rng.uniform(0.2, 0.6) * w, rng.uniform(0.2, 0.6) * h
            anns.append({"id": 100 * iid + j, "image_id": iid, "iscrowd": 0,
                         "category_id": int(rng.randint(1, len(cats))),
                         "bbox": [float(rng.uniform(0, w - bw)),
                                  float(rng.uniform(0, h - bh)),
                                  float(bw), float(bh)], "segmentation": []})
    with open(os.path.join(root, "image_data.json"), "w") as f:
        json.dump(raw, f)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_sg.json"), "w") as f:
            json.dump({"images": images, "annotations": caps}, f)
        with open(os.path.join(root, f"{split}_coco_style.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    return root


def write_vg_raw(root: str, n: int = 30, seed: int = 0) -> Dict[str, str]:
    """A raw Visual Genome dump (``image_data.json``, ``objects.json``,
    ``relationships.json``, ``attributes.json``), the input of
    ``tools/preprocess_vg_sg2im.py``: ``n`` images (two below the default
    ``min_image_size``), 1-9 objects each from a small name pool (some
    small, one name rare, some in capitals, two with aliases), 0-6
    relationships, 0-2 attributes an object; and alias files. Returns the
    alias flags for the preprocessing."""
    rng = np.random.default_rng(seed)
    names = ["person", "dog", "tree", "car", "man", "hat", "rare thing"]
    preds = ["next to", "on", "wearing", "near", "holding", "beside"]
    images, objects, rels, attrs = [], [], [], []
    for iid in range(1, n + 1):
        w, h = (150, 120) if iid in (4, 17) else (640, 480)
        images.append(dict(image_id=iid, width=w, height=h,
                           url=f"http://vg/VG_100K_2/{iid}.jpg"))
        objs = []
        for j in range(int(rng.integers(1, 10))):
            name = names[int(rng.integers(0, 6))] if j else "rare thing"
            side = int(rng.integers(10, 200))
            objs.append(dict(object_id=iid * 100 + j,
                             names=[name.upper() if j % 4 == 3 else name],
                             x=int(rng.integers(0, 300)),
                             y=int(rng.integers(0, 200)), w=side,
                             h=int(rng.integers(10, 200))))
        objects.append(dict(image_id=iid, objects=objs))
        rl = []
        for r in range(int(rng.integers(0, 7))):
            s, o = rng.choice(len(objs), 2)
            rl.append(dict(relationship_id=iid * 1000 + r,
                           predicate=preds[int(rng.integers(0, 6))],
                           subject=dict(object_id=objs[s]["object_id"]),
                           object=dict(object_id=objs[o]["object_id"])))
        rels.append(dict(image_id=iid, relationships=rl))
        attrs.append(dict(image_id=iid, attributes=[
            dict(object_id=o["object_id"],
                 attributes=[str(a) for a in rng.choice(
                     ["tall", "red", "Red", "old"], int(rng.integers(0, 3)))])
            for o in objs]))
    os.makedirs(root, exist_ok=True)
    for name, payload in [("image_data.json", images),
                          ("objects.json", objects),
                          ("relationships.json", rels),
                          ("attributes.json", attrs)]:
        with open(os.path.join(root, name), "w") as f:
            json.dump(payload, f)
    aliases = {"--object_aliases": ("object_alias.txt",
                                    "man,person\nhat,cap\n"),
               "--relationship_aliases": ("pred_alias.txt",
                                          "beside,next to\n")}
    flags = {}
    for flag, (name, text) in aliases.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
        flags[flag] = os.path.join(root, name)
    return flags


def write_open_images_tree(root: str, n: int = 6, seed: int = 0,
                           fixtures: str = FIXTURES) -> str:
    """An OpenImages split at ``root`` (``metadata/classes.csv``,
    ``labels/detections.csv``, ``metadata/image_ids.csv``,
    ``data/<16-digit id>.jpg`` copies of the fixtures): every class of the
    port's top-300 table (Person under its real id ``/m/01g317``, the
    unification's target; the others under made-up ids), the tortoise
    (pinned last in the numbering) and a class outside the table; 2-5
    detections an image, among them classes that the unification maps
    onto Person, boxes too small for ``min_object_area`` 1e-5 and the
    class outside the table. Returns ``root``."""
    import csv

    with open(os.path.join(os.path.dirname(FIXTURES),
                           "open_images_data.json")) as f:
        top300 = json.load(f)["top_300_classes_plus_coco_compatibility"]
    for d in ("metadata", "labels", "data"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = sorted({c[0] for c in top300})
    mids = {nm: ("/m/01g317" if nm == "Person" else f"/m/x{i:04d}")
            for i, nm in enumerate(names)}
    with open(os.path.join(root, "metadata", "classes.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        for nm, m in mids.items():
            w.writerow([m, nm])
        w.writerow(["/m/01s55n", "Tortoise"])
        w.writerow(["/m/zzzz", "Not in the table"])
    labels = [mids["Car"], mids["Dog"], "/m/03bt1vf", mids["Tree"],
              "/m/zzzz", mids["Person"]]
    files = _fixture_cycle(fixtures, SPECS + COLOR_SPECS)
    rng = np.random.RandomState(seed)
    rows, ids = [], []
    for i in range(n):
        iid = f"{rng.randint(1 << 30):016x}"
        ids.append(iid)
        shutil.copyfile(os.path.join(fixtures, files[i % len(files)]),
                        os.path.join(root, "data", f"{iid}.jpg"))
        for j in range(2 + i % 4):
            x0, y0 = rng.uniform(0, 0.6, 2)
            side = 0.001 if j == 3 else rng.uniform(0.1, 0.4)
            rows.append(dict(
                ImageID=iid, Source="xclick",
                LabelName=labels[(i + j) % len(labels)], Confidence="1",
                XMin=x0, XMax=x0 + side, YMin=y0, YMax=y0 + side * 1.2,
                IsOccluded=j % 2, IsTruncated=0, IsGroupOf=int(j == 1),
                IsDepiction=0, IsInside=0))
    with open(os.path.join(root, "labels", "detections.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(root, "metadata", "image_ids.csv"), "w") as f:
        f.write("\n".join(ids))
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
