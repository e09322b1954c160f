"""The port's data layer (``frido_tpu_torch/data/``) against the JAX
package's (``frido_tpu/data/``), on the CPU.

A synthetic mini-COCO-2017 tree (the one of ``tests/test_data.py``: six
images of two categories with captions, here half of them PNG files and
some with more boxes) is written by PIL. Checked exactly against the JAX
package: image ids, annotations, categories, captions, crop boxes, flips,
the conditional builders' rows (objects, objects_bbox, center points),
``collate``, ``split_indices_deterministic``, the loader's order over
epochs and ``set_cursor``'s replay, with both sides at one worker (the JAX
loader's workers share one ``random.Random``). Both pipelines' random
draws are seeded alike (``pipeline.rng``; the builders shuffle with the
global ``random``, seeded before each side's pass).

Pixels, fixed before the comparison:

- against the JAX PIL path (``ImagePipeline.__call__`` on a PIL image,
  ``FRIDO_NATIVE_LOADER=0``), for every crop method with and without the
  flip: max |d| <= 3/127.5 and mean |d| <= 1/127.5 (PIL rounds to uint8
  after each resize pass, the port stays in float);
- against ``frido_tpu.data.native_loader.load_one`` (float on both
  sides, libjpeg's decode on both): max |d| <= 1e-4. The loader runs on
  a private build of ``native/frido_native.cpp`` (``native/Makefile``'s
  flags, into this worker's temporary directory), not on the shared
  ``native/libfrido_native.so``: every pytest-xdist worker reaches the
  JAX loader's build-on-first-use at collection
  (``tests/test_native_loader.py``'s ``skipif``), and one that loads the
  library while another is still writing it marks the loader unavailable
  for good; the case skips only when g++, make or libjpeg is missing. For ``random-2d`` the native loader resizes the crop's window of
  the whole image, reading pixels outside the crop at its edges, where
  PIL (and the port) see only the crop: there the rows and columns whose
  taps stay inside the crop are held to 1e-4, and the edge is shown to
  differ;
- the committed JPEG fixtures (``frido_tpu_torch/data/fixtures/``) through
  both packages' pipelines at 256^2 (``center``, ``random-1d`` with the
  flip, ``random-2d``), the PIL path's bounds;
- PNG decode (``data/image_io.decode_png``) and header sizes exactly
  against PIL;
- the card decoder's upsampling and colour conversion
  (``ops/cuda/jpeg.py``, device-agnostic): ``upsample_plane`` exactly
  against a transcription of libjpeg-turbo's fancy upsampling loops
  (``jdsample.c``) on seeded planes of odd and even sizes, and
  ``ycc_to_rgb`` exactly against PIL on each fixture's full-size YCbCr
  (PIL's ``draft("YCbCr")``: libjpeg's planes, upsampled, unconverted).
"""

import json
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.data import conditional_builder as jcb
from frido_tpu.data import datamodule as jdm
from frido_tpu.data import native_loader as nl
from frido_tpu.data.coco import AnnotatedObjectsCoco as JaxCoco
from frido_tpu.data.helper_types import Annotation as JaxAnnotation
from frido_tpu.data.transforms import ImagePipeline as JaxPipeline
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.data import conditional_builder as pcb
from frido_tpu_torch.data import datamodule as pdm
from frido_tpu_torch.data.coco import AnnotatedObjectsCoco
from frido_tpu_torch.data.helper_types import Annotation
from frido_tpu_torch.data.image_io import (decode_png, image_size,
                                           jpeg_header, jpeg_layout,
                                           load_rgb)
from frido_tpu_torch.data.transforms import ImagePipeline
from frido_tpu_torch.ops.cuda.jpeg import (full_planes, planes_to_rgb,
                                           upsample_plane, ycc_to_rgb)
from frido_tpu_torch.tools.make_mini_coco import (COLOR_SPECS, FIXTURES,
                                                  SPECS, fixture_pixels,
                                                  fixture_planes,
                                                  write_open_images_tree)

torch.set_num_threads(2)

MAX_LEVELS, MEAN_LEVELS = 3 / 127.5, 1 / 127.5
NATIVE_ATOL = 1e-4
METHODS = ("none", "center", "random-1d", "random-2d")
KEYS = ["image", "caption", "file_name", "annotations", "crop_bbox",
        "flipped", "objects", "objects_bbox", "objects_center_points"]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """Six images (three JPEG, three PNG) of two categories, each split."""
    root = tmp_path_factory.mktemp("coco2017")
    for d in ("annotations", "train2017", "val2017"):
        (root / d).mkdir()
    rng = np.random.RandomState(0)
    images, annotations, captions = [], [], []
    for i in range(6):
        ext = ".png" if i % 2 else ".jpg"
        fname = f"{i:012d}{ext}"
        w, h = 64 + 16 * (i % 3), 64 + 8 * (i % 2)
        for split in ("val2017", "train2017"):
            Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(root / split / fname)
        images.append({"id": i, "file_name": fname, "width": w, "height": h,
                       "coco_url": ""})
        for j in range(2 + i % 3):
            annotations.append({
                "id": 10 * i + j, "image_id": i,
                "category_id": 1 + (j % 2), "iscrowd": int(j == 2),
                "bbox": [4.0 + 7 * j, 5.0 + 3 * j, 20.0, 24.0 - j]})
        captions.append({"image_id": i, "id": 1000 + i,
                         "caption": f"a synthetic photo. number {i}."})
    cats = [{"id": 1, "name": "cat", "supercategory": "animal"},
            {"id": 2, "name": "dog", "supercategory": "animal"}]
    inst = {"images": images, "annotations": annotations, "categories": cats}
    for split in ("train2017", "val2017"):
        with open(root / "annotations" / f"instances_{split}.json", "w") as f:
            json.dump(inst, f)
        with open(root / "annotations" / f"captions_{split}.json", "w") as f:
            json.dump({"annotations": captions}, f)
        with open(root / "annotations" / f"stuff_{split}.json", "w") as f:
            json.dump({"images": images, "annotations": [],
                       "categories": []}, f)
    return root


def _args(coco_root, **kw):
    args = dict(
        data_path=str(coco_root), split="validation", keys=list(KEYS),
        target_image_size=32, min_object_area=0.0001,
        min_objects_per_image=0, max_objects_per_image=8,
        crop_method="center", random_flip=False, no_tokens=256,
        use_group_parameter=True, encode_crop=False, use_stuff=False,
        caption_ann_path=str(coco_root / "annotations/captions_val2017.json"))
    args.update(kw)
    return args


def _pair(coco_root, seed=3, **kw):
    """The JAX and the port dataset, their pipelines seeded alike."""
    jds = JaxCoco(**_args(coco_root, **kw))
    pds = AnnotatedObjectsCoco(device="cpu", **_args(coco_root, **kw))
    for ds in (jds, pds):
        if ds.pipeline is not None:
            ds.pipeline.rng = random.Random(seed)
    return jds, pds


def _samples(ds, n=None):
    random.seed(11)
    return [ds[i] for i in range(n or len(ds))]


def _assert_pixels(got, want, max_tol=MAX_LEVELS, mean_tol=MEAN_LEVELS):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= max_tol and d.mean() <= mean_tol, (d.max(), d.mean())


def _same(a, b):
    """Equal values, numpy arrays and Annotation tuples included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split,kw", [
    ("validation", {}), ("train", dict(min_objects_per_image=3)),
    ("validation", dict(use_stuff=True, max_objects_per_image=3)),
    ("validation", dict(num_sample=3, img_id_file="ids"))])
def test_dataset_records_equal_jax(coco_root, split, kw, tmp_path):
    if "img_id_file" in kw:
        ids = tmp_path / "ids.txt"
        ids.write_text("".join(f"{i:012d}\n" for i in (5, 1, 2, 4)))
        kw = dict(kw, img_id_file=str(ids))
    jds, pds = _pair(coco_root, split=split, **kw)
    assert pds.image_ids == jds.image_ids and len(pds) == len(jds) > 0
    assert pds.category_ids == jds.category_ids
    assert pds.category_number == jds.category_number
    assert {k: tuple(v) for k, v in pds.categories.items()} == \
        {k: tuple(v) for k, v in jds.categories.items()}
    assert {k: [tuple(a) for a in v] for k, v in pds.annotations.items()} == \
        {k: [tuple(a) for a in v] for k, v in jds.annotations.items()}
    assert pds.img_id_to_caption_list == jds.img_id_to_caption_list
    assert {k: tuple(v) for k, v in pds.image_descriptions.items()} == \
        {k: tuple(v) for k, v in jds.image_descriptions.items()}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_samples_equal_jax_pil_path(coco_root, method, flip, monkeypatch):
    """Every key exactly (crop boxes, flips, builder rows, captions), the
    pixels within the PIL bounds."""
    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    jds, pds = _pair(coco_root, crop_method=method, random_flip=flip)
    want, got = _samples(jds), _samples(pds)
    for w, g in zip(want, got):
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            if k != "image":
                assert _same(g[k], w[k]), (k, g[k], w[k])
        assert g["image"].dtype == torch.float32
        assert tuple(g["image"].shape) == w["image"].shape == (32, 32, 3)
        _assert_pixels(g["image"], w["image"])
    if flip:
        assert {s["flipped"] for s in got} == {False, True}


@pytest.fixture(scope="module")
def native_library(tmp_path_factory):
    """A private build of the JAX native loader's library, with
    ``native/Makefile``'s rule and flags, in a directory of this worker."""
    native = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    missing = [t for t in ("make", "g++") if shutil.which(t) is None]
    if missing:
        pytest.skip(f"no {' or '.join(missing)} to build the native loader")
    out = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "frido_native.cpp"):
        shutil.copy(os.path.join(native, name), out / name)
    r = subprocess.run(["make", "-C", str(out), "libfrido_native.so"],
                       capture_output=True, text=True)
    if r.returncode and ("jpeglib.h" in r.stderr or "-ljpeg" in r.stderr):
        pytest.skip(f"no libjpeg to build the native loader: {r.stderr}")
    assert r.returncode == 0, r.stdout + r.stderr
    return str(out / "libfrido_native.so")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_pixels_equal_native_loader(method, flip, native_library,
                                    monkeypatch):
    """The port's resize against the native loader's float path on the
    committed JPEG fixtures (same libjpeg decode on both sides)."""
    monkeypatch.delenv("FRIDO_NATIVE_LOADER", raising=False)
    monkeypatch.setattr(nl, "_SO", native_library)
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_build_failed", False)
    assert nl.available()
    for name, *_ in SPECS:
        path = os.path.join(FIXTURES, name)
        img = np.asarray(Image.open(path).convert("RGB"))
        pipe = ImagePipeline(128, method, flip, seed=len(name))
        spec, _, _ = pipe.spec(img.shape[1], img.shape[0])
        rw, rh, cx, cy, cw, ch, fl = spec
        want = nl.load_one(path, 128, resize_to=(rw, rh) if rw else None,
                           crop=(cx, cy, cw, ch) if cw else None,
                           flip=bool(fl))
        got = pipe.apply(torch.from_numpy(img.copy()), spec).numpy()
        if method != "random-2d" or cw == 128:
            np.testing.assert_allclose(got, want, atol=NATIVE_ATOL, rtol=0)
            continue
        # taps of output i reach (i + 0.5) * s +- s of the crop (s = cw /
        # 128): inside it from i >= 1 to i < 127 at these scales
        scale = cw / 128
        m = int(np.ceil(scale + 1))
        inner = slice(m, 128 - m)
        np.testing.assert_allclose(got[inner, inner], want[inner, inner],
                                   atol=NATIVE_ATOL, rtol=0)
        assert np.abs(got - want).max() > NATIVE_ATOL


@pytest.mark.parametrize("method,flip", [("center", False),
                                         ("random-1d", True),
                                         ("random-2d", True)])
def test_fixtures_through_both_pipelines(method, flip):
    """The committed fixtures at 256^2: crop boxes and flips exact, pixels
    within the PIL bounds; the fixtures' PIL pixels are the npz's."""
    pixels = fixture_pixels()
    assert sorted(pixels) == sorted(name for name, *_ in SPECS)
    for name, w, h, mode, *_ in SPECS:
        pil = Image.open(os.path.join(FIXTURES, name))
        assert pil.size == (w, h) and pil.mode == mode
        px = pixels[name]
        np.testing.assert_array_equal(px, np.asarray(pil.convert("RGB")))
        jp = JaxPipeline(256, method, flip, seed=w + h)
        pp = ImagePipeline(256, method, flip, seed=w + h)
        jbox, jflip, want = jp(pil.convert("RGB"))
        pbox, pflip, got = pp(torch.from_numpy(px.copy()))
        assert (pbox, pflip) == (jbox, jflip)
        _assert_pixels(got, want)


def test_png_decode_and_header_sizes_equal_pil(tmp_path):
    """PNGs of every colour type (Pillow picks the row filters: optimize
    makes it try them), and JPEG headers (baseline, progressive, grey)."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 255, (37, 53, 4), dtype=np.uint8)
    base[:, :20] = base[:1, :20]                 # smooth rows for Up/Paeth
    images = {"rgb": Image.fromarray(base[..., :3]),
              "rgba": Image.fromarray(base, "RGBA"),
              "l": Image.fromarray(base[..., 0]),
              "la": Image.fromarray(base[..., :2], "LA"),
              "p": Image.fromarray(base[..., :3]).quantize(17)}
    for name, img in images.items():
        for optimize in (False, True):
            path = tmp_path / f"{name}{int(optimize)}.png"
            img.save(path, optimize=optimize)
            data = path.read_bytes()
            want = np.asarray(Image.open(path).convert("RGB"))
            np.testing.assert_array_equal(decode_png(data, str(path)), want)
            assert image_size(data) == Image.open(path).size
            np.testing.assert_array_equal(
                load_rgb(path, "cpu").numpy(), want)
    for name, w, h, mode, *_ in SPECS:
        data = open(os.path.join(FIXTURES, name), "rb").read()
        assert image_size(data) == (w, h)
        assert jpeg_header(data)[2] == (1 if mode == "L" else 3)
        np.testing.assert_array_equal(
            load_rgb(os.path.join(FIXTURES, name), "cpu").numpy(),
            np.asarray(Image.open(os.path.join(FIXTURES, name))
                       .convert("RGB")))


def test_cmyk_jpeg_is_refused_with_its_name(tmp_path):
    """A CMYK JPEG is decoded now, as PIL converts it; what stays refused
    with the file's name is a component count other than 1, 3 or 4 (here
    a CMYK file whose frame header is rewritten to claim 2)."""
    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(path)
    np.testing.assert_array_equal(
        load_rgb(path, "cpu").numpy(),
        np.asarray(Image.open(path).convert("RGB")))
    data = bytearray(path.read_bytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 9] = 2
    bad = tmp_path / "two.jpg"
    bad.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="two.jpg"):
        load_rgb(bad, "cpu")


def test_colour_layouts_equal_pil():
    """The CMYK (4:4:4, 4:2:0), YCCK and Adobe RGB fixtures: their colour
    space read from the markers as libjpeg reads it; ``load_rgb`` on the
    CPU equal to PIL's committed pixels; and the card path's arithmetic
    (``full_planes`` + ``planes_to_rgb``, as ``decode_jpeg`` runs it on
    nvJPEG's planes) on libjpeg's own coded planes equal to PIL's RGB, 0
    levels: CMYK with the Adobe inversion, YCCK through libjpeg's
    ``ycck_cmyk_convert``, RGB as coded."""
    pixels, planes = fixture_pixels(specs=COLOR_SPECS), fixture_planes()
    src = {"cmyk_444.jpg": "cmyk_444.jpg", "ycck_444.jpg": "cmyk_444.jpg",
           "rgb_444.jpg": "wide_444.jpg"}
    for name, w, h, space, sub, _ in COLOR_SPECS:
        path = os.path.join(FIXTURES, name)
        layout = jpeg_layout(open(path, "rb").read(), name)
        assert (layout.width, layout.height, layout.colorspace) == \
            (w, h, space)
        assert layout.adobe_transform == {"cmyk": 0, "ycck": 2,
                                          "rgb": 0}[space]
        got = load_rgb(path, "cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), pixels[name])
        if name in src:
            coded = torch.from_numpy(planes[src[name]].copy())
            full = full_planes(list(coded.to(torch.uint8).unbind(-1)),
                               layout, name)
            rgb = planes_to_rgb(full, space, True)
            np.testing.assert_array_equal(rgb.numpy(), pixels[name])


@pytest.mark.parametrize("encode_crop", [False, True])
@pytest.mark.parametrize("kind", ["ObjectsConditionalBuilder",
                                  "ObjectsBoundingBoxConditionalBuilder",
                                  "ObjectsCenterPointsConditionalBuilder"])
def test_builder_rows_equal_jax(kind, encode_crop):
    rng = np.random.RandomState(4)

    def anns(cls):
        return [cls(area=0.1, image_id="0", category_no=int(rng_i % 5),
                    category_id=str(rng_i % 5), is_group_of=bool(rng_i % 2),
                    bbox=tuple(float(v) for v in box))
                for rng_i, box in zip(range(9), boxes)]

    boxes = rng.uniform(0, 0.5, (9, 4))
    crops = [None, (0.1, 0.0, 0.8, 1.0), (0.0, 0.2, 1.0, 0.5)]
    j = getattr(jcb, kind)(5, 7, 256, encode_crop, True, False)
    p = getattr(pcb, kind)(5, 7, 256, encode_crop, True, False)
    for crop in crops:
        for flip in (False, True):
            random.seed(9)
            want = j.build(anns(JaxAnnotation), crop, flip)
            random.seed(9)
            got = p.build(anns(Annotation), crop, flip)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert p.inverse_build(got) == j.inverse_build(want)


def test_collate_equals_jax(coco_root):
    _, pds = _pair(coco_root)
    samples = _samples(pds, 3)
    got = pdm.collate(samples)
    plain = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in s.items()} for s in samples]
    want = jdm.collate(plain)
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert _same(g, want[k]), k
    assert isinstance(got["image"], torch.Tensor)
    assert got["image"].shape == (3, 32, 32, 3)


def test_split_indices_equal_jax():
    for n in (0, 1, 5, 8, 31, 100):
        for n_split in (1, 2, 3, 7):
            parts = [pdm.split_indices_deterministic(n, n_split, i)
                     for i in range(n_split)]
            for i, part in enumerate(parts):
                assert part == jdm.split_indices_deterministic(n, n_split, i)
            assert sorted(sum(parts, [])) == list(range(n))


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_over_epochs_and_cursor_equal_jax(drop_last):
    def orders(loader, epochs):
        return [[b["i"].tolist() for b in loader] for _ in range(epochs)]

    kw = dict(batch_size=3, shuffle=True, num_workers=1, drop_last=drop_last,
              seed=4)
    j = jdm.DataLoader(_Indexed(11), **kw)
    p = pdm.DataLoader(_Indexed(11), **kw)
    want, got = orders(j, 3), orders(p, 3)
    assert got == want and len(p) == len(j)
    assert want[0] != want[1]
    for loader in (j, p):
        loader.set_cursor(1, 2)
    replay = orders(p, 2)
    assert replay == orders(j, 2)
    assert replay[0] == want[1][2:] and replay[1] == want[2]
    # a threaded loader gives the same batches
    t = pdm.DataLoader(_Indexed(11), **dict(kw, num_workers=4))
    assert orders(t, 3) == want


def test_coco_loader_equals_jax_and_workers_do_not_change_it(coco_root,
                                                             monkeypatch):
    """The datamodule's train loader (random-1d crop, flip): batches over
    two epochs equal the JAX loader's at one worker; the port's with four
    workers draws the same plans in the same order."""
    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    kw = dict(crop_method="random-1d", random_flip=True, split="train",
              caption_ann_path=str(coco_root /
                                   "annotations/captions_train2017.json"))
    runs = []
    for mod, workers in ((jdm, 1), (pdm, 1), (pdm, 4)):
        jds, pds = _pair(coco_root, **kw)
        ds = jds if mod is jdm else pds
        loader = mod.DataLoader(ds, 2, shuffle=True, num_workers=workers,
                                drop_last=True)
        random.seed(11)
        runs.append([b for _ in range(2) for b in loader])
    want = runs[0]
    for got in runs[1:]:
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            for k in KEYS:
                if k != "image":
                    assert _same(g[k], w[k]), k
            _assert_pixels(g["image"].numpy(), w["image"])


def test_rank_rows_make_the_global_batch(coco_root):
    """World size 2: each rank's rows are its own and together they are
    the one-process batch (plans drawn over the whole global batch)."""
    kw = dict(crop_method="random-1d", random_flip=True)
    batches = {}
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        _, pds = _pair(coco_root, **kw)
        loader = pdm.DataLoader(pds, 4, shuffle=True, num_workers=1,
                                rank=rank, world_size=world)
        random.seed(11)
        batches[rank, world] = [b for _ in range(2) for b in loader]
    full = batches[0, 1]
    assert len(full) == 4               # 6 images, batches of 4 and 2
    for b, r0, r1 in zip(full, batches[0, 2], batches[1, 2]):
        n = len(b["file_name"])
        assert r0["file_name"] == b["file_name"][:n // 2]
        assert r1["file_name"] == b["file_name"][n // 2:]
        assert torch.equal(torch.cat([r0["image"], r1["image"]]),
                           b["image"])
        for k in ("objects_bbox", "crop_bbox", "flipped"):
            assert _same(np.concatenate([np.asarray(r0[k]),
                                         np.asarray(r1[k])]),
                         np.asarray(b[k])), k
    with pytest.raises(ValueError, match="does not split"):
        pdm.DataLoader(_Indexed(4), 3, world_size=2)


@pytest.mark.parametrize("n, world", [(9, 2), (7, 4), (5, 4)])
def test_a_last_batch_that_does_not_split_is_cut_and_named(n, world):
    """Without drop_last, a last batch that does not split over the ranks
    loses its last len % world samples on every rank, named in a warning;
    every rank's rows are equal in number."""
    rows = {}
    for rank in range(world):
        loader = pdm.DataLoader(_Indexed(n), 4, rank=rank, world_size=world)
        with pytest.warns(UserWarning, match="skipped") as caught:
            rows[rank] = [b["i"].tolist() for b in loader]
        cut = list(range(n - (n % 4) % world, n))
        assert str(cut) in str(caught[0].message)
    sizes = {tuple(len(b) for b in r) for r in rows.values()}
    assert len(sizes) == 1
    kept = sorted(i for r in rows.values() for b in r for i in b)
    assert kept == list(range(n - (n % 4) % world))


def test_datamodule_from_config_equals_jax(coco_root, monkeypatch):
    """The config target ``main.DataModuleFromConfig``: the test split cut
    into shards as the JAX module cuts it."""
    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    ds = {"target": "taming.data.annotated_objects_coco.AnnotatedObjectsCoco",
          "params": _args(coco_root)}
    for idx in range(3):
        cfg = {"target": "main.DataModuleFromConfig",
               "params": {"batch_size": 2, "test": ds, "num_workers": 1,
                          "n_split_dataset": 3, "idx_split_dataset": idx}}
        j = jax_instantiate(cfg).setup()
        p = instantiate_from_config(cfg, device="cpu").setup()
        want = [b["file_name"] for b in j.test_dataloader()]
        got = [b["file_name"] for b in p.test_dataloader()]
        assert got == want and got


def test_unported_datasets_and_default_device(coco_root, monkeypatch):
    """The Visual Genome, VG-cocostyle and OpenImages targets, refused
    before, resolve to the port's datasets (the JAX package's classes'
    counterparts); a dataset runs on the card by default."""
    from frido_tpu.config import resolve_target as jax_resolve
    from frido_tpu_torch.config import resolve_target

    for target in ("taming.data.annotated_objects_vg.AnnotatedObjectsVg",
                   "taming.data.annotated_objects_vg_cocostyle."
                   "AnnotatedObjectsVg",
                   "taming.data.annotated_objects_open_images."
                   "AnnotatedObjectsOpenImages"):
        got, want = resolve_target(target), jax_resolve(target)
        assert got.__module__.startswith("frido_tpu_torch.data.")
        assert (got.__module__.split(".")[-1], got.__name__) == \
            (want.__module__.split(".")[-1], want.__name__)
        with pytest.raises(TypeError):
            instantiate_from_config({"target": target, "params": {}},
                                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnnotatedObjectsCoco(**_args(coco_root))


def _libjpeg_upsample(p, hs, vs):
    """libjpeg-turbo's ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``
    and ``h2v2_fancy_upsample`` (``jdsample.c``), loop for loop, the
    context rows above and below the image repeating its edge rows; other
    factors (and 2:1 planes of width <= 2) replicate."""
    h, w = p.shape
    row = lambda r: p[min(max(r, 0), h - 1)]        # noqa: E731
    if (hs, vs) == (2, 1) and w > 2:
        out = np.zeros((h, 2 * w), np.int64)
        for y in range(h):
            i, o = p[y], out[y]
            o[0], o[1] = i[0], (i[0] * 3 + i[1] + 2) >> 2
            for x in range(1, w - 1):
                o[2 * x] = (i[x] * 3 + i[x - 1] + 1) >> 2
                o[2 * x + 1] = (i[x] * 3 + i[x + 1] + 2) >> 2
            o[2 * w - 2], o[2 * w - 1] = (i[w - 1] * 3 + i[w - 2] + 1) >> 2, \
                i[w - 1]
        return out
    if (hs, vs) == (1, 2):
        out = np.zeros((2 * h, w), np.int64)
        for y in range(h):
            out[2 * y] = (row(y) * 3 + row(y - 1) + 1) >> 2
            out[2 * y + 1] = (row(y) * 3 + row(y + 1) + 2) >> 2
        return out
    if (hs, vs) == (2, 2) and w > 2:
        out = np.zeros((2 * h, 2 * w), np.int64)
        for y in range(h):
            for v, near in ((0, row(y - 1)), (1, row(y + 1))):
                c = row(y) * 3 + near
                o = out[2 * y + v]
                o[0], o[1] = (c[0] * 4 + 8) >> 4, (c[0] * 3 + c[1] + 7) >> 4
                for x in range(1, w - 1):
                    o[2 * x] = (c[x] * 3 + c[x - 1] + 8) >> 4
                    o[2 * x + 1] = (c[x] * 3 + c[x + 1] + 7) >> 4
                o[2 * w - 2] = (c[w - 1] * 3 + c[w - 2] + 8) >> 4
                o[2 * w - 1] = (c[w - 1] * 4 + 7) >> 4
        return out
    return p.repeat(vs, 0).repeat(hs, 1)


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                   (4, 2)])
@pytest.mark.parametrize("h,w", [(5, 7), (6, 2), (1, 9), (8, 8)])
def test_upsample_plane_equals_libjpeg_loops(hs, vs, h, w):
    p = np.random.RandomState(h * w + hs).randint(0, 256, (h, w))
    got = upsample_plane(torch.from_numpy(p.astype(np.int32)), hs, vs)
    np.testing.assert_array_equal(got.numpy(), _libjpeg_upsample(p, hs, vs))


def test_ycc_to_rgb_equals_libjpeg():
    for name, w, h, mode, *_ in SPECS:
        if mode == "L":
            continue
        path = os.path.join(FIXTURES, name)
        img = Image.open(path)
        img.draft("YCbCr", img.size)
        assert img.mode == "YCbCr" and img.size == (w, h)
        ycc = torch.from_numpy(np.asarray(img).astype(np.int32))
        got = ycc_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2])
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(Image.open(path).convert("RGB")))


# ---- a resume replays the plans ------------------------------------------
def test_resumed_loader_replays_the_plans(coco_root):
    """A loader resumed at epoch 1, batch 1 (``set_cursor``) on a fresh
    dataset seeded as the first was yields the uninterrupted loader's
    batches from there: random-1d crops, flips and the builders' shuffles
    of several annotations an image (``objects_bbox``) included, at one
    worker and at four. It draws the plans of the batches it skips, from
    the seed, without their pixels."""
    kw = dict(crop_method="random-1d", random_flip=True, split="train",
              caption_ann_path=str(coco_root /
                                   "annotations/captions_train2017.json"))

    def loader(workers):
        _, pds = _pair(coco_root, **kw)
        pds.rng = random.Random(5)
        random.seed(11)
        return pdm.DataLoader(pds, 2, shuffle=True, num_workers=workers,
                              drop_last=True)

    straight = loader(1)
    want = [b for _ in range(2) for b in straight]
    assert len(want) == 6
    for workers in (1, 4):
        resumed = loader(workers)
        resumed.set_cursor(1, 1)
        got = list(resumed)
        assert len(got) == 2
        for g, w in zip(got, want[4:]):
            for k in KEYS:
                if k == "image":
                    assert torch.equal(g[k], w[k])
                else:
                    assert _same(g[k], w[k]), k
    flips = [f for b in want for f in b["flipped"]]
    assert len(set(flips)) == 2


# ---- Visual Genome, VG-cocostyle and OpenImages --------------------------
_VG_FILES = ("landscape_420.jpg", "grey.jpg", "cmyk_444.jpg")   # 640x480


@pytest.fixture(scope="module")
def vg_root(tmp_path_factory):
    """A synthetic VG dump (``tests/test_vg_preprocess.py``'s, four
    objects an image) through ``scripts/preprocess_vg_sg2im.py``,
    ``preprocess_vg_to_sg.py`` and ``convert_vg_to_coco_style.py``; a
    second and third caption added to each image of ``train_sg.json``;
    ``VG_100K/<id>.jpg`` copies of the 640x480 fixtures (a CMYK one
    among them)."""
    import shutil
    import subprocess
    import sys

    root = tmp_path_factory.mktemp("vg")
    images, objects, rels, attrs = [], [], [], []
    (root / "VG_100K").mkdir()
    for iid in range(1, 13):
        shutil.copyfile(os.path.join(FIXTURES, _VG_FILES[iid % 3]),
                        root / "VG_100K" / f"{iid}.jpg")
        images.append(dict(image_id=iid, width=640, height=480,
                           url=f"http://vg/VG_100K/{iid}.jpg"))
        objects.append(dict(image_id=iid, objects=[
            dict(object_id=iid * 10 + j, names=[n], x=10 * j + iid,
                 y=5 * j, w=100 + 10 * j, h=120)
            for j, n in enumerate(["person", "dog", "tree", "person"])]))
        rels.append(dict(image_id=iid, relationships=[dict(
            relationship_id=iid, predicate="next to",
            subject=dict(object_id=iid * 10),
            object=dict(object_id=iid * 10 + 1))]))
        attrs.append(dict(image_id=iid, attributes=[dict(
            object_id=iid * 10, attributes=["tall"])]))
    for name, payload in [("image_data.json", images),
                          ("objects.json", objects),
                          ("relationships.json", rels),
                          ("attributes.json", attrs)]:
        (root / name).write_text(json.dumps(payload))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = [["preprocess_vg_sg2im.py", "--vg_dir", str(root),
             "--min_object_instances", "2", "--min_attribute_instances", "2",
             "--min_relationship_instances", "2",
             "--min_objects_per_image", "2"]]
    for split in ("train", "val"):
        runs += [["preprocess_vg_to_sg.py", "--base_dir", str(root),
                  "--split", split],
                 ["convert_vg_to_coco_style.py", "-b", str(root), "-s",
                  split]]
    for script, *args in runs:
        subprocess.run([sys.executable, os.path.join(repo, "scripts", script),
                        *args], check=True, capture_output=True)
    sg = json.loads((root / "train_sg.json").read_text())
    for a in list(sg["annotations"]):
        for k in (1, 2):
            sg["annotations"].append(dict(a, id=a["id"] + 100 * k,
                                          caption=f"{a['caption']} {k}."))
    (root / "train_sg.json").write_text(json.dumps(sg))
    return root


def _vg_kw(root, **kw):
    args = dict(data_path=str(root), split="train", target_image_size=32,
                min_object_area=1e-5, min_objects_per_image=0,
                max_objects_per_image=8, crop_method="random-1d",
                random_flip=True, no_tokens=1024, use_group_parameter=True,
                encode_crop=True, use_stuff=False)
    args.update(kw)
    return args


def _equal_samples(jds, pds, keys):
    """Every sample of both datasets, their draws seeded alike: the keys
    exactly, the pixels within the PIL path's bounds."""
    for ds in (jds, pds):
        ds.pipeline.rng = random.Random(3)
    want, got = _samples(jds), _samples(pds)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert set(g) == set(w) == set(keys)
        for k in keys:
            if k != "image":
                assert _same(g[k], w[k]), (k, g[k], w[k])
        _assert_pixels(g["image"], w["image"])
    return got


def test_vg_samples_equal_jax(vg_root, monkeypatch):
    from frido_tpu.data.vg import AnnotatedObjectsVg as JaxVg
    from frido_tpu_torch.data.vg import AnnotatedObjectsVg

    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    keys = ["image", "caption", "file_name", "crop_bbox", "flipped"]
    kw = _vg_kw(vg_root, keys=keys,
                caption_ann_path=str(vg_root / "train_sg.json"))
    got = _equal_samples(JaxVg(**kw), AnnotatedObjectsVg(device="cpu", **kw),
                         keys)
    assert len({s["caption"][-1] for s in got}) > 1      # choices drawn


def test_vg_cocostyle_samples_equal_jax(vg_root, monkeypatch):
    from frido_tpu.data.vg_cocostyle import (AnnotatedObjectsVgCocoStyle
                                             as JaxVgCoco)
    from frido_tpu_torch.data.vg_cocostyle import AnnotatedObjectsVgCocoStyle

    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    keys = ["image", "objects_bbox", "file_name", "annotations",
            "crop_bbox", "flipped"]
    kw = _vg_kw(vg_root, keys=keys, min_objects_per_image=3)
    jds = JaxVgCoco(**kw)
    pds = AnnotatedObjectsVgCocoStyle(device="cpu", **kw)
    assert pds.category_number == jds.category_number
    got = _equal_samples(jds, pds, keys)
    assert all(len(s["annotations"]) == 4 for s in got)


@pytest.fixture(scope="module")
def oi_root(tmp_path_factory):
    """``tools/make_mini_coco.write_open_images_tree``: 6 images, every
    top-300 class, the tortoise, a class outside the table, detections
    that the unification maps onto Person and boxes too small."""
    return write_open_images_tree(
        str(tmp_path_factory.mktemp("oi") / "train"), n=6, seed=8)


def test_open_images_samples_equal_jax(oi_root, monkeypatch):
    from frido_tpu.data.open_images import (AnnotatedObjectsOpenImages as
                                            JaxOpenImages)
    from frido_tpu_torch.data.open_images import AnnotatedObjectsOpenImages

    monkeypatch.setenv("FRIDO_NATIVE_LOADER", "0")
    keys = ["image", "objects_bbox", "file_name", "annotations",
            "crop_bbox", "flipped"]
    kw = _vg_kw(oi_root, keys=keys, min_objects_per_image=2,
                max_objects_per_image=30, use_additional_parameters=False)
    del kw["use_stuff"]
    with pytest.warns(UserWarning, match="subset of OpenImages"):
        jds = JaxOpenImages(**kw)
    with pytest.warns(UserWarning, match="subset of OpenImages"):
        pds = AnnotatedObjectsOpenImages(device="cpu", **kw)
    assert pds.category_ids == jds.category_ids
    assert pds.category_ids[-1] == "/m/01s55n"
    assert pds.image_ids == jds.image_ids
    got = _equal_samples(jds, pds, keys)
    cats = {a.category_id for s in got for a in s["annotations"]}
    assert "/m/01g317" in cats and "/m/03bt1vf" not in cats
    assert "/m/zzzz" not in cats
