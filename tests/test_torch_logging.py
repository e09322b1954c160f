"""The port's image logging against the JAX package's, on the CPU.

- ``log_txt_as_img`` and ``plot_bbox_conditioning``
  (``frido_tpu_torch/utils/visualize.py``, drawn from the committed glyph
  table without PIL) equal the JAX package's, which draws with PIL, at 0
  levels: captions of one and several lines at several canvas widths,
  ``objects`` label lists, layout2i box sequences with and without the
  crop, glyph boxes that overlap (``"AVATAR To WAVE fi ff"``), and code
  points outside ASCII, the font lacking some of them (``.notdef``).
- ``FridoDiffusion.log_images`` on the toy t2i model of
  ``tests/test_torch_models.py`` (the same weights in both packages) for
  every key it gives, ``file_name`` included: with the ``objects``
  conditioning and every ``plot_*`` gate on (DDIM-4 samples at eta 1,
  their quantized decode, the diffusion and denoise rows of ``log_rows``,
  the progressive row of the full 40-step chain), and with ``caption``
  and ``objects_bbox`` conditioning and no sampling. The port's noise
  function is fed the JAX package's draws in the order it asks for them
  (``tests/test_torch_samplers.py``'s replay of ``jax.random.split``).
  Tolerances, fixed before the comparison: the decode parity tests'
  3e-4 for images one decode away from the inputs (``inputs``,
  ``reconstruction``, ``diffusion_row``), the sampler parity tests' 1e-3
  for images decoded from a sampler's chain, 0 for the renders.
- ``ImageLogger`` writes the JAX package's file names, and the PNGs read
  back equal the JAX package's (PIL's) pixel for pixel.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from frido_tpu.data import conditional_builder as jax_builders
from frido_tpu.training.image_logger import ImageLogger as JaxImageLogger
from frido_tpu.utils import visualize as jax_vz
from frido_tpu_torch.data import conditional_builder as port_builders
from frido_tpu_torch.schedules import DDIMSchedule
from frido_tpu_torch.training.image_logger import ImageLogger
from frido_tpu_torch.utils import visualize as vz
from frido_tpu_torch.utils.visualize import read_png
from tests.test_torch_models import CTX_LEN, models  # noqa: F401
from tests.test_torch_samplers import WINDOWS, _feed, _schedule

torch.set_num_threads(2)

IMAGE_ATOL = 3e-4
CHAIN_ATOL = 1e-3
T = 40
LABELS = ["person", "bicycle", "traffic light", "cat", "dog",
          "fire hydrant", "teddy bear", "hair drier", "a", "wine glass"]
CAPTIONS = {
    "one line": ["a cat on a mat"],
    "several lines": ["a red double-decker bus on a wet street at night "
                      "with its lights reflected in the puddles, people "
                      "under umbrellas waiting at the stop"],
    "overlapping glyphs": ["AVATAR To WAVE fi ff"],
    "outside ascii": ["café crème — naïve 日本 «quoted» ©™ ﬁ Ωλ 😀"],
    "punctuation and lists": [["person", "dog"], ("a", "b's \"c\""),
                              "x\ny\n\nz", ""],
}
WIDTHS = [(256, 256), (32, 32), (64, 48)]


@pytest.mark.parametrize("wh", WIDTHS, ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("case", list(CAPTIONS))
def test_text_render_equals_pil(case, wh):
    texts = CAPTIONS[case]
    want = jax_vz.log_txt_as_img(wh, texts)
    got = vz.log_txt_as_img(wh, texts)
    assert got.shape == want.shape == (len(texts), wh[1], wh[0], 3)
    assert np.array_equal(got, want)
    if case != "punctuation and lists" and wh[0] >= 64:
        assert (got < 1).any()     # something was drawn


class _Dataset:
    """What ``log_images`` reads of a dataset: the builders and the
    labels."""

    def __init__(self, builders, encode_crop):
        kw = dict(no_object_classes=len(LABELS), no_max_objects=4,
                  no_tokens=64, encode_crop=encode_crop,
                  use_group_parameter=True)
        self.conditional_builders = {
            "objects": builders.ObjectsConditionalBuilder(**kw),
            "objects_bbox": builders.ObjectsBoundingBoxConditionalBuilder(
                **kw)}

    def get_textual_label_for_category_no(self, n):
        return LABELS[n]


def _bbox_rows(seed, n, encode_crop):
    """Seeded ``objects_bbox`` token rows: up to 4 (class, top-left,
    bottom-right) triples on the 8 x 8 grid of 64 tokens, padded with the
    none token (63), and with the crop's corner tokens."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        row = []
        for _ in range(int(rng.integers(1, 5))):
            x0, y0 = rng.integers(0, 7, 2)
            x1, y1 = rng.integers(x0 + 1, 8), rng.integers(y0 + 1, 8)
            row += [int(rng.integers(0, 2 * len(LABELS))),
                    int(y0 * 8 + x0), int(y1 * 8 + x1)]
        row += [63] * (12 - len(row))
        if encode_crop:
            row += [int(rng.integers(0, 9)), int(rng.integers(54, 63))]
        rows.append(row)
    return np.asarray(rows, np.int64)


@pytest.mark.parametrize("size", [(256, 256), (32, 32), (80, 40)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("encode_crop", [False, True])
def test_bbox_render_equals_pil(encode_crop, size):
    jds = _Dataset(jax_builders, encode_crop)
    pds = _Dataset(port_builders, encode_crop)
    for row in _bbox_rows(7, 4, encode_crop):
        want = jax_vz.plot_bbox_conditioning(
            jds.conditional_builders["objects_bbox"], row,
            jds.get_textual_label_for_category_no, size)
        got = vz.plot_bbox_conditioning(
            pds.conditional_builders["objects_bbox"], row,
            pds.get_textual_label_for_category_no, size)
        assert got.shape == want.shape == (size[1], size[0], 3)
        assert np.array_equal(got, want)


def _key_draws(key, shape, kind, steps, eta):
    """The random arrays JAX's ``samplers.sample`` draws from ``key``, in
    the order the port's ``_noise`` is called (``tests/
    test_torch_samplers.py::_jax_draws`` from a key)."""
    rng, init_key = jax.random.split(key)
    draws = [jax.random.normal(init_key, shape)]
    for start, end in WINDOWS:
        rng, k = jax.random.split(rng)
        w = shape[:-1] + (end - start,)
        if kind == "vanilla":
            draws.append(jax.random.normal(k, (T,) + w))
        elif kind == "ddim" and eta != 0.0:
            dd = DDIMSchedule.create(_schedule(), steps, eta=eta)
            draws.append(jax.random.normal(k, (dd.num_steps,) + w))
    return draws


N = 2
STEPS = 4
FLAGS = dict(plot_sample=True, plot_quantize_denoised=True,
             plot_diffusion_rows=True, plot_denoise_rows=True,
             plot_progressive_rows=True)
LOG_CASES = {"objects, every gallery": ("objects", True),
             "caption": ("caption", False),
             "objects_bbox": ("objects_bbox", False)}
SAMPLED = {"samples", "samples_x0_quantized", "denoise_row",
           "progressive_row"}


def _batch(key):
    rng = np.random.default_rng(3)
    batch = {"image": np.tanh(rng.standard_normal((N, 32, 32, 3))).astype(
                 np.float32),
             "file_name": [f"{i:012d}.jpg" for i in range(N)],
             "caption": ["a cat on a mat", "AVATAR To WAVE fi ff"]}
    if key == "objects":
        batch["objects"] = np.array(
            [[0, 3, 7, 63] + [63] * (CTX_LEN - 4),
             [9, 2] + [63] * (CTX_LEN - 2)], np.int64)
    elif key == "objects_bbox":
        batch["objects_bbox"] = _bbox_rows(11, N, True)   # 14 tokens
    return batch


@pytest.mark.parametrize("case", list(LOG_CASES))
def test_log_images_matches_jax(models, monkeypatch, case):  # noqa: F811
    jmodel, jparams, port = models
    key, sample = LOG_CASES[case]
    batch = _batch(key)
    jds = _Dataset(jax_builders, True)
    pds = _Dataset(port_builders, True)
    for m in (jmodel, port):
        monkeypatch.setattr(m, "cond_stage_key", key)
        monkeypatch.setattr(m, "extra", dict(m.extra, **FLAGS))
        if key == "caption":
            # the toy BERT takes ids: both packages tokenize alike
            monkeypatch.setattr(m, "tokenize", lambda cond: np.array(
                [[len(c) % 100] * CTX_LEN for c in cond], np.int64))
        else:
            # the toy's BERT reads ids < 100 of up to 16 tokens
            monkeypatch.setattr(m, "tokenize", lambda cond: np.asarray(
                cond, np.int64)[:, :CTX_LEN])
    want = jmodel.log_images(jparams, {**batch}, n=N, ddim_steps=STEPS,
                             sample_flag=sample, dataset=jds)
    k0 = jax.random.PRNGKey(0)
    shape = (N, 16, 16, 8)
    draws = []
    if sample:
        noise_key, rows_key = jax.random.split(k0)
        draws += _key_draws(k0, shape, "ddim", STEPS, 1.0)
        draws += [jax.random.normal(noise_key, shape)]
        draws += _key_draws(rows_key, shape, "plms", STEPS, 0.0)
        draws += _key_draws(k0, shape, "vanilla", T, 1.0)
    queue = _feed(monkeypatch, [np.asarray(d) for d in draws])
    got = port.log_images({**batch}, n=N, ddim_steps=STEPS,
                          sample_flag=sample, dataset=pds)
    assert not queue
    assert set(got) == set(want)
    assert got["file_name"] == want["file_name"]
    if sample:
        assert SAMPLED | {"diffusion_row"} <= set(got)
    for k, v in want.items():
        if k == "file_name":
            continue
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
        tol = 0 if k == "conditioning" else (
            CHAIN_ATOL if k in SAMPLED else IMAGE_ATOL)
        err = float(np.abs(got[k] - v).max())
        assert err <= tol, (k, err)


def test_image_logger_writes_the_jax_files(tmp_path):
    rng = np.random.default_rng(5)
    logs = {"inputs": np.tanh(rng.standard_normal((5, 24, 20, 3))),
            "sample": rng.uniform(-1.2, 1.2, (5, 24, 20, 3)),
            "conditioning": vz.log_txt_as_img((20, 24), ["a", "b c", "d",
                                                         "e", "f"]),
            "file_name": [f"dir/{i:012d}.jpg" for i in range(5)]}

    class Model:
        def __init__(self, params_first):
            self.params_first = params_first

        def log_images(self, *a, **k):
            return {k: (np.asarray(v, np.float32) if k != "file_name"
                        else v) for k, v in logs.items()}

    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for step in (3, 1000):
        JaxImageLogger(str(roots["jax"])).log_train(Model(True), None, {},
                                                    step, split="val")
        ImageLogger(str(roots["port"])).log_train(Model(False), {}, step,
                                                  split="val")
    for shard in (-1, 2):
        JaxImageLogger(str(roots["jax"]), shard_idx=shard).log_test(
            logs, str(roots["jax"] / "test"))
        ImageLogger(str(roots["port"]), shard_idx=shard).log_test(
            logs, str(roots["port"] / "test"))
    files = {name: sorted(os.path.relpath(os.path.join(d, f), root)
                          for d, _, fs in os.walk(root) for f in fs)
             for name, root in roots.items()}
    assert files["port"] == files["jax"]
    assert "images/val/inputs_gs-001000.png" in files["port"]
    assert "test/img/sample/000000000004_r2.png" in files["port"]
    for rel in files["jax"]:
        want = np.asarray(Image.open(roots["jax"] / rel).convert("RGB"))
        assert np.array_equal(read_png(str(roots["port"] / rel)), want), rel
