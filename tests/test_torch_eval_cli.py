"""The port's image loader and eval CLIs (``eval/fid.load_images``,
``cli/eval_fid.py``, ``cli/eval_recon.py``) against the JAX package's, on
the CPU, on tiny folders of PNGs and a JPEG.

- ``load_images`` equals the JAX function's pixels exactly, at their own
  size and resized (PIL's fixed-point bilinear, reproduced), and refuses
  a folder of mixed sizes as it does;
- ``eval_recon``'s PSNR/SSIM equal the JAX metrics on the JAX loader's
  images within 1e-6;
- ``eval_fid`` prints its skip line without ``FRIDO_TPU_INCEPTION``; with
  ``random_state_dict(0)`` written as an ``.npz`` and named by it, its
  features equal the JAX package's (its loader, preprocess and one jitted
  tower) within 2e-3 (``tests/test_inception_fid.py``'s tolerance), its
  FID equals the FID of the JAX features within 1e-3, relative (random
  weights give features of a spread of ~1e-5, so a 2e-7 feature gap moves
  the FID by ~1e-4 of itself), and its IS equals the JAX function's on
  the same logits within 1e-6.

The CLI computes one Frechet distance, whose ``scipy.linalg.sqrtm`` of a
2048^2 matrix takes about 20 s on one CPU core, most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from frido_tpu.eval import fid as jfid
from frido_tpu.eval import inception as jinc
from frido_tpu.eval import metrics as jmet
from frido_tpu_torch.cli import eval_fid, eval_recon
from frido_tpu_torch.eval import fid as pfid
from frido_tpu_torch.eval import inception as pinc
from frido_tpu_torch.eval import metrics as pmet

torch.set_num_threads(2)

ATOL = 2e-3
FID_RTOL = 1e-3
MET_TOL = 1e-6


@pytest.fixture(scope="module")
def nets():
    sd = jinc.random_state_dict(0)
    params = jinc.import_torch_state_dict(sd)
    model = pinc.InceptionV3.from_state_dict(sd, "cpu")
    run = jax.jit(lambda p, x: (jinc.features(p, x), jinc.logits(p, x)))
    return sd, params, model, run


def _close(got, want):
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= MET_TOL * max(1.0, abs(want)), (got, want)


def _fid_closed_form(a, b):
    """FID of two feature sets of fewer rows than columns, in float64:
    ``tr sqrtm(S1 S2)`` is the sum of the square roots of the nonzero
    eigenvalues of ``S1 S2``, which are those of the small
    ``(A1 A2^T)(A1 A2^T)^T`` for the centred rows ``A / sqrt(n - 1)``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mu1, mu2 = a.mean(0), b.mean(0)
    x = (a - mu1) / np.sqrt(len(a) - 1)
    y = (b - mu2) / np.sqrt(len(b) - 1)
    m = x @ y.T
    ev = np.linalg.eigvals(m @ m.T).real
    d = mu1 - mu2
    return float(d @ d + np.sum(x * x) + np.sum(y * y)
                 - 2 * np.sum(np.sqrt(np.clip(ev, 0, None))))


# ---- the folders and the CLIs --------------------------------------------
@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two folders of 5 PNGs at 40x48 and a JPEG each; a third of mixed
    sizes."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(7)
    for name in ("real", "fake", "mixed"):
        (root / name).mkdir()
    base = rng.randint(0, 256, (5, 40, 48, 3), np.uint8)
    for i, img in enumerate(base):
        Image.fromarray(img).save(root / "real" / f"{i}.png")
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(root / "fake" / f"{i}.png")
        Image.fromarray(img[: 30 + i]).save(root / "mixed" / f"{i}.png")
    Image.fromarray(base[0]).save(root / "real" / "5.jpg", quality=90)
    Image.fromarray(base[1]).save(root / "fake" / "5.jpg", quality=90)
    return root


@pytest.mark.parametrize("name, size", [("real", None), ("real", 32),
                                        ("mixed", 64)])
def test_load_images_equals_jax(folders, name, size):
    want = jfid.load_images(str(folders / name), size=size)
    got = pfid.load_images(str(folders / name), size=size, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_images_refuses_mixed_sizes_as_jax(folders):
    with pytest.raises(ValueError, match="different image sizes"):
        jfid.load_images(str(folders / "mixed"))
    with pytest.raises(ValueError, match="different image sizes"):
        pfid.load_images(str(folders / "mixed"), device="cpu")


def test_eval_recon_cli_equals_jax(folders, capsys):
    ps, ss, n = eval_recon.main(["--real", str(folders / "real"), "--fake",
                                 str(folders / "fake"), "--size", "32",
                                 "--device", "cpu"])
    assert n == 6 and f"PSNR: {ps:.4f}  SSIM: {ss:.4f}  (n=6)" in \
        capsys.readouterr().out
    want = jmet.psnr_ssim_batch(
        jfid.load_images(str(folders / "real"), size=32),
        jfid.load_images(str(folders / "fake"), size=32), data_range=1.0)
    for g, w in zip((ps, ss), want):
        _close(g, w)


def test_eval_fid_cli_equals_jax_fid(folders, nets, monkeypatch, tmp_path,
                                    capsys):
    """End to end: the CLI's FID (the port's loader, tower and Frechet
    distance) against the FID of the JAX package's features of the same
    folders (its loader, preprocess and tower), that one in closed form
    (:func:`_fid_closed_form`: ``scipy.linalg.sqrtm`` of a 2048^2 matrix
    takes about 20 s on one CPU core, and ``tests/test_torch_eval.py``
    holds the two packages' Frechet functions to each other); IS from the
    fc head over the CLI's features."""
    _, params, model, run = nets
    argv = ["--real", str(folders / "real"), "--fake", str(folders / "fake"),
            "--inception_score", "--device", "cpu"]
    monkeypatch.delenv("FRIDO_TPU_INCEPTION", raising=False)
    assert eval_fid.main(argv) is None
    assert "FID skipped" in capsys.readouterr().out
    path = tmp_path / "inception.npz"
    np.savez(path, **nets[0])
    monkeypatch.setenv("FRIDO_TPU_INCEPTION", str(path))
    out = eval_fid.main(argv)
    text = capsys.readouterr().out
    assert f"FID: {out['fid']:.4f}" in text and "IS: " in text
    real, fake = out["features"]
    jfeats = [np.asarray(run(params, jinc.preprocess(jnp.asarray(
        jfid.load_images(str(folders / d)))))[0]) for d in ("real", "fake")]
    for got, want in zip((real, fake), jfeats):
        np.testing.assert_allclose(got, want, atol=ATOL)
    want = _fid_closed_form(*jfeats)
    assert np.isfinite(out["fid"]) and out["fid"] >= 0
    assert abs(out["fid"] - want) <= FID_RTOL * abs(want), (out["fid"], want)
    is_want = pmet.inception_score(model.head(torch.from_numpy(fake)))
    assert out["is"] == is_want
    jis = jmet.inception_score(np.asarray(fake) @ params["fc"]["w"]
                               + params["fc"]["b"])
    for g, w in zip(out["is"], jis):
        assert abs(g - w) <= MET_TOL * w
