"""The port's eval layer (``frido_tpu_torch/eval``, ``cli/eval_fid.py``,
``cli/eval_recon.py``) against the JAX package's, on the CPU.

The FID InceptionV3 with ``random_state_dict(0)`` in both packages:

- one tower pass at batch 6 and 299^2 (one jitted JAX function giving
  the features and the logits), the port's logits taken from its fc head
  over those same features; one pass of the graph at 107^2 without the
  preprocess: features and logits within 2e-3 absolute
  (``tests/test_inception_fid.py``'s tolerance; the gap measured on the
  CPU was under 1e-6);
- ``preprocess`` up (256 -> 299) and down (320 -> 299) within 1e-5
  absolute (``tests/test_inception_fid.py``'s preprocess tolerance);
- ``run_batched``'s padded last batch: its rows equal the same images run
  alone, within 1e-4; the importer's shape and missing-key errors;

The metrics (every function of ``metrics.py``) and the ``fid.py`` math
against the JAX numpy versions on ``tests/test_metrics.py``'s and
``tests/test_eval.py``'s cases, within 1e-6 (relative for the FID). The
loader and the CLIs: ``tests/test_torch_eval_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.eval import fid as jfid
from frido_tpu.eval import inception as jinc
from frido_tpu.eval import metrics as jmet
from frido_tpu_torch.eval import fid as pfid
from frido_tpu_torch.eval import inception as pinc
from frido_tpu_torch.eval import metrics as pmet

torch.set_num_threads(2)

ATOL = 2e-3
PRE_ATOL = 1e-5
TAIL_ATOL = 1e-4
MET_TOL = 1e-6


@pytest.fixture(scope="module")
def nets():
    sd = jinc.random_state_dict(0)
    params = jinc.import_torch_state_dict(sd)
    model = pinc.InceptionV3.from_state_dict(sd, "cpu")
    run = jax.jit(lambda p, x: (jinc.features(p, x), jinc.logits(p, x)))
    return sd, params, model, run


@pytest.fixture(scope="module")
def tower(nets):
    """One JAX pass at batch 6, 299^2, and the port's on the same input."""
    _, params, model, run = nets
    x = np.random.RandomState(1).rand(6, 299, 299, 3).astype(np.float32)
    x = x * 2 - 1
    jf, jl = (np.asarray(a) for a in run(params, jnp.asarray(x)))
    pf = model.features(torch.from_numpy(x))
    return x, jf, jl, pf, model.head(pf)


def test_features_and_logits_equal_jax(tower):
    _, jf, jl, pf, pl = tower
    assert pf.shape == (6, 2048) and pl.shape == (6, pinc.NUM_CLASSES_FID)
    np.testing.assert_allclose(pf.numpy(), jf, atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), jl, atol=ATOL)


def test_small_graph_pass_equals_jax(nets):
    _, params, model, run = nets
    x = np.random.RandomState(2).rand(2, 107, 107, 3).astype(np.float32)
    jf, jl = (np.asarray(a) for a in run(params, jnp.asarray(x * 2 - 1)))
    t = torch.from_numpy(x * 2 - 1)
    np.testing.assert_allclose(model.features(t).numpy(), jf, atol=ATOL)
    np.testing.assert_allclose(model.logits(t).numpy(), jl, atol=ATOL)


@pytest.mark.parametrize("size", [256, 320])
def test_preprocess_up_and_down_equals_jax(size):
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jinc.preprocess(jnp.asarray(x)))
    got = pinc.preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=PRE_ATOL)


def test_run_batched_pads_the_last_batch(nets):
    model = nets[2]
    imgs = np.random.RandomState(4).rand(3, 40, 40, 3).astype(np.float32)
    feats = pinc.run_batched(model, imgs, batch=2)
    single = pinc.run_batched(model, imgs[2:], batch=2)
    logits = pinc.run_batched(model, imgs[2:], batch=2, want_logits=True)
    assert feats.shape == (3, 2048) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[2], single[0], atol=TAIL_ATOL)
    np.testing.assert_allclose(
        logits, model.head(torch.from_numpy(single)).numpy(), atol=TAIL_ATOL)


def test_importer_rejects_shape_drift_and_missing_keys(nets):
    jsd = nets[0]
    sd = pinc.random_state_dict(0)
    assert sd.keys() == jsd.keys()
    assert all(np.array_equal(v, jsd[k]) for k, v in sd.items())
    sd["AuxLogits.fc.weight"] = np.zeros((3, 3), np.float32)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.zeros((), np.int64)
    pinc.import_torch_state_dict(sd)
    drift = dict(sd, **{"Mixed_5b.branch1x1.conv.weight": sd[
        "Mixed_5b.branch1x1.conv.weight"][:, :64]})
    with pytest.raises(ValueError, match="Mixed_5b.branch1x1"):
        pinc.import_torch_state_dict(drift)
    del sd["fc.bias"]
    with pytest.raises(KeyError, match="fc.bias"):
        pinc.import_torch_state_dict(sd)


# ---- metrics and FID math on the JAX tests' cases -----------------------
def _close(got, want):
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= MET_TOL * max(1.0, abs(want)), (got, want)


def _cases():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (32, 32, 3))
    r1 = np.random.RandomState(1)
    a = r1.uniform(-1, 1, (4, 16, 16, 3))
    n, c = 100, 10
    onehot = np.full((n, c), -50.0)
    onehot[np.arange(n), np.arange(n) % c] = 50.0
    feats = np.random.RandomState(2).normal(size=(64, 8))
    e = np.random.RandomState(3).normal(size=(16, 32))
    half = np.random.RandomState(5).normal(size=(48, 8))
    return [
        ("psnr", (np.zeros((8, 8)), np.full((8, 8), 0.5)), {}),
        ("psnr", (x, x), {}),
        ("psnr", (a, a + 0.1), {"data_range": 1.0}),
        ("ssim", (x, x), {}),
        ("ssim", (x, x + rng.normal(0, 0.5, x.shape)), {}),
        ("ssim", (x[..., 0], x[..., 0] * 0.9), {}),
        ("psnr_ssim_batch", (a, a + 0.1), {}),
        ("inception_score", (onehot,), {"splits": 2}),
        ("inception_score", (np.zeros((n, c)),), {"splits": 2}),
        ("inception_score", (r1.normal(size=(37, 12)) * 3,), {}),
        ("precision_recall", (feats, feats.copy()), {}),
        ("precision_recall", (feats, feats + 1000.0), {}),
        ("precision_recall", (feats, half), {"k": 5}),
        ("clip_score", (e, e), {}),
        ("clip_score", (e, -e), {}),
        ("clip_score", (e, np.random.RandomState(6).normal(size=e.shape)),
         {"w": 1.0}),
    ]


@pytest.mark.parametrize("k", range(16))
def test_metrics_equal_jax(k):
    name, args, kw = _cases()[k]
    want = getattr(jmet, name)(*args, **kw)
    got = getattr(pmet, name)(*[torch.from_numpy(np.asarray(a))
                                for a in args], **kw)
    for g, w in zip(np.atleast_1d(got), np.atleast_1d(want)):
        _close(float(g), float(w))


def test_fid_math_equals_jax():
    rng = np.random.RandomState(1)
    f1 = rng.randn(2000, 4)
    cases = [(np.random.RandomState(0).randn(500, 16),) * 2,
             (f1, f1 + np.array([1.0, 0, 0, 0])),
             (np.random.RandomState(2).randn(1000, 8),
              np.random.RandomState(3).randn(1000, 8) * 2 + 1)]
    for a, b in cases:
        got, want = pfid.fid_from_features(a, b), jfid.fid_from_features(a, b)
        assert abs(got - want) <= MET_TOL * max(1.0, abs(want))
        for g, w in zip(pfid.feature_statistics(a),
                        jfid.feature_statistics(a)):
            np.testing.assert_array_equal(g, w)
