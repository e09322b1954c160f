"""The port's CLIP towers, the other conditioning encoders and ``resize``
against the JAX package, on the CPU.

Seeded numpy values for every JAX leaf go into both packages (into the
port through ``io/jax_weights.py``); inputs come from numpy with a fixed
seed; each JAX function is jitted once. Tolerances, fixed before the
comparison (fp32 on both sides, sums in another order):

- ``resize`` (``jax.image.resize``, antialiased): 2e-5 on N(0, 1) inputs
  (up to 16 taps of weights that agree to 1e-7); the weight matrices
  themselves 1e-6;
- toy CLIP text tower (2 layers, width 32), its per-token states and the
  pooled, normalised embedding: 2e-5; the vision tower (2 layers, width
  32) after ``clip_preprocess``: 2e-5; ``clip_preprocess`` alone 5e-5
  (its outputs reach ~8 after the CLIP normalisation);
- ``ClassEmbedder`` (both modes), a gather and a max: exact;
  ``SpatialRescaler`` (two antialiased bilinear x0.5 stages and a 1x1
  map): 2e-5.

At full width, on the ``meta`` device: the clip-t2i config
``configs/frido/t2i/frido_f16f8_coco_clip.yaml`` builds unmodified, and
its tensors are the JAX tree's leaves one for one (the CLIP text tower,
``text_projection``); the CLIP image embedder's ViT-L/14 too (the class
embedding, a direct parameter, included).
"""

import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.config import load_yaml as jax_load_yaml
from frido_tpu.nn import clip as jclip
from frido_tpu.nn import encoders as jenc
from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.nn import clip, encoders
from frido_tpu_torch.ops.image import resize, resize_weights
from frido_tpu_torch.text import ClipBPETokenizer

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CLIP_T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco_clip.yaml"
TOWER_ATOL = 2e-5
RESIZE_ATOL = 2e-5
TEXT = dict(vocab_size=600, hidden=32, layers=2, heads=4, intermediate=64,
            max_positions=16)
VISION = dict(hidden=32, layers=2, heads=4, intermediate=64, patch=4,
              image_size=16, projection_dim=24)


def _random_params(shapes, rng):
    """Seeded values for every leaf: kernels at 1/sqrt(fan_in), norm
    scales near 1, embeddings N(0, 0.02)... at init scale."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _random_params(v, rng)
            continue
        z = rng.standard_normal(v.shape)
        if k == "kernel":
            z = z / np.sqrt(np.prod(v.shape[:-1]))
        elif k == "scale":
            z = 1.0 + 0.1 * z
        elif k in ("embedding", "embeddings__class_embedding"):
            z = 0.02 * z if k == "embedding" else 0.5 * z
        else:
            z = 0.1 * z
        out[k] = z.astype(np.float32)
    return out


def _pair(jmodule, port, *inputs, seed=0):
    """(jitted JAX apply with seeded params, the port module loaded with
    them)."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *inputs)
    params = _random_params(shapes, np.random.default_rng(seed))
    load_jax_params(port, params)
    return jax.jit(lambda *x: jmodule.apply(params, *x)), port.eval()


def _tokens():
    """Fallback-vocab CLIP ids (EOT 513 is the largest) over 16 positions,
    plus a row of random ids with a repeated maximum (first max pools)."""
    ids = ClipBPETokenizer()(["a dog", "two red buses on a wet street",
                              ""], max_length=16)
    rnd = np.random.default_rng(1).integers(0, 500, (1, 16))
    rnd[0, [5, 9]] = 599
    return np.concatenate([ids, rnd.astype(np.int32)])


@pytest.mark.parametrize("shape,out,method", [
    ((2, 16, 16, 3), (2, 8, 8, 3), "bilinear"),     # SpatialRescaler x0.5
    ((2, 9, 13, 3), (2, 4, 6, 3), "bilinear"),
    ((1, 5, 7, 2), (1, 11, 13, 2), "bilinear"),     # up
    ((2, 32, 32, 3), (2, 28, 28, 3), "bicubic"),    # as clip_preprocess
    ((1, 5, 7, 2), (1, 11, 3, 2), "bicubic"),       # up one axis, down one
    ((2, 6, 6, 3), (2, 6, 6, 3), "bicubic"),        # unchanged
])
def test_resize_equals_jax(shape, out, method):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(torch.from_numpy(x), out, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("n_in,n_out,method", [
    (16, 8, "linear"), (7, 13, "linear"), (256, 224, "cubic"),
    (5, 11, "cubic")])
def test_resize_weights_equal_jax(n_in, n_out, method):
    from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                      _fill_triangle_kernel,
                                      compute_weight_mat)

    kernel = (_fill_triangle_kernel if method == "linear"
              else _fill_keys_cubic_kernel)
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         kernel, True))
    got = resize_weights(n_in, n_out, method)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if n_out < n_in and method == "linear":     # x0.5: a 4-tap triangle
        assert (got[:, 3] > 0).sum() == 4


def test_clip_text_tower_equals_jax():
    tokens = _tokens()
    jmod = jclip.CLIPTextModule(**TEXT)
    apply, port = _pair(jmod, clip.CLIPTextModule(**TEXT, device="cpu"),
                        jnp.asarray(tokens))
    want = np.asarray(apply(jnp.asarray(tokens)))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (4, 16, 32)
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


@pytest.mark.parametrize("n_repeat,normalize", [(1, True), (3, False)])
def test_clip_pooled_module_equals_jax(n_repeat, normalize):
    tokens = _tokens()
    kw = dict(TEXT, projection_dim=24, n_repeat=n_repeat,
              normalize=normalize)
    apply, port = _pair(jclip.CLIPTextPooledModule(**kw),
                        clip.CLIPTextPooledModule(**kw, device="cpu"),
                        jnp.asarray(tokens))
    want = np.asarray(apply(jnp.asarray(tokens)))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (4, n_repeat, 24)
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-6)


def test_clip_preprocess_equals_jax():
    x = np.tanh(np.random.default_rng(2).standard_normal(
        (2, 40, 40, 3))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jclip.clip_preprocess(v, 32))(
        jnp.asarray(x)))
    got = clip.clip_preprocess(torch.from_numpy(x), 32).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_clip_vision_tower_equals_jax():
    """Toy ViT over ``clip_preprocess``-ed images, as
    FrozenClipImageEmbedder composes them."""
    x = np.tanh(np.random.default_rng(3).standard_normal(
        (2, 20, 20, 3))).astype(np.float32)

    class Wrapped(fnn.Module):
        def setup(self):
            self.tower = jclip.CLIPVisionTower(**VISION, name="model__visual")

        def __call__(self, v):
            return self.tower(jclip.clip_preprocess(v, 16))

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.Module()
            self.model.visual = clip.CLIPVisionTower(**VISION, device="cpu")

        def forward(self, v):
            return self.model.visual(clip.clip_preprocess(v, 16))

    apply, port = _pair(Wrapped(), Port(), jnp.asarray(x))
    assert "model.visual.embeddings.class_embedding" in port.state_dict()
    want = np.asarray(apply(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 24)
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


@pytest.mark.parametrize("multilabel", [False, True])
def test_class_embedder_equals_jax(multilabel):
    ids = np.random.default_rng(4).integers(
        0, 50, (3, 5) if multilabel else (3,)).astype(np.int32)
    jwrap = jenc.ClassEmbedder(16, multilabel=multilabel, n_classes=50)
    apply, port = _pair(jwrap.build_module(),
                        encoders.ClassEmbedder(16, multilabel=multilabel,
                                               n_classes=50, device="cpu"),
                        jnp.asarray(ids))
    want = np.asarray(apply(jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long()).numpy()
    assert got.shape == ((3, 16) if multilabel else (3, 1, 16))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_channels", [None, 5])
def test_spatial_rescaler_equals_jax(out_channels):
    x = np.random.default_rng(5).standard_normal(
        (2, 20, 20, 3)).astype(np.float32)
    kw = dict(n_stages=2, multiplier=0.5, out_channels=out_channels)
    jwrap = jenc.SpatialRescaler(**kw)
    apply, port = _pair(jwrap.build_module(),
                        encoders.SpatialRescaler(**kw, device="cpu"),
                        jnp.asarray(x))
    want = np.asarray(apply(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, 5, out_channels or 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def _leaf_shapes(shapes):
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    return {k: tuple(v.shape)
            for k, v in jax_params_to_state_dict(views).items()}


def test_full_width_clip_config_builds_and_maps():
    """The clip-t2i config, unmodified: every port tensor gets its JAX leaf
    of the same shape and no leaf is left over."""
    jmodel = jax_instantiate(jax_load_yaml(str(CLIP_T2I))["model"])
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r),
                            jax.random.PRNGKey(0))
    port = instantiate_from_config(load_yaml(str(CLIP_T2I))["model"],
                                   device="meta")
    assert isinstance(port.cond_stage_model, encoders.FrozenCLIPTextEmbedder)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert _leaf_shapes(shapes) == want
    cond = {k: v for k, v in want.items() if k.startswith("cond_stage_")}
    assert cond["cond_stage_model.text_projection.weight"] == (768, 768)
    assert cond["cond_stage_model.transformer.text_model.embeddings."
                "token_embedding.weight"] == (49408, 768)
    assert sum(np.prod(s) for s in cond.values()) == 123_650_304


def test_full_width_clip_image_embedder_maps():
    jmod = jenc.FrozenClipImageEmbedder().build_module()
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    port = encoders.FrozenClipImageEmbedder(device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert _leaf_shapes(shapes) == want
    assert want["model.visual.embeddings.class_embedding"] == (1024,)
    assert len([k for k in want if k.endswith("q_proj.weight")]) == 24
