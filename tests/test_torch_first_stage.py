"""The port's MS-VQGAN encode side against the JAX package, on the CPU.

- A toy MS-VQGAN (``MSFPNVQModel``: the encoder and decoder configs of
  ``tests/test_torch_models.py``, ``resolution=32``, two scales of 4
  channels with codebooks of 32) with seeded numpy weights in both
  packages, carried into the port by ``io/jax_weights.py``: the encoder's
  per-scale outputs, ``encode`` (quantized latent, loss, indices),
  ``decode``, ``forward``, ``forward_with_aux``, ``encode_interface`` with
  and without ``channel_range``, ``quantize_latent``, and the round trip
  ``decode_interface(encode_interface(x))``. Every JAX output comes from
  one jitted function.
- ``ConvTranspose2d`` against the JAX layer, which guards the ``kernel_t``
  flip; the single-scale ``Encoder``; ``VectorQuantizer``'s loss in both
  commitment conventions.
- ``FridoDiffusion.encode_first_stage`` and
  ``decode_first_stage_with_codes`` on the toy t2i model of
  ``tests/test_torch_models.py``.
- ``configs/msvqgan/msvqgan_f16f8_coco.yaml`` built on the ``meta``
  device: every tensor gets a JAX leaf of the same name and shape, and no
  leaf is left over (shapes by ``jax.eval_shape``, nothing allocated).
- Every kernel site of the full-width t2i and layout2i encodes at batch 4,
  found by a ``meta`` run: its route and its host plan (``flash_plan``,
  ``smalls_plan``, ``vq_plan``, ``conv_plan``, ``group_norm_plan``), which
  covers its output once and fits the shared memory, as
  ``tests/test_torch_layout2i.py`` checks the sampling sites.

Tolerances, fixed before the comparison: 1e-4 absolute for encoder and
pre-quantization latents (and the ConvTranspose2d output); 3e-4 for
images; 1e-5 relative for losses. Codes must agree wherever the best and
second-best distances differ by more than 1e-5, and quantized latents
there.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.config import load_yaml as jax_load_yaml
from frido_tpu.models.msvqgan import msvqgan_from_config as jax_msvqgan
from frido_tpu.nn import layers as jax_layers
from frido_tpu.nn import quantize as jax_quantize
from frido_tpu.nn import vqgan as jax_vqgan
from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.models.msvqgan import MSFPNVQModel
from frido_tpu_torch.nn import transformer
from frido_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, GroupNorm
from frido_tpu_torch.nn.quantize import VectorQuantizer
from frido_tpu_torch.nn.vqgan import Encoder
from frido_tpu_torch.ops import vq as ops_vq
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.attention import (MAX_SMEM, flash_plan,
                                                smalls_plan)
from tests.test_torch_attention_numerics import _coverage
from tests.test_torch_conv_numerics import _check_plan
from tests.test_torch_models import (DD, ED, _decided, _np, _random_params,
                                     _t, models)  # noqa: F401 (fixture)
from tests.test_torch_norm_vq_numerics import (
    test_group_norm_plan_covers_every_element_once as _check_gn_plan,
    test_vq_plan_parts_cover_the_codebook_once as _check_vq_plan)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
MSVQGAN_F16F8 = REPO / "configs" / "msvqgan" / "msvqgan_f16f8_coco.yaml"
LATENT_ATOL = 1e-4
IMAGE_ATOL = 3e-4
LOSS_RTOL = 1e-5
FIRST_STAGE = {
    "target": "taming.models.msvqgan.MSFPNVQModel",
    "params": dict(embed_dim=[4, 4], n_embed=[32, 32], edconfig=ED,
                   ddconfig=DD, monitor="val/rec_loss",
                   lossconfig={"target": "taming.modules.losses.DummyLoss"}),
}
CHANNEL_RANGES = [(0, 4), (4, 8), (0, 8)]
X_SHAPE = (2, 32, 32, 3)


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _check_codes(got, want, pre_quant, books):
    """Codes equal wherever the distance gap is over 1e-5; returns those
    rows' masks, one per scale."""
    masks = []
    for g, w, h, book in zip(got, want, pre_quant, books):
        keep = _decided(h, book)
        assert keep.mean() > 0.9
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])
        masks.append(keep)
    return masks


@pytest.fixture(scope="module")
def toy():
    """(jax outputs, port model, inputs, numpy params) of the toy
    MS-VQGAN; the JAX outputs from one jitted function."""
    jwrap = jax_instantiate(FIRST_STAGE)
    module = jwrap.module
    shapes = jax.eval_shape(lambda r: jwrap.init(r, X_SHAPE),
                            jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(10))
    port = instantiate_from_config(FIRST_STAGE, device="cpu")
    assert type(port) is MSFPNVQModel
    load_jax_params(port, np_params)
    port.eval()
    x = _np(11, X_SHAPE)
    z = _np(12, (2, 16, 16, 8), 0.05)
    ranged = {r: jax_msvqgan(dict(FIRST_STAGE["params"], channel_range=r),
                             name=None) for r in CHANNEL_RANGES}

    def run(params, x, z):
        apply = lambda method, *a, **k: module.apply(  # noqa: E731
            params, *a, method=method, **k)
        out = dict(
            enc=apply(lambda m, x: m.encoder(x), x),
            encode=apply("encode", x),
            forward=apply("__call__", x),
            aux=apply("forward_with_aux", x),
            interface=apply("encode_interface", x),
            quantize_latent=apply("quantize_latent", z),
            decode_z=apply("decode", z))
        for r, m in ranged.items():
            out[str(r)] = m.apply(params, x, method="encode_interface")
        return out

    want = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, np_params),
                        jnp.asarray(x), jnp.asarray(z))
    return want, port, x, z


def _pre_quant(port, x):
    """The port's per-scale pre-quantization latents (NHWC), coarsest
    first, and the codebooks."""
    with torch.no_grad():
        per_scale = port._fused_prequant(_t(x).permute(0, 3, 1, 2))
    hs = [h.permute(0, 2, 3, 1).numpy() for h, *_ in per_scale]
    books = [q.embedding.weight.detach().numpy() for q in port.ms_quantize]
    return hs, books


def test_conv_transpose_matches_jax_layer():
    """k4 s2 p1 on a random, asymmetric kernel: a kernel_t bridged by a
    plain transpose (no flip) would turn it by 180 degrees."""
    layer = jax_layers.ConvTranspose2d(5, 4, 2, 1)
    x = _np(20, (2, 6, 7, 3))
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params["params"]["bias"] = _np(21, (5,), 0.1)
    want = layer.apply(params, jnp.asarray(x))
    port = ConvTranspose2d(3, 5, 4, 2, 1, device="cpu")
    load_jax_params(port, params)
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 12, 14, 5)
    _close(got, want, LATENT_ATOL)
    kernel_t = params["params"]["kernel_t"]
    assert np.abs(kernel_t - kernel_t[::-1, ::-1]).max() > 0.1


def test_single_scale_encoder_matches_jax():
    cfg = dict(DD, double_z=True, z_channels=4)
    jenc = jax_vqgan.Encoder(
        ch=32, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(16,),
        resolution=32, z_channels=4, double_z=True)
    x = _np(22, X_SHAPE)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = _random_params(shapes, np.random.default_rng(23))
    want = jax.jit(jenc.apply)(params, jnp.asarray(x))
    port = Encoder(**cfg, device="cpu")
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 16, 16, 8)
    _close(got, want, LATENT_ATOL)


@pytest.mark.parametrize("legacy", [True, False])
def test_vector_quantizer_loss_matches_jax(legacy):
    jq = jax_quantize.VectorQuantizer(32, 4, beta=0.3, legacy=legacy)
    z = _np(24, (2, 5, 6, 4), 0.05)
    params = {"params": {"embedding": {
        "embedding": _np(25, (32, 4), 0.05)}}}
    zq_j, loss_j, idx_j = jax.jit(jq.apply)(params, jnp.asarray(z))
    port = VectorQuantizer(32, 4, beta=0.3, legacy=legacy, device="cpu")
    load_jax_params(port, params)
    zq, loss, idx = port(_t(z))
    book = params["params"]["embedding"]["embedding"]
    keep = _decided(z, book)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[keep], np.asarray(idx_j)[keep])
    _close(zq[keep], np.asarray(zq_j)[keep], LATENT_ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    torch.testing.assert_close(port.get_codebook_entry(idx),
                               port.embedding.weight[idx.long()])


def test_ms_encoder_matches_jax(toy):
    want, port, x, _ = toy
    with torch.no_grad():
        got = port.encoder(_t(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 4, 16, 16), (2, 4, 8, 8)]
    for g, w in zip(got, want["enc"]):
        _close(g.permute(0, 2, 3, 1), w, LATENT_ATOL)


def test_encode_matches_jax(toy):
    want, port, x, _ = toy
    quant_j, loss_j, idx_j = want["encode"]
    with torch.no_grad():
        quant, loss, idx = port.encode(_t(x))
    assert quant.shape == (2, 16, 16, 8)
    assert [tuple(i.shape) for i in idx] == [(2, 8, 8), (2, 16, 16)]
    hs, books = _pre_quant(port, x)
    coarse, fine = _check_codes(idx, idx_j, hs, books)
    up = coarse.repeat(2, axis=1).repeat(2, axis=2)
    _close(quant[..., :4][fine], np.asarray(quant_j)[..., :4][fine],
           LATENT_ATOL)
    _close(quant[..., 4:][up], np.asarray(quant_j)[..., 4:][up], LATENT_ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)


def test_decode_forward_and_aux_match_jax(toy):
    want, port, x, z = toy
    with torch.no_grad():
        dec, diff, _ = port(_t(x))
        aux_dec, aux, aux_diff, _ = port.forward_with_aux(_t(x))
        from_z = port.decode(_t(z))
    _close(from_z, want["decode_z"], IMAGE_ATOL)
    dec_j, diff_j, _ = want["forward"]
    _close(dec, dec_j, IMAGE_ATOL)
    np.testing.assert_allclose(diff.item(), float(diff_j), rtol=LOSS_RTOL)
    aux_dec_j, aux_j, aux_diff_j, _ = want["aux"]
    assert dec.shape == (2, 32, 32, 3) and len(aux) == 2
    _close(aux_dec, aux_dec_j, IMAGE_ATOL)
    for g, w in zip(aux, aux_j):
        _close(g, w, IMAGE_ATOL)
    assert (aux[0] - aux[1]).abs().max() > 1e-2   # two distinct groups
    np.testing.assert_allclose(aux_diff.item(), float(aux_diff_j),
                               rtol=LOSS_RTOL)


def test_encode_interface_matches_jax(toy):
    want, port, x, _ = toy
    with torch.no_grad():
        got = port.encode_interface(_t(x))
    assert got.shape == (2, 16, 16, 8)
    _close(got, want["interface"], LATENT_ATOL)
    # [coarse | fine]: the coarse block repeats over 2x2 cells
    coarse = got[..., :4]
    torch.testing.assert_close(coarse[:, ::2, ::2], coarse[:, 1::2, 1::2])


@pytest.mark.parametrize("channel_range", CHANNEL_RANGES)
def test_encode_interface_channel_range_matches_jax(toy, channel_range):
    want, port, x, _ = toy
    ranged = MSFPNVQModel(ED, DD, [32, 32], [4, 4],
                          channel_range=channel_range, device="cpu",
                          seed=None)
    ranged.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = ranged.encode_interface(_t(x))
    lo, hi = channel_range
    # a range of one scale keeps that scale's own grid
    side = 16 if channel_range != (0, 4) else 8
    assert got.shape == (2, side, side, hi - lo)
    _close(got, want[str(channel_range)], LATENT_ATOL)


def test_quantize_latent_matches_jax(toy):
    want, port, _, z = toy
    with torch.no_grad():
        got = port.quantize_latent(_t(z))
    books = [q.embedding.weight.detach().numpy() for q in port.ms_quantize]
    for i, book in enumerate(books):
        keep = _decided(z[..., 4 * i:4 * i + 4], book)
        assert keep.mean() > 0.9
        _close(got[..., 4 * i:4 * i + 4][keep],
               np.asarray(want["quantize_latent"])[..., 4 * i:4 * i + 4][keep],
               LATENT_ATOL)


def test_round_trip_codes_and_image(toy):
    """decode_interface(encode_interface(x)) re-quantizes the same vectors
    (the coarse ones repeated by the nearest 2x upsample): the codes are
    encode's, the coarse ones upsampled, and the image is decode(encode)."""
    _, port, x, _ = toy
    with torch.no_grad():
        quant, _, (coarse, fine) = port.encode(_t(x))
        img, codes = port.decode_interface(port.encode_interface(_t(x)),
                                           return_code=True)
        want_img = port.decode(quant)
    up = coarse.repeat_interleave(2, 1).repeat_interleave(2, 2)
    torch.testing.assert_close(codes[0], up, atol=0, rtol=0)
    torch.testing.assert_close(codes[1], fine, atol=0, rtol=0)
    torch.testing.assert_close(img, want_img, atol=1e-5, rtol=0)


def test_frido_encode_and_decode_with_codes_match_jax(models):
    jmodel, jparams, port = models
    x = _np(13, X_SHAPE)
    want = jax.jit(jmodel.encode_first_stage)(jparams, jnp.asarray(x))
    got = port.encode_first_stage(_t(x))
    assert got.shape == (2, 16, 16, 8)
    _close(got, want, LATENT_ATOL)

    img_j, codes_j = jax.jit(jmodel.decode_first_stage_with_codes)(
        jparams, want)
    img, codes = port.decode_first_stage_with_codes(_t(np.asarray(want)))
    raw = port._scale_latent(_t(np.asarray(want)), invert=True).numpy()
    books = [q.embedding.weight.detach().numpy()
             for q in port.first_stage_model.ms_quantize]
    masks = _check_codes(codes, codes_j, [raw[..., :4], raw[..., 4:]], books)
    assert all(m.all() for m in masks)   # so the images compare in full
    _close(img, img_j, IMAGE_ATOL)


def test_msvqgan_config_builds_with_the_jax_tree():
    jwrap = jax_instantiate(jax_load_yaml(str(MSVQGAN_F16F8))["model"])
    shapes = jax.eval_shape(lambda r: jwrap.init(r), jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = jax_params_to_state_dict(views)
    port = instantiate_from_config(load_yaml(str(MSVQGAN_F16F8))["model"],
                                   device="meta")
    assert type(port) is MSFPNVQModel
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert got == want
    assert want["upsample.0.weight"] == (4, 4, 4, 4)
    assert want["shared_decoder.0.conv_in.weight"] == (128, 8, 3, 3)
    assert want["encoder.mid_ms.1.attn_1.q.weight"] == (512, 512, 1, 1)


# ---------------------------------------------------------------------------
# the kernel sites of the full-width encodes

FULL_WIDTH = {name: REPO / "configs" / "frido" / path for name, path in (
    ("t2i", "t2i/frido_f16f8_coco.yaml"),
    ("layout2i", "layout2i/frido_f8f4_coco_seg.yaml"))}
BATCH = 4


@pytest.fixture(scope="module")
def encode_sites():
    """Every site the kernels would serve in one full-width
    ``encode_first_stage`` at batch 4, per config, from a ``meta`` run with
    the kernels off: attention (bh, nq, nk, d, itemsize), VQ (n, k, d),
    3x3 / stride-1 convs (shape, cout, itemsize), GroupNorms (shape,
    itemsize)."""
    out = {}
    for name, path in FULL_WIDTH.items():
        model = instantiate_from_config(load_yaml(str(path))["model"],
                                        device="meta")
        found = dict(attn=set(), vq=set(), conv=set(), gn=set())
        plain_attn, plain_vq = (transformer.attention_plain,
                                ops_vq.vq_argmin_plain)

        def attn(q, k, v, scale):
            found["attn"].add((int(np.prod(q.shape[:-2])), q.shape[-2],
                               k.shape[-2], q.shape[-1], q.element_size()))
            return plain_attn(q, k, v, scale)

        def vq(z, e):
            found["vq"].add((z.shape[0],) + tuple(e.shape))
            return plain_vq(z, e)

        def conv_hook(mod, args, _):
            if mod.is_3x3_same:
                found["conv"].add((tuple(args[0].shape), mod.weight.shape[0],
                                   args[0].element_size()))

        def gn_hook(mod, args, _):
            found["gn"].add((tuple(args[0].shape), args[0].element_size()))

        hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
                 if isinstance(m, Conv2d)]
        hooks += [m.register_forward_hook(gn_hook) for m in model.modules()
                  if isinstance(m, GroupNorm)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FRIDO_PALLAS", "0")
            mp.setattr(transformer, "attention_plain", attn)
            mp.setattr(ops_vq, "vq_argmin_plain", vq)
            try:
                z = model.encode_first_stage(
                    torch.empty((BATCH, 256, 256, 3), device="meta"))
            finally:
                for h in hooks:
                    h.remove()
        side = model.image_size
        assert tuple(z.shape) == (BATCH, side, side, model.channels)
        out[name] = found
    return out


def _route(site):
    bh, nq, nk, d, itemsize = site
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("FRIDO_SMALLS_ATTN", "1"), ("FRIDO_PALLAS", "auto"),
                     ("FRIDO_FLASH", "1")):
            mp.setenv(k, v)
        if dispatch.use_flash(nk):
            return "flash"
        return "smalls" if dispatch.use_smalls(nq, nk) else "plain"


ENCODE_ATTENTION = {   # kernel -> sites (bh, nq, nk, d, itemsize)
    "t2i": {"flash": {(4, 1024, 1024, 256, 4), (4, 1024, 1024, 128, 4)},
            "smalls": {(4, 256, 256, 512, 4)}},
    "layout2i": {"flash": {(4, 4096, 4096, 256, 4), (4, 4096, 4096, 128, 4),
                           (4, 1024, 1024, 512, 4)}},
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_encode_attention_sites_plans_cover_and_fit(encode_sites, name):
    """The encoder's and the shared decoder's attention: flash from 1024
    tokens (d = 128, 256, 512), the short-sequence kernel (under its
    switch) for the t2i head-1 mid at 16^2; each plan covers its output
    once and fits the shared memory."""
    routes = {}
    for site in encode_sites[name]["attn"]:
        routes.setdefault(_route(site), set()).add(site)
    assert routes == ENCODE_ATTENTION[name]
    for kernel, chosen in routes.items():
        planner = flash_plan if kernel == "flash" else smalls_plan
        for bh, nq, nk, d, itemsize in chosen:
            plan = planner(bh, nq, nk, d, itemsize)
            assert (_coverage(plan, bh, nq, d) == 1).all(), plan
            assert 0 < plan.smem <= MAX_SMEM, plan


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_encode_vq_conv_and_norm_plans_cover_and_fit(encode_sites, name):
    found = encode_sites[name]
    k, d = (8192, 4) if name == "t2i" else (4096, 3)
    fine = 32 if name == "t2i" else 64
    assert found["vq"] == {(BATCH * fine * fine // 4, k, d),
                           (BATCH * fine * fine, k, d)}
    for n, kk, dd in sorted(found["vq"]):
        _check_vq_plan(n, kk, dd)
    # conv_in at Cin = 3, the heads' conv_out at Cout = D, the shared
    # decoder's conv_in from the 2D fused channels
    assert ((BATCH, 3, 256, 256), 128, 4) in found["conv"]
    assert ((BATCH, 256, fine, fine), d, 4) in found["conv"]
    assert ((BATCH, 2 * d, fine, fine), 128, 4) in found["conv"]
    for shape, cout, itemsize in sorted(found["conv"]):
        _check_plan(shape, cout, itemsize, False, False)
    assert ((BATCH, 128, 256, 256), 4) in found["gn"]
    for shape, itemsize in sorted(found["gn"]):
        _check_gn_plan((shape, itemsize))
