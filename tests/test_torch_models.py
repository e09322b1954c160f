"""The port's models against the JAX package at toy size, on the CPU.

One toy t2i FridoDiffusion (split-head SPADE PyUNet, MS-VQGAN decode side,
one-layer BERT) is built in JAX; seeded numpy values for its params (the
zero-initialised output convs included) go into both packages, into the
port through ``frido_tpu_torch.io.jax_weights``. Inputs come from numpy
with a fixed seed. The JAX calls are jitted to keep compile time down.

Tolerances, fixed before the comparison: 3e-4 absolute for one UNet call
and for decoded images (the golden-suite tolerance,
``tests/test_pyunet_parity.py:16``); 1e-4 for the BERT context; 1e-3 for
the sampled latent, which chains ten UNet calls per stage through PLMS
combinations with coefficients up to 59/24. VQ codes must agree wherever
the best and second-best distances differ by more than 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.nn.pyunet import ResBlock
from frido_tpu_torch.nn.transformer import SpatialTransformer

torch.set_num_threads(2)

UNET = dict(use_split_head=True, split_embed_dim_list=[4, 4],
            use_SPADE_norm=True, image_size=16, in_channels=8,
            out_channels=8, model_channels=32, attention_resolutions=[2],
            num_res_blocks=1, channel_mult=[1, 2], num_head_channels=16,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=32, num_stage=2)
ED = dict(multiscale=2, double_z=False, z_channels=[4, 4], resolution=32,
          in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 2],
          num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
# attn at 16 = the decoder's first resolution, so AttnBlock runs
DD = dict(double_z=False, z_channels=8, resolution=32, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
          attn_resolutions=[16], dropout=0.0)
CTX_LEN = 16
CONFIG = {
    "target": "frido.models.diffusion.frido.FridoDiffusion",
    "params": dict(
        adopted_scale_factor=True, adopted_scale_factor_value=[0.8, 1.3],
        linear_start=0.0015, linear_end=0.0155, timesteps=40,
        image_size=16, channels=8, conditioning_key="crossattn",
        unet_config=dict(target="frido.modules.diffusionmodules.pyunet."
                                "PyUNetModel", params=UNET),
        first_stage_config=dict(
            target="taming.models.msvqgan.VQModelInterface",
            params=dict(embed_dim=[4, 4], n_embed=[32, 32], edconfig=ED,
                        ddconfig=DD,
                        lossconfig={"target":
                                    "taming.modules.losses.DummyLoss"})),
        cond_stage_config=dict(
            target="frido.modules.encoders.modules.BERTEmbedder",
            params=dict(n_embed=32, n_layer=1, vocab_size=100,
                        max_seq_len=CTX_LEN, use_tokenizer=False)),
    ),
}


def _random_params(shapes, rng):
    """Seeded random values for every JAX leaf: convs and dense layers at
    the init scale 1/sqrt(fan_in), norm scales around 1, small biases,
    embeddings from N(0, 0.02) as at init. The zero-initialised output
    convs are random too, else eps-hat would be trivially 0."""
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
        elif k == "embedding":
            z = 0.02 * z
        else:
            z = 0.1 * z
        out[k] = z.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jmodel = jax_instantiate(CONFIG)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    port = instantiate_from_config(CONFIG, device="cpu")
    # the whole JAX tree, first-stage encoder and fusion heads included,
    # loads strictly: no leaf is skipped and nothing warns
    state = jax_params_to_state_dict(np_params)
    assert set(state) == set(port.state_dict())
    assert any(k.startswith("first_stage_model.encoder.") for k in state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_jax_params(port, np_params)
    return jmodel, jparams, port


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("stage", [0, 1])
def test_unet_eps_matches_jax(models, stage):
    jmodel, jparams, port = models
    x, ctx = _np(1, (2, 16, 16, 8)), _np(2, (2, CTX_LEN, 32))
    t = np.asarray([3, 27], np.int32)
    apply = jax.jit(jmodel.apply_model, static_argnums=(4,))
    want = np.asarray(apply(jparams, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx), stage))
    got = port.apply_model(_t(x), _t(t).long(), _t(ctx), stage)
    assert got.shape == (2, 16, 16, 4)
    assert np.abs(want).max() > 1e-2  # the output convs are not zero
    np.testing.assert_allclose(got.detach().numpy(), want, atol=3e-4, rtol=0)


def test_spade_tables_equal_recompute(models):
    _, _, port = models
    x, ctx = _t(_np(3, (2, 16, 16, 8))), _t(_np(4, (2, CTX_LEN, 32)))
    t = torch.tensor([5, 33])
    with torch.no_grad():
        inline = port.apply_model(x, t, ctx, 1)
        tables = port.spade_tables(x[..., :4], 1)
        pre = port.apply_model(x, t, ctx, 1, spade_pre=tables)
        poisoned = port.apply_model(
            x, t, ctx, 1, spade_pre={k: tuple((g + 1, b) for g, b in v)
                                     if isinstance(v[0], tuple)
                                     else (v[0] + 1, v[1])
                                     for k, v in tables.items()})
    unet = port.model.diffusion_model
    assert len(tables) == sum(isinstance(m, (ResBlock, SpatialTransformer))
                              for m in unet.modules())
    torch.testing.assert_close(pre, inline, atol=1e-6, rtol=0)
    assert (poisoned - inline).abs().max() > 1e-3


def _decided(z, codebook):
    d = (codebook.astype(np.float64) ** 2).sum(1)[None] \
        - 2 * z.reshape(-1, z.shape[-1]).astype(np.float64) \
        @ codebook.astype(np.float64).T
    top2 = np.sort(d, axis=1)[:, :2]
    return ((top2[:, 1] - top2[:, 0]) > 1e-5).reshape(z.shape[:-1])


def _check_decode(jmodel, jparams, port, z):
    """Both decoders on the same scaled latent: codes under the margin rule,
    then the images."""
    want_img, want_codes = jmodel.decode_first_stage_with_codes(
        jparams, jnp.asarray(z))
    zt = _t(z)
    with torch.no_grad():
        _, got_codes = port.first_stage_model.decode_interface(
            port._scale_latent(zt, invert=True), return_code=True)
        got_img = port.decode_first_stage(zt)
    z_raw = port._scale_latent(zt, invert=True).numpy()
    for i, (g, w) in enumerate(zip(got_codes, want_codes)):
        books = port.first_stage_model.ms_quantize[i].embedding.weight
        keep = _decided(z_raw[..., 4 * i:4 * i + 4], books.detach().numpy())
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])
    assert got_img.shape == (z.shape[0], 32, 32, 3)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=3e-4, rtol=0)


def test_decode_matches_jax(models):
    jmodel, jparams, port = models
    _check_decode(jmodel, jparams, port, _np(5, (2, 16, 16, 8), 0.05))


def test_decode_chunks_and_warns_on_ragged_batch(models):
    _, _, port = models
    z = _t(_np(6, (3, 16, 16, 8), 0.05))
    whole = port.decode_first_stage(z)
    with pytest.warns(UserWarning, match="does not divide"):
        ragged = port.decode_first_stage(z, chunk=2)
    torch.testing.assert_close(ragged, whole)
    z4 = torch.cat([z, z[:1]])
    chunked = port.decode_first_stage(z4, chunk=2)
    torch.testing.assert_close(chunked[:3], whole, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cfg_mode", ["sequential", "batched"])
def test_slice_tokens_to_image_matches_jax(models, cfg_mode):
    """tokens -> context -> PLMS (CFG 1.5) in both packages; then the JAX
    latent through both decoders, so a near-tie code flip in sampling
    cannot reach the image comparison."""
    jmodel, jparams, port = models
    tokens = np.random.default_rng(7).integers(0, 100, (2, CTX_LEN),
                                               dtype=np.int32)
    utokens = np.zeros_like(tokens)
    ctx_j = jmodel.get_learned_conditioning(jparams, jnp.asarray(tokens))
    uctx_j = jmodel.get_learned_conditioning(jparams, jnp.asarray(utokens))
    ctx_p = port.get_learned_conditioning(tokens)
    uctx_p = port.get_learned_conditioning(_t(utokens))
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), atol=1e-4,
                               rtol=0)
    x_init = _np(8, (2, 16, 16, 8))
    z_j = jax.jit(lambda p, c, u, x: jmodel.sample(
        p, jax.random.PRNGKey(0), 2, context=c, uncond_context=u, steps=4,
        eta=0.0, guidance_scale=1.5, sampler="plms", x_init=x,
        cfg_mode=cfg_mode))(jparams, ctx_j, uctx_j, jnp.asarray(x_init))
    z_p = port.sample(2, context=ctx_p, uncond_context=uctx_p, steps=4,
                      eta=0.0, guidance_scale=1.5, x_init=_t(x_init),
                      cfg_mode=cfg_mode)
    z_j = np.asarray(z_j)
    assert z_p.shape == (2, 16, 16, 8)
    assert np.abs(z_j - x_init).max() > 1e-2  # the chain moved the latent
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-3, rtol=0)
    _check_decode(jmodel, jparams, port, z_j)
