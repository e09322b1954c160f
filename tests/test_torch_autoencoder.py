"""The port's single-scale first stages, posterior, Gumbel and EMA
quantizers and tiled inference against the JAX package, on the CPU.

- ``VQModel`` and ``AutoencoderKL`` on a toy ``ddconfig`` (32^2 images,
  one AttnBlock level), seeded numpy weights in both packages carried by
  ``io/jax_weights.py``; ``IdentityFirstStage``.
- ``DiagonalGaussianDistribution`` (``sample`` fed JAX's normal draws,
  ``mode``, ``kl`` with and without ``other``, ``nll``) and ``normal_kl``.
- ``GumbelQuantize`` in eval and in training (the port's ``_gumbel`` fed
  the draws the JAX module makes), ``EMAVectorQuantizer``'s update of its
  three buffers (loaded from the JAX ``ema`` collection).
- Tiled inference on the JAX tiling test's toy model
  (``tests/test_tiling.py``: ``ks (16, 16)``, ``stride (8, 8)``, a latent
  twice the training size): ``tile_positions``, ``tiled_apply`` and the
  tiled ``apply_model`` and ``decode_first_stage``.

Tolerances, fixed before the comparison: 1e-4 absolute for latents and
posterior moments; 3e-4 for images, tiled UNet outputs and tiled decodes;
1e-5 relative for losses, KL and NLL; 1e-6 for the EMA buffers. Codes
must agree wherever the best and second-best distances (or, for Gumbel,
logits) differ by more than 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY_COND, _TINY_FIRST, _TINY_MODEL, _TINY_UNET
from frido_tpu.models import autoencoder as jax_autoencoder
from frido_tpu.models.frido import FridoDiffusion as JaxFrido
from frido_tpu.nn import distributions as jax_dist
from frido_tpu.nn import quantize as jax_quantize
from frido_tpu.ops import tiling as jax_tiling
from frido_tpu_torch.io.jax_weights import load_jax_params
from frido_tpu_torch.models.autoencoder import (AutoencoderKL,
                                                IdentityFirstStage, VQModel)
from frido_tpu_torch.models.frido import FridoDiffusion
from frido_tpu_torch.nn import distributions, quantize
from frido_tpu_torch.ops.tiling import tile_positions, tiled_apply
from tests.test_torch_models import _decided, _np, _random_params, _t

torch.set_num_threads(2)

LATENT_ATOL = 1e-4
IMAGE_ATOL = 3e-4
RTOL = 1e-5
EMA_ATOL = 1e-6
DDCONFIG = dict(double_z=False, z_channels=4, resolution=32, in_channels=3,
                out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
                attn_resolutions=[16], dropout=0.0)
X_SHAPE = (2, 32, 32, 3)
SPLIT = {"ks": (16, 16), "stride": (8, 8)}


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _build(jax_cls, port_cls, params, init_kwargs=None, seed=30):
    """(JAX module, numpy variables, port model) from one config."""
    module = jax_cls(**params).module
    shapes = jax.eval_shape(
        lambda r: module.init(r, jnp.zeros(X_SHAPE), **(init_kwargs or {})),
        jax.random.PRNGKey(0))
    variables = _random_params(shapes, np.random.default_rng(seed))
    port = port_cls(**params, device="cpu").eval()
    load_jax_params(port, variables)
    return module, variables, port


# ---------------------------------------------------------------------------
# single-scale first stages


def test_vq_model_matches_jax():
    params = dict(ddconfig=DDCONFIG, n_embed=32, embed_dim=4,
                  lossconfig={"target": "taming.modules.losses.DummyLoss"})
    module, variables, port = _build(jax_autoencoder.VQModel, VQModel,
                                     params)
    x = _np(31, X_SHAPE)

    @jax.jit
    def run(v, x):
        return dict(
            pre=module.apply(v, x, method="encode_prequant"),
            forward=module.apply(v, x),
            interface=module.apply(v, x, method="encode_interface"),
            decoded=module.apply(
                v, module.apply(v, x, method="encode_interface"),
                method="decode_interface"))

    want = run(jax.tree_util.tree_map(jnp.asarray, variables),
               jnp.asarray(x))
    with torch.no_grad():
        pre = port.encode_prequant(_t(x))
        dec, diff, idx = port(_t(x))
        interface = port.encode_interface(_t(x))
        decoded = port.decode_interface(interface)
    assert pre.shape == (2, 16, 16, 4) and dec.shape == X_SHAPE
    _close(pre, want["pre"], LATENT_ATOL)
    _close(interface, want["interface"], LATENT_ATOL)
    dec_j, diff_j, idx_j = want["forward"]
    keep = _decided(pre.numpy(), port.quantize.embedding.weight.detach()
                    .numpy())
    assert keep.all()       # so the images compare in full
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(diff.item(), float(diff_j), rtol=RTOL)
    _close(dec, dec_j, IMAGE_ATOL)
    _close(decoded, want["decoded"], IMAGE_ATOL)


def test_autoencoder_kl_matches_jax(monkeypatch):
    ddconfig = dict(DDCONFIG, double_z=True)
    module, variables, port = _build(
        jax_autoencoder.AutoencoderKL, AutoencoderKL,
        dict(ddconfig=ddconfig, embed_dim=3), dict(sample_posterior=False))
    x = _np(32, X_SHAPE)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def run(v, x):
        posterior = module.apply(v, x, method="encode")
        dec_mode, _ = module.apply(v, x, sample_posterior=False)
        dec_sample, _ = module.apply(v, x, rng=key)
        noise = jax.random.normal(key, posterior.mean.shape)
        return dict(mean=posterior.mean, logvar=posterior.logvar,
                    kl=posterior.kl(), dec_mode=dec_mode,
                    dec_sample=dec_sample, noise=noise)

    want = run(jax.tree_util.tree_map(jnp.asarray, variables),
               jnp.asarray(x))
    noise = _t(np.asarray(want["noise"]))
    monkeypatch.setattr(distributions, "_normal",
                        lambda shape, dtype, device, generator=None: noise)
    with torch.no_grad():
        posterior = port.encode(_t(x))
        dec_mode, _ = port(_t(x), sample_posterior=False)
        dec_sample, _ = port(_t(x))
    assert posterior.mean.shape == (2, 16, 16, 3)
    _close(posterior.mean, want["mean"], LATENT_ATOL)
    _close(posterior.logvar, want["logvar"], LATENT_ATOL)
    _close(posterior.kl(), want["kl"], 0.0, RTOL)
    _close(dec_mode, want["dec_mode"], IMAGE_ATOL)
    _close(dec_sample, want["dec_sample"], IMAGE_ATOL)
    assert (dec_sample - dec_mode).abs().max() > 1e-3


def test_identity_first_stage():
    x = _np(33, (1, 4, 4, 2))
    for vq in (False, True):
        jid = jax_autoencoder.IdentityFirstStage(vq_interface=vq)
        port = IdentityFirstStage(vq_interface=vq)
        for name in ("encode", "decode"):
            assert getattr(port, name)(x) is x
            np.testing.assert_array_equal(getattr(jid, name)(x), x)
        assert port(x) is x
        got, want = port.quantize(x), jid.quantize(x)
        if vq:
            assert got[0] is x and got[1:] == want[1:] == (None,
                                                           [None] * 3)
        else:
            assert got is x


# ---------------------------------------------------------------------------
# the posterior


def _moments(seed):
    return _np(seed, (2, 4, 4, 6))


def test_diagonal_gaussian_matches_jax(monkeypatch):
    params, other_params = _moments(34), _moments(35)
    key = jax.random.PRNGKey(3)
    jd = jax_dist.DiagonalGaussianDistribution(jnp.asarray(params))
    jo = jax_dist.DiagonalGaussianDistribution(jnp.asarray(other_params))
    noise = np.asarray(jax.random.normal(key, jd.mean.shape, jd.mean.dtype))
    monkeypatch.setattr(distributions, "_normal",
                        lambda shape, dtype, device, generator=None:
                        _t(noise))
    pd = distributions.DiagonalGaussianDistribution(_t(params))
    po = distributions.DiagonalGaussianDistribution(_t(other_params))
    sample = pd.sample(torch.Generator().manual_seed(0))
    _close(sample, jd.sample(key), LATENT_ATOL)
    _close(pd.mode(), jd.mode(), 0.0)
    _close(pd.kl(), jd.kl(), 0.0, RTOL)
    _close(pd.kl(po), jd.kl(jo), 0.0, RTOL)
    _close(pd.nll(_t(other_params[..., :3])),
           jd.nll(jnp.asarray(other_params[..., :3])), 0.0, RTOL)
    _close(pd.nll(_t(other_params[..., :3]), dims=(1, 2)),
           jd.nll(jnp.asarray(other_params[..., :3]), dims=(1, 2)), 0.0,
           RTOL)
    det = distributions.DiagonalGaussianDistribution(_t(params),
                                                     deterministic=True)
    assert float(det.kl()) == float(det.nll(sample)) == 0.0
    assert float(det.std.abs().max()) == 0.0


def test_diagonal_gaussian_sample_draws_on_the_generator():
    pd = distributions.DiagonalGaussianDistribution(_t(_moments(36)))
    a = pd.sample(torch.Generator().manual_seed(4))
    b = pd.sample(torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - pd.mode()).abs().max() > 1e-2


def test_normal_kl_matches_jax():
    m1, l1, m2, l2 = (_np(s, (3, 5)) for s in range(37, 41))
    _close(distributions.normal_kl(_t(m1), _t(l1), _t(m2), _t(l2)),
           jax_dist.normal_kl(m1, l1, m2, l2), 0.0, RTOL)
    _close(distributions.normal_kl(_t(m1), _t(l1), 0.0, 0.0),
           jax_dist.normal_kl(m1, l1, 0.0, 0.0), 0.0, RTOL)


# ---------------------------------------------------------------------------
# Gumbel and EMA quantizers


@pytest.fixture(scope="module")
def gumbel():
    jq = jax_quantize.GumbelQuantize(n_e=16, e_dim=4, num_hiddens=6,
                                     kl_weight=0.01, temperature=0.7)
    z = _np(41, (2, 5, 6, 6))
    shapes = jax.eval_shape(jq.init, jax.random.PRNGKey(0), jnp.asarray(z))
    variables = _random_params(shapes, np.random.default_rng(42))
    port = quantize.GumbelQuantize(16, 4, 6, kl_weight=0.01,
                                   temperature=0.7, device="cpu")
    load_jax_params(port, variables)
    return jq, variables, port, z


def _logit_decided(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 1e-5


def test_gumbel_quantize_eval_matches_jax(gumbel):
    jq, variables, port, z = gumbel
    zq_j, kl_j, idx_j = jq.apply(variables, jnp.asarray(z))
    with torch.no_grad():
        zq, kl, idx = port.eval()(_t(z))
        logits = port.proj(_t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    keep = _logit_decided(logits)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[keep], np.asarray(idx_j)[keep])
    _close(zq[keep], np.asarray(zq_j)[keep], LATENT_ATOL)
    _close(kl, kl_j, 0.0, RTOL)
    torch.testing.assert_close(port.get_codebook_entry(idx),
                               port.embed.weight[idx.long()])


@pytest.mark.parametrize("straight_through", [True, False])
def test_gumbel_quantize_training_matches_jax(gumbel, monkeypatch,
                                              straight_through):
    jq, variables, port, z = gumbel
    jq = jq.clone(straight_through=straight_through)
    port.straight_through = straight_through
    draws = []
    jax_gumbel = jax.random.gumbel

    def recorded(*args, **kwargs):
        draws.append(jax_gumbel(*args, **kwargs))
        return draws[-1]

    monkeypatch.setattr(jax.random, "gumbel", recorded)
    zq_j, kl_j, idx_j = jq.apply(variables, jnp.asarray(z),
                                 deterministic=False,
                                 rngs={"gumbel": jax.random.PRNGKey(5)})
    assert len(draws) == 1
    g = _t(np.asarray(draws[0]))
    monkeypatch.setattr(quantize, "_gumbel",
                        lambda shape, dtype, device, generator=None: g)
    with torch.no_grad():
        zq, kl, idx = port.train()(_t(z))
        logits = port.proj(_t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    port.eval()
    keep = _logit_decided((logits + g) / 0.7)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[keep], np.asarray(idx_j)[keep])
    _close(zq, zq_j, LATENT_ATOL)
    _close(kl, kl_j, 0.0, RTOL)


def test_ema_vector_quantizer_update_matches_jax():
    n_e, e_dim = 12, 3
    jq = jax_quantize.EMAVectorQuantizer(n_e, e_dim, beta=0.3, decay=0.9)
    ema = {"embedding": _np(43, (n_e, e_dim)),
           "cluster_size": np.abs(_np(44, (n_e,))) + 0.5,
           "embed_avg": _np(45, (n_e, e_dim))}
    variables = {"ema": ema}
    z = _np(46, (2, 4, 5, e_dim))
    port = quantize.EMAVectorQuantizer(n_e, e_dim, beta=0.3, decay=0.9,
                                       device="cpu")
    load_jax_params(port, variables)
    keep = _decided(z, ema["embedding"])
    assert keep.all()       # every assignment decided, so the sums compare

    # eval: no update, in either package
    (zq_j, loss_j, idx_j), state = jq.apply(variables, jnp.asarray(z),
                                            mutable=["ema"])
    zq, loss, idx = port.eval()(_t(z))
    for name, value in ema.items():
        np.testing.assert_array_equal(np.asarray(state["ema"][name]), value)
        np.testing.assert_array_equal(getattr(port, name).numpy(), value)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(zq, zq_j, LATENT_ATOL)
    _close(loss, loss_j, 0.0, RTOL)

    # training: the three buffers move as the JAX collection does
    (zq_j, loss_j, idx_j), state = jq.apply(
        variables, jnp.asarray(z), deterministic=False, mutable=["ema"])
    zq, loss, idx = port.train()(_t(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(zq, zq_j, LATENT_ATOL)
    _close(loss, loss_j, 0.0, RTOL)
    for name, value in ema.items():
        got = getattr(port, name)
        assert np.abs(got.numpy() - value).max() > 1e-3
        _close(got, state["ema"][name], EMA_ATOL)
    torch.testing.assert_close(port.get_codebook_entry(idx),
                               port.embedding[idx.long()])


def test_ema_vector_quantizer_init():
    port = quantize.EMAVectorQuantizer(8, 3, device="cpu")
    port.reset_parameters(torch.Generator().manual_seed(0))
    assert float(port.cluster_size.abs().max()) == 0.0
    torch.testing.assert_close(port.embed_avg, port.embedding)
    assert 0.005 < float(port.embedding.std()) < 0.05


# ---------------------------------------------------------------------------
# tiled inference


@pytest.mark.parametrize("size,ks,stride", [
    (8, 8, 4), (16, 8, 4), (18, 8, 4), (4, 8, 4), (32, 16, 8), (31, 16, 8)])
def test_tile_positions_match_jax(size, ks, stride):
    assert tile_positions(size, ks, stride) == jax_tiling.tile_positions(
        size, ks, stride)


def test_tiled_apply_matches_jax():
    x = _np(47, (2, 18, 20, 3))
    fn_j = lambda t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2)[..., :2] * t.mean()
    fn_p = lambda t: (t.repeat_interleave(2, 1).repeat_interleave(2, 2)
                      [..., :2] * t.mean())
    want = jax_tiling.tiled_apply(fn_j, jnp.asarray(x), ks=(8, 8),
                                  stride=(4, 6), scale=2)
    got = tiled_apply(fn_p, _t(x), ks=(8, 8), stride=(4, 6), scale=2)
    assert got.shape == (2, 36, 40, 2)
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="channels"):
        tiled_apply(fn_p, _t(x), ks=(8, 8), stride=(4, 6), out_ch=3)


class _JitPerCall:
    """Stands in for the JAX model's flax module: each ``apply`` is jitted
    once per method and per value of its int and bool arguments, so the
    tiles of ``FridoDiffusion.apply_model`` and ``decode_first_stage`` run
    one compiled tile each."""

    def __init__(self, module):
        self.module, self.compiled = module, {}

    def apply(self, params, *args, method):
        static = {i: a for i, a in enumerate(args)
                  if isinstance(a, (bool, int))}
        key = (method, tuple(static.items()))
        if key not in self.compiled:
            def call(params, *arrays):
                it = iter(arrays)
                full = [static[i] if i in static else next(it)
                        for i in range(len(args))]
                return self.module.apply(params, *full, method=method)
            self.compiled[key] = jax.jit(call)
        arrays = [a for i, a in enumerate(args) if i not in static]
        return self.compiled[key](params, *arrays)


@pytest.fixture(scope="module")
def tiled_models():
    kw = {**_TINY_MODEL, "split_input_params": SPLIT}
    jmodel = JaxFrido(first_stage_config=_TINY_FIRST,
                      cond_stage_config=_TINY_COND, unet_config=_TINY_UNET,
                      **kw)
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r, context_len=12),
                            jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(48))
    jmodel.module = _JitPerCall(jmodel.module)
    port = FridoDiffusion(first_stage_config=_TINY_FIRST,
                          cond_stage_config=_TINY_COND,
                          unet_config=_TINY_UNET, device="cpu", **kw)
    load_jax_params(port, np_params)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), port


def test_tiled_apply_model_matches_jax(tiled_models):
    jmodel, jparams, port = tiled_models
    z, ctx = _np(49, (1, 32, 32, 8)), _np(50, (1, 12, 48))
    t = np.asarray([17], np.int32)
    for stage in (0, 1):
        want = jmodel.apply_model(jparams, jnp.asarray(z), jnp.asarray(t),
                                  jnp.asarray(ctx), stage)
        with torch.no_grad():
            got = port.apply_model(_t(z), _t(t).long(), _t(ctx), stage)
        assert got.shape == want.shape and got.shape[1:3] == (32, 32)
        assert np.abs(np.asarray(want)).max() > 1e-2
        _close(got, want, IMAGE_ATOL)


def test_tiled_decode_matches_jax(tiled_models):
    jmodel, jparams, port = tiled_models
    z = _np(51, (2, 32, 32, 8), 0.05)
    want = jmodel.decode_first_stage(jparams, jnp.asarray(z))
    got = port.decode_first_stage(_t(z))
    assert got.shape == (2, 64, 64, 3)
    _close(got, want, IMAGE_ATOL)
    # chunking wraps the tiled decode
    _close(port.decode_first_stage(_t(z), chunk=1), want, IMAGE_ATOL)
    # at the training size the whole latent decodes at once
    small = _np(52, (1, 16, 16, 8), 0.05)
    _close(port.decode_first_stage(_t(small)),
           jmodel.decode_first_stage(jparams, jnp.asarray(small)),
           IMAGE_ATOL)


def test_tiled_sampling_skips_the_spade_tables(tiled_models, monkeypatch):
    _, _, port = tiled_models

    def refuse(*args):
        raise AssertionError("full-grid SPADE tables under tiling")

    monkeypatch.setattr(port, "spade_tables", refuse)
    monkeypatch.setattr(port, "image_size", 32)     # twice the training size
    z = port.sample(1, context=_t(_np(53, (1, 12, 48))), steps=1, eta=0.0,
                    x_init=_t(_np(54, (1, 32, 32, 8))),
                    generator=torch.Generator().manual_seed(0))
    assert z.shape == (1, 32, 32, 8) and bool(torch.isfinite(z).all())
