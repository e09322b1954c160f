"""The t2i slice in the JAX package's all-kernel configuration
(``FRIDO_CONV_MODE=pallas_fused FRIDO_GN_PALLAS=1 FRIDO_SMALLS_ATTN=1``) on
the CPU, against the JAX package under the same switches.

It reuses ``tests/test_torch_models.py``'s toy t2i model: seeded numpy
params go into both packages, inputs come from numpy with a fixed seed. On
the JAX side ``FRIDO_PALLAS=interpret`` runs the Pallas kernels through
the interpreter wherever the JAX dispatch sends a site to them; on the port
side every routed site takes its op's entry point, which computes the plain
version on CPU tensors.

- Routing: under the switches one toy UNet forward reaches each op's entry
  point at the number of sites its architecture gives (a call counter that
  both devices increment); with no switch set it reaches none.
- The JAX params of the toy model built under the switches have the same
  tree as in the default mode, so the weight bridge still covers them.
- The UNet's eps-hat, both stages, within 3e-4 (``test_torch_models.py``'s
  tolerance).
- The whole tokens -> image chain within ``test_torch_models.py``'s
  tolerances (1e-4 context, 1e-3 latent, 3e-4 image, codes under the margin
  rule). The JAX side of the chain runs its default path: its jitted
  PLMS loop with interpreted kernels inside takes minutes to compile on the
  CPU, and its math under the switches equals the default path's
  (``tests/test_pallas.py:328-359``), which the UNet test above confirms
  against the port at toy size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu_torch.nn.layers import Conv2d, GroupNorm
from frido_tpu_torch.nn.pyunet import ResBlock, UNetUpsample
from frido_tpu_torch.nn.transformer import SpatialTransformer
from frido_tpu_torch.nn.vqgan import AttnBlock
from frido_tpu_torch.ops.cuda.attention import smalls_attention
from frido_tpu_torch.ops.cuda.conv import conv3x3, conv3x3_norm_silu
from frido_tpu_torch.ops.cuda.norm import group_norm
from test_torch_models import (CONFIG, CTX_LEN, _check_decode, _jitted, _np,
                               _t)
from test_torch_models import models  # noqa: F401  (the module fixture)

torch.set_num_threads(2)

SWITCHES = {"FRIDO_CONV_MODE": "pallas_fused", "FRIDO_GN_PALLAS": "1",
            "FRIDO_SMALLS_ATTN": "1"}
OPS = (conv3x3_norm_silu, conv3x3, group_norm, smalls_attention)


@pytest.fixture
def switches(monkeypatch):
    for name, value in SWITCHES.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("FRIDO_PALLAS", "interpret")
    return monkeypatch


@pytest.fixture
def no_switches(monkeypatch):
    for name in (*SWITCHES, "FRIDO_PALLAS", "FRIDO_CONV_SMALLS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _calls():
    return tuple(op.calls for op in OPS)


def _unet_sites(unet):
    """(ResBlocks, SpatialTransformers, upsample convs) of the UNet."""
    mods = list(unet.modules())
    n_res = sum(isinstance(m, ResBlock) for m in mods)
    n_st = sum(isinstance(m, SpatialTransformer) for m in mods)
    n_up = sum(isinstance(m, UNetUpsample) and m.conv is not None
               for m in mods)
    return n_res, n_st, n_up


def _forward(port, stage, seed=1):
    x, ctx = _np(seed, (2, 16, 16, 8)), _np(seed + 1, (2, CTX_LEN, 32))
    t = torch.tensor([3, 27])
    with torch.no_grad():
        return port.apply_model(_t(x), t, _t(ctx), stage)


@pytest.mark.parametrize("stage", [0, 1])
def test_routing_reaches_every_site(models, switches, stage):  # noqa: F811
    _, _, port = models
    unet = port.model.diffusion_model
    n_res, n_st, n_up = _unet_sites(unet)
    assert (n_res, n_st, n_up) == (8, 4, 1)
    before = _calls()
    _forward(port, stage)
    got = tuple(a - b for a, b in zip(_calls(), before))
    # stage 1 without tables computes SPADE's three 3x3 convs at each of
    # the 2 n_res + n_st sites in line, after the pre_input_cond conv
    spade_convs = (1 + 3 * (2 * n_res + n_st)) if stage else 0
    want = (2 * n_res,                    # every ResBlock prologue, twice
            1 + n_up + 1 + spade_convs,   # pre_input, upsample, out head
            n_st + 1,                     # transformer norms, out head
            2 * n_st)                     # self- and cross-attention
    assert got == want


def test_no_switch_reaches_no_new_op(models, no_switches):  # noqa: F811
    _, _, port = models
    before = _calls()
    _forward(port, 1)
    tokens = np.random.default_rng(9).integers(0, 100, (2, CTX_LEN))
    port.get_learned_conditioning(tokens)
    with torch.no_grad():
        port.decode_first_stage(_t(_np(10, (2, 16, 16, 8), 0.05)))
    assert _calls() == before


def test_unported_conv_mode_raises(models, switches):  # noqa: F811
    _, _, port = models
    switches.setenv("FRIDO_CONV_MODE", "auto")
    with pytest.raises(NotImplementedError, match="FRIDO_CONV_MODE=auto"):
        _forward(port, 0)


def test_param_tree_is_the_same_under_the_switches(models,  # noqa: F811
                                                    no_switches):
    def tree():
        jmodel = jax_instantiate(CONFIG)
        shapes = jax.eval_shape(
            lambda r: jmodel.init_params(r, context_len=CTX_LEN),
            jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(lambda s: s.shape, shapes)

    # the module's model was built in the default mode
    default = jax.tree_util.tree_map(lambda a: a.shape, models[1])
    for name, value in SWITCHES.items():
        no_switches.setenv(name, value)
    no_switches.setenv("FRIDO_PALLAS", "interpret")
    assert tree() == default


@pytest.mark.parametrize("stage", [0, 1])
def test_unet_eps_matches_jax_under_the_switches(models, switches,  # noqa: F811
                                                 stage):
    jmodel, jparams, port = models
    x, ctx = _np(1, (2, 16, 16, 8)), _np(2, (2, CTX_LEN, 32))
    t = np.asarray([3, 27], np.int32)
    # a new function object, so the trace reads the switches
    apply = jax.jit(lambda p, a, b, c: jmodel.apply_model(p, a, b, c, stage))
    want = np.asarray(apply(jparams, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx)))
    before = _calls()
    got = port.apply_model(_t(x), _t(t).long(), _t(ctx), stage)
    assert all(a > b for a, b in zip(_calls(), before))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), want, atol=3e-4, rtol=0)


def test_slice_tokens_to_image_matches_jax_under_the_switches(
        models, monkeypatch):  # noqa: F811
    """Port under the switches; JAX on its default path (module
    docstring)."""
    jmodel, jparams, port = models
    tokens = np.random.default_rng(7).integers(0, 100, (2, CTX_LEN),
                                               dtype=np.int32)
    utokens = np.zeros_like(tokens)
    x_init = _np(8, (2, 16, 16, 8))
    for name in (*SWITCHES, "FRIDO_PALLAS"):
        monkeypatch.delenv(name, raising=False)
    cond = _jitted(jmodel, "get_learned_conditioning")
    ctx_j = cond(jparams, jnp.asarray(tokens))
    uctx_j = cond(jparams, jnp.asarray(utokens))
    z_j = np.asarray(jax.jit(lambda p, c, u, x: jmodel.sample(
        p, jax.random.PRNGKey(0), 2, context=c, uncond_context=u, steps=4,
        eta=0.0, guidance_scale=1.5, sampler="plms", x_init=x,
        cfg_mode="sequential"))(jparams, ctx_j, uctx_j, jnp.asarray(x_init)))

    for name, value in SWITCHES.items():
        monkeypatch.setenv(name, value)
    before = _calls()
    ctx_p = port.get_learned_conditioning(tokens)
    uctx_p = port.get_learned_conditioning(_t(utokens))
    np.testing.assert_allclose(ctx_p.detach().numpy(), np.asarray(ctx_j),
                               atol=1e-4, rtol=0)
    z_p = port.sample(2, context=ctx_p, uncond_context=uctx_p, steps=4,
                      eta=0.0, guidance_scale=1.5, x_init=_t(x_init),
                      cfg_mode="sequential")
    assert z_p.shape == (2, 16, 16, 8)
    assert np.abs(z_j - x_init).max() > 1e-2
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-3, rtol=0)
    _check_decode(jmodel, jparams, port, z_j)
    assert all(a > b for a, b in zip(_calls(), before))


def test_decoder_routes_through_the_layers(models, switches):  # noqa: F811
    """nn/vqgan.py has no routing of its own: its GroupNorms and 3x3 convs
    reach the kernels' entry points through nn/layers.py, and its
    attention (256 tokens in the toy decoder) through dot_attention."""
    _, _, port = models
    mods = list(port.first_stage_model.decoder.modules())   # not the encoder
    n_conv = sum(isinstance(m, Conv2d) and m.is_3x3_same for m in mods)
    n_norm = sum(isinstance(m, GroupNorm) for m in mods)
    n_attn = sum(isinstance(m, AttnBlock) for m in mods)
    before = _calls()
    with torch.no_grad():
        port.decode_first_stage(_t(_np(10, (2, 16, 16, 8), 0.05)))
    got = tuple(a - b for a, b in zip(_calls(), before))
    assert got == (0, n_conv, n_norm, n_attn)
    assert min(n_conv, n_norm, n_attn) > 0
