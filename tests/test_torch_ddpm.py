"""The port's pixel-space DDPM and ``DiffusionWrapper`` against the JAX
package, on the CPU.

A toy pixel-space ``DDPM`` (the ``frido.models.diffusion.frido.DDPM``
target, no first stage, 16^2 x 3 images, 40 timesteps; the UNet is the
``ddpm-pixel`` combination of ``tests/test_torch_pyunet_options.py``:
GroupNorm ResBlocks with resblock up/down and scale-shift norm, the plain
``AttentionBlock`` in the new QKV order; ``learn_logvar`` on, a scale
factor of 0.5) is built in both packages from one config; seeded numpy
values for every JAX leaf go into both (``tests/test_torch_models.py``'s
recipe), into the port through ``io/jax_weights.load_jax_params``.

- The config builds the port's ``DDPM`` through ``instantiate_from_config``;
  encode and decode are the scaled identity, as in the JAX package.
- One training loss (``training_loss`` with the same t and noise) and every
  gradient, ``logvar``'s included, against ``jax.value_and_grad`` of the
  JAX loss; ``DiffusionTrainer`` takes a step on the DDPM (the batch's
  image is the latent, no first stage to freeze) and its loss is the
  model's on the trainer's own draws.
- A DDIM chain of 4 steps with eta 1 fed the JAX package's draws
  (``tests/test_torch_samplers.py``'s replay of its keys).
- ``DiffusionWrapper`` with each of the five conditioning keys against the
  JAX wrapper; ``concat`` through ``FridoDiffusion.apply_model``; ``adm``
  and ``hybrid`` through ``FridoDiffusion`` refused, naming the JAX fault.

Tolerances, fixed before the comparison (``tests/test_torch_training.py``
and ``tests/test_torch_samplers.py``): the loss 3e-4 absolute; each
gradient leaf within 1e-3 of its largest JAX magnitude, floored at 1e-3 of
the largest over all leaves; the sampled images 1e-3; one wrapper call
3e-4; the identity encode and decode 1e-7 (one fp32 multiply).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.models.frido import DiffusionWrapper as JaxWrapper
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.models.frido import DDPM, DiffusionWrapper
from frido_tpu_torch.training import optim, trainer
from tests.test_torch_models import _random_params
from tests.test_torch_samplers import _feed, _jax_draws

torch.set_num_threads(2)

LOSS_ATOL = 3e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-3
IMAGE_ATOL = 1e-3
WRAPPER_ATOL = 3e-4
SHAPE = (2, 16, 16, 3)
UNET = dict(image_size=16, in_channels=3, out_channels=3, model_channels=32,
            num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2],
            num_head_channels=16, resblock_updown=True,
            use_scale_shift_norm=True, use_new_attention_order=True)
# the schedule of tests/test_torch_models.py (40 timesteps), whose draws
# tests/test_torch_samplers.py replays
CONFIG = {
    "target": "frido.models.diffusion.frido.DDPM",
    "params": dict(
        unet_config={"target": "frido.modules.diffusionmodules.pyunet."
                               "PyUNetModel", "params": UNET},
        channels=3, image_size=16, timesteps=40, linear_start=0.0015,
        linear_end=0.0155, scale_factor=0.5, learn_logvar=True,
        logvar_init=0.1),
}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_instantiate(CONFIG)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    port = instantiate_from_config(CONFIG, device="cpu")
    assert set(jax_params_to_state_dict(np_params)) == set(port.state_dict())
    load_jax_params(port, np_params)
    return jmodel, jparams, port


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_ddpm_target_builds_a_pixel_space_model(models):
    jmodel, _, port = models
    assert isinstance(port, DDPM)
    assert port.first_stage_model is None and jmodel.first_stage_config is None
    assert port.num_stage == jmodel.num_stage == 1
    assert port.embed_dim_list == jmodel.embed_dim_list == [3]
    assert isinstance(port.logvar, torch.nn.Parameter)
    assert port.logvar.shape == (40,)
    with pytest.raises(ValueError, match="no first stage"):
        port.quantize_latent(torch.zeros(SHAPE))


def test_encode_and_decode_are_the_scaled_identity(models):
    jmodel, jparams, port = models
    x = _np(1, SHAPE)
    z = port.encode_first_stage(torch.from_numpy(x))
    want = np.asarray(jmodel.encode_first_stage(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(z.numpy(), want, atol=1e-7, rtol=0)
    np.testing.assert_allclose(z.numpy(), 0.5 * x, atol=1e-7, rtol=0)
    back = port.decode_first_stage(z)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        np.asarray(jmodel.decode_first_stage(jparams, jnp.asarray(want))),
        back.numpy(), atol=1e-7, rtol=0)


def _check_grads(got, want):
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= GRAD_RTOL * max(np.abs(w).max(), floor), (k, err)


def test_training_loss_and_every_gradient_match_jax(models):
    jmodel, jparams, port = models
    z = 0.5 * _np(2, SHAPE)
    noise = _np(3, SHAPE)
    t = np.asarray([5, 33], np.int32)
    (want, jlogs), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.training_loss(p, z, None, t, noise),
        has_aux=True))(jparams)
    port.train()
    port.zero_grad(set_to_none=True)
    loss, logs = port.training_loss(torch.from_numpy(z), None,
                                    torch.from_numpy(t).long(),
                                    torch.from_numpy(noise))
    loss.backward()
    port.eval()
    assert set(logs) == set(jlogs) == {"loss", "loss_simple_stage0",
                                       "loss_vlb_stage0"}
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   atol=LOSS_ATOL, rtol=0, err_msg=k)
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))
    _check_grads(got, want_grads)
    # logvar's gradient sits at the drawn timesteps only
    assert set(np.flatnonzero(got["logvar"])) == {5, 33}


def test_trainer_steps_a_pixel_space_ddpm():
    port = instantiate_from_config(CONFIG, device="cpu", seed=3)
    before = port.logvar.detach().clone()
    params = [p for _, p in trainer.trainable_parameters(port)]
    assert len(params) == len(list(port.parameters()))
    tr = trainer.DiffusionTrainer(port, optim.build_optimizer(params, 1e-3),
                                  use_ema=True)
    image = torch.from_numpy(_np(4, SHAPE))
    t, noise = trainer._draw(torch.Generator().manual_seed(9), 2, 40, SHAPE,
                             torch.device("cpu"))
    with torch.no_grad():
        want, _ = port.training_loss(0.5 * image, None, t, noise)
    logs = tr.train_step({"image": image}, torch.Generator().manual_seed(9))
    assert float(logs["loss"]) == pytest.approx(float(want), abs=1e-6)
    # AdamW moves the drawn timesteps' entries by about lr; the others
    # only by its weight decay
    moved = (port.logvar.detach() - before).abs().numpy()
    drawn = np.zeros(40, bool)
    drawn[t.numpy()] = True
    assert moved[drawn].min() > 10 * moved[~drawn].max()
    assert tr.ema.num_updates == 1


def test_ddim_chain_matches_jax(models, monkeypatch):
    jmodel, jparams, port = models
    draws = _jax_draws(5, SHAPE, [(0, 3)], "ddim", 4, 1.0)
    want = np.asarray(jax.jit(lambda p: jmodel.sample(
        p, jax.random.PRNGKey(5), 2, steps=4, eta=1.0,
        sampler="ddim"))(jparams))
    queue = _feed(monkeypatch, draws)
    got = port.sample(2, steps=4, eta=1.0, sampler="ddim")
    assert not queue
    assert got.shape == SHAPE
    assert np.abs(want - draws[0]).max() > 1e-2    # the chain moved
    np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_ATOL, rtol=0)
    np.testing.assert_allclose(port.decode_first_stage(got).numpy(),
                               2.0 * want, atol=2 * IMAGE_ATOL, rtol=0)


WRAPPED = dict(image_size=8, in_channels=4, out_channels=4,
               model_channels=32, attention_resolutions=[2],
               num_res_blocks=1, channel_mult=[1, 2], num_head_channels=16)


def _wrapper_case(key):
    """(unet params, JAX wrapper inputs) of ``test_model_paths_parity``'s
    wrapper cases: concat maps of 2 channels, 5 context tokens of 64, class
    ids of 10 classes."""
    cfg = dict(WRAPPED)
    rng = np.random.default_rng(6)
    kw = {}
    if key in ("concat", "hybrid"):
        cfg["in_channels"] = 6
        kw["c_concat"] = [rng.standard_normal((2, 8, 8, 2), np.float32)]
    if key in ("crossattn", "hybrid"):
        cfg.update(use_spatial_transformer=True, transformer_depth=1,
                   context_dim=64)
        kw["c_crossattn"] = [rng.standard_normal((2, 3, 64), np.float32),
                             rng.standard_normal((2, 2, 64), np.float32)]
    if key == "adm":
        cfg.update(num_classes=10, use_embed=True)
        kw["c_crossattn"] = [np.asarray([1, 7], np.int32)]
    return cfg, kw


@pytest.mark.parametrize("key", [None, "concat", "crossattn", "hybrid",
                                 "adm"])
def test_diffusion_wrapper_matches_jax(key):
    cfg, kw = _wrapper_case(key)
    unet = {"target": "frido_tpu.nn.pyunet.PyUNetModel", "params": cfg}
    jw = JaxWrapper(unet_config=unet, conditioning_key=key)
    x = _np(7, (2, 8, 8, 4))
    t = np.asarray([3, 33], np.int32)
    shapes = jax.eval_shape(lambda r: jw.init(r, x, t, **kw),
                            jax.random.PRNGKey(0))
    np_params = _random_params(shapes["params"], np.random.default_rng(8))
    want = np.asarray(jax.jit(lambda p, x, t, kw: jw.apply(
        p, x, t, **kw))({"params": np_params}, x, t, kw))
    port = DiffusionWrapper(unet, key, device="cpu")
    load_jax_params(port, np_params)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    pkw = {}
    if "c_concat" in kw:
        pkw["c_concat"] = [nchw(a) for a in kw["c_concat"]]
    if "c_crossattn" in kw:
        pkw["c_crossattn"] = [torch.from_numpy(a) for a in kw["c_crossattn"]]
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t).long(), **pkw)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=WRAPPER_ATOL, rtol=0)


def _keyed(key, cond):
    cfg = copy.deepcopy(CONFIG)
    cfg["params"].update(conditioning_key=key, cond_stage_config=cond)
    return cfg


def test_concat_through_apply_model_joins_the_channels():
    cond = {"target": "frido.modules.encoders.modules.SpatialRescaler",
            "params": dict(n_stages=1, multiplier=0.5, in_channels=3,
                           out_channels=2)}
    cfg = _keyed("concat", cond)
    cfg["params"]["unet_config"]["params"]["in_channels"] = 5
    port = instantiate_from_config(cfg, device="cpu", seed=4)
    x = torch.from_numpy(_np(10, SHAPE))
    ctx = port.get_learned_conditioning(_np(11, (2, 32, 32, 3)))
    assert ctx.shape == (2, 16, 16, 2)
    t = torch.tensor([4, 30])
    with torch.no_grad():
        got = port.apply_model(x, t, ctx, 0)
        want = port.model(x.permute(0, 3, 1, 2), t,
                          c_concat=[ctx.permute(0, 3, 1, 2)])
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=0)


@pytest.mark.parametrize("key,fault", [("adm", "indices must have an "
                                        "integer type"),
                                       ("hybrid", "c_concat alone")])
def test_jax_faults_are_refused_through_frido_diffusion(key, fault):
    cond = {"target": "frido.modules.encoders.modules.ClassEmbedder",
            "params": dict(embed_dim=64, n_classes=10)}
    with pytest.raises(ValueError, match=fault):
        instantiate_from_config(_keyed(key, cond), device="cpu")


def test_image_logs_without_a_first_stage(models, monkeypatch):
    """``log_images`` and its galleries on the pixel-space model: the
    reconstruction is the input (identity encode and decode), samples and
    rows are images of the model's size."""
    _, _, port = models
    monkeypatch.setattr(port, "extra", dict(
        plot_diffusion_rows=True, plot_denoise_rows=True))
    image = np.tanh(_np(12, SHAPE))
    log = port.log_images({"image": image}, torch.Generator().manual_seed(1),
                          n=2, ddim_steps=4, ddim_eta=0.0)
    assert {"inputs", "reconstruction", "samples", "diffusion_row",
            "denoise_row"} <= set(log)
    np.testing.assert_array_equal(log["reconstruction"], log["inputs"])
    assert log["samples"].shape == SHAPE
    assert np.isfinite(log["samples"]).all()
    # one stage: 4 noised snapshots (every 10 of 40 timesteps) a row
    assert log["diffusion_row"].shape[0] == 2
    assert log["denoise_row"].shape[0] == 2
