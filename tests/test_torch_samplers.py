"""The port's DDIM, DPM-Solver++(2M) and vanilla samplers (and PLMS) against
the JAX package's, on the CPU.

Two eps models:

- the toy t2i FridoDiffusion of ``tests/test_torch_models.py`` (its config
  and its seeded weight recipe, one module-scoped model in each package),
  driven through ``FridoDiffusion.sample`` in both packages;
- a closed-form eps, the same formula in JAX and torch, driven through
  ``samplers.sample`` in both, for what ``FridoDiffusion.sample`` does not
  expose (``keep_intermediates``, ``temperature``, ``discretize``): it
  compiles in a fraction of a second, so every sampler gets each case.

torch and JAX draw different random numbers, so the port's noise function
(``samplers._noise``) is fed the JAX package's own draws: the test replays
``jax.random.split`` as ``frido_tpu/diffusion/samplers.py::sample`` does
(the initial key, then one key per sampled stage) and draws the stage
noise as ``_scan_inputs`` and the vanilla chain do, in the order the port
asks for it.

Tolerance, fixed before the comparison: 1e-3 absolute on latents and
intermediates, as ``tests/test_torch_models.py`` fixes for chained UNet
calls. Step counts divide the toy schedule of 40 timesteps (4 and 20: the
uniform stride 40 // S must give S steps; S = 16 would run the same 20
steps as S = 20, so DPM-Solver++'s second-order final step is tested at
20).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.diffusion import samplers as jax_samplers
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.diffusion import samplers
from frido_tpu_torch.io.jax_weights import load_jax_params
from frido_tpu_torch.schedules import DDIMSchedule, DiffusionSchedule
from tests.test_torch_models import CONFIG, CTX_LEN, _random_params

torch.set_num_threads(2)

ATOL = 1e-3
SHAPE = (2, 16, 16, 8)      # the toy latent: two stages of 4 channels
T = CONFIG["params"]["timesteps"]


@pytest.fixture(scope="module")
def models():
    jmodel = jax_instantiate(CONFIG)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    port = instantiate_from_config(CONFIG, device="cpu")
    load_jax_params(port, np_params)
    return jmodel, jparams, port


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jax_draws(seed, shape, windows, kind, steps, eta, temperature=1.0,
               discretize="uniform", skip_stage0=False):
    """The random arrays JAX's ``sample`` draws from ``PRNGKey(seed)``, in
    the order the port's ``_noise`` is called: the initial latent (unless
    a finished stage 0 is adopted), then each sampled stage's noise."""
    rng, init_key = jax.random.split(jax.random.PRNGKey(seed))
    draws = [] if skip_stage0 else [jax.random.normal(init_key, shape)]
    for s, (start, end) in enumerate(windows):
        if skip_stage0 and s == 0:
            continue
        rng, key = jax.random.split(rng)
        w = shape[:-1] + (end - start,)
        if kind == "vanilla":
            draws.append(jax.random.normal(key, (T,) + w) * temperature)
        elif kind == "ddim" and eta != 0.0:
            dd = DDIMSchedule.create(_schedule(), steps, eta=eta,
                                     discretize=discretize)
            draws.append(jax.random.normal(key, (dd.num_steps,) + w)
                         * temperature)
    return [np.asarray(d) for d in draws]


def _feed(monkeypatch, draws):
    """Replace the port's noise function with the given draws, in order;
    every draw must be asked for with its own shape."""
    queue = list(draws)

    def fake(generator, shape, temperature, device):
        want = queue.pop(0)
        assert tuple(shape) == want.shape
        return torch.from_numpy(want.copy()).to(device)

    monkeypatch.setattr(samplers, "_noise", fake)
    return queue


def _schedule():
    p = CONFIG["params"]
    return DiffusionSchedule.create(timesteps=T,
                                    linear_start=p["linear_start"],
                                    linear_end=p["linear_end"])


WINDOWS = [(0, 4), (4, 8)]

# (sampler, steps, eta, guidance, cfg_mode, x_T given); both CFG modes on
# DDIM
CASES = {
    "ddim-eta0-cfg-batched": ("ddim", 4, 0.0, 1.5, "batched", False),
    "ddim-eta1-cfg-sequential": ("ddim", 4, 1.0, 1.5, "sequential", False),
    "dpmpp-S4-lower-order-final": ("dpmpp", 4, 0.0, 1.0, "batched", False),
    "dpmpp-S20-second-order-final": ("dpmpp", 20, 0.0, 1.0, "batched",
                                     False),
    "vanilla-T40": ("vanilla", 4, 1.0, 1.0, "batched", False),
    "ddim-eta1-x_T": ("ddim", 4, 1.0, 1.0, "batched", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_frido_sample_matches_jax(models, monkeypatch, case):
    """``FridoDiffusion.sample`` in both packages, from the same key's
    draws; with ``x_T`` the given stage 0 is kept and only stage 1 runs."""
    kind, steps, eta, gs, cfg_mode, with_x_T = CASES[case]
    jmodel, jparams, port = models
    ctx, uctx = _np(1, (2, CTX_LEN, 32)), _np(2, (2, CTX_LEN, 32))
    x_T = _np(3, SHAPE) if with_x_T else None

    def run(p, c, u, k, xt):
        return jmodel.sample(p, k, 2, context=c, uncond_context=u,
                             steps=steps, eta=eta, guidance_scale=gs,
                             sampler=kind, x_T=xt, cfg_mode=cfg_mode)

    want = np.asarray(jax.jit(run)(
        jparams, jnp.asarray(ctx), jnp.asarray(uctx), jax.random.PRNGKey(5),
        None if x_T is None else jnp.asarray(x_T)))
    left = _feed(monkeypatch, _jax_draws(5, SHAPE, WINDOWS, kind, steps, eta,
                                         skip_stage0=with_x_T))
    got = port.sample(2, context=torch.from_numpy(ctx),
                      uncond_context=torch.from_numpy(uctx), steps=steps,
                      eta=eta, guidance_scale=gs, sampler=kind,
                      x_T=None if x_T is None else torch.from_numpy(x_T),
                      cfg_mode=cfg_mode)
    assert not left                       # every JAX draw was asked for
    assert got.shape == SHAPE
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if with_x_T:
        np.testing.assert_array_equal(got.numpy()[..., :4], x_T[..., :4])


@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_nonzero_eta_is_refused(models, sampler):
    jmodel, jparams, port = models
    with pytest.raises(ValueError, match="must be 0"):
        jmodel.sample(jparams, jax.random.PRNGKey(0), 2, steps=4, eta=0.5,
                      sampler=sampler)
    with pytest.raises(ValueError, match="must be 0"):
        port.sample(2, steps=4, eta=0.5, sampler=sampler)
    with pytest.raises(ValueError, match="must be 0"):
        port.sample(2, steps=4, sampler=sampler)   # eta defaults to 1.0


def test_sample_signature_is_the_jax_methods():
    """The JAX method's arguments after (params, rng), in order and with
    its defaults, then the port's generator."""
    import inspect

    from frido_tpu.models.frido import FridoDiffusion as JaxFrido
    from frido_tpu_torch.models.frido import FridoDiffusion
    want = inspect.signature(JaxFrido.sample).parameters
    got = inspect.signature(FridoDiffusion.sample).parameters
    jax_names = [n for n in want if n not in ("self", "params", "rng")]
    assert [n for n in got if n != "self"] == jax_names + ["generator"]
    for n in jax_names:
        assert got[n].default == want[n].default, n


# ---------------------------------------------------------------------------
# samplers.sample with a closed-form eps


def _eps_jax(x, t, ctx, stage, aux=None):
    start, end = WINDOWS[stage]
    w = x[..., start:end]
    rest = jnp.mean(x, axis=-1, keepdims=True)
    tt = t.astype(jnp.float32)[:, None, None, None] / T
    return jnp.tanh(0.8 * w + 0.3 * rest + tt - 0.2 * stage)


def _eps_torch(x, t, ctx, stage, aux=None):
    start, end = WINDOWS[stage]
    w = x[..., start:end]
    rest = x.mean(dim=-1, keepdim=True)
    tt = t.float()[:, None, None, None] / T
    return torch.tanh(0.8 * w + 0.3 * rest + tt - 0.2 * stage)


def _configs(kind, steps, eta, **kw):
    common = dict(num_steps=steps, eta=eta, embed_dim_list=(4, 4),
                  num_stage=2, kind=kind, **kw)
    return (jax_samplers.SamplerConfig(schedule=_schedule(), **common),
            samplers.SamplerConfig(schedule=_schedule(), **common))


# (sampler, steps, eta): every sampler, eta > 0 where it is allowed
# (quad at 8 steps repeats timestep 1 in the toy schedule; 4 does not)
KINDS = [("plms", 4, 0.0), ("ddim", 4, 1.0), ("dpmpp", 4, 0.0),
         ("vanilla", 4, 1.0)]


@pytest.mark.parametrize("kind,steps,eta", KINDS, ids=[k[0] for k in KINDS])
def test_keep_intermediates_temperature_and_quad(monkeypatch, kind, steps,
                                                 eta):
    """``keep_intermediates`` returns one stacked tensor per stage (PLMS:
    steps 1..S-1; DDIM and DPM++: every step; vanilla: the T x0
    composites), equal to JAX's; with ``temperature`` 0.7 and the ``quad``
    timesteps."""
    jcfg, pcfg = _configs(kind, steps, eta, temperature=0.7,
                          discretize="quad", keep_intermediates=True)
    x_init = _np(9, SHAPE)
    jx, jinter = jax.jit(lambda k, x: jax_samplers.sample(
        jcfg, _eps_jax, k, SHAPE, x_init=x))(jax.random.PRNGKey(3),
                                              jnp.asarray(x_init))
    draws = _jax_draws(3, SHAPE, WINDOWS, kind, steps, eta, 0.7, "quad")
    left = _feed(monkeypatch, draws[1:])    # x_init replaces the first
    px, pinter = samplers.sample(pcfg, _eps_torch, SHAPE,
                                 x_init=torch.from_numpy(x_init))
    assert not left
    per_stage = {"plms": steps - 1, "ddim": steps, "dpmpp": steps,
                 "vanilla": T}[kind]
    assert [tuple(i.shape) for i in pinter] == [(per_stage,) + SHAPE] * 2
    assert [tuple(i.shape) for i in pinter] == [i.shape for i in jinter]
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    for p, j in zip(pinter, jinter):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)
    # the last kept frame of the last stage is the latent before smoothing
    if kind != "vanilla":
        np.testing.assert_array_equal(pinter[-1][-1].numpy(), px.numpy())


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_stage_noise_scales_with_temperature(monkeypatch, temperature):
    """The port's own draws: DDIM eta = 1 asks for one [S, *window] draw a
    stage, scaled by ``temperature``; eta = 0 draws nothing."""
    seen = []
    real = samplers._noise

    def spy(generator, shape, temp, device):
        seen.append((tuple(shape), temp))
        return real(generator, shape, temp, device)

    monkeypatch.setattr(samplers, "_noise", spy)
    _, pcfg = _configs("ddim", 4, 1.0, temperature=temperature)
    gen = torch.Generator().manual_seed(0)
    samplers.sample(pcfg, _eps_torch, SHAPE, generator=gen)
    w = SHAPE[:-1] + (4,)
    assert seen == [(SHAPE, 1.0), ((4,) + w, temperature),
                    ((4,) + w, temperature)]
    a = real(torch.Generator().manual_seed(1), (1000,), temperature, "cpu")
    b = real(torch.Generator().manual_seed(1), (1000,), 1.0, "cpu")
    torch.testing.assert_close(a, b * temperature, rtol=0, atol=0)
    seen.clear()
    _, pcfg = _configs("ddim", 4, 0.0, temperature=temperature)
    samplers.sample(pcfg, _eps_torch, SHAPE, generator=gen)
    assert seen == [(SHAPE, 1.0)]


def test_x_T_and_x_init_are_exclusive():
    _, pcfg = _configs("ddim", 4, 0.0)
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="not both"):
        samplers.sample(pcfg, _eps_torch, SHAPE, x_T=x, x_init=x)
