"""The port's diffusion training against the JAX package, on the CPU.

The toy t2i model of ``tests/test_torch_models.py`` (its config and seeded
weight recipe, the zero-initialised output convs random too, so no
gradient is trivially 0), here with the training settings of the t2i
config: the l1 loss, ``noise_mix_ratio`` 0.1, and ``learn_logvar`` (a
random logvar), so the per-timestep logvar trains. One JAX model, one
port model and ONE jitted JAX train step (``make_train_step``, fp32) per
module: the step takes a ``TrainState`` at step 3, whose Adam moments,
EMA and counters are seeded and non-trivial (bias correction at count 3,
the EMA ramp at 3 updates, a warm-up-cosine schedule past its warm-up),
carried across to the port by ``io/jax_weights.jax_train_state_to_port``.
Its optimizer is wrapped in a transformation that records the raw
gradients in its state, so the one compiled step also gives
``jax.grad``'s gradients. The port's draw function (``trainer._draw``) is
fed the JAX step's own draws of t and the noise. The JAX eval loss on the
weights and on the EMA weights comes from the same compiled step, run on
those weights (``make_eval_step`` computes the same ``training_loss`` on an
fp32 encode). A second jitted JAX function gives the value and gradient
of the same step's loss (the conditioning and ``training_loss``,
``trainer.py``'s ``loss_fn``) with the UNet under
``compute_dtype=bfloat16``, against the port's on the same tokens, t and
noise and the port's fp32 latent of the batch (the step holds it to
JAX's). Both compile on other threads while the port's side of the tests
runs. The l1 and l2 loss math is held apart, with both
packages' UNet replaced by the same fixed outputs.

Tolerances, fixed before the comparison:

- ``q_sample_stage``: 1e-6 absolute (elementwise fp32);
- the loss math on fixed UNet outputs: 1e-6 relative, 1e-7 absolute (fp32
  means in another order);
- losses and their logs: 3e-4 absolute, the golden tolerance of one UNet
  call (``tests/test_torch_models.py``), which bounds a mean of per-element
  differences;
- gradients, per leaf: 1e-3 of the leaf's largest JAX magnitude (fp32 sums
  over two UNets, BERT and the loss in another order), that magnitude
  floored at 1e-3 of the largest over all leaves (so no leaf is held
  tighter than 1e-6 of it): a leaf whose exact gradient is 0 (a ResBlock's
  time-embedding bias before a GroupNorm of one channel per group, which
  removes it) carries only rounding noise in both packages;
- the optimizer fed the JAX gradients: new weights within 1e-6 relative
  and 1e-8 absolute (fp32 rounding of the same formula);
- the port's own step: each weight within 2 * lr_t of the JAX one (an
  element whose gradient is at the two packages' rounding level can move
  by up to lr_t either way, so the weights carry no signal of the
  gradient: the moments and the optimizer fed the JAX gradients do),
  moments within (1 - b1) and (1 - b2) times the gradient tolerance, the
  EMA within (1 - d) of that weight bound;
- ``init_scale_by_std``: 1e-5 relative (the std of fp32 latents);
- bf16, stated apart: the loss and its logs within 2e-2 relative (both
  packages round every activation to bf16, 2^-9 relative each, through
  BERT and two UNets in another order); each gradient leaf within 3
  times JAX's own bf16 noise of JAX's bf16 gradient, plus 2^-8 (one bf16
  rounding) of the leaf's largest fp32 gradient, plus 1e-6 of the largest
  fp32 gradient over all leaves. JAX's noise is the distance of its bf16
  gradient to its fp32 one (``jax.grad`` of the same loss, from the
  step). Many leaves' bf16 gradients are 5-15% away from fp32 (biases
  feeding a GroupNorm, whose exact gradient nearly cancels), so no fixed
  fraction of the leaf's magnitude holds them; the port's rounding, as
  large as JAX's, puts the two bf16 gradients about sqrt(2) noise widths
  apart, and at most 2 if both roundings lie on opposite sides. One
  realisation of JAX's noise underestimates its width on a leaf that
  averages it away (logvar's gradient is a mean over the whole latent:
  on the CPU 5e-4 from fp32 in JAX and 2e-3 in the port), hence the 2^-8
  term. The tolerance does not depend on the port's result, so a wrong
  gradient cannot widen it;
- AdamW against optax on identical gradients: 1e-6 relative and 1e-8
  absolute, and lr * 2^-7 with the bf16 first moment (one bf16 rounding of
  the moment may land the other way); the learning rate schedules against
  ``_JaxLambdaLR``: 1e-6 relative; the EMA against ``update_ema``: 1e-6
  relative, 1e-7 absolute.
"""

import concurrent.futures
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.training import optim as jax_optim
from frido_tpu.training import trainer as jax_trainer
from frido_tpu.training.ema import init_ema, update_ema
from frido_tpu_torch.config import instantiate_from_config
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            jax_train_state_to_port,
                                            load_jax_params)
from frido_tpu_torch.training import ema as port_ema
from frido_tpu_torch.training import optim, trainer
from tests.test_torch_models import CONFIG, CTX_LEN, _random_params

torch.set_num_threads(2)

TRAIN = dict(loss_type="l1", noise_mix_ratio=0.1, learn_logvar=True)
LR = 1e-3
SCHEDULE = dict(warm_up_steps=2, lr_min=0.1, lr_max=1.0, lr_start=0.5,
                max_decay_steps=10)
START = 3           # the carried-across state's step, count and EMA count
B1, B2 = 0.9, 0.999
LOSS_ATOL = 3e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-3
BF16_LOSS_RTOL = 2e-2
BF16_NOISE_FACTOR = 3.0
BF16_GRAD_RTOL = 2.0 ** -8
BF16_GRAD_FLOOR = 1e-6


def _config(**extra):
    cfg = copy.deepcopy(CONFIG)
    cfg["params"].update(TRAIN, **extra)
    return cfg


def _recording(inner):
    """``inner`` whose state also holds the gradients it was last given."""
    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)

    return optax.GradientTransformation(init, update)


def _seeded_state(rec, np_params, rng):
    """A ``TrainState`` at step START for the optimizer ``rec``, made in
    numpy (no eager JAX op to compile): counts START, seeded moments with
    sqrt(nu) >= |mu|, zero recorded gradients, an EMA a small seeded step
    away from the weights."""
    def leaf(path, x):
        names = [getattr(p, "name", None) for p in path]
        if x.dtype == jnp.int32 and len(x.shape) == 0:
            return jnp.asarray(START, jnp.int32)
        mu = 1e-3 * rng.standard_normal(x.shape)
        if "nu" in names:
            mu = mu ** 2 + 1e-6 * rng.uniform(0.5, 1.5, x.shape)
        elif "mu" not in names:
            mu = np.zeros(x.shape)
        return jnp.asarray(mu.astype(x.dtype))

    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(rec.init, params))
    ema = jax.tree_util.tree_map(
        lambda p: jnp.asarray(p + 1e-3 * rng.standard_normal(p.shape)
                              .astype(np.float32)),
        np_params["params"]["model"])
    return jax_trainer.TrainState(
        params=params, opt_state=opt, ema_params=ema,
        ema_updates=jnp.asarray(START, jnp.int32),
        step=jnp.asarray(START, jnp.int32))


def _batch():
    rng = np.random.default_rng(11)
    return {"image": np.tanh(rng.standard_normal((2, 32, 32, 3))
                             ).astype(np.float32),
            "tokens": rng.integers(0, 100, (2, CTX_LEN)).astype(np.int32)}


def _jax_draws(jmodel, step, rng, b):
    """t and the noise as ``make_train_step`` draws them."""
    t_key, n_key = jax.random.split(jax.random.fold_in(rng, step))
    t = jax.random.randint(t_key, (b,), 0, jmodel.timesteps)
    noise = jax.random.normal(n_key, (b, jmodel.image_size,
                                      jmodel.image_size, jmodel.channels))
    return t, noise


def _feed(monkeypatch, draws):
    def fake(generator, batch, timesteps, noise_shape, device):
        t, noise = draws
        assert t.shape == (batch,) and noise.shape == tuple(noise_shape)
        return (torch.from_numpy(t.astype(np.int64)).to(device),
                torch.from_numpy(noise.copy()).to(device))

    monkeypatch.setattr(trainer, "_draw", fake)


def _sd(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(tree).items()}


@pytest.fixture(scope="module")
def run():
    """The JAX model, its carried-across state, the batch and the draws;
    ``run["jax"]()`` gives the JAX step's results (from step START, and
    its loss on the EMA weights); ``run["bf16"](z)`` the step's loss in
    bf16 at the latent z, with its gradients."""
    jmodel = jax_instantiate(_config())
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    sched = jax_optim.LambdaWarmUpCosineScheduler(**SCHEDULE)
    tx = jax_optim.build_optimizer(LR, sched)
    rec = _recording(jax_trainer.build_masked_optimizer(tx, np_params))
    state = _seeded_state(rec, np_params, np.random.default_rng(5))
    batch = _batch()
    rng = jax.random.PRNGKey(4)
    draws = jax.jit(lambda r: _jax_draws(jmodel, START, r, 2))(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ema_state = state.replace(params=jax_trainer.ema_full_params(state))

    def bf16_loss(params, z, tokens, t, noise):
        """``make_train_step``'s loss with its UNet under
        ``compute_dtype=bfloat16``."""
        ctx = jmodel.module.apply(params, tokens, method="encode_cond")
        return jmodel.training_loss(params, z, ctx, t, noise,
                                    compute_dtype=jnp.bfloat16)

    step = jax.jit(jax_trainer.make_train_step(jmodel, rec)).lower(
        state, jbatch, rng)
    z = jax.ShapeDtypeStruct(draws[1].shape, jnp.float32)
    grad = jax.jit(jax.value_and_grad(bf16_loss, has_aux=True)).lower(
        state.params, z, jbatch["tokens"], *draws)
    # XLA compiles both on other threads while the port's side runs
    # (tracing holds the interpreter, so it stays on this one)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    step, grad = pool.submit(step.compile), pool.submit(grad.compile)

    def results():
        new_state, logs = step.result()(state, jbatch, rng)
        _, ema_logs = step.result()(ema_state, jbatch, rng)
        return dict(new_state=new_state, logs=logs, ema_logs=ema_logs)

    def bf16(z):
        """The bf16 loss, its logs and its gradients at the latent z."""
        return grad.result()(state.params, jnp.asarray(z), jbatch["tokens"],
                             *draws)

    yield dict(jmodel=jmodel, np_params=np_params, state=state,
               batch=batch, draws=tuple(np.asarray(d) for d in draws),
               jax=functools.cache(results), bf16=bf16)
    pool.shutdown()


@pytest.fixture(scope="module")
def port_step(run):
    """The port's step from the carried-across state, on the JAX draws:
    (trainer after it, logs, the gradients it took, the weights before)."""
    with pytest.MonkeyPatch.context() as mp:
        _feed(mp, run["draws"])
        tr = _carried(run)
        grads = _recorded_grads(tr)
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        logs = tr.train_step(run["batch"])
    return tr, logs, grads, before


def _port_model(np_params, **extra):
    model = instantiate_from_config(_config(**extra), device="cpu")
    load_jax_params(model, np_params)
    return model


def _port_trainer(model, sched=None, **kw):
    params = [p for _, p in trainer.trainable_parameters(model)]
    opt = optim.build_optimizer(params, LR, sched)
    return trainer.DiffusionTrainer(model, opt, **kw)


def _carried(run, **kw):
    model = _port_model(run["np_params"])
    tr = _port_trainer(model, optim.LambdaWarmUpCosineScheduler(**SCHEDULE),
                       **kw)
    tr.load_state(jax_train_state_to_port(run["state"]))
    return tr


def _recorded_grads(tr):
    """Wrap the trainer's optimizer call to keep the gradients it gets."""
    grads = {}
    names = {id(p): n for n, p in tr.model.named_parameters()}
    real = tr.optimizer.step

    def step():
        for group in tr.optimizer.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.detach().clone()
        return real()

    tr.optimizer.step = step
    return grads


def _check_grads(got, want, rtol):
    """Per leaf within ``rtol`` of its largest JAX magnitude, floored at
    GRAD_FLOOR of the largest over all leaves; returns each leaf's
    tolerance."""
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    tols = {}
    for k, w in want.items():
        tols[k] = rtol * max(np.abs(w).max(), floor)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= tols[k], (k, err, tols[k])
    return tols


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", [0, 1])
def test_q_sample_stage_matches_jax(run, stage):
    jmodel = run["jmodel"]
    port = _port_model(run["np_params"])
    rng = np.random.default_rng(stage)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    t = np.asarray([0, 37])
    want = np.asarray(jmodel.q_sample_stage(jnp.asarray(x), jnp.asarray(t),
                                            stage, jnp.asarray(noise)))
    got = port.q_sample_stage(torch.from_numpy(x), torch.from_numpy(t),
                              stage, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # below the window clean (with the 0.1 leak), above it pure noise
    start, end = 4 * stage, 4 * stage + 4
    np.testing.assert_allclose(got[..., :start], 0.9 * x[..., :start]
                               + 0.1 * noise[..., :start], atol=1e-6)
    np.testing.assert_array_equal(got[..., end:], noise[..., end:])


def test_init_scale_by_std_matches_jax(run):
    """1/std per stage of one batch's latents: the population std."""
    jmodel = copy.copy(run["jmodel"])
    jmodel.scale_by_std = True
    module = jmodel.module
    # the JAX model's encode jitted once: a stand-in for its flax module
    apply = jax.jit(module.apply, static_argnames=("method",))
    jmodel.module = type("Jitted", (), {"apply": staticmethod(apply)})()
    jparams = jax.tree_util.tree_map(jnp.asarray, run["np_params"])
    images = run["batch"]["image"]
    want = jmodel.init_scale_by_std(jparams, images)
    port = _port_model(run["np_params"], scale_by_std=True)
    got = port.init_scale_by_std(torch.from_numpy(images))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_array_equal(port.scale_factors, got)
    z = port.first_stage_model.encode_interface(torch.from_numpy(images))
    ddof1 = 1.0 / z[..., :4].std().item()
    assert abs(got[0] - ddof1) > 1e-4 * ddof1   # not torch's default ddof


def test_logvar_is_trained_only_with_learn_logvar(run):
    model = _port_model(run["np_params"])
    assert isinstance(model.logvar, torch.nn.Parameter)
    assert "logvar" in dict(trainer.trainable_parameters(model))
    plain = instantiate_from_config(_config(learn_logvar=False,
                                            logvar_init=0.5), device="cpu")
    assert not isinstance(plain.logvar, torch.nn.Parameter)
    assert "logvar" not in plain.state_dict()
    assert torch.equal(plain.logvar, torch.full((40,), 0.5))


def test_training_fields_default_as_in_jax():
    cfg = copy.deepcopy(CONFIG)
    port = instantiate_from_config(cfg, device="cpu")
    jmodel = jax_instantiate(cfg)
    for k in ("loss_type", "original_elbo_weight", "l_simple_weight",
              "noise_mix_ratio", "stage_loss_ratio", "scale_by_std",
              "cond_stage_trainable", "num_timesteps_cond", "use_ema",
              "learn_logvar", "logvar_init"):
        assert getattr(port, k) == getattr(jmodel, k), k
        assert k not in port.extra


def test_train_keeps_the_first_stage_in_eval_mode(run):
    model = _port_model(run["np_params"])
    model.train()
    assert model.training and model.model.training
    assert model.cond_stage_model.training
    assert not any(m.training for m in model.first_stage_model.modules())
    model.eval()
    assert not any(m.training for m in model.modules())


def test_conditioning_keeps_its_gradient(run):
    model = _port_model(run["np_params"])
    ctx = model.get_learned_conditioning(run["batch"]["tokens"])
    assert ctx.requires_grad
    ctx.square().mean().backward()
    assert all(p.grad is not None
               for p in model.cond_stage_model.parameters())


def test_unet_dropout_is_refused_in_training():
    cfg = copy.deepcopy(CONFIG)
    cfg["params"]["unet_config"]["params"]["dropout"] = 0.1
    model = instantiate_from_config(cfg, device="cpu")
    x = torch.zeros(1, 16, 16, 8)
    t = torch.zeros(1, dtype=torch.long)
    ctx = torch.zeros(1, CTX_LEN, 32)
    model.apply_model(x, t, ctx, 0)        # eval: dropout is the identity
    model.train()
    with pytest.raises(NotImplementedError, match="dropout"):
        model.apply_model(x, t, ctx, 0)


# AdamW, the schedules and the EMA alone, on identical inputs
def _tree(rng):
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


def _run_both(tx, port_opt_kw, calls):
    """optax ``tx`` and the port's ``build_optimizer(**port_opt_kw)`` over
    ``calls`` calls on the same seeded gradients: the initial weights, both
    packages' weights after each call, and the port's optimizer."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optim.build_optimizer(list(tp.values()), **port_opt_kw)

    @jax.jit
    def jax_call(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    out = []
    for _ in range(calls):
        g = _tree(rng)
        jp, js = jax_call(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: p.detach().numpy().copy() for k, p in tp.items()}))
    return p0, out, opt


SCHEDULERS = {
    "constant": None,
    "warmup-cosine": lambda m: m.LambdaWarmUpCosineScheduler(
        warm_up_steps=2, lr_min=0.1, lr_max=1.0, lr_start=0.3,
        max_decay_steps=5),
    "linear-cycle": lambda m: m.LambdaLinearScheduler(
        warm_up_steps=[1], f_min=[0.2], f_max=[1.0], f_start=[0.1],
        cycle_lengths=[4]),
}


@pytest.mark.parametrize("variant,sched", [
    ("fp32", "constant"), ("fp32", "warmup-cosine"), ("fp32", "linear-cycle"),
    ("mu-bf16", "warmup-cosine"), ("multisteps-k2", "linear-cycle")])
def test_adamw_matches_optax(variant, sched):
    """Three updates on identical gradients: Adam, the decoupled weight
    decay, the schedule at the update count, MultiSteps (k = 2: six calls,
    the weights move on every second), the bf16 first moment."""
    make = SCHEDULERS[sched]
    lr = 1e-2
    kw = dict(mu_dtype=None, accumulate_grad_batches=1)
    if variant == "mu-bf16":
        kw["mu_dtype"] = "bf16"
    if variant == "multisteps-k2":
        kw["accumulate_grad_batches"] = 2
    tx = jax_optim.build_optimizer(
        lr, make(jax_optim) if make else None,
        accumulate_grad_batches=kw["accumulate_grad_batches"],
        mu_dtype=jnp.bfloat16 if kw["mu_dtype"] else None)
    port_kw = dict(learning_rate=lr,
                   scheduler=make(optim) if make else None,
                   accumulate_grad_batches=kw["accumulate_grad_batches"],
                   mu_dtype=torch.bfloat16 if kw["mu_dtype"] else None)
    k = kw["accumulate_grad_batches"]
    atol = lr * 2.0 ** -7 if kw["mu_dtype"] else 1e-8
    prev, out, opt = _run_both(tx, port_kw, 3 * k)
    for i, (want, got) in enumerate(out):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       atol=atol, err_msg=f"{name} {i}")
        moved = any(not np.array_equal(got[n], prev[n]) for n in got)
        assert moved == ((i + 1) % k == 0)
        prev = got
    assert opt.count == 3 and opt.mini_step == 0
    if kw["mu_dtype"]:
        assert all(st["mu"].dtype == torch.bfloat16
                   for st in opt.state.values())


@pytest.mark.parametrize("sched", ["warmup-cosine", "linear-cycle"])
def test_schedules_match_jax_lambda_lr(sched):
    base = 4.5e-6
    jfn = jax_optim._JaxLambdaLR(base, SCHEDULERS[sched](jax_optim))
    params = [torch.nn.Parameter(torch.zeros(1))]
    opt = optim.build_optimizer(params, base, SCHEDULERS[sched](optim))
    for n in range(12):
        np.testing.assert_allclose(opt.learning_rate(n),
                                   float(jfn(jnp.asarray(n, jnp.int32))),
                                   rtol=1e-6)
    assert optim.scaled_learning_rate(1e-6, 32, 1) == \
        jax_optim.scaled_learning_rate(1e-6, 32, 1)


def test_ema_ramp_and_update_match_jax():
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    shadow, n = init_ema(jax.tree_util.tree_map(jnp.asarray, p))
    lin = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p["w"]))
    ema = port_ema.EMA(lin)
    assert ema.shadow["weight"].data_ptr() != lin.weight.data_ptr()
    for _ in range(3):
        new = rng.standard_normal((4, 3)).astype(np.float32)
        shadow, n = update_ema(shadow, {"w": jnp.asarray(new)}, n)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(new))
        ema.update()
        np.testing.assert_allclose(ema.shadow["weight"].numpy(),
                                   np.asarray(shadow["w"]), rtol=1e-6,
                                   atol=1e-7)
    assert ema.num_updates == int(n) == 3
    with ema.scope() as m:
        np.testing.assert_array_equal(m.weight.detach().numpy(),
                                      ema.shadow["weight"].numpy())
    np.testing.assert_array_equal(lin.weight.detach().numpy(), new)


# the JAX step's results
def test_train_step_matches_jax(run, port_step):
    """One whole step from the carried-across state: loss and logs, every
    trainable gradient, the frozen first stage, the updated weights, the
    moments and counts, the EMA."""
    tr, logs, grads, before = port_step
    jlogs = run["jax"]()["logs"]
    assert set(logs) == set(jlogs) == {
        "loss", "loss_simple_stage0", "loss_vlb_stage0",
        "loss_simple_stage1", "loss_vlb_stage1"}
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   atol=LOSS_ATOL, rtol=0, err_msg=k)

    new = run["jax"]()["new_state"]
    jgrads = _sd(new.opt_state[0])
    frozen = [k for k in jgrads if k.startswith("first_stage_model.")]
    assert frozen and all(not jgrads[k].any() for k in frozen)
    tols = _check_grads(grads, {k: v for k, v in jgrads.items()
                                if k not in frozen}, GRAD_RTOL)
    assert grads["logvar"].abs().max() > 0     # the drawn timesteps' entries

    after = tr.model.state_dict()
    for k in frozen:
        assert torch.equal(after[k], before[k])
        assert not dict(tr.model.named_parameters())[k].requires_grad
    assert tr.model.first_stage_model.training is False

    lr_t = tr.optimizer.learning_rate(START)
    jnew = _sd(new.params)
    for k in grads:
        err = np.abs(after[k].numpy() - jnew[k]).max()
        assert err <= 2 * lr_t, (k, err)

    carried = jax_train_state_to_port(new)
    adam = carried["adam"]
    assert (tr.optimizer.count, tr.ema.num_updates, tr.step) == (
        adam["count"], carried["ema_updates"], carried["step"]) == (
        START + 1, START + 1, START + 1)
    names = {id(p): n for n, p in tr.model.named_parameters()}
    for p, st in tr.optimizer.state.items():
        k = names[id(p)]
        tol_g = tols[k]
        mu_err = np.abs(st["mu"].numpy() - adam["mu"][k]).max()
        nu_err = np.abs(st["nu"].numpy() - adam["nu"][k]).max()
        assert mu_err <= (1 - B1) * tol_g + 1e-9, (k, mu_err)
        assert nu_err <= (1 - B2) * (2 * np.abs(jgrads[k]).max() * tol_g
                                     + tol_g ** 2) + 1e-12, (k, nu_err)
    d = min(0.9999, (1 + START + 1) / (10 + START + 1))
    for k, s in tr.ema.shadow.items():
        err = np.abs(s.numpy() - carried["ema"][k]).max()
        assert err <= (1 - d) * 2 * lr_t + 1e-7, (k, err)


def test_optimizer_fed_jax_grads_gives_jax_weights(run):
    """The port's AdamW and EMA on the JAX step's own gradients give the
    JAX step's weights, moments and EMA."""
    tr = _carried(run)
    new = run["jax"]()["new_state"]
    jgrads = _sd(new.opt_state[0])
    for name, p in trainer.trainable_parameters(tr.model):
        p.grad = torch.from_numpy(jgrads[name].copy())
    tr.optimizer.step()
    tr.ema.update()
    carried = jax_train_state_to_port(new)
    after = tr.model.state_dict()
    for k, w in carried["params"].items():
        np.testing.assert_allclose(after[k].numpy(), w, rtol=1e-6,
                                   atol=1e-8, err_msg=k)
    for k, s in tr.ema.shadow.items():
        np.testing.assert_allclose(s.numpy(), carried["ema"][k], rtol=1e-6,
                                   atol=1e-8, err_msg=k)
    names = {id(p): n for n, p in tr.model.named_parameters()}
    for p, st in tr.optimizer.state.items():
        k = names[id(p)]
        np.testing.assert_allclose(st["mu"].numpy(), carried["adam"]["mu"][k],
                                   rtol=1e-6, atol=1e-10, err_msg=k)
        np.testing.assert_allclose(st["nu"].numpy(), carried["adam"]["nu"][k],
                                   rtol=1e-6, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("ema", [False, True])
def test_eval_step_matches_jax(run, monkeypatch, ema):
    """The eval loss on the weights and on the EMA weights of the carried
    state, from the same draws."""
    _feed(monkeypatch, run["draws"])
    tr = _carried(run)
    w = {k: v.clone() for k, v in tr.model.state_dict().items()}
    got = float(tr.eval_step(run["batch"], ema=ema))
    want = float(run["jax"]()["ema_logs" if ema else "logs"]["loss"])
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    # the EMA scope gives the weights back
    assert all(torch.equal(v, w[k]) for k, v in tr.model.state_dict().items())


def test_remat_gives_the_same_gradients(run, port_step, monkeypatch):
    _feed(monkeypatch, run["draws"])
    tr = _carried(run, remat=True)
    g1 = _recorded_grads(tr)
    l1 = tr.train_step(run["batch"])
    _, l0, g0, _ = port_step
    assert float(l0["loss"]) == float(l1["loss"])
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9)


def test_bf16_loss_and_gradients_match_jax(run):
    """The step's loss with its UNet in bf16, on the same fp32 latent,
    tokens and draws: its logs, and every trainable gradient held to JAX's
    bf16 gradient within BF16_NOISE_FACTOR times JAX's own bf16 distance
    to its fp32 gradient (the step's), plus BF16_GRAD_RTOL of the leaf."""
    port = _port_model(run["np_params"])
    port.train()
    image = torch.from_numpy(run["batch"]["image"])
    t, noise = (torch.from_numpy(d.copy()) for d in run["draws"])
    z = port.encode_first_stage(image).float()
    ctx = port.get_learned_conditioning(run["batch"]["tokens"])
    loss, logs = port.training_loss(z, ctx, t.long(), noise,
                                    compute_dtype=torch.bfloat16)
    assert loss.dtype == torch.float32
    (_, jlogs), jgrads = run["bf16"](z.numpy())
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=BF16_LOSS_RTOL, err_msg=k)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in trainer.trainable_parameters(port)}
    assert all(g.dtype == np.float32 for g in got.values())
    want = _sd(jgrads)
    fp32 = _sd(run["jax"]()["new_state"].opt_state[0])
    assert set(got) == {k for k in want
                        if not k.startswith("first_stage_model.")}
    floor = BF16_GRAD_FLOOR * max(np.abs(fp32[k]).max() for k in got)
    for k, g in got.items():
        noise = np.abs(want[k] - fp32[k]).max()
        tol = (BF16_NOISE_FACTOR * noise
               + BF16_GRAD_RTOL * np.abs(fp32[k]).max() + floor)
        err = np.abs(g - want[k]).max()
        assert err <= tol, (k, err, noise)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_training_loss_math_matches_jax(run, loss_type):
    """``training_loss`` and its logs, both packages' UNet replaced by the
    same fixed outputs: the l1/l2 window loss, the trained logvar at t,
    ``l_simple_weight``, the lvlb term and ``stage_loss_ratio``."""
    extra = dict(loss_type=loss_type, l_simple_weight=0.7,
                 original_elbo_weight=0.5, stage_loss_ratio=[0.4, 0.6])
    rng = np.random.default_rng(31)
    z, noise = (rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
                for _ in range(2))
    t = np.asarray([3, 29])
    outs = [rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
            for _ in range(2)]
    jmodel = jax_instantiate(_config(**extra))
    jmodel.apply_model = lambda params, x, t, ctx, stage, *a: \
        jnp.asarray(outs[stage])
    jparams = {"params": {"logvar": jnp.asarray(
        run["np_params"]["params"]["logvar"])}}
    jloss, jlogs = jmodel.training_loss(jparams, jnp.asarray(z), None,
                                        jnp.asarray(t), jnp.asarray(noise))
    port = _port_model(run["np_params"], **extra)
    port.apply_model = lambda x, t, ctx, stage, *a: \
        torch.from_numpy(outs[stage])
    loss, logs = port.training_loss(torch.from_numpy(z), None,
                                    torch.from_numpy(t),
                                    torch.from_numpy(noise))
    assert set(logs) == set(jlogs)
    assert float(jloss) == float(jlogs["loss"])
    for k in logs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
