"""The port's MS-VQGAN GAN training against the JAX package, on the CPU.

The toy MS-VQGAN of ``tests/test_training.py`` (``TINY_FIRST``) and its
loss (a two-layer PatchGAN, disc_weight 0.8, no LPIPS: the JAX package
trains with perceptual_weight 0 without local weights), seeded numpy
weights and BatchNorm statistics carried into the port by
``io/jax_weights.py``. ONE jitted JAX ``make_vqgan_train_step`` per module
(``use_aux_loss``, fp32, ``disc_start`` 1), run from one fresh state at
step 0 (before ``disc_start``: the discriminator is off) and at step 1
(after it); each optimizer is wrapped in a transformation that records
the gradients it gets, so the step also gives both phases' gradients.
Beside it: ``NLayerDiscriminator`` with BatchNorm (training forward and
the running statistics) and with ActNorm (its data-dependent init), LPIPS
with seeded weights at 32^2 (through the bridge, and from local
checkpoint files named as torchvision's and LPIPS's), the hinge and
vanilla d-losses.

Tolerances, fixed before the comparison:

- losses, logits and LPIPS distances: 3e-4 absolute (the golden tolerance
  of images, ``tests/test_torch_models.py``); ``d_weight``: 1e-3 relative
  (a ratio of two gradient norms);
- gradients, per leaf: 1e-3 of the leaf's largest JAX magnitude, floored
  at 1e-3 of the largest over the model's leaves;
- the optimizers fed the JAX gradients: weights within 1e-6 relative and
  1e-8 absolute; the port's own step: each weight within 2 * lr of JAX's;
- the BatchNorm running statistics after the step: 3e-4 absolute (they
  average the discriminator's activations of the reconstruction);
- the discriminator alone and the ActNorm init: 1e-5 absolute.
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

from frido_tpu.losses import discriminator as jax_disc
from frido_tpu.losses import lpips as jax_lpips
from frido_tpu.losses import vqperceptual as jax_vqp
from frido_tpu.models.msvqgan import msvqgan_from_config
from frido_tpu.training import optim as jax_optim
from frido_tpu.training.vqgan_trainer import (VQGANTrainState,
                                              make_vqgan_train_step)
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.losses import discriminator, lpips, vqperceptual
from frido_tpu_torch.models.msvqgan import MSFPNVQModel
from frido_tpu_torch.training import optim, vqgan_trainer
from tests.test_torch_models import _random_params
from tests.test_training import TINY_FIRST

torch.set_num_threads(2)

LR = 1e-4
LOSS = dict(disc_start=1, disc_num_layers=2, disc_weight=0.8,
            perceptual_weight=0.0)
ATOL = 3e-4
GRAD_RTOL = GRAD_FLOOR = 1e-3


def _recording(inner):
    """``inner`` whose state also holds the gradients it was last given."""
    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)

    return optax.GradientTransformation(init, update)


def _zeros(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.zeros(a.shape, a.dtype)), tree)


def _images(seed, n=2, side=32):
    return np.tanh(np.random.default_rng(seed).standard_normal(
        (n, side, side, 3))).astype(np.float32)


def _sd(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_params_to_state_dict(tree).items()}


def _disc_vars(shapes, rng):
    """Seeded discriminator variables; running variances positive."""
    out = _random_params(shapes, rng)
    for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]:
        if path[-1].key == "running_var":
            leaf[...] = 1.0 + np.abs(leaf)
    return out


@pytest.fixture(scope="module")
def gan():
    """The JAX module, loss, seeded weights, the batch; ``gan["jax"]()``
    gives the JAX step's (state, logs) at step 0 and at step 1."""
    mod = msvqgan_from_config(TINY_FIRST["params"], name=None)
    loss = jax_vqp.VQLPIPSWithDiscriminator(**LOSS)
    x = _images(0)
    pg = _random_params(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x),
                        np.random.default_rng(0))
    vd = _disc_vars(jax.eval_shape(
        lambda r: loss.init_params(r, x.shape), jax.random.PRNGKey(1)),
        np.random.default_rng(1))
    tx_g = _recording(jax_optim.build_optimizer(LR))
    tx_d = _recording(jax_optim.build_optimizer(LR))
    jpg = jax.tree_util.tree_map(jnp.asarray, pg)
    jvd = jax.tree_util.tree_map(jnp.asarray, vd)
    state = VQGANTrainState(
        params_g=jpg, vars_d=jvd,
        opt_g=_zeros(jax.eval_shape(tx_g.init, jpg)),
        opt_d=_zeros(jax.eval_shape(tx_d.init, {"params": jvd["params"]})),
        step=jnp.asarray(0, jnp.int32))
    lowered = jax.jit(make_vqgan_train_step(
        mod, loss, tx_g, tx_d, use_aux_loss=True)).lower(state, jnp.asarray(x))
    # XLA compiles on another thread while the port's side runs
    pool = concurrent.futures.ThreadPoolExecutor(1)
    compiled = pool.submit(lowered.compile)

    def results():
        step = compiled.result()
        return [step(state.replace(step=jnp.asarray(s, jnp.int32)),
                     jnp.asarray(x)) for s in (0, 1)]

    yield dict(pg=pg, vd=vd, x=x, jax=functools.cache(results))
    pool.shutdown()


def _port(gan, start_step):
    model = MSFPNVQModel(**TINY_FIRST["params"], device="cpu", seed=None)
    load_jax_params(model, gan["pg"])
    loss = vqperceptual.VQLPIPSWithDiscriminator(**LOSS, device="cpu")
    load_jax_params(loss, gan["vd"])
    opt_g = optim.build_optimizer(list(model.parameters()), LR)
    opt_d = optim.build_optimizer(list(loss.parameters()), LR)
    return vqgan_trainer.VQGANTrainer(model, loss, opt_g, opt_d,
                                      use_aux_loss=True,
                                      start_step=start_step)


def _record(opt, module):
    grads = {}
    names = {id(p): n for n, p in module.named_parameters()}
    real = opt.step

    def step():
        for group in opt.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.detach().clone()
        return real()

    opt.step = step
    return grads


@pytest.fixture(scope="module")
def port_steps(gan):
    """The port's step from the same weights at step 0 and at step 1:
    (trainer, logs, generator gradients, discriminator gradients)."""
    out = []
    for start in (0, 1):
        tr = _port(gan, start)
        gg = _record(tr.opt_g, tr.model)
        gd = _record(tr.opt_d, tr.loss)
        logs = tr.train_step(torch.from_numpy(gan["x"]))
        out.append((tr, logs, gg, gd))
    return out


def _check_grads(got, want):
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        tol = GRAD_RTOL * max(np.abs(w).max(), floor)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= tol, (k, err, tol)


# ---------------------------------------------------------------------------
def test_gan_state_carries_every_leaf(gan):
    """Every JAX leaf of the generator and of the loss (BatchNorm
    statistics included) has its port tensor and the reverse. (Runs
    first, while the JAX step compiles.)"""
    model = MSFPNVQModel(**TINY_FIRST["params"], device="meta", seed=None)
    loss = vqperceptual.VQLPIPSWithDiscriminator(**LOSS, device="meta")
    assert set(model.state_dict()) == set(_sd(gan["pg"]))
    assert set(loss.state_dict()) == set(_sd(gan["vd"]))
    assert any(k.endswith("running_var") for k in loss.state_dict())


@pytest.mark.parametrize("name", ["hinge", "vanilla"])
def test_d_losses_match_jax(name):
    rng = np.random.default_rng(4)
    real, fake = (rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
                  for _ in range(2))
    want = getattr(jax_vqp, f"{name}_d_loss")(jnp.asarray(real),
                                              jnp.asarray(fake))
    got = getattr(vqperceptual, f"{name}_d_loss")(torch.from_numpy(real),
                                                  torch.from_numpy(fake))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    assert vqperceptual.adopt_weight(1.0, 5, threshold=6) == 0.0
    assert vqperceptual.adopt_weight(1.0, 6, threshold=6) == 1.0


def test_batchnorm_discriminator_matches_jax():
    """A training forward with BatchNorm and its running statistics, and
    the eval forward on them; ``update_stats=False`` leaves them alone."""
    jd = jax_disc.NLayerDiscriminator(ndf=8, n_layers=2)
    x = _images(1, side=16)
    vd = _disc_vars(jax.eval_shape(jd.init, jax.random.PRNGKey(0), x),
                    np.random.default_rng(2))
    apply = jax.jit(jd.apply, static_argnums=(2,),
                    static_argnames=("mutable",))
    out, upd = apply(vd, jnp.asarray(x), True, mutable=("batch_stats",))
    port = discriminator.NLayerDiscriminator(ndf=8, n_layers=2,
                                             device="cpu")
    load_jax_params(port, vd)
    port.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    stats = {k: v.clone() for k, v in port.state_dict().items()
             if "running" in k}
    port(xt, update_stats=False)
    assert all(torch.equal(port.state_dict()[k], v) for k, v in stats.items())
    got = port(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    new = port.state_dict()
    for k, v in _sd({"batch_stats": upd["batch_stats"]}).items():
        np.testing.assert_allclose(new[k].numpy(), v, atol=1e-5, rtol=0,
                                   err_msg=k)
    port.eval()
    want = apply({**vd, **upd}, jnp.asarray(x), False)
    np.testing.assert_allclose(port(xt).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_actnorm_init_matches_jax():
    """ActNorm's loc and scale from the first training batch, given the
    same conv weights; a constant batch gives the identity."""
    jd = jax_disc.NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    x = _images(2, n=3, side=16)
    jvars = jax.jit(jd.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    port = discriminator.NLayerDiscriminator(ndf=8, n_layers=2,
                                             use_actnorm=True, device="cpu")
    state = jax_params_to_state_dict(jvars)
    load_jax_params(port, jvars)
    norms = [m for m in port.modules()
             if isinstance(m, discriminator.ActNorm)]
    assert len(norms) == 2 and all(m.initialized for m in norms)
    for m in norms:
        m.reset_parameters()
    port.train()
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(state[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    want = jax.jit(jd.apply)(jvars, jnp.asarray(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)
    for m in norms:
        m.reset_parameters()
    port(torch.zeros(2, 3, 16, 16))
    assert all(torch.equal(m.loc, torch.zeros_like(m.loc)) for m in norms)
    assert all(torch.equal(m.scale, torch.ones_like(m.scale))
               for m in norms)


def test_trainer_initialises_actnorm():
    """Without sample images the trainer leaves the ActNorms at the
    identity (a zero init batch's result), so the first training batch
    does not set them; with them it gives ActNorm's data-dependent init."""
    x = torch.from_numpy(_images(7, n=2, side=32))

    def trainer(**kw):
        model = MSFPNVQModel(**TINY_FIRST["params"], device="cpu", seed=1)
        loss = vqperceptual.VQLPIPSWithDiscriminator(
            **LOSS, use_actnorm=True, device="cpu", seed=2)
        opts = [optim.build_optimizer(list(m.parameters()), LR)
                for m in (model, loss)]
        tr = vqgan_trainer.VQGANTrainer(model, loss, *opts, **kw)
        norms = [m for m in loss.modules()
                 if isinstance(m, discriminator.ActNorm)]
        assert len(norms) == 2 and all(m.initialized for m in norms)
        return tr, norms

    _, norms = trainer()
    assert all(torch.equal(m.loc, torch.zeros_like(m.loc))
               and torch.equal(m.scale, torch.ones_like(m.scale))
               for m in norms)
    tr, norms = trainer(sample_images=x)
    want = copy.deepcopy(tr.loss)
    for m in want.modules():
        if isinstance(m, discriminator.ActNorm):
            m.reset_parameters()
    want.logits(x)
    got = tr.loss.state_dict()
    for k, v in want.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert any(not torch.equal(m.scale, torch.ones_like(m.scale))
               for m in norms)


@pytest.fixture(scope="module")
def lpips_weights():
    shapes = jax.eval_shape(jax_lpips.LPIPS().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 32, 32, 3)))
    return _random_params(shapes, np.random.default_rng(6))


def test_lpips_matches_jax(lpips_weights):
    x, y = _images(3), _images(4)
    want = jax.jit(jax_lpips.LPIPS().apply)(lpips_weights, jnp.asarray(x),
                                            jnp.asarray(y))
    port = lpips.LPIPS(device="cpu")
    load_jax_params(port, lpips_weights)
    got = port(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 1, 1, 1)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert not any(p.requires_grad for p in port.parameters())


def test_lpips_weights_load_from_local_files(lpips_weights, tmp_path,
                                             monkeypatch):
    """torchvision's ``features.*`` and LPIPS's ``lin{k}.model.1.weight``
    from the two local paths give the bridge's weights; without the paths
    the loss warns and trains without LPIPS."""
    bridged = lpips.LPIPS(device="cpu")
    load_jax_params(bridged, lpips_weights)
    sd = bridged.state_dict()
    vgg = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    vgg["classifier.0.weight"] = torch.zeros(2, 2)   # not read
    lin = {k: v for k, v in sd.items() if k.startswith("lin")}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "vgg.pth")
    monkeypatch.delenv("FRIDO_TPU_VGG16", raising=False)
    monkeypatch.delenv("FRIDO_TPU_LPIPS", raising=False)
    with pytest.warns(UserWarning, match="LPIPS weights unavailable"):
        loss = vqperceptual.VQLPIPSWithDiscriminator(disc_start=0,
                                                     device="cpu")
    assert not loss.use_lpips and not hasattr(loss, "perceptual_loss")
    monkeypatch.setenv("FRIDO_TPU_VGG16", str(tmp_path / "vgg16.pth"))
    monkeypatch.setenv("FRIDO_TPU_LPIPS", str(tmp_path / "vgg.pth"))
    assert lpips.lpips_available()
    loss = vqperceptual.VQLPIPSWithDiscriminator(disc_start=0,
                                                 device="cpu")
    assert loss.use_lpips
    got = loss.perceptual_loss.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", [0, 1], ids=["before-disc-start",
                                               "after-disc-start"])
def test_gan_step_matches_jax(gan, port_steps, start):
    """Every log, ``d_weight``, both phases' gradients, the updated
    weights and the running statistics."""
    tr, logs, gg, gd = port_steps[start]
    jstate, jlogs = gan["jax"]()[start]
    assert set(logs) == set(jlogs)
    for k in jlogs:
        if k == "d_weight":
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=1e-3)
        else:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       atol=ATOL, rtol=0, err_msg=k)
    assert float(jlogs["d_weight"]) > 0
    if start == 0:
        assert float(logs["discloss"]) == 0.0
    else:
        assert float(logs["discloss"]) > 0.0
    _check_grads(gg, _sd(jstate.opt_g[0]))
    jgd = _sd(jstate.opt_d[0])
    if start == 0:
        assert all(not v.any() for v in jgd.values())
        assert all(not g.any() for g in gd.values())
    else:
        _check_grads(gd, jgd)
    for module, want in ((tr.model, _sd(jstate.params_g)),
                         (tr.loss, _sd(jstate.vars_d))):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            tol = ATOL if "running" in k else 2 * LR
            err = np.abs(got[k].numpy() - w).max()
            assert err <= tol, (k, err, tol)
    assert tr.step == start + 1
    assert tr.opt_g.count == tr.opt_d.count == 1


def test_optimizers_fed_jax_grads_give_jax_weights(gan):
    tr = _port(gan, 1)
    jstate, _ = gan["jax"]()[1]
    for module, opt, grads in ((tr.model, tr.opt_g, _sd(jstate.opt_g[0])),
                               (tr.loss, tr.opt_d, _sd(jstate.opt_d[0]))):
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
    for module, want in ((tr.model, _sd(jstate.params_g)),
                         (tr.loss, _sd(jstate.vars_d["params"]))):
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w,
                                       rtol=1e-6, atol=1e-8, err_msg=k)
