"""The port's kernel modules of the all-kernel configuration on the CPU:
each plain version against the JAX package's Pallas kernel run in interpret
mode, as ``tests/test_pallas.py`` runs them, and the switch reads of
``frido_tpu_torch/ops/cuda/dispatch.py``.

Inputs come from numpy with a fixed seed and go through both packages; the
JAX kernels take NHWC and HWIO, the port NCHW and OIHW. Tolerances are
``tests/test_pallas.py``'s: atol = rtol = 2e-5 for GroupNorm and the
short-sequence attention, 2e-4 for the convs. On CPU tensors the wrappers
compute their plain versions: each call counts in ``.calls`` and none in
``.launches``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.ops.pallas.attention import smalls_attention as jax_smalls
from frido_tpu.ops.pallas.conv_pallas import (conv3x3_norm_silu_pallas,
                                              conv3x3_pallas)
from frido_tpu.ops.pallas.norm_pallas import group_norm_pallas
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.attention import smalls_attention
from frido_tpu_torch.ops.cuda.conv import conv3x3, conv3x3_norm_silu
from frido_tpu_torch.ops.cuda.norm import group_norm, group_norm_plain

torch.set_num_threads(2)


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _counted(fn, *args, **kwargs):
    """fn(*args) on the CPU: one call counted, no launch."""
    calls, launches = fn.calls, fn.launches
    out = fn(*args, **kwargs)
    assert (fn.calls, fn.launches) == (calls + 1, launches)
    return out


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 8, 8, 96)])
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_plain_group_norm_matches_pallas(shape, fuse_silu):
    c = shape[-1]
    x = _randn(shape, 0, 2.0) + 0.5
    w = 1.0 + _randn((c,), 1, 0.1)
    b = _randn((c,), 2, 0.1)
    want = np.asarray(group_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), 32, 1e-6, fuse_silu))
    got = _counted(group_norm, _nchw(x), torch.from_numpy(w),
                   torch.from_numpy(b), 32, 1e-6, fuse_silu)
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-5, rtol=2e-5)


def test_plain_group_norm_constant_group_gives_bias():
    """A constant group of 33.3 has E[x^2] - E[x]^2 < 0 in fp32: unclamped
    (as in the Pallas kernel, norm_pallas.py:58) rsqrt(var + 1e-6) would be
    NaN. The plain version clamps, and gives the bias, up to the rounding
    of x * rstd ~ 3.3e4 in its folded affine."""
    x = torch.full((2, 64, 16, 16), 33.3)
    s1 = x.sum(dim=(2, 3)).view(2, 32, 2).sum(-1) / 512
    s2 = (x * x).sum(dim=(2, 3)).view(2, 32, 2).sum(-1) / 512
    assert (s2 - s1 * s1).max().item() < -1e-6
    w = torch.ones(64)
    b = torch.linspace(-1.0, 1.0, 64)
    got = group_norm_plain(x, w, b, 32, 1e-6)
    assert bool(torch.isfinite(got).all())
    assert (got - b[None, :, None, None]).abs().max().item() <= 4 * 2.0 ** -8


@pytest.mark.parametrize("bh,nq,nk,d", [
    (2, 64, 64, 384),   # a UNet self-attention width, one head
    (2, 64, 77, 384),   # cross-attention over 77 text tokens
])
def test_plain_smalls_attention_matches_pallas(bh, nq, nk, d):
    q, k, v = (_randn((bh, n, d), s) for n, s in ((nq, 3), (nk, 4), (nk, 5)))
    scale = d ** -0.5
    want = np.asarray(jax_smalls(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale))
    got = _counted(smalls_attention, *(torch.from_numpy(a) for a in (q, k, v)),
                   scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,cout", [
    ((2, 16, 16, 64), 64),
    ((4, 4, 4, 128), 256),
])
def test_plain_conv3x3_matches_pallas(shape, cout):
    x = _randn(shape, 6)
    w = _randn((3, 3, shape[-1], cout), 7, 0.05)       # HWIO
    b = _randn((cout,), 8)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = _counted(conv3x3, _nchw(x), w_oihw, torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("spade", [False, True])
def test_plain_conv3x3_norm_silu_matches_pallas(spade):
    shape, cout = (2, 8, 8, 64), 32
    x = _randn(shape, 9)
    w = _randn((3, 3, 64, cout), 10, 0.05)
    b = _randn((cout,), 11)
    nscale = 1.0 + _randn((64,), 12, 0.1)
    nbias = _randn((64,), 13, 0.1)
    gamma = _randn(shape, 14, 0.2) if spade else None
    beta = _randn(shape, 15, 0.2) if spade else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(conv3x3_norm_silu_pallas(
        j(x), j(w), j(b), j(nscale), j(nbias), 32, 1e-5, gamma=j(gamma),
        beta=j(beta)))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    t = (lambda a: None if a is None else _nchw(a))
    got = _counted(conv3x3_norm_silu, _nchw(x), w_oihw, torch.from_numpy(b),
                   torch.from_numpy(nscale), torch.from_numpy(nbias), 32,
                   1e-5, t(gamma), t(beta))
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-4, rtol=2e-4)


def test_dispatch_reads_the_jax_switches(monkeypatch):
    for name in ("FRIDO_PALLAS", "FRIDO_FLASH", "FRIDO_GN_PALLAS",
                 "FRIDO_SMALLS_ATTN", "FRIDO_CONV_MODE", "FRIDO_CONV_SMALLS"):
        monkeypatch.delenv(name, raising=False)
    assert dispatch.conv_mode() == "conv"
    assert not (dispatch.use_conv_kernel() or dispatch.use_fused_prologue()
                or dispatch.use_group_norm_kernel()
                or dispatch.use_smalls(256, 77))
    assert dispatch.use_flash(1024) and not dispatch.use_flash(511)
    monkeypatch.setenv("FRIDO_CONV_MODE", "pallas_fused")
    monkeypatch.setenv("FRIDO_GN_PALLAS", "1")
    monkeypatch.setenv("FRIDO_SMALLS_ATTN", "1")
    assert dispatch.use_conv_kernel() and dispatch.use_fused_prologue()
    assert dispatch.use_group_norm_kernel()
    assert dispatch.use_smalls(16, 16) and dispatch.use_smalls(512, 77)
    assert not dispatch.use_smalls(513, 77)
    monkeypatch.setenv("FRIDO_CONV_MODE", "pallas")
    assert dispatch.use_conv_kernel() and not dispatch.use_fused_prologue()
    monkeypatch.setenv("FRIDO_FLASH", "0")
    assert not dispatch.use_flash(1024)
    monkeypatch.setenv("FRIDO_PALLAS", "interpret")   # the JAX tests' value
    assert dispatch.use_conv_kernel()
    monkeypatch.setenv("FRIDO_PALLAS", "0")
    assert not (dispatch.kernels_on() or dispatch.use_conv_kernel()
                or dispatch.use_group_norm_kernel()
                or dispatch.use_smalls(16, 16))


@pytest.mark.parametrize("name,value", [
    ("FRIDO_CONV_MODE", "auto"), ("FRIDO_CONV_MODE", "im2col"),
    ("FRIDO_CONV_MODE", "shift9"), ("FRIDO_CONV_MODE", "pad128"),
    ("FRIDO_CONV_MODE", "pad256"), ("FRIDO_CONV_SMALLS", "shift9"),
])
def test_dispatch_refuses_unported_conv_modes(monkeypatch, name, value):
    monkeypatch.delenv("FRIDO_CONV_SMALLS", raising=False)
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch.conv_mode()
