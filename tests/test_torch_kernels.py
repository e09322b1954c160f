"""The port's kernel modules on the CPU: their plain versions against the JAX
package's Pallas kernels run in interpret mode.

Inputs come from numpy with a fixed seed and go through both. Tolerances:
flash fp32 atol 2e-5 (the Pallas kernel's own test tolerance,
``tests/test_pallas.py``); VQ indices equal wherever the best and
second-best distances differ by more than 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.ops.pallas.attention import flash_attention as jax_flash
from frido_tpu.ops.pallas.vq_pallas import vq_argmin as jax_vq_argmin
from frido_tpu_torch.ops.cuda.attention import attention_plain, flash_attention
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain

torch.set_num_threads(2)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("bh,nq,nk,d", [
    (2, 16, 77, 32),     # text-length kv, padded inside the Pallas kernel
    (1, 40, 300, 64),    # kv tail over two Pallas blocks
    (1, 8, 24, 512),     # decoder head width with a short sequence
])
def test_plain_flash_matches_pallas(bh, nq, nk, d):
    q, k, v = (_randn((bh, n, d), s) for n, s in ((nq, 0), (nk, 1), (nk, 2)))
    scale = d ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale, block_q=128,
                                block_k=128))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(attention_plain(tq, tk, tv, scale).numpy(),
                               want, atol=2e-5, rtol=0)


def _decided(z, e):
    d = (e.astype(np.float64) ** 2).sum(1)[None] \
        - 2 * z.astype(np.float64) @ e.astype(np.float64).T
    top2 = np.sort(d, axis=1)[:, :2]
    return (top2[:, 1] - top2[:, 0]) > 1e-5


@pytest.mark.parametrize("n,k,d", [(300, 1000, 4), (64, 256, 8)])
def test_plain_vq_argmin_matches_pallas(n, k, d):
    z, e = _randn((n, d), 3), _randn((k, d), 4)
    want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(e),
                                    block_n=64, block_k=256))
    got = vq_argmin(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    assert got.dtype == np.int32 and got.shape == (n,)
    keep = _decided(z, e)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(got[keep], want[keep])


def test_plain_vq_argmin_ties_go_to_lowest_index():
    e = np.concatenate([np.ones((4, 4)), np.ones((4, 4)),
                        np.zeros((4, 4))]).astype(np.float32)
    z = np.ones((16, 4), np.float32)
    want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(e),
                                    block_n=8, block_k=4))
    got = vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros(16, np.int32))
