"""The attention kernels' arithmetic and host plans, on the CPU.

The CUDA kernels cannot run here, so this file holds what they compute to
the references by emulating their rounding points in numpy/torch:

- (a) 3xTF32: each fp32 operand split as ``cvt.rna.tf32.f32`` rounds (to
  nearest, ties away from zero, to 10 mantissa bits; the kernels do it by
  the same integer add and mask as :func:`tf32_rna` here) into hi and
  lo = tf32(x - hi); the product taken as lo*hi + hi*lo + hi*hi. Attention
  with both products in 3xTF32 stays within 5e-5 of fp32
  ``attention_plain`` (the card tests' fp32 tolerance); one tf32 pass does
  not.
- (b) the bf16 flash kernel's online softmax, which rounds each key tile's
  un-normalised exp(s - m_new) to bf16 before P.V, against the JAX
  package's ``flash_attention`` (bf16, Pallas interpret mode); both within
  5e-5 + 2^-9 max|v| + 2^-8 |plain| of fp32 ``attention_plain`` on the
  same bf16-rounded inputs (the card tests' bf16 tolerance).
- (c) ``flash_plan`` and ``smalls_plan``: every output element is covered
  by exactly one block, no block is empty, the shared memory fits the
  227 KB a block may opt in to, and the UNet's heaviest site fills the card.

Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.ops.pallas.attention import flash_attention as jax_flash
from frido_tpu_torch.ops.cuda.attention import (MAX_SMEM, attention_plain,
                                                flash_plan, smalls_plan)

torch.set_num_threads(2)

TOL_FP32 = 5e-5


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    mantissa bits to the magnitude, then clear them (ties away from 0)."""
    u = x.float().numpy().view(np.uint32)
    r = ((u.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(r.view(np.float32))


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with tf32 operands: 1 pass hi*hi, 3 passes lo*hi + hi*lo +
    hi*hi (each tf32 product exact in fp32, sums in fp32)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # tf32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(got, want)
    # hi + lo carries 21 or more significant bits of x
    y = torch.from_numpy(_randn((1000,), 5))
    hi = tf32_rna(y)
    rel = ((hi + tf32_rna(y - hi)) - y).abs() / y.abs()
    assert rel.max().item() <= 2.0 ** -21


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_3xtf32_attention_keeps_the_fp32_tolerance(passes, within):
    """[1, 256, 512], scale d^-1/2: 3 passes stay within 5e-5 of the fp32
    plain version, 1 pass does not."""
    q, k, v = (torch.from_numpy(_randn((256, 512), s)) for s in (0, 1, 2))
    scale = 512 ** -0.5
    s = mm_tf32(q, k.t().contiguous(), passes) * scale
    p = torch.softmax(s, dim=-1)
    got = mm_tf32(p, v, passes)
    want = attention_plain(q, k, v, scale)
    err = (got - want).abs().max().item()
    assert (err <= TOL_FP32) == within, err


def flash_bf16_emulated(q, k, v, scale, bk=32):
    """The bf16 flash kernel's numerics: fp32 scores of the bf16 inputs,
    an online softmax over key tiles of ``bk`` whose un-normalised
    exp(s - m_new) is rounded to bf16 for P.V (fp32 sums), the row sum
    taken in fp32, one rounding of the output."""
    qf, kf, vf = q.float(), k.float(), v.float()
    nq, nk = q.shape[-2], k.shape[-2]
    m = torch.full((*q.shape[:-1], 1), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, nk, bk):
        s = qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.bfloat16().float() @ vf[..., k0:k0 + bk, :]
        m = m_new
    assert acc.shape[-2] == nq
    return (acc / l).bfloat16()


def test_flash_bf16_rounding_matches_pallas_within_bound():
    bh, nq, nk, d = 2, 40, 100, 64
    q, k, v = (torch.from_numpy(_randn((bh, n, d), s)).bfloat16()
               for n, s in ((nq, 10), (nk, 11), (nk, 12)))
    scale = d ** -0.5
    emulated = flash_bf16_emulated(q, k, v, scale)
    pallas = torch.from_numpy(np.array(jax_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        scale, block_q=128, block_k=128).astype(jnp.float32)))
    plain = attention_plain(q.float(), k.float(), v.float(), scale)
    bound = (TOL_FP32 + 2.0 ** -9 * v.float().abs().max().item()
             + 2.0 ** -8 * plain.abs())
    for got in (emulated.float(), pallas):
        assert bool(((got - plain).abs() <= bound).all()), \
            (got - plain).abs().max().item()
    # the rounding of p moves the output: the emulation is not the fp32
    # softmax rounded once
    assert not torch.equal(emulated, plain.bfloat16())


# every site chip_smoke.py checks, and the card tests' ragged edges
FLASH_SITES = [(32, 1024, 1024, 512), (4, 1024, 1024, 512), (2, 1024, 1024,
               512), (3, 100, 77, 64), (2, 37, 300, 512), (1, 1, 1, 4),
               (2, 17, 513, 60), (2, 15, 31, 8)]
SMALLS_SITES = [(4, 256, 256, 384), (4, 256, 77, 384), (4, 64, 64, 576),
                (4, 64, 77, 576), (4, 16, 16, 960), (4, 16, 77, 960),
                (32, 77, 77, 64), (3, 100, 512, 50), (2, 17, 33, 960),
                (2, 1, 31, 8), (2, 15, 33, 60)]


def _coverage(plan, bh, nq, d):
    count = np.zeros((bh, nq, d), np.int32)
    gx, gy, gz = plan.grid
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                rows = slice(x * plan.rows, min(nq, (x + 1) * plan.rows))
                cols = slice(y * plan.cols, min(d, (y + 1) * plan.cols))
                assert rows.start < rows.stop and cols.start < cols.stop
                count[z, rows, cols] += 1
    return count


@pytest.mark.parametrize("planner,sites", [(flash_plan, FLASH_SITES),
                                           (smalls_plan, SMALLS_SITES)],
                         ids=["flash", "smalls"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
def test_plans_cover_each_output_once_and_fit(planner, sites, itemsize):
    for bh, nq, nk, d in sites:
        plan = planner(bh, nq, nk, d, itemsize)
        assert (_coverage(plan, bh, nq, d) == 1).all(), (bh, nq, nk, d)
        assert 0 < plan.smem <= MAX_SMEM, (bh, nq, nk, d, plan)
        assert plan.copy_bytes in (0, 4, 8, 16)
        if plan.copy_bytes:
            assert d * itemsize % plan.copy_bytes == 0
        if planner is flash_plan:
            assert plan.copy_bytes and plan.cols == d
            assert plan.rows in (32, 64)


def test_smalls_plan_fills_the_card_at_the_heaviest_site():
    plan = smalls_plan(4, 256, 256, 384, 2)
    gx, gy, gz = plan.grid
    assert gx * gy * gz >= 128
    # and the smallest sites too, as far as d allows
    for site in ((4, 64, 77, 576), (32, 77, 77, 64)):
        p = smalls_plan(*site, 2)
        assert p.grid[0] * p.grid[1] * p.grid[2] >= 128
