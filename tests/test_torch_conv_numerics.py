"""The conv kernels' host plan and arithmetic, on the CPU.

The CUDA kernel (``frido_tpu_torch/csrc/conv3x3.cu``) cannot run here, so
this file holds what it computes to the references by emulating it:

- (a) ``conv_plan`` at every site ``chip_smoke.py`` times and at the card
  tests' ragged shapes: every output (pixel, Cout) is covered by exactly
  one block of each K split, the splits cover the Cin chunks exactly once,
  the shared memory fits the 227 KB a block may opt in to, and every
  main-path site launches at least 132 blocks (one per SM).
- (b) :func:`emulate`, the kernel's order of work with its own index
  arithmetic on flat stand-ins for shared memory (filled with NaN, so a
  read of anything the copies did not stage shows in the output): the
  weight packed to [9, Cout, Cin8] (fp32: split once into tf32 hi and lo),
  each Cin chunk's raw patch rows staged, the prologue applied once per
  staged element and rounded to bf16 into the compute patch, 0 at the
  halo, nine shifted dots per chunk, split-K partials summed in split
  order, bias, one rounding. Held against the JAX package's
  ``conv3x3_norm_silu_pallas`` (interpret mode) and ``conv3x3_pallas``,
  and against the port's plain versions.
- (c) 3xTF32 (``cvt.rna`` rounding emulated bit for bit) at the decoder's
  K = 9 * 128 = 1152 stays within 1e-4 of the output RMS of fp32
  ``conv3x3_plain`` (the card tests' fp32 tolerance); one tf32 pass does
  not.

Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from frido_tpu.ops.pallas.conv_pallas import (conv3x3_norm_silu_pallas,
                                              conv3x3_pallas)
from frido_tpu_torch.ops.cuda.conv import (MAX_SMEM, SM_COUNT, chunk,
                                           conv3x3_norm_silu_plain,
                                           conv3x3_plain, conv_plan)
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain

torch.set_num_threads(2)

BM = 64           # output channels per block (conv3x3.cu)
THREADS = 256


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _cdiv(a, b):
    return -(-a // b)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    mantissa bits to the magnitude, then clear them (ties away from 0)."""
    u = x.float().contiguous().numpy().view(np.uint32)
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


def _bf16(t):
    return t.bfloat16().float()


# ---------------------------------------------------------------------------
# (b) the kernel's order of work


def emulate(x, w, bias, bf16, norm=None, gamma=None, beta=None):
    """conv3x3.cu on fp32 tensors that hold the kernel's dtype (bf16 values
    when ``bf16``). ``norm``: (scale, shift) [N, Cin] of the statistics
    launch, for the fused variant."""
    isz = 2 if bf16 else 4
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    fused, spade = norm is not None, gamma is not None
    p = conv_plan(n, cin, h, wd, cout, isz, fused, spade)
    bk = chunk(isz)
    ld = bk + (8 if bf16 else 4)
    ve = 16 // isz
    cinp = _cdiv(cin, ve) * ve
    nch = _cdiv(cin, bk)
    # pack: [parts][9][cout][cinp], fp32 split once into hi and lo
    wt = torch.zeros(9, cout, cinp)
    wt[:, :, :cin] = w.permute(2, 3, 0, 1).reshape(9, cout, cin)
    parts = [wt] if bf16 else [tf32_rna(wt), tf32_rna(wt - tf32_rna(wt))]
    ph, pw = p.th + 2, p.tw + 2
    npix = p.nb * ph * pw
    vc = p.xcopy // isz if p.xcopy else 1
    nv = 1 + _cdiv(p.tw + 1, vc)
    plane = p.nb * ph * p.rs
    tiles_x, tiles_y = _cdiv(wd, p.tw), _cdiv(h, p.th)
    tpix = p.nb * p.th * p.tw
    assert p.grid[0] == tiles_x * tiles_y * _cdiv(n, p.nb)
    srcs = [x] + ([gamma, beta] if spade else [])
    ws = torch.zeros(p.split, n, cout, h, wd)

    # per-thread raw-row geometry and convert items (chunk invariant)
    ipc = p.nb * ph * nv
    cstep = THREADS // ipc
    tid = torch.arange(THREADS)
    xslot, r = tid // ipc, tid % ipc
    xv, q = r % nv, r // nv
    xpy, xb = q % ph, q // ph
    item = torch.arange(npix * bk // 4)
    gi, pp = item // npix, item % npix
    px, q = pp % pw, pp // pw
    py, b = q % ph, q // ph
    roff = ((4 * gi * p.nb + b) * ph + py) * p.rs + px + vc - 1
    coff = pp * ld + 4 * gi
    lane_n = torch.arange(32 * p.nt)
    nb_, rr = lane_n // (p.th * p.tw), lane_n % (p.th * p.tw)
    pbase = (nb_ * ph + rr // p.tw) * pw + rr % p.tw
    pbase = torch.where(lane_n < tpix, pbase, 0)

    for bx in range(p.grid[0]):
        x0 = (bx % tiles_x) * p.tw
        y0 = (bx // tiles_x % tiles_y) * p.th
        b0 = bx // (tiles_x * tiles_y) * p.nb
        gx, gy = x0 - vc + xv * vc, y0 - 1 + xpy
        xok = (xslot < cstep) & (b0 + xb < n) & (gy >= 0) & (gy < h) & \
            (gx >= 0) & (gx < wd)
        xdst = (xb * ph + xpy) * p.rs + xv * vc
        cgx, cgy = x0 - 1 + px, y0 - 1 + py
        inimg = (b0 + b < n) & (cgx >= 0) & (cgx < wd) & (cgy >= 0) & \
            (cgy < h)
        for by in range(p.grid[1]):
            co0 = by * BM
            for bz in range(p.grid[2]):
                kc0 = bz * p.cps
                nk = min(nch, kc0 + p.cps) - kc0
                assert nk > 0
                acc = torch.zeros(BM, 32 * p.nt)
                for kc in range(kc0, kc0 + nk):
                    c0 = kc * bk
                    # weight tile [parts][9][64][ld]: two 16-byte copies a row
                    a = torch.full((len(parts), 9, BM, ld), float("nan"))
                    a[..., :bk] = 0.0
                    cos = slice(co0, min(cout, co0 + BM))
                    cis = slice(c0, min(cinp, c0 + bk))
                    for k, part in enumerate(parts):
                        a[k, :, :cos.stop - co0, :cis.stop - c0] = \
                            part[:, cos, cis]
                    # raw rows: in-image vectors only, the rest stays NaN
                    raw = torch.full((len(srcs), bk * plane), float("nan"))
                    for t in range(THREADS):
                        if not xok[t]:
                            continue
                        bi, y_, x_ = b0 + int(xb[t]), int(gy[t]), int(gx[t])
                        for ci_l in range(int(xslot[t]), bk, cstep):
                            if c0 + ci_l >= cin:
                                continue
                            d = ci_l * plane + int(xdst[t])
                            for s, src in enumerate(srcs):
                                raw[s, d:d + vc] = src[bi, c0 + ci_l, y_,
                                                       x_:x_ + vc]
                    # convert: once per staged element, into [parts][npix][ld]
                    patch = torch.full((len(parts), npix * ld), float("nan"))
                    for j in range(4):
                        ci = c0 + 4 * gi + j
                        ok = inimg & (ci < cin)
                        o = roff + j * plane
                        val = torch.where(ok, raw[0, o.clamp(max=raw.shape[1]
                                                             - 1)], 0.0)
                        if fused:
                            bi = (b0 + b).clamp(max=n - 1)
                            cc = ci.clamp(max=cin - 1)
                            v = val * norm[0][bi, cc] + norm[1][bi, cc]
                            if spade:
                                v = v * (1 + raw[1, o.clamp(
                                    max=raw.shape[1] - 1)]) + raw[2, o.clamp(
                                        max=raw.shape[1] - 1)]
                            v = F.silu(v)
                            v = _bf16(v) if bf16 else v
                            val = torch.where(ok, v, 0.0)
                        if bf16:
                            patch[0, coff + j] = val
                        else:
                            hi = tf32_rna(val)
                            patch[0, coff + j] = hi
                            patch[1, coff + j] = tf32_rna(val - hi)
                    patch = patch.view(len(parts), npix, ld)
                    # nine shifted dots over the patch
                    for tap in range(9):
                        shift = (tap // 3) * pw + tap % 3
                        bt = patch[:, pbase + shift, :bk]
                        at = a[:, tap, :, :bk]
                        if bf16:
                            acc += at[0] @ bt[0].t()
                        else:
                            acc += (at[1] @ bt[0].t() + at[0] @ bt[1].t()) \
                                + at[0] @ bt[0].t()
                # store the block's tile
                for nn in range(tpix):
                    bi = b0 + nn // (p.th * p.tw)
                    rem = nn % (p.th * p.tw)
                    y_, x_ = y0 + rem // p.tw, x0 + rem % p.tw
                    if bi >= n or y_ >= h or x_ >= wd:
                        continue
                    m = min(BM, cout - co0)
                    ws[bz, bi, co0:co0 + m, y_, x_] = acc[:m, nn]
    out = ws[0].clone()
    for k in range(1, p.split):
        out += ws[k]
    out = out + bias[None, :, None, None]
    return _bf16(out) if bf16 else out


def _affine(x, nscale, nbias, groups, eps):
    """The statistics launch: scale and shift [N, Cin] (fp32)."""
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1)
    mean = xg.mean(-1)
    var = ((xg * xg).mean(-1) - mean * mean).clamp(min=0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd.repeat_interleave(c // groups, 1) * nscale
    return scale, nbias - mean.repeat_interleave(c // groups, 1) * scale


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("spade", [False, True])
def test_emulated_fused_kernel_matches_pallas_and_plain(bf16, spade):
    """[2, 8, 8, 64] -> 32, 32 groups: the emulation against the JAX
    Pallas kernel (interpret mode) within ``tests/test_pallas.py``'s 2e-4,
    and against the plain version on the same (bf16-rounded) inputs within
    the card tests' tolerance (1e-4 of the output RMS, bf16 2^-6 of it +
    2^-8 |plain|)."""
    shape, cout = (2, 8, 8, 64), 32
    rnd = _bf16 if bf16 else (lambda t: t)
    x = rnd(_nchw(_randn(shape, 9) * 1.5 + 0.3))
    w = rnd(torch.from_numpy(_randn((cout, 64, 3, 3), 10, 0.05)))
    b = rnd(torch.from_numpy(_randn((cout,), 11, 0.1)))
    nscale = torch.from_numpy(1.0 + _randn((64,), 12, 0.1))
    nbias = torch.from_numpy(_randn((64,), 13, 0.1))
    g = bt = None
    if spade:
        g, bt = (rnd(_nchw(_randn(shape, s, 0.2))) for s in (14, 15))
    got = emulate(x, w, b, bf16, _affine(x, nscale, nbias, 32, 1e-5), g, bt)
    assert bool(torch.isfinite(got).all())
    want = conv3x3_norm_silu_plain(x, w, b, nscale, nbias, 32, 1e-5, g, bt)
    if bf16:
        want = conv3x3_norm_silu_plain(x.bfloat16(), w.bfloat16(),
                                       b.bfloat16(), nscale, nbias, 32, 1e-5,
                                       g, bt).float()
    rms = want.square().mean().sqrt().item()
    atol = (2.0 ** -6 if bf16 else 1e-4) * rms
    rtol = 2.0 ** -8 if bf16 else 0.0
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), err.max().item()
    j = (lambda t: None if t is None else jnp.asarray(_nhwc(t)))
    pallas = np.asarray(conv3x3_norm_silu_pallas(
        j(x), jnp.asarray(w.permute(2, 3, 1, 0).numpy()), jnp.asarray(b),
        jnp.asarray(nscale), jnp.asarray(nbias), 32, 1e-5, gamma=j(g),
        beta=j(bt)))
    if bf16:   # the Pallas kernel in fp32 on the same values; bf16 output
        np.testing.assert_allclose(_nhwc(got), pallas, atol=atol,
                                   rtol=rtol)
    else:
        np.testing.assert_allclose(_nhwc(got), pallas, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,cout", [
    ((2, 16, 16, 16), 24),     # split K, row tiles
    ((3, 6, 5, 7), 10),        # ragged everything: element copies in bf16
    ((2, 20, 3, 65), 10),      # W = 65: two column tiles and a tail
    ((4, 4, 32, 32), 8),       # Cin = 4: K = 36 in one chunk
    ((4, 40, 4, 4), 70),       # whole 4x4 images, Cout tail, split K
])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_emulated_conv_kernel_matches_plain(shape, cout, bf16):
    """The plain variant at the ragged edges of its tiles against
    ``conv3x3_plain`` within the card tests' tolerance, and the JAX
    package's ``conv3x3_pallas`` (interpret mode) within 2e-4."""
    n, cin, h, w_ = shape
    rnd = _bf16 if bf16 else (lambda t: t)
    x = rnd(torch.from_numpy(_randn(shape, 20)))
    w = rnd(torch.from_numpy(_randn((cout, cin, 3, 3), 21) / (9 * cin) ** .5))
    b = rnd(torch.from_numpy(_randn((cout,), 22, 0.1)))
    got = emulate(x, w, b, bf16)
    want = conv3x3_plain(x, w, b)
    rms = want.square().mean().sqrt().item()
    rtol = 2.0 ** -8 if bf16 else 0.0
    err = (got - want).abs()
    assert bool((err <= 1e-4 * rms + rtol * want.abs()).all()), \
        err.max().item()
    pallas = np.asarray(conv3x3_pallas(
        jnp.asarray(_nhwc(x)), jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
        jnp.asarray(b)))
    np.testing.assert_allclose(_nhwc(got), pallas, atol=2e-4 + rtol,
                               rtol=2e-4 + rtol)


def test_emulated_split_k_is_summed_in_split_order():
    """[4, 1920, 4, 4] -> 960's plan splits K 9 ways; the same inputs give
    the same bits twice, and the partials go in split order (a shuffled
    order would give other bits of fp32 sums)."""
    plan = conv_plan(4, 1920, 4, 4, 960, 2, True)
    assert plan.split == 9 and plan.grid[2] == 9
    x = _bf16(torch.from_numpy(_randn((1, 40, 4, 4), 30)))
    w = _bf16(torch.from_numpy(_randn((8, 40, 3, 3), 31)))
    b = torch.zeros(8)
    assert conv_plan(1, 40, 4, 4, 8, 2).split == 3
    one, two = emulate(x, w, b, True), emulate(x, w, b, True)
    assert torch.equal(one, two)


# ---------------------------------------------------------------------------
# (a) the plan

# (shape, cout, itemsize, fused, spade): the main path's sites (the UNet's
# fused prologues at each resolution, its plain convs, the decoder's fp32
# convs) and the card tests' shapes
MAIN_SITES = [
    ((4, 576, 32, 32), 192, 2, True, True),
    ((4, 192, 32, 32), 192, 2, True, False),
    ((4, 384, 32, 32), 192, 2, True, True),
    ((4, 960, 16, 16), 384, 2, True, True),
    ((4, 192, 16, 16), 384, 2, True, False),
    ((4, 1536, 8, 8), 576, 2, True, True),
    ((4, 384, 8, 8), 576, 2, True, False),
    ((4, 1920, 4, 4), 960, 2, True, False),
    ((4, 1920, 4, 4), 960, 2, True, True),
    ((4, 576, 4, 4), 960, 2, True, True),
    ((4, 4, 32, 32), 192, 2, False, False),
    ((4, 960, 8, 8), 960, 2, False, False),
    ((4, 576, 16, 16), 576, 2, False, False),
    ((4, 384, 32, 32), 384, 2, False, False),
    ((4, 192, 32, 32), 4, 2, False, False),
    ((4, 128, 256, 256), 128, 4, False, False),
    ((4, 128, 256, 256), 3, 4, False, False),
    ((4, 256, 128, 128), 128, 4, False, False),
    ((4, 512, 64, 64), 256, 4, False, False),
    ((4, 512, 32, 32), 512, 4, False, False),
    ((4, 8, 32, 32), 512, 4, False, False),
]
CARD_SITES = [
    ((3, 6, 5, 7), 10, 4, False, False), ((3, 6, 5, 7), 10, 2, False, False),
    ((2, 64, 5, 7), 20, 2, True, True), ((2, 64, 5, 7), 20, 4, True, True),
    ((1, 1, 1, 1), 1, 2, False, False), ((1, 20, 3, 65), 10, 4, True, True),
    ((1, 6, 1, 1), 1, 2, False, False), ((2, 128, 256, 256), 128, 4, False,
                                         False),
    ((4, 128, 4, 4), 1920, 2, False, False),
    ((4, 192, 4, 4), 128, 2, False, False),
]


def _check_plan(shape, cout, itemsize, fused, spade):
    n, cin, h, w = shape
    p = conv_plan(n, cin, h, w, cout, itemsize, fused, spade)
    assert 0 < p.smem <= MAX_SMEM
    tiles_x, tiles_y = _cdiv(w, p.tw), _cdiv(h, p.th)
    assert p.grid == (tiles_x * tiles_y * _cdiv(n, p.nb), _cdiv(cout, BM),
                      p.split)
    assert p.nb * p.th * p.tw <= 32 * p.nt
    assert p.nb == 1 or (p.th, p.tw) == (h, w)
    cover = np.zeros((n, h, w), np.int32)
    for bx in range(p.grid[0]):
        x0 = (bx % tiles_x) * p.tw
        y0 = (bx // tiles_x % tiles_y) * p.th
        b0 = bx // (tiles_x * tiles_y) * p.nb
        assert b0 < n and y0 < h and x0 < w
        cover[b0:b0 + p.nb, y0:y0 + p.th, x0:x0 + p.tw] += 1
    assert (cover == 1).all()
    chans = np.zeros(_cdiv(cout, BM) * BM, np.int32)
    for by in range(p.grid[1]):
        chans[by * BM:(by + 1) * BM] += 1
    assert (chans[:cout] == 1).all()
    nch = _cdiv(cin, chunk(itemsize))
    chunks = np.zeros(nch, np.int32)
    for bz in range(p.split):
        k = np.arange(bz * p.cps, min(nch, (bz + 1) * p.cps))
        assert k.size > 0
        chunks[k] += 1
    assert (chunks == 1).all()
    if p.xcopy:
        assert w * itemsize % p.xcopy == 0
        assert tiles_x == 1 or p.tw % (p.xcopy // itemsize) == 0
    assert p.rs * itemsize % 16 == 0
    return p


@pytest.mark.parametrize("site", MAIN_SITES,
                         ids=[f"{s[0]}->{s[1]}" for s in MAIN_SITES])
def test_plan_covers_once_fits_and_fills_the_card(site):
    p = _check_plan(*site)
    assert p.grid[0] * p.grid[1] * p.grid[2] >= SM_COUNT, p


def test_plan_covers_the_ragged_card_test_shapes_once():
    for site in CARD_SITES:
        _check_plan(*site)


# ---------------------------------------------------------------------------
# (c) 3xTF32 at the decoder's K


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_3xtf32_conv_keeps_the_fp32_tolerance(passes, within):
    """[1, 128, 32, 32] -> 128 (K = 1152) as an implicit GEMM in tf32
    against fp32 ``conv3x3_plain``: 3 passes stay within 1e-4 of the output
    RMS, 1 pass does not."""
    x = torch.from_numpy(_randn((1, 128, 32, 32), 40))
    w = torch.from_numpy(_randn((128, 128, 3, 3), 41) / 1152 ** 0.5)
    b = torch.zeros(128)
    cols = F.unfold(x, 3, padding=1)[0]             # [1152, 1024]
    got = mm_tf32(w.reshape(128, -1), cols, passes).reshape(1, 128, 32, 32)
    want = conv3x3_plain(x, w, b)
    rms = want.square().mean().sqrt().item()
    err = (got - want).abs().max().item()
    assert (err <= 1e-4 * rms) == within, (err, rms)


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4])
    assert torch.equal(tf32_rna(x), torch.tensor([1 + ulp, -(1 + ulp), 1.0,
                                                  1 + ulp]))


def test_plain_prologue_pads_after_the_prologue():
    """The emulation's halo is 0, not prologue(0): with beta = 3 the border
    differs from a conv of the padded prologue."""
    shape = (1, 32, 4, 4)
    x = torch.from_numpy(_randn(shape, 50))
    w = torch.from_numpy(_randn((8, 32, 3, 3), 51, 0.05))
    b = torch.zeros(8)
    ns, nb = torch.ones(32), torch.zeros(32)
    g, bt = torch.zeros(shape), torch.full(shape, 3.0)
    got = emulate(x, w, b, False, _affine(x, ns, nb, 8, 1e-5), g, bt)
    xn = F.silu(group_norm_plain(x, ns, nb, 8, 1e-5) + 3.0)
    wrong = F.conv2d(F.pad(xn, (1, 1, 1, 1), value=F.silu(
        torch.tensor(3.0)).item()), w, b)
    right = F.conv2d(xn, w, b, padding=1)
    assert (got - right).abs().max().item() <= 1e-4
    assert (got - wrong).abs().max().item() > 0.1
