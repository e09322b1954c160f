"""The GroupNorm and VQ argmin kernels' host plans and orders of work, on
the CPU.

The CUDA kernels (``frido_tpu_torch/csrc/group_norm.cu``,
``csrc/vq_argmin.cu``) cannot run here, so this file holds what they
compute to the references by emulating them:

- (a) ``group_norm_plan`` at every GroupNorm site of the main path and at
  the card tests' shapes: every element of every (sample, group) run lies
  in exactly one CTA's slice, slices are whole 16-byte vectors, the
  cluster size is one the launch takes (1 to 16, a power of 2; 0 for the
  streaming path), a slice in registers fits its threads' vectors, three
  CTAs' shared memory fit an SM, and runs over 16 x 64 KB are streamed.
- (b) ``vq_plan``: the parts cover the codebook [0, K) exactly once, the
  cluster divides a CTA's rows, the shared memory fits 227 KB, and the
  main path's N = 4096 (and N = 1024, 32768) puts a CTA on each of 128
  SMs.
- (c) :func:`emulate_group_norm`, the kernel's sum order (per thread over
  its strided 4-element vectors, a butterfly over each warp and over the
  warps, the cluster's CTA partials in rank order) and its per-slice
  normalisation with the channel taken from each element's index, held
  against the JAX package's ``group_norm_pallas`` (interpret mode) and
  the port's plain version, the constant group included.
- (d) :func:`emulate_vq`, the sliced scan (per part: a running minimum,
  the chunk of its last strict decrease, the first code in that chunk at
  the minimum, lanes staggered) and the lexicographic merge (warps in
  order, then the cluster's CTAs in rank order), held against the JAX
  package's ``vq_argmin`` (interpret mode), with exact ties placed in
  different chunks, warps' parts and CTAs.

Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.ops.pallas.norm_pallas import group_norm_pallas
from frido_tpu.ops.pallas.vq_pallas import vq_argmin as jax_vq_argmin
from frido_tpu_torch.ops.cuda.norm import (MAX_SLICE_BYTES, MAX_SMEM, REGS,
                                           group_norm_plan)
from frido_tpu_torch.ops.cuda.vq import CHUNK, vq_plan
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain

torch.set_num_threads(2)

# (shape, dtype itemsize): every GroupNorm site of the main path (batch 4)
MAIN_SITES = [
    ((4, 512, 32, 32), 4), ((4, 512, 64, 64), 4), ((4, 256, 64, 64), 4),
    ((4, 256, 128, 128), 4), ((4, 128, 128, 128), 4),
    ((4, 128, 256, 256), 4),
    ((4, 192, 32, 32), 2), ((4, 384, 16, 16), 2), ((4, 576, 8, 8), 2),
    ((4, 960, 4, 4), 2),
]
# the card tests' shapes (32 groups unless a third element says otherwise)
CARD_SITES = [
    ((1, 32, 512, 512), 4), ((1, 32, 512, 513), 4), ((1, 64, 768, 768), 4),
    ((1, 32, 724, 724), 2), ((4, 96, 40, 40), 4), ((4, 64, 45, 45), 4),
    ((2, 96, 2, 2), 2), ((2, 64, 5, 3), 4), ((2, 128, 5, 1), 4),
    ((2, 6, 7, 7), 2, 1), ((2, 64, 8, 8), 4), ((4, 128, 64, 64), 4),
    ((2, 64, 150, 150), 4), ((2, 64, 99, 99), 4), ((2, 64, 102, 103), 4),
]
STATIC_SMEM = 64 * 4 + 8   # the kernel's red[64] and its (mean, rstd)
SMEM_RESERVED = 1024       # per CTA, kept by the hardware


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _site(entry):
    shape, itemsize = entry[:2]
    groups = entry[2] if len(entry) > 2 else 32
    n, c = shape[:2]
    return n, c, groups, int(np.prod(shape[2:])), itemsize


# ---------------------------------------------------------------------------
# (a) group_norm_plan


@pytest.mark.parametrize("entry", MAIN_SITES + CARD_SITES)
def test_group_norm_plan_covers_every_element_once(entry):
    n, c, groups, hw, itemsize = _site(entry)
    p = group_norm_plan(n, c, groups, hw, itemsize)
    count = (c // groups) * hw
    if count * itemsize > 16 * MAX_SLICE_BYTES:
        assert p.cluster == 0 and p.ctas == n * groups and p.smem == 0
        return
    assert p.cluster in (1, 2, 4, 8, 16)
    assert p.ctas == n * groups * p.cluster
    # the slices [rank * slice, ...) cut the run into disjoint pieces that
    # cover it, none empty
    owner = np.zeros(count, np.int64)
    for rank in range(p.cluster):
        lo = rank * p.slice
        assert lo < count
        owner[lo:min(count, lo + p.slice)] += 1
    assert (owner == 1).all()
    if p.vpt:        # the run in one CTA's registers, vpt vectors a thread
        assert hw % 4 == 0 and p.smem == 0
        assert (p.cluster, p.slice) == (1, count)
        assert (p.threads, p.vpt) in REGS
        assert count <= p.threads * 4 * p.vpt
    else:            # slices in shared memory
        assert p.slice % 8 == 0 and p.slice * itemsize <= MAX_SLICE_BYTES
        assert p.smem == p.slice * itemsize + 64
        assert 3 * (p.smem + STATIC_SMEM + SMEM_RESERVED) <= MAX_SMEM
        assert p.threads in (256, 512)


@pytest.mark.parametrize("entry", MAIN_SITES)
def test_group_norm_plan_at_the_main_path_sites(entry):
    """Runs up to 32768 elements (the UNet's, the decoder's at 32^2 and
    256 x 64^2) in one CTA's registers; larger ones in clusters of 32 KB
    slices, the decoder's 1 MB runs in 16 CTAs of 64 KB."""
    n, c, groups, hw, itemsize = _site(entry)
    p = group_norm_plan(n, c, groups, hw, itemsize)
    count = (c // groups) * hw
    assert (p.vpt > 0) == (count <= 32768)
    if not p.vpt:
        assert p.slice * itemsize <= 32768 or p.cluster == 16
    if entry[0] == (4, 128, 256, 256):
        assert (p.cluster, p.slice * itemsize) == (16, MAX_SLICE_BYTES)


# ---------------------------------------------------------------------------
# (b) vq_plan


@pytest.mark.parametrize("n,k,d", [
    (1, 1, 4), (1, 8192, 4), (1024, 8192, 4), (4096, 8192, 4),
    (32768, 8192, 4), (32769, 8191, 3), (4096, 300, 3), (4096, 1000, 4),
    (77, 5000, 3), (64, 200000, 4),
])
def test_vq_plan_parts_cover_the_codebook_once(n, k, d):
    p = vq_plan(n, k, d)
    parts = p.warps * p.cluster
    owner = np.zeros(k, np.int64)
    for part in range(parts):
        owner[part * p.ks:min(k, (part + 1) * p.ks)] += 1
    assert (owner == 1).all()
    assert p.kr % CHUNK == 0 and p.ks % p.kr == 0
    assert p.cluster in (1, 2, 4, 8) and (32 * p.rows) % p.cluster == 0
    assert 1 <= p.warps <= 8 and p.rows in (2, 4, 8)
    assert p.smem <= MAX_SMEM
    assert p.grid == -(-n // (32 * p.rows)) * p.cluster


def test_vq_plan_fills_the_card_at_the_main_path():
    """N = 4 * 32 * 32 (both codebooks at batch 4), the decode chunk's
    N = 32768 and N = 1024: one CTA of 8 warps on each of 128 SMs, the
    largest power of 2 under the 132 (more, shorter CTAs measured slower
    on the card)."""
    for n in (1024, 4096, 32768):
        p = vq_plan(n, 8192, 4)
        assert p.grid == 128 and p.warps == 8
    assert vq_plan(4096, 8192, 4).cluster == 2


# ---------------------------------------------------------------------------
# (c) the GroupNorm kernel's order of work


def _butterfly(v):
    """__shfl_xor_sync sums over the last axis (32 lanes): every lane ends
    with the same total; lane 0's."""
    v = v.clone()
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _cta_sums(xs, threads):
    """(sum, sum of squares) of one CTA's slice as group_norm.cu takes
    them: 4-element vectors strided over the threads, each thread in index
    order, (v0 + v1) + (v2 + v3); then block_sum2's two butterflies. The
    kernel restarts the stride at each of its four bulk-copy pieces, which
    changes which thread sums which vector but not this structure; the
    emulation strides over the slice as one piece."""
    pad = (-xs.numel()) % 4
    v = torch.cat([xs, xs.new_zeros(pad)]).view(-1, 4)
    steps = -(-v.shape[0] // threads)
    v = torch.cat([v, v.new_zeros(steps * threads - v.shape[0], 4)])
    v = v.view(steps, threads, 4)
    s = torch.zeros(threads)
    ss = torch.zeros(threads)
    for i in range(steps):
        q = v[i]
        s = s + ((q[:, 0] + q[:, 1]) + (q[:, 2] + q[:, 3]))
        ss = ss + ((q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1])
                   + (q[:, 2] * q[:, 2] + q[:, 3] * q[:, 3]))
    warps = threads // 32
    ws, wss = _butterfly(s.view(warps, 32)), _butterfly(ss.view(warps, 32))
    lane = torch.zeros(2, 32)
    lane[0, :warps], lane[1, :warps] = ws, wss
    t = _butterfly(lane)
    return t[0], t[1]


def emulate_group_norm(x, w, b, groups, eps, silu, itemsize):
    """group_norm.cu on an fp32 NCHW tensor that holds the kernel's dtype;
    returns fp32 (round to bf16 outside)."""
    n, c = x.shape[:2]
    hw = int(np.prod(x.shape[2:]))
    p = group_norm_plan(n, c, groups, hw, itemsize)
    assert p.cluster > 0
    cg = c // groups
    count = cg * hw
    flat = x.reshape(n, groups, count)
    out = torch.empty_like(flat)
    for i in range(n):
        for g in range(groups):
            run = flat[i, g]
            slices = [run[r * p.slice:(r + 1) * p.slice]
                      for r in range(p.cluster)]
            s1 = torch.zeros(())
            s2 = torch.zeros(())
            for xs in slices:            # the cluster, in rank order
                a, q = _cta_sums(xs, p.threads)
                s1, s2 = s1 + a, s2 + q
            mean = s1 / count
            var = torch.clamp(s2 / count - mean * mean, min=0.0)
            rstd = torch.rsqrt(var + eps)
            for r, xs in enumerate(slices):
                idx = r * p.slice + torch.arange(xs.numel())
                ch = g * cg + idx // hw
                a = rstd * w[ch]
                y = xs * a + (b[ch] - mean * a)
                if silu:
                    y = y / (1.0 + torch.exp(-y))
                out[i, g, idx] = y
    return out.view(x.shape)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape,bf16,silu,cluster", [
    ((2, 150, 150, 64), False, True, 8),   # NHWC; slices end mid-channel
    ((2, 99, 99, 64), False, False, 4),    # ragged H*W, mid-channel
    ((4, 16, 16, 192), True, True, 1),     # C/G = 6, bf16, in registers
])
def test_group_norm_emulation_matches_pallas_and_plain(shape, bf16, silu,
                                                       cluster):
    c = shape[-1]
    x = _randn(shape, 10, 2.0) + 0.5
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    w = 1.0 + _randn((c,), 11, 0.1)
    b = _randn((c,), 12, 0.1)
    itemsize = 2 if bf16 else 4
    xt = _nchw(x)
    hw = shape[1] * shape[2]
    assert group_norm_plan(shape[0], c, 32, hw, itemsize).cluster == cluster
    got = emulate_group_norm(xt, torch.from_numpy(w), torch.from_numpy(b),
                             32, 1e-6, silu, itemsize)
    want = np.asarray(group_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), 32, 1e-6, silu))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=2e-5, rtol=2e-5)
    plain = group_norm_plain(xt, torch.from_numpy(w), torch.from_numpy(b),
                             32, 1e-6, silu)
    assert (got - plain).abs().max().item() <= 5e-5


def test_group_norm_emulation_constant_group_across_a_cluster():
    """A constant 33.3 over runs split across an 8-CTA cluster: the clamped
    variance gives the bias, as the plain version does (the Pallas kernel,
    unclamped, gives NaN here)."""
    shape = (2, 64, 150, 150)
    assert group_norm_plan(2, 64, 32, 150 * 150, 4).cluster == 8
    x = torch.full(shape, 33.3)
    w = torch.ones(64)
    b = torch.linspace(-1.0, 1.0, 64)
    got = emulate_group_norm(x, w, b, 32, 1e-6, False, 4)
    plain = group_norm_plain(x, w, b, 32, 1e-6)
    assert bool(torch.isfinite(got).all())
    assert (got - b[None, :, None, None]).abs().max().item() <= 4 * 2.0 ** -8
    assert (got - plain).abs().max().item() <= 4 * 2.0 ** -8


# ---------------------------------------------------------------------------
# (d) the VQ kernel's sliced scan and merge


def _part_scan(zm, codes, esq, kr):
    """One warp's part: rounds of kr staged codes, a running minimum, the
    16-code chunk of its last strict decrease, then the first code of that
    chunk at the minimum (the kernel's lanes visit the chunk from their own
    starting code and keep the lowest match: the order of the visit does
    not change it). Returns (min, offset in the part) per row."""
    rows = zm.shape[0]
    run = torch.full((rows,), float("inf"))
    best = run.clone()
    at = torch.zeros(rows, dtype=torch.long)
    ar = torch.arange(CHUNK)
    for r0 in range(0, codes.shape[0], kr):
        e, s = codes[r0:r0 + kr], esq[r0:r0 + kr]
        dist = s[None, :] + zm @ e.t()            # [rows, kr]
        bc = torch.full((rows,), -1, dtype=torch.long)
        for c0 in range(0, kr, CHUNK):
            run = torch.minimum(run, dist[:, c0:c0 + CHUNK].min(dim=1).values)
            better = run < best
            best = torch.where(better, run, best)
            bc = torch.where(better, torch.full_like(bc, c0), bc)
        hit = bc >= 0
        chunk = dist.gather(1, bc.clamp(min=0)[:, None] + ar[None, :])
        first = torch.where(chunk == best[:, None], ar[None, :],
                            CHUNK).min(dim=1).values
        at = torch.where(hit, r0 + bc + first, at)
    return best, at


def emulate_vq(z, e):
    """vq_argmin.cu: parts of ks codes (past K: e = 0, |e|^2 = inf), each
    scanned as one warp does, merged (distance, index) with strict < over
    the warps in order, then the cluster's CTAs in rank order."""
    n, d = z.shape
    k = e.shape[0]
    p = vq_plan(n, k, d)
    parts = p.warps * p.cluster
    total = parts * p.ks
    ep = torch.zeros(total, d)
    ep[:k] = e
    esq = torch.full((total,), float("inf"))
    esq[:k] = (e * e).sum(dim=1)
    zm = -2.0 * z
    scans = [_part_scan(zm, ep[q * p.ks:(q + 1) * p.ks],
                        esq[q * p.ks:(q + 1) * p.ks], p.kr)
             for q in range(parts)]

    def merge(pairs):
        bd, bx = pairs[0]
        for dd, xx in pairs[1:]:
            better = dd < bd
            bd, bx = torch.where(better, dd, bd), torch.where(better, xx, bx)
        return bd, bx

    ctas = []
    for rank in range(p.cluster):
        pairs = []
        for w in range(p.warps):
            q = rank * p.warps + w
            best, at = scans[q]
            lo = q * p.ks
            pairs.append((best, torch.clamp(lo + at, max=k - 1)))
        ctas.append(merge(pairs))
    return merge(ctas)[1].to(torch.int32)


def _decided(z, e):
    dist = (e.astype(np.float64) ** 2).sum(1)[None] \
        - 2 * z.astype(np.float64) @ e.astype(np.float64).T
    top2 = np.sort(dist, axis=1)[:, :2]
    return (top2[:, 1] - top2[:, 0]) > 1e-5


@pytest.mark.parametrize("n,k,d,cluster", [
    (64, 8192, 4, 8),      # 64 parts: 8 warps x 8 CTAs
    (300, 1000, 4, 1),
    (77, 5000, 3, 8),
])
def test_vq_emulation_matches_pallas(n, k, d, cluster):
    assert vq_plan(n, k, d).cluster == cluster
    z, e = _randn((n, d), 20), _randn((k, d), 21)
    want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(e),
                                    block_n=64, block_k=1024))
    got = emulate_vq(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    keep = _decided(z, e)
    assert keep.mean() > 0.8
    np.testing.assert_array_equal(got[keep], want[keep])


def test_vq_emulation_ties_across_parts_go_to_the_lowest_index():
    """Integer codes (every distance exact): the nearest code appears at
    indices in one chunk, in two chunks of one part, in another warp's part
    and in another CTA of the cluster; removing the lowest copy each time
    moves the answer to the next, in both the emulation and the JAX
    kernel."""
    n, k, d = 64, 8192, 4
    p = vq_plan(n, k, d)
    assert p.cluster == 8 and p.warps == 8
    rng = np.random.default_rng(30)
    e = rng.integers(20, 40, (k, d)).astype(np.float32)
    z = rng.integers(-2, 3, (n, d)).astype(np.float32)
    target = np.zeros(d, np.float32)
    copies = [5, 9, 5 + CHUNK, p.ks + 2, p.ks * p.warps + 1, k - 1]
    e[copies] = target
    for lowest in copies:
        want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(e),
                                        block_n=64, block_k=1024))
        got = emulate_vq(torch.from_numpy(z), torch.from_numpy(e)).numpy()
        np.testing.assert_array_equal(want, np.full(n, lowest))
        np.testing.assert_array_equal(got, want)
        e[lowest] = 50.0
