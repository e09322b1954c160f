"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the decision is
made inside the ``cuda`` fixture, never at import). The file imports only
torch and the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every kernel is held to its plain version in fp32 on the same inputs
(bf16 inputs are upcast exactly; TF32 off for matmuls and cuDNN). For bf16
each tolerance adds 2^-8 of the reference at each element: the kernels
compute in fp32 and round their output to bf16 once, which costs at most
half of that. The absolute parts:

- flash, group_norm, smalls_attention: 5e-5 (fp32 sums taken in another
  order; the attention kernels' fp32 products are 3xTF32 on the tensor
  cores, which drops only about 2^-22 of each product). Both attention
  kernels in bf16 also round the probabilities to bf16 before P.V, as the
  Pallas kernels do (flash each key tile's un-normalised exp(s - m), smalls
  the normalised row), which moves an output by at most 2^-9 * max|v|,
  added to their tolerance.
- conv3x3 and conv3x3_norm_silu: 1e-4 of the output's RMS (fp32 sums over
  K = 9 * Cin <= 17280 terms in another order). conv3x3_norm_silu in bf16
  rounds the prologue's output to bf16 before the conv; each of the K
  terms then carries an independent error of up to 2^-9 of itself, which
  sums to about 0.6 * 2^-9 of the output's RMS per element and stays under
  2^-6 of it at 5 sigma; that is its absolute part in bf16.

VQ indices must be equal wherever the best and second-best distances
differ by more than 1e-5. Each backward is held to the plain version's
autograd within 1e-4 (fp32, small shapes).
"""

import numpy as np
import pytest
import torch

from frido_tpu_torch.ops.cuda.attention import (attention_plain,
                                                flash_attention,
                                                smalls_attention)
from frido_tpu_torch.ops.cuda.conv import (conv3x3, conv3x3_norm_silu,
                                           conv3x3_norm_silu_plain,
                                           conv3x3_plain)
from frido_tpu_torch.ops.cuda.norm import (group_norm, group_norm_plain,
                                           group_norm_plan)
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain, vq_plan

BF16_RTOL = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("bh,nq,nk,d", [
    (2, 1024, 1024, 512),   # decoder AttnBlock site
    (4, 1024, 1024, 256),   # t2i encoder: trunk and head-0 mid at 32^2
    (4, 1024, 1024, 128),   # t2i shared decoder's mid at 32^2
    (4, 4096, 4096, 256),   # layout2i encoder at 64^2
    (4, 4096, 4096, 128),   # layout2i shared decoder's mid at 64^2
    (3, 100, 77, 64),       # ragged q and kv
    (2, 37, 300, 512),      # d=512, short q, kv tail
    (1, 1, 1, 4),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, bh, nq, nk, d, dtype):
    q = _randn((bh, nq, d), 0, cuda, dtype)
    k = _randn((bh, nk, d), 1, cuda, dtype)
    v = _randn((bh, nk, d), 2, cuda, dtype)
    scale = d ** -0.5
    before = flash_attention.launches
    got = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_plain(q.float(), k.float(), v.float(), scale)
    assert got.dtype == dtype and got.shape == want.shape
    ok, err = _within(got, want, _attn_atol(v, dtype), dtype)
    assert ok, err


def _attn_atol(v, dtype):
    """5e-5, + 2^-9 max|v| in bf16: P is rounded to bf16 before P.V."""
    return 5e-5 + (0.0 if dtype == torch.float32
                   else 2.0 ** -9 * v.float().abs().max().item())


def _attn_case(kernel, q, k, v, scale):
    """Launch once, check the count, shape and finiteness; compare."""
    before = kernel.launches
    got = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = attention_plain(q.float(), k.float(), v.float(), scale)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    return _within(got, want, _attn_atol(v, q.dtype), q.dtype)


def _qkv(bh, nq, nk, d, dtype, device, seed=80):
    return (_randn((bh, n, d), seed + i, device, dtype)
            for i, n in enumerate((nq, nk, nk)))


@pytest.mark.parametrize("nq", [1, 15, 17])
@pytest.mark.parametrize("nk", [31, 33, 513])
@pytest.mark.parametrize("d", [8, 60])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_tile_edges(cuda, nq, nk, d, dtype):
    """nq and nk one short of and one past the 16/32-row tiles; d short of
    the mma depth (8 tf32, 16 bf16) and not a multiple of 16."""
    q, k, v = _qkv(2, nq, nk, d, dtype, cuda)
    ok, err = _attn_case(flash_attention, q, k, v, d ** -0.5)
    assert ok, err


@pytest.mark.parametrize("nq", [1, 15, 17])
@pytest.mark.parametrize("nk", [31, 33])
@pytest.mark.parametrize("d", [8, 60, 576, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smalls_kernel_ragged_tile_edges(cuda, nq, nk, d, dtype):
    q, k, v = _qkv(2, nq, nk, d, dtype, cuda)
    ok, err = _attn_case(smalls_attention, q, k, v, d ** -0.5)
    assert ok, err


@pytest.mark.parametrize("kernel", [flash_attention, smalls_attention],
                         ids=["flash", "smalls"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_large_scores_stay_finite(cuda, kernel, dtype):
    """Scores of 100 +- 15, where exp(s) overflows fp32: the kernels must
    subtract the row max. q and k are small integers with a common offset
    of 20 in one column and the scale is 1/4, so every score is exact in
    fp32, tf32 and bf16 alike and the comparison sees only the softmax."""
    rng = np.random.default_rng(90)
    qk = rng.integers(-4, 5, (2, 2, 140, 64)).astype(np.float32)
    qk[:, :, :, 0] = 20.0
    q, k = (torch.from_numpy(a).to(cuda, dtype) for a in qk)
    v = _randn((2, 140, 64), 91, cuda, dtype)
    s = (q[:, :, None].float() * k.float()[:, None]).sum(-1) / 4
    assert s.max().item() > 90 and s.min().item() > 20
    ok, err = _attn_case(kernel, q, k, v, 0.25)
    assert ok, err


def test_flash_kernel_4d_layout_and_backward(cuda):
    q = _randn((2, 3, 64, 32), 3, cuda).requires_grad_()
    k = _randn((2, 3, 48, 32), 4, cuda).requires_grad_()
    v = _randn((2, 3, 48, 32), 5, cuda).requires_grad_()
    out = flash_attention(q, k, v, 0.2)
    ref = attention_plain(q, k, v, 0.2)
    assert (out - ref).abs().max().item() <= 5e-5
    g_k = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    g_r = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(g_k, g_r):
        assert (a - b).abs().max().item() <= 1e-4


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = _randn((1, 8, 6), 0, cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, 1.0)          # d % 4 != 0
    q = _randn((1, 8, 8), 0, cuda, torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, 1.0)


def _margin_ok(z, e, got, want):
    z64, e64 = z.double().cpu(), e.double().cpu()
    dist = (e64 * e64).sum(1)[None] - 2 * z64 @ e64.t()
    top2 = dist.topk(2, dim=1, largest=False).values
    decided = (top2[:, 1] - top2[:, 0]) > 1e-5
    return bool((got.cpu()[decided] == want.cpu()[decided]).all())


@pytest.mark.parametrize("n,k,d", [
    (32768, 8192, 4),   # decode lookup
    (1024, 8192, 4),    # t2i encode, coarse 16^2 scale
    (1000, 1000, 4),    # ragged K
    (513, 300, 4),
    (77, 5000, 3),
])
def test_vq_kernel_matches_plain(cuda, n, k, d):
    z = _randn((n, d), 6, cuda)
    e = _randn((k, d), 7, cuda)
    before = vq_argmin.launches
    got = vq_argmin(z, e)
    torch.cuda.synchronize()
    assert vq_argmin.launches == before + 1
    want = vq_argmin_plain(z, e)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert _margin_ok(z, e, got, want)


def test_vq_kernel_ties_go_to_lowest_index(cuda):
    e = torch.cat([torch.ones(4, 4), torch.ones(4, 4),
                   torch.zeros(4, 4)]).to(cuda)
    z = torch.ones(16, 4, device=cuda)
    assert (vq_argmin(z, e).cpu() == 0).all()


def _within(got, want, atol, dtype):
    """|kernel - plain| <= atol + 2^-8 |plain| (bf16) elementwise."""
    rtol = 0.0 if dtype == torch.float32 else BF16_RTOL
    err = (got.float() - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), err.max().item()


def _rms(t):
    return t.float().square().mean().sqrt().item()


@pytest.mark.parametrize("shape,eps,silu", [
    ((4, 192, 32, 32), 1e-5, True),    # UNet out head, C/G = 6
    ((4, 384, 16, 16), 1e-6, False),   # SpatialTransformer norm
    ((4, 960, 4, 4), 1e-6, False),     # H = W = 4
    ((4, 128, 256, 256), 1e-6, True),  # decoder 256^2, 262,144 per group
    ((2, 64, 5, 3), 1e-5, True),       # H*W % 4 != 0: the scalar path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_matches_plain(cuda, shape, eps, silu, dtype):
    c = shape[1]
    x = _randn(shape, 20, cuda, dtype) * 2.0 + 0.5
    w = 1.0 + 0.1 * _randn((c,), 21, cuda)
    b = 0.1 * _randn((c,), 22, cuda)
    before = group_norm.launches
    got = group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    want = group_norm_plain(x.float(), w, b, 32, eps, silu)
    assert got.dtype == dtype and got.shape == want.shape
    ok, err = _within(got, want, 5e-5, dtype)
    assert ok, err


def test_group_norm_kernel_constant_group_gives_bias(cuda):
    """The clamped variance: a constant group of 33.3 has E[x^2] - E[x]^2 < 0
    in fp32 (the plain version's sums), which unclamped is NaN at eps 1e-6.
    The output is the bias, up to the rounding of x * rstd ~ 3.3e4."""
    x = torch.full((2, 64, 16, 16), 33.3, device=cuda)
    w = torch.ones(64, device=cuda)
    b = torch.linspace(-1, 1, 64, device=cuda)
    got = group_norm(x, w, b, 32, 1e-6)
    assert bool(torch.isfinite(got).all())
    assert (got - b[None, :, None, None]).abs().max().item() <= 4 * 2.0 ** -8


@pytest.mark.parametrize("bh,nq,nk,d", [
    (4, 256, 256, 384),   # UNet self-attention, 256 tokens, one head
    (4, 256, 77, 384),    # cross-attention over 77 text tokens
    (4, 64, 77, 576),
    (4, 16, 16, 960),     # the 4x4 site: d = 960
    (4, 16, 77, 960),
    (32, 77, 77, 64),     # BERT: 8 heads x batch 4
    (4, 256, 256, 512),   # t2i encoder's head-1 mid at 16^2
    (3, 100, 512, 50),    # ragged q, the most keys, d % 4 != 0
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smalls_kernel_matches_plain(cuda, bh, nq, nk, d, dtype):
    q = _randn((bh, nq, d), 23, cuda, dtype)
    k = _randn((bh, nk, d), 24, cuda, dtype)
    v = _randn((bh, nk, d), 25, cuda, dtype)
    scale = d ** -0.5
    before = smalls_attention.launches
    got = smalls_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert smalls_attention.launches == before + 1
    want = attention_plain(q.float(), k.float(), v.float(), scale)
    assert got.dtype == dtype and got.shape == want.shape
    atol = 5e-5 + (0.0 if dtype == torch.float32
                   else 2.0 ** -9 * v.float().abs().max().item())
    ok, err = _within(got, want, atol, dtype)
    assert ok, err


def test_smalls_kernel_rejects_long_kv(cuda):
    q = _randn((1, 8, 16), 0, cuda)
    k = _randn((1, 513, 16), 1, cuda)
    with pytest.raises(ValueError):
        smalls_attention(q, k, k, 1.0)


def _conv_inputs(shape, cout, cuda, dtype, seed=30):
    cin = shape[1]
    x = _randn(shape, seed, cuda, dtype)
    w = (_randn((cout, cin, 3, 3), seed + 1, cuda) / (9 * cin) ** 0.5
         ).to(dtype)
    b = (0.1 * _randn((cout,), seed + 2, cuda)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("shape,cout", [
    ((4, 4, 32, 32), 192),      # pre_input_blocks: Cin = 4
    ((4, 192, 32, 32), 4),      # UNet out head: Cout = 4
    ((4, 384, 32, 32), 384),    # upsample conv
    ((4, 1920, 4, 4), 960),     # H = W = 4, K = 17280
    ((2, 128, 256, 256), 128),  # decoder 256^2
    ((4, 3, 256, 256), 128),    # encoder conv_in: Cin = 3 at 256^2
    ((4, 256, 32, 32), 4),      # t2i encoder head 0 conv_out
    ((4, 512, 16, 16), 4),      # t2i encoder head 1 conv_out
    ((4, 8, 32, 32), 128),      # t2i shared decoder conv_in
    ((3, 6, 5, 7), 10),         # ragged everything
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, shape, cout, dtype):
    x, w, b = _conv_inputs(shape, cout, cuda, dtype)
    before = conv3x3.launches
    got = conv3x3(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    want = conv3x3_plain(x.float(), w.float(), b.float())
    assert got.dtype == dtype and got.shape == want.shape
    ok, err = _within(got, want, 1e-4 * _rms(want), dtype)
    assert ok, err


@pytest.mark.parametrize("shape,cout,spade,groups", [
    ((4, 192, 32, 32), 192, False, 32),   # stage 0 prologue, C/G = 6
    ((4, 576, 32, 32), 192, True, 32),    # the heaviest prologue, stage 1
    ((4, 1920, 4, 4), 960, True, 32),     # H = W = 4, Cin = 1920
    ((2, 64, 5, 7), 20, True, 8),         # ragged: H*W % 4 != 0
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_norm_silu_kernel_matches_plain(cuda, shape, cout, spade,
                                                groups, dtype):
    x, w, b = _conv_inputs(shape, cout, cuda, dtype, seed=40)
    x = x * 1.5 + 0.3
    cin = shape[1]
    nscale = 1.0 + 0.1 * _randn((cin,), 43, cuda)
    nbias = 0.1 * _randn((cin,), 44, cuda)
    gamma = beta = None
    if spade:
        gamma = (0.2 * _randn(shape, 45, cuda)).to(dtype)
        beta = (0.2 * _randn(shape, 46, cuda)).to(dtype)
    before = conv3x3_norm_silu.launches
    got = conv3x3_norm_silu(x, w, b, nscale, nbias, groups, 1e-5, gamma,
                            beta)
    torch.cuda.synchronize()
    assert conv3x3_norm_silu.launches == before + 1
    up = (lambda t: None if t is None else t.float())
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), nscale,
                                   nbias, groups, 1e-5, up(gamma), up(beta))
    assert got.dtype == dtype and got.shape == want.shape
    atol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * _rms(want)
    ok, err = _within(got, want, atol, dtype)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_norm_silu_pads_after_the_prologue(cuda, dtype):
    """A large beta makes prologue(0) far from 0: a halo tap must read 0,
    so the border pixels differ from a conv of the padded prologue."""
    shape = (2, 64, 8, 8)
    x, w, b = _conv_inputs(shape, 32, cuda, dtype, seed=50)
    nscale = torch.ones(64, device=cuda)
    nbias = torch.zeros(64, device=cuda)
    gamma = torch.zeros(shape, device=cuda, dtype=dtype)
    beta = torch.full(shape, 3.0, device=cuda, dtype=dtype)
    got = conv3x3_norm_silu(x, w, b, nscale, nbias, 32, 1e-5, gamma, beta)
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), nscale,
                                   nbias, 32, 1e-5, gamma.float(),
                                   beta.float())
    atol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * _rms(want)
    ok, err = _within(got, want, atol, dtype)
    assert ok, err
    # prologue(0) = silu(3) ~ 2.86: padding before it would move the border
    xn = torch.nn.functional.silu(group_norm_plain(
        x.float(), nscale, nbias, 32, 1e-5) + 3.0)
    wrong = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xn, (1, 1, 1, 1), value=2.8577),
        w.float(), b.float())
    assert (got.float() - wrong).abs().max().item() > 0.1


def test_new_kernels_backward_match_plain_autograd(cuda):
    def grads(fn, inputs):
        inputs = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*inputs)
        return torch.autograd.grad((out ** 2).sum(), inputs)

    def check(kernel, plain, inputs):
        for a, r in zip(grads(kernel, inputs), grads(plain, inputs)):
            assert (a - r).abs().max().item() <= 1e-4

    x = _randn((2, 64, 8, 8), 60, cuda)
    w = 1.0 + 0.1 * _randn((64,), 61, cuda)
    b = 0.1 * _randn((64,), 62, cuda)
    check(lambda *a: group_norm(*a, 32, 1e-6, True),
          lambda *a: group_norm_plain(*a, 32, 1e-6, True), [x, w, b])
    q, k, v = (_randn((2, 40, 32), s, cuda) for s in (63, 64, 65))
    check(lambda *a: smalls_attention(*a, 0.2),
          lambda *a: attention_plain(*a, 0.2), [q, k, v])
    cx, cw, cb = _conv_inputs((2, 16, 8, 8), 24, cuda, torch.float32, 66)
    check(conv3x3, conv3x3_plain, [cx, cw, cb])
    g, bt = (0.2 * _randn((2, 16, 8, 8), s, cuda) for s in (70, 71))
    ns, nb = 1.0 + 0.1 * _randn((16,), 72, cuda), 0.1 * _randn((16,), 73,
                                                              cuda)
    check(lambda *a: conv3x3_norm_silu(*a[:5], 8, 1e-5, *a[5:]),
          lambda *a: conv3x3_norm_silu_plain(*a[:5], 8, 1e-5, *a[5:]),
          [cx, cw, cb, ns, nb, g, bt])


def _training_site(name, cuda):
    """(kernel call, plain call, inputs) of one training site."""
    bf16 = torch.bfloat16
    if name == "fused-spade-bf16":          # UNet ResBlock prologue, b 32
        shape = (32, 576, 32, 32)
        x, w, b = _conv_inputs(shape, 192, cuda, bf16, 80)
        ns = 1.0 + 0.1 * _randn((576,), 83, cuda)
        nb = 0.1 * _randn((576,), 84, cuda)
        g, bt = ((0.2 * _randn(shape, s, cuda)).to(bf16) for s in (85, 86))
        return (lambda *a: conv3x3_norm_silu(*a[:5], 32, 1e-5, *a[5:]),
                lambda *a: conv3x3_norm_silu_plain(*a[:5], 32, 1e-5, *a[5:]),
                [x, w, b, ns, nb, g, bt])
    if name == "smalls-bf16":               # UNet self-attention at 16^2
        q, k, v = (_randn((32, 256, 384), s, cuda, bf16) for s in (87, 88,
                                                                   89))
        return (lambda *a: smalls_attention(*a, 384 ** -0.5),
                lambda *a: attention_plain(*a, 384 ** -0.5), [q, k, v])
    if name == "group-norm-bf16":           # bf16 encode at 256^2
        x = _randn((32, 128, 256, 256), 90, cuda, bf16)
        w = 1.0 + 0.1 * _randn((128,), 91, cuda)
        b = 0.1 * _randn((128,), 92, cuda)
        return (lambda *a: group_norm(*a, 32, 1e-6, True),
                lambda *a: group_norm_plain(*a, 32, 1e-6, True), [x, w, b])
    if name == "conv-cin3-bf16":            # encoder conv_in, bf16 encode
        return conv3x3, conv3x3_plain, list(_conv_inputs(
            (32, 3, 256, 256), 128, cuda, bf16, 93))
    bh, d, dtype = {"flash-bf16": (32, 256, bf16),     # bf16 encode, d 256
                    "flash-fp32": (6, 512, torch.float32)}[name]  # GAN dec
    q, k, v = (_randn((bh, 1024, d), s, cuda, dtype) for s in (94, 95, 96))
    return (lambda *a: flash_attention(*a, d ** -0.5),
            lambda *a: attention_plain(*a, d ** -0.5), [q, k, v])


@pytest.mark.parametrize("name", [
    "fused-spade-bf16", "smalls-bf16", "group-norm-bf16", "conv-cin3-bf16",
    "flash-bf16", "flash-fp32"])
def test_backward_at_training_sites(cuda, name):
    """At the training steps' shapes (diffusion batch 32, GAN batch 6):
    each kernel under autograd gives the plain version's gradients for one
    seeded cotangent, to every input (x, the weights, the norm affine and
    SPADE's gamma and beta included); the backward recomputes through the
    plain version in the inputs' dtype, so they agree within 1e-5 of the
    largest gradient (fp32; 2^-7 in bf16, where cuDNN may pick another
    algorithm between two calls); the forward is held to the plain version
    in fp32 with the tolerances of the kernel tests above."""
    kernel, plain, inputs = _training_site(name, cuda)
    dtype = inputs[0].dtype

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        cot = _randn(tuple(out.shape), 97, cuda, out.dtype)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    got, got_g = run(kernel)
    _, want_g = run(plain)
    torch.cuda.synchronize()
    with torch.no_grad():     # the forward against fp32, as above
        want = plain(*(t.float() for t in inputs))
    scale = _rms(want) if "conv" in name or "fused" in name else 1.0
    fwd_atol = (2.0 ** -6 if "fused" in name else 1e-4 if "conv" in name
                else 5e-5) * scale
    if dtype == torch.bfloat16 and name.startswith(("smalls", "flash")):
        fwd_atol += 2.0 ** -9 * inputs[2].float().abs().max().item()
    ok, err = _within(got, want, fwd_atol, dtype)
    assert ok, err
    del want
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for i, (a, r) in enumerate(zip(got_g, want_g)):
        assert a.shape == r.shape and a.dtype == r.dtype, i
        err = (a.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item(), (i, err)
        assert bool(torch.isfinite(a.float()).all()), i


def _fused_case(shape, cout, spade, groups, dtype, device, seed=40,
                magnitude=1.0):
    """One fused call against its plain version: (ok, max error, output)."""
    x, w, b = _conv_inputs(shape, cout, device, dtype, seed=seed)
    x = (x.float() * 1.5 * magnitude + 0.3).to(dtype)
    cin = shape[1]
    nscale = 1.0 + 0.1 * _randn((cin,), seed + 3, device)
    nbias = 0.1 * _randn((cin,), seed + 4, device)
    gamma = beta = None
    if spade:
        gamma = (0.2 * _randn(shape, seed + 5, device)).to(dtype)
        beta = (0.2 * _randn(shape, seed + 6, device)).to(dtype)
    before = conv3x3_norm_silu.launches
    got = conv3x3_norm_silu(x, w, b, nscale, nbias, groups, 1e-5, gamma, beta)
    torch.cuda.synchronize()
    assert conv3x3_norm_silu.launches == before + 1
    up = (lambda t: None if t is None else t.float())
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), nscale,
                                   nbias, groups, 1e-5, up(gamma), up(beta))
    assert got.dtype == dtype and got.shape == want.shape
    atol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * _rms(want)
    ok, err = _within(got, want, atol, dtype)
    return ok, err, got


@pytest.mark.parametrize("shape,cout,spade", [
    ((4, 960, 16, 16), 384, True),     # 16^2, the heaviest Cin there
    ((4, 1536, 8, 8), 576, True),      # 8^2: split K over 4
    ((4, 1920, 4, 4), 960, False),     # 4^2 without SPADE: split K over 9
    ((4, 576, 4, 4), 960, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_norm_silu_kernel_at_each_resolution(cuda, shape, cout,
                                                     spade, dtype):
    ok, err, _ = _fused_case(shape, cout, spade, 32, dtype, cuda)
    assert ok, err


def _conv_case(x, w, b):
    before = conv3x3.launches
    got = conv3x3(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    want = conv3x3_plain(x.float(), w.float(), b.float())
    assert got.dtype == x.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    return _within(got, want, 1e-4 * _rms(want), x.dtype)


@pytest.mark.parametrize("shape,cout", [
    ((4, 960, 8, 8), 960),      # upsample conv at 8^2: split K over 3
    ((4, 576, 16, 16), 576),    # upsample conv at 16^2
    ((4, 192, 4, 4), 128),      # a SPADE table conv at 4^2
    ((1, 1, 1, 1), 1),          # 1x1 image, Cin = Cout = 1
    ((1, 20, 3, 65), 10),       # W = 65: a one-column tail tile
    ((2, 6, 3, 65), 1),         # Cin = 6, Cout = 1
    ((1, 1, 9, 9), 10),         # Cin = 1
    ((3, 20, 1, 1), 10),        # several 1x1 images in one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_split_k_and_ragged_edges(cuda, shape, cout, dtype):
    ok, err = _conv_case(*_conv_inputs(shape, cout, cuda, dtype, seed=70))
    assert ok, err


@pytest.mark.parametrize("shape,cout,groups", [
    ((1, 20, 3, 65), 10, 4),
    ((1, 6, 1, 1), 1, 2),
    ((2, 1, 5, 7), 10, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_norm_silu_kernel_ragged_edges(cuda, shape, cout, groups,
                                               dtype):
    ok, err, _ = _fused_case(shape, cout, True, groups, dtype, cuda)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_take_unaligned_views(cuda, dtype):
    """x, weight and bias as views one element into their storage (not 16
    bytes aligned): the wrapper hands the kernel aligned copies."""
    x, w, b = _conv_inputs((2, 16, 8, 8), 24, cuda, dtype, seed=75)
    xs = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)
    xs[1:] = x.reshape(-1)
    ws = torch.empty(w.numel() + 1, device=cuda, dtype=dtype)
    ws[1:] = w.reshape(-1)
    bs = torch.empty(b.numel() + 1, device=cuda, dtype=dtype)
    bs[1:] = b
    xv, wv, bv = xs[1:].view(x.shape), ws[1:].view(w.shape), bs[1:]
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16
    ok, err = _conv_case(xv, wv, bv)
    assert ok, err
    got = conv3x3_norm_silu(xv, wv, bv, torch.ones(16, device=cuda),
                            torch.zeros(16, device=cuda), 4, 1e-5)
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(),
                                   torch.ones(16, device=cuda),
                                   torch.zeros(16, device=cuda), 4, 1e-5)
    atol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * _rms(want)
    ok, err = _within(got, want, atol, dtype)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_large_inputs(cuda, dtype):
    """Inputs of magnitude about 100: the same relative tolerances hold."""
    x, w, b = _conv_inputs((2, 64, 16, 16), 48, cuda, dtype, seed=80)
    ok, err = _conv_case((x.float() * 100).to(dtype), w, b)
    assert ok, err
    ok, err, _ = _fused_case((2, 64, 16, 16), 48, True, 32, dtype, cuda,
                             magnitude=100.0)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_are_deterministic(cuda, dtype):
    """Two calls on the same inputs give the same bits, split K included
    ([4, 1920, 4, 4] -> 960 splits K 9 ways)."""
    x, w, b = _conv_inputs((4, 960, 8, 8), 960, cuda, dtype, seed=85)
    assert torch.equal(conv3x3(x, w, b), conv3x3(x, w, b))
    _, _, one = _fused_case((4, 1920, 4, 4), 960, False, 32, dtype, cuda)
    _, _, two = _fused_case((4, 1920, 4, 4), 960, False, 32, dtype, cuda)
    assert torch.equal(one, two)


def _gn_case(shape, groups, dtype, silu, device, seed=90, x=None):
    """One group_norm call against its plain version: (ok, max error,
    output)."""
    c = shape[1]
    if x is None:
        x = (_randn(shape, seed, device) * 2.0 + 0.5).to(dtype)
    w = 1.0 + 0.1 * _randn((c,), seed + 1, device)
    b = 0.1 * _randn((c,), seed + 2, device)
    before = group_norm.launches
    got = group_norm(x, w, b, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    want = group_norm_plain(x.float(), w, b, groups, 1e-6, silu)
    assert got.dtype == dtype and got.shape == want.shape
    ok, err = _within(got, want, 5e-5, dtype)
    return ok, err, got


def _gn_plan(shape, groups, dtype):
    n, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    return group_norm_plan(n, c, groups, hw, torch.finfo(dtype).bits // 8)


@pytest.mark.parametrize("shape,groups,dtype,path", [
    ((4, 960, 4, 4), 32, torch.bfloat16, "regs"),    # 480 per run
    ((4, 192, 32, 32), 32, torch.bfloat16, "regs"),  # C/G = 6
    ((4, 256, 64, 64), 32, torch.float32, "regs"),   # 32768: 1024 threads
    ((2, 96, 2, 2), 32, torch.bfloat16, "regs"),     # 12 per run
    ((4, 512, 64, 64), 32, torch.float32, 8),
    ((4, 256, 128, 128), 32, torch.float32, 16),
    ((4, 128, 256, 256), 32, torch.float32, 16),     # the decoder's 1 MB
    ((1, 32, 512, 512), 32, torch.float32, 16),      # exactly 16 x 64 KB
    ((1, 32, 512, 513), 32, torch.float32, 0),       # just over: streamed
    ((1, 64, 768, 768), 32, torch.float32, 0),
    ((1, 32, 724, 724), 32, torch.bfloat16, 16),     # bf16, just under 1 MB
    ((2, 64, 150, 150), 32, torch.float32, 8),       # slices end mid-channel
    ((2, 64, 99, 99), 32, torch.float32, 4),         # ragged: element copies
    ((2, 64, 102, 103), 32, torch.float32, 4),       # H*W % 4 == 2: bulk copy
    ((2, 64, 5, 3), 32, torch.float32, 1),           # H*W % 4 != 0
    ((2, 128, 5, 1), 32, torch.float32, 1),          # bulk copy, H*W = 5
    ((2, 6, 7, 7), 1, torch.bfloat16, 1),            # one group of 294
])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_kernel_plan_paths(cuda, shape, groups, dtype, path,
                                      silu):
    """Each path of group_norm_plan (a run in one CTA's registers, in 1 to
    16 CTAs of a cluster in shared memory, or streamed twice) and its
    edges, in fp32 and bf16, with and without the SiLU, against the plain
    version."""
    plan = _gn_plan(shape, groups, dtype)
    assert (plan.vpt > 0 if path == "regs"
            else plan.vpt == 0 and plan.cluster == path)
    ok, err, _ = _gn_case(shape, groups, dtype, silu, cuda)
    assert ok, err


@pytest.mark.parametrize("shape,dtype", [
    ((4, 960, 4, 4), torch.bfloat16),
    ((4, 128, 256, 256), torch.float32),
])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_kernel_both_dtypes_at_the_ends(cuda, shape, dtype, silu):
    """The smallest and the largest main-path runs in the other dtype too."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for dt in (dtype, other):
        ok, err, _ = _gn_case(shape, 32, dt, silu, cuda)
        assert ok, (dt, err)


@pytest.mark.parametrize("shape", [(4, 128, 64, 64), (2, 64, 150, 150),
                                   (1, 32, 512, 512)])
def test_group_norm_kernel_constant_group_across_a_cluster(cuda, shape):
    """The clamped variance in one CTA's registers and split across a
    cluster (8 and 16 CTAs): a constant 33.3 gives the bias."""
    c = shape[1]
    x = torch.full(shape, 33.3, device=cuda)
    b = torch.linspace(-1, 1, c, device=cuda)
    got = group_norm(x, torch.ones(c, device=cuda), b, 32, 1e-6)
    assert bool(torch.isfinite(got).all())
    assert (got - b[None, :, None, None]).abs().max().item() <= 4 * 2.0 ** -8


@pytest.mark.parametrize("shape,dtype", [
    ((4, 128, 256, 256), torch.float32),
    ((4, 192, 32, 32), torch.bfloat16),
    ((1, 32, 512, 513), torch.float32),
])
def test_group_norm_kernel_is_deterministic(cuda, shape, dtype):
    """Two calls on the same inputs give the same bits (the cluster's
    partials are added in rank order)."""
    _, _, one = _gn_case(shape, 32, dtype, True, cuda, seed=95)
    _, _, two = _gn_case(shape, 32, dtype, True, cuda, seed=95)
    assert torch.equal(one, two)


@pytest.mark.parametrize("n", [1, 4096, 32769])
@pytest.mark.parametrize("k", [300, 1000, 8191, 8192])
@pytest.mark.parametrize("d", [3, 4])
def test_vq_kernel_plan_sizes(cuda, n, k, d):
    """Row counts under one tile and over a whole number of tiles, K that
    leaves pad codes in the last part, both embed dims."""
    z = _randn((n, d), 100 + d, cuda)
    e = _randn((k, d), 200 + d, cuda)
    before = vq_argmin.launches
    got = vq_argmin(z, e)
    torch.cuda.synchronize()
    assert vq_argmin.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert bool(((got >= 0) & (got < k)).all())
    assert _margin_ok(z, e, got, vq_argmin_plain(z, e))


@pytest.mark.parametrize("n,k,d", [(4096, 8192, 4), (32768, 8192, 4),
                                   (1024, 8192, 3), (77, 5000, 3)])
def test_vq_kernel_equal_codes_in_different_parts(cuda, n, k, d):
    """The same code at indices in different chunks, warps' parts and
    cluster CTAs (by the plan), nearest to every row: the lowest index
    wins."""
    plan = vq_plan(n, k, d)
    e = _randn((k, d), 300, cuda) * 10.0
    at = sorted(i for i in {3, 3 + 16, plan.ks + 5, plan.ks * plan.warps + 7,
                            k - 1} if i < k)
    target = torch.full((d,), 0.25, device=cuda)
    e[at] = target
    z = target[None] + 0.01 * _randn((n, d), 301, cuda)
    assert (vq_argmin(z, e).cpu() == at[0]).all()
    e[at[0]] = 100.0        # now the second copy is the lowest
    assert (vq_argmin(z, e).cpu() == at[1]).all()


def test_vq_kernel_is_deterministic(cuda):
    z = _randn((32768, 4), 310, cuda)
    e = _randn((8192, 4), 311, cuda)
    assert torch.equal(vq_argmin(z, e), vq_argmin(z, e))


# ---------------------------------------------------------------------------
# the layout2i f8f4 sites (configs/frido/layout2i/frido_f8f4_coco_seg.yaml):
# the decoder's attention at 64^2 (4096 tokens, d = 512, fp32), the UNet's
# one-head self-attention at 32^2 (1024 tokens, d = 384, bf16), the D = 3
# codebooks of 4096 codes over a 64^2 latent grid, the UNet's 64^2 x 192
# level at batch 4


@pytest.mark.parametrize("bh,nq,nk,d,dtype", [
    (4, 4096, 4096, 512, torch.float32),    # decoder AttnBlock, batch 4
    (4, 1024, 1024, 384, torch.bfloat16),   # UNet self-attention at 32^2
])
def test_flash_kernel_at_the_layout2i_sites(cuda, bh, nq, nk, d, dtype):
    ok, err = _attn_case(flash_attention,
                         *_qkv(bh, nq, nk, d, dtype, cuda, seed=90),
                         d ** -0.5)
    assert ok, err


@pytest.mark.parametrize("bh,nq,nk,d,dtype", [
    (4, 256, 256, 576, torch.bfloat16),    # UNet at 16^2
    (4, 256, 96, 576, torch.bfloat16),     # cross-attention over 96 tokens
    (4, 64, 96, 960, torch.bfloat16),      # 8^2
    (32, 96, 96, 64, torch.float32),       # BERT over 96 tokens
])
def test_smalls_kernel_at_the_layout2i_sites(cuda, bh, nq, nk, d, dtype):
    ok, err = _attn_case(smalls_attention,
                         *_qkv(bh, nq, nk, d, dtype, cuda, seed=95),
                         d ** -0.5)
    assert ok, err


@pytest.mark.parametrize("n", [4 * 64 * 64, 32 * 64 * 64])
def test_vq_kernel_at_the_layout2i_sites(cuda, n):
    """Batch 4 and the decode chunk of 32, against 4096 codes of D = 3."""
    z = _randn((n, 3), 110, cuda)
    e = _randn((4096, 3), 111, cuda)
    before = vq_argmin.launches
    got = vq_argmin(z, e)
    torch.cuda.synchronize()
    assert vq_argmin.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert _margin_ok(z, e, got, vq_argmin_plain(z, e))


@pytest.mark.parametrize("shape,cout", [
    ((4, 3, 64, 64), 192),      # pre_input and pre_input_cond: Cin = 3
    ((4, 192, 64, 64), 192),
    ((4, 192, 64, 64), 128),    # SPADE mlp_shared
    ((4, 128, 64, 64), 192),    # SPADE gamma / beta
    ((4, 192, 64, 64), 3),      # out head: Cout = 3
])
def test_conv3x3_kernel_at_the_layout2i_unet_sites(cuda, shape, cout):
    ok, err = _conv_case(*_conv_inputs(shape, cout, cuda, torch.bfloat16,
                                       seed=120))
    assert ok, err


@pytest.mark.parametrize("shape,spade", [
    ((4, 192, 64, 64), False),   # stage 0
    ((4, 192, 64, 64), True),    # stage 1
    ((4, 384, 64, 64), True),    # output blocks: the skip concatenated
])
def test_conv3x3_norm_silu_kernel_at_the_layout2i_unet_sites(cuda, shape,
                                                             spade):
    ok, err, _ = _fused_case(shape, 192, spade, 32, torch.bfloat16, cuda,
                             seed=130)
    assert ok, err


@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
def test_group_norm_kernel_at_the_layout2i_unet_site(cuda, eps, silu):
    """The out head's GroupNorm + SiLU at 64^2 x 192 (bf16)."""
    shape = (4, 192, 64, 64)
    x = _randn(shape, 140, cuda, torch.bfloat16)
    w = 1.0 + 0.1 * _randn((192,), 141, cuda)
    b = 0.1 * _randn((192,), 142, cuda)
    before = group_norm.launches
    got = group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    want = group_norm_plain(x.float(), w, b, 32, eps, silu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ok, err = _within(got, want, 5e-5, torch.bfloat16)
    assert ok, err
