"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the decision is
made inside the ``cuda`` fixture, never at import). The file imports only
torch and the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Flash is held to the plain version in fp32 on the same inputs (bf16
inputs are upcast exactly). Tolerance: 5e-5 absolute (fp32 sums over
<= 1024 keys taken in another order; TF32 off), plus, for bf16, 2^-8 of
the reference at each element: the kernel computes in fp32 and rounds its
output to bf16 once, which costs at most half of that. VQ indices must be
equal wherever the best and second-best distances differ by more than
1e-5.
"""

import numpy as np
import pytest
import torch

from frido_tpu_torch.ops.cuda.attention import attention_plain, flash_attention
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("bh,nq,nk,d", [
    (2, 1024, 1024, 512),   # decoder AttnBlock site
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
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -8
    err = (got.float() - want).abs()
    assert bool((err <= 5e-5 + rtol * want.abs()).all()), err.max().item()


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
