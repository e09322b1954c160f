"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the t2i chain of ``configs/frido/t2i/frido_f16f8_coco.yaml``
at full width: token ids -> BERT context -> PLMS with classifier-free
guidance 1.5 (sequential) and a bf16 UNet over two pyramid stages ->
MS-VQGAN decode (per-scale VQ re-quantization, post_quant_conv, the 256^2
conv decoder). Weights are random, made from a seed; the zero-initialised
output convs get a seeded random init too, so the UNet does not predict 0.
It runs twice: in the default configuration (flash attention and the VQ
argmin on their kernels), and in the JAX package's all-kernel
configuration (``FRIDO_CONV_MODE=pallas_fused FRIDO_GN_PALLAS=1
FRIDO_SMALLS_ATTN=1``), where GroupNorm, short-sequence attention, every
3x3 conv and every fused ResBlock prologue take their kernels too.

Phases, in order; any failure exits non-zero and nothing is caught:

1. setup: card, power limit, versions, TF32 flags, kernel build time;
2. each hand-written kernel at main-path shapes against its plain PyTorch
   version: error, and kernel / plain / library-call times (CUDA events),
   beside the least time the card could take (``bound_ms``);
3. a toy-width model on the card against the same model on the CPU (the
   plain path, which the CPU tests hold to the JAX package), in both
   configurations;
4. the full-width main path in each configuration, with every kernel's
   launch count set to 0 just before and read just after, and held to the
   count the architecture gives.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one ``{"kernels": [...]}``
line. Without CUDA, or outside the repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
             "is False")

REPO = pathlib.Path(__file__).resolve().parent
if not (REPO / "frido_tpu_torch" / "__init__.py").exists():
    sys.exit(f"chip_smoke.py must run from the repository: no "
             f"frido_tpu_torch/ beside {__file__}")
sys.path.insert(0, str(REPO))

import torch.nn.functional as F  # noqa: E402

from frido_tpu_torch.config import instantiate_from_config, load_yaml  # noqa: E402,E501
from frido_tpu_torch.nn.layers import Conv2d, GroupNorm  # noqa: E402
from frido_tpu_torch.nn.pyunet import ResBlock, UNetUpsample  # noqa: E402
from frido_tpu_torch.nn.quantize import VectorQuantizer  # noqa: E402
from frido_tpu_torch.nn.transformer import SpatialTransformer  # noqa: E402
from frido_tpu_torch.nn.vqgan import AttnBlock  # noqa: E402
from frido_tpu_torch.nn.xtransformer import XAttention  # noqa: E402
from frido_tpu_torch.ops.cuda import build  # noqa: E402
from frido_tpu_torch.ops.cuda.attention import (  # noqa: E402
    attention_plain, flash_attention, smalls_attention)
from frido_tpu_torch.ops.cuda.conv import (  # noqa: E402
    conv3x3, conv3x3_norm_silu, conv3x3_norm_silu_plain, conv3x3_plain,
    conv_plan)
from frido_tpu_torch.ops.cuda.norm import group_norm, group_norm_plain  # noqa: E402,E501
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain  # noqa: E402,E501

T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml"

# Published peaks of one H100 SXM (dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # tf32 tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores
PEAK_BYTES = 3.35e12         # HBM3

# main path, as bench.py runs it (batch 4 and 50 steps here, to stay short;
# the all-kernel configuration 20 steps)
BATCH = 4
STEPS = 50
ALL_KERNEL_STEPS = 20
ALL_KERNELS = {"FRIDO_CONV_MODE": "pallas_fused", "FRIDO_GN_PALLAS": "1",
               "FRIDO_SMALLS_ATTN": "1"}
# the t2i architecture's sites, as counted from the model: 22 ResBlocks (2
# per level x 4 in, 2 in the middle, 3 per level x 4 out), 16
# SpatialTransformers (levels 1-3: 6 in, 1 middle, 9 out), 3 upsample
# convs, 32 BERT layers; the decoder's 33 3x3 convs (conv_in, 2 per
# ResnetBlock x 14, 3 upsample, conv_out), 33 GroupNorms (2 per
# ResnetBlock, 1 per AttnBlock, norm_out), 4 AttnBlocks, 2 codebooks
T2I_ARCH = dict(res_blocks=22, transformers=16, upsamples=3, bert_layers=32,
                first_stage_3x3=33, first_stage_norms=33, first_stage_attn=4,
                codebooks=2)
GUIDANCE = 1.5
DECODE_CHUNK = 32
CTX_LEN = 77
PROFILE_STEPS = 4   # a short chain under torch.profiler, for the breakdown
# kernel phases at the shapes the main path gives the kernels: flash at
# the benchmark's decode chunk of 32 ([32, 1024, 512], the row) and at this
# script's batch of 4; VQ N = 32*32*32
FLASH_SHAPE = (32, 1024, 512)
VQ_N, VQ_K, VQ_D = 32 * 32 * 32, 8192, 4

# Tolerances, fixed before the first run.
# Every kernel against its plain version in fp32 on the same (exactly
# upcast) inputs, as the card tests; for bf16 each adds 2^-8 of the
# reference at each element (one rounding of the kernel's fp32 result to
# bf16 costs at most half of that).
# Both attention kernels: 5e-5 (fp32 sums in another order; their fp32
# products are 3xTF32, which drops only about 2^-22 of each), and in bf16
# + 2^-9 max|v|: they round P to bf16 before P.V as the Pallas kernels do
# (flash each key tile's un-normalised exp(s - m), smalls the normalised
# row), which moves an output by at most that.
ATTN_ATOL = 5e-5
VQ_DIST_ATOL = 1e-5        # a kernel pick may differ only within a near tie
BF16_RTOL = 2.0 ** -8
GN_ATOL = 5e-5             # fp32 group sums in another order
CONV_ATOL_RMS = 1e-4       # of the output's RMS: K <= 17280 fp32 terms
# the fused prologue's output is rounded to bf16 before the conv: each of
# the K terms carries up to 2^-9 of itself, ~0.6 * 2^-9 of the output RMS
# per element, under 2^-6 of it at 5 sigma
FUSED_BF16_ATOL_RMS = 2.0 ** -6
TOY_LATENT_ATOL = 1e-3     # ten fp32 UNet calls per stage, CPU vs card sums
TOY_IMAGE_ATOL = 1e-3      # fp32 decoder, cuDNN vs CPU conv sum order


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, peak_ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    and bytes over the memory rate."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def seeded(shape, seed, dtype=torch.float32, device="cuda"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def randomize_zero_init_(model, seed):
    """Give every zero-initialised conv a seeded U(-1/sqrt(fan_in), ...)
    init, else the UNet's eps-hat and its SpatialTransformers' outputs
    are trivially 0."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv2d) and mod.zero_init:
                bound_ = 1.0 / math.sqrt(mod.fan_in)
                mod.weight.uniform_(-bound_, bound_, generator=gen)
                n += 1
    if n == 0:
        raise RuntimeError("no zero-initialised conv found")
    return n


# ---------------------------------------------------------------------------
def setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32 set off: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    reports = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(reports) or 'nothing (all built already)'}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def flash_phase():
    """The decode chunk's fp32 site gives the row; the main path's batch
    of 4 and the kernel's bf16 form (off the main path) are checked and
    timed too."""
    b, n, d = FLASH_SHAPE
    row = None
    for shape, dtype in (((b, n, d), torch.float32),
                         ((BATCH, n, d), torch.float32),
                         ((b, n, d), torch.bfloat16)):
        q, k, v = (seeded(shape, s, dtype) for s in (10, 11, 12))
        scale = d ** -0.5
        got = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = attention_plain(q.float(), k.float(), v.float(), scale)
        err, tol = check_close(f"flash {dtype} {list(shape)}", got, want,
                               attn_atol(v, dtype), dtype)
        ms = cuda_ms(lambda: flash_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        itemsize = torch.finfo(dtype).bits // 8
        bounded = matmul_bound(4 * shape[0] * n * n * d, dtype,
                               4 * shape[0] * n * d * itemsize)
        log(f"flash_attention {dtype} q,k,v {list(shape)}: max_abs_err "
            f"{err:.3e} (tol {tol}), output max "
            f"{want.abs().max().item():.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
            f"{describe_bound(bounded)}")
        if row is None:
            row = kernel_row("flash_attention",
                             "frido_tpu_torch/csrc/flash_attention.cu",
                             "frido_tpu/ops/pallas/attention.py:301", err, ms,
                             plain_ms, bounded, library_ms)
    return row


def vq_phase():
    z = seeded((VQ_N, VQ_D), 20)
    e = seeded((VQ_K, VQ_D), 21)
    got = vq_argmin(z, e)
    torch.cuda.synchronize()
    want = vq_argmin_plain(z, e)
    # error: how much farther the kernel's pick is than the plain pick, by
    # the kernel's own distance, in float64
    z64, e64 = z.double(), e.double()
    esq = (e64 * e64).sum(1)

    def dist(idx):
        sel = e64[idx.long()]
        return esq[idx.long()] - 2 * (z64 * sel).sum(1)

    err = (dist(got) - dist(want)).abs().max().item()
    if got.dtype != torch.int32 or got.shape != (VQ_N,):
        raise AssertionError(f"vq_argmin gave {got.dtype} {tuple(got.shape)}")
    if not err <= VQ_DIST_ATOL:
        raise AssertionError(f"vq_argmin: distance of kernel pick vs plain "
                             f"pick differs by {err} > {VQ_DIST_ATOL}")
    ms = cuda_ms(lambda: vq_argmin(z, e))
    plain_ms = cuda_ms(lambda: vq_argmin_plain(z, e))
    library_ms = cuda_ms(lambda: torch.cdist(z, e).argmin(dim=1))
    # per (row, code): D multiply-adds and one compare; |e|^2 once per code
    ops = VQ_N * VQ_K * (2 * VQ_D + 1) + VQ_K * 2 * VQ_D
    nbytes = 4 * (VQ_N * VQ_D + VQ_K * VQ_D + VQ_N)
    bound_ms, bound_by = bound(ops, PEAK_FP32_FLOPS, nbytes)
    same = (got == want).float().mean().item()
    row = dict(name="vq_argmin", route="cuda",
               source="frido_tpu_torch/csrc/vq_argmin.cu",
               replaces="frido_tpu/ops/pallas/vq_pallas.py:74",
               launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log(f"vq_argmin z [{VQ_N}, {VQ_D}] codebook [{VQ_K}, {VQ_D}]: same index "
        f"{same:.6f} of rows, max distance gap {err:.3e} (tol "
        f"{VQ_DIST_ATOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+argmin {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return row


def check_close(name, got, want, atol, dtype):
    """Raise unless |kernel - plain| <= atol (+ 2^-8 |plain| for bf16)
    everywhere; return the max error and the tolerance as text."""
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want).abs()
    err = diff.max().item()
    tol = f"{atol:.3e}" + (f" + {rtol:.5f}*|plain|" if rtol else "")
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: |kernel - plain| exceeds {tol} "
                             f"(max {err})")
    return err, tol


def rms(t):
    return t.float().square().mean().sqrt().item()


def matmul_bound(ops, dtype, nbytes):
    """bound() for matmul-shaped work (attention, conv) in ``dtype``.

    bf16: the operations at the bf16 tensor-core peak. fp32: 3xTF32 is the
    fastest fp32-accurate route on this card (each product split into
    tf32 hi + lo, three tf32 products: attention_mma.cuh), so 3 x the
    operations at the TF32 peak, 2.5x lower than the operations at the
    67 TFLOP/s fp32 CUDA-core rate. That older figure rides along as the
    third element, so the log shows both."""
    if dtype == torch.float32:
        return bound(3 * ops, PEAK_TF32_FLOPS, nbytes) + (
            ops / PEAK_FP32_FLOPS * 1e3,)
    return bound(ops, PEAK_BF16_FLOPS, nbytes) + (None,)


def describe_bound(bounded):
    text = f"bound {bounded[0]:.4f} ms ({bounded[1]})"
    if bounded[2] is not None:
        text += f" [fp32 CUDA cores: {bounded[2]:.4f} ms]"
    return text


def attn_atol(v, dtype):
    return ATTN_ATOL + (0.0 if dtype == torch.float32 else
                        2.0 ** -9 * v.float().abs().max().item())


def kernel_row(name, source, replaces, err, ms, plain_ms, bounded,
               library_ms):
    bound_ms, bound_by = bounded[:2]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def group_norm_phase():
    """The heaviest site, the decoder's 256^2 fp32 norms (+SiLU), gives the
    row; the UNet's sites are checked too. The library call is
    F.group_norm, which has no SiLU: it times less work than the kernel."""
    sites = [  # (shape, dtype, eps, silu)
        ((BATCH, 128, 256, 256), torch.float32, 1e-6, True),   # decoder
        ((BATCH, 192, 32, 32), torch.bfloat16, 1e-5, True),    # out head
        ((BATCH, 384, 16, 16), torch.bfloat16, 1e-6, False),   # ST norm
        ((BATCH, 960, 4, 4), torch.bfloat16, 1e-6, False),
    ]
    row = None
    for shape, dtype, eps, silu in sites:
        c = shape[1]
        x = seeded(shape, 40, dtype)
        w = 1.0 + 0.1 * seeded((c,), 41)
        b = 0.1 * seeded((c,), 42)
        got = group_norm(x, w, b, 32, eps, silu)
        torch.cuda.synchronize()
        want = group_norm_plain(x.float(), w, b, 32, eps, silu)
        err, tol = check_close(f"group_norm {dtype} {list(shape)}", got, want,
                               GN_ATOL, dtype)
        ms = cuda_ms(lambda: group_norm(x, w, b, 32, eps, silu))
        plain_ms = cuda_ms(lambda: group_norm_plain(x, w, b, 32, eps, silu))
        wl, bl = w.to(dtype), b.to(dtype)
        library_ms = cuda_ms(lambda: F.group_norm(x, 32, wl, bl, eps))
        n = x.numel()
        itemsize = torch.finfo(dtype).bits // 8
        # per element: 3 for the sums, 2 for the affine, 3 for the SiLU
        bounded = bound((8 if silu else 5) * n, PEAK_FP32_FLOPS,
                        2 * n * itemsize + 8 * c)
        log(f"group_norm {dtype} x {list(shape)} eps {eps} silu {silu}: "
            f"max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.group_norm (no SiLU) {library_ms:.4f} ms, "
            f"bound {bounded[0]:.4f} ms ({bounded[1]})")
        if row is None:
            row = kernel_row("group_norm", "frido_tpu_torch/csrc/group_norm.cu",
                             "frido_tpu/ops/pallas/norm_pallas.py:130", err,
                             ms, plain_ms, bounded, library_ms)
    return row


def smalls_phase():
    """The heaviest site, the UNet's 256-token bf16 self-attention with one
    head of d = 384, gives the row; the other sites are checked too."""
    sites = [  # (bh, nq, nk, d, dtype)
        (BATCH, 256, 256, 384, torch.bfloat16),   # self, 32^2 / 2
        (BATCH, 256, CTX_LEN, 384, torch.bfloat16),   # cross
        (BATCH, 64, 64, 576, torch.bfloat16),     # self at 8x8, d = 576
        (BATCH, 64, CTX_LEN, 576, torch.bfloat16),
        (BATCH, 16, 16, 960, torch.bfloat16),     # self at 4x4, d = 960
        (BATCH, 16, CTX_LEN, 960, torch.bfloat16),
        (BATCH * 8, CTX_LEN, CTX_LEN, 64, torch.float32),   # BERT
    ]
    row = None
    for bh, nq, nk, d, dtype in sites:
        q = seeded((bh, nq, d), 43, dtype)
        k = seeded((bh, nk, d), 44, dtype)
        v = seeded((bh, nk, d), 45, dtype)
        scale = d ** -0.5
        got = smalls_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = attention_plain(q.float(), k.float(), v.float(), scale)
        err, tol = check_close(f"smalls_attention {dtype} {[bh, nq, nk, d]}",
                               got, want, attn_atol(v, dtype), dtype)
        ms = cuda_ms(lambda: smalls_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        itemsize = torch.finfo(dtype).bits // 8
        bounded = matmul_bound(4 * bh * nq * nk * d, dtype,
                               (2 * nq + 2 * nk) * bh * d * itemsize)
        log(f"smalls_attention {dtype} bh {bh} nq {nq} nk {nk} d {d}: "
            f"max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
            f"{describe_bound(bounded)}")
        if row is None:
            row = kernel_row("smalls_attention",
                             "frido_tpu_torch/csrc/smalls_attention.cu",
                             "frido_tpu/ops/pallas/attention.py:282", err, ms,
                             plain_ms, bounded, library_ms)
    return row


def conv_operands(shape, cout, dtype, seed):
    cin = shape[1]
    x = seeded(shape, seed, dtype)
    w = (seeded((cout, cin, 3, 3), seed + 1) / math.sqrt(9 * cin)).to(dtype)
    b = (0.1 * seeded((cout,), seed + 2)).to(dtype)
    return x, w, b


def conv_bytes(shape, cout, itemsize):
    n, cin, h, w = shape
    return (n * cin * h * w + cout * cin * 9 + cout + n * cout * h * w) \
        * itemsize


def conv3x3_phase():
    """The heaviest site, the decoder's 256^2 fp32 conv, gives the row; the
    UNet's bf16 sites with Cin = 4 and Cout = 4 and its three upsample
    convs are checked too. The library call is F.conv2d (cuDNN, TF32
    off)."""
    sites = [  # (shape, cout, dtype)
        ((BATCH, 128, 256, 256), 128, torch.float32),   # decoder
        ((BATCH, 384, 32, 32), 384, torch.bfloat16),    # upsample conv, 32^2
        ((BATCH, 576, 16, 16), 576, torch.bfloat16),    # upsample conv, 16^2
        ((BATCH, 960, 8, 8), 960, torch.bfloat16),      # upsample conv, 8^2
        ((BATCH, 4, 32, 32), 192, torch.bfloat16),      # pre_input
        ((BATCH, 192, 32, 32), 4, torch.bfloat16),      # out head
    ]
    row = None
    for shape, cout, dtype in sites:
        x, w, b = conv_operands(shape, cout, dtype, 50)
        got = conv3x3(x, w, b)
        torch.cuda.synchronize()
        want = conv3x3_plain(x.float(), w.float(), b.float())
        err, tol = check_close(f"conv3x3 {dtype} {list(shape)}->{cout}", got,
                               want, CONV_ATOL_RMS * rms(want), dtype)
        ms = cuda_ms(lambda: conv3x3(x, w, b))
        plain_ms = cuda_ms(lambda: conv3x3_plain(x, w, b))
        library_ms = cuda_ms(lambda: F.conv2d(x, w, b, 1, 1))
        n, cin, h, wd = shape
        itemsize = torch.finfo(dtype).bits // 8
        bounded = matmul_bound(2 * n * h * wd * cout * 9 * cin, dtype,
                               conv_bytes(shape, cout, itemsize))
        log(f"conv3x3 {dtype} x {list(shape)} -> {cout}: max_abs_err "
            f"{err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.conv2d {library_ms:.4f} ms, "
            f"{describe_bound(bounded)}; plan {conv_plan_of(x, cout)}")
        if row is None:
            row = kernel_row("conv3x3", "frido_tpu_torch/csrc/conv3x3.cu",
                             "frido_tpu/ops/pallas/conv_pallas.py:177", err,
                             ms, plain_ms, bounded, library_ms)
    return row


def conv_plan_of(x, cout, fused=False, spade=False):
    """The kernel's host plan for x -> cout, as printed beside its time."""
    p = conv_plan(*x.shape, cout, x.element_size(), fused, spade)
    return (f"grid {list(p.grid)}, {32 * p.nt}-pixel tile, split "
            f"{p.split}, {p.smem} B shared")


def fused_operands(shape, cout, spade, seed):
    """x, weight, bias, the norm affine and (with SPADE) the tables."""
    dtype = torch.bfloat16
    x, w, b = conv_operands(shape, cout, dtype, seed)
    cin = shape[1]
    ns = 1.0 + 0.1 * seeded((cin,), seed + 3)
    nb = 0.1 * seeded((cin,), seed + 4)
    g = bt = None
    if spade:
        g = (0.2 * seeded(shape, seed + 5)).to(dtype)
        bt = (0.2 * seeded(shape, seed + 6)).to(dtype)
    return x, w, b, ns, nb, g, bt


def conv3x3_norm_silu_phase():
    """The heaviest prologue, [4, 576, 32, 32] -> 192 with SPADE (stage 1),
    gives the row; the heaviest one at each other resolution of the UNet
    is checked and timed too. No single library call computes the fused
    op: library_ms is null; F.conv2d of the conv alone (no prologue) on the
    same shape is printed beside each."""
    sites = [  # (shape, cout, spade)
        ((BATCH, 576, 32, 32), 192, True),
        ((BATCH, 960, 16, 16), 384, True),
        ((BATCH, 1536, 8, 8), 576, True),
        ((BATCH, 1920, 4, 4), 960, True),
        ((BATCH, 1920, 4, 4), 960, False),
    ]
    dtype = torch.bfloat16
    row = None
    for shape, cout, spade in sites:
        x, w, b, ns, nb, g, bt = fused_operands(shape, cout, spade, 60)
        args = (x, w, b, ns, nb, 32, 1e-5, g, bt)
        got = conv3x3_norm_silu(*args)
        torch.cuda.synchronize()
        up = (lambda t: None if t is None else t.float())
        want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), ns,
                                       nb, 32, 1e-5, up(g), up(bt))
        err, tol = check_close(
            f"conv3x3_norm_silu {list(shape)}->{cout}", got, want,
            FUSED_BF16_ATOL_RMS * rms(want), dtype)
        ms = cuda_ms(lambda: conv3x3_norm_silu(*args))
        plain_ms = cuda_ms(lambda: conv3x3_norm_silu_plain(*args))
        alone_ms = cuda_ms(lambda: F.conv2d(x, w, b, 1, 1))
        n, cin, h, wd = shape
        itemsize = torch.finfo(dtype).bits // 8
        # the conv's products, and per input element 3 for the statistics,
        # 2 for the affine, 2 for SPADE and 3 for the SiLU
        ops = (2 * n * h * wd * cout * 9 * cin
               + (10 if spade else 8) * x.numel())
        nbytes = conv_bytes(shape, cout, itemsize) + 8 * cin + (
            2 * x.numel() * itemsize if spade else 0)
        bounded = bound(ops, PEAK_BF16_FLOPS, nbytes)
        split = conv_plan(*shape, cout, itemsize, True, spade).split > 1
        launches = "statistics, pack, conv" + (", reduce" if split else "")
        log(f"conv3x3_norm_silu {dtype} x {list(shape)} -> {cout} spade "
            f"{spade}: max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms "
            f"(one call: {launches}), "
            f"plain {plain_ms:.4f} ms, no library call (conv alone, no "
            f"prologue: F.conv2d {alone_ms:.4f} ms), bound {bounded[0]:.4f} "
            f"ms ({bounded[1]}); plan {conv_plan_of(x, cout, True, spade)}")
        if row is None:
            row = kernel_row("conv3x3_norm_silu",
                             "frido_tpu_torch/csrc/conv3x3.cu",
                             "frido_tpu/ops/pallas/conv_pallas.py:376", err,
                             ms, plain_ms, bounded, None)
    return row


def unet_conv_sites(model):
    """Every 3x3 conv of one all-kernel UNet call (stage 1, batch 4), as
    the model makes them: {(shape, cout, fused, spade): count}."""
    sites = {}

    def hook(mod, args, kwargs, out):
        fused = kwargs.get("fused_norm")
        key = (tuple(args[0].shape), mod.weight.shape[0], fused is not None,
               fused is not None and fused.get("gamma") is not None)
        sites[key] = sites.get(key, 0) + 1

    unet = model.model.diffusion_model
    x = seeded((BATCH, 32, 32, 8), 31, torch.bfloat16)
    t = torch.full((BATCH,), 500, device="cuda")
    with torch.no_grad(), all_kernels():
        ctx = model.get_learned_conditioning(
            np.zeros((BATCH, CTX_LEN), np.int64)).to(torch.bfloat16)
        tables = model.spade_tables(x[..., :4], 1)   # once per stage
        handles = [m.register_forward_hook(hook, with_kwargs=True)
                   for m in unet.modules()
                   if isinstance(m, Conv2d) and m.is_3x3_same]
        try:
            model.apply_model(x, t, ctx, 1, tables)
        finally:
            for h in handles:
                h.remove()
    return sites


def unet_conv_sum_phase(model):
    """The kernels' time summed over one UNet call's conv sites against
    F.conv2d's on the same shapes (the fused sites' F.conv2d without the
    prologue: cuDNN has no such call)."""
    sites = unet_conv_sites(model)
    calls = sum(sites.values())
    want = 2 * T2I_ARCH["res_blocks"] + 1 + T2I_ARCH["upsamples"] + 1
    if calls != want:
        raise AssertionError(f"one UNet call ran {calls} 3x3 convs, "
                             f"expected {want}: {sites}")
    kernel = library = 0.0
    for (shape, cout, fused, spade), count in sorted(sites.items()):
        if fused:
            x, w, b, ns, nb, g, bt = fused_operands(shape, cout, spade, 70)
            ms = cuda_ms(lambda: conv3x3_norm_silu(x, w, b, ns, nb, 32, 1e-5,
                                                   g, bt))
        else:
            x, w, b = conv_operands(shape, cout, torch.bfloat16, 70)
            ms = cuda_ms(lambda: conv3x3(x, w, b))
        lib = cuda_ms(lambda: F.conv2d(x, w, b, 1, 1))
        kernel += count * ms
        library += count * lib
    log(f"UNet call's {calls} conv sites ({len(sites)} distinct; batch "
        f"{BATCH}, bf16, stage 1): kernels {kernel:.3f} ms in all, F.conv2d "
        f"{library:.3f} ms (the 44 fused sites' F.conv2d without the "
        f"prologue), ratio {kernel / library:.2f}")


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def all_kernels():
    """The JAX package's all-kernel configuration, for the block."""
    saved = {k: os.environ.get(k) for k in ALL_KERNELS}
    os.environ.update(ALL_KERNELS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


KERNELS = {"flash_attention": flash_attention, "vq_argmin": vq_argmin,
           "group_norm": group_norm, "smalls_attention": smalls_attention,
           "conv3x3": conv3x3, "conv3x3_norm_silu": conv3x3_norm_silu}


def zero_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


# ---------------------------------------------------------------------------
def toy_config():
    """The t2i configuration cut to toy widths; the decoder keeps one
    1024-token attention (so the flash kernel runs) and the real
    8192-entry codebooks."""
    cfg = copy.deepcopy(load_yaml(str(T2I))["model"])
    p = cfg["params"]
    p["image_size"] = 32
    p["unet_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
        attention_resolutions=[2], num_head_channels=16, context_dim=32)
    p["first_stage_config"]["params"]["ddconfig"].update(
        ch=32, ch_mult=[1, 1], num_res_blocks=1, attn_resolutions=[32],
        resolution=64)
    p["cond_stage_config"]["params"].update(n_embed=32, n_layer=1)
    return cfg


def toy_phase(label):
    """The toy model on the card (kernels) against the same weights on the
    CPU (plain versions), in the current configuration; returns the
    launches of the card run."""
    cfg = toy_config()
    cpu = instantiate_from_config(cfg, device="cpu", seed=1)
    randomize_zero_init_(cpu, 2)
    gpu = instantiate_from_config(cfg, seed=1)
    gpu.load_state_dict(cpu.state_dict(), strict=True)

    tokens = np.random.default_rng(3).integers(0, 30522, (2, CTX_LEN))
    x_init = seeded((2, 32, 32, 8), 4, device="cpu")
    latents = []
    zero_launches()
    for model in (cpu, gpu):
        ctx = model.get_learned_conditioning(tokens)
        uctx = model.get_learned_conditioning(np.zeros_like(tokens))
        z = model.sample(2, context=ctx, uncond_context=uctx, steps=4,
                         guidance_scale=GUIDANCE, x_init=x_init,
                         cfg_mode="sequential")
        latents.append(z.cpu())
    lat_err = (latents[0] - latents[1]).abs().max().item()
    if not lat_err <= TOY_LATENT_ATOL:
        raise AssertionError(f"toy latent card vs CPU {lat_err} > "
                             f"{TOY_LATENT_ATOL}")

    # codes and images from the CPU latent on both sides; the images are
    # compared from the CPU's codes, so that a near-tie code flip between
    # the two argmins cannot reach the image comparison
    z = cpu._scale_latent(latents[0], invert=True)
    n_attn = sum(isinstance(m, AttnBlock) for m in gpu.modules())
    fl0, vq0 = flash_attention.launches, vq_argmin.launches
    with torch.no_grad():
        _, codes_c = cpu.first_stage_model.decode_interface(
            z, return_code=True)
        _, codes_g = gpu.first_stage_model.decode_interface(
            z.cuda(), return_code=True)
    got = (flash_attention.launches - fl0, vq_argmin.launches - vq0)
    if got != (n_attn, 2):
        raise AssertionError(f"toy decode launched (flash, VQ) {got}, "
                             f"expected ({n_attn}, 2)")
    decided = 0
    for i, (cc, cg) in enumerate(zip(codes_c, codes_g)):
        book = cpu.first_stage_model.ms_quantize[i].embedding.weight.double()
        zz = z[..., 4 * i:4 * i + 4].reshape(-1, 4).double()
        dist = (book * book).sum(1)[None] - 2 * zz @ book.t()
        top2 = dist.topk(2, dim=1, largest=False).values
        keep = (top2[:, 1] - top2[:, 0]) > 1e-5
        decided += int(keep.sum())
        if not bool((cc.reshape(-1)[keep] == cg.cpu().reshape(-1)[keep])
                    .all()):
            raise AssertionError(f"toy codes of scale {i} differ at a "
                                 f"decided row")
    quant = torch.cat([
        cpu.first_stage_model.ms_quantize[i].embedding.weight[codes_c[i].long()]
        for i in (1, 0)], dim=-1).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        img_c = cpu.first_stage_model.decode(quant)
        img_g = gpu.first_stage_model.decode(quant.cuda()).cpu()
    img_err = (img_c - img_g).abs().max().item()
    if not img_err <= TOY_IMAGE_ATOL:
        raise AssertionError(f"toy image card vs CPU {img_err} > "
                             f"{TOY_IMAGE_ATOL}")
    launches = read_launches()
    log(f"toy model card vs CPU ({label}): latent max_abs_err {lat_err:.3e} "
        f"(tol {TOY_LATENT_ATOL}), codes equal at {decided} decided rows, "
        f"image max_abs_err {img_err:.3e} (tol {TOY_IMAGE_ATOL}), image range "
        f"[{img_c.min().item():.3f}, {img_c.max().item():.3f}], launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_main_path(model, seed, steps):
    """tokens -> context -> PLMS -> decode, as bench.py's pipeline; returns
    (image, latent, phase seconds)."""
    tokens = np.zeros((BATCH, CTX_LEN), np.int64)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    (ctx, uctx), t_cond = timed(lambda: (
        model.get_learned_conditioning(tokens),
        model.get_learned_conditioning(tokens)))
    z, t_sample = timed(lambda: model.sample(
        BATCH, context=ctx, uncond_context=uctx, steps=steps,
        guidance_scale=GUIDANCE,
        compute_dtype=torch.bfloat16, cfg_mode="sequential", generator=gen))
    img, t_decode = timed(lambda: model.decode_first_stage(
        z, chunk=DECODE_CHUNK))
    return img, z, dict(cond=t_cond, sample=t_sample, decode=t_decode)


def architecture(model, steps):
    """The sites of the model that the kernels serve, counted from its
    modules, and the UNet calls of a PLMS run of ``steps`` steps."""
    unet = model.model.diffusion_model
    first = model.first_stage_model
    return dict(
        res_blocks=count(unet, ResBlock),
        transformers=count(unet, SpatialTransformer),
        upsamples=sum(isinstance(m, UNetUpsample) and m.conv is not None
                      for m in unet.modules()),
        bert_layers=count(model.cond_stage_model, XAttention),
        first_stage_3x3=sum(isinstance(m, Conv2d) and m.is_3x3_same
                            for m in first.modules()),
        first_stage_norms=count(first, GroupNorm),
        first_stage_attn=count(first, AttnBlock),
        codebooks=count(first, VectorQuantizer),
        # each of the stages takes steps + 1 eps evaluations (PLMS peels
        # step 0 into two), each two UNet calls (CFG sequential)
        unet_calls=model.num_stage * (steps + 1) * 2,
        table_stages=model.num_stage - 1)


def expected_launches(arch, all_kernel):
    """Each kernel's launches in one main-path run.

    Per UNet call in the all-kernel configuration: 2 fused prologues per
    ResBlock; 3x3 convs at pre_input, each upsample and the out head; a
    GroupNorm in each SpatialTransformer and the out head; a self- and a
    cross-attention in each SpatialTransformer. Once per stage after the
    first, the SPADE tables: the pre_input_cond conv and three 3x3 convs
    at each SPADE site (2 per ResBlock, 1 per SpatialTransformer). BERT:
    one attention per layer for each of the 2 conditionings. Decode, once
    per chunk: every 3x3 conv and GroupNorm of the first stage, a flash
    attention per AttnBlock (1024 tokens), a VQ argmin per codebook."""
    a = arch
    chunks = BATCH // DECODE_CHUNK if (BATCH > DECODE_CHUNK and
                                       BATCH % DECODE_CHUNK == 0) else 1
    want = dict(flash_attention=a["first_stage_attn"] * chunks,
                vq_argmin=a["codebooks"] * chunks, group_norm=0,
                smalls_attention=0, conv3x3=0, conv3x3_norm_silu=0)
    if all_kernel:
        calls = a["unet_calls"]
        want.update(
            conv3x3_norm_silu=2 * a["res_blocks"] * calls,
            conv3x3=((1 + a["upsamples"] + 1) * calls
                     + a["table_stages"] * (
                         1 + 3 * (2 * a["res_blocks"] + a["transformers"]))
                     + a["first_stage_3x3"] * chunks),
            group_norm=((a["transformers"] + 1) * calls
                        + a["first_stage_norms"] * chunks),
            smalls_attention=(2 * a["transformers"] * calls
                              + 2 * a["bert_layers"]))
    return want


def count(module, cls):
    return sum(isinstance(m, cls) for m in module.modules())


def main_path_phase(card, model, label, steps):
    all_kernel = label == "all-kernel"
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    img, z, secs = drive_main_path(model, seed=0, steps=steps)
    launches = read_launches()
    arch = architecture(model, steps)
    if {k: arch[k] for k in T2I_ARCH} != T2I_ARCH:
        raise AssertionError(f"the t2i model has {arch}, not {T2I_ARCH}")
    want = expected_launches(arch, all_kernel)
    log(f"main path ({label}) launches {launches}; from the architecture "
        f"{arch}: {want}")
    if launches != want:
        raise AssertionError(f"main path ({label}) launches {launches}, "
                             f"expected {want}")
    if tuple(img.shape) != (BATCH, 256, 256, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if tuple(z.shape) != (BATCH, 32, 32, 8):
        raise AssertionError(f"latent shape {tuple(z.shape)}")
    if not (bool(torch.isfinite(img).all()) and
            bool(torch.isfinite(z).all())):
        raise AssertionError("non-finite latent or image")
    spread = img.float().std().item()
    if not spread > 1e-4:
        raise AssertionError(f"constant image (std {spread})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    _, _, warm = drive_main_path(model, seed=1, steps=steps)
    for run, s in (("first run", secs), ("second run", warm)):
        total = sum(s.values())
        log(f"main path ({label}) {run} on {card}: batch {BATCH}, PLMS "
            f"{steps} steps x 2 stages, CFG {GUIDANCE} sequential, bf16 "
            f"UNet: cond {s['cond']:.3f} s, sample {s['sample']:.3f} s, "
            f"decode {s['decode']:.3f} s, total {total:.3f} s, "
            f"{BATCH / total:.4f} img/s")
    log(f"main path ({label}): image std {spread:.4f}, range "
        f"[{img.min().item():.3f}, {img.max().item():.3f}], peak device "
        f"memory {peak_gib:.2f} GiB")
    profile_phase(model, label)
    return launches


def build_main_model():
    t0 = time.perf_counter()
    model = instantiate_from_config(load_yaml(str(T2I))["model"], seed=0)
    n_zero = randomize_zero_init_(model, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path model: {T2I.relative_to(REPO)}, {n_params} parameters, "
        f"{n_zero} zero-init convs randomised, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def profile_phase(model, label):
    """Where the main path's time goes: device busy share and the heaviest
    kernels of a short run under torch.profiler (which slows the host, so
    the idle share it gives is an upper bound), then one UNet call and the
    part of it spent casting the fp32 weights to bf16."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs = drive_main_path(model, seed=2, steps=PROFILE_STEPS)
    wall = sum(secs.values())
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    unet_calls = 2 * 2 * (PROFILE_STEPS + 1)
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        log(f"profile ({label}; batch {BATCH}, PLMS {PROFILE_STEPS}, "
            f"{unet_calls} "
            f"UNet calls, decode): wall {wall:.3f} s under the profiler, "
            f"device busy {busy:.3f} s, idle share {1 - busy / wall:.3f}, "
            f"{sum(e.count for e in kernels)} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                        )[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x {e.key[:90]}")
    else:
        log("profile: torch.profiler recorded no device time; device busy "
            "share not measured")

    unet = model.model.diffusion_model
    x = seeded((BATCH, 32, 32, 8), 30, torch.bfloat16)
    t = torch.full((BATCH,), 500, device="cuda")
    with torch.no_grad():
        ctx = model.get_learned_conditioning(
            np.zeros((BATCH, CTX_LEN), np.int64)).to(torch.bfloat16)
        tables = model.spade_tables(x[..., :4], 1)
        call_ms = cuda_ms(lambda: model.apply_model(x, t, ctx, 1, tables),
                          reps=5)
        cast_ms = cuda_ms(lambda: [p.to(torch.bfloat16)
                                   for p in unet.parameters()], reps=5)
    log(f"UNet call ({label}; batch {BATCH}, bf16, stage 1): "
        f"{call_ms:.3f} ms; "
        f"casting its {sum(1 for _ in unet.parameters())} weight tensors "
        f"to bf16 alone: {cast_ms:.3f} ms")


def main():
    card = setup()
    rows = [flash_phase(), vq_phase()]
    rows += [group_norm_phase(), smalls_phase(), conv3x3_norm_silu_phase(),
             conv3x3_phase()]
    toy_phase("default")
    with all_kernels():
        toy = toy_phase("all-kernel")
    if not all(toy[name] > 0 for name in KERNELS):
        raise AssertionError(f"toy all-kernel run launched {toy}")

    model = build_main_model()
    unet_conv_sum_phase(model)
    default = main_path_phase(card, model, "default", STEPS)
    with all_kernels():
        opt_in = main_path_phase(card, model, "all-kernel", ALL_KERNEL_STEPS)
    for row in rows:
        path = default if row["name"] in ("flash_attention", "vq_argmin") \
            else opt_in
        row["launches"] = path[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
