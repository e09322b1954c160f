"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two main paths, each at full width with batch 4, classifier-free guidance
1.5 (sequential), a bf16 UNet over two pyramid stages and an fp32 MS-VQGAN
decode (per-scale VQ re-quantization, post_quant_conv, the 256^2 conv
decoder):

- t2i, ``configs/frido/t2i/frido_f16f8_coco.yaml``: 77 token ids -> BERT
  context -> PLMS over a 32^2 x 8 latent;
- layout2i f8f4, ``configs/frido/layout2i/frido_f8f4_coco_seg.yaml``: 96
  bbox token ids -> BERT context -> DPM-Solver++(2M), 25 steps, over a
  64^2 x 6 latent (D = 3 codebooks of 4096; the decoder attends over 4096
  tokens, the UNet over 1024 at 32^2).

Beside them, each path's first stage encodes 256^2 images at batch 4 in
fp32 (``encode_first_stage``: the MS-VQGAN encoder, the cross-scale fusion
heads and both codebooks) and decodes the latent again, and the MS-VQGAN of
``configs/msvqgan/msvqgan_f16f8_coco.yaml`` (the t2i first stage's
architecture) runs its training forward ``forward_with_aux`` at batch 4.

Training: the t2i model trains at its config's batch of 32 (bf16 UNet and
encode, fp32 weights, AdamW at ``scaled_learning_rate(1e-6, 32, 1)``, the
EMA of the denoiser), and the MS-VQGAN at its config's batch of 6 (fp32,
``use_aux_loss``, the config's loss, from its ``disc_start`` so both
phases and d_weight are live; no LPIPS, as without local weights).

Weights are random, made from a seed; the zero-initialised output convs get
a seeded random init too, so the UNet does not predict 0. Each path runs
twice: in the default configuration (flash attention and the VQ argmin on
their kernels), and in the JAX package's all-kernel configuration
(``FRIDO_CONV_MODE=pallas_fused FRIDO_GN_PALLAS=1 FRIDO_SMALLS_ATTN=1``),
where GroupNorm, short-sequence attention, every 3x3 conv and every fused
ResBlock prologue take their kernels too.

Phases, in order; any failure exits non-zero and nothing is caught:

1. setup: card, power limit, versions, TF32 flags, kernel build time;
2. each hand-written kernel at the t2i path's shapes against its plain
   PyTorch version: error, and kernel / plain / library-call times (CUDA
   events), beside the least time the card could take (``bound_ms``);
3. a toy-width model on the card against the same model on the CPU (the
   plain path, which the CPU tests hold to the JAX package), in both
   configurations; then each sampler (PLMS, DDIM with eta 1,
   DPM-Solver++(2M), the full-T vanilla chain over a schedule cut to 40
   timesteps) on the toy model, card against CPU, the noise drawn from a
   CPU generator seeded alike for both; then the toy's encode,
   round trip and ``forward_with_aux``, card against CPU, in both
   configurations; then a toy diffusion train step and a toy GAN step
   before and after ``disc_start``, card against CPU from the same weights
   (loss, logs, every gradient, the updated weights, the Adam moments, the
   EMA, d_weight, the BatchNorm statistics), in both configurations;
4. the t2i path in each configuration, with every kernel's launch count
   set to 0 just before and read just after, and held to the count the
   architecture and the sampler give;
5. the t2i encode sites: every distinct kernel call of one all-kernel
   ``encode_first_stage`` at batch 4, recorded where the port calls the
   wrappers, each checked and timed as in 2 (the "other sites"); then the
   t2i first stage in each configuration: encode and decode with their
   launches held to the architecture's, the round-trip invariant (the
   re-quantized diffusion latent gives encode's codes and image), times,
   peak memory and a profile of one encode; then ``forward_with_aux`` of
   the MS-VQGAN config in each configuration, held alike;
6. training: every distinct kernel call of one all-kernel t2i train step and of one GAN
   step, forward as in 5 and, where it takes a gradient, its gradient
   against the plain version's autograd; the t2i model's diffusion
   training (2 warm-up and 5 timed steps) in both configurations and one
   fp32 step, and the MS-VQGAN's GAN training (2 + 3) in both, each with
   its launches per step held to the architecture's (the backward
   recomputes through the plain versions and launches nothing), img/s,
   step seconds, peak memory above the model and a profiled step; LPIPS
   with seeded weights at the GAN's batch, card against CPU;
7. the layout2i sites: every distinct kernel call of one all-kernel pass
   of the layout2i model at batch 4 (conditioning, a UNet call per stage,
   decode) and of its encode, and flash and the VQ argmin at the decode
   chunk of 32, each checked as in 5 unless checked before (in 2 or an
   earlier pass); then the layout2i path in each configuration, as in 4,
   and its first stage, as in 5.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one ``{"kernels": [...]}``
line (the launches: the t2i path's), and before that one
``{"other_sites": [...]}`` line (each site with the pass that made it,
its gradient's relative error where it was checked, and the arguments of
its check: attention (bh, nq, nk, d, dtype), VQ (n, k,
d), GroupNorm (shape, dtype, groups, eps, silu), conv (shape, cout,
dtype), fused conv (shape, cout, dtype, spade, groups, eps)). Without
CUDA, or outside the repository, it exits non-zero and prints no result.
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
from frido_tpu_torch.losses.lpips import LPIPS  # noqa: E402
from frido_tpu_torch.losses.vqperceptual import (  # noqa: E402
    VQLPIPSWithDiscriminator)
from frido_tpu_torch.models.msvqgan import MSFPNVQModel  # noqa: E402
from frido_tpu_torch.nn.layers import Conv2d, GroupNorm, init_module_  # noqa: E402,E501
from frido_tpu_torch.nn.pyunet import (  # noqa: E402
    ResBlock, UNetDownsample, UNetUpsample)
from frido_tpu_torch.nn.quantize import VectorQuantizer  # noqa: E402
from frido_tpu_torch.nn.transformer import SpatialTransformer  # noqa: E402
from frido_tpu_torch.nn.vqgan import AttnBlock  # noqa: E402
from frido_tpu_torch.nn.xtransformer import XAttention  # noqa: E402
from frido_tpu_torch.ops.image import (  # noqa: E402
    interpolate_nearest_2x, to_nchw, to_nhwc)
from frido_tpu_torch.ops.cuda import build, dispatch  # noqa: E402
from frido_tpu_torch.ops.cuda.attention import (  # noqa: E402
    attention_plain, flash_attention, flash_plan, smalls_attention,
    smalls_plan)
from frido_tpu_torch.ops.cuda.conv import (  # noqa: E402
    conv3x3, conv3x3_norm_silu, conv3x3_norm_silu_plain, conv3x3_plain,
    conv_plan)
from frido_tpu_torch.ops.cuda.norm import (  # noqa: E402
    group_norm, group_norm_plain, group_norm_plan)
from frido_tpu_torch.ops.cuda.vq import (  # noqa: E402
    vq_argmin, vq_argmin_plain, vq_plan)
from frido_tpu_torch.schedules import DDIMSchedule  # noqa: E402
from frido_tpu_torch.training import (  # noqa: E402
    optim, trainer, vqgan_trainer)
from frido_tpu_torch.tools.attention_ab import graph_ms  # noqa: E402

T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml"
L2I = REPO / "configs" / "frido" / "layout2i" / "frido_f8f4_coco_seg.yaml"
MSVQ = REPO / "configs" / "msvqgan" / "msvqgan_f16f8_coco.yaml"

# Published peaks of one H100 SXM (dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # tf32 tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores
PEAK_BYTES = 3.35e12         # HBM3

# main path, as bench.py runs it (batch 4 here)
BATCH = 4
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
# layout2i f8f4: the t2i UNet's site counts, at 64^2; a three-level decoder
# with 26 3x3 convs (conv_in, 2 per ResnetBlock x 11, 2 upsample,
# conv_out), 27 GroupNorms (2 per ResnetBlock, 1 per AttnBlock, norm_out)
# and 4 AttnBlocks (the middle one and three at 64^2)
L2I_ARCH = dict(res_blocks=22, transformers=16, upsamples=3, bert_layers=32,
                first_stage_3x3=26, first_stage_norms=27, first_stage_attn=4,
                codebooks=2)
# the encode side of the t2i first stage (the MS-VQGAN of
# configs/msvqgan/msvqgan_f16f8_coco.yaml too): a five-level trunk (ch_mult
# [1, 1, 2, 2, 4], 2 ResnetBlocks a level) with 2 AttnBlocks at 32^2, two
# heads (mid block, attn, block; norm_out; conv_out) on the 32^2 x 256 and
# 16^2 x 512 taps, and the fusion's shared decoder (conv_in, mid, one level
# of 3 ResnetBlocks, norm_out, conv_out at 128 channels over the 32^2
# grid): 31 + 12 3x3 convs (conv_in, 2 per ResnetBlock x 14, 2 conv_out;
# 2 x 5 + 2), 34 + 12 GroupNorms (2 per ResnetBlock, 1 per AttnBlock, 2
# norm_out; 2 x 5 + 1 + 1), attention over 1024 tokens (trunk x 2, head 0,
# shared decoder) and 256 (head 1)
T2I_ENCODE_ARCH = dict(encode_3x3=43, encode_norms=46,
                       encode_attn_tokens=[1024, 1024, 1024, 256, 1024],
                       codebooks=2)
# layout2i f8f4: a four-level trunk (ch_mult [1, 1, 2, 4]) with 2
# AttnBlocks at 64^2, heads on the 64^2 x 256 and 32^2 x 512 taps, the
# shared decoder over the 64^2 grid: 27 + 12 3x3 convs, 30 + 12 GroupNorms,
# attention over 4096 tokens (trunk x 2, head 0, shared decoder) and 1024
# (head 1)
L2I_ENCODE_ARCH = dict(encode_3x3=39, encode_norms=42,
                       encode_attn_tokens=[4096, 4096, 4096, 1024, 4096],
                       codebooks=2)
GUIDANCE = 1.5
DECODE_CHUNK = 32
CTX_LEN = 77
# Each main path: config, token window, the bound of its conditioning token
# ids (t2i conditions on id 0 alone, as bench.py does; layout2i on seeded
# bbox token ids, which lie below the dataset's no_tokens of 1024), sampler
# and eta, steps in the default and in the all-kernel configuration (t2i
# at 20, to keep the script short; layout2i at bench.py's BENCH_SAMPLER=
# dpmpp default of 25), the architecture's counts.
PATHS = {
    "t2i": dict(config=T2I, ctx_len=CTX_LEN, token_high=1, sampler="plms",
                eta=0.0, steps=20, all_kernel_steps=20, arch=T2I_ARCH,
                encode_arch=T2I_ENCODE_ARCH),
    "layout2i": dict(config=L2I, ctx_len=96, token_high=1024,
                     sampler="dpmpp", eta=0.0, steps=25, all_kernel_steps=10,
                     arch=L2I_ARCH, encode_arch=L2I_ENCODE_ARCH),
}
PROFILE_STEPS = 4   # a short chain under torch.profiler, for the breakdown
# the samplers' toy phase: the toy schedule cut to 40 timesteps (the
# vanilla chain runs all of them), 4 steps for the others
TOY_TIMESTEPS = 40
TOY_SAMPLERS = (("plms", 0.0), ("ddim", 1.0), ("dpmpp", 0.0),
                ("vanilla", 1.0))
# kernel phases at the shapes the main path gives the kernels: flash at
# the benchmark's decode chunk of 32 ([32, 1024, 512], the row) and at this
# script's batch of 4; VQ at this script's batch of 4 (N = 4*32*32, the
# row: both codebooks see a 32^2 latent grid) and at the decode chunk of 32
FLASH_SHAPE = (32, 1024, 512)
VQ_NS, VQ_K, VQ_D = (BATCH * 32 * 32, 32 * 32 * 32), 8192, 4
# the layout2i sites: every distinct kernel call of the path, recorded from
# the model, among them these (the decoder's fp32 attention at 64^2, the
# UNet's one-head bf16 self-attention at 32^2, both D = 3 codebooks over a
# 64^2 grid, the 64^2 UNet's fused prologues, convs and GroupNorm); and
# flash and VQ at the decode chunk of 32, which this batch does not reach
L2I_NAMED_SITES = (
    ("flash_attention", (BATCH, 4096, 4096, 512, torch.float32)),
    ("flash_attention", (BATCH, 1024, 1024, 384, torch.bfloat16)),
    ("vq_argmin", (BATCH * 64 * 64, 4096, 3)),
    ("conv3x3_norm_silu", ((BATCH, 192, 64, 64), 192, torch.bfloat16, True,
                           32, 1e-5)),
    ("conv3x3", ((BATCH, 3, 64, 64), 192, torch.bfloat16)),
    ("group_norm", ((BATCH, 192, 64, 64), torch.bfloat16, 32, 1e-5, True)),
)
L2I_CHUNK_FLASH = (DECODE_CHUNK, 4096, 4096, 512, torch.float32)
L2I_CHUNK_VQ = (DECODE_CHUNK * 64 * 64, 4096, 3)

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
TOY_ENCODE_ATOL = 1e-4     # fp32 encoder latents, CPU vs card sums
ROUND_TRIP_ATOL = 1e-5     # one decode of one quantized latent, twice

# Training: the configs' batches (t2i data.params.batch_size 32, the
# MS-VQGAN's 6) and learning rates, scaled as main.py and
# scripts/train_msvqgan.py scale them; the GAN starts at its config's
# disc_start, so both phases and d_weight are live. Steps: (warm-up, timed).
_T2I_CFG, _MSVQ_CFG = load_yaml(str(T2I)), load_yaml(str(MSVQ))
TRAIN_BATCH = _T2I_CFG["data"]["params"]["batch_size"]
TRAIN_LR = optim.scaled_learning_rate(
    _T2I_CFG["model"]["base_learning_rate"], TRAIN_BATCH, 1)
GAN_BATCH = _MSVQ_CFG["data"]["params"]["batch_size"]
GAN_LR = optim.scaled_learning_rate(
    _MSVQ_CFG["model"]["base_learning_rate"], GAN_BATCH, 1)
GAN_DISC_START = _MSVQ_CFG["model"]["params"]["lossconfig"]["params"][
    "disc_start"]
TRAIN_STEPS, GAN_STEPS = (2, 5), (2, 3)
TOY_LR = 1e-3
TOY_GAN_LOSS = dict(disc_start=1, disc_num_layers=2, disc_weight=0.8,
                    perceptual_weight=0.0)
# Training tolerances. Toy steps, card against CPU in fp32: the loss and
# logs 1e-4 (one UNet call per stage agrees to about 1e-5). Gradients per
# leaf within 1e-2 of the reference's largest magnitude, that magnitude
# floored at 1e-1 of the largest over all leaves; and every leaf above
# 1e-4 of that largest also within 5e-2 of its own norm (the 2-norm of the
# difference), so a floored leaf that is zeroed, flipped or missing a
# term fails. The diffusion step's reference is its gradient in float64
# on the CPU: fp32 sums that cancel (SPADE's mlp_shared weight and bias,
# whose cotangent passes a GroupNorm's zero-mean output) leave those
# leaves up to 1.2e-2 of their norm from float64, on the CPU for some
# leaves and on the card for others (an H100 80GB HBM3 at 700 W). Leaves
# under 1e-4 of the largest are those whose exact gradient is
# 0 (a ResBlock's time-embedding bias before a GroupNorm of one channel
# per group): float64 puts them near 1e-8 of it, and fp32 leaves only
# rounding noise there. The GAN steps hold the card to the CPU's fp32
# gradient. The weights within 2 lr: after the first Adam step an element
# moves by lr whatever its gradient's size, so the weights and the EMA
# carry no signal of the gradient; the Adam moments, held to (1 - b1) and
# (1 - b2) times the bound on the two gradients' difference, do. The GAN's
# logs within the image tolerance, d_weight (a ratio of two gradient
# norms) within 1e-3 relative. A kernel's gradient against its plain
# version's autograd at a site: the backward recomputes through the plain
# version in the inputs' dtype, so 1e-5 of the largest gradient in fp32,
# 2^-7 in bf16 (cuDNN may pick another algorithm). LPIPS distances (13
# convs deep, values of order 0.1-1): 1e-3.
TOY_TRAIN_LOSS_ATOL = 1e-4
TOY_D_WEIGHT_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-2
TRAIN_GRAD_FLOOR = 1e-1
TRAIN_GRAD_NORM_RTOL = 5e-2
TRAIN_GRAD_NORM_FROM = 1e-4
SITE_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
LPIPS_ATOL = 1e-3


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
    """Standard normal fp32 values of ``shape``, drawn on ``device`` by a
    generator seeded with ``seed``, in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


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


def conv_plan_of(x, cout, fused=False, spade=False):
    """The kernel's host plan for x -> cout, as printed beside its time."""
    p = conv_plan(*x.shape, cout, x.element_size(), fused, spade)
    return (f"grid {list(p.grid)}, {32 * p.nt}-pixel tile, split "
            f"{p.split}, {p.smem} B shared")


def fused_operands(shape, cout, dtype, spade, seed):
    """x, weight, bias, the norm affine and (with SPADE) the tables."""
    x, w, b = conv_operands(shape, cout, dtype, seed)
    cin = shape[1]
    ns = 1.0 + 0.1 * seeded((cin,), seed + 3)
    nb = 0.1 * seeded((cin,), seed + 4)
    g = bt = None
    if spade:
        g = (0.2 * seeded(shape, seed + 5)).to(dtype)
        bt = (0.2 * seeded(shape, seed + 6)).to(dtype)
    return x, w, b, ns, nb, g, bt


def attention_site(kernel, bh, nq, nk, d, dtype):
    """One attention kernel (``flash_attention`` or ``smalls_attention``)
    over q [bh, nq, d], k, v [bh, nk, d] against its plain version;
    returns (max error, kernel ms, plain ms, bound, SDPA ms)."""
    fn, planner = ((flash_attention, flash_plan)
                   if kernel == "flash_attention"
                   else (smalls_attention, smalls_plan))
    q = seeded((bh, nq, d), 10, dtype)
    k, v = (seeded((bh, nk, d), s, dtype) for s in (11, 12))
    scale = d ** -0.5
    got = fn(q, k, v, scale)
    torch.cuda.synchronize()
    want = attention_plain(q.float(), k.float(), v.float(), scale)
    err, tol = check_close(f"{kernel} {dtype} {[bh, nq, nk, d]}", got, want,
                           attn_atol(v, dtype), dtype)
    ms = cuda_ms(lambda: fn(q, k, v, scale))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, scale))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale))
    itemsize = torch.finfo(dtype).bits // 8
    bounded = matmul_bound(4 * bh * nq * nk * d, dtype,
                           (2 * nq + 2 * nk) * bh * d * itemsize)
    p = planner(bh, nq, nk, d, itemsize)
    log(f"{kernel} {dtype} bh {bh} nq {nq} nk {nk} d {d}: max_abs_err "
        f"{err:.3e} (tol {tol}), output max {want.abs().max().item():.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, {describe_bound(bounded)}; plan {p.rows}-row "
        f"tiles, grid {list(p.grid)}, {p.smem} B shared")
    return err, ms, plain_ms, bounded, library_ms


def vq_site(n, k, d):
    """The VQ argmin of z [n, d] against a codebook [k, d] against its
    plain version; returns (max distance gap, kernel ms, plain ms, bound,
    cdist + argmin ms). Device: a replayed CUDA graph of 20 calls."""
    z = seeded((n, d), 20)
    e = seeded((k, d), 21)
    got = vq_argmin(z, e)
    torch.cuda.synchronize()
    want = vq_argmin_plain(z, e)
    # error: how much farther the kernel's pick is than the plain pick,
    # by the kernel's own distance, in float64
    z64, e64 = z.double(), e.double()
    esq = (e64 * e64).sum(1)

    def dist(idx):
        sel = e64[idx.long()]
        return esq[idx.long()] - 2 * (z64 * sel).sum(1)

    err = (dist(got) - dist(want)).abs().max().item()
    if got.dtype != torch.int32 or got.shape != (n,):
        raise AssertionError(f"vq_argmin gave {got.dtype} "
                             f"{tuple(got.shape)}")
    if not err <= VQ_DIST_ATOL:
        raise AssertionError(f"vq_argmin N {n}: distance of kernel pick "
                             f"vs plain pick differs by {err} > "
                             f"{VQ_DIST_ATOL}")
    ms = cuda_ms(lambda: vq_argmin(z, e))
    device_ms = graph_ms(lambda: vq_argmin(z, e))
    plain_ms = cuda_ms(lambda: vq_argmin_plain(z, e))
    library_ms = cuda_ms(lambda: torch.cdist(z, e).argmin(dim=1))
    # per (row, code): D multiply-adds and one compare; |e|^2 once per code
    ops = n * k * (2 * d + 1) + k * 2 * d
    nbytes = 4 * (n * d + k * d + n)
    bounded = bound(ops, PEAK_FP32_FLOPS, nbytes)
    same = (got == want).float().mean().item()
    p = vq_plan(n, k, d)
    log(f"vq_argmin z [{n}, {d}] codebook [{k}, {d}]: same "
        f"index {same:.6f} of rows, max distance gap {err:.3e} (tol "
        f"{VQ_DIST_ATOL}), kernel {ms:.4f} ms (device {device_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, cdist+argmin {library_ms:.4f} ms, "
        f"bound {bounded[0]:.4f} ms ({bounded[1]}); plan {p.grid} CTAs "
        f"of {p.warps} warps in clusters of {p.cluster}, {32 * p.rows} "
        f"rows a CTA, {p.ks} codes a part")
    return err, ms, plain_ms, bounded, library_ms


def group_norm_site(shape, dtype, groups, eps, silu):
    """GroupNorm (+ SiLU) of x ``shape`` against its plain version. The
    library call is F.group_norm, which has no SiLU: it times less work
    than the kernel. Device: a replayed CUDA graph of 20 calls."""
    c = shape[1]
    x = seeded(shape, 40, dtype)
    w = 1.0 + 0.1 * seeded((c,), 41)
    b = 0.1 * seeded((c,), 42)
    got = group_norm(x, w, b, groups, eps, silu)
    torch.cuda.synchronize()
    want = group_norm_plain(x.float(), w, b, groups, eps, silu)
    err, tol = check_close(f"group_norm {dtype} {list(shape)}", got, want,
                           GN_ATOL, dtype)
    ms = cuda_ms(lambda: group_norm(x, w, b, groups, eps, silu))
    device_ms = graph_ms(lambda: group_norm(x, w, b, groups, eps, silu))
    plain_ms = cuda_ms(lambda: group_norm_plain(x, w, b, groups, eps, silu))
    wl, bl = w.to(dtype), b.to(dtype)
    library_ms = cuda_ms(lambda: F.group_norm(x, groups, wl, bl, eps))
    library_device_ms = graph_ms(lambda: F.group_norm(x, groups, wl, bl, eps))
    n = x.numel()
    itemsize = torch.finfo(dtype).bits // 8
    # per element: 3 for the sums, 2 for the affine, 3 for the SiLU
    bounded = bound((8 if silu else 5) * n, PEAK_FP32_FLOPS,
                    2 * n * itemsize + 8 * c)
    p = group_norm_plan(shape[0], c, groups, math.prod(shape[2:]), itemsize)
    path = (f"one CTA of {p.threads} threads per run, in registers"
            if p.vpt else f"clusters of {p.cluster} CTAs, {p.slice}-"
            f"element slices in shared memory" if p.cluster
            else "streamed twice")
    log(f"group_norm {dtype} x {list(shape)} groups {groups} eps {eps} silu "
        f"{silu}: max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms "
        f"(device {device_ms:.4f}), plain {plain_ms:.4f} ms, F.group_norm "
        f"(no SiLU) {library_ms:.4f} ms (device {library_device_ms:.4f}), "
        f"bound {bounded[0]:.4f} ms ({bounded[1]}); plan: {path}")
    return err, ms, plain_ms, bounded, library_ms


def conv3x3_site(shape, cout, dtype):
    """The 3x3 conv of x ``shape`` to ``cout`` channels against its plain
    version. The library call is F.conv2d (cuDNN, TF32 off)."""
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
    return err, ms, plain_ms, bounded, library_ms


def conv3x3_norm_silu_site(shape, cout, dtype, spade, groups, eps):
    """The fused GroupNorm -> (SPADE) -> SiLU -> 3x3 conv of x ``shape``
    against its plain version. No single library call computes the fused
    op: library_ms is None; F.conv2d of the conv alone (no prologue) on
    the same shape is printed beside it. Its tolerance is fixed for bf16,
    the dtype of every fused site."""
    if dtype != torch.bfloat16:
        raise AssertionError(f"conv3x3_norm_silu in {dtype}: no tolerance "
                             f"fixed")
    x, w, b, ns, nb, g, bt = fused_operands(shape, cout, dtype, spade, 60)
    args = (x, w, b, ns, nb, groups, eps, g, bt)
    got = conv3x3_norm_silu(*args)
    torch.cuda.synchronize()
    up = (lambda t: None if t is None else t.float())
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), ns, nb,
                                   groups, eps, up(g), up(bt))
    err, tol = check_close(
        f"conv3x3_norm_silu {dtype} {list(shape)}->{cout}", got, want,
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
        f"(one call: {launches}), plain {plain_ms:.4f} ms, no library call "
        f"(conv alone, no prologue: F.conv2d {alone_ms:.4f} ms), "
        f"bound {bounded[0]:.4f} ms ({bounded[1]}); plan "
        f"{conv_plan_of(x, cout, True, spade)}")
    return err, ms, plain_ms, bounded, None


# each kernel: its source, the TPU kernel it replaces, its site check
KERNEL_SOURCES = {
    "flash_attention": ("frido_tpu_torch/csrc/flash_attention.cu",
                        "frido_tpu/ops/pallas/attention.py:301"),
    "vq_argmin": ("frido_tpu_torch/csrc/vq_argmin.cu",
                  "frido_tpu/ops/pallas/vq_pallas.py:74"),
    "group_norm": ("frido_tpu_torch/csrc/group_norm.cu",
                   "frido_tpu/ops/pallas/norm_pallas.py:130"),
    "smalls_attention": ("frido_tpu_torch/csrc/smalls_attention.cu",
                         "frido_tpu/ops/pallas/attention.py:282"),
    "conv3x3_norm_silu": ("frido_tpu_torch/csrc/conv3x3.cu",
                          "frido_tpu/ops/pallas/conv_pallas.py:376"),
    "conv3x3": ("frido_tpu_torch/csrc/conv3x3.cu",
                "frido_tpu/ops/pallas/conv_pallas.py:177"),
}
SITE_CHECKS = {
    "flash_attention": lambda *s: attention_site("flash_attention", *s),
    "vq_argmin": vq_site,
    "group_norm": group_norm_site,
    "smalls_attention": lambda *s: attention_site("smalls_attention", *s),
    "conv3x3_norm_silu": conv3x3_norm_silu_site,
    "conv3x3": conv3x3_site,
}


# every site checked so far, {kernel: {arguments of its site check}}: the
# "other sites" check each site once
CHECKED = {name: set() for name in SITE_CHECKS}
# every site whose gradient was checked (site_grad_check)
GRAD_CHECKED = {name: set() for name in SITE_CHECKS}


def phase_row(name, sites):
    """Check and time the kernel ``name`` at each site (the arguments of
    its site check); the first site gives its row of the kernels line."""
    results = [SITE_CHECKS[name](*site) for site in sites]
    CHECKED[name].update(sites)
    err, ms, plain_ms, bounded, library_ms = results[0]
    source, replaces = KERNEL_SOURCES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bounded[0], bound_by=bounded[1],
                library_ms=library_ms)


def flash_phase():
    """The decode chunk's fp32 site gives the row; the main path's batch
    of 4 and the kernel's bf16 form (off the t2i path) are checked and
    timed too."""
    b, n, d = FLASH_SHAPE
    return phase_row("flash_attention", [(b, n, n, d, torch.float32),
                                         (BATCH, n, n, d, torch.float32),
                                         (b, n, n, d, torch.bfloat16)])


def vq_phase():
    """The main path's N = 4 * 32 * 32 gives the row; the decode chunk's
    N = 32 * 32 * 32 is checked and timed too."""
    return phase_row("vq_argmin", [(n, VQ_K, VQ_D) for n in VQ_NS])


def group_norm_phase():
    """The heaviest site, the decoder's 256^2 fp32 norms (+SiLU), gives the
    row; every other GroupNorm site of the main path (the decoder's fp32
    ones, the UNet's bf16 ones) is checked and timed too."""
    return phase_row("group_norm", [  # (shape, dtype, groups, eps, silu)
        ((BATCH, 128, 256, 256), torch.float32, 32, 1e-6, True),  # decoder
        ((BATCH, 512, 32, 32), torch.float32, 32, 1e-6, True),
        ((BATCH, 512, 64, 64), torch.float32, 32, 1e-6, True),
        ((BATCH, 256, 64, 64), torch.float32, 32, 1e-6, True),
        ((BATCH, 256, 128, 128), torch.float32, 32, 1e-6, True),
        ((BATCH, 128, 128, 128), torch.float32, 32, 1e-6, True),
        ((BATCH, 192, 32, 32), torch.bfloat16, 32, 1e-5, True),   # out head
        ((BATCH, 384, 16, 16), torch.bfloat16, 32, 1e-6, False),  # ST norms
        ((BATCH, 576, 8, 8), torch.bfloat16, 32, 1e-6, False),
        ((BATCH, 960, 4, 4), torch.bfloat16, 32, 1e-6, False),
    ])


def smalls_phase():
    """The heaviest site, the UNet's 256-token bf16 self-attention with one
    head of d = 384, gives the row; the other sites are checked too."""
    bf16 = torch.bfloat16
    return phase_row("smalls_attention", [  # (bh, nq, nk, d, dtype)
        (BATCH, 256, 256, 384, bf16),          # self, 32^2 / 2
        (BATCH, 256, CTX_LEN, 384, bf16),      # cross
        (BATCH, 64, 64, 576, bf16),            # self at 8x8, d = 576
        (BATCH, 64, CTX_LEN, 576, bf16),
        (BATCH, 16, 16, 960, bf16),            # self at 4x4, d = 960
        (BATCH, 16, CTX_LEN, 960, bf16),
        (BATCH * 8, CTX_LEN, CTX_LEN, 64, torch.float32),   # BERT
    ])


def conv3x3_phase():
    """The heaviest site, the decoder's 256^2 fp32 conv, gives the row; the
    UNet's bf16 sites with Cin = 4 and Cout = 4 and its three upsample
    convs are checked too."""
    bf16 = torch.bfloat16
    return phase_row("conv3x3", [  # (shape, cout, dtype)
        ((BATCH, 128, 256, 256), 128, torch.float32),   # decoder
        ((BATCH, 384, 32, 32), 384, bf16),    # upsample conv, 32^2
        ((BATCH, 576, 16, 16), 576, bf16),    # upsample conv, 16^2
        ((BATCH, 960, 8, 8), 960, bf16),      # upsample conv, 8^2
        ((BATCH, 4, 32, 32), 192, bf16),      # pre_input
        ((BATCH, 192, 32, 32), 4, bf16),      # out head
    ])


def conv3x3_norm_silu_phase():
    """The heaviest prologue, [4, 576, 32, 32] -> 192 with SPADE (stage 1),
    gives the row; the heaviest one at each other resolution of the UNet
    is checked and timed too."""
    bf16 = torch.bfloat16
    return phase_row("conv3x3_norm_silu", [
        # (shape, cout, dtype, spade, groups, eps)
        ((BATCH, 576, 32, 32), 192, bf16, True, 32, 1e-5),
        ((BATCH, 960, 16, 16), 384, bf16, True, 32, 1e-5),
        ((BATCH, 1536, 8, 8), 576, bf16, True, 32, 1e-5),
        ((BATCH, 1920, 4, 4), 960, bf16, True, 32, 1e-5),
        ((BATCH, 1920, 4, 4), 960, bf16, False, 32, 1e-5),
    ])


def record_sites(run, grad=False):
    """Every distinct kernel call made while ``run()`` drives a model in the
    current configuration, recorded where the port calls the six wrappers.
    Returns {kernel: {arguments of its site check}}, and under "grad" the
    calls that took a gradient, by kernel. ``run()`` goes without autograd
    unless ``grad``."""
    from frido_tpu_torch.nn import layers, transformer
    from frido_tpu_torch.ops import vq as ops_vq

    found = {name: set() for name in KERNELS}
    found["grad"] = {name: set() for name in KERNELS}

    def add(name, site, *tensors):
        found[name].add(site)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            found["grad"][name].add(site)

    def attention(name):
        def call(q, k, v, scale):
            add(name, (math.prod(q.shape[:-2]), q.shape[-2], k.shape[-2],
                       q.shape[-1], q.dtype), q, k, v)
            return KERNELS[name](q, k, v, scale)
        return call

    def vq(z, e):
        found["vq_argmin"].add((z.shape[0],) + tuple(e.shape))
        return vq_argmin(z, e)

    def norm(x, weight, bias, num_groups=32, eps=1e-6, fuse_silu=False):
        add("group_norm", (tuple(x.shape), x.dtype, num_groups, eps,
                           fuse_silu), x, weight, bias)
        return group_norm(x, weight, bias, num_groups, eps, fuse_silu)

    def conv(x, weight, bias):
        add("conv3x3", (tuple(x.shape), weight.shape[0], x.dtype), x,
            weight, bias)
        return conv3x3(x, weight, bias)

    def fused(x, weight, bias, nscale, nbias, num_groups, eps, gamma=None,
              beta=None):
        add("conv3x3_norm_silu", (tuple(x.shape), weight.shape[0], x.dtype,
                                  gamma is not None, num_groups, eps),
            x, weight, bias, nscale, nbias, gamma, beta)
        return conv3x3_norm_silu(x, weight, bias, nscale, nbias, num_groups,
                                 eps, gamma, beta)

    patches = [(transformer, "flash_attention", attention("flash_attention")),
               (transformer, "smalls_attention",
                attention("smalls_attention")),
               (ops_vq, "vq_argmin", vq), (layers, "group_norm", norm),
               (layers, "conv3x3", conv), (layers, "conv3x3_norm_silu", fused)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        with torch.set_grad_enabled(grad):
            run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return found


def sampling_pass(model, path):
    """One pass of ``path`` at this script's batch: both conditionings, one
    UNet call in each stage (with its SPADE tables after the first) and
    the decode."""
    side, device = model.image_size, model.device
    x = seeded((BATCH, side, side, model.channels), 32, torch.bfloat16,
               device)
    t = torch.full((BATCH,), 500, device=device)
    ctx = model.get_learned_conditioning(np.zeros(
        (BATCH, path["ctx_len"]), np.int64)).to(torch.bfloat16)
    for stage in range(model.num_stage):
        frozen = sum(model.embed_dim_list[:stage])
        tables = (model.spade_tables(x[..., :frozen], stage)
                  if stage else None)
        model.apply_model(x, t, ctx, stage, tables)
    model.decode_first_stage(x.float(), chunk=DECODE_CHUNK)


def seeded_images(seed, device="cuda"):
    """A batch of 256^2 RGB images in [-1, 1], the first stage's input
    range."""
    return seeded((BATCH, 256, 256, 3), seed, device=device).tanh()


def check_sites(found, label):
    """Check and time each site of ``found`` not checked before against its
    plain version with the tolerances above; returns one "other sites"
    entry per site, labelled with the pass that made it."""
    sites = []
    grad_sites = found.get("grad", {})
    for name in KERNELS:
        todo = grad_sites.get(name, set()) - GRAD_CHECKED[name]
        for site in sorted((found[name] - CHECKED[name]) | todo, key=str):
            entry = {"name": name, "site": str(site).replace("torch.", ""),
                     "pass": label, "grad_rel_err": None}
            if site not in CHECKED[name]:
                err, ms, plain_ms, bounded, library_ms = \
                    SITE_CHECKS[name](*site)
                CHECKED[name].add(site)
                entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bounded[0], bound_by=bounded[1],
                             library_ms=library_ms)
            if site in todo:
                entry["grad_rel_err"] = site_grad_check(name, site)
                GRAD_CHECKED[name].add(site)
            sites.append(entry)
    n_grad = sum(e["grad_rel_err"] is not None for e in sites)
    log(f"{label} sites: {len(sites)} checked, {n_grad} of them with their "
        f"gradient ({ {n: len(found[n]) for n in KERNELS} } distinct calls, "
        f"{ {n: len(grad_sites.get(n, ())) for n in KERNELS} } with a "
        f"gradient)")
    return sites


def encode_sites_phase(model, label):
    """Every distinct kernel call of one all-kernel ``encode_first_stage``
    at this script's batch, each checked as in ``check_sites``."""
    x = seeded_images(33)
    with all_kernels():
        found = record_sites(lambda: model.encode_first_stage(x))
    return check_sites(found, label)


def layout2i_sites_phase(model):
    """Every kernel site of the layout2i sampling path, taken from the
    model: each distinct kernel call of one all-kernel pass at this
    script's batch (``sampling_pass``), and flash and the VQ argmin at the
    decode chunk of 32, each against its plain version with the
    tolerances above. Returns one "other sites" entry per site."""
    with all_kernels():
        found = record_sites(lambda: sampling_pass(model, PATHS["layout2i"]))
    for name, site in L2I_NAMED_SITES:
        if site not in found[name]:
            raise AssertionError(f"the layout2i pass made no {name} call at "
                                 f"{site}: {sorted(found[name], key=str)}")
    found["flash_attention"].add(L2I_CHUNK_FLASH)
    found["vq_argmin"].add(L2I_CHUNK_VQ)
    return check_sites(found, "layout2i sampling")


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
            x, w, b, ns, nb, g, bt = fused_operands(
                shape, cout, torch.bfloat16, spade, 70)
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
    8192-entry codebooks. The encoder maps 64^2 images to the 32^2 latent:
    a three-level trunk with attention at 32^2, heads on the 32^2 and 16^2
    taps (1024 and 256 tokens), the shared decoder at its fixed width."""
    cfg = copy.deepcopy(load_yaml(str(T2I))["model"])
    p = cfg["params"]
    p["image_size"] = 32
    p["unet_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
        attention_resolutions=[2], num_head_channels=16, context_dim=32)
    first = p["first_stage_config"]["params"]
    first["ddconfig"].update(ch=32, ch_mult=[1, 1], num_res_blocks=1,
                             attn_resolutions=[32], resolution=64)
    first["edconfig"].update(ch=32, ch_mult=[1, 1, 2], num_res_blocks=1,
                             attn_resolutions=[32], resolution=64)
    p["cond_stage_config"]["params"].update(n_embed=32, n_layer=1)
    return cfg



def toy_phase(label):
    """The toy model on the card (kernels) against the same weights on the
    CPU (plain versions), in the current configuration; returns the
    launches of the card run."""
    cpu, gpu = toy_models(toy_config())
    tokens = np.random.default_rng(3).integers(0, 30522, (2, CTX_LEN))
    x_init = seeded((2, 32, 32, 8), 4, device="cpu")
    latents = []
    zero_launches()
    for model in (cpu, gpu):
        ctx = model.get_learned_conditioning(tokens)
        uctx = model.get_learned_conditioning(np.zeros_like(tokens))
        z = model.sample(2, context=ctx, uncond_context=uctx, steps=4,
                         eta=0.0, guidance_scale=GUIDANCE, x_init=x_init,
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
    n_attn = count(gpu.first_stage_model.decoder, AttnBlock)
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
    decided = check_codes(cpu.first_stage_model, codes_c, codes_g,
                          [z[..., :4], z[..., 4:]])
    img_c, img_err = images_from_cpu_codes(cpu.first_stage_model,
                                           gpu.first_stage_model, codes_c)
    launches = read_launches()
    log(f"toy model card vs CPU ({label}): latent max_abs_err {lat_err:.3e} "
        f"(tol {TOY_LATENT_ATOL}), codes equal at {decided} decided rows, "
        f"image max_abs_err {img_err:.3e} (tol {TOY_IMAGE_ATOL}), image range "
        f"[{img_c.min().item():.3f}, {img_c.max().item():.3f}], launches "
        f"{launches}")
    return launches


def images_from_cpu_codes(fc, fg, codes):
    """Decode the quantized latent of the CPU's ``codes`` on the CPU's
    first stage ``fc`` and the card's ``fg``; raise unless the images agree
    within ``TOY_IMAGE_ATOL``. Returns (CPU image, max error)."""
    quant = torch.cat([fc.ms_quantize[i].embedding.weight[codes[i].long()]
                       for i in reversed(range(len(codes)))], dim=-1)
    with torch.no_grad():
        img_c = fc.decode(quant)
        img_g = fg.decode(quant.cuda()).cpu()
    err = (img_c - img_g).abs().max().item()
    if not err <= TOY_IMAGE_ATOL:
        raise AssertionError(f"toy image card vs CPU {err} > "
                             f"{TOY_IMAGE_ATOL}")
    return img_c, err


def toy_models(cfg):
    """The same seeded toy model on the CPU and on the card."""
    cpu = instantiate_from_config(cfg, device="cpu", seed=1)
    randomize_zero_init_(cpu, 2)
    gpu = instantiate_from_config(cfg, seed=1)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def check_codes(first_stage, codes_c, codes_g, latents):
    """Raise unless the CPU's and the card's codes agree at every row
    whose best and second-best distances (float64, from the CPU latent of
    each scale) differ by more than 1e-5; returns the count of such rows."""
    decided = 0
    for i, (cc, cg, zz) in enumerate(zip(codes_c, codes_g, latents)):
        book = first_stage.ms_quantize[i].embedding.weight.double().cpu()
        zz = zz.reshape(-1, book.shape[1]).double().cpu()
        dist = (book * book).sum(1)[None] - 2 * zz @ book.t()
        top2 = dist.topk(2, dim=1, largest=False).values
        keep = (top2[:, 1] - top2[:, 0]) > VQ_DIST_ATOL
        decided += int(keep.sum())
        if not bool((cc.cpu().reshape(-1)[keep]
                     == cg.cpu().reshape(-1)[keep]).all()):
            raise AssertionError(f"codes of scale {i} differ at a decided "
                                 f"row")
    return decided


def toy_encode_phase(label):
    """The toy model's encode side on the card against the CPU, in the
    current configuration: ``encode_first_stage``, the round trip through
    ``decode_first_stage``, and ``forward_with_aux`` (``MSFPNVQModel``'s
    training forward) of its first stage. Every code is held to the margin
    rule, and the CPU goes on from the card's codes, so that a near tie the
    two sums break apart cannot reach a later comparison: the coarse latent
    and codes; the fine latent from the card's coarse codes (the fusion
    heads) and its codes; the diffusion latent; the images and codebook
    loss of ``forward_with_aux``, decoded on the CPU from the card's
    quantized latent; the round trip's codes, and its image decoded from
    the CPU's codes on both."""
    cpu, gpu = toy_models(toy_config())
    fc, fg = cpu.first_stage_model, gpu.first_stage_model
    x = seeded((2, 64, 64, 3), 6, device="cpu").tanh()
    xg = x.cuda()
    with torch.no_grad():
        (h0, q0, _, i0), (h1, _, _, i1) = fg._fused_prequant(to_nchw(xg))
        z_g = gpu.encode_first_stage(xg)
        quant_g, _, _ = fg.encode(xg)
        dec_g, aux_g, loss_g, _ = fg.forward_with_aux(xg)
        fine_tap, coarse_tap = fc.encoder(to_nchw(x))
        h0_c = fc.ms_quant_conv[0](coarse_tap)
        fused = fc.shared_decoder[0](torch.cat([fc.shared_post_quant_conv[0](
            fc.upsample[0](q0.cpu())), fine_tap], dim=1))
        h1_c = fc.ms_quant_conv[1](fused)
        pre = [to_nhwc(h0_c), to_nhwc(h1_c)]
        (_, loss0, c0), (_, loss1, c1) = (fc.ms_quantize[i](pre[i])
                                          for i in (0, 1))
    decided = check_codes(fc, [c0, c1], [i0, i1], pre)
    z_c = cpu._scale_latent(to_nhwc(torch.cat(
        [interpolate_nearest_2x(h0_c), h1_c], dim=1)), invert=False)
    lat_err = max((h0.cpu() - h0_c).abs().max().item(),
                  (h1.cpu() - h1_c).abs().max().item(),
                  (z_g.cpu() - z_c).abs().max().item())
    if not lat_err <= TOY_ENCODE_ATOL:
        raise AssertionError(f"toy encode card vs CPU {lat_err} > "
                             f"{TOY_ENCODE_ATOL}")
    loss_c = loss0 + loss1
    loss_err = abs(loss_g.item() - loss_c.item()) / loss_c.item()
    if not loss_err <= TOY_ENCODE_ATOL:
        raise AssertionError(f"toy codebook loss card vs CPU: relative "
                             f"{loss_err} > {TOY_ENCODE_ATOL}")
    # forward_with_aux's images: its quantized latent, then the coarse and
    # the fine channel group alone
    quant = quant_g.cpu()
    groups = [quant, quant.clone(), quant.clone()]
    groups[1][..., :4] = 0.0
    groups[2][..., 4:] = 0.0
    with torch.no_grad():
        imgs_c = [fc.decode(q) for q in groups]
    img_err = max((a - b.cpu()).abs().max().item()
                  for a, b in zip(imgs_c, [dec_g] + aux_g))
    if not img_err <= TOY_IMAGE_ATOL:
        raise AssertionError(f"toy forward_with_aux images card vs CPU "
                             f"{img_err} > {TOY_IMAGE_ATOL}")
    # the round trip: the card's diffusion latent decoded on both
    z = cpu._scale_latent(z_g.cpu(), invert=True)
    with torch.no_grad():
        img_g, codes_g = gpu.decode_first_stage_with_codes(z_g)
        _, codes_c = cpu.decode_first_stage_with_codes(z_g.cpu())
    trip_decided = check_codes(fc, codes_c, codes_g,
                               [z[..., :4], z[..., 4:]])
    trip_c, trip_err = images_from_cpu_codes(fc, fg, codes_c)
    if not bool(torch.isfinite(img_g).all()):
        raise AssertionError("toy round trip: non-finite image")
    rows = sum(c.numel() for c in (c0, c1))
    log(f"toy encode card vs CPU ({label}): latents max_abs_err "
        f"{lat_err:.3e} (tol {TOY_ENCODE_ATOL}), codes equal at {decided} "
        f"decided rows of {rows}; forward_with_aux images max_abs_err "
        f"{img_err:.3e} (tol {TOY_IMAGE_ATOL}), codebook loss relative "
        f"error {loss_err:.3e}; round trip codes equal at {trip_decided} "
        f"decided rows, image max_abs_err {trip_err:.3e}, range "
        f"[{trip_c.min().item():.3f}, {trip_c.max().item():.3f}]")


def sampler_phase():
    """Each sampler on the toy model with its schedule cut to
    ``TOY_TIMESTEPS``, card against CPU, CFG 1.5 sequential: PLMS, DDIM
    with eta 1, DPM-Solver++(2M) at 4 steps, the vanilla chain over every
    timestep. Every random number comes from a CPU generator seeded alike
    for both runs, so both see the same noise."""
    cfg = toy_config()
    cfg["params"]["timesteps"] = TOY_TIMESTEPS
    cpu, gpu = toy_models(cfg)
    tokens = np.random.default_rng(3).integers(0, 30522, (2, CTX_LEN))
    for sampler, eta in TOY_SAMPLERS:
        latents = []
        for model in (cpu, gpu):
            ctx = model.get_learned_conditioning(tokens)
            uctx = model.get_learned_conditioning(np.zeros_like(tokens))
            gen = torch.Generator().manual_seed(5)
            z = model.sample(2, context=ctx, uncond_context=uctx, steps=4,
                             eta=eta, guidance_scale=GUIDANCE,
                             sampler=sampler, cfg_mode="sequential",
                             generator=gen)
            latents.append(z.cpu())
        err = (latents[0] - latents[1]).abs().max().item()
        if not (bool(torch.isfinite(latents[1]).all())
                and err <= TOY_LATENT_ATOL):
            raise AssertionError(f"toy {sampler} latent card vs CPU {err} > "
                                 f"{TOY_LATENT_ATOL}")
        log(f"toy sampler {sampler} (eta {eta}, {TOY_TIMESTEPS} timesteps) "
            f"card vs CPU: latent max_abs_err {err:.3e} (tol "
            f"{TOY_LATENT_ATOL}), latent std "
            f"{latents[0].std().item():.4f}")


# ---------------------------------------------------------------------------
def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_main_path(model, path, seed, steps):
    """tokens -> context -> the path's sampler -> decode, as bench.py's
    pipeline; returns (image, latent, phase seconds). The conditioning
    token ids are seeded below the path's ``token_high``, the
    unconditional branch's are 0."""
    shape = (BATCH, path["ctx_len"])
    utokens = np.zeros(shape, np.int64)
    tokens = np.random.default_rng(seed).integers(0, path["token_high"],
                                                  shape)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        (ctx, uctx), t_cond = timed(lambda: (
            model.get_learned_conditioning(tokens),
            model.get_learned_conditioning(utokens)))
    z, t_sample = timed(lambda: model.sample(
        BATCH, context=ctx, uncond_context=uctx, steps=steps,
        eta=path["eta"], guidance_scale=GUIDANCE, sampler=path["sampler"],
        compute_dtype=torch.bfloat16, cfg_mode="sequential", generator=gen))
    img, t_decode = timed(lambda: model.decode_first_stage(
        z, chunk=DECODE_CHUNK))
    return img, z, dict(cond=t_cond, sample=t_sample, decode=t_decode)


def unet_calls(model, sampler, steps):
    """UNet calls of one chain under CFG sequential (two a evaluation):
    per stage PLMS makes S + 1 evaluations (step 0 takes two), DDIM and
    DPM-Solver++ S, the vanilla chain one per timestep of the schedule."""
    if sampler == "vanilla":
        per_stage = model.schedule.num_timesteps
    else:
        per_stage = DDIMSchedule.create(model.schedule, steps).num_steps
        per_stage += sampler == "plms"
    return model.num_stage * per_stage * 2


def unet_tokens(model):
    """Tokens of each SpatialTransformer's self-attention in one UNet call,
    walked from the latent size through the UNet's down- and upsamples."""
    side = model.image_size
    tokens = []
    for _, layers in model.model.diffusion_model._trunk():
        for _, mod in layers:
            if isinstance(mod, UNetDownsample):
                side //= 2
            elif isinstance(mod, UNetUpsample):
                side *= 2
            elif isinstance(mod, SpatialTransformer):
                tokens.append(side * side)
    return tokens


def decoder_tokens(dec, side):
    """Tokens of each AttnBlock of a VQGAN Decoder fed a side x side
    latent: the middle one, then each up level's from the coarsest."""
    tokens = [side * side]
    for i in reversed(range(len(dec.up))):
        tokens += [side * side] * len(dec.up[i]["attn"])
        if "upsample" in dec.up[i]:
            side *= 2
    return tokens


def n_3x3(*modules):
    return sum(isinstance(m, Conv2d) and m.is_3x3_same
               for module in modules for m in module.modules())


def first_stage_arch(first, image_side):
    """The MS-VQGAN's kernel sites, counted from its modules for images of
    image_side^2. Encode: every 3x3 conv and GroupNorm of the encoder and
    the shared decoders, the tokens of each AttnBlock (the trunk's, walked
    through its downsamples; each head's over its tap; each shared
    decoder's over the finer scale's grid); decode: the decoder's, from the
    finest grid."""
    enc = first.encoder
    side, tokens, taps = image_side, [], []
    for level in enc.down:
        tokens += [side * side] * len(level["attn"])
        taps.append(side)
        if "downsample" in level:
            side //= 2
    taps = taps[-enc.multiscale:]             # finer -> coarser
    tokens += [s * s for s in taps]
    for dec, s in zip(first.shared_decoder, taps[::-1][1:]):
        tokens += decoder_tokens(dec, s)
    return dict(
        encode_3x3=n_3x3(enc, first.shared_decoder),
        encode_norms=count(enc, GroupNorm) + count(first.shared_decoder,
                                                   GroupNorm),
        encode_attn_tokens=tokens,
        first_stage_3x3=n_3x3(first.decoder),
        first_stage_norms=count(first.decoder, GroupNorm),
        first_stage_attn=count(first.decoder, AttnBlock),
        decoder_attn_tokens=decoder_tokens(first.decoder, taps[0]),
        codebooks=count(first, VectorQuantizer))


def architecture(model, path, steps):
    """The sites of the model that the kernels serve, counted from its
    modules, and the UNet calls of a run of the path's sampler."""
    unet = model.model.diffusion_model
    return dict(
        first_stage_arch(model.first_stage_model, 256),
        res_blocks=count(unet, ResBlock),
        transformers=count(unet, SpatialTransformer),
        upsamples=sum(isinstance(m, UNetUpsample) and m.conv is not None
                      for m in unet.modules()),
        bert_layers=count(model.cond_stage_model, XAttention),
        unet_attn_tokens=unet_tokens(model), ctx_len=path["ctx_len"],
        unet_calls=unet_calls(model, path["sampler"], steps),
        table_stages=model.num_stage - 1)


def attention_route(nq, nk):
    """The kernel an attention of nq queries over nk keys takes in the
    current configuration, by the gates ``dot_attention`` asks, or None
    for the plain form."""
    if dispatch.use_flash(nk):
        return "flash_attention"
    if dispatch.use_smalls(nq, nk):
        return "smalls_attention"
    return None


def route_attention(want, sites):
    """Add to ``want`` the kernel launches of attention ``sites`` (nq, nk,
    times), each routed by ``attention_route``."""
    for nq, nk, times in sites:
        kernel = attention_route(nq, nk)
        if kernel is not None:
            want[kernel] += times


def expected_first_stage_launches(arch, all_kernel, encodes=0, decodes=0,
                                  requantizes=0):
    """Each kernel's launches in ``encodes`` encodes (encoder, fusion heads
    and a VQ argmin per codebook), ``decodes`` decoder runs and
    ``requantizes`` per-scale re-quantizations of a diffusion latent:
    attention routed by its tokens; in the all-kernel configuration every
    3x3 conv and GroupNorm of those parts (the 1x1, stride-2 and transposed
    convs stay plain)."""
    a = arch
    want = {name: 0 for name in KERNELS}
    route_attention(want, [(t, t, encodes) for t in a["encode_attn_tokens"]]
                    + [(t, t, decodes) for t in a["decoder_attn_tokens"]])
    want["vq_argmin"] = a["codebooks"] * (encodes + requantizes)
    if all_kernel:
        want["conv3x3"] = (a["encode_3x3"] * encodes
                           + a["first_stage_3x3"] * decodes)
        want["group_norm"] = (a["encode_norms"] * encodes
                              + a["first_stage_norms"] * decodes)
    return want


def expected_launches(arch, all_kernel):
    """Each kernel's launches in one main-path run.

    Attention: each SpatialTransformer's self-attention (over its tokens)
    and cross-attention (its tokens over the context) in every UNet call,
    one attention per BERT layer for each of the 2 conditionings, one per
    decoder AttnBlock in each decoded chunk, each counted for the kernel
    its token counts route it to in the current configuration. Per UNet
    call in the all-kernel
    configuration: 2 fused prologues per ResBlock; 3x3 convs at pre_input,
    each upsample and the out head; a GroupNorm in each SpatialTransformer
    and the out head. Once per stage after the first, the SPADE tables: the
    pre_input_cond conv and three 3x3 convs at each SPADE site (2 per
    ResBlock, 1 per SpatialTransformer). Decode, once per chunk: every 3x3
    conv and GroupNorm of the first stage, a VQ argmin per codebook."""
    a = arch
    chunks = BATCH // DECODE_CHUNK if (BATCH > DECODE_CHUNK and
                                       BATCH % DECODE_CHUNK == 0) else 1
    calls, ctx = a["unet_calls"], a["ctx_len"]
    want = dict(flash_attention=0, vq_argmin=a["codebooks"] * chunks,
                group_norm=0, smalls_attention=0, conv3x3=0,
                conv3x3_norm_silu=0)
    sites = [(tok, tok, calls) for tok in a["unet_attn_tokens"]]
    sites += [(tok, ctx, calls) for tok in a["unet_attn_tokens"]]
    sites += [(ctx, ctx, 2 * a["bert_layers"])]
    sites += [(tok, tok, chunks) for tok in a["decoder_attn_tokens"]]
    route_attention(want, sites)
    if all_kernel:
        want.update(
            conv3x3_norm_silu=2 * a["res_blocks"] * calls,
            conv3x3=((1 + a["upsamples"] + 1) * calls
                     + a["table_stages"] * (
                         1 + 3 * (2 * a["res_blocks"] + a["transformers"]))
                     + a["first_stage_3x3"] * chunks),
            group_norm=((a["transformers"] + 1) * calls
                        + a["first_stage_norms"] * chunks))
    return want


def count(module, cls):
    return sum(isinstance(m, cls) for m in module.modules())


def main_path_phase(card, model, task, label):
    """One path in the current configuration: launches held to the
    architecture's, the outputs checked, a second run timed, a profile."""
    path = PATHS[task]
    all_kernel = label == "all-kernel"
    steps = path["all_kernel_steps" if all_kernel else "steps"]
    name = f"{task}, {label}"
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    img, z, secs = drive_main_path(model, path, seed=0, steps=steps)
    launches = read_launches()
    arch = architecture(model, path, steps)
    if {k: arch[k] for k in path["arch"]} != path["arch"]:
        raise AssertionError(f"the {task} model has {arch}, not "
                             f"{path['arch']}")
    want = expected_launches(arch, all_kernel)
    log(f"main path ({name}) launches {launches}; from the architecture "
        f"{arch}: {want}")
    if launches != want:
        raise AssertionError(f"main path ({name}) launches {launches}, "
                             f"expected {want}")
    if tuple(img.shape) != (BATCH, 256, 256, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    latent = (BATCH, model.image_size, model.image_size, model.channels)
    if tuple(z.shape) != latent:
        raise AssertionError(f"latent shape {tuple(z.shape)}, not {latent}")
    if not (bool(torch.isfinite(img).all()) and
            bool(torch.isfinite(z).all())):
        raise AssertionError("non-finite latent or image")
    spread = img.float().std().item()
    if not spread > 1e-4:
        raise AssertionError(f"constant image (std {spread})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    _, _, warm = drive_main_path(model, path, seed=1, steps=steps)
    for run, s in (("first run", secs), ("second run", warm)):
        total = sum(s.values())
        log(f"main path ({name}) {run} on {card}: batch {BATCH}, "
            f"{path['sampler']} {steps} steps x 2 stages, CFG {GUIDANCE} "
            f"sequential, bf16 UNet: cond {s['cond']:.3f} s, sample "
            f"{s['sample']:.3f} s, decode {s['decode']:.3f} s, total "
            f"{total:.3f} s, {BATCH / total:.4f} img/s")
    log(f"main path ({name}): image std {spread:.4f}, range "
        f"[{img.min().item():.3f}, {img.max().item():.3f}], peak device "
        f"memory {peak_gib:.2f} GiB")
    profile_phase(model, path, name)
    return launches


def peak_above(run):
    """(run's result, its peak device memory above what was allocated
    before it, GiB)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def check_first_stage_arch(first, want, label):
    arch = first_stage_arch(first, 256)
    if {k: arch[k] for k in want} != want:
        raise AssertionError(f"the {label} first stage has {arch}, not "
                             f"{want}")
    return arch


def held_launches(name, want):
    """Raise unless the launches since the last ``zero_launches`` are
    ``want``; returns them."""
    got = read_launches()
    if got != want:
        raise AssertionError(f"{name} launches {got}, expected {want}")
    return got


def check_images(img, name):
    if tuple(img.shape) != (BATCH, 256, 256, 3):
        raise AssertionError(f"{name}: image shape {tuple(img.shape)}")
    spread = img.float().std().item()
    if not (bool(torch.isfinite(img).all()) and spread > 1e-4):
        raise AssertionError(f"{name}: non-finite or constant image "
                             f"(std {spread})")
    return spread


def first_stage_phase(card, model, task, label):
    """The path's first stage at full width, batch 4, in the current
    configuration: ``encode_first_stage`` and then ``decode_first_stage``
    of seeded images, each with its launches held to the architecture's;
    the round-trip invariant; times of a second run, peak memory and a
    profile of one encode."""
    path = PATHS[task]
    all_kernel = label == "all-kernel"
    name = f"{task} first stage, {label}"
    first = model.first_stage_model
    arch = check_first_stage_arch(first, path["encode_arch"], task)
    x = seeded_images(34)
    zero_launches()
    (z, t_encode), enc_gib = peak_above(
        lambda: timed(lambda: model.encode_first_stage(x)))
    enc = held_launches(f"{name} encode", expected_first_stage_launches(
        arch, all_kernel, encodes=1))
    latent = (BATCH, model.image_size, model.image_size, model.channels)
    if tuple(z.shape) != latent or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{name}: latent {tuple(z.shape)}, not a "
                             f"finite {latent}")
    zero_launches()
    (img, t_decode), dec_gib = peak_above(
        lambda: timed(lambda: model.decode_first_stage(z)))
    held_launches(f"{name} decode", expected_first_stage_launches(
        arch, all_kernel, decodes=1, requantizes=1))
    spread = check_images(img, name)

    # quantizing is per vector and the nearest 2x upsample repeats vectors:
    # re-quantizing the diffusion latent gives encode's codes, the coarse
    # ones upsampled, and decode(encode(x)[0])'s image
    with torch.no_grad():
        quant, _, (coarse, fine) = first.encode(x)
        img_rt, codes = first.decode_interface(first.encode_interface(x),
                                               return_code=True)
        img_q = first.decode(quant)
    up = coarse.repeat_interleave(2, 1).repeat_interleave(2, 2)
    if not (torch.equal(codes[0], up) and torch.equal(codes[1], fine)):
        raise AssertionError(f"{name}: re-quantized codes differ from "
                             f"encode's")
    rt_err = (img_rt - img_q).abs().max().item()
    if not rt_err <= ROUND_TRIP_ATOL:
        raise AssertionError(f"{name}: round-trip image differs by {rt_err} "
                             f"> {ROUND_TRIP_ATOL}")
    _, t_encode2 = timed(lambda: model.encode_first_stage(x))
    _, t_decode2 = timed(lambda: model.decode_first_stage(z))
    log(f"{name} on {card}: batch {BATCH}, fp32, latent {tuple(z.shape)} "
        f"std {z.std().item():.4f}; encode {t_encode:.4f} s / "
        f"{t_encode2:.4f} s (first / second run), decode {t_decode:.4f} / "
        f"{t_decode2:.4f} s; image std {spread:.4f}; peak device memory "
        f"above the model: encode {enc_gib:.3f} GiB, decode {dec_gib:.3f} "
        f"GiB; encode launches {enc}; round trip: codes "
        f"equal to encode's ({codes[0].numel()} + {codes[1].numel()}), "
        f"image max_abs_err {rt_err:.3e} (tol {ROUND_TRIP_ATOL})")
    profile_once(lambda: model.encode_first_stage(x), f"{name}, one encode")


def forward_with_aux_phase(card, model, label):
    """``MSFPNVQModel.forward_with_aux`` of the MS-VQGAN config at batch 4
    in the current configuration: one encode and three decodes (the image
    and the two aux images), launches held to the architecture's; the
    outputs checked; the time of a second run, peak memory, a profile."""
    all_kernel = label == "all-kernel"
    name = f"MSFPNVQModel.forward_with_aux, {label}"
    arch = check_first_stage_arch(model, T2I_ENCODE_ARCH, "MS-VQGAN")
    want_dec = {k: T2I_ARCH[k] for k in ("first_stage_3x3",
                                         "first_stage_norms",
                                         "first_stage_attn")}
    if {k: arch[k] for k in want_dec} != want_dec:
        raise AssertionError(f"the MS-VQGAN decoder has {arch}")
    x = seeded_images(35)

    def run():
        with torch.no_grad():
            return model.forward_with_aux(x)

    zero_launches()
    ((img, aux, loss, idx), secs), gib = peak_above(lambda: timed(run))
    launches = held_launches(name, expected_first_stage_launches(
        arch, all_kernel, encodes=1, decodes=3))
    spreads = [check_images(i, name) for i in [img] + aux]
    shapes = [tuple(i.shape) for i in idx]
    if shapes != [(BATCH, 16, 16), (BATCH, 32, 32)] or not bool(
            torch.isfinite(loss)):
        raise AssertionError(f"{name}: indices {shapes}, loss {loss}")
    gap = min((img - a).abs().max().item() for a in aux)
    if not gap > 1e-3:
        raise AssertionError(f"{name}: an aux image equals the image")
    _, secs2 = timed(run)
    log(f"{name} on {card}: batch {BATCH}, fp32: {secs:.4f} s / "
        f"{secs2:.4f} s (first / second run), peak device memory above "
        f"the model {gib:.3f} GiB, image std {spreads}, codebook loss "
        f"{loss.item():.4e}, launches {launches}")
    profile_once(run, name)


# ---------------------------------------------------------------------------
# training
def record_optimizer_grads(opt, module):
    """Wrap ``opt.step`` to keep the gradients it gets, by parameter name."""
    grads = {}
    names = {id(p): n for n, p in module.named_parameters()}
    real = opt.step

    def step():
        for group in opt.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = (torch.zeros_like(p) if p.grad is None
                                       else p.grad.detach().clone())
        return real()

    opt.step = step
    return grads


def grad_errors(got, ref):
    """Per leaf of ``ref``: (largest error / its tolerance, 2-norm of the
    error / the leaf's 2-norm, or None for a leaf under
    TRAIN_GRAD_NORM_FROM of the largest), the tolerance as set out with
    the training tolerances above."""
    big = max(g.abs().max().item() for g in ref.values())
    out = {}
    for k, g in ref.items():
        d = got[k].cpu().to(g.dtype) - g
        tol = TRAIN_GRAD_RTOL * max(g.abs().max().item(),
                                    TRAIN_GRAD_FLOOR * big)
        rel = (d.norm() / g.norm()).item() if (
            g.abs().max().item() >= TRAIN_GRAD_NORM_FROM * big) else None
        out[k] = (d.abs().max().item() / tol, rel, tol)
    return out


def compare_train_state(name, cpu, gpu, lr, exact=None):
    """Card against CPU after one step. ``cpu``, ``gpu``: (gradients by
    name, optimizer, module, trainer with an EMA or None); ``exact``: the
    step's gradients in float64, the reference where given (else the
    CPU's). Every gradient within its tolerances of the reference
    (``grad_errors``), the weights within 2 lr, the Adam moments within
    (1 - b1), (1 - b2) times the bound on the card's and the CPU's
    gradient difference, the EMA within (1 - d) 2 lr. Returns the largest
    errors."""
    (grads_c, opt_c, mod_c, tr_c), (grads_g, opt_g, mod_g, tr_g) = cpu, gpu
    ref = grads_c if exact is None else exact
    if set(grads_g) != set(grads_c) or set(ref) != set(grads_c):
        raise AssertionError(f"{name}: gradients of other parameters")
    card = grad_errors(grads_g, ref)
    ratios = sorted((r, k) for k, (r, _, _) in card.items())
    rels = sorted((r, k) for k, (_, r, _) in card.items() if r is not None)
    log(f"{name}: gradient error / tolerance, the largest three: "
        f"{[(round(r, 3), k) for r, k in ratios[-3:]]}; relative norm of "
        f"the error, the largest three: "
        f"{[(float(f'{r:.3e}'), k) for r, k in rels[-3:]]}")
    errs = dict(grad_ratio=ratios[-1][0], grad_norm_rel=rels[-1][0],
                weight=0.0, mu=0.0, nu=0.0)
    bad = [(r, k) for r, k in ratios if not r <= 1.0] + [
        (r, k) for r, k in rels if not r <= TRAIN_GRAD_NORM_RTOL]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} gradients card vs CPU "
                             f"beyond their tolerance: {bad[-5:]}")
    cpu_err = {k: (0.0, None, 0.0) for k in grads_c}
    if exact is not None:
        cpu_err = grad_errors(grads_c, exact)
        worst = max((r, k) for k, (r, _, _) in cpu_err.items())
        worst_rel = max((r, k) for k, (_, r, _) in cpu_err.items()
                        if r is not None)
        log(f"{name}: the CPU's fp32 gradient against float64, the largest "
            f"error / tolerance {worst[0]:.3e} ({worst[1]}), relative norm "
            f"{worst_rel[0]:.3e} ({worst_rel[1]})")
    params_g = dict(mod_g.named_parameters())
    b1, b2 = opt_c.defaults["b1"], opt_c.defaults["b2"]
    for k, p in mod_c.named_parameters():
        err = (params_g[k].detach().cpu() - p.detach()).abs().max().item()
        errs["weight"] = max(errs["weight"], err)
        if not err <= 2 * lr:
            raise AssertionError(f"{name}: weight {k} card vs CPU {err} > "
                                 f"2 lr")
        if k not in grads_c:
            continue
        st_c, st_g = opt_c.state[p], opt_g.state[params_g[k]]
        g_max = grads_c[k].abs().max().item()
        # the card's and the CPU's gradients each lie within their error
        # of the reference
        gap = card[k][2] * (1.0 + cpu_err[k][0])
        for m, tol in (("mu", (1 - b1) * gap + 1e-9),
                       ("nu", (1 - b2) * (2 * g_max * gap + gap ** 2)
                        + 1e-12)):
            err = (st_g[m].cpu() - st_c[m]).abs().max().item()
            errs[m] = max(errs[m], err)
            if not err <= tol:
                raise AssertionError(f"{name}: Adam {m} of {k} card vs CPU "
                                     f"{err} > {tol}")
    if tr_c is not None:
        n = tr_c.ema.num_updates
        d = min(0.9999, (1 + n) / (10 + n))
        errs["ema"] = max((tr_g.ema.shadow[k].cpu() - v).abs().max().item()
                          for k, v in tr_c.ema.shadow.items())
        if not errs["ema"] <= (1 - d) * 2 * lr + 1e-7:
            raise AssertionError(f"{name}: EMA card vs CPU {errs['ema']}")
    return {k: float(f"{v:.3e}") for k, v in errs.items()}


def toy_exact_grads(model, images, tokens, seed):
    """The toy diffusion step's gradients in float64 on the CPU: a float64
    copy of ``model`` (before its step) through the trainer's own draws,
    encode, conditioning and ``training_loss``."""
    m = copy.deepcopy(model).double()
    m.train()
    m.first_stage_model.requires_grad_(False)
    shape = (images.shape[0], m.image_size, m.image_size, m.channels)
    t, noise = trainer._draw(torch.Generator().manual_seed(seed),
                             images.shape[0], m.timesteps, shape, "cpu")
    z = m.encode_first_stage(images.double())
    loss, _ = m.training_loss(z, m.get_learned_conditioning(tokens), t,
                              noise.double())
    loss.backward()
    return {k: p.grad for k, p in trainer.trainable_parameters(m)}


def toy_train_config():
    """The toy t2i model with codebooks of 32: a near tie between two codes
    the CPU and the card break apart cannot then reach a comparison."""
    cfg = toy_config()
    cfg["params"]["first_stage_config"]["params"]["n_embed"] = [32, 32]
    return cfg


def toy_training_phase(label):
    """One diffusion train step and one GAN step before and after
    ``disc_start`` on the toy models, card against CPU from the same
    weights in fp32, in the current configuration: the loss and logs,
    every gradient (the diffusion step's against float64 on the CPU), the
    updated weights, the Adam moments, the EMA, d_weight and the BatchNorm
    running statistics."""
    cpu, gpu = toy_models(toy_train_config())
    images = seeded((2, 64, 64, 3), 7, device="cpu").tanh()
    tokens = np.random.default_rng(8).integers(0, 30522, (2, CTX_LEN))
    exact = toy_exact_grads(cpu, images, tokens, 9)
    runs = []
    for model in (cpu, gpu):
        opt = optim.build_optimizer(
            [p for _, p in trainer.trainable_parameters(model)], TOY_LR)
        tr = trainer.DiffusionTrainer(model, opt)
        grads = record_optimizer_grads(opt, model)
        gen = torch.Generator().manual_seed(9)     # t, noise drawn on the CPU
        logs = tr.train_step({"image": images.to(model.device),
                              "tokens": tokens}, gen)
        runs.append((tr, logs, grads))
    (tc, lc, gc), (tg, lg, gg) = runs
    loss_err = max(abs(lc[k].item() - lg[k].item()) for k in lc)
    if not loss_err <= TOY_TRAIN_LOSS_ATOL:
        raise AssertionError(f"toy train step ({label}) logs card vs CPU "
                             f"{loss_err} > {TOY_TRAIN_LOSS_ATOL}")
    errs = compare_train_state(f"toy train step ({label})",
                               (gc, tc.optimizer, cpu, tc),
                               (gg, tg.optimizer, gpu, tg), TOY_LR, exact)
    log(f"toy diffusion train step card vs CPU ({label}, fp32): loss "
        f"{lc['loss'].item():.6f}, logs max_abs_err {loss_err:.3e} (tol "
        f"{TOY_TRAIN_LOSS_ATOL}); largest errors {errs} (gradients per leaf "
        f"against float64 within {TRAIN_GRAD_RTOL} of its max, floor "
        f"{TRAIN_GRAD_FLOOR}, and {TRAIN_GRAD_NORM_RTOL} of its norm; weights "
        f"2 lr = {2 * TOY_LR}, no signal at step 1)")

    first = toy_train_config()["params"]["first_stage_config"]["params"]
    x = seeded((2, 64, 64, 3), 10, device="cpu").tanh()
    for start in (0, 1):
        runs = []
        model_c = MSFPNVQModel(**first, device="cpu", seed=11)
        loss_c = VQLPIPSWithDiscriminator(**TOY_GAN_LOSS, device="cpu",
                                          seed=12)
        model_g = MSFPNVQModel(**first, seed=None)
        loss_g = VQLPIPSWithDiscriminator(**TOY_GAN_LOSS, seed=None)
        model_g.load_state_dict(model_c.state_dict(), strict=True)
        loss_g.load_state_dict(loss_c.state_dict(), strict=True)
        for model, loss in ((model_c, loss_c), (model_g, loss_g)):
            device = model.decoder.conv_out.weight.device
            opt_g = optim.build_optimizer(list(model.parameters()), TOY_LR)
            opt_d = optim.build_optimizer(list(loss.parameters()), TOY_LR)
            tr = vqgan_trainer.VQGANTrainer(model, loss, opt_g, opt_d,
                                            use_aux_loss=True,
                                            start_step=start)
            gg_ = record_optimizer_grads(opt_g, model)
            gd_ = record_optimizer_grads(opt_d, loss)
            logs = tr.train_step(x.to(device))
            runs.append((tr, logs, gg_, gd_))
        (tc, lc, ggc, gdc), (tg, lg, ggg, gdg) = runs
        dw_err = abs(lg["d_weight"].item() / lc["d_weight"].item() - 1)
        log_err = max(abs(lc[k].item() - lg[k].item()) for k in lc
                      if k != "d_weight")
        if not (dw_err <= TOY_D_WEIGHT_RTOL and log_err <= TOY_IMAGE_ATOL):
            raise AssertionError(f"toy GAN step {start}: d_weight relative "
                                 f"{dw_err}, logs {log_err}")
        name = f"toy GAN step from step {start} ({label})"
        errs = compare_train_state(name, (ggc, tc.opt_g, tc.model, None),
                                   (ggg, tg.opt_g, tg.model, None), TOY_LR)
        d_errs = (compare_train_state(name, (gdc, tc.opt_d, tc.loss, None),
                                      (gdg, tg.opt_d, tg.loss, None),
                                      TOY_LR) if start else None)
        stats_g = tg.loss.state_dict()
        bn_err = max((stats_g[k].cpu() - v).abs().max().item()
                     for k, v in tc.loss.state_dict().items()
                     if "running" in k)
        if not bn_err <= TOY_IMAGE_ATOL:
            raise AssertionError(f"{name}: BatchNorm statistics card vs CPU "
                                 f"{bn_err}")
        log(f"{name} card vs CPU, fp32: discloss {lc['discloss'].item():.5f}"
            f", d_weight {lc['d_weight'].item():.5f} (relative error "
            f"{dw_err:.3e}, tol {TOY_D_WEIGHT_RTOL}), logs max_abs_err "
            f"{log_err:.3e} (tol {TOY_IMAGE_ATOL}), generator {errs}, "
            f"discriminator {d_errs}, running statistics max_abs_err "
            f"{bn_err:.3e}")


def site_grad_check(name, site):
    """The kernel under autograd against its plain version's autograd at
    one site, for one seeded cotangent: the largest gradient error over
    the inputs, relative to the largest plain gradient. The backward
    recomputes through the plain version in the inputs' dtype."""
    if name in ("flash_attention", "smalls_attention"):
        bh, nq, nk, d, dtype = site
        inputs = [seeded((bh, n, d), s, dtype)
                  for n, s in ((nq, 10), (nk, 11), (nk, 12))]
        scale = d ** -0.5
        kernel = lambda *a: KERNELS[name](*a, scale)
        plain = lambda *a: attention_plain(*a, scale)
    elif name == "group_norm":
        shape, dtype, groups, eps, silu = site
        inputs = [seeded(shape, 40, dtype), 1.0 + 0.1 * seeded(
            (shape[1],), 41), 0.1 * seeded((shape[1],), 42)]
        kernel = lambda *a: group_norm(*a, groups, eps, silu)
        plain = lambda *a: group_norm_plain(*a, groups, eps, silu)
    elif name == "conv3x3":
        shape, cout, dtype = site
        inputs = list(conv_operands(shape, cout, dtype, 50))
        kernel, plain = conv3x3, conv3x3_plain
    else:
        shape, cout, dtype, spade, groups, eps = site
        inputs = [t for t in fused_operands(shape, cout, dtype, spade, 60)
                  if t is not None]
        kernel = lambda *a: conv3x3_norm_silu(*a[:5], groups, eps, *a[5:])
        plain = lambda *a: conv3x3_norm_silu_plain(*a[:5], groups, eps,
                                                   *a[5:])
    dtype = inputs[0].dtype

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        cot = seeded(tuple(out.shape), 13, out.dtype)
        return torch.autograd.grad(out, leaves, cot)

    err = 0.0
    for a, r in zip(grads(kernel), grads(plain)):
        scale = r.float().abs().max().item()
        err = max(err, (a.float() - r.float()).abs().max().item()
                  / max(scale, 1e-30))
    tol = SITE_GRAD_RTOL[dtype]
    if not err <= tol:
        raise AssertionError(f"{name} {site}: gradient relative error {err} "
                             f"> {tol}")
    return err


def train_batch(n, seed, device="cuda"):
    """Seeded 256^2 images in [-1, 1] and t2i token ids."""
    return {"image": seeded((n, 256, 256, 3), seed, device=device).tanh(),
            "tokens": np.random.default_rng(seed).integers(
                0, 30522, (n, CTX_LEN))}


def diffusion_trainer(model, compute_dtype, remat=False):
    params = [p for _, p in trainer.trainable_parameters(model)]
    opt = optim.build_optimizer(params, TRAIN_LR)
    return trainer.DiffusionTrainer(model, opt, use_ema=True, remat=remat,
                                     compute_dtype=compute_dtype)


def gan_trainer(model, loss, start_step):
    """Adam (b1 0.5, b2 0.9, no decay) for both phases, as
    scripts/train_msvqgan.py trains the JAX package's."""
    opt_g, opt_d = (optim.build_optimizer(list(m.parameters()), GAN_LR,
                                          b1=0.5, b2=0.9, weight_decay=0.0)
                    for m in (model, loss))
    return vqgan_trainer.VQGANTrainer(model, loss, opt_g, opt_d,
                                      use_aux_loss=True,
                                      start_step=start_step)


def diffusion_sites_phase(model):
    """Every distinct kernel call of one all-kernel bf16 diffusion train
    step at the config's batch (encode, conditioning, both stages' UNet
    forwards), each forward checked as in ``check_sites`` unless checked
    before, and each call that takes a gradient checked by
    ``site_grad_check`` once."""
    with all_kernels():
        tr = diffusion_trainer(model, torch.bfloat16)
        batch = train_batch(TRAIN_BATCH, 14)
        found = record_sites(lambda: tr.train_step(
            batch, torch.Generator().manual_seed(15)), grad=True)
    del tr, batch
    torch.cuda.empty_cache()
    return check_sites(found, "t2i diffusion train step")


def gan_sites_phase(model, loss):
    """The same for one all-kernel GAN step at the config's batch."""
    with all_kernels():
        gan = gan_trainer(model, loss, GAN_DISC_START)
        x = seeded((GAN_BATCH, 256, 256, 3), 16).tanh()
        found = record_sites(lambda: gan.train_step(x), grad=True)
    del gan
    torch.cuda.empty_cache()
    return check_sites(found, "MS-VQGAN GAN step")


def expected_train_launches(arch, all_kernel, remat=False):
    """Each kernel's launches in one diffusion train step: one encode, one
    conditioning, one UNet forward per stage (stage 1 computes its SPADE
    tables in line: the pre_input_cond conv and three 3x3 convs at each
    SPADE site); the backward recomputes through the plain versions and
    launches nothing, except that ``remat`` runs the UNet forwards again."""
    a = arch
    runs = 2 if remat else 1
    calls = (a["table_stages"] + 1) * runs
    want = expected_first_stage_launches(a, all_kernel, encodes=1)
    route_attention(want, [(t, t, calls) for t in a["unet_attn_tokens"]]
                    + [(t, a["ctx_len"], calls)
                       for t in a["unet_attn_tokens"]]
                    + [(a["ctx_len"], a["ctx_len"], a["bert_layers"])])
    if all_kernel:
        want["conv3x3_norm_silu"] += 2 * a["res_blocks"] * calls
        want["conv3x3"] += ((1 + a["upsamples"] + 1) * calls
                            + a["table_stages"] * runs * (
                                1 + 3 * (2 * a["res_blocks"]
                                         + a["transformers"])))
        want["group_norm"] += (a["transformers"] + 1) * calls
    return want


def timed_steps(step, n):
    """Seconds of each of ``n`` calls of ``step``, each ending in a
    synchronise."""
    return [timed(step)[1] for _ in range(n)]


def diffusion_training_phase(card, model, label, compute_dtype, steps):
    """Full-width t2i diffusion training at the config's batch in the
    current configuration: ``steps`` = (warm-up, timed); launches per step
    held to the architecture's; the loss finite; the first stage bit for
    bit unchanged; the EMA counter and the EMA apart from the weights;
    img/s, step seconds, peak memory above the model, a profiled step.
    Returns the launches of one step."""
    all_kernel = label == "all-kernel"
    warm, timed_n = steps
    dt = "bf16" if compute_dtype is not None else "fp32"
    name = f"t2i diffusion training, {label}, {dt}"
    arch = architecture(model, PATHS["t2i"], 1)
    first = {k: v.clone() for k, v in
             model.first_stage_model.state_dict().items()}
    torch.cuda.synchronize()
    model_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    remat = False
    tr = diffusion_trainer(model, compute_dtype)
    gen = torch.Generator().manual_seed(17)
    batch = train_batch(TRAIN_BATCH, 18)
    try:
        zero_launches()
        logs, first_s = timed(lambda: tr.train_step(batch, gen))
    except torch.cuda.OutOfMemoryError as e:
        log(f"{name}: batch {TRAIN_BATCH} does not fit ({str(e)[:200]}); "
            f"the batch stays {TRAIN_BATCH} and the step runs with remat "
            f"(torch.utils.checkpoint over the diffusion loss)")
        del tr
        torch.cuda.empty_cache()
        remat = True
        tr = diffusion_trainer(model, compute_dtype, remat=True)
        zero_launches()
        logs, first_s = timed(lambda: tr.train_step(batch, gen))
    launches = read_launches()
    want = expected_train_launches(arch, all_kernel, remat)
    if launches != want:
        raise AssertionError(f"{name}: launches per step {launches}, "
                             f"expected {want}")
    secs = [first_s] + timed_steps(lambda: tr.train_step(batch, gen),
                                   warm + timed_n - 1)
    loss = logs["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: loss {loss}")
    peak_gib = (torch.cuda.max_memory_allocated() - model_bytes) / 2 ** 30
    state_gib = (torch.cuda.memory_allocated() - model_bytes) / 2 ** 30
    after = model.first_stage_model.state_dict()
    if not all(torch.equal(after[k], v) for k, v in first.items()):
        raise AssertionError(f"{name}: the frozen first stage changed")
    if tr.ema.num_updates != warm + timed_n:
        raise AssertionError(f"{name}: EMA counter {tr.ema.num_updates}")
    params = dict(tr.ema.module.named_parameters())
    if all(torch.equal(s, params[k]) for k, s in tr.ema.shadow.items()):
        raise AssertionError(f"{name}: the EMA equals the weights")
    step_s = secs[warm:] or secs
    log(f"{name} on {card}: batch {TRAIN_BATCH}, AdamW lr {TRAIN_LR:.2e} "
        f"(scaled_learning_rate(1e-6, {TRAIN_BATCH}, 1)), EMA on"
        f"{', remat' if remat else ''}: loss {loss:.5f} (first step), "
        f"{logs['loss_simple_stage0'].item():.5f} / "
        f"{logs['loss_simple_stage1'].item():.5f} per stage; step seconds "
        f"{[round(x, 4) for x in secs]} ({warm} warm-up), mean "
        f"{sum(step_s) / len(step_s):.4f} s, "
        f"{TRAIN_BATCH * len(step_s) / sum(step_s):.3f} img/s; peak device "
        f"memory above the model {peak_gib:.2f} GiB (optimizer state and "
        f"EMA {state_gib:.2f} GiB of it); launches per step {launches}; "
        f"EMA counter {tr.ema.num_updates}; first stage unchanged")
    if timed_n:
        profile_once(lambda: tr.train_step(batch, gen), f"{name}, one step")
    del tr
    torch.cuda.empty_cache()
    return launches


def gan_training_phase(card, model, loss, label, steps):
    """Full-width MS-VQGAN GAN training at the config's batch, fp32,
    ``use_aux_loss``, from step ``disc_start`` so both phases and d_weight
    are live, in the current configuration: launches per step held to the
    architecture's (one encode and three decodes of forward_with_aux; the
    discriminator's 4x4 convs and BatchNorms are plain); finite logs;
    img/s, step seconds, peak memory above the model, a profiled step."""
    all_kernel = label == "all-kernel"
    warm, timed_n = steps
    name = f"MS-VQGAN GAN training, {label}, fp32"
    arch = first_stage_arch(model, 256)
    torch.cuda.synchronize()
    model_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = gan_trainer(model, loss, GAN_DISC_START)
    x = seeded((GAN_BATCH, 256, 256, 3), 19).tanh()
    zero_launches()
    logs, first_s = timed(lambda: tr.train_step(x))
    launches = held_launches(name, expected_first_stage_launches(
        arch, all_kernel, encodes=1, decodes=3))
    secs = [first_s] + timed_steps(lambda: tr.train_step(x),
                                   warm + timed_n - 1)
    bad = {k: v.item() for k, v in logs.items()
           if not math.isfinite(v.item())}
    if bad or not logs["d_weight"].item() > 0 \
            or not logs["discloss"].item() > 0:
        raise AssertionError(f"{name}: logs {logs}")
    peak_gib = (torch.cuda.max_memory_allocated() - model_bytes) / 2 ** 30
    step_s = secs[warm:]
    log(f"{name} on {card}: batch {GAN_BATCH}, use_aux_loss, from step "
        f"{GAN_DISC_START} (disc_start), perceptual_weight "
        f"{loss.perceptual_weight if loss.use_lpips else 0}: aeloss "
        f"{logs['aeloss'].item():.5f}, discloss {logs['discloss'].item():.5f},"
        f" d_weight {logs['d_weight'].item():.5f} (first step); step seconds "
        f"{[round(s, 4) for s in secs]} ({warm} warm-up), timed mean "
        f"{sum(step_s) / len(step_s):.4f} s, "
        f"{GAN_BATCH * len(step_s) / sum(step_s):.3f} img/s; peak device "
        f"memory above the model {peak_gib:.2f} GiB; launches per step "
        f"{launches}")
    profile_once(lambda: tr.train_step(x), f"{name}, one step")
    del tr
    torch.cuda.empty_cache()
    return launches


def lpips_phase(card):
    """The LPIPS network with seeded weights at the GAN step's batch and
    256^2: all-kernel on the card (every VGG 3x3 conv on the conv kernel,
    Cin = 3 included) against the card's plain path and against the CPU."""
    cpu = LPIPS(device="cpu")
    init_module_(cpu, torch.Generator().manual_seed(20))
    with torch.no_grad():    # LPIPS's lin weights are non-negative
        for k in range(5):
            getattr(cpu, f"lin{k}").model["1"].weight.abs_()
    gpu = LPIPS()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = seeded((GAN_BATCH, 256, 256, 3), 21, device="cpu").tanh()
    y = (x + 0.3 * seeded(x.shape, 22, device="cpu")).clamp(-1, 1)
    with torch.no_grad():
        want = cpu(x, y)
        plain = gpu(x.cuda(), y.cuda())
        with all_kernels():
            zero_launches()
            got = gpu(x.cuda(), y.cuda())
            n = conv3x3.launches
    if n != 2 * 13:
        raise AssertionError(f"LPIPS all-kernel launched {n} convs, not "
                             f"13 for each image")
    errs = ((got.cpu() - want).abs().max().item(),
            (got - plain).abs().max().item())
    if not max(errs) <= LPIPS_ATOL:
        raise AssertionError(f"LPIPS card vs CPU, kernel vs plain {errs} > "
                             f"{LPIPS_ATOL}")
    log(f"LPIPS (seeded weights) on {card}: batch {GAN_BATCH}, 256^2, "
        f"distances {[round(v, 5) for v in want.flatten().tolist()]}; "
        f"all-kernel card vs CPU max_abs_err {errs[0]:.3e}, vs the card's "
        f"plain path {errs[1]:.3e} (tol {LPIPS_ATOL}); {n} conv launches")


def build_msvqgan():
    t0 = time.perf_counter()
    model = instantiate_from_config(load_yaml(str(MSVQ))["model"], seed=0)
    torch.cuda.synchronize()
    log(f"MS-VQGAN model: {MSVQ.relative_to(REPO)}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, built "
        f"in {time.perf_counter() - t0:.2f} s")
    return model


def build_gan_loss():
    """The MS-VQGAN config's loss on the card, its discriminator seeded;
    without local LPIPS weights it warns and trains with
    perceptual_weight 0, as the JAX package does."""
    loss = instantiate_from_config(_MSVQ_CFG["model"]["params"]["lossconfig"],
                                   seed=0)
    log(f"MS-VQGAN loss: {type(loss).__name__}, LPIPS "
        f"{'on' if loss.use_lpips else 'off (no local weights)'}, "
        f"{sum(p.numel() for p in loss.parameters())} parameters")
    return loss


def build_main_model(config):
    t0 = time.perf_counter()
    model = instantiate_from_config(load_yaml(str(config))["model"], seed=0)
    n_zero = randomize_zero_init_(model, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path model: {config.relative_to(REPO)}, {n_params} "
        f"parameters, {n_zero} zero-init convs randomised, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def union_seconds(events):
    """Seconds covered by at least one of ``events`` (overlapping kernels
    counted once)."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e6


def profile_once(run, name, top=5):
    """Device busy time and idle share of one ``run()`` under
    torch.profiler, and its heaviest kernels. Busy is the union of the
    kernels' intervals, so kernels that overlap count once; the profiler
    slows the host, so the idle share is an upper bound. The wall time
    ends in a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(run)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile ({name}): torch.profiler recorded no device time; "
            f"device busy share not measured")
        return
    busy = union_seconds(e for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
    summed = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profile ({name}): wall {wall:.4f} s under the profiler, device "
        f"busy {busy:.4f} s (kernel times summed: {summed:.4f} s), idle "
        f"share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x {e.key[:90]}")


def profile_phase(model, path, name):
    """Where the main path's time goes: device busy share and the heaviest
    kernels of a short run under torch.profiler (which slows the host, so
    the idle share it gives is an upper bound), then one UNet call and the
    part of it spent casting the fp32 weights to bf16."""
    calls = unet_calls(model, path["sampler"], PROFILE_STEPS)
    profile_once(lambda: drive_main_path(model, path, seed=2,
                                         steps=PROFILE_STEPS),
                 f"{name}; batch {BATCH}, {path['sampler']} {PROFILE_STEPS}"
                 f", {calls} UNet calls, decode", top=10)

    unet = model.model.diffusion_model
    side, first = model.image_size, model.embed_dim_list[0]
    x = seeded((BATCH, side, side, model.channels), 30, torch.bfloat16)
    t = torch.full((BATCH,), 500, device="cuda")
    with torch.no_grad():
        ctx = model.get_learned_conditioning(
            np.zeros((BATCH, path["ctx_len"]), np.int64)).to(torch.bfloat16)
        tables = model.spade_tables(x[..., :first], 1)
        call_ms = cuda_ms(lambda: model.apply_model(x, t, ctx, 1, tables),
                          reps=5)
        cast_ms = cuda_ms(lambda: [p.to(torch.bfloat16)
                                   for p in unet.parameters()], reps=5)
    log(f"UNet call ({name}; batch {BATCH}, bf16, stage 1): "
        f"{call_ms:.3f} ms; "
        f"casting its {sum(1 for _ in unet.parameters())} weight tensors "
        f"to bf16 alone: {cast_ms:.3f} ms")


def main():
    start = time.perf_counter()
    seconds = {}

    def mark(phase):
        seconds[phase] = round(time.perf_counter() - start - sum(
            seconds.values()), 1)

    card = setup()
    mark("setup and kernel build")
    rows = [flash_phase(), vq_phase()]
    rows += [group_norm_phase(), smalls_phase(), conv3x3_norm_silu_phase(),
             conv3x3_phase()]
    mark("kernel phases")
    toy_phase("default")
    with all_kernels():
        toy = toy_phase("all-kernel")
    if not all(toy[name] > 0 for name in KERNELS):
        raise AssertionError(f"toy all-kernel run launched {toy}")
    sampler_phase()
    toy_encode_phase("default")
    with all_kernels():
        toy_encode_phase("all-kernel")
    toy_training_phase("default")
    with all_kernels():
        toy_training_phase("all-kernel")
    mark("toy phases")

    model = build_main_model(T2I)
    unet_conv_sum_phase(model)
    default = main_path_phase(card, model, "t2i", "default")
    with all_kernels():
        opt_in = main_path_phase(card, model, "t2i", "all-kernel")
    mark("t2i paths")
    other = encode_sites_phase(model, "t2i encode")
    mark("t2i encode sites")
    first_stage_phase(card, model, "t2i", "default")
    with all_kernels():
        first_stage_phase(card, model, "t2i", "all-kernel")
    mark("t2i first stage")
    other += diffusion_sites_phase(model)
    mark("diffusion train step sites")
    diffusion_training_phase(card, model, "default", torch.bfloat16,
                             TRAIN_STEPS)
    with all_kernels():
        diffusion_training_phase(card, model, "all-kernel", torch.bfloat16,
                                 TRAIN_STEPS)
    diffusion_training_phase(card, model, "default", None, (1, 0))
    mark("t2i diffusion training")
    del model
    torch.cuda.empty_cache()
    model = build_msvqgan()
    forward_with_aux_phase(card, model, "default")
    with all_kernels():
        forward_with_aux_phase(card, model, "all-kernel")
    mark("forward_with_aux")
    loss = build_gan_loss()
    other += gan_sites_phase(model, loss)
    mark("GAN step sites")
    gan_training_phase(card, model, loss, "default", GAN_STEPS)
    with all_kernels():
        gan_training_phase(card, model, loss, "all-kernel", GAN_STEPS)
    mark("MS-VQGAN GAN training")
    lpips_phase(card)
    mark("LPIPS")
    del model, loss
    torch.cuda.empty_cache()
    model = build_main_model(L2I)
    other += layout2i_sites_phase(model)
    other += encode_sites_phase(model, "layout2i encode")
    mark("layout2i sites")
    main_path_phase(card, model, "layout2i", "default")
    with all_kernels():
        main_path_phase(card, model, "layout2i", "all-kernel")
    mark("layout2i paths")
    first_stage_phase(card, model, "layout2i", "default")
    with all_kernels():
        first_stage_phase(card, model, "layout2i", "all-kernel")
    mark("layout2i first stage")
    for row in rows:
        path = default if row["name"] in ("flash_attention", "vq_argmin") \
            else opt_in
        row["launches"] = path[row["name"]]
    log(f"phase seconds on {card}: {seconds}, total "
        f"{time.perf_counter() - start:.1f}")
    log(json.dumps({"other_sites": other}))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
