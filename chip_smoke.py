"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Three main paths, each at full width with batch 4, classifier-free
guidance 1.5, a bf16 UNet over two pyramid stages and an fp32 MS-VQGAN
decode (per-scale VQ re-quantization, post_quant_conv, the 256^2 conv
decoder):

- t2i, ``configs/frido/t2i/frido_f16f8_coco.yaml``: 77 token ids -> BERT
  context -> PLMS over a 32^2 x 8 latent (CFG sequential);
- layout2i f8f4, ``configs/frido/layout2i/frido_f8f4_coco_seg.yaml``: 96
  bbox token ids -> BERT context -> DPM-Solver++(2M), 5 steps, over a
  64^2 x 6 latent (D = 3 codebooks of 4096; the decoder attends over 4096
  tokens, the UNet over 1024 at 32^2; CFG sequential);
- clip-t2i, ``configs/frido/t2i/frido_f16f8_coco_clip.yaml``, through the
  sampling CLI (``python -m frido_tpu_torch.cli.sample_diffusion``) run in
  process: a Lightning ``.ckpt`` and a caption -> the CLIP BPE tokenizer
  -> the ViT-L/14 text tower's pooled, normalised embedding (a context of
  one token) -> PLMS (CFG batched, the CLI's) -> PNGs.

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
   training (1 warm-up and 2 timed steps) in both configurations and one
   fp32 step, and the MS-VQGAN's GAN training (1 + 1) in both, each with
   its launches per step held to the architecture's (the backward
   recomputes through the plain versions and launches nothing), img/s,
   step seconds, peak memory above the model and a profiled step (the
   GAN's in the default configuration only); LPIPS
   with seeded weights at the GAN's batch, card against CPU; the t2i
   step with ``fsdp=True`` at world size 1 (a one-rank NCCL group: the
   per-unit gathers and reduce-scatters over a group of one, counted)
   bit for bit the replicated step, with and without ``remat``,
   deterministic algorithms on, after a control that the replicated step
   repeats bit for bit, each mode's step seconds, peak allocation and
   the units' counters printed; every
   distinct kernel site a tensor-parallel rank at n_model 2 and 4 runs
   in that train step and in the fp32 first stage (each 3x3 conv and
   fused prologue at cout / n_model; ``parallel/tp.py``), checked and
   gradient-checked as in 5; image logging: ``log_images`` of the t2i
   model at batch 8 through ``ImageLogger`` (the config's flags: the
   reconstruction bit for bit the card's encode and decode, the captions'
   text render bit for bit the host's, each PNG read back equal to its
   grid; then with ``plot_sample`` and ``plot_quantize_denoised`` at
   DDIM 20 bit for bit direct sample + decode), and every gallery of the
   toy model on the card;
7. the layout2i sites: every distinct kernel call of one all-kernel pass
   of the layout2i model at batch 4 (conditioning, a UNet call per stage,
   decode) and of its encode, and flash and the VQ argmin at the decode
   chunk of 32, each checked as in 5 unless checked before (in 2 or an
   earlier pass); then the layout2i path in each configuration, as in 4,
   and its first stage, as in 5; its ``log_images`` with the box render
   of ``objects_bbox`` bit for bit ``plot_bbox_conditioning``, the PNGs
   read back;
8. the CLIP towers with seeded weights at full width, card against CPU in
   fp32: the text tower on the CLIP tokenizer's [4, 77] ids of four
   captions (pooled embedding and per-token states) and the ViT-L/14
   image tower with ``clip_preprocess`` on four 256^2 images;
9. the clip-t2i sites: every distinct kernel call of one all-kernel pass
   of the clip-t2i model at batch 4, checked as in 7; among them the
   UNet's cross-attention over the one CLIP token (nk = 1);
10. the sampling CLI: a Lightning ``.ckpt`` of the seeded clip-t2i model
   (a distinct EMA, a scalar scale factor) and vocab files written from
   the fallback BPE vocabulary, under the CLI's strict-vocab default;
   ``-r that.ckpt --prompt ... -plms -G -gs 1.5 -bs 4`` at 5 steps in
   both configurations, then ``--no_ema``; launches
   held to the architecture's, the PNGs read back, the images bit for bit
   those of a direct ``sample`` + ``decode`` under the EMA with the CLI's
   generator, ``--no_ema`` other images; checkpoint write and load
   seconds, sampling seconds and img/s;
11. JPEG decode: each committed fixture (``frido_tpu_torch/data/
   fixtures/``: eight COCO-sized JPEGs, one grey, one progressive, one
   4:4:4) decoded by nvJPEG on the card against its PIL pixels (the
   committed ``pixels.npz``), ms a decode; the image pipeline (256^2,
   ``center`` and ``random-1d`` with the flip) on the card against the
   CPU on the same pixels; the colour layouts (CMYK at 4:4:4 and 4:2:0,
   YCCK, Adobe RGB) decoded as their coded components and converted as
   PIL converts them;
12. the data layer: a mini-COCO-2014 tree of 64 records a split written
   from the fixtures under ``build/``; the t2i config's train loader
   (batch 32, ``random-1d`` and flip, its 64 worker threads, nvJPEG and
   the pipeline on the card) alone over three epochs: loader img/s; the
   same loader resumed at (epoch 0, batch 1) and (epoch 1, batch 1) gives
   the uninterrupted loader's batches (pixels, captions, boxes, crops and
   flips);
13. the training CLI: ``torchrun --standalone --nproc_per_node 1 -m
   frido_tpu_torch.cli.main -b configs/frido/t2i/frido_f16f8_coco.yaml -t
   --bf16_train`` (NCCL at world size 1), the config's data section
   pointed at the tree, 3 steps default, then 1 more all-kernel resumed
   from its ``last`` with ``--fsdp`` (the sharded restore), each run with
   its test pass (DDIM 5, one test batch of 32, PNGs); launches per step
   held to the architecture's (the CLI prints its counts, the image log's
   encode and decode at step 3 beside); set-up seconds, step seconds,
   training img/s, the loader wait share, peak memory above the model,
   train state a rank, the image log's seconds and its PNGs (inputs and
   captions equal to the CLI loader's third batch's grids);
14. dataset sampling: the sampling CLI over the tree's test split from the
   training CLI's run (its EMA), PLMS 10, CFG 1.5, batches of 4, shard
   0 of two (``-ngpu 2 -igpu 0``; the runbook phase, 22, runs both), 4
   samples: its ``*-samples.npz`` holds the first samples of its split,
   launches held to the architecture's, img/s;
15. eval: the FID InceptionV3 with seeded weights on the card against
   the CPU; ``python -m frido_tpu_torch.cli.eval_fid --size 256
   --inception_score`` between the tree's val JPEGs and the first shard's
   PNGs, the weights an .npz named by ``FRIDO_TPU_INCEPTION``: FID, IS,
   the tower's img/s;
16. the MS-VQGAN training CLI (``python -m
   frido_tpu_torch.cli.train_msvqgan``) in process: the MS-VQGAN config at
   its batch of 6, fp32, over the tree, 3 steps default (a checkpoint
   every 2) and 1 all-kernel: launches per step held to the
   architecture's, the first step's losses against a direct
   ``VQGANTrainer`` step, the last train state loaded back equal; then
   ``cli/eval_recon.py`` between the val split's first batch and the
   trained model's reconstructions, card against CPU;
17. the VG (sg2i), VG-cocostyle and OpenImages (layout2i) configs' train
   loaders over synthetic trees written from the fixtures: one batch at
   each config's batch size, each sample card against CPU;
18. with two cards or more, ``tools/dryrun_multichip.py --full`` under
   torchrun on min(4, count) of them (NCCL): the four checks of the JAX
   dry run at full t2i width, checks 1 and 2 with each rank's peak full
   parameter and gradient bytes and peak allocation; with one card a
   line says it was not run;
19. (run before 11) the rest of the denoiser, two models built from
   dicts at the t2i UNet's widths (no config sets these options):
   ddpm-pixel, a pixel-space DDPM at 64^2 x 3 (GroupNorm ResBlocks with
   resblock up/down and scale-shift norm, AttentionBlocks over 1024, 256
   and 64 tokens in heads of 32): every distinct kernel call of an
   all-kernel DDIM step, a bf16 train step at batch 32 and a 1000-class
   UNet call through ``DiffusionWrapper("adm")``, checked forward and
   gradient as in 6 (flash at [48, 1024, 32] bf16 and the fused prologue
   without SPADE among them); in each QKV order one fp32 UNet call card
   against CPU, DDIM-5 at batch 4 and two bf16 train steps at batch 32
   in both configurations, launches held to the architecture's; then
   t2i-ablations, the t2i config with stage experts, mscond and position
   embeddings: the kernel calls of an all-kernel pass and of a bf16 train
   step, checked alike, one fp32 UNet call a stage card against CPU,
   PLMS-5 (CFG 1.5) with the decode at batch 4 and one bf16 train step
   at batch 32 in both configurations; img/s, step seconds and peak
   memory above the model, beside the card;
20. (run after 3) jax-import: the committed export of a toy t2i train
   state that the JAX package trained two steps
   (``frido_tpu_torch/data/fixtures/jax_export_toy``, made by
   ``tools/make_jax_export_fixture.py``; the card's machine has no JAX
   and no orbax) imported as a port run, every tensor of the trainer
   restored on the card bit for bit the export's arrays (the bf16 first
   moment included), the JAX run's third step in fp32 against the JAX
   loss, weights and EMA it records, PLMS-4 from the EMA; in the default
   configuration and all-kernel, launches counted from 0 in each; then the
   VG preprocessing tools (no h5py) on a raw dump; its seconds beside the
   card;
21. the repository's measuring tools (``frido_tpu_torch/tools/``): after
   4, ``flops_audit`` on the full-width t2i model (every unit on
   ``meta``, the plain versions' products): the TFLOP a sampled image at
   PLMS 200, CFG 1.5, and the main path's timed PLMS-20 batch-4 run's
   products over its seconds and over the bf16 peak in each
   configuration; after 6's image logging, ``profile_step`` at batch 4 in
   both configurations (the all-kernel trace of every unit names all six
   kernels; the default's without the decode; stage 1 held to the ``UNet
   call`` line) and ``profile_train
   --units step`` at batch 32, bf16; then ``quality_dpmpp_vs_plms`` at
   full width, batch 2, PLMS 20 / DPM-Solver++ 10 / control PLMS 10 (no
   NaN, DPM-Solver++'s latent PSNR within QUALITY_MARGIN_DB of the
   control's); and after 14, ``acceptance`` in process (CKPT the training
   CLI's run, the mini-val config pointed at the tree, PLMS 4, N 4, no
   gate: ``nogate``), then its gate alone on that FID (``pass``, and
   ``fail`` with exit 1 at the FID plus 2 TOL);
22. the quickstart and the runbooks, after 13's all-kernel run:
   ``frido_tpu_torch/demo.ipynb``'s code cells in order in one namespace
   at full width from random weights (``CKPT`` empty), the steps set to
   NOTEBOOK_STEPS after the first cell: the grid's shape, finite samples,
   flash and VQ launches; then the port's ``eval_t2i_multiGPU.sh 2``
   (``frido_tpu_torch/runbooks/``) as a subprocess (before 15), in a
   scratch working directory under ``build/`` holding the t2i config at full
   width over the tree, its test split narrowed to RUNBOOK_RECORDS
   records by an id list, ``CKPT`` the training CLI's run: both shards on
   the card at the runbook's own PLMS 200, CFG 1.5, each writing one
   sample and its input under the split's file names (no overlap), each
   shard's summary naming ``cuda`` and launches equal to the
   architecture's for one image; the same runbook with ``CKPT`` missing,
   run beside it in an empty directory, exits non-zero before any
   sampling.

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

import argparse
import contextlib
import copy
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
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
from frido_tpu_torch.nn.layers import (  # noqa: E402
    Conv1d, Conv2d, GroupNorm, init_module_, seed_init_)
from frido_tpu_torch.models.frido import DiffusionWrapper  # noqa: E402
from frido_tpu_torch.nn.pyunet import (  # noqa: E402
    AttentionBlock, PyUNetModel, ResBlock, UNetDownsample, UNetUpsample)
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
from frido_tpu_torch.parallel import fsdp as fsdp_units  # noqa: E402
from frido_tpu_torch.schedules import DDIMSchedule  # noqa: E402
from frido_tpu_torch.training import (  # noqa: E402
    optim, trainer, vqgan_trainer)
from frido_tpu_torch.tools.attention_ab import graph_ms  # noqa: E402

T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml"
CLIP_T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco_clip.yaml"
L2I = REPO / "configs" / "frido" / "layout2i" / "frido_f8f4_coco_seg.yaml"
MSVQ = REPO / "configs" / "msvqgan" / "msvqgan_f16f8_coco.yaml"
SG2I_VG = REPO / "configs" / "frido" / "sg2i" / "frido_f16f8_vg.yaml"
L2I_VG = REPO / "configs" / "frido" / "layout2i" / "frido_f8f4_vg.yaml"
L2I_OI = REPO / "configs" / "frido" / "layout2i" / "frido_f8f4_openimage.yaml"

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
# clip-t2i: the t2i UNet and first stage; the CLIP text tower's attention
# is plain torch.matmul in every configuration (no kernel site), and the
# UNet's cross-attention runs over the one pooled CLIP token
CLIP_ARCH = dict(T2I_ARCH, bert_layers=0)
GUIDANCE = 1.5
DECODE_CHUNK = 32
CTX_LEN = 77
# Each main path: config, token window, the bound of its conditioning token
# ids (t2i conditions on id 0 alone, as bench.py does; layout2i on seeded
# bbox token ids, which lie below the dataset's no_tokens of 1024), sampler
# and eta, steps in the default and in the all-kernel configuration (t2i
# at 20, layout2i at 5 in both, to keep the script short: bench.py's
# BENCH_SAMPLER=dpmpp default is 25 steps, cut to make room for the data,
# training-CLI and measuring-tool phases), the architecture's counts.
# clip-t2i is driven through the sampling CLI (``sampling_cli_phase``): 77
# CLIP tokens give a context of one token (``context_len``), PLMS 5 steps
# in both configurations, CFG batched (the CLI's), so one UNet call per
# evaluation.
PATHS = {
    "t2i": dict(config=T2I, ctx_len=CTX_LEN, token_high=1, sampler="plms",
                eta=0.0, steps=20, all_kernel_steps=20, arch=T2I_ARCH,
                encode_arch=T2I_ENCODE_ARCH),
    "layout2i": dict(config=L2I, ctx_len=96, token_high=1024,
                     sampler="dpmpp", eta=0.0, steps=5, all_kernel_steps=5,
                     arch=L2I_ARCH, encode_arch=L2I_ENCODE_ARCH),
    "clip-t2i": dict(config=CLIP_T2I, ctx_len=CTX_LEN, context_len=1,
                     sampler="plms", eta=0.0, steps=5, all_kernel_steps=5,
                     arch=CLIP_ARCH, cfg_batched=True),
}
PROFILE_STEPS = 2   # a short chain under torch.profiler, for the breakdown
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
# the clip-t2i sites new to this script: the UNet's bf16 cross-attention
# over the one pooled CLIP token at each SpatialTransformer resolution, at
# the batch of 2 * BATCH that the CLI's batched CFG gives every UNet call;
# and the same at BATCH, the UNet's batch without guidance
CLIP_NAMED_SITES = tuple(
    ("smalls_attention", (2 * BATCH, nq, 1, d, torch.bfloat16))
    for nq, d in ((256, 384), (64, 576), (16, 960)))
CLIP_UNGUIDED_SITES = tuple(
    (name, (BATCH,) + site[1:]) for name, site in CLIP_NAMED_SITES)
# the CLIP towers and the sampling CLI: four captions for the text tower,
# one prompt for the CLI (its batch is -bs copies), the CLI's default seed
CLIP_CAPTIONS = ("a red double-decker bus on a wet street at night",
                 "two dogs playing with a ball on the beach",
                 "a bowl of fruit on a wooden kitchen table",
                 "a man riding a horse across a field at sunset")
CLI_PROMPT = "a red double-decker bus on a wet street at night"
CLI_SEED = 42
CLI_SCALE_FACTOR = 0.9      # the .ckpt's scalar scale_factor

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
# the full-width CLIP towers, fp32, card (TF32 off) against the CPU: sums
# in another order through 12 (text) and 24 (vision) pre-LN layers; the
# text states and the ViT's projection are of order 1, the pooled
# embedding is unit-normalised
CLIP_TEXT_ATOL = 1e-4
CLIP_VISION_ATOL = 2e-4

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
TRAIN_STEPS, GAN_STEPS = (1, 2), (1, 1)     # (warm-up, timed) steps
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

# The data layer, the training CLI and dataset sampling. nvJPEG against
# PIL's libjpeg on the committed fixtures. Stated first: 4:4:4 and grey
# within 2 levels of PIL's RGB, 4:2:0 reported. The first chip run gave
# 4:4:4 4 levels (nvJPEG's own upsampling and YCbCr conversion) and grey 1
# (its inverse DCT alone). The port now converts nvJPEG's coded planes in
# libjpeg's integer arithmetic, so what is left is the inverse DCT's
# rounding, and the checks that fail the run are: the coded planes (grey's
# one plane, the 4:4:4 fixture's Y, Cb, Cr against libjpeg's, committed)
# within 1 level; grey's RGB within 1; libjpeg's own 4:4:4 planes through
# the port's conversion on the card equal to PIL's RGB; every colour
# fixture's RGB within 3 levels, mean within 0.05 (a plane error of 1
# moves R, G or B by up to 1 + 1.772; a wrong upsampling or conversion is
# tens of levels off at colour edges). The stated 4:4:4 RGB bound was 2
# levels; it is 3, held together with the plane check (1) and the exact
# conversion of libjpeg's planes (0): nvJPEG gives no DCT coefficients,
# and its inverse DCT's +-1 in Y and in Cb or Cr adds up through the
# conversion to as much as 1 + 1.772. The colour layouts besides JFIF
# YCbCr (CMYK, YCCK, Adobe RGB) are held to the same RGB bounds, the CMYK
# 4:4:4 planes to the plane bound. The image pipeline on the card against the CPU on the
# same uint8 pixels: 1e-5 (fp32 matmuls in another order, of values up to
# 255 / 127.5). The tree: 64 records a split. The training CLI: 3 steps
# default (then one resumed), 2 all-kernel; its test pass DDIM 5 steps on
# one test batch. Dataset sampling: PLMS 10, batches of 4, 4 samples of
# shard 0 of two. A resumed train loader: its batches equal the
# uninterrupted loader's exactly (the same decodes and pixel work on the
# same files with the same plans).
#
# Eval: the FID Inception on the card against the CPU, both fp32 with TF32
# off, within 1e-4 of the largest feature (fp32 sums of up to 2048 x 9
# terms in another order); the reconstruction CLI's PSNR and SSIM on the
# card against the CPU within 1e-6 (float64 sums in another order). The
# MS-VQGAN training CLI: 3 steps default with a checkpoint every 2, then 1
# all-kernel; its first step's losses against a direct VQGANTrainer step
# from the same seeded state and batch within 1e-6 relative (the same
# kernels on the same inputs; only the loader around them differs). The
# VG (sg2i), VG-cocostyle and OpenImages loaders: a tree of 24 VG images
# and one of 8 OpenImages images.
JPEG_PLANE_LEVELS = 1
JPEG_GREY_LEVELS = 1
JPEG_444_STATED_LEVELS = 3
JPEG_RGB_LEVELS = 3
JPEG_RGB_MEAN_LEVELS = 0.05
JPEG_REPS = 5
PIPELINE_ATOL = 1e-5
TREE_IMAGES = 64
DATA_EPOCHS = 3
# the default run, then the all-kernel one resumed from it with --fsdp
CLI_STEPS = {"default": 3, "all-kernel": 1}
CLI_RUN = "t2i_cli"
CLI_TEST_STEPS = 5
CLI_TIMEOUT = 420
DATASET_BATCH, DATASET_STEPS, DATASET_SAMPLES = 4, 10, 4
# shard 0 of two in process (the FID phase reads its samples); both shards
# run as processes in the runbook phase
DATASET_SHARDS = (0,)
# the acceptance chain (tools/acceptance.py) over the tree from the training
# CLI's run: its STEPS and N, cut from the runbook's 200 and the whole split
ACCEPT_STEPS, ACCEPT_N = 4, 4
# the port's multishard runbook at its own PLMS 200 (CFG batched) over a
# test split of one record a shard, and the notebook at NOTEBOOK_STEPS
RUNBOOK_SHARDS, RUNBOOK_RECORDS, RUNBOOK_TIMEOUT = 2, 2, 420
RUNBOOK_STEPS = 200
NOTEBOOK_STEPS = 4
EVAL_IMAGES = 4
EVAL_FEATURE_RTOL = 1e-4
RECON_ATOL = 1e-6
MSVQ_CLI_STEPS = {"default": 3, "all-kernel": 1}
MSVQ_CKPT_EVERY = 2
MSVQ_STEP_RTOL = 1e-6
MSVQ_SEED = 23
CLI_TRAIN_SEED = 23         # the training CLI's default --seed
IMG_LOG_EVERY = 3           # the training CLI's image log fires at step 3
LOG_N = 8                   # ImageLogger's max_images
LOG_DDIM_STEPS = 10
LOG_CAPTIONS = ("a red double-decker bus on a wet street at night",
                "AVATAR To WAVE fi ff", "café crème — naïve 日本",
                "two dogs", "a plate of food with a fork and a knife "
                "next to a glass of water on a wooden table", "x",
                "", "a man riding a wave on top of a surfboard")
TP_SIZES = (2, 4)
FSDP_STEPS = 2
# profile one more remat step of the replicated and fsdp modes (the host
# ops too): the probe that placed fsdp remat's time, run as
#   python -c "import chip_smoke as cs; cs.FSDP_STEPS = 5; \
#     cs.FSDP_PROFILE = True; card = cs.setup(); \
#     cs.fsdp_phase(card, cs.build_main_model(cs.T2I))"
# off here, for the script's time limit (a trace's parse is slow)
FSDP_PROFILE = False
# The repository's measuring tools on the card (frido_tpu_torch/tools/).
# The DPM-Solver++-vs-PLMS check at full width, batch 2, its step counts
# (PLMS, DPM-Solver++, the PLMS control) cut from the script's 200, 25,
# 100 at batch 16; it fails on NaN or on a DPM-Solver++ latent PSNR below
# the control's minus QUALITY_MARGIN_DB (a check that the samplers run the
# same ODE, not a quality claim). The profilers at the main path's batch,
# PROFILE_ITERS calls a unit: profile_step's stage-1 device ms is at most
# HOST_SPREAD times the UNet call line's event ms (its device time cannot
# exceed the call's wall time; the host's speed moves between the two
# measurements), its host ms under the profiler between 1 / HOST_SPREAD and
# PROFILER_SLOWDOWN x HOST_SPREAD times it.
QUALITY_BATCH, QUALITY_STEPS, QUALITY_MARGIN_DB = 2, (20, 10, 10), 10.0
PROFILE_ITERS, HOST_SPREAD, PROFILER_SLOWDOWN = 2, 2.0, 2.0
DRYRUN_TIMEOUT = 900
VG_IMAGES, OI_IMAGES = 24, 8

# The rest of the denoiser, at full width from dicts: no config
# file sets these options. ddpm-pixel: a pixel-space DDPM (no first stage)
# at 64^2 x 3 with the t2i unet_config's widths (192 x [1, 2, 3, 5], 2
# ResBlocks a level, attention at 32^2, 16^2 and 8^2 with heads of 32:
# 1024 tokens x 12 heads, 256 x 18, 64 x 30), GroupNorm ResBlocks with
# resblock up/down and scale-shift norm, the plain AttentionBlock in both
# QKV orders; DDIM-5 (eta 0) at batch 4 in both configurations, two bf16
# training steps at the t2i batch of 32, one UNet call with 1000 class ids
# (use_embed) through DiffusionWrapper("adm") at batch 4. t2i-ablations:
# the t2i config with stage experts, mscond and position embeddings;
# PLMS-5, CFG 1.5, batch 4 with the decode in both configurations, one
# bf16 training step at batch 32. One fp32 UNet call of each model (each
# order, each stage) card against CPU within FULL_UNET_RTOL of the CPU
# output's largest magnitude: fp32 sums of up to 9 x 1920 terms through
# some 40 convs and the attentions, in another order (TF32 off).
_T2I_PARAMS = _T2I_CFG["model"]["params"]
PIXEL_UNET = dict(
    {k: v for k, v in _T2I_PARAMS["unet_config"]["params"].items()
     if k not in ("split_embed_dim_list", "context_dim",
                  "transformer_depth")},
    image_size=64, in_channels=3, out_channels=3, use_split_head=False,
    use_SPADE_norm=False, use_spatial_transformer=False, num_stage=1,
    resblock_updown=True, use_scale_shift_norm=True)
PIXEL_STEPS = 5
PIXEL_TRAIN_STEPS = 2
PIXEL_CLASSES = 1000
ABLATIONS = dict(use_stage_expert=True, use_mscond=True, use_pos_embed=True)
ABLATION_STEPS = 5
FULL_UNET_RTOL = 1e-3
# sites these paths must reach: flash over the pixel
# UNet's 1024 tokens (12 heads of 32 at batch 4) and the fused prologue
# without SPADE at its first ResBlock
PIXEL_NAMED_SITES = (
    ("flash_attention", (BATCH * 12, 1024, 1024, 32, torch.bfloat16)),
    ("smalls_attention", (BATCH * 18, 256, 256, 32, torch.bfloat16)),
    ("smalls_attention", (BATCH * 30, 64, 64, 32, torch.bfloat16)),
    ("conv3x3_norm_silu", ((BATCH, 192, 64, 64), 192, torch.bfloat16,
                           False, 32, 1e-5)),
)


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
    init, else the UNet's eps-hat and its SpatialTransformers' and
    AttentionBlocks' outputs are trivially 0."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv2d, Conv1d)) and mod.zero_init:
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
    the same shape is printed beside it. In bf16 the prologue's output is
    rounded before the conv (FUSED_BF16_ATOL_RMS); in fp32 (the
    t2i-ablations UNet after its first position-embedded transformer) it
    is not, and the conv's tolerance holds (CONV_ATOL_RMS)."""
    x, w, b, ns, nb, g, bt = fused_operands(shape, cout, dtype, spade, 60)
    args = (x, w, b, ns, nb, groups, eps, g, bt)
    got = conv3x3_norm_silu(*args)
    torch.cuda.synchronize()
    up = (lambda t: None if t is None else t.float())
    want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(), ns, nb,
                                   groups, eps, up(g), up(bt))
    atol = FUSED_BF16_ATOL_RMS if dtype == torch.bfloat16 else CONV_ATOL_RMS
    err, tol = check_close(
        f"conv3x3_norm_silu {dtype} {list(shape)}->{cout}", got, want,
        atol * rms(want), dtype)
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
    bounded = (bound(ops, PEAK_BF16_FLOPS, nbytes) if dtype == torch.bfloat16
               else matmul_bound(ops, dtype, nbytes)[:2])
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


def check_named_sites(found, named, label):
    """Raise unless every (kernel, site) of ``named`` is among ``found``."""
    for name, site in named:
        if site not in found[name]:
            raise AssertionError(f"{label} made no {name} call at {site}: "
                                 f"{sorted(found[name], key=str)}")


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
    check_named_sites(found, L2I_NAMED_SITES, "the layout2i pass")
    found["flash_attention"].add(L2I_CHUNK_FLASH)
    found["vq_argmin"].add(L2I_CHUNK_VQ)
    return check_sites(found, "layout2i sampling")


def clip_sites_phase(found):
    """Every kernel site of the clip-t2i sampling path: ``found``, each
    distinct kernel call of one all-kernel run of the sampling CLI (CLIP
    conditioning, every UNet call at the batched CFG's batch, decode),
    among them the cross-attention over one key, and that cross-attention
    at the unguided batch; each against its plain version unless checked
    before."""
    check_named_sites(found, CLIP_NAMED_SITES, "the clip-t2i CLI")
    for name, site in CLIP_UNGUIDED_SITES:
        found[name].add(site)
    return check_sites(found, "clip-t2i sampling")


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
def environ(values):
    """The environment variables ``values`` for the block, put back
    after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def all_kernels():
    """The JAX package's all-kernel configuration, for the block."""
    return environ(ALL_KERNELS)


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


def unet_calls(model, sampler, steps, cfg_batched=False):
    """UNet calls of one chain under CFG, sequential (two an evaluation) or
    batched (one of twice the batch): per stage PLMS makes S + 1
    evaluations (step 0 takes two), DDIM and DPM-Solver++ S, the vanilla
    chain one per timestep of the schedule."""
    if sampler == "vanilla":
        per_stage = model.schedule.num_timesteps
    else:
        per_stage = DDIMSchedule.create(model.schedule, steps).num_steps
        per_stage += sampler == "plms"
    return model.num_stage * per_stage * (1 if cfg_batched else 2)


def unet_tokens(model):
    """Tokens of each SpatialTransformer's (or AttentionBlock's)
    self-attention in one UNet call, walked from the latent size through
    the UNet's down- and upsamples (resampling ResBlocks included)."""
    side = model.image_size
    tokens = []
    for _, _, layers in model.model.diffusion_model._blocks():
        for _, mod in layers:
            if isinstance(mod, UNetDownsample) or (
                    isinstance(mod, ResBlock) and mod.down):
                side //= 2
            elif isinstance(mod, UNetUpsample) or (
                    isinstance(mod, ResBlock) and mod.up):
                side *= 2
            elif isinstance(mod, (SpatialTransformer, AttentionBlock)):
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
        unet_attn_tokens=unet_tokens(model),
        ctx_len=path.get("context_len", path["ctx_len"]),
        unet_calls=unet_calls(model, path["sampler"], steps,
                              path.get("cfg_batched", False)),
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


# the second (timed) run of each main path: (seconds, steps), and the
# profiled stage-1 UNet call's event ms, by "task, label"
MAIN_SECONDS, UNET_CALL_MS = {}, {}


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
    MAIN_SECONDS[name] = (sum(warm.values()), steps)
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
    outputs checked; the time of a second run, peak memory, a profile
    (all-kernel)."""
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
    if all_kernel:   # the default's ~100k launches: the GAN step profiles it
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
    return check_sites(found, "t2i diffusion train step"), found


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
    img/s, step seconds, peak memory above the model, a profiled step in
    the default configuration."""
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
    if not all_kernel:   # ~120k launches a step: the trace's parse is slow
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


@contextlib.contextmanager
def clip_vocab():
    """``FRIDO_TPU_CLIP_VOCAB`` pointed, for the block, at vocab.json and
    merges.txt written from the port's fallback BPE vocabulary (no real
    CLIP vocabulary is in the repository); yields the directory."""
    from frido_tpu_torch.text.clip_bpe import fallback_vocab, write_vocab_files

    saved = os.environ.get("FRIDO_TPU_CLIP_VOCAB")
    with tempfile.TemporaryDirectory() as d:
        write_vocab_files(d, *fallback_vocab())
        os.environ["FRIDO_TPU_CLIP_VOCAB"] = d
        try:
            yield d
        finally:
            if saved is None:
                os.environ.pop("FRIDO_TPU_CLIP_VOCAB", None)
            else:
                os.environ["FRIDO_TPU_CLIP_VOCAB"] = saved


def clip_towers_phase(card):
    """The full-width CLIP towers with seeded weights, card against CPU in
    fp32: the ViT-L/14 text tower (FrozenCLIPTextEmbedder, and its
    per-token states) on the CLIP tokenizer's [4, 77] ids of four
    captions, and the ViT-L/14 image tower (FrozenClipImageEmbedder) with
    ``clip_preprocess`` (bicubic 256 -> 224) on four seeded 256^2 images;
    device ms of each on the card."""
    from frido_tpu_torch.nn.encoders import (FrozenCLIPTextEmbedder,
                                             FrozenClipImageEmbedder)

    def pair(cls, seed):
        cpu = cls(device="cpu")
        init_module_(cpu, torch.Generator().manual_seed(seed))
        gpu = cls(device="cuda")
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        return cpu, gpu

    text_cpu, text_gpu = pair(FrozenCLIPTextEmbedder, 23)
    tokens = torch.from_numpy(text_cpu.tokenize(list(CLIP_CAPTIONS))).long()
    if tuple(tokens.shape) != (BATCH, CTX_LEN):
        raise AssertionError(f"CLIP tokens {tuple(tokens.shape)}")
    img_cpu, img_gpu = pair(FrozenClipImageEmbedder, 24)
    images = seeded_images(25, device="cpu")
    with torch.no_grad():
        want = [text_cpu(tokens), text_cpu.transformer.text_model(tokens),
                img_cpu(images)]
        tg, ig = tokens.cuda(), images.cuda()
        got = [text_gpu(tg), text_gpu.transformer.text_model(tg),
               img_gpu(ig)]
        text_ms = cuda_ms(lambda: text_gpu(tg), reps=5)
        image_ms = cuda_ms(lambda: img_gpu(ig), reps=5)
    shapes = [(BATCH, 1, 768), (BATCH, CTX_LEN, 768), (BATCH, 768)]
    errs = []
    for name, g, w, shape, tol in zip(
            ("pooled text", "text states", "image"), got, want, shapes,
            (CLIP_TEXT_ATOL, CLIP_TEXT_ATOL, CLIP_VISION_ATOL)):
        err = (g.cpu() - w).abs().max().item()
        if tuple(g.shape) != shape or not (bool(torch.isfinite(g).all())
                                           and err <= tol):
            raise AssertionError(f"CLIP {name} {tuple(g.shape)} card vs "
                                 f"CPU {err} > {tol}")
        errs.append(err)
    norms = got[0][:, 0].norm(dim=-1)
    log(f"CLIP towers (seeded weights) on {card}: text [4, 77] ids of the "
        f"CLIP tokenizer (EOT at {tokens.argmax(1).tolist()}): pooled "
        f"max_abs_err {errs[0]:.3e}, states {errs[1]:.3e} (tol "
        f"{CLIP_TEXT_ATOL}), norms {[round(v, 6) for v in norms.tolist()]},"
        f" {text_ms:.3f} ms; image tower on 4 x 256^2 (bicubic to 224): "
        f"max_abs_err {errs[2]:.3e} (tol {CLIP_VISION_ATOL}), "
        f"{image_ms:.3f} ms")
    del text_gpu, img_gpu
    torch.cuda.empty_cache()


def write_lightning_ckpt(path, model, seed):
    """A Lightning-format checkpoint of ``model`` (the seeded full-width
    clip-t2i model): ``state_dict`` with its tensors, the EMA's flat
    ``model_ema.*`` names for every denoiser parameter at values 1% (of
    the tensor's RMS) of seeded noise away from the weights, a scalar
    ``scale_factor``, and pickled ``hyper_parameters`` (a Namespace, which
    ``torch.load``'s weights_only refuses, as Lightning's AttributeDict).
    Returns {name: EMA tensor on the card}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ema = {}
    with torch.no_grad():
        for name, p in model.model.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device="cuda")
            ema[name] = p + 0.01 * rms(p) * noise
            flat = ("model." + name).replace(".", "")[len("model"):]
            sd["model_ema." + flat] = ema[name].cpu()
    sd["model_ema.num_updates"] = torch.tensor(1000, dtype=torch.int32)
    sd["scale_factor"] = torch.tensor(CLI_SCALE_FACTOR)
    params = load_yaml(str(CLIP_T2I))["model"]["params"]
    torch.save({"state_dict": sd, "epoch": 10, "global_step": 100000,
                "hyper_parameters": argparse.Namespace(**params)}, path)
    return ema


def direct_images(model, steps):
    """The CLI's pipeline called directly: the prompt's and the empty
    caption's CLIP contexts, PLMS with CFG, the bf16 UNet and the decode,
    with a generator seeded as the CLI seeds it."""
    gen = torch.Generator(device="cuda").manual_seed(CLI_SEED)
    with torch.no_grad():
        ctx = model.get_learned_conditioning(
            model.tokenize([CLI_PROMPT] * BATCH))
        uctx = model.get_learned_conditioning(model.tokenize([""] * BATCH))
        z = model.sample(BATCH, context=ctx, uncond_context=uctx,
                         steps=steps, eta=0.0, guidance_scale=GUIDANCE,
                         sampler="plms", compute_dtype=torch.bfloat16,
                         generator=gen)
        return model.decode_first_stage(z).float().cpu().numpy()


def sampling_cli_phase(card, model):
    """The clip-t2i path through the sampling CLI, in process: a Lightning
    ``.ckpt`` written from ``model``'s seeded weights with a distinct EMA;
    ``-r that.ckpt --prompt ... -plms -G -gs 1.5 -bs 4`` at 10 steps in
    both configurations, under the CLI's
    strict-vocab default with the fallback BPE files as the vocabulary;
    then ``--no_ema`` all-kernel. Each run: launches held to the
    architecture's (counts set to 0 just before ``main``, read just after),
    the PNGs read back equal ``to_uint8`` of the returned images, the
    images finite and not constant; with the EMA, the model's denoiser is
    the checkpoint's EMA, the scalar scale factor became [0.9], and a
    direct ``sample`` + ``decode`` with the CLI's generator gives the same
    images, bit for bit; ``--no_ema`` gives other images. Returns the
    kernel sites of the ``--no_ema`` run (``record_sites``), whose shapes
    are the all-kernel EMA run's."""
    from frido_tpu_torch.cli import sample_diffusion as cli
    from frido_tpu_torch.utils.visualize import read_png, to_uint8

    path = PATHS["clip-t2i"]
    saved_strict = os.environ.pop("FRIDO_TPU_STRICT_VOCAB", None)
    with clip_vocab(), tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.ckpt")
        ema, write_s = timed(lambda: write_lightning_ckpt(ckpt, model, 26))
        gib = os.path.getsize(ckpt) / 2 ** 30
        log(f"sampling CLI: wrote {ckpt} ({gib:.2f} GiB, "
            f"{len(ema)} EMA tensors) in {write_s:.2f} s")
        runs, found = {}, None
        for label, extra in (("default", []), ("all-kernel", []),
                             ("all-kernel", ["--no_ema"])):
            all_kernel = label == "all-kernel"
            steps = path["all_kernel_steps" if all_kernel else "steps"]
            name = f"clip-t2i CLI, {label}{' '.join([''] + extra)}"
            argv = ["-cfg", str(CLIP_T2I), "-r", ckpt, "--prompt",
                    CLI_PROMPT, "-plms", "-c", str(steps), "-G", "-gs",
                    str(GUIDANCE), "-bs", str(BATCH), "--seed",
                    str(CLI_SEED), "-o", os.path.join(tmp, "out"), "-name",
                    f"{label}{''.join(extra)}", *extra]
            out = []

            def run():
                out.append(cli.main(argv))

            with (all_kernels() if all_kernel else contextlib.nullcontext()):
                zero_launches()
                if "--no_ema" in extra:
                    found = record_sites(run)
                else:
                    run()
                torch.cuda.synchronize()
                res = out[0]
                launches = read_launches()
                m = res["model"]
                arch = architecture(m, path, steps)
                # routed by the switches in force, as the run was
                held = expected_launches(arch, all_kernel)
            if {k: arch[k] for k in path["arch"]} != path["arch"]:
                raise AssertionError(f"the clip-t2i model has {arch}")
            if launches != held:
                raise AssertionError(f"{name} launches {launches}, expected "
                                     f"{held}")
            if os.environ.get("FRIDO_TPU_STRICT_VOCAB") != "1":
                raise AssertionError("the CLI did not turn strict vocab on")
            imgs = res["images"]
            spread = check_images(torch.from_numpy(imgs), name)
            pngs = sorted(os.listdir(os.path.join(res["out_dir"], "sample")))
            if len(pngs) != BATCH:
                raise AssertionError(f"{name}: PNGs {pngs}")
            for i, png in enumerate(pngs):
                back = read_png(os.path.join(res["out_dir"], "sample", png))
                if not np.array_equal(back, to_uint8(imgs[i])):
                    raise AssertionError(f"{name}: {png} is not the image")
            direct_err = None
            if "--no_ema" not in extra:
                params = dict(m.model.named_parameters())
                if not all(torch.equal(params[k], v) for k, v in ema.items()):
                    raise AssertionError(f"{name}: the EMA is not swapped in")
                if not np.array_equal(m.scale_factors,
                                      np.float32([CLI_SCALE_FACTOR])):
                    raise AssertionError(f"{name}: scale factors "
                                         f"{m.scale_factors}")
                with (all_kernels() if all_kernel
                      else contextlib.nullcontext()):
                    direct = direct_images(m, steps)
                direct_err = float(np.abs(direct - imgs).max())
                if direct_err != 0.0:
                    raise AssertionError(f"{name}: the CLI's images differ "
                                         f"from direct sampling by "
                                         f"{direct_err}")
            runs[(label, tuple(extra))] = imgs
            log(f"{name} on {card}: batch {BATCH}, PLMS {steps} steps x 2 "
                f"stages, CFG {GUIDANCE} batched, bf16 UNet: checkpoint "
                f"load {res['load_seconds']:.2f} s, sampling (tokens to "
                f"images) {res['sample_seconds']:.3f} s, "
                f"{BATCH / res['sample_seconds']:.4f} img/s; launches "
                f"{launches} (the architecture's); image std {spread:.4f}; "
                f"PNGs read back equal; direct sampling max_abs_diff "
                f"{direct_err}"
                f"{'; kernel sites recorded' if found is not None else ''}")
            del m, res, out
            torch.cuda.empty_cache()
    if saved_strict is None:
        os.environ.pop("FRIDO_TPU_STRICT_VOCAB", None)
    else:
        os.environ["FRIDO_TPU_STRICT_VOCAB"] = saved_strict
    gap = float(np.abs(runs[("all-kernel", ("--no_ema",))]
                       - runs[("all-kernel", ())]).max())
    if not gap > 1e-2:
        raise AssertionError(f"--no_ema gave the EMA's images (max diff "
                             f"{gap})")
    log(f"sampling CLI: --no_ema images differ from the EMA's by up to "
        f"{gap:.4f}")
    return found


# ---------------------------------------------------------------------------
# The data layer, the training CLI and dataset sampling.
def tree_dotlist(root):
    """The t2i config's data section pointed at the mini-COCO-2014 tree at
    ``root`` (its ``data_path`` and ``caption_ann_path`` only)."""
    dots = []
    for split, ann in (("train", "train2014"), ("validation", "val2014"),
                       ("test", "val2014")):
        q = f"data.params.{split}.params."
        dots += [q + f"data_path={root}",
                 q + f"caption_ann_path={root}/annotations/"
                     f"captions_{ann}.json"]
    return dots


def jpeg_phase(card):
    """nvJPEG on each committed fixture against libjpeg (PIL), with the
    bounds stated at JPEG_PLANE_LEVELS: the grey fixture's one plane, and
    the 4:4:4 fixture's coded Y, Cb, Cr planes, within JPEG_PLANE_LEVELS
    of libjpeg's; grey's RGB within JPEG_GREY_LEVELS and the others'
    within JPEG_RGB_LEVELS (mean within JPEG_RGB_MEAN_LEVELS); libjpeg's
    4:4:4 planes through the port's conversion equal to PIL's RGB; the
    4:4:4 RGB against JPEG_444_STATED_LEVELS with the plane and
    conversion checks beside it, printed as met; ms a decode; the image
    pipeline on the card against the CPU on the same pixels; then the
    colour layouts (``colour_fixture_phase``)."""
    from frido_tpu_torch.data.transforms import ImagePipeline
    from frido_tpu_torch.ops.cuda.jpeg import (decode_jpeg, decode_planes,
                                               jpeg_info, ycc_to_rgb)
    from frido_tpu_torch.tools.make_mini_coco import (FIXTURES, SPECS,
                                                      fixture_pixels,
                                                      fixture_planes)

    pixels, coded = fixture_pixels(), fixture_planes()
    if not coded:
        raise AssertionError("jpeg: no committed 4:4:4 planes")
    decode_jpeg.launches = 0
    decode_ms, pipe_ms, worst_pipe, unmet = [], [], 0.0, []
    for name, w, h, mode, sub, prog in SPECS:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        comps, css, sizes = jpeg_info(data, name)
        iw, ih = sizes[0]
        img, _ = timed(lambda: decode_jpeg(data, "cuda", name))
        if tuple(img.shape) != (h, w, 3) or img.dtype != torch.uint8 \
                or (iw, ih) != (w, h):
            raise AssertionError(f"jpeg {name}: {tuple(img.shape)} "
                                 f"{img.dtype}, header {iw}x{ih}")
        want = torch.from_numpy(pixels[name]).cuda()
        d = (img.int() - want.int()).abs()
        mx, mean = d.max().item(), d.float().mean().item()
        plane_err, notes = None, ""
        if css == "grey":
            plane_err = mx
        if name in coded:
            got = torch.stack(decode_planes(data, "cuda", name), -1)
            ref = torch.from_numpy(coded[name]).cuda().int()
            plane_err = (got.int() - ref).abs().max().item()
            conv_err = (ycc_to_rgb(*ref.unbind(-1)).int() - want.int()
                        ).abs().max().item()
            if conv_err:
                raise AssertionError(f"jpeg {name}: libjpeg's planes through "
                                     f"the port's conversion {conv_err} "
                                     "levels from PIL's RGB")
            notes += "; libjpeg's planes through the port's conversion: 0"
        if plane_err is not None and plane_err > JPEG_PLANE_LEVELS:
            raise AssertionError(f"jpeg {name} ({css}): coded planes "
                                 f"{plane_err} levels from libjpeg's > "
                                 f"{JPEG_PLANE_LEVELS}")
        rgb_levels = JPEG_GREY_LEVELS if css == "grey" else JPEG_RGB_LEVELS
        if mx > rgb_levels or mean > JPEG_RGB_MEAN_LEVELS:
            raise AssertionError(f"jpeg {name} ({css}): |nvJPEG - PIL| max "
                                 f"{mx}, mean {mean:.4f} levels > "
                                 f"{rgb_levels}, {JPEG_RGB_MEAN_LEVELS}")
        if css == "4:4:4":
            met = (mx <= JPEG_444_STATED_LEVELS and plane_err is not None
                   and plane_err <= JPEG_PLANE_LEVELS and name in coded)
            notes += (f"; the stated 4:4:4 bound of {JPEG_444_STATED_LEVELS}"
                      f" levels with planes <= {JPEG_PLANE_LEVELS} and the "
                      f"conversion exact: {'met' if met else 'NOT MET'}")
            if not met:
                unmet.append(f"{name} RGB max {mx} levels, planes "
                             f"{plane_err}")
        _, secs = timed(lambda: [decode_jpeg(data, "cuda", name)
                                 for _ in range(JPEG_REPS)])
        decode_ms.append(secs / JPEG_REPS * 1e3)
        errs = []
        for method, flip in (("center", False), ("random-1d", True)):
            cpu = ImagePipeline(256, method, flip, seed=w + h)
            gpu = ImagePipeline(256, method, flip, seed=w + h)
            _, _, want_px = cpu(torch.from_numpy(pixels[name].copy()))
            spec, _, _ = gpu.spec(w, h)
            got_px, secs = timed(lambda: gpu.apply(want, spec))
            pipe_ms.append(secs * 1e3)
            errs.append((got_px.cpu() - want_px).abs().max().item())
        worst_pipe = max(worst_pipe, *errs)
        if max(errs) > PIPELINE_ATOL:
            raise AssertionError(f"pipeline {name}: card vs CPU {errs} > "
                                 f"{PIPELINE_ATOL}")
        log(f"jpeg {name} ({w}x{h}, {comps} components, {css}"
            f"{', progressive' if prog else ''}) on {card}: |nvJPEG - PIL| "
            f"max {mx} levels, mean {mean:.4f}"
            f"{'' if plane_err is None else f'; coded planes max {plane_err}'}"
            f"{notes}"
            f"; decode {decode_ms[-1]:.3f} ms (host clock, {JPEG_REPS} "
            f"decodes, synchronised); pipeline 256^2 center / random-1d+flip "
            f"card vs CPU max {errs[0]:.2e} / {errs[1]:.2e}")
    log(f"jpeg on {card}: {len(SPECS)} fixtures, nvJPEG decode "
        f"{np.mean(decode_ms):.3f} ms an image (mean; "
        f"{min(decode_ms):.3f}-{max(decode_ms):.3f}), image pipeline "
        f"{np.mean(pipe_ms):.3f} ms an image, card vs CPU max "
        f"{worst_pipe:.2e} (tol {PIPELINE_ATOL}); {decode_jpeg.launches} "
        f"decodes")
    if unmet:
        raise AssertionError(f"jpeg: the stated 4:4:4 bound not met: "
                             f"{'; '.join(unmet)}")
    colour_fixture_phase(card, coded)


def data_phase(card, dots):
    """The t2i config's train loader (batch 32, random-1d crop and flip,
    its default 64 worker threads) over the mini-COCO-2014 tree on the
    card, alone: batches of [32, 256, 256, 3] in [-1, 1] with 32
    captions, one nvJPEG decode an image, loader img/s."""
    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.ops.cuda.jpeg import decode_jpeg

    cfg = apply_dotlist(load_yaml(str(T2I)), dots)
    dm, setup_s = timed(lambda: instantiate_from_config(
        cfg["data"], device=torch.device("cuda", 0)).setup())
    n = len(dm.datasets["train"])
    if n != TREE_IMAGES:
        raise AssertionError(f"data: the train split has {n} records")
    loader = dm.train_dataloader()
    decode_jpeg.launches = 0
    secs = []
    for _ in range(DATA_EPOCHS):
        t0 = time.perf_counter()
        for batch in loader:
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            img = batch["image"]
            if (tuple(img.shape) != (TRAIN_BATCH, 256, 256, 3)
                    or img.device.type != "cuda"
                    or not bool(torch.isfinite(img).all())
                    or img.abs().max().item() > 1.0 + 1e-6
                    or len(batch["caption"]) != TRAIN_BATCH):
                raise AssertionError(f"data: batch {tuple(img.shape)} on "
                                     f"{img.device}")
            t0 = time.perf_counter()
    if decode_jpeg.launches != DATA_EPOCHS * n:
        raise AssertionError(f"data: {decode_jpeg.launches} decodes for "
                             f"{DATA_EPOCHS * n} images")
    steady = secs[1:]
    ips = TRAIN_BATCH * len(steady) / sum(steady)
    log(f"data on {card}: t2i train split, {n} records, batch "
        f"{TRAIN_BATCH}, random-1d + flip, {dm.num_workers} workers, "
        f"setup {setup_s:.2f} s; batch seconds "
        f"{rounded(secs, 4)}; loader {ips:.2f} img/s after the "
        f"first batch ({TRAIN_BATCH / secs[0]:.2f} the first); "
        f"{decode_jpeg.launches} nvJPEG decodes")
    return ips


def rounded(xs, digits):
    return [round(x, digits) for x in xs]


def run_train_cli(name, args, env=None):
    """The training CLI under torchrun (one process, NCCL); returns its
    stdout and the summary it prints."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "frido_tpu_torch.cli.main",
           *args]
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = str(REPO)
    t0 = time.perf_counter()
    # a session of its own, so that torchrun's worker goes with it
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            stdin=subprocess.DEVNULL, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name}: exit {proc.returncode}\n"
                             f"{out[-4000:]}\n{err[-4000:]}")
    lines = [ln for ln in out.splitlines()
             if ln.startswith("train summary: ")]
    if len(lines) != 1:
        raise AssertionError(f"{name}: no summary\n{out[-4000:]}")
    return out, json.loads(lines[0][len("train summary: "):]), wall


def train_cli_phase(card, dots, arch, logroot):
    """The full-width t2i training CLI under torchrun --standalone
    --nproc_per_node 1 (NCCL at world size 1), --bf16_train, the config's
    batch of 32 from the tree, CLI_STEPS["default"] steps with the image
    log every IMG_LOG_EVERY steps, then its test pass (DDIM CLI_TEST_STEPS,
    one test batch, PNGs); launches per step held to the architecture's;
    the image log's PNGs checked (``cli_image_log_check``). Returns the
    run directory."""
    name, steps = "t2i training CLI, default", CLI_STEPS["default"]

    def run_dirs():
        return {d for d in logroot.iterdir() if d.name.endswith(CLI_RUN)} \
            if logroot.exists() else set()

    before = run_dirs()
    out, summ, wall = run_train_cli(name, [
        *train_cli_args(dots, logroot), "--max_steps", str(steps)])
    run_dir = run_dirs() - before
    if len(run_dir) != 1:
        raise AssertionError(f"{name}: run dirs {run_dir}")
    run_dir = run_dir.pop()
    check_train_cli(name, run_dir, out, summ, wall, arch, False, 0)
    written = cli_image_log_check(name, run_dir, dots)
    log(f"{name}: the image log wrote {written}; inputs and captions equal "
        f"the CLI loader's third batch's grids")
    return run_dir


def train_cli_resume_phase(card, dots, arch, run_dir, logroot):
    """The same CLI all-kernel, resumed from the default run's ``last``
    with ``--fsdp`` (the sharded restore) for CLI_STEPS["all-kernel"] more
    steps, then its test pass: the restored step, launches per step held
    to the all-kernel architecture's, the test pass's PNGs."""
    name, start = "t2i training CLI, all-kernel", CLI_STEPS["default"]
    with all_kernels():
        out, summ, wall = run_train_cli(f"{name}, resumed with --fsdp", [
            *train_cli_args(dots, logroot), "--auto_resume", "True",
            "--max_steps", str(start + CLI_STEPS["all-kernel"]), "--fsdp"],
            ALL_KERNELS)
        if f"Restored training state at step {start} " not in out \
                or not summ["fsdp"]:
            raise AssertionError(f"{name}: resume with --fsdp\n"
                                 f"{out[-3000:]}")
        check_train_cli(f"{name}, resumed with --fsdp from the default "
                        f"run's step {start}", run_dir, out, summ, wall, arch,
                        True, start)


def train_cli_args(dots, logroot):
    """The flags both training CLI runs share (one run name, so that
    ``--auto_resume`` finds the first run)."""
    return ["-b", str(T2I), "-t", "--bf16_train", "--img_log_every_steps",
            str(IMG_LOG_EVERY), "--log_every_steps", "1",
            "--val_every_steps", "0", "-l", str(logroot), "-n", CLI_RUN,
            "--test_steps", str(CLI_TEST_STEPS), "--test_batches", "1",
            *dots]


def check_train_cli(name, run_dir, out, summ, wall, arch, all_kernel, start):
    """A training CLI run's steps, launches (per step the architecture's,
    and the image log's when it fired), test pass PNGs and its log line;
    ``start``: the step it resumed from."""
    steps = CLI_STEPS["all-kernel" if all_kernel else "default"]
    # the image log (when it fired): one encode and one decode (with its
    # re-quantization) at LOG_N
    logged = len(summ["image_log_seconds"])
    if logged != (start + steps) // IMG_LOG_EVERY - start // IMG_LOG_EVERY:
        raise AssertionError(f"{name}: {logged} image logs")
    per_step = expected_train_launches(arch, all_kernel)
    log_want = expected_first_stage_launches(
        arch, all_kernel, encodes=logged, decodes=logged,
        requantizes=logged)
    want = {k: v * steps + log_want[k] for k, v in per_step.items()}
    got = {k: v for k, v in summ["launches"].items() if k in want}
    if summ["steps"] != steps or got != want:
        raise AssertionError(f"{name}: {summ['steps']} steps, launches "
                             f"{got}, expected {want}")
    sample_dir = run_dir / "test" / "sample"
    pngs = sorted(os.listdir(sample_dir))
    if len(pngs) != TRAIN_BATCH or len(os.listdir(
            run_dir / "test" / "inputs")) != TRAIN_BATCH:
        raise AssertionError(f"{name}: test pass wrote {len(pngs)} PNGs")
    from frido_tpu_torch.utils.visualize import read_png
    if read_png(str(sample_dir / pngs[0])).shape != (256, 256, 3):
        raise AssertionError(f"{name}: test PNG shape")
    test_ips = [float(ln.split(":")[1]) for ln in out.splitlines()
                if ln.startswith("Throughput for this batch")]
    secs = summ["step_seconds"]
    steady = secs[1:] or secs
    log(f"{name} on {summ['card']}: torchrun, NCCL, world size "
        f"{summ['world_size']}, fsdp {summ['fsdp']}, batch "
        f"{summ['global_batch']}, bf16, {steps} steps: process wall "
        f"{wall:.1f} s, set-up {summ['setup_seconds']:.2f} s (start to "
        f"first step: model, data, scale_by_std or the restore); step "
        f"seconds {rounded(secs, 4)}, "
        f"{TRAIN_BATCH * len(steady) / sum(steady):.3f} img/s after the "
        f"first; loader wait share {rounded(summ['data_wait_share'], 4)}; "
        f"peak memory above the model {summ['peak_gib_above_model']:.2f} "
        f"GiB; train state {summ['state_gib_per_rank']:.3f} GiB a rank; "
        f"train-state writes {rounded(summ['checkpoint_seconds'], 2)} "
        f"s (not step time); image log at step {IMG_LOG_EVERY} "
        f"{rounded(summ['image_log_seconds'], 3)} s; launches {got} "
        f"({steps} x the architecture's, the image log's encode and decode "
        f"at {LOG_N} beside), {summ['launches']['decode_jpeg']} nvJPEG "
        f"decodes; test pass DDIM {CLI_TEST_STEPS} at batch {TRAIN_BATCH}: "
        f"{len(pngs)} PNGs, {test_ips} img/s")


def dataset_sampling_phase(card, dots, run_dir, out_root):
    """The sampling CLI in dataset mode from the training CLI's run (its
    EMA): the t2i test split of the tree in batches of DATASET_BATCH,
    PLMS DATASET_STEPS, CFG 1.5, the shards DATASET_SHARDS of two (-ngpu
    2 -igpu i) one after the other, -n DATASET_SAMPLES each; each shard's
    npz holds the first samples of its split (file names against
    ``split_indices_deterministic``); launches held to the
    architecture's."""
    from frido_tpu_torch.cli import sample_diffusion as scli
    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.data.datamodule import split_indices_deterministic

    cfg = apply_dotlist(load_yaml(str(T2I)), dots)
    ds = instantiate_from_config(cfg["data"]["params"]["test"],
                                 device=torch.device("cuda", 0))
    path = dict(PATHS["t2i"], cfg_batched=True)
    seen = set()
    for shard in DATASET_SHARDS:
        argv = ["-cfg", str(T2I), "-r", str(run_dir), "-plms", "-c",
                str(DATASET_STEPS), "-G", "-gs", str(GUIDANCE), "-bs",
                str(DATASET_BATCH), "-n", str(DATASET_SAMPLES), "-ngpu", "2",
                "-igpu", str(shard), "-o", str(out_root), "-name",
                f"shard{shard}", *dots,
                f"data.params.batch_size={DATASET_BATCH}"]
        zero_launches()
        res = scli.main(argv)
        torch.cuda.synchronize()
        launches = read_launches()
        arch = architecture(res["model"], path, DATASET_STEPS)
        batches = DATASET_SAMPLES // DATASET_BATCH
        want = {k: v * batches for k, v in
                expected_launches(arch, False).items()}
        idx = split_indices_deterministic(len(ds), 2, shard)
        names = [ds.image_descriptions[ds.image_ids[i]].file_name
                 for i in idx][:DATASET_SAMPLES]
        imgs = res["images"]
        npz = out_root / f"shard{shard}" / (
            f"{DATASET_SAMPLES}x256x256x3-samples.npz")
        if (res["file_names"] != names or imgs.shape
                != (DATASET_SAMPLES, 256, 256, 3) or not npz.exists()
                or not np.array_equal(np.load(npz)["arr_0"], imgs)
                or seen & set(names) or launches != want
                or res["batches"] != batches):
            raise AssertionError(
                f"dataset sampling shard {shard}: files {res['file_names']} "
                f"(want {names}), images {imgs.shape}, launches {launches} "
                f"(want {want})")
        seen |= set(names)
        log(f"dataset sampling CLI, shard {shard} of 2, on {card}: "
            f"{DATASET_SAMPLES} of its {len(idx)} test images, batch "
            f"{DATASET_BATCH}, PLMS {DATASET_STEPS}, CFG {GUIDANCE} batched, "
            f"bf16 UNet: checkpoint load {res['load_seconds']:.2f} s, "
            f"sampling {res['sample_seconds']:.3f} s, "
            f"{DATASET_SAMPLES / res['sample_seconds']:.4f} img/s; npz "
            f"{npz.name} holds its split's first {DATASET_SAMPLES}; "
            f"launches {launches} (the architecture's)")
        del res
        torch.cuda.empty_cache()


def data_cli_phases(card, arch, runbook_arch):
    """The data layer (and a resumed loader's replay), the training CLI
    (default; then dataset sampling and the acceptance chain from its run;
    then all-kernel, resumed from it with --fsdp), the notebook, the
    multishard runbook from the run, the FID Inception, the FID CLI on the
    samples, the MS-VQGAN training CLI, the reconstruction CLI on its
    model and the VG and OpenImages loaders over trees of their own; the
    rest over a mini-COCO-2014 tree of TREE_IMAGES records a split written
    from the fixtures, under build/ (the train states take some GiB)."""
    import shutil

    from frido_tpu_torch.tools.make_mini_coco import write_tree

    work = REPO / "build" / "chip_smoke_data"
    shutil.rmtree(work, ignore_errors=True)
    seconds = {}
    t0 = time.perf_counter()
    try:
        root = work / "coco" / "2014"
        write_tree(str(root), n=TREE_IMAGES, seed=0)
        dots = tree_dotlist(root)
        def mark(phase):
            seconds[phase] = time.perf_counter() - t0 - sum(seconds.values())

        jpeg_phase(card)
        mark("jpeg")
        data_phase(card, dots)
        mark("data")
        resume_phase(card, dots)
        mark("resume")
        torch.cuda.empty_cache()
        logroot = work / "logs"
        run_dir = train_cli_phase(card, dots, arch, logroot)
        mark("train CLI default")
        dataset_sampling_phase(card, dots, run_dir, work / "samples")
        mark("dataset sampling")
        acceptance_phase(card, root, run_dir, work)
        mark("acceptance chain")
        train_cli_resume_phase(card, dots, arch, run_dir, logroot)
        mark("train CLI all-kernel, --fsdp resumed")
        notebook_phase(card, work)
        mark("notebook")
        runbook_phase(card, dots, run_dir, work, runbook_arch)
        mark("runbooks")
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()
        inception_phase(card)
        eval_fid_phase(card, work, root / "val2014",
                       work / "samples" / "shard0" / "sample")
        mark("eval: Inception, FID")
        model = msvqgan_cli_phase(card, root, work)
        mark("MS-VQGAN training CLI")
        recon_phase(card, model, root, work)
        del model
        torch.cuda.empty_cache()
        mark("eval: reconstructions")
        vg_open_images_phase(card, work)
        mark("VG, OpenImages")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {k: round(v, 1) for k, v in seconds.items()}


def first_batch(loader):
    """A loader's first batch, its producer thread stopped after it."""
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def same(a, b):
    """Equal values: arrays element for element, anything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def colour_fixture_phase(card, coded):
    """The colour layouts besides JFIF YCbCr (``COLOR_SPECS``: CMYK at
    4:4:4 and 4:2:0, YCCK, Adobe RGB), each decoded by nvJPEG as its coded
    components (``NVJPEG_OUTPUT_UNCHANGED``) and converted on the card as
    libjpeg and PIL convert them: RGB within JPEG_RGB_LEVELS of PIL's
    (mean JPEG_RGB_MEAN_LEVELS); the CMYK 4:4:4 planes within
    JPEG_PLANE_LEVELS of libjpeg's; libjpeg's own planes through the
    port's conversion on the card equal to PIL's RGB (CMYK and YCCK from
    the CMYK file's planes, RGB from the 4:4:4 YCbCr file's)."""
    from frido_tpu_torch.data.image_io import jpeg_layout
    from frido_tpu_torch.ops.cuda.jpeg import (decode_jpeg, decode_planes,
                                               full_planes, planes_to_rgb)
    from frido_tpu_torch.tools.make_mini_coco import (COLOR_SPECS, FIXTURES,
                                                      fixture_pixels)

    pixels = fixture_pixels(specs=COLOR_SPECS)
    source = {"cmyk_444.jpg": "cmyk_444.jpg", "ycck_444.jpg": "cmyk_444.jpg",
              "rgb_444.jpg": "wide_444.jpg"}
    for name, w, h, space, sub, _ in COLOR_SPECS:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        layout = jpeg_layout(data, name)
        img, _ = timed(lambda: decode_jpeg(data, "cuda", name))
        want = torch.from_numpy(pixels[name]).cuda()
        d = (img.int() - want.int()).abs()
        mx, mean = d.max().item(), d.float().mean().item()
        notes = ""
        if name in coded:
            got = torch.stack(decode_planes(data, "cuda", name), -1)
            plane_err = (got.int() - torch.from_numpy(coded[name]).cuda()
                         .int()).abs().max().item()
            if plane_err > JPEG_PLANE_LEVELS:
                raise AssertionError(f"jpeg {name}: coded planes {plane_err}"
                                     f" levels from libjpeg's")
            notes += f"; coded planes max {plane_err}"
        if name in source:
            ref = torch.from_numpy(coded[source[name]]).cuda()
            conv = planes_to_rgb(full_planes(list(ref.unbind(-1)), layout,
                                             name), space, True)
            conv_err = (conv.int() - want.int()).abs().max().item()
            if conv_err:
                raise AssertionError(f"jpeg {name}: libjpeg's planes through "
                                     f"the port's conversion {conv_err} "
                                     "levels from PIL's RGB")
            notes += "; libjpeg's planes through the port's conversion: 0"
        if mx > JPEG_RGB_LEVELS or mean > JPEG_RGB_MEAN_LEVELS:
            raise AssertionError(f"jpeg {name} ({space}): |nvJPEG - PIL| max "
                                 f"{mx}, mean {mean:.4f} levels")
        _, secs = timed(lambda: [decode_jpeg(data, "cuda", name)
                                 for _ in range(JPEG_REPS)])
        log(f"jpeg {name} ({w}x{h}, {space}, Adobe transform "
            f"{layout.adobe_transform}, sampling "
            f"{[c[1:] for c in layout.components]}) on {card}: |nvJPEG - "
            f"PIL| max {mx} levels, mean {mean:.4f}{notes}; decode "
            f"{secs / JPEG_REPS * 1e3:.3f} ms")


def resume_phase(card, dots):
    """A resumed train loader replays the uninterrupted one: the t2i
    config's train split over the tree on the card (batch 32, random-1d,
    flip, its worker threads), with ``objects_bbox`` added to its keys so
    that the builders' shuffles of 2-5 boxes an image are drawn; seeded as
    the training CLI seeds it (``seed_data``). Loaders resumed at (epoch
    0, batch 1) and (epoch 1, batch 1) give the uninterrupted loader's
    batches there: pixels, captions, boxes, crops and flips equal."""
    from frido_tpu_torch.cli.main import seed_data
    from frido_tpu_torch.config import apply_dotlist

    cfg = apply_dotlist(load_yaml(str(T2I)), dots + [
        "data.params.train.params.keys=[image,caption,file_name,"
        "annotations,crop_bbox,flipped,objects_bbox]"])

    def loader():
        dm = instantiate_from_config(cfg["data"], device=torch.device(
            "cuda", 0)).setup()
        seed_data(dm, CLI_SEED)
        return dm.train_dataloader()

    first = loader()
    straight, secs = timed(lambda: [b for _ in range(2) for b in first])
    per_epoch = len(straight) // 2
    for epoch, batch in ((0, 1), (1, 1)):
        resumed = loader()
        resumed.set_cursor(epoch, batch)
        got = first_batch(resumed)
        want = straight[epoch * per_epoch + batch]
        if not torch.equal(got["image"], want["image"]):
            raise AssertionError(f"resume at ({epoch}, {batch}): pixels "
                                 f"{(got['image'] - want['image']).abs().max()}")
        for k in ("caption", "file_name", "crop_bbox", "flipped",
                  "objects_bbox", "annotations"):
            if not same(got[k], want[k]):
                raise AssertionError(f"resume at ({epoch}, {batch}): {k}")
    flips = {f for b in straight for f in b["flipped"]}
    log(f"resume on {card}: the t2i train loader (batch {TRAIN_BATCH}, "
        f"random-1d, flip, objects_bbox) resumed at (epoch 0, batch 1) and "
        f"(epoch 1, batch 1) gives the uninterrupted loader's batches: "
        f"pixels bit for bit, captions, boxes, crops and flips {flips} "
        f"equal; two epochs ({len(straight)} batches) in {secs:.2f} s")


def inception_phase(card):
    """The FID InceptionV3 with ``random_state_dict(0)`` on the card
    against the same model on the CPU, TF32 off on both, on EVAL_IMAGES
    seeded images at 299^2: features and logits within EVAL_FEATURE_RTOL
    of the largest |feature| (|logit|)."""
    from frido_tpu_torch.eval import inception

    sd = inception.random_state_dict(0)
    cpu = inception.InceptionV3.from_state_dict(sd, "cpu")
    gpu = inception.InceptionV3.from_state_dict(sd, "cuda")
    x = seeded((EVAL_IMAGES, 299, 299, 3), 41, device="cpu").tanh()
    with inception.fp32():
        want_f = cpu.features(x)
        got_f, secs = timed(lambda: gpu.features(x.cuda()))
        want_l, got_l = cpu.head(want_f), gpu.head(got_f)
    errs = [((g.cpu() - w).abs().max() / w.abs().max()).item()
            for g, w in ((got_f, want_f), (got_l, want_l))]
    if max(errs) > EVAL_FEATURE_RTOL:
        raise AssertionError(f"Inception card vs CPU {errs} > "
                             f"{EVAL_FEATURE_RTOL} of the largest")
    log(f"FID Inception (random_state_dict(0)) on {card}: card vs CPU, "
        f"fp32, TF32 off, {EVAL_IMAGES} images at 299^2: features "
        f"{errs[0]:.2e}, logits {errs[1]:.2e} of the largest (tol "
        f"{EVAL_FEATURE_RTOL}); {secs * 1e3:.1f} ms for the batch")


def eval_fid_phase(card, work, real_dir, fake_dir):
    """``cli/eval_fid.py --size 256 --inception_score`` between the
    tree's val JPEGs and the dataset-sampling PNGs on the card, its
    Inception's weights ``random_state_dict(0)`` written as an .npz and
    named by FRIDO_TPU_INCEPTION: FID, IS, the CLI's seconds, and the
    tower's img/s at batch 32 on the real images, warm."""
    from frido_tpu_torch.cli import eval_fid
    from frido_tpu_torch.eval import fid, inception

    path = work / "inception.npz"
    np.savez(path, **inception.random_state_dict(0))
    old = os.environ.get("FRIDO_TPU_INCEPTION")
    os.environ["FRIDO_TPU_INCEPTION"] = str(path)
    try:
        out, secs = timed(lambda: eval_fid.main([
            "--real", str(real_dir), "--fake", str(fake_dir), "--size",
            "256", "--inception_score"]))
        images = fid.load_images(str(real_dir), size=256)
        _, warm = timed(lambda: inception.run_batched(fid.inception_model(),
                                                      images, batch=32))
    finally:
        if old is None:
            del os.environ["FRIDO_TPU_INCEPTION"]
        else:
            os.environ["FRIDO_TPU_INCEPTION"] = old
    if not (math.isfinite(out["fid"]) and out["fid"] >= 0
            and all(math.isfinite(v) for v in out["is"])):
        raise AssertionError(f"eval_fid: {out['fid']}, {out['is']}")
    log(f"eval_fid CLI on {card}: {out['n'][0]} real (the tree's val "
        f"JPEGs, --size 256) vs {out['n'][1]} fake (dataset-sampling PNGs)"
        f", seeded Inception: FID {out['fid']:.6g}, IS {out['is'][0]:.6g} "
        f"+/- {out['is'][1]:.4g}; load {out['load_seconds']:.2f} s, "
        f"features {out['feature_seconds']:.2f} s (the model's load "
        f"included), whole CLI {secs:.2f} s (the rest: the Frechet "
        f"distance's 2048^2 sqrtm on the host); the tower again on the "
        f"{len(images)} real images: {len(images) / warm:.1f} img/s at "
        f"batch 32")


def msvqgan_cli_phase(card, tree, work):
    """``cli/train_msvqgan.py`` in process: the MS-VQGAN config at its batch
    of 6 and full width, fp32, over the tree (its ``data:`` paths only),
    MSVQ_CLI_STEPS default with a checkpoint every MSVQ_CKPT_EVERY, then
    all-kernel; launches per step held to the architecture's (one encode,
    one decode); the first step's logs equal a direct ``VQGANTrainer``
    step from the same initial state and batch (MSVQ_STEP_RTOL); the last
    train state loads back into that trainer equal to the one in memory.
    Returns the default run's model (for the reconstructions)."""
    from frido_tpu_torch.cli import train_msvqgan
    from frido_tpu_torch.io import checkpoint as ckpt_io

    dots = [f"data.params.{s}.params.data_path={tree}"
            for s in ("train", "validation", "test")]
    runs = {}
    for label, steps in MSVQ_CLI_STEPS.items():
        all_kernel = label == "all-kernel"
        name = f"MS-VQGAN training CLI, {label}"
        with (all_kernels() if all_kernel else contextlib.nullcontext()):
            summ = train_msvqgan.main([
                "-b", str(MSVQ), "-s", str(MSVQ_SEED), "-l",
                str(work / "msvq_logs"), "-n",
                f"msvq_{label.replace('-', '_')}", "--max_steps",
                str(steps), "--log_every_steps", "1", "--ckpt_every_steps",
                str(MSVQ_CKPT_EVERY), *dots])
            tr = summ["trainer"]
            per_step = expected_first_stage_launches(
                first_stage_arch(tr.model, 256), all_kernel, encodes=1,
                decodes=1)
        got = {k: v for k, v in summ["launches"].items() if k in per_step}
        want = {k: v * steps for k, v in per_step.items()}
        bad = [v for s in summ["logs"] for v in s.values()
               if not math.isfinite(v)]
        if summ["steps"] != steps or got != want or bad:
            raise AssertionError(f"{name}: {summ['steps']} steps, launches "
                                 f"{got}, expected {want}, logs "
                                 f"{summ['logs']}")
        secs = summ["step_seconds"]
        steady = secs[1:] or secs
        log(f"{name} on {summ['card']}: batch {summ['batch']}, fp32, lr "
            f"{summ['lr']:.2e}, {steps} steps: set-up "
            f"{summ['setup_seconds']:.2f} s; step seconds {rounded(secs, 4)}"
            f", {summ['batch'] * len(steady) / sum(steady):.3f} img/s after "
            f"the first; peak memory above the model "
            f"{summ['peak_gib_above_model']:.2f} GiB; train-state writes "
            f"{rounded(summ['checkpoint_seconds'], 2)} s; logs "
            f"{summ['logs']}; launches {got} ({steps} x the architecture's),"
            f" {summ['launches']['decode_jpeg']} nvJPEG decodes")
        runs[label] = summ
    summ = runs["default"]
    cfg = load_yaml(str(MSVQ))
    model = instantiate_from_config(cfg["model"], seed=MSVQ_SEED)
    loss = instantiate_from_config(cfg["model"]["params"]["lossconfig"],
                                   seed=MSVQ_SEED)
    opts = [optim.AdamW(list(m.parameters()), summ["lr"], b1=0.5, b2=0.9,
                        weight_decay=0.0) for m in (model, loss)]
    direct = vqgan_trainer.VQGANTrainer(model, loss, *opts)
    logs = direct.train_step(summ["first_batch"].cuda())
    for k in ("aeloss", "discloss"):
        want = summ["logs"][0][k]
        if abs(float(logs[k]) - want) > MSVQ_STEP_RTOL * max(abs(want), 1.0):
            raise AssertionError(f"MS-VQGAN CLI first step {k}: "
                                 f"{want} vs direct {float(logs[k])}")
    ckdir = pathlib.Path(summ["logdir"]) / "checkpoints"
    steps = MSVQ_CLI_STEPS["default"]
    stored = sorted(d.name for d in ckdir.iterdir() if d.is_dir())
    restored = ckpt_io.restore_train_state(str(ckdir), direct)
    mem, back = (ckpt_io.train_state(t) for t in (summ["trainer"], direct))
    same = all(torch.equal(back[p][k], v) for p in ("model", "loss")
               for k, v in mem[p].items()) and all(
        torch.equal(back[o][m][k], v) for o in ("opt_g", "opt_d")
        for m in ("mu", "nu") for k, v in mem[o][m].items())
    if restored != steps or not same or back["step"] != steps:
        raise AssertionError(f"MS-VQGAN CLI: the state at step {restored} "
                             f"does not load back equal")
    log(f"MS-VQGAN training CLI on {card}: first step's aeloss, discloss "
        f"{summ['logs'][0]} equal a direct VQGANTrainer step from the same "
        f"seeded state and batch ({float(logs['aeloss'])}, "
        f"{float(logs['discloss'])}; tol {MSVQ_STEP_RTOL} relative); "
        f"checkpoints {stored}; step_{steps} loads back into a "
        f"VQGANTrainer equal to the one in memory (weights, BatchNorm "
        f"statistics, both Adam states)")
    del direct, model, loss, opts, runs
    torch.cuda.empty_cache()
    return summ["trainer"].model


def recon_phase(card, model, tree, work):
    """The MS-VQGAN from the training CLI reconstructs the config's val
    split's first batch (center crop 256); ``cli/eval_recon.py`` between
    the inputs' and the reconstructions' PNGs on the card, and on the CPU:
    PSNR and SSIM equal within RECON_ATOL."""
    from frido_tpu_torch.cli import eval_recon
    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.utils.visualize import to_uint8, write_png

    cfg = apply_dotlist(load_yaml(str(MSVQ)), [
        f"data.params.{s}.params.data_path={tree}"
        for s in ("train", "validation", "test")])
    dm = instantiate_from_config(cfg["data"], device=torch.device(
        "cuda", 0)).setup()
    x = first_batch(dm.val_dataloader())["image"]
    model.eval()
    with torch.no_grad():
        rec = model(x)[0].clamp(-1, 1)
    model.train()
    dirs = {k: work / "recon" / k for k in ("real", "fake")}
    for key, imgs in (("real", x), ("fake", rec)):
        dirs[key].mkdir(parents=True, exist_ok=True)
        for i, im in enumerate(to_uint8(imgs.cpu().numpy())):
            write_png(im, str(dirs[key] / f"{i:03d}.png"))
    argv = ["--real", str(dirs["real"]), "--fake", str(dirs["fake"])]
    (ps, ss, n), secs = timed(lambda: eval_recon.main(argv))
    cps, css, _ = eval_recon.main(argv + ["--device", "cpu"])
    if max(abs(ps - cps), abs(ss - css)) > RECON_ATOL:
        raise AssertionError(f"eval_recon card {ps}, {ss} vs CPU {cps}, "
                             f"{css}")
    log(f"eval_recon CLI on {card}: {n} val images (256^2) vs the trained "
        f"MS-VQGAN's reconstructions: PSNR {ps:.6f} dB, SSIM {ss:.6f}; the "
        f"CPU's {cps:.6f}, {css:.6f} (tol {RECON_ATOL}); {secs:.2f} s")


def vg_open_images_phase(card, work):
    """The VG (sg2i), VG-cocostyle (layout2i) and OpenImages (layout2i)
    configs' train splits over synthetic trees written here from the
    fixtures (``write_vg_tree``, ``write_open_images_tree``; only their
    paths overridden), on the card: one batch at each config's batch size
    through its loader (img/s), and each sample of it planned on the card
    and on the CPU from the same seed: every key but the pixels equal;
    the pixels within JPEG_RGB_LEVELS / 127.5 of the CPU pipeline on PIL's
    committed pixels (mean 1 / 127.5)."""
    import random

    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.data.datamodule import DataLoader
    from frido_tpu_torch.tools.make_mini_coco import (
        COLOR_SPECS, FIXTURES, SPECS, fixture_pixels,
        write_open_images_tree, write_vg_tree)

    pixels = {**fixture_pixels(), **fixture_pixels(specs=COLOR_SPECS)}
    by_bytes = {open(os.path.join(FIXTURES, n), "rb").read(): n
                for n, *_ in SPECS + COLOR_SPECS}
    vg = write_vg_tree(str(work / "vg"), n=VG_IMAGES, seed=4)
    oi = write_open_images_tree(str(work / "openimage" / "train"),
                                n=OI_IMAGES, seed=4)
    cases = (("VG sg2i", SG2I_VG, [f"data_path={vg}",
                                   f"caption_ann_path={vg}/train_sg.json"]),
             ("VG-cocostyle layout2i", L2I_VG, [f"data_path={vg}"]),
             ("OpenImages layout2i", L2I_OI, [f"data_path={oi}"]))
    for label, config, over in cases:
        cfg = apply_dotlist(load_yaml(str(config)), [
            f"data.params.train.params.{o}" for o in over])
        dcfg = cfg["data"]["params"]["train"]
        batch = cfg["data"]["params"]["batch_size"]
        gpu, cpu = (instantiate_from_config(dcfg, device=d)
                    for d in (torch.device("cuda", 0), "cpu"))
        loader = DataLoader(gpu, batch, shuffle=True, num_workers=2 * batch,
                            drop_last=True)
        got, secs = timed(lambda: first_batch(loader))
        if tuple(got["image"].shape) != (batch, 256, 256, 3):
            raise AssertionError(f"{label}: batch {got['image'].shape}")
        worst = 0.0
        for ds in (gpu, cpu):
            ds.pipeline.rng.seed(5)
            ds.rng = random.Random(5)
        for i in range(batch):
            pg, pc = gpu.plan(i), cpu.plan(i)
            for k in set(pg) | set(pc):
                if not same(pg.get(k), pc.get(k)):
                    raise AssertionError(f"{label} sample {i}: {k}")
            with open(pc["image_path"], "rb") as f:
                src = by_bytes[f.read()]
            want = cpu.pipeline.apply(torch.from_numpy(pixels[src].copy()),
                                      pc["_spec"])
            img = gpu.load(pg)["image"].cpu()
            d = (img - want).abs()
            worst = max(worst, d.max().item())
            if d.max().item() > JPEG_RGB_LEVELS / 127.5 \
                    or d.mean().item() > 1 / 127.5:
                raise AssertionError(f"{label} sample {i} ({src}): pixels "
                                     f"{d.max().item()}")
        log(f"{label} loader on {card}: {config.relative_to(REPO)}'s train "
            f"split over {len(gpu)} synthetic records, batch {batch}: "
            f"{batch / secs:.1f} img/s for the first batch "
            f"({2 * batch} workers); {batch} samples card vs CPU: keys "
            f"equal, pixels max {worst * 127.5:.2f} levels")


# ---------------------------------------------------------------------------
def tp_sites(found, n):
    """The kernel sites a tensor-parallel rank at ``n_model = n`` runs for
    the sites ``found`` on one process: each 3x3 conv and fused prologue
    whose cout divides by n computes cout / n of its output channels from
    the same input (``parallel/tp.py``); attention, GroupNorm and the VQ
    argmin see the gathered tensors, the sites already checked. Calls that
    took a gradient keep it."""
    out = {name: set() for name in KERNELS}
    out["grad"] = {name: set() for name in KERNELS}
    for name in ("conv3x3", "conv3x3_norm_silu"):
        for src, dst in ((found[name], out[name]),
                         (found["grad"][name], out["grad"][name])):
            for site in src:
                if site[1] % n == 0:
                    dst.add((site[0], site[1] // n) + tuple(site[2:]))
    return out


def first_stage_found(model):
    """Every distinct kernel call of one all-kernel fp32 encode and decode
    of the model's first stage at this script's batch."""
    x = seeded_images(34)
    with all_kernels():
        def run():
            z = model.encode_first_stage(x)
            model.decode_first_stage(z)
        return record_sites(run)


def tp_sites_phase(step_found, stage_found):
    """Each distinct kernel site a tensor-parallel rank at n_model 2 and 4
    runs in the all-kernel bf16 t2i train step (forward and gradient) and
    in the fp32 first stage (encode and decode), checked against its plain
    version (and its gradient) unless checked before."""
    sites = []
    for n in TP_SIZES:
        sites += check_sites(tp_sites(step_found, n),
                             f"TP rank at n_model {n}: t2i train step")
        sites += check_sites(tp_sites(stage_found, n),
                             f"TP rank at n_model {n}: t2i first stage")
    return sites


def exact(name, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (np.abs(got - want).max() if got.shape == want.shape
                else f"shapes {got.shape} vs {want.shape}")
        raise AssertionError(f"{name}: not equal ({diff})")


def check_pngs(name, out_dir, logs, step):
    """Each array of ``logs`` written by ImageLogger as its grid under
    ``out_dir``: the file read back equals the grid's pixels."""
    from frido_tpu_torch.utils import visualize as vz

    for key, val in logs.items():
        if key == "file_name":
            continue
        path = out_dir / f"{key}_gs-{step:06}.png"
        exact(f"{name}: {path.name}", vz.read_png(str(path)),
              vz.to_uint8(vz.make_grid(val, nrow=4)))


@contextlib.contextmanager
def plot_flags(model, **flags):
    saved = dict(model.extra)
    model.extra.update(flags)
    try:
        yield
    finally:
        model.extra.clear()
        model.extra.update(saved)


def image_logging_phase(card, model, work):
    """``log_images`` of the full-width t2i model at LOG_N on the card,
    written by ``ImageLogger``: at the config's flags (no sampling) the
    inputs, the reconstruction (bit for bit the card's own encode and
    decode), the captions drawn as text (bit for bit the host render),
    each PNG read back equal to its grid; then with ``plot_sample`` and
    ``plot_quantize_denoised`` at DDIM-LOG_DDIM_STEPS (eta 1, fp32 UNet),
    the samples and their quantized decode bit for bit those of direct
    ``sample`` + ``decode`` with the same CPU generator. Seconds per
    logged step and launches."""
    from frido_tpu_torch.training.image_logger import ImageLogger
    from frido_tpu_torch.utils import visualize as vz

    images = seeded((LOG_N, 256, 256, 3), 72).tanh()
    batch = {"image": images, "caption": list(LOG_CAPTIONS),
             "file_name": [f"{i:012d}.jpg" for i in range(LOG_N)]}
    logger = ImageLogger(str(work), max_images=LOG_N)
    model.eval()
    # the first call builds the host tokenizer and the decoder's plans at
    # this batch; the second is a logged step's time
    _, first_secs = timed(lambda: logger.log_train(model, batch, 0))
    zero_launches()
    logs, secs = timed(lambda: logger.log_train(model, batch, 1))
    launches = read_launches()
    if set(logs) != {"inputs", "reconstruction", "conditioning",
                     "file_name"}:
        raise AssertionError(f"log_images at the config's flags: "
                             f"{sorted(logs)}")
    exact("inputs", logs["inputs"], images.cpu().numpy())
    exact("reconstruction", logs["reconstruction"], model.decode_first_stage(
        model.encode_first_stage(images)).float().cpu().numpy())
    exact("conditioning", logs["conditioning"],
          vz.log_txt_as_img((256, 256), list(LOG_CAPTIONS)))
    check_pngs("t2i image log", work / "images" / "train", logs, 1)
    with plot_flags(model, plot_sample=True, plot_quantize_denoised=True):
        logs2, secs2 = timed(lambda: model.log_images(
            batch, generator=torch.Generator().manual_seed(73), n=LOG_N,
            ddim_steps=LOG_DDIM_STEPS, ddim_eta=1.0))
    with torch.no_grad():
        ctx = model.get_learned_conditioning(model.tokenize(
            list(LOG_CAPTIONS)))
        z = model.sample(LOG_N, context=ctx, steps=LOG_DDIM_STEPS, eta=1.0,
                         sampler="ddim",
                         generator=torch.Generator().manual_seed(73))
        want = model.decode_first_stage(z).float().cpu().numpy()
        zq = model.quantize_latent(model._scale_latent(z, invert=True))
        want_q = model.first_stage_model.decode_interface(
            zq).float().cpu().numpy()
    exact("samples", logs2["samples"], want)
    exact("samples_x0_quantized", logs2["samples_x0_quantized"], want_q)
    if not all(np.isfinite(v).all() for k, v in logs2.items()
               if k != "file_name"):
        raise AssertionError("log_images gave non-finite values")
    log(f"image logging on {card}: t2i log_images at n {LOG_N} with the "
        f"config's flags (inputs, reconstruction, captions as text) "
        f"{secs:.3f} s a logged step (the first call {first_secs:.3f} s), "
        f"PNGs written by ImageLogger and read "
        f"back equal; reconstruction bit for bit the card's encode and "
        f"decode; the text render bit for bit the host's; launches "
        f"{launches}; with plot_sample and plot_quantize_denoised (DDIM "
        f"{LOG_DDIM_STEPS}, eta 1, fp32 UNet) {secs2:.3f} s, samples and "
        f"their quantized decode bit for bit direct sample + decode")


def layout2i_log_phase(card, model, work):
    """``log_images`` of the full-width layout2i model at BATCH with its
    ``objects_bbox`` conditioning drawn as boxes (the config's builder:
    1024 tokens, the crop encoded; COCO's labels): the render bit for bit
    ``plot_bbox_conditioning`` on the host, the PNG read back equal."""
    from frido_tpu_torch.data.conditional_builder import (
        ObjectsBoundingBoxConditionalBuilder)
    from frido_tpu_torch.training.image_logger import ImageLogger
    from frido_tpu_torch.utils import visualize as vz

    builder = ObjectsBoundingBoxConditionalBuilder(
        no_object_classes=183, no_max_objects=31, no_tokens=1024,
        encode_crop=True, use_group_parameter=True)
    labels = [f"category {i}" for i in range(183)]

    class Dataset:
        conditional_builders = {"objects_bbox": builder}

        @staticmethod
        def get_textual_label_for_category_no(n):
            return labels[n]

    rng = np.random.default_rng(74)
    rows = []
    for _ in range(BATCH):
        row = []
        for _ in range(int(rng.integers(2, 6))):
            x0, y0 = rng.integers(0, 28, 2)
            x1, y1 = rng.integers(x0 + 2, 32), rng.integers(y0 + 2, 32)
            row += [int(rng.integers(0, 183)), int(y0 * 32 + x0),
                    int(y1 * 32 + x1)]
        row += [builder.none] * (93 - len(row)) + [33, 990]
        rows.append(row)
    images = seeded((BATCH, 256, 256, 3), 75).tanh()
    batch = {"image": images, "objects_bbox": np.asarray(rows, np.int64)}
    logs, secs = timed(lambda: ImageLogger(str(work), max_images=BATCH)
                       .log_train(model, batch, 1, dataset=Dataset()))
    want = np.stack([vz.plot_bbox_conditioning(
        builder, row, Dataset.get_textual_label_for_category_no, (256, 256))
        for row in batch["objects_bbox"]])
    exact("layout2i box render", logs["conditioning"], want)
    if not (want < 1).any():
        raise AssertionError("layout2i box render drew nothing")
    check_pngs("layout2i image log", work / "images" / "train", logs, 1)
    log(f"layout2i image log on {card}: {BATCH} box renders of 2-5 boxes "
        f"and the crop, bit for bit plot_bbox_conditioning, PNGs read back "
        f"equal; {secs:.3f} s a logged step")


def toy_log_phase(card):
    """Every gallery of ``log_images`` on the toy model on the card (every
    ``plot_*`` gate on: DDIM-4 samples, their quantized decode, the
    diffusion and denoise rows, the progressive row of a 40-step chain),
    the noise from a CPU generator: finite values of each key's shape.
    The CPU tests hold these galleries to the JAX package's."""
    cfg = toy_config()
    cfg["params"]["timesteps"] = TOY_TIMESTEPS
    _, gpu = toy_models(cfg)
    batch = {"image": seeded_images(76, "cuda")[:2, ::4, ::4],
             "caption": ["a cat", "two dogs on a mat"],
             "file_name": ["a.jpg", "b.jpg"]}
    with plot_flags(gpu, plot_sample=True, plot_quantize_denoised=True,
                    plot_diffusion_rows=True, plot_denoise_rows=True,
                    plot_progressive_rows=True):
        logs, secs = timed(lambda: gpu.log_images(
            batch, generator=torch.Generator().manual_seed(77), n=2,
            ddim_steps=4))
    want = {"inputs", "reconstruction", "conditioning", "samples",
            "samples_x0_quantized", "diffusion_row", "denoise_row",
            "progressive_row", "file_name"}
    if set(logs) != want or not all(
            np.isfinite(v).all() for k, v in logs.items()
            if k != "file_name"):
        raise AssertionError(f"toy log_images: {sorted(logs)}")
    log(f"toy log_images on {card}: every gallery "
        f"{ {k: list(v.shape) for k, v in logs.items() if k != 'file_name'} }"
        f" finite, {secs:.2f} s")


@contextlib.contextmanager
def log_dir(name):
    """A fresh directory under build/ for an image log, removed after."""
    import shutil

    work = REPO / "build" / "chip_smoke_logs" / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        yield work
    finally:
        shutil.rmtree(work, ignore_errors=True)


def snapshot(tr):
    """A trainer's weights, EMA and Adam moments, copied on the card."""
    opt = tr.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    return {"params": [p.detach().clone() for p in tr.model.parameters()],
            "ema": [t.clone() for t in tr.ema.shadow.values()],
            "mu": [opt.state[p]["mu"].clone() for p in params],
            "nu": [opt.state[p]["nu"].clone() for p in params]}


def fsdp_phase(card, model):
    """The full-width t2i step with ``fsdp=True`` at world size 1 against
    the replicated step, bit for bit: FSDP_STEPS bf16 steps at the
    config's batch from the same weights, each mode's trainer built on the
    model, under a one-rank NCCL group, with PyTorch's deterministic
    algorithms on (cuDNN's and the embedding's backward otherwise sum in
    an order of their own from run to run). The replicated step runs
    twice first: the control that the step itself repeats bit for bit.
    Then the same with ``remat``, and the replicated ``remat`` step again
    after it (a control of the order). Under ``fsdp`` the per-unit path runs
    over a group of one (``parallel/fsdp.py``: each block gathered when
    called and before its backward, its gradients reduce-scattered in the
    backward): it fails unless the units gathered and reduce-scattered.
    Each mode's step seconds, peak allocation above the allocation at its
    start (the model, its earlier snapshots and the new trainer), peak
    reserved, the allocator's retries and device mallocs, train state a
    rank and the units' counters are printed with the card. The ``remat``
    modes take one more step, with FSDP_PROFILE under torch.profiler
    (the first two), whose heaviest kernels and host ops say where
    ``fsdp remat``'s time goes. Beside them, the 4-rank reckoning
    (:func:`fsdp_reckoning`)."""
    import socket

    import torch.distributed as tdist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             rank=0, world_size=1)
    cudnn_det = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    # (mode, fsdp, remat, the mode it must equal bit for bit)
    modes = [("replicated", False, False, None),
             ("replicated again", False, False, "replicated"),
             ("fsdp", True, False, "replicated"),
             ("replicated remat", False, True, None),
             ("fsdp remat", True, True, "replicated remat"),
             ("replicated remat again", False, True, "replicated remat")]
    try:
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        batch = train_batch(TRAIN_BATCH, 80)
        snaps, info = {}, {}
        for mode, fsdp, remat, ref in modes:
            model.load_state_dict(init)
            params = [p for _, p in trainer.trainable_parameters(model)]
            tr = trainer.DiffusionTrainer(
                model, optim.build_optimizer(params, TRAIN_LR),
                remat=remat, compute_dtype=torch.bfloat16, rank=0,
                world_size=1, fsdp=fsdp)
            gen = torch.Generator()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            stats0 = torch.cuda.memory_stats()
            secs = []
            for i in range(FSDP_STEPS):
                gen.manual_seed(90 + i)
                last = torch.cuda.memory_stats()
                secs.append(timed(lambda: tr.train_step(batch, gen))[1])
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            stats = torch.cuda.memory_stats()
            counters = tr.fsdp_counters()
            units = tr.sharding.units if tr.sharding is not None else []
            if remat:       # one more step, profiled but in the control
                gen.manual_seed(90 + FSDP_STEPS)
                if mode.endswith("again") or not FSDP_PROFILE:
                    tr.train_step(batch, gen)
                else:
                    profile_once(lambda: tr.train_step(batch, gen),
                                 f"fsdp phase, {mode}, one step", top=6,
                                 host=8)
            info[mode] = {"step_s": rounded(secs, 4),
                          "peak_gib_above_start": round(peak, 3),
                          "peak_reserved_gib": round(
                              torch.cuda.max_memory_reserved() / 2 ** 30, 3),
                          **{k: stats.get(k, 0) - stats0.get(k, 0) for k in (
                              "num_alloc_retries", "num_device_alloc",
                              "num_device_free")},
                          "last_step_device_alloc": stats.get(
                              "num_device_alloc", 0) - last.get(
                              "num_device_alloc", 0),
                          "state_gib": round(tr.state_bytes() / 2 ** 30, 3),
                          "units": len(units),
                          "sharded_leaves": sum(len(u.params)
                                                for u in units),
                          **counters}
            if fsdp and not (counters.get("gathers", 0) > 0 and
                             counters.get("reduce_scatters", 0) > 0):
                raise AssertionError(f"fsdp phase: {mode} ran no unit "
                                     f"collective: {counters}")
            snaps[mode] = snapshot(tr)
            if tr.sharding is not None:
                tr.sharding.close()
            del tr
            torch.cuda.empty_cache()
            if ref is not None:
                bad = [part for part, xs in snaps[mode].items()
                       if not all(torch.equal(x, y) for x, y in
                                  zip(xs, snaps[ref][part]))]
                if bad:
                    raise AssertionError(f"fsdp phase: {mode} differs from "
                                         f"{ref} in {bad}")
                del snaps[mode]
            if mode == "fsdp":
                del snaps["replicated"]
        del snaps, init
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn_det
        tdist.destroy_process_group()
        torch.cuda.empty_cache()
    log(f"fsdp on {card}: the t2i step at batch {TRAIN_BATCH}, bf16, "
        f"{FSDP_STEPS} steps, world size 1 (NCCL group), deterministic "
        f"algorithms: replicated twice bit for bit (the control), fsdp=True "
        f"(per-unit gathers and reduce-scatters over a group of one) bit "
        f"for bit the replicated (weights, EMA, Adam moments), with and "
        f"without remat; the replicated remat step again after fsdp remat "
        f"(a control of the order); remat modes one more step")
    for mode, row in info.items():
        log(f"fsdp on {card}: {mode}: {json.dumps(row)}")
    log(f"fsdp, reckoned from the t2i shapes for 4 data ranks (not "
        f"measured): {json.dumps(fsdp_reckoning(model, 4))}")


def fsdp_reckoning(model, n_data):
    """What a rank holds at ``n_data`` data ranks, fp32, from the shapes
    alone: the parameters, the trainable ones (all but the first stage),
    the data-sharded leaves and units of the data rule; the full
    parameters and trainable gradients a whole-model gather held at once
    (and its one gather and reduce-scatter a sharded leaf) against the
    units' bound: the rank's parts plus two of the largest unit in
    flight (``tests/test_torch_fsdp_units.py`` holds the measured peaks
    to it)."""
    params = dict(model.named_parameters())
    trainable = {n for n, _ in trainer.trainable_parameters(model)}
    dims = fsdp_units.data_dims_for(model, n_data)
    plan = fsdp_units.unit_plan(model, dims)
    size = {n: p.numel() * p.element_size() for n, p in params.items()}
    part = {n: b // (n_data if n in dims else 1) for n, b in size.items()}
    units = {o: fsdp_units.resident_bytes(p for _, _, p, _ in ents)
             for o, ents in plan.items()}
    largest = max(units, key=units.get)
    gib = 2 ** 30
    return {
        "n_data": n_data,
        "params": sum(p.numel() for p in params.values()),
        "trainable": sum(params[n].numel() for n in trainable),
        "params_gib": round(sum(size.values()) / gib, 4),
        "trainable_gib": round(sum(size[n] for n in trainable) / gib, 4),
        "sharded_leaves": len(dims),
        "sharded_trainable_leaves": len(set(dims) & trainable),
        "units": len(plan), "largest_unit": largest,
        "largest_unit_gib": round(units[largest] / gib, 4),
        "whole_model_full_params_and_grads_gib": round(
            (sum(size.values()) + sum(size[n] for n in trainable)) / gib, 4),
        "units_bound_params_gib": round(
            (sum(part.values()) + 2 * units[largest]) / gib, 4),
        "units_bound_grads_gib": round(
            (sum(part[n] for n in trainable) + 2 * units[largest]) / gib, 4)}


def cli_image_log_check(name, run_dir, dots):
    """The training CLI's image log at step IMG_LOG_EVERY: its inputs and
    captions are the third batch of the CLI's train loader (seeded as the
    CLI seeds it); each PNG holds that batch's grid, the reconstruction's
    grid has the inputs' size."""
    from frido_tpu_torch.cli.main import seed_data
    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.utils import visualize as vz

    out = run_dir / "images" / "train"
    names = sorted(os.listdir(out))
    want_names = sorted(f"{k}_gs-{IMG_LOG_EVERY:06}.png" for k in
                        ("inputs", "reconstruction", "conditioning"))
    if names != want_names:
        raise AssertionError(f"{name}: image log wrote {names}")
    cfg = apply_dotlist(load_yaml(str(T2I)), dots)
    dm = instantiate_from_config(cfg["data"], device=torch.device(
        "cuda", 0)).setup()
    seed_data(dm, CLI_TRAIN_SEED)
    loader, seen = dm.train_dataloader(), []
    while len(seen) < IMG_LOG_EVERY:     # across epochs, as the CLI runs
        it = iter(loader)
        try:
            for b in it:
                seen.append(b)
                if len(seen) == IMG_LOG_EVERY:
                    break
        finally:
            it.close()
    batch = seen[-1]
    grid = vz.make_grid(batch["image"][:LOG_N].float().cpu().numpy(), 4)
    exact(f"{name}: inputs PNG", vz.read_png(str(out / want_names[1])),
          vz.to_uint8(grid))
    text = vz.make_grid(vz.log_txt_as_img(
        (256, 256), batch["caption"][:LOG_N]), 4)
    exact(f"{name}: conditioning PNG", vz.read_png(str(out / want_names[0])),
          vz.to_uint8(text))
    rec = vz.read_png(str(out / want_names[2]))
    if rec.shape != grid.shape or rec.std() == 0:
        raise AssertionError(f"{name}: reconstruction PNG {rec.shape}")
    return [n for n in names]


def jax_import_phase(card):
    """A train state the JAX package trained, carried onto the card: the
    committed export ``frido_tpu_torch/data/fixtures/jax_export_toy``
    (``tools/make_jax_export_fixture.py``: a toy t2i trained two steps,
    AdamW with a bf16 first moment) imported as a port run
    (``tools/import_jax_run.py``), its trainer restored on the card with
    every tensor bit for bit the export's arrays, the JAX run's third step
    in fp32 against the JAX loss (3e-4), weights (2 lr) and EMA, then
    PLMS-4 from the EMA (``tools/jax_import_check.py``); in the default
    configuration (flash and the VQ argmin launched) and all-kernel (all
    six). Then the VG preprocessing without h5py on a raw dump
    (``tools/preprocess_vg_sg2im.py``, ``preprocess_vg_to_sg.py``,
    ``convert_vg_to_coco_style.py``). Returns the phase's seconds."""
    import shutil

    from frido_tpu_torch.tools import (convert_vg_to_coco_style,
                                       jax_import_check, preprocess_vg_sg2im,
                                       preprocess_vg_to_sg)
    from frido_tpu_torch.tools.make_mini_coco import write_vg_raw

    work = REPO / "build" / "chip_smoke_jax_import"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        for label in ("default", "all-kernel"):
            with (all_kernels() if label == "all-kernel"
                  else contextlib.nullcontext()):
                zero_launches()
                out = jax_import_check.run(torch.device("cuda"),
                                           str(work / label))
                launches = read_launches()
            want = (KERNELS if label == "all-kernel"
                    else ("flash_attention", "vq_argmin"))
            idle = [k for k in want if launches[k] == 0]
            if idle:
                raise AssertionError(f"jax-import ({label}) launched no "
                                     f"{idle}: {launches}")
            log(f"jax-import ({label}): step {out['step']}, cursor "
                f"{out['meta']}, every tensor bit for bit the export's; "
                f"third step against JAX {out['errors']}; "
                f"PLMS-{jax_import_check.PLMS_STEPS} from the EMA finite; "
                f"launches {launches}; seconds "
                f"{ {k: round(v, 2) for k, v in out['seconds'].items()} }")
        t1 = time.perf_counter()
        raw = work / "vg"
        flags = write_vg_raw(str(raw))
        preprocess_vg_sg2im.main(
            ["--vg_dir", str(raw), "--min_object_instances", "2",
             "--min_attribute_instances", "2",
             "--min_relationship_instances", "2",
             "--min_objects_per_image", "2",
             *[x for kv in flags.items() for x in kv]])
        for split in ("train", "val"):
            preprocess_vg_to_sg.main(["-b", str(raw), "-s", split])
            convert_vg_to_coco_style.main(["-b", str(raw), "-s", split])
        sg = json.loads((raw / "train_sg.json").read_text())
        boxes = json.loads((raw / "train_coco_style.json").read_text())
        if not (sg["annotations"] and boxes["annotations"]):
            raise AssertionError("VG preprocessing wrote no annotations")
        log(f"VG preprocessing without h5py: {len(sg['annotations'])} "
            f"sg2i captions, {len(boxes['annotations'])} layout2i boxes in "
            f"train, {time.perf_counter() - t1:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    log(f"jax-import phase: {secs:.2f} s on {card}")
    return secs


def dryrun_phase(card):
    """``tools/dryrun_multichip.py --full`` under torchrun on min(4,
    device count) cards (NCCL): the four checks at full t2i width. With
    one card it is not run, and a line says so."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        log(f"multi-card dry run not run: {torch.cuda.device_count()} card "
            f"on this machine (NCCL allows one rank a card; the four checks "
            f"run on 4 gloo ranks in tests/test_torch_sharding.py)")
        return
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m",
           "frido_tpu_torch.tools.dryrun_multichip", "--full"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            stdin=subprocess.DEVNULL, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun")]
    if proc.returncode != 0 or len(lines) != 4:
        raise AssertionError(f"dry run on {n} cards: exit {proc.returncode}"
                             f"\n{out[-3000:]}\n{err[-3000:]}")
    for ln in lines:
        log(f"{ln} ({n} x {card}, NCCL, --full)")


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


def pixel_config(new_order):
    """The ddpm-pixel model's config (``frido.models.diffusion.frido.DDPM``,
    no first stage, the t2i config's schedule)."""
    p = _T2I_PARAMS
    return {"target": "frido.models.diffusion.frido.DDPM", "params": dict(
        channels=3, image_size=64, timesteps=p["timesteps"],
        linear_start=p["linear_start"], linear_end=p["linear_end"],
        unet_config={"target": p["unet_config"]["target"],
                     "params": dict(PIXEL_UNET,
                                    use_new_attention_order=new_order)})}


def ablations_config():
    cfg = copy.deepcopy(_T2I_CFG["model"])
    cfg["params"]["unet_config"]["params"].update(ABLATIONS)
    return cfg


def unet_card_vs_cpu(name, unet, params, x, t, context=None, stage=0,
                     y=None):
    """One fp32 UNet call on the card against the same weights on the CPU
    (plain versions); returns the error relative to the CPU output's
    largest magnitude."""
    cpu = PyUNetModel(**params, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in unet.state_dict().items()})
    with torch.no_grad():
        got = unet(x, t, context, stage, y=y).cpu()
        want = cpu(*(None if a is None else a.cpu() for a in (x, t, context)),
                   stage, y=None if y is None else y.cpu())
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    if not (scale > 1e-2 and err <= FULL_UNET_RTOL):
        raise AssertionError(f"{name}: card vs CPU {err} of {scale} > "
                             f"{FULL_UNET_RTOL}")
    log(f"{name}: one fp32 UNet call card vs CPU, max error {err:.3e} of "
        f"the output's largest magnitude {scale:.3f} (tol {FULL_UNET_RTOL})")
    return err


def measured(run):
    """``run()`` in the current configuration with every count set to 0
    just before and read just after: (its result, launches, seconds, peak
    memory above what was allocated before, GiB)."""
    zero_launches()
    (out, secs), peak = peak_above(lambda: timed(run))
    return out, read_launches(), secs, peak


def pixel_launches(model, calls, all_kernel):
    """Each kernel's launches in ``calls`` ddpm-pixel UNet calls: each
    AttentionBlock's attention routed by its tokens; all-kernel, per
    call, a fused prologue and then a GroupNorm (scale-shift's, no SiLU)
    and a 3x3 conv in each ResBlock that keeps its size, two GroupNorm +
    SiLU kernels and two 3x3 convs in each resampling one (the resample
    sits between its norm and its conv), a GroupNorm in each
    AttentionBlock and in the out head, the stem and out-head convs."""
    unet = model.model.diffusion_model
    want = {name: 0 for name in KERNELS}
    route_attention(want, [(tok, tok, calls) for tok in unet_tokens(model)])
    if all_kernel:
        res = [m for m in unet.modules() if isinstance(m, ResBlock)]
        n_resample = sum(m.up or m.down for m in res)
        n_attn = count(unet, AttentionBlock)
        want["conv3x3_norm_silu"] = (len(res) - n_resample) * calls
        want["group_norm"] = (len(res) + n_resample + n_attn + 1) * calls
        want["conv3x3"] = (len(res) + n_resample + 2) * calls
    return want


def pixel_train_steps(card, model, name):
    """PIXEL_TRAIN_STEPS bf16 steps at the t2i batch of 32 on 64^2 images
    (the latent itself); step seconds, img/s, peak memory above the
    model, the launches of one step."""
    tr = diffusion_trainer(model, torch.bfloat16)
    batch = {"image": seeded((TRAIN_BATCH, 64, 64, 3), 19).tanh()}
    gen = torch.Generator().manual_seed(20)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    logs, first = timed(lambda: tr.train_step(batch, gen))
    launches = read_launches()
    secs = [first] + timed_steps(lambda: tr.train_step(batch, gen),
                                 PIXEL_TRAIN_STEPS - 1)
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    loss = logs["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"{name}: loss {loss}")
    log(f"{name} on {card}: bf16, batch {TRAIN_BATCH}, loss {loss:.5f}; "
        f"step seconds {[round(x, 4) for x in secs]}, "
        f"{TRAIN_BATCH * len(secs) / sum(secs):.3f} img/s; peak device "
        f"memory above the model {peak:.2f} GiB; launches per step "
        f"{launches}")
    del tr
    torch.cuda.empty_cache()
    return launches


def adm_wrapper(unet):
    """DiffusionWrapper("adm") around a ddpm-pixel UNet with 1000 class ids
    (use_embed), seeded on the card."""
    cfg = {"target": _T2I_PARAMS["unet_config"]["target"],
           "params": dict(PIXEL_UNET, num_classes=PIXEL_CLASSES,
                          use_embed=True)}
    wrapper = DiffusionWrapper(cfg, "adm", device="cuda")
    seed_init_(wrapper, 21, torch.device("cuda"))
    randomize_zero_init_(wrapper, 22)
    return wrapper.eval()


def adm_call(wrapper):
    x = seeded((BATCH, 3, 64, 64), 23, torch.bfloat16)
    t = torch.full((BATCH,), 500, device="cuda")
    y = torch.randint(0, PIXEL_CLASSES, (BATCH,), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(
                          24))
    with torch.no_grad():
        out = wrapper(x, t, c_crossattn=[y])
    if tuple(out.shape) != (BATCH, 3, 64, 64) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"adm UNet call gave {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    return out


def ddpm_pixel_phase(card):
    """ddpm-pixel: every distinct kernel call of one all-kernel
    DDIM step, one bf16 train step at batch 32 and one adm UNet call,
    checked (forward, and gradient where it takes one) as in
    ``check_sites``; in each QKV order the fp32 UNet card against CPU,
    DDIM-PIXEL_STEPS at batch 4 and the bf16 training steps in both
    configurations (img/s, launches held to the architecture's, peak
    memory); the adm call. Returns the sites' "other sites" entries."""
    t0 = time.perf_counter()
    model = instantiate_from_config(pixel_config(False), seed=0)
    randomize_zero_init_(model, 1)
    unet = model.model.diffusion_model
    log(f"ddpm-pixel model: {sum(p.numel() for p in model.parameters())} "
        f"parameters, {count(unet, ResBlock)} ResBlocks, "
        f"{count(unet, AttentionBlock)} AttentionBlocks over "
        f"{unet_tokens(model)} tokens, built in "
        f"{time.perf_counter() - t0:.2f} s")
    wrapper = adm_wrapper(unet)
    gen = lambda: torch.Generator(device="cuda").manual_seed(25)  # noqa: E731

    def ddim(steps):
        return model.sample(BATCH, steps=steps, eta=0.0, sampler="ddim",
                            compute_dtype=torch.bfloat16, generator=gen())

    with all_kernels():
        found = record_sites(lambda: (ddim(1), adm_call(wrapper)))
        tr = diffusion_trainer(model, torch.bfloat16)
        batch = {"image": seeded((TRAIN_BATCH, 64, 64, 3), 26).tanh()}
        grads = record_sites(lambda: tr.train_step(
            batch, torch.Generator().manual_seed(27)), grad=True)
        del tr
        torch.cuda.empty_cache()
    for name in KERNELS:
        found[name] |= grads[name]
    found["grad"] = grads["grad"]
    check_named_sites(found, PIXEL_NAMED_SITES, "the ddpm-pixel pass")
    sites = check_sites(found, "ddpm-pixel")

    x = seeded((2, 3, 64, 64), 28)
    t = torch.tensor([17, 803], device="cuda")
    for new_order in (False, True):
        order = "new" if new_order else "legacy"
        if new_order:
            model = instantiate_from_config(pixel_config(True), seed=0)
            randomize_zero_init_(model, 1)
            unet = model.model.diffusion_model
        unet_card_vs_cpu(f"ddpm-pixel ({order} QKV order)", unet,
                         dict(PIXEL_UNET, use_new_attention_order=new_order),
                         x, t)
        for label in ("default", "all-kernel"):
            with (all_kernels() if label == "all-kernel"
                  else contextlib.nullcontext()):
                img, launches, secs, peak = measured(
                    lambda: ddim(PIXEL_STEPS))
                want = pixel_launches(model, PIXEL_STEPS,
                                      label == "all-kernel")
            if tuple(img.shape) != (BATCH, 64, 64, 3) or not bool(
                    torch.isfinite(img).all()) or img.std().item() < 1e-4:
                raise AssertionError(f"ddpm-pixel DDIM: {tuple(img.shape)}")
            if launches != want:
                raise AssertionError(f"ddpm-pixel DDIM launches {launches}"
                                     f", expected {want}")
            log(f"ddpm-pixel DDIM-{PIXEL_STEPS} ({order} QKV order, {label})"
                f" on {card}: batch {BATCH}, bf16 UNet, {secs:.3f} s, "
                f"{BATCH / secs:.4f} img/s, peak device memory above the "
                f"model {peak:.2f} GiB, image std {img.std().item():.4f}, "
                f"launches {launches}")
        for label in ("default", "all-kernel"):
            with (all_kernels() if label == "all-kernel"
                  else contextlib.nullcontext()):
                launches = pixel_train_steps(
                    card, model, f"ddpm-pixel training ({order} QKV order, "
                    f"{label})")
                # one UNet forward a step; the backward launches nothing
                want = pixel_launches(model, 1, label == "all-kernel")
            if launches != want:
                raise AssertionError(f"ddpm-pixel training ({label}) "
                                     f"launches {launches}, expected {want}")
    zero_launches()
    with torch.no_grad():
        _, adm_s = timed(lambda: adm_call(wrapper))
    log(f"ddpm-pixel adm UNet call on {card}: {PIXEL_CLASSES} class ids "
        f"(Embed), batch {BATCH}, bf16, {adm_s * 1e3:.2f} ms, launches "
        f"{read_launches()}")
    del model, wrapper, unet
    torch.cuda.empty_cache()
    return sites


def t2i_ablations_phase(card):
    """t2i-ablations: every distinct kernel call of one all-kernel
    pass (conditioning, both stages' UNet calls on their expert trunks with
    the mscond branch and position embeddings, decode) and of one bf16
    train step at batch 32, checked as in ``check_sites``; one fp32 UNet
    call a stage card against CPU; PLMS-ABLATION_STEPS (CFG 1.5) with the
    decode at batch 4 in both configurations; one bf16 train step at batch 32.
    Returns the sites' "other sites" entries."""
    t0 = time.perf_counter()
    model = instantiate_from_config(ablations_config(), seed=0)
    randomize_zero_init_(model, 1)
    torch.cuda.synchronize()
    unet = model.model.diffusion_model
    log(f"t2i-ablations model: {sum(p.numel() for p in model.parameters())}"
        f" parameters, built in {time.perf_counter() - t0:.2f} s")
    with all_kernels():
        found = record_sites(lambda: sampling_pass(model, PATHS["t2i"]))
        tr = diffusion_trainer(model, torch.bfloat16)
        batch = train_batch(TRAIN_BATCH, 29)
        grads = record_sites(lambda: tr.train_step(
            batch, torch.Generator().manual_seed(30)), grad=True)
        del tr, batch
        torch.cuda.empty_cache()
    for name in KERNELS:
        found[name] |= grads[name]
    found["grad"] = grads["grad"]
    sites = check_sites(found, "t2i-ablations")

    params = ablations_config()["params"]["unet_config"]["params"]
    x = seeded((1, 8, 32, 32), 31)
    t = torch.tensor([311], device="cuda")
    with torch.no_grad():
        ctx = model.get_learned_conditioning(np.random.default_rng(32)
                                             .integers(0, 30522, (1, 77)))
    for stage in (0, 1):
        unet_card_vs_cpu(f"t2i-ablations stage {stage}", unet, params, x, t,
                         ctx, stage)
    path = PATHS["t2i"]
    for label in ("default", "all-kernel"):
        with (all_kernels() if label == "all-kernel"
              else contextlib.nullcontext()):
            (img, z, secs), launches, _, peak = measured(
                lambda: drive_main_path(model, path, 0, ABLATION_STEPS))
            check_images(img, f"t2i-ablations {label}")
            want = {"flash_attention", "vq_argmin"} | (
                set(KERNELS) if label == "all-kernel" else set())
            if not all(launches[k] > 0 for k in want):
                raise AssertionError(f"t2i-ablations {label} launches "
                                     f"{launches}")
            total = sum(secs.values())
            log(f"t2i-ablations PLMS-{ABLATION_STEPS} ({label}) on {card}: "
                f"batch {BATCH}, CFG {GUIDANCE} sequential, bf16 UNet: cond "
                f"{secs['cond']:.3f} s, sample {secs['sample']:.3f} s, "
                f"decode {secs['decode']:.3f} s, {BATCH / total:.4f} img/s;"
                f" peak device memory above the model {peak:.2f} GiB; "
                f"launches {launches}")
            zero_launches()
            tr = diffusion_trainer(model, torch.bfloat16)
            batch = train_batch(TRAIN_BATCH, 33)
            (logs, step_s), step_peak = peak_above(lambda: timed(
                lambda: tr.train_step(batch, torch.Generator().manual_seed(
                    34))))
            launches = read_launches()
            loss = logs["loss"].item()
            if not math.isfinite(loss):
                raise AssertionError(f"t2i-ablations training loss {loss}")
            log(f"t2i-ablations training ({label}) on {card}: one bf16 "
                f"step at batch {TRAIN_BATCH}, {step_s:.3f} s (the first, "
                f"with the EMA's and AdamW's state made), loss {loss:.5f}, "
                f"peak device memory above the model {step_peak:.2f} GiB, "
                f"launches {launches}")
            del tr, batch
            torch.cuda.empty_cache()
    del model, unet
    torch.cuda.empty_cache()
    return sites


def flops_phase(card):
    """``tools/flops_audit.py`` on the full-width t2i model (every unit on
    ``meta``, the plain versions' products): the TFLOP a sampled image at
    PLMS 200, CFG 1.5 (the JAX script's report), then the FLOPs the main
    path's timed PLMS-20 batch-4 run did in each configuration over its
    seconds and over the card's bf16 peak (a share, no limit)."""
    from frido_tpu_torch.tools import flagship, flops_audit

    t0 = time.perf_counter()
    meta = flagship.build(False, "meta")
    counted = flops_audit.unit_flops(meta, 1)
    if set(counted["devices"].values()) != {"meta"}:
        raise AssertionError(f"FLOP audit devices {counted['devices']}")
    report = flops_audit.compose(counted["flops"], meta.num_stage, 200)
    log(f"FLOP audit (t2i f16f8, PLMS 200, CFG {GUIDANCE} sequential, "
        f"products on meta, {time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(report)}")
    for label in ("default", "all-kernel"):
        secs, steps = MAIN_SECONDS[f"t2i, {label}"]
        path = flops_audit.compose(counted["flops"], meta.num_stage, steps)
        calls = unet_calls(meta, "plms", steps)
        if path["model_calls_per_image"] != calls:
            raise AssertionError(f"the audit composes "
                                 f"{path['model_calls_per_image']} UNet "
                                 f"calls, the sampler makes {calls}")
        tflop = path["total_tflop_per_image"] * BATCH
        log(f"main path share of peak (t2i, {label}) on {card}: "
            f"{tflop:.4f} TFLOP (products) for batch {BATCH}, PLMS {steps}, "
            f"CFG {GUIDANCE} sequential, in the timed run's {secs:.3f} s: "
            f"{tflop / secs:.3f} TFLOP/s, "
            f"{tflop * 1e12 / secs / PEAK_BF16_FLOPS:.5f} of the bf16 peak "
            f"({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s)")


def quality_phase(card):
    """``tools/quality_dpmpp_vs_plms.py`` at full width with cut step
    counts: its JSON line, no NaN, and DPM-Solver++'s latent PSNR against
    PLMS at least the control's minus QUALITY_MARGIN_DB."""
    from frido_tpu_torch.tools import quality_dpmpp_vs_plms as quality

    p, d, c = QUALITY_STEPS
    defaults = "/".join(map(str, quality.STEPS["full"]))
    log(f"quality check on {card}: full-width t2i (seeded, livened), batch "
        f"{QUALITY_BATCH}, PLMS {p} / DPM-Solver++ {d} / control PLMS {c} "
        f"(the script's defaults: batch 16, {defaults})")
    out, secs = timed(lambda: quality.main(
        ["--batch", str(QUALITY_BATCH), "--steps", f"{p},{d},{c}"]))
    torch.cuda.empty_cache()
    nan = [k for k, v in out.items() if isinstance(v, float) and v != v]
    if nan:
        raise AssertionError(f"quality check: NaN in {nan}")
    gap = out["control_plms100_latent_psnr_db"] - out["latent_psnr_db"]
    if gap > QUALITY_MARGIN_DB:
        raise AssertionError(f"quality check: DPM-Solver++ latent PSNR "
                             f"{out['latent_psnr_db']} dB is {gap:.2f} dB "
                             f"below the control's (margin "
                             f"{QUALITY_MARGIN_DB})")
    log(f"quality check: {secs:.1f} s; DPM-Solver++ latent PSNR "
        f"{out['latent_psnr_db']} dB, the control's "
        f"{out['control_plms100_latent_psnr_db']} dB (gap {gap:.2f} dB, "
        f"margin {QUALITY_MARGIN_DB})")


def profile_tools_phase(card, model):
    """``tools/profile_step.py`` on the t2i model at the main path's batch
    in both configurations (every unit all-kernel, whose trace must name
    all six kernels; the default's stage and cond units, which run none;
    stage 1's per-call ms held to the ``UNet call`` line), then
    ``tools/profile_train.py --units step`` at the training phase's batch,
    bf16 (the model trained in place one step, then back in eval mode)."""
    from frido_tpu_torch.tools import profile_step, profile_train

    # default: no decode unit (cuDNN's FFT launches ~34 000 kernels a
    # decode, slow to trace; the main path's profile shows it)
    units = {"default": ["stage0", "stage1", "cond"],
             "all-kernel": list(profile_step.UNITS)}
    want = {"default": set(),
            "all-kernel": set(profile_step.PORT_KERNEL_NAMES)}
    for label in ("default", "all-kernel"):
        log(f"profile_step ({label}) on {card}:")
        argv = ["--batch", str(BATCH), "--iters", str(PROFILE_ITERS),
                "--top", "8", "--units", ",".join(units[label])]
        with (all_kernels() if label == "all-kernel"
              else contextlib.nullcontext()):
            res, secs = timed(lambda: profile_step.main(argv, model=model))
        named = {c for unit in res.values()
                 for c, ms in unit["categories"].items()
                 if c in profile_step.PORT_KERNEL_NAMES and ms > 0}
        if named != want[label]:
            raise AssertionError(f"profile_step ({label}) named {named}, "
                                 f"not {want[label]}")
        stage1, call_ms = res["stage1"], UNET_CALL_MS[f"t2i, {label}"]
        dev, wall = stage1["ms"] / call_ms, stage1["wall_ms"] / call_ms
        if not (dev <= HOST_SPREAD and 1 / HOST_SPREAD <= wall
                <= PROFILER_SLOWDOWN * HOST_SPREAD):
            raise AssertionError(
                f"profile_step ({label}) stage 1: device {stage1['ms']:.3f}"
                f" ms, host {stage1['wall_ms']:.3f} ms a call against the "
                f"UNet call's {call_ms:.3f} ms")
        log(f"profile_step ({label}): {secs:.1f} s; kernels named "
            f"{sorted(named)}; stage 1 device {stage1['ms']:.3f} ms ({dev:.3f} of the UNet "
            f"call line's {call_ms:.3f} ms), host {stage1['wall_ms']:.3f} "
            f"ms under the profiler ({wall:.3f})")
    log(f"profile_train (step, batch {TRAIN_BATCH}, bf16) on {card}:")
    res, secs = timed(lambda: profile_train.main(
        ["--batch", str(TRAIN_BATCH), "--iters", "1", "--units", "step",
         "--top", "8"], model=model))
    model.eval()
    torch.cuda.empty_cache()
    if not res["step"]["ms"] > 0:
        raise AssertionError(f"profile_train: {res['step']['ms']} ms")
    log(f"profile_train: {secs:.1f} s")


def acceptance_phase(card, tree, run_dir, work):
    """``tools/acceptance.py`` in process: CKPT the training CLI's run,
    the mini-val config pointed at the tree (DATA_PATH, EXTRA_OVERRIDES:
    the caption files, an id list of the tree's val images, batches of
    4), STEPS ACCEPT_STEPS, N ACCEPT_N, the seeded Inception weights,
    the fallback vocabulary as the vocab file (the run was trained on its
    ids), no gate: exit 0, ``nogate``; then the gate alone on that FID,
    expecting it (``pass``, exit 0) and expecting it plus 2 TOL
    (``fail``, exit 1)."""
    from frido_tpu_torch.eval import inception
    from frido_tpu_torch.text.wordpiece import fallback_vocab
    from frido_tpu_torch.tools import acceptance

    weights, vocab = work / "inception.npz", work / "vocab.txt"
    np.savez(weights, **inception.random_state_dict(0))
    v = fallback_vocab()
    vocab.write_text("\n".join(sorted(v, key=v.get)) + "\n",
                     encoding="utf-8")
    ids = work / "ids_val.txt"
    ids.write_text("".join(f"{i:012d}\n" for i in range(1, TREE_IMAGES + 1)))
    extra = [d for d in tree_dotlist(tree) if "caption_ann_path" in d] + [
        f"data.params.test.params.img_id_file={ids}",
        f"data.params.batch_size={ACCEPT_N}"]
    out = work / "acceptance"
    env = {"CKPT": str(run_dir), "FRIDO_TPU_INCEPTION": str(weights),
           "FRIDO_TPU_BERT_VOCAB": str(vocab), "STEPS": str(ACCEPT_STEPS),
           "N": str(ACCEPT_N), "OUT": str(out), "EXPECTED_FID": "",
           "DATA_PATH": str(tree), "EXTRA_OVERRIDES": " ".join(extra)}
    with environ(env):
        rc, secs = timed(lambda: acceptance.main([]))
    result = json.loads((out / "acceptance" / "RESULT.json").read_text())
    n = len(os.listdir(out / "acceptance" / "sample"))
    if rc != 0 or result["status"] != "nogate" or n != ACCEPT_N:
        raise AssertionError(f"acceptance chain: exit {rc}, {result}, "
                             f"{n} samples")
    fid, tol = result["fid"], float(acceptance.DEFAULTS["TOL"])
    log(f"acceptance chain on {card}: the mini-val config over the tree, "
        f"CKPT the training CLI's run, PLMS {ACCEPT_STEPS}, CFG 1.5, "
        f"N {ACCEPT_N}, seeded Inception: exit {rc}, {result['status']}, "
        f"FID {fid:.6g}, {secs:.1f} s")
    for expected, status, code in ((fid, "pass", 0),
                                   (fid + 2 * tol, "fail", 1)):
        with environ(dict(env, EXPECTED_FID=repr(expected))):
            rc = acceptance.gate(acceptance.knobs(), fid)
        got = json.loads((out / "acceptance" / "RESULT.json").read_text())
        if rc != code or got["status"] != status:
            raise AssertionError(f"acceptance gate at {expected}: exit {rc}"
                                 f", {got}")
        log(f"acceptance gate alone, EXPECTED_FID {expected!r}, TOL "
            f"{tol:g}: exit {rc}, {got['status']}")


def run_runbooks(book, runs):
    """``bash book RUNBOOK_SHARDS`` in each (cwd, env) of ``runs``, all
    started at once, each in a session of its own with its stdout and
    stderr in ``<cwd>.out`` and ``<cwd>.err``; waited for in order, all
    within RUNBOOK_TIMEOUT. Returns each one's (exit code, stdout, stderr,
    seconds from the start to the wait's return)."""
    t0 = time.perf_counter()
    procs = []
    try:
        for cwd, env in runs:
            with open(f"{cwd}.out", "w") as out, \
                    open(f"{cwd}.err", "w") as err:
                procs.append(subprocess.Popen(
                    ["bash", str(book), str(RUNBOOK_SHARDS)], cwd=str(cwd),
                    env=env, stdout=out, stderr=err,
                    stdin=subprocess.DEVNULL, start_new_session=True))
        results = []
        for (cwd, _), proc in zip(runs, procs):
            left = RUNBOOK_TIMEOUT - (time.perf_counter() - t0)
            try:
                rc = proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"runbook in {cwd}: still running "
                                     f"after {RUNBOOK_TIMEOUT} s")
            results.append((rc, pathlib.Path(f"{cwd}.out").read_text(),
                            pathlib.Path(f"{cwd}.err").read_text(),
                            time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return results


def runbook_phase(card, dots, run_dir, work, arch):
    """The port's ``eval_t2i_multiGPU.sh RUNBOOK_SHARDS`` from the
    training CLI's run over the tree's first RUNBOOK_RECORDS test
    records, and beside it the same in an empty directory with ``CKPT``
    missing. Each shard's launches are held to ``arch``'s (the t2i model
    at PLMS RUNBOOK_STEPS, CFG batched) for one image. The run's train
    states other than its ``last`` are removed first (disk)."""
    import shutil

    import yaml

    from frido_tpu_torch.config import apply_dotlist
    from frido_tpu_torch.data.datamodule import split_indices_deterministic

    ckpts = run_dir / "checkpoints"
    last = os.path.basename(json.loads(
        (ckpts / "last.json").read_text())["path"].rstrip("/"))
    for old in ckpts.glob("step_*"):
        if old.name != last:
            shutil.rmtree(old)
    cwd, failing = work / "runbook", work / "runbook_missing"
    failing.mkdir()
    ids = work / "ids_runbook.txt"
    ids.write_text("".join(f"{i:012d}\n"
                           for i in range(1, RUNBOOK_RECORDS + 1)))
    cfg = apply_dotlist(load_yaml(str(T2I)), dots + [
        f"data.params.test.params.img_id_file={ids}"])
    config = cwd / T2I.relative_to(REPO)
    config.parent.mkdir(parents=True)
    config.write_text(yaml.safe_dump(cfg))
    book = REPO / "frido_tpu_torch" / "runbooks" / "frido" / (
        "eval_t2i_multiGPU.sh")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "FRIDO_TPU_STRICT_VOCAB")
           and k not in ALL_KERNELS}
    env.update(PYTHONPATH=str(REPO), CKPT=str(run_dir))
    # the sampling CLI refuses a missing -r before it reads the config or
    # touches the card: the failing run needs no config
    (rc, out, err, secs), run = run_runbooks(book, [
        (failing, dict(env, CKPT=str(failing / "none"))), (cwd, env)])
    if rc == 0 or os.listdir(failing) \
            or "no such file or directory" not in err:
        raise AssertionError(f"runbook with CKPT missing: exit {rc}\n"
                             f"{err[-3000:]}")
    log(f"runbook with CKPT missing: exit {rc} in {secs:.1f} s, nothing "
        f"sampled ({err.strip().splitlines()[-1]})")
    rc, out, err, secs = run
    if rc != 0:
        raise AssertionError(f"runbook: exit {rc}\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    ds = instantiate_from_config(cfg["data"]["params"]["test"],
                                 device=torch.device("cuda", 0))
    summaries = sorted((json.loads(ln[len("sampling summary: "):])
                        for ln in out.splitlines()
                        if ln.startswith("sampling summary: ")),
                       key=lambda x: x["shard"])
    samples = cwd / "exp" / "t2i" / "samples" / "full"
    seen = set()
    for i, summ in enumerate(summaries):
        idx = split_indices_deterministic(len(ds), RUNBOOK_SHARDS, i)
        names = {os.path.splitext(ds.image_descriptions[
            ds.image_ids[j]].file_name)[0] + ".png" for j in idx}
        # one image a shard: one decode, its ground truth one JPEG
        want = dict(expected_launches(arch, False), decode_jpeg=len(idx))
        if (summ["shard"] != i or summ["device"] != "cuda"
                or summ["images"] != len(idx) or len(idx) != 1
                or seen & names
                or summ["launches"] != want):
            raise AssertionError(f"runbook shard {i}: {summ}, files "
                                 f"{names}, launches want {want}")
        seen |= names
    written = {sub: set(os.listdir(samples / sub))
               for sub in ("sample", "inputs")}
    if len(summaries) != RUNBOOK_SHARDS or len(seen) != RUNBOOK_RECORDS \
            or any(w != seen for w in written.values()):
        raise AssertionError(f"runbook: {summaries}, wrote {written}, "
                             f"want {seen}")
    from frido_tpu_torch.utils.visualize import read_png
    for name in seen:
        if read_png(str(samples / "sample" / name)).shape != (256, 256, 3):
            raise AssertionError(f"runbook: sample {name} shape")
    log(f"runbook eval_t2i_multiGPU.sh {RUNBOOK_SHARDS} on {card}: "
        f"{RUNBOOK_SHARDS} processes on card 0, PLMS {RUNBOOK_STEPS}, CFG "
        f"1.5, bf16 UNet, CKPT the training CLI's run, {RUNBOOK_RECORDS} "
        f"test records: exit 0 in {secs:.1f} s (beside the run with CKPT "
        f"missing; limit {RUNBOOK_TIMEOUT} s); shards "
        + "; ".join(f"{s['shard']}: {s['images']} image, load "
                    f"{s['load_seconds']:.2f} s, sampling "
                    f"{s['sample_seconds']:.2f} s, launches "
                    f"{ {k: v for k, v in s['launches'].items() if v} }"
                    for s in summaries)
        + f" (the architecture's); files {sorted(seen)}")


def notebook_phase(card, work):
    """``frido_tpu_torch/demo.ipynb``'s code cells in order in one
    namespace, the first cell's steps replaced by NOTEBOOK_STEPS, its
    CKPT by '' (random weights) and its output folder put under ``work``;
    launches counted from 0."""
    nb = json.loads((REPO / "frido_tpu_torch" / "demo.ipynb").read_text())
    cells = ["".join(c["source"]) for c in nb["cells"]
             if c["cell_type"] == "code"]
    ns = {}
    exec(cells[0], ns)
    ns.update(CKPT="", STEPS=NOTEBOOK_STEPS, OUT=str(work / "demo"))
    zero_launches()
    t0 = time.perf_counter()
    with environ({"FRIDO_TPU_STRICT_VOCAB": "0"}):
        for cell in cells[1:]:
            exec(cell, ns)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    samples, grid, batch = ns["samples"], ns["grid"], ns["BATCH"]
    if (ns["DEVICE"] != "cuda" or samples.shape != (batch, 256, 256, 3)
            or not np.isfinite(samples).all()
            or grid.shape != (256, 256 * batch, 3)
            or not (work / "demo" / "grid.png").exists()
            or launches["flash_attention"] < 1
            or launches["vq_argmin"] < 1):
        raise AssertionError(f"notebook: samples {samples.shape}, grid "
                             f"{grid.shape}, launches {launches}")
    log(f"notebook on {card}: {len(cells)} code cells, {ns['CONFIG']}, "
        f"random weights, batch {batch}, PLMS {NOTEBOOK_STEPS}, CFG 1.5, "
        f"bf16 UNet: grid {grid.shape}, {secs:.1f} s (model build "
        f"included); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del ns
    torch.cuda.empty_cache()


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


def profile_once(run, name, top=5, host=0):
    """Device busy time and idle share of one ``run()`` under
    torch.profiler, its heaviest kernels and (``host`` > 0) its heaviest
    host ops by self time. Busy is the union of the kernels' intervals,
    so kernels that overlap count once; the profiler slows the host, so
    the idle share is an upper bound. The wall time ends in a
    synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(run)
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
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
    ops = [e for e in averages if e.device_type == DeviceType.CPU]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:host]:
        log(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms "
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
    UNET_CALL_MS[name] = call_ms
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
    jax_import_phase(card)
    mark("jax-import")

    model = build_main_model(T2I)
    t2i_arch = architecture(model, PATHS["t2i"], 1)
    runbook_arch = architecture(model, dict(PATHS["t2i"], cfg_batched=True),
                                RUNBOOK_STEPS)
    unet_conv_sum_phase(model)
    default = main_path_phase(card, model, "t2i", "default")
    with all_kernels():
        opt_in = main_path_phase(card, model, "t2i", "all-kernel")
    mark("t2i paths")
    flops_phase(card)
    mark("FLOP audit")
    other = encode_sites_phase(model, "t2i encode")
    mark("t2i encode sites")
    first_stage_phase(card, model, "t2i", "default")
    with all_kernels():
        first_stage_phase(card, model, "t2i", "all-kernel")
    mark("t2i first stage")
    step_sites, step_found = diffusion_sites_phase(model)
    other += step_sites
    mark("diffusion train step sites")
    other += tp_sites_phase(step_found, first_stage_found(model))
    mark("TP rank sites")
    diffusion_training_phase(card, model, "default", torch.bfloat16,
                             TRAIN_STEPS)
    with all_kernels():
        diffusion_training_phase(card, model, "all-kernel", torch.bfloat16,
                                 TRAIN_STEPS)
    diffusion_training_phase(card, model, "default", None, (1, 0))
    mark("t2i diffusion training")
    fsdp_phase(card, model)
    mark("fsdp")
    with log_dir("t2i") as work:
        image_logging_phase(card, model, work)
    toy_log_phase(card)
    mark("image logging")
    profile_tools_phase(card, model)
    mark("profile tools")
    del model
    torch.cuda.empty_cache()
    quality_phase(card)
    mark("quality check")
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
    with log_dir("layout2i") as work:
        layout2i_log_phase(card, model, work)
    mark("layout2i image log")
    del model
    torch.cuda.empty_cache()
    with clip_vocab():
        clip_towers_phase(card)
    mark("CLIP towers")
    model = build_main_model(CLIP_T2I)
    found = sampling_cli_phase(card, model)
    mark("sampling CLI")
    del model
    torch.cuda.empty_cache()
    other += clip_sites_phase(found)
    mark("clip-t2i sites")
    other += ddpm_pixel_phase(card)
    mark("ddpm pixel")
    other += t2i_ablations_phase(card)
    mark("t2i ablations")
    for phase, secs in data_cli_phases(card, t2i_arch,
                                       runbook_arch).items():
        seconds[phase] = secs
    dryrun_phase(card)
    mark("multi-card dry run")
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
