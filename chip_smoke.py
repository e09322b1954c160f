"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the t2i chain of ``configs/frido/t2i/frido_f16f8_coco.yaml``
at full width: token ids -> BERT context -> PLMS with classifier-free
guidance 1.5 (sequential) and a bf16 UNet over two pyramid stages ->
MS-VQGAN decode (per-scale VQ re-quantization, post_quant_conv, the 256^2
conv decoder). Weights are random, made from a seed; the zero-initialised
output convs get a seeded random init too, so the UNet does not predict 0.

Phases, in order; any failure exits non-zero and nothing is caught:

1. setup: card, power limit, versions, TF32 flags, kernel build time;
2. each hand-written kernel at main-path shapes against its plain PyTorch
   version: error, and kernel / plain / library-call times (CUDA events),
   beside the least time the card could take (``bound_ms``);
3. a toy-width model on the card against the same model on the CPU (the
   plain path, which the CPU tests hold to the JAX package);
4. the full-width main path, with every kernel's launch count set to 0
   just before and read just after.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one ``{"kernels": [...]}``
line. Without CUDA, or outside the repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import copy
import json
import math
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
from frido_tpu_torch.nn.layers import Conv2d  # noqa: E402
from frido_tpu_torch.nn.vqgan import AttnBlock  # noqa: E402
from frido_tpu_torch.ops.cuda import build  # noqa: E402
from frido_tpu_torch.ops.cuda.attention import (  # noqa: E402
    attention_plain, flash_attention)
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain  # noqa: E402,E501

T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml"

# Published peaks of one H100 SXM (dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores
PEAK_BYTES = 3.35e12         # HBM3

# main path, as bench.py runs it (batch 4 and 50 steps here, to stay short)
BATCH = 4
STEPS = 50
GUIDANCE = 1.5
DECODE_CHUNK = 32
CTX_LEN = 77
PROFILE_STEPS = 4   # a short chain under torch.profiler, for the breakdown
# kernel phases at the shapes the main path gives the kernels at the
# benchmark's decode chunk of 32: flash [32, 1024, 512], VQ N = 32*32*32
FLASH_SHAPE = (32, 1024, 512)
VQ_N, VQ_K, VQ_D = 32 * 32 * 32, 8192, 4

# Tolerances, fixed before the first run.
# flash against the plain version in fp32 on the same inputs: 5e-5, plus
# for bf16 2^-8 of the reference at each element (one rounding of the
# kernel's fp32 result to bf16 costs at most half of that); as the card tests
FLASH_ATOL = 5e-5
FLASH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
VQ_DIST_ATOL = 1e-5        # a kernel pick may differ only within a near tie
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


def flash_phase(dtype):
    b, n, d = FLASH_SHAPE
    q, k, v = (seeded(FLASH_SHAPE, s, dtype) for s in (10, 11, 12))
    scale = d ** -0.5
    got = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    want = attention_plain(q.float(), k.float(), v.float(), scale)
    diff = (got.float() - want).abs()
    err = diff.max().item()
    tol = f"{FLASH_ATOL} + {FLASH_RTOL[dtype]:.5f}*|plain|"
    if not bool((diff <= FLASH_ATOL + FLASH_RTOL[dtype] * want.abs()).all()):
        raise AssertionError(f"flash {dtype}: |kernel - plain| exceeds {tol} "
                             f"(max {err})")
    ms = cuda_ms(lambda: flash_attention(q, k, v, scale))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, scale))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale))
    itemsize = torch.finfo(dtype).bits // 8
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    bound_ms, bound_by = bound(4 * b * n * n * d, peak, 4 * b * n * d * itemsize)
    row = dict(name="flash_attention", route="cuda",
               source="frido_tpu_torch/csrc/flash_attention.cu",
               replaces="frido_tpu/ops/pallas/attention.py:301",
               launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log(f"flash_attention {dtype} q,k,v {list(FLASH_SHAPE)}: max_abs_err "
        f"{err:.3e} (tol {tol}), output max "
        f"{want.abs().max().item():.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by})")
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


def toy_phase():
    """The toy model on the card (kernels) against the same weights on the
    CPU (plain versions)."""
    cfg = toy_config()
    cpu = instantiate_from_config(cfg, device="cpu", seed=1)
    randomize_zero_init_(cpu, 2)
    gpu = instantiate_from_config(cfg, seed=1)
    gpu.load_state_dict(cpu.state_dict(), strict=True)

    tokens = np.random.default_rng(3).integers(0, 30522, (2, CTX_LEN))
    x_init = seeded((2, 32, 32, 8), 4, device="cpu")
    latents = []
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
    log(f"toy model card vs CPU: latent max_abs_err {lat_err:.3e} (tol "
        f"{TOY_LATENT_ATOL}), codes equal at {decided} decided rows, image "
        f"max_abs_err {img_err:.3e} (tol {TOY_IMAGE_ATOL}), image range "
        f"[{img_c.min().item():.3f}, {img_c.max().item():.3f}]")


# ---------------------------------------------------------------------------
def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_main_path(model, seed, steps=STEPS):
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


def main_path_phase(card):
    t0 = time.perf_counter()
    model = instantiate_from_config(load_yaml(str(T2I))["model"], seed=0)
    n_zero = randomize_zero_init_(model, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path model: {T2I.relative_to(REPO)}, {n_params} parameters, "
        f"{n_zero} zero-init convs randomised, built in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    vq_argmin.launches = 0
    img, z, secs = drive_main_path(model, seed=0)
    launches = {"flash_attention": flash_attention.launches,
                "vq_argmin": vq_argmin.launches}

    chunks = BATCH // DECODE_CHUNK if (BATCH > DECODE_CHUNK and
                                       BATCH % DECODE_CHUNK == 0) else 1
    want = {"flash_attention": 4 * chunks, "vq_argmin": 2 * chunks}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{want}")
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

    _, _, warm = drive_main_path(model, seed=1)
    for label, s in (("first run", secs), ("second run", warm)):
        total = sum(s.values())
        log(f"main path {label} on {card}: batch {BATCH}, PLMS {STEPS} "
            f"steps x 2 stages, CFG {GUIDANCE} sequential, bf16 UNet: "
            f"cond {s['cond']:.3f} s, sample {s['sample']:.3f} s, decode "
            f"{s['decode']:.3f} s, total {total:.3f} s, "
            f"{BATCH / total:.4f} img/s")
    log(f"main path: launches {launches}, image std {spread:.4f}, range "
        f"[{img.min().item():.3f}, {img.max().item():.3f}], peak device "
        f"memory {peak_gib:.2f} GiB")
    profile_phase(model)
    return launches


def profile_phase(model):
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
        log(f"profile (batch {BATCH}, PLMS {PROFILE_STEPS}, {unet_calls} "
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
    log(f"UNet call (batch {BATCH}, bf16, stage 1): {call_ms:.3f} ms; "
        f"casting its {sum(1 for _ in unet.parameters())} weight tensors "
        f"to bf16 alone: {cast_ms:.3f} ms")


def main():
    card = setup()
    rows = [flash_phase(torch.float32), vq_phase()]
    flash_phase(torch.bfloat16)   # the kernel's bf16 form; off the main path
    toy_phase()
    launches = main_path_phase(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
