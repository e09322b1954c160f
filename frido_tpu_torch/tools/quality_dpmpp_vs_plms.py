"""DPM-Solver++(2M) against PLMS on the flagship t2i model (port of
``scripts/quality_dpmpp_vs_plms.py``).

    python -m frido_tpu_torch.tools.quality_dpmpp_vs_plms [--batch 16]
        [--tiny] [--steps PLMS,DPMPP,CONTROL] [--device cpu]

Runs both samplers from the same ``x_T``, contexts and guidance on the
full-width t2i f16f8 model with seeded random weights and reports how
close DPM-Solver++(2M) lands to PLMS on the same probability-flow ODE, in
latent and in pixel space:

- latent PSNR (over the PLMS latent's range) and Pearson correlation;
- pixel PSNR (decoded [-1, 1] images) and correlation;
- a control: PLMS at fewer steps against PLMS, the spread within one
  sampler family against which the DPM-Solver++ gap is judged.

Steps: PLMS 200, DPM-Solver++ 25 and the PLMS 100 control (50, 10 and 25
with ``--tiny``, whose schedule has 100 timesteps), all at eta 0, CFG 1.5
run sequentially, the UNet in bf16, then the MS-VQGAN decode;
``--steps`` sets other counts. The control's keys keep the JAX script's
names (``control_plms100_*``) whatever its step count; ``steps`` in the
output says what ran. ``x_T`` is adopted as the finished stage 0, as the
JAX script passes it, so the samplers differ in stage 1.

Contexts: the conditional one from token ids drawn by
``np.random.RandomState(7)`` in [1, min(1000, vocab)), the unconditional
one from all-zero ids: distinct, so guidance is live.

The zero-initialised weights of the reference (every SpatialTransformer's
``proj_out`` and ResBlock's output conv) would make the attention branch,
and with it the conditional-unconditional difference, exactly zero at a
random init: :func:`liven_` gives each parameter of two or more
dimensions that is all zero 0.02 x standard normal noise. It picks the
leaves the JAX script's ``liven`` picks (the same zero leaves, through
``io/jax_weights.py``'s name map), and each leaf's noise comes from a
``torch.Generator`` seeded by the CRC32 of its name, not ``jax.random``'s
bits, which PyTorch cannot reproduce. So the numbers are this port's, not
the JAX script's.

Prints one JSON line with the JAX script's keys; ``backend`` is ``cuda``
or ``cpu``. Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from frido_tpu_torch.device import resolve_device
from frido_tpu_torch.tools import flagship

GUIDANCE = 1.5
LIVEN_SCALE = 0.02
STEPS = {"full": (200, 25, 100), "tiny": (50, 10, 25)}


def psnr(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    a -= a.mean()
    b -= b.mean()
    return float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@torch.no_grad()
def liven_(model: torch.nn.Module) -> List[str]:
    """Give every all-zero parameter of two or more dimensions
    ``LIVEN_SCALE`` x standard normal noise from a generator seeded by the
    CRC32 of its name; returns the names, in order."""
    names = []
    for name, p in model.named_parameters():
        if p.ndim >= 2 and not bool(p.any()):
            gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
            p.copy_(LIVEN_SCALE * torch.randn(p.shape, generator=gen))
            names.append(name)
    return names


def run(model, batch: int, tokens, utokens, x_t, sampler: str, steps: int):
    """tokens -> both contexts -> ``sampler`` at ``steps`` from ``x_t``
    (eta 0, CFG 1.5 sequential, bf16 UNet) -> decode: (latent, images) on
    the host, fp32."""
    with torch.no_grad():
        ctx = model.get_learned_conditioning(tokens)
        uctx = model.get_learned_conditioning(utokens)
        z = model.sample(batch, context=ctx, uncond_context=uctx,
                         steps=steps, eta=0.0, guidance_scale=GUIDANCE,
                         sampler=sampler, x_T=x_t,
                         compute_dtype=torch.bfloat16, cfg_mode="sequential")
        img = model.decode_first_stage(
            z, chunk=min(32, batch) if batch > 32 else None)
    return z.float().cpu().numpy(), img.float().cpu().numpy()


def agreement(model, batch: int, tiny: bool, steps) -> Dict[str, Any]:
    """The JAX script's report for ``model`` (already livened)."""
    ctx_len, vocab = flagship.context_shape(tiny)
    tokens = np.random.RandomState(7).randint(1, min(1000, vocab),
                                              (batch, ctx_len))
    utokens = np.zeros((batch, ctx_len), np.int64)
    lat = model.image_size
    x_t = torch.randn((batch, lat, lat, model.channels),
                      generator=torch.Generator().manual_seed(42))
    s_plms, s_dpm, s_ctrl = steps
    z_plms, img_plms = run(model, batch, tokens, utokens, x_t, "plms",
                           s_plms)
    z_dpm, img_dpm = run(model, batch, tokens, utokens, x_t, "dpmpp", s_dpm)
    z_ctrl, img_ctrl = run(model, batch, tokens, utokens, x_t, "plms",
                           s_ctrl)
    z_range = float(z_plms.max() - z_plms.min())
    return {
        "metric": f"DPM++(2M)-{s_dpm} vs PLMS-{s_plms} flagship agreement",
        "cfg": "guided (1.5, distinct uncond context, zero-init "
               "projections livened so the context path is nonzero)",
        "batch": batch,
        "model": "tiny" if tiny else "flagship t2i f16f8 (random init)",
        "latent_psnr_db": round(psnr(z_dpm, z_plms, z_range), 2),
        "latent_pearson": round(pearson(z_dpm, z_plms), 5),
        "pixel_psnr_db": round(psnr(img_dpm, img_plms, 2.0), 2),
        "pixel_pearson": round(pearson(img_dpm, img_plms), 5),
        "control_plms100_latent_psnr_db":
            round(psnr(z_ctrl, z_plms, z_range), 2),
        "control_plms100_pixel_psnr_db":
            round(psnr(img_ctrl, img_plms, 2.0), 2),
        "control_plms100_latent_pearson": round(pearson(z_ctrl, z_plms), 5),
        "backend": model.device.type,
        "steps": {"plms": s_plms, "dpmpp": s_dpm, "control": s_ctrl},
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (a CPU smoke test)")
    ap.add_argument("--steps", default=None,
                    help="PLMS,DPMPP,CONTROL step counts (default 200,25,100;"
                         " 50,10,25 with --tiny)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    steps = (tuple(int(s) for s in args.steps.split(",")) if args.steps
             else STEPS["tiny" if args.tiny else "full"])
    if len(steps) != 3:
        raise ValueError(f"--steps takes three counts, got {args.steps!r}")
    model = flagship.build(args.tiny, resolve_device(args.device), seed=0)
    liven_(model)
    out = agreement(model, args.batch, args.tiny, steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
