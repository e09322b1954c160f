"""Device time of each unit of the training step, by category and by
kernel (port of ``scripts/profile_train.py``).

    python -m frido_tpu_torch.tools.profile_train [--batch 16] [--iters 3]
        [--top 15] [--units step,encode,lossgrad,opt] [--fp32] [--remat]
        [--tiny] [--msvqgan] [--device cpu]

Points ``tools/profile_step.py``'s capture and report (its
``summarize`` and categorizer) at the units of ``DiffusionTrainer``'s
step on the flagship t2i model (seeded weights, all-zero images and
tokens at 256^2; bf16 compute unless ``--fp32``; AdamW at 1e-4 with the
EMA, as the JAX script's):

- ``step``: the whole ``train_step`` (the frozen encode, the conditioning,
  the two stages' windowed losses forward and backward, AdamW, the EMA);
- ``encode``: the frozen MS-VQGAN encode alone at batch B;
- ``lossgrad``: the conditioning and both stages' losses, forward and
  backward, from a latent made beforehand (t = 500, seeded noise), every
  gradient read once (its squared sum) so none is left unused;
- ``opt``: AdamW and the EMA update from gradients made beforehand.

``--remat`` recomputes the loss's activations in the backward
(``DiffusionTrainer(remat=True)``; ``lossgrad`` under
``torch.utils.checkpoint`` alike). ``--msvqgan`` profiles the MS-VQGAN
GAN step instead (``VQGANTrainer``, the generator and discriminator
phases, the config's model at 256^2, Adam 4.5e-6 with b1 0.5 and b2 0.9
for both, LPIPS off, bf16 encoder and decoder unless ``--fp32``, from
step 0). ``--tiny`` runs the tiny models at 32^2 (a CPU smoke test);
the GAN's tiny model is the tiny t2i model's first stage. Runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.device import resolve_device
from frido_tpu_torch.tools import flagship
from frido_tpu_torch.tools.profile_step import capture, report
from frido_tpu_torch.training import optim, trainer as trainer_mod
from frido_tpu_torch.training.vqgan_trainer import VQGANTrainer

UNITS = ("step", "encode", "lossgrad", "opt")
LR = 1e-4
GAN_LR = 4.5e-6


def msvqgan_config(tiny: bool) -> Dict[str, Any]:
    """The MS-VQGAN config's model node with LPIPS off, or the tiny
    model's first stage with the config's loss."""
    cfg = load_yaml(flagship.MSVQGAN_CONFIG)["model"]
    cfg["params"]["lossconfig"]["params"]["perceptual_weight"] = 0.0
    if tiny:
        tiny_first = copy.deepcopy(flagship._TINY_FIRST["params"])
        cfg["params"].update(embed_dim=tiny_first["embed_dim"],
                             n_embed=tiny_first["n_embed"],
                             edconfig=tiny_first["edconfig"],
                             ddconfig=tiny_first["ddconfig"])
    return cfg


def profile_msvqgan(args, device) -> Dict[str, Any]:
    """The GAN step (both phases) under the profiler."""
    cd = None if args.fp32 else torch.bfloat16
    print(f"device={device} batch={args.batch} "
          f"dtype={'fp32' if args.fp32 else 'bf16'} model=msvqgan")
    cfg = msvqgan_config(args.tiny)
    model = instantiate_from_config(cfg, device=device, seed=0)
    loss = instantiate_from_config(cfg["params"]["lossconfig"],
                                   device=device, seed=0)
    opt_g, opt_d = (optim.build_optimizer(list(m.parameters()), GAN_LR,
                                          b1=0.5, b2=0.9, weight_decay=0.0)
                    for m in (model, loss))
    gan = VQGANTrainer(model, loss, opt_g, opt_d, compute_dtype=cd)
    side = cfg["params"]["ddconfig"]["resolution"]
    x = torch.zeros((args.batch, side, side, 3), device=device)
    ev, wall = capture(lambda: gan.train_step(x)["aeloss"], args.iters,
                       "msvqgan")
    out = report(ev, args.iters, "msvqgan GAN step (G+D)", args.top)
    print(f"\n  device-time bound: {args.batch / (out['ms'] / 1e3):.1f} "
          f"img/s at batch {args.batch}")
    return {"msvqgan": out}


def profile_diffusion(args, device, model=None) -> Dict[str, Any]:
    """The diffusion step's units under the profiler; ``model`` (a built
    flagship or tiny model) skips the build and is trained in place."""
    cd = None if args.fp32 else torch.bfloat16
    print(f"device={device} batch={args.batch} "
          f"dtype={'fp32' if args.fp32 else 'bf16'} remat={args.remat}")
    if model is None:
        model = flagship.build(args.tiny, device)
    params = [p for _, p in trainer_mod.trainable_parameters(model)]
    tr = trainer_mod.DiffusionTrainer(
        model, optim.build_optimizer(params, LR), use_ema=True,
        remat=args.remat, compute_dtype=cd)
    ctx_len, _ = flagship.context_shape(args.tiny)
    side = model.first_stage_ddconfig["resolution"]
    B = args.batch
    batch = {"image": torch.zeros((B, side, side, 3), device=device),
             "tokens": torch.zeros((B, ctx_len), dtype=torch.long,
                                   device=device)}
    gen = torch.Generator(device=device).manual_seed(0)
    units = [u for u in args.units.split(",") if u]
    unknown = set(units) - set(UNITS)
    if unknown:
        raise ValueError(f"--units: unknown {sorted(unknown)}; the units "
                         f"are {', '.join(UNITS)}")
    results = {}

    if "step" in units:
        ev, _ = capture(lambda: tr.train_step(batch, gen)["loss"],
                        args.iters, "step")
        results["step"] = report(ev, args.iters, "step (full)", args.top)

    img = batch["image"] if cd is None else batch["image"].to(cd)
    if "encode" in units:
        ev, _ = capture(lambda: model.encode_first_stage(img).float().mean(),
                        args.iters, "encode")
        results["encode"] = report(ev, args.iters,
                                    "encode (frozen first stage)", args.top)

    if "lossgrad" in units or "opt" in units:
        z = model.encode_first_stage(img).float()
        # t = 500 (the tiny schedule's last step, 99, on the tiny model)
        t = torch.full((B,), min(500, model.timesteps - 1), dtype=torch.long,
                       device=device)
        noise = torch.randn(z.shape, generator=gen, device=device)

        def loss_fn():
            ctx = model.get_learned_conditioning(batch["tokens"])

            def diffusion_loss(z, ctx, t, noise):
                return model.training_loss(z, ctx, t, noise,
                                           compute_dtype=cd)[0]

            if args.remat:
                return torch.utils.checkpoint.checkpoint(
                    diffusion_loss, z, ctx, t, noise, use_reentrant=False)
            return diffusion_loss(z, ctx, t, noise)

        def lossgrad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            # read every gradient once, so none is left unused
            gn = sum(g.float().square().sum() for g in grads
                     if g is not None)
            return loss.detach() + 0.0 * gn

        if "lossgrad" in units:
            ev, _ = capture(lossgrad, args.iters, "lossgrad")
            results["lossgrad"] = report(
                ev, args.iters, "lossgrad (cond + 2-stage UNet fwd+bwd)",
                args.top)

        if "opt" in units:
            grads = torch.autograd.grad(loss_fn(), params, allow_unused=True)

            def opt():
                for p, g in zip(params, grads):
                    p.grad = g
                tr.optimizer.step()
                tr.ema.update()
                return params[0]

            ev, _ = capture(opt, args.iters, "opt")
            results["opt"] = report(ev, args.iters, "opt (AdamW + EMA)",
                                     args.top)

    if results:
        print("\n== summary (device ms/call) ==")
        for k, v in results.items():
            print(f"  {k:10s} {v['ms']:8.2f} ms")
        if "step" in results:
            acct = sum(v["ms"] for k, v in results.items() if k != "step")
            if acct:
                print(f"  sub-units account for {acct:.2f} ms of "
                      f"{results['step']['ms']:.2f} ms step "
                      f"({acct / results['step']['ms'] * 100:.0f}%)")
            ips = B / (results["step"]["ms"] / 1e3)
            print(f"  device-time bound: {ips:.1f} img/s at batch {B}")
    return results


def main(argv: Optional[list] = None, model=None) -> Dict[str, Any]:
    """The CLI; ``model`` (a built t2i model, left in training mode with
    the steps' updates) skips the diffusion model's build."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--units", default="step,encode,lossgrad,opt")
    ap.add_argument("--fp32", action="store_true",
                    help="profile the fp32 step instead of bf16")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny models (a CPU smoke test; its numbers "
                         "are not the flagship's)")
    ap.add_argument("--msvqgan", action="store_true",
                    help="profile the MS-VQGAN GAN step (G+D phases, f16f8 "
                         "at 256^2, LPIPS off) instead of diffusion")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.msvqgan:
        return profile_msvqgan(args, device)
    return profile_diffusion(args, device, model)


if __name__ == "__main__":
    main()
