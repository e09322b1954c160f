"""MS-VQGAN training CLI (port of ``scripts/train_msvqgan.py``).

    python -m frido_tpu_torch.cli.train_msvqgan -b configs/msvqgan/CONFIG \\
        [-n NAME] [-l LOGDIR] [-s SEED] [--max_steps N] \\
        [--log_every_steps N] [--ckpt_every_steps N] [--scale_lr BOOL] \\
        [--bf16_train] [--device cpu] [a.b.c=value ...]

The JAX script's flags and loop: the config's MS-VQGAN and its loss
(``lossconfig``) on one device (the card unless ``--device cpu``), the
config's ``data:`` section through the port's data layer, two Adam
optimisers (b1 0.5, b2 0.9, no weight decay) at ``lr = batch_size x 1 x
base_learning_rate`` (one device; ``--scale_lr False``: the base rate),
``training/vqgan_trainer.VQGANTrainer`` without the auxiliary loss, as
the JAX script builds its step, in bf16 for the encoder and decoder
under ``--bf16_train``. With ``use_actnorm`` in the loss the
discriminator's ActNorms are initialised from the first training batch.
The logdir ``<logdir>/<time>_<name>`` gets the merged ``config.yaml``;
the train state (``io/checkpoint.py``: both networks, both Adam states,
the step) is saved every ``--ckpt_every_steps``, at ``--max_steps`` and
at the end of ``lightning.trainer.max_epochs`` (50 by default). Every
``--log_every_steps`` it prints ``step N aeloss x disc y (z img/s)``, and
at the end one ``train summary: {json}`` line (set-up and step seconds,
img/s, checkpoint write seconds, kernel launches, peak memory above the
model on the card). The JAX script has no resume; neither has this.

Two things are the port's own: the data's crop, flip and builder draws
are seeded by ``--seed`` (``cli/main.seed_data``; the JAX script leaves
them to the OS), and the ActNorm peek rewinds the loader, so the first
step trains on the batch it peeked (the JAX script's peek starts the
persistent loader's first epoch, and training begins at its second).
``--scale_lr`` parses a boolean (the JAX script takes any string given,
"False" included, as true). In process, :func:`main` returns the
summary with the trainer and the first batch.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch
import yaml

from frido_tpu_torch.cli.main import (launch_counts, peek_first_batch,
                                      seed_data, str2bool)
from frido_tpu_torch.config import instantiate_from_config, load_configs
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.training import optim
from frido_tpu_torch.training.vqgan_trainer import VQGANTrainer


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[])
    p.add_argument("-t", "--train", default=True)
    p.add_argument("-n", "--name", type=str, default="msvqgan")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--log_every_steps", type=int, default=50)
    p.add_argument("--ckpt_every_steps", type=int, default=2000)
    p.add_argument("--scale_lr", type=str2bool, default=True)
    p.add_argument("--bf16_train", action="store_true",
                   help="bf16 encoder/decoder compute, fp32 master params "
                        "and losses")
    p.add_argument("--device", default=None,
                   help="the training device (default: the card)")
    return p


def build(args, dotlist: List[str]) -> Dict[str, Any]:
    """Config, logdir, model, loss, data and trainer, before any step."""
    cfg = load_configs(args.base, dotlist=dotlist)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "frido_tpu_torch trains on the GPU by default and no CUDA device "
            "is available; pass --device cpu to train on the CPU")
    device = torch.device(args.device or "cuda")
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    logdir = os.path.join(args.logdir, f"{now}_{args.name}")
    ckptdir = os.path.join(logdir, "checkpoints")
    os.makedirs(ckptdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)

    mp = cfg["model"]["params"]
    model = instantiate_from_config(cfg["model"], device=device,
                                    seed=args.seed)
    loss = instantiate_from_config(mp["lossconfig"], device=device,
                                   seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        model_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        model_bytes = 0
    data = instantiate_from_config(cfg["data"], device=device).setup()
    seed_data(data, args.seed)
    bs = cfg["data"]["params"]["batch_size"]
    base_lr = cfg["model"]["base_learning_rate"]
    lr = bs * 1 * base_lr if args.scale_lr else base_lr
    print(f"learning rate: {lr:.2e}")
    opt_g, opt_d = (optim.AdamW(list(m.parameters()), lr, b1=0.5, b2=0.9,
                                weight_decay=0.0) for m in (model, loss))
    sample = None
    if mp["lossconfig"].get("params", {}).get("use_actnorm"):
        sample = peek_first_batch(data, args.seed)["image"]
    tr = VQGANTrainer(model, loss, opt_g, opt_d, use_aux_loss=False,
                      compute_dtype=torch.bfloat16 if args.bf16_train
                      else None, sample_images=sample)
    return dict(cfg=cfg, device=device, logdir=logdir, ckptdir=ckptdir,
                model=model, loss=loss, data=data, trainer=tr,
                batch_size=bs, lr=lr, model_bytes=model_bytes)


def fit(args, run: Dict[str, Any], t_start: float) -> Dict[str, Any]:
    """The JAX script's loop over epochs and batches."""
    tr, device, bs = run["trainer"], run["device"], run["batch_size"]
    ckpt_seconds: List[float] = []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save(step):
        t0 = time.perf_counter()
        ckpt_io.save_train_state(run["ckptdir"], step,
                                 ckpt_io.train_state(tr))
        ckpt_seconds.append(time.perf_counter() - t0)

    sync()
    setup_seconds = time.perf_counter() - t_start
    before = launch_counts()
    step, first, step_seconds, logged = 0, None, [], []
    window = {"t": time.perf_counter(), "skip": 0.0}
    epochs = run["cfg"].get("lightning", {}).get("trainer", {}).get(
        "max_epochs", 50)
    done = False
    for _ in range(epochs):
        for batch in run["data"].train_dataloader():
            x = batch["image"]
            if first is None:
                first = x.detach().cpu()
            logs = tr.train_step(x)
            step += 1
            if step % args.log_every_steps == 0:
                aeloss, disc = (float(logs[k]) for k in ("aeloss",
                                                         "discloss"))
                dt = time.perf_counter() - window["t"] - window["skip"]
                step_seconds.append(dt / args.log_every_steps)
                logged.append({"step": step, "aeloss": aeloss,
                               "discloss": disc})
                print(f"step {step} aeloss {aeloss:.4f} disc {disc:.4f} "
                      f"({args.log_every_steps * bs / dt:.1f} img/s)",
                      flush=True)
                window.update(t=time.perf_counter(), skip=0.0)
            t0 = time.perf_counter()
            if args.max_steps > 0 and step >= args.max_steps:
                save(step)
                done = True
                break
            if args.ckpt_every_steps and step % args.ckpt_every_steps == 0:
                save(step)
            window["skip"] += time.perf_counter() - t0
        if done:
            break
    if not done:
        save(step)
    sync()
    summary = {"steps": step, "setup_seconds": setup_seconds,
               "step_seconds": step_seconds, "logs": logged, "batch": bs,
               "lr": run["lr"],
               "device": str(device), "checkpoint_seconds": ckpt_seconds,
               "launches": {k: v - before[k]
                            for k, v in launch_counts().items()}}
    if step_seconds:
        summary["img_per_s"] = bs / (sum(step_seconds) / len(step_seconds))
    if device.type == "cuda":
        summary["peak_gib_above_model"] = (
            torch.cuda.max_memory_allocated(device)
            - run["model_bytes"]) / 2 ** 30
        summary["card"] = torch.cuda.get_device_name(device)
    print("train summary: " + json.dumps(summary), flush=True)
    summary.update(trainer=tr, first_batch=first, logdir=run["logdir"])
    return summary


def main(argv=None) -> Optional[Dict[str, Any]]:
    t_start = time.perf_counter()
    args, unknown = get_parser().parse_known_args(argv)
    run = build(args, [u for u in unknown if "=" in u])
    return fit(args, run, t_start)


if __name__ == "__main__":
    main()
