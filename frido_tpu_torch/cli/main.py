"""Training CLI (port of the root ``main.py``).

    python -m frido_tpu_torch.cli.main -b CONFIG.yaml -t [--max_steps N] \\
        [--device cpu] [a.b.c=value ...]
    torchrun --nproc_per_node N -m frido_tpu_torch.cli.main -b CONFIG.yaml -t

The flags and defaults are the JAX script's; unknown ``a.b.c=value``
arguments override the config (dot-list). One process trains on one
device: the card (``cuda:LOCAL_RANK``) unless ``--device cpu``. Under
``torchrun`` the processes form one data-parallel group
(``parallel/dist.py``: NCCL on the card, gloo on the CPU, also at world
size 1): each rank loads and decodes its rows of every global batch of
the config's ``batch_size``, the gradients are averaged over the ranks
before AdamW (``training/trainer.py``), and the learning rate is
``scaled_learning_rate(base_lr, batch_size, world_size, accumulate,
scale_lr)``, with the global batch staying the config's, as the JAX
script scales it. Rank 0 writes the logdir, the checkpoints and the logs;
every rank restores.

A run: the logdir ``<logdir>/<time>_<name>`` with the merged config in
``configs/`` (a resumed run, ``-r`` or ``--auto_resume``, re-merges the
configs persisted there before ``-b`` and the overrides); the first
stage's ``ckpt_path`` imported; ``scale_by_std`` set from the first
global batch and kept in ``checkpoints/scale_factors.json``; AdamW (bf16
first moment under ``--adam_mu_bf16``, ``--accumulate_grad_batches``), the
EMA of the denoiser, the UNet and encode in bf16 under ``--bf16_train``;
checkpoints (``io/checkpoint.py``) with the loader's cursor in
``last.json`` so a resume replays the uninterrupted run's batches and
their random draws;
``val/loss`` and ``val/loss_ema`` every ``--val_every_steps`` with a
``best`` checkpoint on ``val/loss_ema``; SIGUSR1 saves, SIGUSR2 dumps the
stack (or attaches pdb on a tty); a CSV log (TensorBoard and wandb degrade
to it when missing); ``--debug`` moves a failed fresh run to
``debug_runs/``; after fitting, the test pass samples the test split with
DDIM in bf16 under the EMA weights and writes PNGs by ``file_name``
(``--uncond_gen_mode``: seed + rank). Each step's draws come from a
generator seeded by the seed and the step, so a resume draws what the
uninterrupted run drew; the data's crop, flip and builder draws are
seeded by the seed on every rank (the JAX script leaves them unseeded),
so the ranks together see the one-process run's batches. A resume
replays the same images with the same crops, flips and annotation
shuffles: the loader draws the plans of every batch before the cursor
again, without their pixels.

``--fsdp`` shards the parameters, both AdamW moments and the EMA over the
data-parallel ranks (``parallel/fsdp.py``, ZeRO-3 style: each block's
parameters gathered when it is called, one ``all_gather_into_tensor`` a
block, and again before its backward; its mean gradients reduce-scattered
inside the backward, one ``reduce_scatter_tensor`` a block; AdamW and the
EMA on the local parts), so no rank holds every full parameter or
gradient at once; the layout is data-only (no tensor parallelism), as in
the JAX script. Every forward then runs on every rank: validation, the
image log (rank 0 writes it) and the test pass (the loader gives every
rank as many batches). The summary
adds each rank's peak full-parameter and full-gradient GiB. With gloo
ranks (``--device cpu``) or one card a rank (NCCL), also at world size 1,
where the step is the replicated one bit for bit. Its checkpoints are
gathered and written whole by rank 0, so a ``--fsdp`` run's ``last``
resumes without ``--fsdp`` and the reverse.

Image logging (``training/image_logger.py``), as the JAX script does it:
every ``--img_log_every_steps`` steps ``log_images`` of the train batch
under the EMA weights, and at that cadence the first validation batch's,
written by rank 0 as PNG grids under ``<logdir>/images/{train,val}/``
(text and boxes drawn without PIL, ``utils/visualize.py``); a logging
error is printed and the run goes on. The summary's
``image_log_seconds`` holds each logged step's seconds (not step time).
"""

from __future__ import annotations

import argparse
import csv
import datetime
import glob
import json
import os
import random
import signal
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml

from frido_tpu_torch.config import instantiate_from_config, load_configs
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.ops.cuda import launch_counts
from frido_tpu_torch.parallel import dist
from frido_tpu_torch.training import optim, trainer as trainer_mod
from frido_tpu_torch.training.image_logger import ImageLogger
from frido_tpu_torch.utils.visualize import save_image


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml",
                   default=[])
    p.add_argument("-t", "--train", type=str2bool, default=False, nargs="?",
                   const=True)
    p.add_argument("--no-test", type=str2bool, default=False, nargs="?")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--scale_lr", type=str2bool, default=True, nargs="?")
    p.add_argument("--auto_resume", type=str2bool, default=False)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--max_epochs", type=int, default=-1)
    p.add_argument("--ckpt_every_steps", type=int, default=0)
    p.add_argument("--log_every_steps", type=int, default=50)
    p.add_argument("--val_every_steps", type=int, default=2000)
    p.add_argument("--val_batches", type=int, default=-1,
                   help="val batches per validation pass (-1 = the whole "
                        "val split)")
    p.add_argument("-tb", "--tensorboard", type=str2bool, default=False,
                   help="also log scalars to TensorBoard (logdir/tb)")
    p.add_argument("--wandb", type=str2bool, default=False,
                   help="also log scalars to Weights & Biases; degrades to "
                        "CSV if not installed")
    p.add_argument("-d", "--debug", type=str2bool, default=False,
                   help="post-mortem pdb on failure + move a fresh run's "
                        "logdir to debug_runs/")
    p.add_argument("--no_test", type=str2bool, default=False,
                   help="skip the post-fit test-split sampling pass")
    p.add_argument("--test_steps", type=int, default=200,
                   help="sampler steps for the post-fit test pass")
    p.add_argument("--test_batches", type=int, default=-1,
                   help="limit test batches (-1 = whole split)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel devices (0 = the torchrun world "
                        "size; any other value must equal it)")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--img_log_every_steps", type=int, default=1000,
                   help="log_images of the train batch (and the first val "
                        "batch) every N steps under the EMA weights, PNG "
                        "grids in logdir/images (0: off)")
    p.add_argument("--bf16_train", type=str2bool, default=False, nargs="?",
                   const=True,
                   help="bf16 UNet and encode with fp32 weights and "
                        "optimizer state")
    p.add_argument("--adam_mu_bf16", type=str2bool, default=False,
                   nargs="?", const=True,
                   help="store the Adam first moment in bf16")
    p.add_argument("--fsdp", type=str2bool, default=False, nargs="?",
                   const=True,
                   help="shard the parameters, Adam moments and EMA over "
                        "the data-parallel ranks (ZeRO-3 style; "
                        "parallel/fsdp.py): each block gathered when it "
                        "runs and its gradients reduce-scattered in the "
                        "backward, one collective a block; the numerics "
                        "of replicated data parallelism")
    p.add_argument("--uncond_gen_mode", type=str2bool, default=False,
                   nargs="?", const=True,
                   help="the test pass's seed is seed + rank")
    p.add_argument("--device", type=str, default=None,
                   help="torch device type (default: the card, "
                        "cuda:LOCAL_RANK)")
    return p


class CSVLogger:
    def __init__(self, path):
        self.path = path
        self.keys = None

    def log(self, step, metrics):
        metrics = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new = self.keys is None
        if new:
            self.keys = list(metrics.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(metrics)


class TensorBoardLogger:
    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir)

    def log(self, step, metrics):
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), step)


class WandbLogger:
    """Raises ImportError without wandb; the caller degrades to CSV."""

    def __init__(self, logdir, run_name, config=None):
        import wandb

        self.run = wandb.init(project="frido_tpu", name=run_name,
                              dir=logdir, config=config or {})

    def log(self, step, metrics):
        self.run.log({k: float(v) for k, v in metrics.items()}, step=step)


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, step, metrics):
        for lg in self.loggers:
            lg.log(step, metrics)


def batch_to_arrays(model, batch) -> Dict[str, Any]:
    """A collated batch -> the trainer's ``image`` and ``tokens``."""
    out = {"image": batch["image"]}
    key = model.cond_stage_key
    if model.cond_stage_model is not None:
        cond = batch[key] if key in batch else batch
        out["tokens"] = model.tokenize(cond)
    return out


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s draws (the JAX step folds the step into
    its key)."""
    return seed * 1_000_003 + step


def seed_data(data, seed: int) -> None:
    """Every rank draws the same crop and flip plans (each rank plans the
    whole global batch and keeps its rows) and the same builder shuffles:
    each dataset's pipeline and builders seeded alike, the builders with a
    ``random.Random`` of the dataset's own, so that validation and the
    test pass draw nothing from the train split's sequence, and a resume
    that replays the train plans (``DataLoader.set_cursor``) ends where
    the uninterrupted run stands. The global ``random`` is seeded too. The
    JAX package leaves all of them to the OS's entropy."""
    random.seed(seed)
    for ds in data.datasets.values():
        if getattr(ds, "pipeline", None) is not None:
            ds.pipeline.rng.seed(seed)
        if hasattr(ds, "rng"):
            ds.rng = random.Random(seed)


def peek_first_batch(data, seed: int) -> Dict[str, object]:
    """The train loader's first batch (for ``scale_by_std``), with the
    loader and the plans left as before the peek: the cursor back at epoch
    0's first batch, since last.json counts from it, and the pipelines
    seeded again, since the loader's thread plans batches ahead of the
    consumer (how far depends on timing), so the first training batch is
    this one on every rank."""
    loader = data.train_dataloader()
    it = iter(loader)
    first = next(it)
    it.close()
    loader.set_cursor(0, 0)
    seed_data(data, seed)
    return first


def run_device(args, world: dist.World) -> torch.device:
    if args.device is not None:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "frido_tpu_torch trains on the GPU by default and no CUDA device "
            "is available; pass --device cpu to train on the CPU")
    return torch.device("cuda", world.local_rank)


_RUN_LOGDIR = {"path": "", "fresh": False}


def main(argv=None) -> Optional[Dict[str, Any]]:
    """Post-mortem debugging and the ``debug_runs/`` move around
    :func:`train`."""
    args, unknown = get_parser().parse_known_args(argv)
    try:
        return train(args, unknown)
    except Exception:
        if args.debug:
            import pdb

            pdb.post_mortem()
        raise
    finally:
        if args.debug and _RUN_LOGDIR["fresh"] and _RUN_LOGDIR["path"]:
            src = _RUN_LOGDIR["path"]
            base, name = os.path.split(src)
            dst = os.path.join(base, "debug_runs", name)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.exists(src):
                os.rename(src, dst)
                print(f"debug run moved to {dst}")


def _usr2_debugger(signum, frame):
    """SIGUSR2: pdb at the interrupted frame on a tty, else the stack."""
    if sys.stdin.isatty():
        print("SIGUSR2 received: attaching pdb (c to continue)", flush=True)
        import pdb

        pdb.Pdb().set_trace(frame)
    else:
        import traceback

        print("SIGUSR2 received: no tty, dumping stack", flush=True)
        traceback.print_stack(frame)


def _run_logdir(args, name: str, world: dist.World):
    """(logdir, fresh) on rank 0, shared with every rank."""
    logdir, fresh = None, False
    if world.main:
        if args.resume:
            logdir = args.resume
        elif args.auto_resume and (
                found := ckpt_io.find_resume(args.logdir, name)):
            print(f"Auto-resuming from {found}")
            logdir = found
    if world.world_size > 1:
        box = [logdir]
        torch.distributed.broadcast_object_list(box, src=0)
        logdir = box[0]
    return logdir


def _scale_by_std(model, images: torch.Tensor, world: dist.World,
                  every_rank: bool = False):
    """Per-stage 1/std of the first global batch's latents, computed on
    rank 0 (on every rank with ``every_rank``: FSDP units gather in the
    encode) from every rank's rows, and rank 0's shared."""
    if world.world_size > 1:
        parts = [torch.empty_like(images) for _ in range(world.world_size)]
        torch.distributed.all_gather(parts, images.contiguous())
        images = torch.cat(parts)
    box = [model.init_scale_by_std(images)
           if world.main or every_rank else None]
    if world.world_size > 1:
        torch.distributed.broadcast_object_list(box, src=0)
    model.scale_factors = np.asarray(box[0], np.float32)
    return model.scale_factors


def train(args, unknown) -> Optional[Dict[str, Any]]:
    t_start = time.perf_counter()
    world = dist.init_from_env(args.device or "cuda")
    device = run_device(args, world)
    if args.n_devices not in (0, world.world_size):
        raise ValueError(f"--n_devices {args.n_devices} with a world of "
                         f"{world.world_size}: launch one process a device "
                         f"under torchrun")
    try:
        return _train(args, unknown, world, device, t_start)
    finally:
        dist.shutdown(world)


def _train(args, unknown, world, device, t_start):
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    name = (args.name or os.path.splitext(os.path.basename(args.base[0]))[0]
            if args.base else args.name)
    logdir = _run_logdir(args, name, world)
    if logdir:
        # a resumed run re-merges the configs persisted in its logdir
        # before the -b bases and the overrides
        persisted = sorted(glob.glob(os.path.join(logdir, "configs",
                                                  "*.yaml")))
        if persisted:
            args.base = persisted + list(args.base)
    cfg = load_configs(args.base, dotlist=[u for u in unknown if "=" in u])
    if not name:
        name = os.path.splitext(os.path.basename(args.base[0]))[0]
    if logdir is None:
        logdir = os.path.join(args.logdir, f"{now}_{name}")
        _RUN_LOGDIR.update(fresh=True)
        if world.world_size > 1:
            box = [logdir]
            torch.distributed.broadcast_object_list(box, src=0)
            logdir = box[0]
    _RUN_LOGDIR.update(path=logdir)
    ckptdir = os.path.join(logdir, "checkpoints")
    if world.main:
        cfgdir = os.path.join(logdir, "configs")
        os.makedirs(ckptdir, exist_ok=True)
        os.makedirs(cfgdir, exist_ok=True)
        with open(os.path.join(cfgdir, f"{now}-project.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)

    # ---- model ----------------------------------------------------------
    mp = dict(cfg["model"]["params"])
    model = instantiate_from_config(cfg["model"], device=device,
                                    seed=args.seed)
    fs_ckpt = (mp.get("first_stage_config") or {}).get(
        "params", {}).get("ckpt_path")
    if fs_ckpt and os.path.exists(fs_ckpt):
        print(f"Loading frozen first stage from {fs_ckpt}")
        from frido_tpu_torch.io.torch_import import (load_state_dict,
                                                     load_torch_checkpoint)

        load_state_dict(model.first_stage_model,
                        load_torch_checkpoint(fs_ckpt), strict=False)
    dist.broadcast_(model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        model_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    # ---- data -----------------------------------------------------------
    data = instantiate_from_config(
        cfg["data"], device=device, rank=world.rank,
        world_size=world.world_size).setup()
    seed_data(data, args.seed)
    batch_size = cfg["data"]["params"]["batch_size"]

    # ---- optimizer: the LR scaling rule, over the world size -----------
    base_lr = cfg["model"]["base_learning_rate"]
    lr = optim.scaled_learning_rate(base_lr, batch_size, world.world_size,
                                    args.accumulate_grad_batches,
                                    args.scale_lr)
    if world.main:
        print(f"Setting learning rate to {lr:.2e}")
    opt = optim.build_from_config(
        [p for _, p in trainer_mod.trainable_parameters(model)], lr,
        mp.get("scheduler_config"),
        accumulate_grad_batches=args.accumulate_grad_batches,
        mu_dtype=torch.bfloat16 if args.adam_mu_bf16 else None)
    use_remat = bool(mp.get("unet_config", {}).get("params", {})
                     .get("use_checkpoint", False))
    tr = trainer_mod.DiffusionTrainer(
        model, opt, use_ema=True, remat=use_remat,
        compute_dtype=torch.bfloat16 if args.bf16_train else None,
        rank=world.rank, world_size=world.world_size, fsdp=args.fsdp)
    # FSDP units gather in every forward: every rank runs them alike
    units = bool(tr.sharding is not None and tr.sharding.units)

    sf_path = os.path.join(ckptdir, "scale_factors.json")
    start_step = 0
    # the loader's cursor (shuffle epoch, batches consumed in it), kept in
    # last.json so that a resume replays the uninterrupted run's batches,
    # their crops, flips and builder shuffles included (set_cursor draws
    # the plans before the cursor again)
    cursor = {"epoch": 0, "batch": 0}
    if os.path.exists(os.path.join(ckptdir, "last.json")):
        start_step = ckpt_io.restore_train_state(ckptdir, tr)
        meta = ckpt_io.read_last_meta(ckptdir)
        cursor["epoch"] = int(meta.get("epoch", 0))
        cursor["batch"] = int(meta.get("batch_in_epoch", 0))
        if world.main:
            print(f"Restored training state at step {start_step} "
                  f"(epoch {cursor['epoch']}, batch {cursor['batch']})")
        if os.path.exists(sf_path):
            with open(sf_path) as f:
                model.scale_factors = np.asarray(json.load(f), np.float32)
    elif getattr(model, "scale_by_std", False):
        first = peek_first_batch(data, args.seed)
        sf = _scale_by_std(model, batch_to_arrays(model, first)["image"],
                           world, every_rank=units)
        if world.main:
            with open(sf_path, "w") as f:
                json.dump(sf.tolist(), f)
            print(f"scale_by_std: per-stage scale factors {sf.tolist()}")

    logger = CSVLogger(os.path.join(logdir, "metrics.csv"))
    if world.main and args.tensorboard:
        try:
            logger = MultiLogger(
                logger, TensorBoardLogger(os.path.join(logdir, "tb")))
        except ImportError:
            print("tensorboard unavailable; CSV logging only")
    if world.main and args.wandb:
        try:
            logger = MultiLogger(
                logger, WandbLogger(logdir, os.path.basename(logdir)))
        except ImportError:
            print("wandb unavailable; falling back to CSV logging")

    img_logger = ImageLogger(logdir, every_steps=args.img_log_every_steps)
    image_log_seconds = []

    def log_images(batch, step, split):
        """Rank 0 writes ``log_images`` of ``batch`` under the EMA
        weights (under ``--fsdp`` every rank computes it: the units gather
        in it); a logging error is printed and the run goes on."""
        t0 = time.perf_counter()
        with tr.weights(ema=True):
            if world.main or units:
                try:
                    img_logger.log_train(
                        model, batch, step, split=split,
                        dataset=data.datasets.get(
                            "validation" if split == "val" else "train"),
                        generator=torch.Generator(device=device).manual_seed(
                            args.seed), write=world.main)
                except Exception as e:  # logging must never kill a run
                    print(f"{split} image logging failed: {e!r}")
        image_log_seconds.append(time.perf_counter() - t0)

    stop_requested = {"save": False}
    signal.signal(signal.SIGUSR1, lambda *_: stop_requested.update(save=True))
    signal.signal(signal.SIGUSR2, _usr2_debugger)

    ckpt_seconds = []

    def full_state():
        """The train state on rank 0 (None elsewhere); every rank gathers
        under sharded state."""
        if tr.sharding is None and not world.main:
            return None
        return ckpt_io.train_state(tr)

    def save(step):
        """Rank 0 writes the train state; returns the seconds it took."""
        t0 = time.perf_counter()
        state = full_state()
        if not world.main:
            return 0.0
        ckpt_io.save_train_state(
            ckptdir, step, state,
            meta={"epoch": cursor["epoch"],
                  "batch_in_epoch": cursor["batch"]})
        ckpt_seconds.append(time.perf_counter() - t0)
        print(f"Saved checkpoint at step {step} ({ckpt_seconds[-1]:.1f} s)")
        return ckpt_seconds[-1]

    best_monitor = {"value": float("inf")}
    # val images at the image-log cadence, not at every validation pass
    last_val_img = {"step": -10 ** 9}

    def validate(step):
        """val/loss and val/loss_ema over the val split (``--val_batches``
        of it); a ``best`` checkpoint on val/loss_ema; the first val
        batch's images at the image-log cadence."""
        losses, losses_ema = [], []
        for i, vbatch in enumerate(data.val_dataloader()):
            if 0 < args.val_batches <= i:
                break
            arrays = batch_to_arrays(model, vbatch)
            gen = torch.Generator(device=device).manual_seed(1234 + i)
            state = gen.get_state()
            losses.append(float(tr.eval_step(arrays, gen)))
            gen.set_state(state)
            losses_ema.append(float(tr.eval_step(arrays, gen, ema=True)))
            if (i == 0 and img_logger.every_steps > 0
                    and step - last_val_img["step"]
                    >= img_logger.every_steps):
                last_val_img["step"] = step
                log_images(vbatch, step, "val")
        if not losses:
            return
        val_loss = sum(losses) / len(losses)
        val_loss_ema = sum(losses_ema) / len(losses_ema)
        if world.main:
            logger.log(step, {"val/loss": val_loss,
                              "val/loss_ema": val_loss_ema})
            print(f"step {step} val/loss {val_loss:.4f} "
                  f"val/loss_ema {val_loss_ema:.4f}")
        if val_loss_ema < best_monitor["value"]:
            best_monitor["value"] = val_loss_ema
            state = full_state()
            if world.main:
                ckpt_io.save_train_state(ckptdir, step, state, tag="best")
                print(f"New best val/loss_ema {val_loss_ema:.4f}; "
                      "saved 'best' checkpoint")

    if not args.train:
        if world.main:
            print("Train flag not set (-t True); exiting after setup.")
        return None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step = start_step
    train_loader = data.train_dataloader()
    if cursor["epoch"] or cursor["batch"]:
        train_loader.set_cursor(cursor["epoch"], cursor["batch"])
    gen = torch.Generator(device=device)
    sync()
    setup_seconds = time.perf_counter() - t_start
    launches_before = launch_counts()
    step_seconds, waits = [], []
    fsdp_peaks = {"peak_full_param_bytes": 0, "peak_full_grad_bytes": 0}
    # the log window; checkpoint writes and validation are not step time
    window = {"t": time.perf_counter(), "wait": 0.0, "skip": 0.0}
    try:
        while True:
            if args.max_epochs > 0 and cursor["epoch"] >= args.max_epochs:
                break
            it = iter(train_loader)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                wait = time.perf_counter() - t0
                window["wait"] += wait
                arrays = batch_to_arrays(model, batch)
                gen.manual_seed(step_seed(args.seed, step))
                logs = tr.train_step(arrays, gen)
                counters = tr.fsdp_counters()
                for k in fsdp_peaks:
                    fsdp_peaks[k] = max(fsdp_peaks[k], counters.get(k, 0))
                step += 1
                cursor["batch"] += 1
                if step % args.log_every_steps == 0:
                    logs = {k: float(v) for k, v in logs.items()}
                    dt = time.perf_counter() - window["t"] - window["skip"]
                    ips = args.log_every_steps * batch_size / dt
                    step_seconds.append(dt / args.log_every_steps)
                    waits.append(window["wait"] / dt)
                    if world.main:
                        logger.log(step, {**logs, "img_per_s": ips,
                                          "data_wait_share": waits[-1]})
                        print(f"step {step} loss {logs['loss']:.4f} "
                              f"({ips:.1f} img/s, {waits[-1]:.3f} of the "
                              f"time waiting on the loader)", flush=True)
                    window.update(t=time.perf_counter(), wait=0.0, skip=0.0)
                t0 = time.perf_counter()
                if args.val_every_steps and step % args.val_every_steps == 0:
                    validate(step)
                if img_logger.should_log(step):
                    log_images(batch, step, "train")
                if args.ckpt_every_steps and step % args.ckpt_every_steps == 0:
                    save(step)
                if stop_requested["save"]:
                    save(step)
                    stop_requested["save"] = False
                window["skip"] += time.perf_counter() - t0
                if args.max_steps > 0 and step >= args.max_steps:
                    raise StopIteration
            cursor["epoch"] += 1
            cursor["batch"] = 0
            window["skip"] += save(step)
    except (StopIteration, KeyboardInterrupt):
        save(step)
    launches = {k: v - launches_before[k] for k, v in launch_counts().items()}
    summary = {"steps": step - start_step, "setup_seconds": setup_seconds,
               "step_seconds": step_seconds, "data_wait_share": waits,
               "global_batch": batch_size, "world_size": world.world_size,
               "device": str(device), "launches": launches,
               "checkpoint_seconds": ckpt_seconds,
               "image_log_seconds": image_log_seconds, "fsdp": args.fsdp,
               "state_gib_per_rank": tr.state_bytes() / 2 ** 30,
               "peak_full_param_gib": fsdp_peaks["peak_full_param_bytes"]
               / 2 ** 30,
               "peak_full_grad_gib": fsdp_peaks["peak_full_grad_bytes"]
               / 2 ** 30}
    if device.type == "cuda":
        sync()
        summary["peak_gib_above_model"] = (
            torch.cuda.max_memory_allocated(device) - model_bytes) / 2 ** 30
        summary["card"] = torch.cuda.get_device_name(device)
    if world.main:
        print("train summary: " + json.dumps(summary), flush=True)

    if not args.no_test:
        # the post-fit test pass, under the EMA weights
        print("testing time")
        with tr.weights(ema=True):
            summary["test"] = run_test(args, model, data, logdir, world,
                                       device)
    return summary


@torch.no_grad()
def run_test(args, model, data, logdir, world, device) -> Dict[str, Any]:
    """DDIM (``--test_steps``, bf16 UNet) over this rank's rows of the
    test split; PNGs of the samples and the inputs by ``file_name``. Every
    rank runs as many batches (the loader cuts a last batch that does not
    split over the ranks), so FSDP's units gather alike on every rank."""
    out_dir = os.path.join(logdir, "test")
    for sub in ("sample", "inputs"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    seed = args.seed
    if args.uncond_gen_mode:
        # parallel unconditional test passes draw distinct samples
        seed = dist.rank_seed(args.seed, world.rank)
        print("reset seed for unconditional generation.")
        print(f"Set seed to {seed}.")
    gen = torch.Generator(device=device).manual_seed(seed)
    model.eval()
    n_saved, seconds = 0, 0.0
    for i, batch in enumerate(data.test_dataloader()):
        if args.test_batches > 0 and i >= args.test_batches:
            break
        tokens = batch_to_arrays(model, batch).get("tokens")
        t0 = time.perf_counter()
        ctx = (model.get_learned_conditioning(tokens)
               if tokens is not None else None)
        b = len(batch[next(iter(batch))])
        z = model.sample(b, context=ctx, steps=args.test_steps,
                         sampler="ddim", compute_dtype=torch.bfloat16,
                         generator=gen)
        imgs = model.decode_first_stage(z).float().cpu().numpy()
        dt = time.perf_counter() - t0
        seconds += dt
        print(f"Throughput for this batch: {imgs.shape[0] / dt:.4f}")
        names = batch.get("file_name")
        for j, img in enumerate(imgs):
            name = names[j] if names is not None else f"{n_saved:06}.png"
            name = os.path.splitext(os.path.basename(str(name)))[0] + ".png"
            save_image(img, os.path.join(out_dir, "sample", name))
            if "image" in batch:
                save_image(batch["image"][j].float().cpu().numpy(),
                           os.path.join(out_dir, "inputs", name))
            n_saved += 1
    print(f"test pass: {n_saved} samples in {out_dir}")
    return {"samples": n_saved, "seconds": seconds, "out_dir": out_dir}


if __name__ == "__main__":
    main()
