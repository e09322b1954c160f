"""Sampling CLI: captions and a checkpoint in, PNGs out (port of
``scripts/sample_diffusion.py``).

    python -m frido_tpu_torch.cli.sample_diffusion -cfg CONFIG.yaml \\
        -r model.ckpt --prompt "a red bus" -plms -c 200 -G -gs 1.5 -bs 4

The flags are the JAX script's; unknown ``a.b.c=value`` arguments override
the config (dot-list). ``-r`` takes a Lightning ``.ckpt`` (its EMA swapped
in unless ``--no_ema``), a checkpoint directory of this port
(``io/checkpoint.py``: a train state's ``step_N`` or tag, whose EMA is
swapped in likewise, or a params-only directory), a run's
``checkpoints/`` directory or a run directory (both through the ``last``
pointer). A ``.ckpt`` turns strict vocab mode on
(``FRIDO_TPU_STRICT_VOCAB=1`` unless set): its embedding rows need the
vocab files it was trained with, not the fallback's ids.

With ``--prompt`` the batch is ``-bs`` copies of the caption (``-n`` and
``-ngpu``, which pick and split a dataset's samples, are refused), the
unconditional batch ``tokenize([""])``; the images go to
``<out>/sample/sample_NNNNNN.png`` (``--get_codebook`` adds
``codes_000000.npz``), where ``<out>`` is ``-o`` (else the run's
``samples/``, else ``outputs/samples``) joined with ``-name``.

Without ``--prompt`` the CLI samples the config's test split
(``data/``), as the JAX script does: batches of the config's
``data.params.batch_size`` (``-bs`` does not apply; a dot-list override
does), shard ``-igpu`` of ``-ngpu`` deterministic shards
(``split_indices_deterministic``), the generator seeded with ``seed +
shard``; each batch's tokens from its ``cond_stage_key``, the
unconditional ones from ``dummy_tokens_like``; PNGs under ``sample/`` and
the inputs under ``inputs/`` by ``file_name`` (``--get_codebook``:
``codes_NNNNNN.npz`` a batch); batches until ``-n`` samples are reached
(-1: the whole shard), and the samples, at most ``-n``, in one
``"{N}x{H}x{W}x3-samples.npz"``. The decodes and the pixel work run on
the same device as the model.

The model runs on the card unless ``--device cpu``; ``--bf16`` (on by
default, as in the JAX script) runs the UNet in bf16.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from frido_tpu_torch.config import instantiate_from_config, load_configs
from frido_tpu_torch.device import resolve_device
from frido_tpu_torch.utils.visualize import to_uint8, write_png


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-r", "--resume", type=str, default=None,
                   help="checkpoint (.ckpt torch file, a checkpoint dir of "
                        "this port, a run's checkpoints/ dir, or a run "
                        "logdir; the latter two resolve the 'last' pointer)")
    p.add_argument("-cfg", "--cfg_path", type=str, required=True)
    p.add_argument("-name", "--exp_name", type=str, default="v0")
    p.add_argument("-o", "--output_path", type=str, default="",
                   help="output base ('' = <run logdir>/samples)")
    p.add_argument("-l", "--logdir", type=str, default="none",
                   help="extra logdir: relocate the run's sample output "
                        "under this base")
    p.add_argument("-n", "--n_samples", type=int, default=-1)
    p.add_argument("-plms", "--plms", action="store_true")
    p.add_argument("-dpmpp", "--dpmpp", action="store_true",
                   help="DPM-Solver++(2M)")
    p.add_argument("-e", "--eta", type=float, default=1.0)
    p.add_argument("-v", "--vanilla_sample", action="store_true",
                   help="full-T ancestral sampling")
    p.add_argument("-c", "--custom_steps", type=int, default=200)
    p.add_argument("-bs", "--batch_size", type=int, default=10)
    p.add_argument("-G", "--use_guidance", action="store_true")
    p.add_argument("-gs", "--guidance_scale", type=float, default=1.0)
    p.add_argument("-ngpu", "--num_shards", type=int, default=1,
                   help="split the test set into N deterministic groups")
    p.add_argument("-igpu", "--shard_idx", type=int, default=0)
    p.add_argument("--prompt", type=str, default=None,
                   help="sample from a raw text prompt (no dataset)")
    p.add_argument("--no_ema", action="store_true",
                   help="sample with the raw weights instead of the EMA")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--profile", type=str, default="",
                   help="torch.profiler trace dir (Chrome trace)")
    p.add_argument("--get_codebook", action="store_true",
                   help="also dump per-scale codebook indices "
                        "(codes_*.npz)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def save_batch(imgs: np.ndarray, out_dir: str, names=None, n_saved: int = 0,
               key: str = "sample") -> int:
    """[-1, 1] images to ``<out_dir>/<key>/``: ``<name>.png`` per name,
    else ``<key>_NNNNNN.png`` counting from ``n_saved``; returns the new
    count."""
    d = os.path.join(out_dir, key)
    os.makedirs(d, exist_ok=True)
    for i, arr in enumerate(to_uint8(imgs)):
        if names is not None:
            fname = os.path.splitext(os.path.basename(str(names[i])))[0] \
                + ".png"
        else:
            fname = f"{key}_{n_saved:06}.png"
        write_png(arr, os.path.join(d, fname))
        n_saved += 1
    return n_saved


def resolve_resume(resume: Optional[str]):
    """The ``-r`` forms -> (checkpoint, run logdir): a ``.ckpt`` file or a
    checkpoint directory as given; a ``<run>/checkpoints`` directory or a
    run directory through its ``last`` pointer (rebuilt from the pointer's
    basename, as it may have been written elsewhere)."""
    if not resume:
        return None, None
    r = resume.rstrip("/")
    if os.path.isdir(os.path.join(r, "checkpoints")):
        cdir, run = os.path.join(r, "checkpoints"), r
    elif os.path.isdir(r) and os.path.exists(os.path.join(r, "last.json")):
        cdir, run = r, os.path.dirname(r)
    else:  # a file or a checkpoint leaf directory
        d = os.path.dirname(os.path.abspath(r))
        run = os.path.dirname(d) if os.path.basename(d) == "checkpoints" else d
        return r, run
    with open(os.path.join(cdir, "last.json")) as f:
        meta = json.load(f)
    leaf = os.path.join(cdir, os.path.basename(meta["path"].rstrip("/")))
    return (leaf if os.path.exists(leaf) else meta["path"]), run


@torch.no_grad()
def _swap_in(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """Copy ``tensors`` (every parameter of ``module``) into it."""
    params = dict(module.named_parameters())
    if set(tensors) != set(params):
        raise KeyError("the EMA does not cover the denoiser's parameters")
    for name, p in params.items():
        p.copy_(tensors[name])


def build_model(cfg: Dict[str, Any], ckpt: Optional[str], use_ema: bool = True,
                device=None):
    """The config's FridoDiffusion on ``device`` with ``ckpt``'s weights
    (the EMA of the denoiser swapped in when ``use_ema`` and the
    checkpoint has one)."""
    from frido_tpu_torch.io import checkpoint as ckpt_io
    from frido_tpu_torch.models.frido import FridoDiffusion
    from frido_tpu_torch.training.ema import import_ema

    if ckpt and os.path.isfile(ckpt):
        # an imported .ckpt was trained with real vocabularies: the
        # fallback's ids would sample garbage against its embedding rows,
        # so the tokenizer must fail instead; the port's own checkpoint
        # dirs keep the fallback, trained with the same ids
        os.environ.setdefault("FRIDO_TPU_STRICT_VOCAB", "1")
    mp = dict(cfg["model"]["params"])
    model = FridoDiffusion(device=device, **mp)
    if not ckpt:
        return model
    if os.path.isfile(os.path.join(ckpt, ckpt_io.PARAMS_FILE)):
        return ckpt_io.restore_params(ckpt, model)
    if os.path.isdir(ckpt):                      # a train state
        raw = ckpt_io.restore_raw(ckpt)
        model.load_state_dict(raw["params"], strict=True)
        if use_ema and raw["ema"]:
            _swap_in(model.model, raw["ema"])
        print(f"Restored {'EMA ' if use_ema else ''}params from train "
              f"state {ckpt}")
        return model
    print(f"Loading torch checkpoint {ckpt}")
    report = model.load_torch_checkpoint(ckpt)
    sd = report["state_dict"]
    if use_ema and any(k.startswith("model_ema.") for k in sd):
        print("Swapping in EMA weights for sampling")
        _swap_in(model.model, import_ema(model.model, sd))
    return model


def make_pipeline(model, args):
    """tokens, unconditional tokens, generator -> images (and with
    ``--get_codebook`` the per-scale codes): the conditioning, the
    sampler the flags pick (PLMS and DPM-Solver++ at eta 0), guidance
    under ``-G``, the UNet in bf16 under ``--bf16``, the decode."""
    sampler = ("vanilla" if args.vanilla_sample
               else "dpmpp" if getattr(args, "dpmpp", False)
               else "plms" if args.plms else "ddim")
    eta = 0.0 if sampler in ("plms", "dpmpp") else args.eta
    gs = args.guidance_scale if args.use_guidance else 1.0
    dtype = torch.bfloat16 if args.bf16 else None
    get_codes = getattr(args, "get_codebook", False)

    @torch.no_grad()
    def pipeline(tokens, utokens, generator):
        ctx = model.get_learned_conditioning(tokens)
        uctx = (model.get_learned_conditioning(utokens)
                if gs != 1.0 else None)
        z = model.sample(tokens.shape[0], context=ctx, uncond_context=uctx,
                         steps=args.custom_steps, eta=eta, guidance_scale=gs,
                         sampler=sampler, compute_dtype=dtype,
                         generator=generator)
        if get_codes:
            return model.decode_first_stage_with_codes(z)
        return model.decode_first_stage(z)

    return pipeline


def dummy_tokens_like(model, tokens, cond_stage_key):
    """The unconditional batch of the dataset path: empty captions for a
    tokenizing cond stage, zeros otherwise (the CLIP wrappers, which have
    no ``use_tokenizer``, included)."""
    if getattr(model.cond_stage_model, "use_tokenizer", False):
        return model.tokenize([""] * tokens.shape[0])
    return np.zeros_like(tokens)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> Dict[str, Any]:
    """Everything after argument parsing; returns ``out_dir``, ``model``,
    ``load_seconds``, ``sample_seconds`` and, with ``--prompt``,
    ``images`` (float [B, H, W, 3] in [-1, 1]) and ``codes`` (with
    ``--get_codebook``), else what :func:`sample_dataset` returns."""
    if args.prompt is not None and (args.n_samples != -1
                                    or args.num_shards != 1):
        raise ValueError("-n and -ngpu pick and split a dataset's samples; "
                         "with --prompt the batch is -bs copies of it")
    cfg = load_configs([args.cfg_path],
                       dotlist=getattr(args, "config_overrides", None))
    device = resolve_device(args.device)
    ckpt, run_logdir = resolve_resume(args.resume)
    t0 = time.perf_counter()
    model = build_model(cfg, ckpt, use_ema=not args.no_ema, device=device)
    _sync(device)
    load_seconds = time.perf_counter() - t0
    pipeline = make_pipeline(model, args)
    gen = torch.Generator(device=device).manual_seed(
        args.seed + args.shard_idx)

    if args.logdir != "none" and run_logdir:
        # keep the run's leaf name, relocated under the extra logdir base
        local = os.path.basename(run_logdir.rstrip(os.sep)) or run_logdir
        print(f"Switching logdir from '{run_logdir}' to "
              f"'{os.path.join(args.logdir, local)}'")
        run_logdir = os.path.join(args.logdir, local)
    out_base = args.output_path or os.path.join(run_logdir or "outputs",
                                                "samples")
    out_dir = os.path.join(out_base, args.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    common = dict(out_dir=out_dir, model=model, load_seconds=load_seconds)
    if args.prompt is None:
        return dict(common, **sample_dataset(args, cfg, model, pipeline, gen,
                                             out_dir, device))
    tokens = model.tokenize([args.prompt] * args.batch_size)
    utokens = model.tokenize([""] * args.batch_size)
    t0 = time.perf_counter()
    out = pipeline(tokens, utokens, gen)
    codes = None
    if args.get_codebook:
        out, codes = out
        np.savez(os.path.join(out_dir, f"codes_{0:06}.npz"),
                 **{f"scale_{i}": c.cpu().numpy()
                    for i, c in enumerate(codes)})
    imgs = out.float().cpu().numpy()
    sample_seconds = time.perf_counter() - t0
    save_batch(imgs, out_dir)
    print(f"Throughput for this batch: "
          f"{args.batch_size / sample_seconds:.4f}")
    return dict(common, images=imgs, codes=codes,
                sample_seconds=sample_seconds)


def sample_dataset(args, cfg, model, pipeline, gen, out_dir, device):
    """The dataset mode: this shard of the test split, batch by batch;
    returns ``images`` (uint8, the npz's), ``file_names``,
    ``sample_seconds`` (sampling and decode, summed) and ``batches``."""
    data_cfg = dict(cfg["data"])
    data_cfg["params"] = dict(data_cfg.get("params", {}))
    if args.num_shards > 1:
        data_cfg["params"]["n_split_dataset"] = args.num_shards
        data_cfg["params"]["idx_split_dataset"] = args.shard_idx
    data = instantiate_from_config(data_cfg, device=device).setup()
    cond_key = model.cond_stage_key
    n_saved = len(glob.glob(os.path.join(out_dir, "sample", "*.png")))
    samples, names, seconds, batches = [], [], 0.0, 0
    for batch_idx, batch in enumerate(data.test_dataloader()):
        cond = batch[cond_key] if cond_key in batch else batch
        tokens = np.asarray(model.tokenize(cond))
        utokens = dummy_tokens_like(model, tokens, cond_key)
        t0 = time.perf_counter()
        out = pipeline(tokens, utokens, gen)
        if args.get_codebook:
            out, codes = out
            np.savez(os.path.join(out_dir, f"codes_{batch_idx:06}.npz"),
                     **{f"scale_{i}": c.cpu().numpy()
                        for i, c in enumerate(codes)})
        imgs = out.float().cpu().numpy()
        dt = time.perf_counter() - t0
        seconds += dt
        batches += 1
        print(f"Throughput for this batch: {imgs.shape[0] / dt:.4f}")
        file_names = batch.get("file_name")
        n_saved = save_batch(imgs, out_dir, file_names, n_saved)
        if "image" in batch:
            save_batch(batch["image"].float().cpu().numpy(), out_dir,
                       file_names, 0, key="inputs")
        samples.append(to_uint8(imgs))
        names += list(file_names or [])
        if 0 < args.n_samples <= sum(len(x) for x in samples):
            break
    if not samples:
        print("no batches sampled")
        return dict(images=None, file_names=[], sample_seconds=0.0,
                    batches=0)
    allv = np.concatenate(samples)
    if args.n_samples > 0:
        allv, names = allv[:args.n_samples], names[:args.n_samples]
    shape_str = "x".join(map(str, allv.shape))
    np.savez(os.path.join(out_dir, f"{shape_str}-samples.npz"), allv)
    print(f"sampling of {n_saved} images finished -> {out_dir}")
    return dict(images=allv, file_names=names, sample_seconds=seconds,
                batches=batches)


def main(argv=None) -> Dict[str, Any]:
    # unknown arguments are dot-list config overrides (a.b.c=value)
    args, unknown = get_parser().parse_known_args(argv)
    args.config_overrides = unknown
    from frido_tpu_torch.utils.profiling import trace

    with trace(args.profile):
        return run(args)


if __name__ == "__main__":
    main()
