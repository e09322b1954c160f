#!/usr/bin/env python
"""Write the JAX-trained checkpoint export that the port's
``chip_smoke.py`` imports on a machine without JAX.

    python tools/make_jax_export_fixture.py \\
        [--out frido_tpu_torch/data/fixtures/jax_export_toy]

It needs the JAX package and orbax (CPU is enough), and it is the only
place where the fixture is made. It builds a seeded toy t2i model
(:func:`model_config`: the t2i config's FridoDiffusion, MS-VQGAN first
stage, BERT conditioning and spatial-transformer PyUNet, cut to one
pyramid stage of 4 channels at a 32^2 latent, widths of 32, without
SPADE, so that its train state with AdamW and the EMA stays a few MB),
trains it two steps with ``frido_tpu.training.trainer.make_train_step``
(AdamW with a bfloat16 first moment, the masked first stage, the EMA),
saves it with ``frido_tpu.io.checkpoint.save_train_state`` under
``<tmp>/run/checkpoints`` with the loader's cursor, and exports that run
with ``tools/export_jax_checkpoint.py``. Beside the export it writes
``step3.npz`` and ``step3.json``: the third step's batch and draws of t
and the noise, and what the JAX step gives on them (the loss, its logs, a
seeded sample of every weight and EMA tensor, and the counts).

The first stage and the UNet attend over the 32^2 latent, 1024 tokens, so
a port run of this state reaches the flash kernel (and the VQ argmin in
the encode and decode).

The test ``tests/test_torch_jax_export.py`` reuses these helpers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

T2I = os.path.join(REPO, "configs", "frido", "t2i", "frido_f16f8_coco.yaml")
OUT = os.path.join(REPO, "frido_tpu_torch", "data", "fixtures",
                   "jax_export_toy")
CTX_LEN = 16
VOCAB = 100
BATCH = 2
LR = 1e-3
SEED = 0
DIGEST = 8          # sampled elements of each tensor in the digest
CURSOR = {"epoch": 0, "batch_in_epoch": 2}


def model_config() -> dict:
    """The fixture's model config (the ``model:`` section of a run's
    config)."""
    from frido_tpu.config import load_yaml

    cfg = copy.deepcopy(load_yaml(T2I)["model"])
    cfg["base_learning_rate"] = LR
    p = cfg["params"]
    p.update(image_size=32, channels=4, timesteps=40,
             adopted_scale_factor_value=[0.8], scale_by_std=False)
    unet = p["unet_config"]["params"]
    unet.pop("split_embed_dim_list")
    unet.update(use_split_head=False, use_SPADE_norm=False, image_size=32,
                in_channels=4, out_channels=4, model_channels=32,
                channel_mult=[1], num_res_blocks=1,
                attention_resolutions=[1], num_head_channels=8,
                context_dim=32, num_stage=1)
    first = p["first_stage_config"]["params"]
    first.pop("ckpt_path")
    first.update(embed_dim=[4], n_embed=[32])
    first["edconfig"].update(multiscale=1, z_channels=[4], resolution=32,
                             ch=32, ch_mult=[1], num_res_blocks=1,
                             attn_resolutions=[32])
    first["ddconfig"].update(z_channels=4, resolution=32, ch=32, ch_mult=[1],
                             num_res_blocks=1, attn_resolutions=[32])
    p["cond_stage_config"]["params"].update(
        n_embed=32, n_layer=1, vocab_size=VOCAB, max_seq_len=CTX_LEN,
        use_tokenizer=False)
    return cfg


def random_params(shapes, rng):
    """Seeded values for every leaf of a params tree of shapes: kernels at
    1/sqrt(fan_in) (the zero-initialised output convs too, so the UNet's
    output is not 0), norm scales around 1, small biases, embeddings from
    N(0, 0.02)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng)
            continue
        z = rng.standard_normal(v.shape)
        if k in ("kernel", "kernel_t"):
            z = z / np.sqrt(np.prod(v.shape[:-1]))
        elif k == "scale":
            z = 1.0 + 0.1 * z
        elif k == "embedding":
            z = 0.02 * z
        else:
            z = 0.1 * z
        out[k] = z.astype(np.float32)
    return out


def batch(i: int) -> dict:
    """Step ``i``'s batch (0-based): images in [-1, 1] and token ids."""
    rng = np.random.default_rng(100 + i)
    return {"image": np.tanh(rng.standard_normal((BATCH, 32, 32, 3))
                             ).astype(np.float32),
            "tokens": rng.integers(0, VOCAB, (BATCH, CTX_LEN)
                                   ).astype(np.int32)}


def build(cfg=None, accumulate_grad_batches=1, mu_bf16=True, seed=SEED,
          shapes=None):
    """(JAX model, its optimizer, the TrainState at step 0, the jitted
    train step); ``shapes``: the model's params shapes, if known."""
    import jax
    import jax.numpy as jnp

    from frido_tpu.config import instantiate_from_config
    from frido_tpu.training import optim, trainer

    jmodel = instantiate_from_config(cfg or model_config())
    if shapes is None:
        shapes = jax.eval_shape(
            lambda r: jmodel.init_params(r, context_len=CTX_LEN),
            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        jnp.asarray, random_params(shapes, np.random.default_rng(seed)))
    tx = optim.build_optimizer(
        LR, None, accumulate_grad_batches=accumulate_grad_batches,
        mu_dtype=jnp.bfloat16 if mu_bf16 else None)
    state, masked = trainer.create_train_state(jmodel, params, tx)
    step = jax.jit(trainer.make_train_step(jmodel, masked))
    return jmodel, masked, state, step


def draws(jmodel, step: int, rng):
    """t and the noise as ``make_train_step`` draws them at ``step``."""
    import jax

    t_key, n_key = jax.random.split(jax.random.fold_in(rng, step))
    t = jax.random.randint(t_key, (BATCH,), 0, jmodel.timesteps)
    noise = jax.random.normal(n_key, (BATCH, jmodel.image_size,
                                      jmodel.image_size, jmodel.channels))
    return np.asarray(t), np.asarray(noise)


def run_steps(state, step, n, rng, start=0):
    """``n`` JAX steps from batch ``start``; (state, logs of the last)."""
    import jax.numpy as jnp

    logs = None
    for i in range(start, start + n):
        state, logs = step(state, {k: jnp.asarray(v)
                                   for k, v in batch(i).items()}, rng)
    return state, {k: float(v) for k, v in logs.items()}


def save_run(run: str, state, cfg: dict, meta=None, tag: str = "") -> str:
    """``state`` saved as ``main.py`` saves it under ``run``, with the
    config as ``run/configs/*-project.yaml``; returns the checkpoint
    path."""
    import yaml

    from frido_tpu.io import checkpoint as ckpt_io

    os.makedirs(os.path.join(run, "configs"), exist_ok=True)
    with open(os.path.join(run, "configs", "fixture-project.yaml"),
              "w") as f:
        yaml.safe_dump({"model": cfg}, f)
    return ckpt_io.save_train_state(
        os.path.join(run, "checkpoints"), int(state.step), state,
        meta=CURSOR if meta is None else meta, tag=tag)


def digest(tree, rng, prefix: str, out: dict) -> None:
    """A seeded sample of ``DIGEST`` elements of each leaf of ``tree``
    (flat indices into the JAX layout, and their values)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            digest(v, rng, f"{prefix}/{k}", out)
            continue
        a = np.asarray(v)
        idx = rng.choice(a.size, min(DIGEST, a.size), replace=False)
        out[f"{prefix}/{k}/index"] = idx.astype(np.int64)
        out[f"{prefix}/{k}/value"] = a.reshape(-1)[idx]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from export_jax_checkpoint import export

    cfg = model_config()
    jmodel, _, state, step = build(cfg)
    rng = jax.random.PRNGKey(SEED)
    state, _ = run_steps(state, step, 2, rng)
    t, noise = draws(jmodel, int(state.step), rng)
    after, logs = run_steps(state, step, 1, rng, start=2)
    work = tempfile.mkdtemp()
    try:
        save_run(os.path.join(work, "run"), state, cfg)
        if os.path.exists(args.out):
            shutil.rmtree(args.out)
        export(os.path.join(work, "run"), args.out)
    finally:
        shutil.rmtree(work)
    arrays = {"batch/image": batch(2)["image"],
              "batch/tokens": batch(2)["tokens"], "draws/t": t,
              "draws/noise": noise}
    sample = np.random.default_rng(SEED)
    digest(jax.device_get(after.params), sample, "params", arrays)
    digest(jax.device_get(after.ema_params), sample, "ema", arrays)
    np.savez_compressed(os.path.join(args.out, "step3.npz"), **arrays)
    adam = after.opt_state.inner_states["train"].inner_state[0]
    with open(os.path.join(args.out, "step3.json"), "w") as f:
        json.dump({"loss": logs["loss"], "logs": logs, "lr": LR,
                   "mu_dtype": "bfloat16", "accumulate_grad_batches": 1,
                   "step": int(after.step), "count": int(adam.count),
                   "ema_updates": int(after.ema_updates)}, f, indent=1)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out)
               if os.path.isfile(os.path.join(args.out, f)))
    print(f"wrote {args.out}: {size / 2 ** 20:.2f} MiB, step-3 loss "
          f"{logs['loss']:.6f}")


if __name__ == "__main__":
    main()
