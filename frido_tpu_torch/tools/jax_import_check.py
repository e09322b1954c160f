"""Check the committed JAX-trained fixture on a device: import it, hold the
imported state to its arrays, take the JAX run's third step and hold it to
the JAX numbers, then sample from the EMA.

    python -m frido_tpu_torch.tools.jax_import_check [--device cpu]

The fixture (``frido_tpu_torch/data/fixtures/jax_export_toy``) is an export
(``tools/export_jax_checkpoint.py``) of a toy t2i train state that the JAX
package trained two steps (``tools/make_jax_export_fixture.py``), with the
third step's batch, its draws of t and the noise, the JAX loss and logs of
that step and a seeded sample of every weight and EMA tensor after it
(``step3.npz``, ``step3.json``). ``chip_smoke.py`` runs these checks on the
card; ``tests/test_torch_jax_export.py`` on the CPU.

Tolerances (``tests/test_torch_training.py``'s): the imported tensors bit
for bit; the loss and logs 3e-4 absolute; each sampled weight within 2 lr of
the JAX one, each sampled EMA element within (1 - d) 2 lr + 1e-7 (d the
decay at the new count); the counts equal.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from frido_tpu_torch.config import instantiate_from_config, load_configs
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_export import read_export, to_port
from frido_tpu_torch.io.jax_weights import (denoiser_ema,
                                            jax_params_to_state_dict)
from frido_tpu_torch.tools.import_jax_run import import_run
from frido_tpu_torch.training import optim, trainer

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "fixtures", "jax_export_toy")
LOSS_ATOL = 3e-4
PLMS_STEPS = 4


def imported_trainer(run: str, device, step3: dict
                     ) -> trainer.DiffusionTrainer:
    """The run's model on ``device`` with an AdamW as the JAX run's
    (``step3.json``: lr, first-moment dtype, accumulation), its train
    state restored."""
    cfg = load_configs(sorted(
        os.path.join(run, "configs", c)
        for c in os.listdir(os.path.join(run, "configs"))))
    model = instantiate_from_config(cfg["model"], device=device)
    opt = optim.build_optimizer(
        [p for _, p in trainer.trainable_parameters(model)], step3["lr"],
        None, accumulate_grad_batches=step3["accumulate_grad_batches"],
        mu_dtype=torch.bfloat16 if step3["mu_dtype"] == "bfloat16" else None)
    tr = trainer.DiffusionTrainer(model, opt)
    ckpt_io.restore_train_state(os.path.join(run, "checkpoints"), tr)
    return tr


def exact_mismatches(tr: trainer.DiffusionTrainer, export) -> list:
    """Tensors of the trainer that are not bit for bit the export's arrays
    in the port's layout (bf16 moments through their fp32 values), and
    counts that differ."""
    want, got = to_port(export), ckpt_io.train_state(tr)
    bad = []
    groups = [("params", got["params"], want["params"]),
              ("ema", got["ema"], want["ema"]),
              ("mu", got["adam"]["mu"], want["adam"]["mu"]),
              ("nu", got["adam"]["nu"], want["adam"]["nu"])]
    if want["adam"]["acc"] is not None:
        groups.append(("acc", got["adam"]["acc"], want["adam"]["acc"]))
    for name, tensors, arrays in groups:
        if set(tensors) != set(arrays):
            bad.append((name, "keys"))
            continue
        bad += [(name, k) for k, v in tensors.items()
                if not np.array_equal(v.float().numpy(), arrays[k])]
    for k in ("step", "ema_updates"):
        if got[k] != want[k]:
            bad.append((k, got[k], want[k]))
    if got["adam"]["count"] != want["adam"]["count"]:
        bad.append(("count", got["adam"]["count"], want["adam"]["count"]))
    return bad


def digest_trees(arrays, export) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, np.ndarray]]:
    """The JAX step's sampled weights and EMA elements, in the port's
    layout: state dicts of NaN except at the sampled elements."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}/{k}") for k, v in node.items()}
        a = np.full(np.shape(node), np.nan, np.float32)
        a.reshape(-1)[arrays[f"{path}/index"]] = arrays[f"{path}/value"]
        return a

    return (jax_params_to_state_dict(build(export.tree["params"], "params")),
            jax_params_to_state_dict(build(denoiser_ema(export.tree),
                                           "ema")))


def third_step(tr: trainer.DiffusionTrainer, export, step3: dict,
               arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The JAX run's third step on its batch and draws (``step3.npz``'s
    ``arrays``); raises unless the loss, its logs, the sampled weights and
    EMA elements and the counts hold to the JAX numbers (``step3``).
    Returns the largest errors."""
    t, noise = arrays["draws/t"], arrays["draws/noise"]

    def fed(generator, batch, timesteps, noise_shape, dev):
        if tuple(noise_shape) != noise.shape:
            raise ValueError(f"noise {noise_shape} against {noise.shape}")
        return (torch.from_numpy(t.astype(np.int64)).to(dev),
                torch.from_numpy(noise).to(dev))

    real, trainer._draw = trainer._draw, fed
    try:
        logs = tr.train_step({"image": arrays["batch/image"],
                              "tokens": arrays["batch/tokens"]})
    finally:
        trainer._draw = real
    errs = {"loss": max(abs(float(logs[k]) - v)
                        for k, v in step3["logs"].items())}
    if not errs["loss"] <= LOSS_ATOL:
        raise AssertionError(f"third step's logs against JAX: "
                             f"{errs['loss']} > {LOSS_ATOL}")
    lr, n = step3["lr"], tr.ema.num_updates
    d = min(0.9999, (1 + n) / (10 + n))
    weights, ema = digest_trees(arrays, export)
    got = ckpt_io.train_state(tr)
    for name, want, have, tol in (
            ("weight", weights, got["params"], 2 * lr),
            ("ema", ema, got["ema"], (1 - d) * 2 * lr + 1e-7)):
        if set(want) != set(have):
            raise AssertionError(f"the digest's {name} keys are not the "
                                 f"port's")
        errs[name] = 0.0
        for k, w in want.items():
            m = ~np.isnan(w)
            err = float(np.abs(have[k].float().numpy()[m] - w[m]).max())
            errs[name] = max(errs[name], err)
            if not err <= tol:
                raise AssertionError(f"third step's {name} {k} against "
                                     f"JAX: {err} > {tol}")
    counts = (got["step"], got["ema_updates"], got["adam"]["count"])
    want_counts = (step3["step"], step3["ema_updates"], step3["count"])
    if counts != want_counts:
        raise AssertionError(f"counts {counts} against JAX {want_counts}")
    errs["tolerances"] = {"loss": LOSS_ATOL, "weight": 2 * lr,
                          "ema": (1 - d) * 2 * lr + 1e-7}
    return errs


@torch.no_grad()
def sample_from_ema(tr: trainer.DiffusionTrainer, tokens: np.ndarray,
                    image_shape: Tuple[int, ...], steps: int = PLMS_STEPS,
                    seed: int = 0) -> torch.Tensor:
    """PLMS from the EMA weights with classifier-free guidance 1.5 over
    ``tokens``, decoded; raises unless the images are finite and of
    ``image_shape``."""
    model = tr.model
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with tr.weights(ema=True):
        model.eval()
        ctx = model.get_learned_conditioning(tokens)
        uctx = model.get_learned_conditioning(np.zeros_like(tokens))
        z = model.sample(len(tokens), context=ctx, uncond_context=uctx, steps=steps,
                         eta=0.0, guidance_scale=1.5, sampler="plms",
                         cfg_mode="sequential", generator=gen)
        img = model.decode_first_stage(z)
        model.train()
    if tuple(img.shape) != tuple(image_shape) or not torch.isfinite(
            img).all():
        raise AssertionError(f"PLMS-{steps} from the EMA gave "
                             f"{tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")
    return img


def run(device, work: str) -> Dict[str, Any]:
    """Import the fixture under ``work``, the exact check, the third step
    and PLMS from the EMA; returns the errors and seconds."""
    t0 = time.perf_counter()
    export = read_export(FIXTURE)
    with open(os.path.join(FIXTURE, "step3.json")) as f:
        step3 = json.load(f)
    with np.load(os.path.join(FIXTURE, "step3.npz")) as f:
        arrays = dict(f)
    done = import_run(FIXTURE, work)
    tr = imported_trainer(work, device, step3)
    bad = exact_mismatches(tr, export)
    if bad:
        raise AssertionError(f"imported tensors not bit for bit the "
                             f"export's: {bad[:5]} ({len(bad)})")
    t1 = time.perf_counter()
    errs = third_step(tr, export, step3, arrays)
    t2 = time.perf_counter()
    sample_from_ema(tr, arrays["batch/tokens"], arrays["batch/image"].shape)
    sync(device)
    t3 = time.perf_counter()
    return {"step": done["step"], "meta": done["meta"], "errors": errs,
            "seconds": {"import": t1 - t0, "step": t2 - t1,
                        "plms": t3 - t2}}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as work:
        out = run(torch.device(args.device), os.path.join(work, "run"))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
