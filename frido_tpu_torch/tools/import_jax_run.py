"""Turn a JAX checkpoint export (``tools/export_jax_checkpoint.py``) into a
run directory of the port.

    python -m frido_tpu_torch.tools.import_jax_run EXPORT OUT

- A diffusion train state becomes ``OUT/checkpoints/step_N/state.pt``
  (``io/checkpoint.py``'s format) with ``last.json`` at the JAX step and
  the loader's ``epoch`` and ``batch_in_epoch`` from the export's
  ``meta.json``, ``scale_factors.json`` beside it and the run's configs in
  ``OUT/configs/``. ``python -m frido_tpu_torch.cli.main -r OUT`` (or
  ``--auto_resume`` over OUT's parent) then resumes at the JAX step on the
  uninterrupted run's batches, and ``python -m
  frido_tpu_torch.cli.sample_diffusion -r OUT`` samples from the EMA. An
  export of a ``best`` tag has no cursor: the resume starts its epoch at
  the first batch, and a line says so.
- An MS-VQGAN train state becomes the port's params files of the generator
  (``OUT/generator/params.pt``) and of the loss module with its
  discriminator (``OUT/discriminator/params.pt``), and the whole state as
  ``OUT/checkpoints/step_N/state.pt`` in ``VQGANTrainer.state``'s layout,
  what the port's MS-VQGAN CLI writes; its config goes to
  ``OUT/config.yaml``. The CLI has no resume, as the JAX script has none.
- A params-only export becomes ``OUT/params.pt``, which
  ``io/checkpoint.restore_params`` loads (``-r OUT`` of the sampling CLI,
  with ``-cfg``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Any, Dict

from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.io.jax_export import read_export, tensors, to_port

CURSOR = ("epoch", "batch_in_epoch")


def import_run(export_dir: str, out: str) -> Dict[str, Any]:
    """Write the export at ``export_dir`` as a port run under ``out``;
    returns ``{"kind", "step", "path", "meta"}``."""
    export = read_export(export_dir)
    state = tensors(to_port(export))
    os.makedirs(out, exist_ok=True)
    if export.kind == "params":
        ckpt_io.save_params(out, state)
        _copy_configs(export.configs, os.path.join(out, "configs"))
        return {"kind": export.kind, "step": None, "path": out, "meta": None}
    step = int(state["step"])
    meta = dict(export.meta or {})
    if meta.get("step", step) != step:
        raise ValueError(f"{export_dir}: meta.json's step {meta['step']} is "
                         f"not the state's {step}")
    cursor = {k: meta[k] for k in CURSOR if k in meta}
    ckpt_dir = os.path.join(out, "checkpoints")
    if export.kind == "vqgan_state":
        ckpt_io.save_params(os.path.join(out, "generator"), state["model"])
        ckpt_io.save_params(os.path.join(out, "discriminator"),
                            state["loss"])
        if export.configs:
            shutil.copy(export.configs[-1], os.path.join(out, "config.yaml"))
    else:
        if len(cursor) < len(CURSOR):
            print(f"{export_dir}: no loader cursor in its meta (a tagged "
                  f"checkpoint); a resume starts epoch "
                  f"{cursor.get('epoch', 0)} at its first batch")
        _copy_configs(export.configs, os.path.join(out, "configs"))
        if export.scale_factors:
            os.makedirs(ckpt_dir, exist_ok=True)
            shutil.copy(export.scale_factors,
                        os.path.join(ckpt_dir, "scale_factors.json"))
    path = ckpt_io.save_train_state(ckpt_dir, step, state, meta=cursor)
    return {"kind": export.kind, "step": step, "path": path, "meta": cursor}


def _copy_configs(files, cdir: str) -> None:
    if not files:
        return
    os.makedirs(cdir, exist_ok=True)
    for file in files:
        shutil.copy(file, os.path.join(cdir, os.path.basename(file)))


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(
        description="Write a JAX checkpoint export as a run of the port.")
    p.add_argument("export", help="the directory tools/"
                                  "export_jax_checkpoint.py wrote")
    p.add_argument("out", help="the run directory to write")
    args = p.parse_args(argv)
    done = import_run(args.export, args.out)
    print(json.dumps(done))
    return done


if __name__ == "__main__":
    main()
