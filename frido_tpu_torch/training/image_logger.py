"""Periodic image logging during training (port of
``frido_tpu/training/image_logger.py``, the reference's Lightning
``ImageLogger``).

Every ``every_steps`` steps the training CLI runs ``model.log_images`` on
the current batch (under the EMA weights) and writes one PNG grid a key,
four images a row, as ``<logdir>/images/<split>/<key>_gs-<step:06>.png``;
:meth:`ImageLogger.log_test` writes per-sample files named by the
dataset's ``file_name`` (else ``<key>_<i:06>``) under
``<out_dir>/img/<key>/``, with an ``_r<shard>`` suffix for a shard of a
multi-process run. PNGs are written without PIL
(``utils/visualize.save_image``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from frido_tpu_torch.utils import visualize as vz


class ImageLogger:
    def __init__(self, logdir: str, every_steps: int = 1000,
                 max_images: int = 8, shard_idx: int = -1):
        self.save_dir = os.path.join(logdir, "images")
        self.every_steps = every_steps
        self.max_images = max_images
        self.shard_idx = shard_idx

    def should_log(self, step: int) -> bool:
        return self.every_steps > 0 and step % self.every_steps == 0

    def log_train(self, model, batch: Dict[str, Any], step: int,
                  split: str = "train", dataset=None,
                  generator: Optional[torch.Generator] = None,
                  sample: bool = False, write: bool = True
                  ) -> Dict[str, Any]:
        """``model.log_images`` of ``batch`` (its first ``max_images``) as
        one grid a key (written with ``write``; a rank of a sharded model
        computes the logs with the writer); returns the logs."""
        logs = model.log_images(batch, generator=generator,
                                n=self.max_images, sample_flag=sample,
                                dataset=dataset)
        if not write:
            return logs
        out = os.path.join(self.save_dir, split)
        os.makedirs(out, exist_ok=True)
        for key, val in logs.items():
            if key == "file_name" or not isinstance(val, np.ndarray):
                continue
            vz.save_image(vz.make_grid(val, nrow=4),
                          os.path.join(out, f"{key}_gs-{step:06}.png"))
        return logs

    def log_test(self, logs: Dict[str, Any], out_dir: str,
                 keys=("sample", "inputs", "conditioning")) -> None:
        """One PNG a sample of each of ``keys``, by ``file_name``."""
        suffix = f"_r{self.shard_idx}" if self.shard_idx >= 0 else ""
        names = logs.get("file_name")
        for key in keys:
            if key not in logs:
                continue
            d = os.path.join(out_dir, "img", key)
            os.makedirs(d, exist_ok=True)
            for i, arr in enumerate(logs[key]):
                if names is not None:
                    base = os.path.splitext(os.path.basename(
                        str(names[i])))[0]
                else:
                    base = f"{key}_{i:06}"
                vz.save_image(arr, os.path.join(d, base + suffix + ".png"))
