"""The one generator of every traffic mix: the parameters of a mix
(``traffic/<mix>.json``) and a seed in, the inputs of each batch out.

A batch's inputs depend on the seed and the batch's index alone, so the
same seed gives the same batches, and every seed gives the same sizes
(captions and layouts are padded to the same length): only the values
change from seed to seed.

Condition kinds (``cond.kind``):

- ``caption``: WordPiece ids of BERT's vocabulary: [CLS], ``min_ids`` to
  ``max_ids`` ids drawn from ``[first_id, vocab)``, [SEP], padded with
  ``pad`` to ``length``. The unconditional batch (``uncond``:
  ``empty_caption``) is [CLS] [SEP] and padding, what the tokenizer gives
  for the empty caption.
- ``layout``: ``min_objects`` to ``max_objects`` objects, each a class
  number below ``classes`` and a box of at least ``min_area`` inside the
  whole image, encoded as the port's ``objects_bbox`` builder encodes
  them (a copy of ``data/conditional_builder.py``'s arithmetic: class,
  top-left and bottom-right tokens on a sqrt(``no_tokens``) grid, padded
  to ``max_objects`` triples with ``no_tokens - 1``, then the crop's two
  tokens). The unconditional batch (``uncond``: ``zeros``) is all zeros,
  as the sampling CLI's dataset mode gives a layout model.

Images (training) are uniform in [-1, 1], made on the device by a
``torch.Generator`` seeded from the seed.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

# the streams a seed is split into
CONDITION, NOISE, IMAGES, STEP, SAMPLE, WEIGHTS = range(6)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream, index])


def torch_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for a ``torch.Generator`` of (seed, stream, index)."""
    return int(rng(seed, stream, index).integers(0, 1 << 62))


def captions(spec: Dict[str, Any], r: np.random.Generator, n: int
             ) -> np.ndarray:
    out = np.full((n, spec["length"]), spec["pad"], dtype=np.int32)
    for i in range(n):
        k = int(r.integers(spec["min_ids"], spec["max_ids"] + 1))
        ids = r.integers(spec["first_id"], spec["vocab"], size=k)
        row = [spec["cls"], *ids.tolist(), spec["sep"]]
        out[i, :len(row)] = row
    return out


def empty_captions(spec: Dict[str, Any], n: int) -> np.ndarray:
    out = np.full((n, spec["length"]), spec["pad"], dtype=np.int32)
    out[:, 0], out[:, 1] = spec["cls"], spec["sep"]
    return out


def _coord_token(x: float, y: float, sections: int) -> int:
    xd = int(round(x * (sections - 1)))
    yd = int(round(y * (sections - 1)))
    return yd * sections + xd


def layouts(spec: Dict[str, Any], r: np.random.Generator, n: int
            ) -> np.ndarray:
    sections = int(math.sqrt(spec["no_tokens"]))
    none = spec["no_tokens"] - 1
    max_obj = spec["max_objects"]
    rows = []
    for _ in range(n):
        k = int(r.integers(spec["min_objects"], max_obj + 1))
        flat = []
        for _ in range(k):
            area = float(r.uniform(spec["min_area"], 1.0))
            w = float(r.uniform(area, 1.0))
            h = area / w
            x0 = float(r.uniform(0.0, 1.0 - w))
            y0 = float(r.uniform(0.0, 1.0 - h))
            cls = int(r.integers(0, spec["classes"]))
            flat += [cls, _coord_token(x0, y0, sections),
                     _coord_token(x0 + w, y0 + h, sections)]
        flat += [none] * (3 * (max_obj - k))
        # the whole image as the crop: (0, 0) and (1, 1)
        flat += [_coord_token(0.0, 0.0, sections),
                 _coord_token(1.0, 1.0, sections)]
        rows.append(flat)
    return np.asarray(rows, dtype=np.int64)


def conditions(traffic: Dict[str, Any], seed: int, index: int):
    """(tokens, unconditional tokens) of batch ``index``."""
    spec, n = traffic["cond"], traffic["batch"]
    r = rng(seed, CONDITION, index)
    if spec["kind"] == "caption":
        tokens = captions(spec, r, n)
    elif spec["kind"] == "layout":
        tokens = layouts(spec, r, n)
    else:
        raise ValueError(f"unknown condition kind {spec['kind']!r}")
    uncond = traffic.get("uncond")
    if uncond == "empty_caption":
        utokens = empty_captions(spec, n)
    elif uncond == "zeros":
        utokens = np.zeros_like(tokens)
    elif uncond is None:
        utokens = None
    else:
        raise ValueError(f"unknown unconditional batch {uncond!r}")
    return tokens, utokens


def images(traffic: Dict[str, Any], seed: int, n: int, device):
    """``n`` NHWC images uniform in [-1, 1], made on ``device``."""
    import torch

    size = traffic["image_size"]
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, IMAGES))
    x = torch.rand((n, size, size, 3), generator=g, device=device)
    return x.mul_(2.0).sub_(1.0)
