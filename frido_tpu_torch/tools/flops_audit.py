"""FLOPs a sampled image of the t2i chain (port of ``scripts/flops_audit.py``).

    python -m frido_tpu_torch.tools.flops_audit [--steps 200] [--batch 1]
        [--tiny] [--device cpu]

Counts every unit of the sampling chain with
``torch.utils.flop_counter.FlopCounterMode`` and composes the FLOPs a
sampled image takes at PLMS ``--steps`` steps, CFG 1.5 run sequentially,
two pyramid stages, as the JAX script composes XLA's cost analysis
(``scripts/flops_audit.py:84-127``):

- one UNet call a stage; stage 1 with its SPADE tables given
  (``spade_pre``), as ``FridoDiffusion.sample`` runs it;
- the SPADE tables, once a stage (not a step);
- the sequential CFG pair: the unconditional and the conditional call and
  their combine. The port runs the two calls eagerly, so nothing is
  shared between them and ``stage{s}_cfg_pair_vs_2x_single`` is 1.0; the
  JAX script's pair is below 2 because XLA removes the work common to
  both calls of one program;
- PLMS makes ``steps + 1`` model calls a stage: step 0 takes an extra
  call (``diffusion/samplers.py:194``);
- one MS-VQGAN decode and two conditioning encodes (tokens and the
  unconditional tokens).

What is counted (the report's ``counted`` field): products, 2 FLOPs a
multiply-add, of the matmuls, convolutions and attentions
``FlopCounterMode`` knows; elementwise work, norms and softmax are not
counted, while XLA's cost analysis counts them too. A transposed conv
counts its input pixels times its taps, as ``FlopCounterMode`` counts it.
The counter sees PyTorch operators only, not the hand-written kernels,
which it cannot look into: the audit runs every unit with
``FRIDO_PALLAS=0``, so each kernel site takes its plain version, which
computes the same function with the same products. Every unit runs on
the ``meta`` device (shapes only, no weights in memory); a unit that needs
data to run there (none of the t2i chain's so far) is counted on
``--device`` at batch 1 with seeded weights instead, and the report's
``devices`` says where each unit ran. The tool needs the card unless
given ``--device cpu``, like every entry point of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
from typing import Any, Callable, Dict, Optional

import torch

from frido_tpu_torch.device import resolve_device
from frido_tpu_torch.tools import flagship

GUIDANCE = 1.5
COUNTED = ("products only: 2 FLOPs a multiply-add of the matmuls, "
           "convolutions and attentions (torch.utils.flop_counter); "
           "elementwise work, norms and softmax not counted")


@contextlib.contextmanager
def plain_versions():
    """``FRIDO_PALLAS=0`` for the block: every kernel site takes its plain
    PyTorch version, which the counter can see."""
    old = os.environ.get("FRIDO_PALLAS")
    os.environ["FRIDO_PALLAS"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FRIDO_PALLAS"]
        else:
            os.environ["FRIDO_PALLAS"] = old


def count_flops(fn: Callable[[], Any]) -> int:
    """Product FLOPs of ``fn()`` under ``FlopCounterMode``, no gradient,
    every kernel site on its plain version."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with plain_versions(), torch.no_grad(), counter:
        fn()
    return int(counter.get_total_flops())


def unit_calls(model, batch: int) -> Dict[str, Callable[[], Any]]:
    """The chain's units on ``model``'s device, with the JAX script's
    inputs (zero latent, timesteps and tokens; contexts of zeros and
    ones): ``stage{s}`` (one UNet call; stage s > 0 given its SPADE
    tables, made here, outside the unit), ``stage{s}_pair`` (the
    sequential CFG pair and its combine), ``stage{s}_tables`` (s > 0 with
    SPADE), ``decode`` and ``cond``."""
    dev = model.device
    lat = model.image_size
    ctx_len = model.cond_stage_model.max_seq_len
    dim = model.model.diffusion_model.context_dim
    z = torch.zeros((batch, lat, lat, model.channels), device=dev)
    t = torch.zeros((batch,), dtype=torch.long, device=dev)
    ctx = torch.zeros((batch, ctx_len, dim), device=dev)
    uctx = torch.ones((batch, ctx_len, dim), device=dev)
    tokens = torch.zeros((batch, ctx_len), dtype=torch.long, device=dev)
    splits = list(model.embed_dim_list)
    units: Dict[str, Callable[[], Any]] = {}
    for s in range(model.num_stage):
        aux = None
        if model.use_spade and s > 0:
            def tables(_s=s):
                return model.spade_tables(z[..., :sum(splits[:_s])], _s)

            units[f"stage{s}_tables"] = tables
            with plain_versions(), torch.no_grad():
                aux = tables()

        def call(c, _s=s, _aux=aux):
            return model.apply_model(z, t, c, _s, spade_pre=_aux)

        def pair(_call=call):
            e_u = _call(uctx)
            e_c = _call(ctx)
            return e_u + GUIDANCE * (e_c - e_u)

        units[f"stage{s}"] = functools.partial(call, ctx)
        units[f"stage{s}_pair"] = pair
    units["decode"] = lambda: model.decode_first_stage(z)
    units["cond"] = lambda: model.get_learned_conditioning(tokens)
    return units


def unit_flops(model, batch: int = 1, fallback=None) -> Dict[str, Any]:
    """Product FLOPs a sample of each unit of :func:`unit_calls` at
    ``batch``, and the device each was counted on: ``model``'s, or for a
    unit that raises there (data-dependent work on ``meta``) ``fallback``
    (a model of the same config on a device with data), at batch 1."""
    flops, devices = {}, {}
    for name, fn in unit_calls(model, batch).items():
        try:
            flops[name] = count_flops(fn) / batch
            devices[name] = str(model.device)
        except (NotImplementedError, RuntimeError):
            if fallback is None:
                raise
            flops[name] = count_flops(unit_calls(fallback(), 1)[name])
            devices[name] = str(fallback().device)
    return {"flops": flops, "devices": devices}


def compose(flops: Dict[str, float], num_stage: int,
            steps: int) -> Dict[str, Any]:
    """The JAX script's report (``scripts/flops_audit.py:84-127``) from
    the FLOPs a sample of each unit."""
    report: Dict[str, Any] = {"steps": steps, "stages": num_stage}
    total = 0.0
    for s in range(num_stage):
        single, pair = flops[f"stage{s}"], flops[f"stage{s}_pair"]
        table_fl = flops.get(f"stage{s}_tables", 0)
        calls = steps + 1        # PLMS step 0 makes one extra model call
        report[f"stage{s}_tflop_per_call_per_image"] = single / 1e12
        report[f"stage{s}_tflop_per_cfg_pair_per_image"] = pair / 1e12
        report[f"stage{s}_cfg_pair_vs_2x_single"] = pair / (2 * single)
        report[f"stage{s}_spade_tables_tflop_per_image"] = table_fl / 1e12
        total += calls * pair + table_fl
    dec_fl, cond_fl = flops["decode"], flops["cond"]
    total += dec_fl + 2 * cond_fl
    report["decode_tflop_per_image"] = dec_fl / 1e12
    report["cond_tflop_per_encode_per_image"] = cond_fl / 1e12
    report["model_calls_per_image"] = num_stage * (steps + 1) * 2
    report["total_tflop_per_image"] = total / 1e12
    report["counted"] = COUNTED
    return report


def audit(tiny: bool = False, steps: int = 200, batch: int = 1,
          device=None) -> Dict[str, Any]:
    """The report of the tiny or the flagship model, every unit counted
    on ``meta`` at ``batch`` where it runs there, else on ``device`` (the
    card unless told otherwise) at batch 1 with seeded weights; the
    report's ``devices`` says where each was counted."""
    device = resolve_device(device)
    meta = flagship.build(tiny, "meta")

    @functools.lru_cache(maxsize=None)
    def with_data():
        return flagship.build(tiny, device)

    counted = unit_flops(meta, batch, fallback=with_data)
    report = compose(counted["flops"], meta.num_stage, steps)
    report["devices"] = counted["devices"]
    return report


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model instead of the flagship")
    ap.add_argument("--device", default=None,
                    help="device of a unit that cannot run on meta "
                         "(default: the card)")
    args = ap.parse_args(argv)
    report = audit(args.tiny, args.steps, args.batch, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
