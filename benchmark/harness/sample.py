"""A sampling cell: back-to-back batches through the sampling CLI's own
per-batch pipeline (``cli/sample_diffusion.make_pipeline`` on
``build_model(cfg, None)`` with the seeded weights loaded), then the
comparison of one batch, drawn from the seed, with the reference.

The traffic mix gives the batch, the sampler (``plms`` or ``dpmpp``), the
steps, the guidance scale and the conditions (``harness/traffic.py``).
The UNet runs in bfloat16 (the CLI's ``--bf16`` default), the
conditioning and the decode in float32, as the CLI runs them.

Spans: ``cond`` (each conditioning call), ``sample`` (the chain),
``decode`` (the first stage's decode), around the model's own methods,
wrapped on the instance; the pipeline calls them as it always does."""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Tuple

import torch

from harness import common, compare, traffic as tr, weights
from harness import trace as tracing
from harness.registry import Cell
from reference import frido as ref_frido, precision

NUMBERS = ("cond_rel", "latent_rel", "image_rel")
# the inputs of the warm-up batch: an index no window reaches
WARM_INDEX = 1 << 40


def cli_args(traffic: Dict[str, Any], config_path: str) -> List[str]:
    """The sampling CLI's flags for the mix: the sampler, its steps and
    the guidance (PLMS and DPM-Solver++ run at eta 0)."""
    flag = {"plms": "-plms", "dpmpp": "-dpmpp"}[traffic["sampler"]]
    args = ["-cfg", config_path, flag, "-c", str(traffic["steps"])]
    if traffic["guidance_scale"] != 1.0:
        args += ["-G", "-gs", str(traffic["guidance_scale"])]
    return args


class Program:
    """The port's model and the CLI's pipeline, with the harness's spans
    and the outputs of each batch kept for the comparison."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 spans: common.Spans):
        from frido_tpu_torch.cli.sample_diffusion import (build_model,
                                                          get_parser,
                                                          make_pipeline)

        self.cell, self.device, self.spans = cell, device, spans
        self.traffic = cell.traffic
        self.model = build_model({"model": cell.config["model"]}, None,
                                 device=device)
        self.ref_meta = ref_frido.build(cell.config, device="meta")
        self.load_weights(seed)
        parser = get_parser()
        self.pipeline = make_pipeline(self.model, parser.parse_args(
            cli_args(self.traffic, cell.config_name)))
        warm = dict(self.traffic, steps=2)
        self.warm_pipeline = make_pipeline(self.model, parser.parse_args(
            cli_args(warm, cell.config_name)))
        self.current: Dict[str, Any] = {}
        spans.wrap(self.model, "get_learned_conditioning", "cond",
                   lambda out: self.current.setdefault("ctx", []).append(out))
        spans.wrap(self.model, "sample", "sample",
                   lambda out: self.current.__setitem__("z", out))
        spans.wrap(self.model, "decode_first_stage", "decode",
                   lambda out: self.current.__setitem__("image", out))
        self.kept: Dict[int, Dict[str, Any]] = {}

    def load_weights(self, seed: int) -> None:
        sd = weights.state_dict(self.ref_meta, seed, self.device)
        self.model.load_state_dict(sd, strict=True)
        del sd

    def inputs(self, seed: int, i: int):
        tokens, utokens = tr.conditions(self.traffic, seed, i)
        return tokens, utokens, tr.torch_seed(seed, tr.NOISE, i)

    def batch(self, seed: int, i: int, keep: bool = True,
              warm: bool = False) -> int:
        tokens, utokens, noise_seed = self.inputs(seed, i)
        gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        self.current = {}
        (self.warm_pipeline if warm else self.pipeline)(tokens, utokens, gen)
        if keep:
            self.kept[i] = self.current
        return int(tokens.shape[0])

    def close(self) -> None:
        self.model = self.pipeline = self.warm_pipeline = None
        self.current = {}


def reference_outputs(cell: Cell, seed: int, i: int, z_prog: torch.Tensor,
                      ref: ref_frido.Frido, control: bool = False,
                      target=None) -> Dict[str, Any]:
    """Batch ``i``'s conditioning (both batches), its sampled latent from
    the batch's own initial noise, and the decode of the program's latent
    ``z_prog``, computed by ``ref``. The reference's own run is float32
    with TF32 off; with ``target`` (the images it is to judge) its decode
    takes, where two codes tie within float32's reach, the choice nearest
    to the target (``reference/frido.decode_judged``). ``control``:
    ``ref`` is the control (its UNet rounded to fp8 by
    ``reference/precision.unet_fp8``), run one step below what the
    configuration states: the conditioning in TF32, the UNet's products
    in fp8 under bfloat16, the decode in bfloat16.

    The chain runs for the rows ``rows`` (every row, or the mix's
    ``reference_rows`` of them drawn from the seed: the chain is the
    reference's costliest part, and each row's chain is its own); the
    conditioning and the decode for every row."""
    t = cell.traffic
    dev = next(ref.parameters()).device
    tokens, utokens = tr.conditions(t, seed, i)
    tok = torch.as_tensor(tokens, device=dev)
    utok = torch.as_tensor(utokens, device=dev)
    shape = (t["batch"], ref.image_size, ref.image_size, ref.channels)
    gen = torch.Generator(device=dev).manual_seed(
        tr.torch_seed(seed, tr.NOISE, i))
    x_init = torch.randn(shape, generator=gen, device=dev)
    rows = torch.arange(t["batch"], device=dev)
    if t.get("reference_rows", t["batch"]) < t["batch"]:
        pick = tr.rng(seed, tr.SAMPLE, i).choice(
            t["batch"], t["reference_rows"], replace=False)
        rows = torch.as_tensor(sorted(pick.tolist()), device=dev)
    with torch.no_grad():
        with (precision.tf32() if control else precision.exact()):
            ctx = (ref.conditioning(tok), ref.conditioning(utok))
        with precision.exact():
            z = ref.sample(x_init[rows], ctx[0][rows], ctx[1][rows],
                           t["steps"], t["sampler"], t["guidance_scale"],
                           compute_dtype=torch.bfloat16 if control else None)
            zp = z_prog.to(dev).float()
            if target is None:
                image = ref.decode(zp, dtype=torch.bfloat16 if control
                                   else None)
            else:
                image = ref.decode_judged(zp, target.to(dev))
    return {"ctx": ctx, "z": z, "rows": rows, "image": image.float()}


def rows_of(out: Dict[str, Any], exact: Dict[str, Any]
            ) -> Dict[str, torch.Tensor]:
    """Per-sample relative errors of ``out`` (the program's outputs, or a
    control's) against the reference's ``exact``; a sample's
    conditioning error is the larger of its two batches'; the latent's
    is read on the reference's rows (0 elsewhere)."""
    cond = compare.rel_rows(out["ctx"][0], exact["ctx"][0])
    ucond = compare.rel_rows(out["ctx"][1], exact["ctx"][1])
    rows = exact["rows"].to(out["z"].device)
    z = out["z"] if out["z"].shape[0] == rows.numel() else out["z"][rows]
    latent = torch.zeros_like(cond)
    latent[rows.to(latent.device)] = compare.rel_rows(z, exact["z"]).to(
        latent.device)
    return {"cond_rel": torch.maximum(cond, ucond), "latent_rel": latent,
            "image_rel": compare.rel_rows(out["image"], exact["image"])}


def program_outputs(kept: Dict[str, Any]) -> Dict[str, Any]:
    return {"ctx": tuple(kept["ctx"]), "z": kept["z"], "image": kept["image"]}


def checks_of(rows: Dict[str, torch.Tensor], limits: Dict[str, float]
              ) -> Tuple[List[Dict[str, Any]], int]:
    """The worst sample's number of each kind against its limit, and the
    samples with any number over its limit."""
    checks = [compare.check(n, float(rows[n].max()), limits)
              for n in NUMBERS]
    over = torch.zeros_like(rows[NUMBERS[0]], dtype=torch.bool)
    for n in NUMBERS:
        over |= ~(rows[n] <= float(limits[n]))
    return checks, int(over.sum())


def traced_batches(cell: Cell) -> int:
    return int(cell.traffic.get("traced_batches", 1))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, spans: common.Spans):
    """One run of a sampling cell: (record, checks, failed)."""
    rec = common.Record(kind="sample")
    phase = common.Phases(t_start)
    prog = Program(cell, seed, device, spans)
    common.synchronize(device)
    phase("import and build")
    prog.batch(seed, WARM_INDEX, keep=False, warm=True)
    common.synchronize(device)
    phase("warm-up")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec.setup_s = time.perf_counter() - t_start

    m = common.measure(lambda i: prog.batch(seed, i), seconds, device)
    phase("window")
    rec.units, rec.images, rec.window_s = m["units"], m["images"], \
        m["window_s"]
    rec.extra["unit_s"] = [round(x, 4) for x in m["unit_s"]]
    if device.type == "cuda":
        rec.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        rec.trace, rec.traced_units = tracing.capture(
            lambda k: prog.batch(seed, m["started"] + k, keep=False),
            traced_batches(cell), spans, device)
        phase("traced batches")
        rec.work = sample_work(cell)
        phase("operation counts")

    j = int(tr.rng(seed, tr.SAMPLE).integers(0, rec.units))
    kept = prog.kept[j]
    prog.kept.clear()
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_frido.build(cell.config, device=device)
    ref.load_state_dict(weights.state_dict(ref, seed, device), strict=True)
    phase("free and build the reference")
    exact = reference_outputs(cell, seed, j, kept["z"], ref,
                              target=kept["image"])
    rows = rows_of(program_outputs(kept), exact)
    checks, failed = checks_of(rows, cell.limits)
    phase("reference")
    rec.extra["compared_batch"] = j
    rec.extra["phases_s"] = phase.seconds
    return rec, checks, failed


def sample_work(cell: Cell) -> Dict[str, float]:
    from harness.flops import sample_units

    model = ref_frido.build(cell.config, device="meta")
    return sample_units(model, cell.traffic, torch.bfloat16)
