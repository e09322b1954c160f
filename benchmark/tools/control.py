"""The readings a cell's limits are set from, in one process:

    python3 benchmark/tools/control.py --workload <cell> --seeds a,b,... \
        [--controls 3] [--out FILE]

For each seed, the program's numbers (the lower readings): the cell's
timed path at the cell's size, one batch (sampling) or the checked steps
(training), compared with the reference exactly as a run compares them.
For the first ``--controls`` seeds, the control's numbers (the upper
readings): the reference put in the program's place one precision below
what the configuration states (``reference/precision.py``), compared
with the same reference; for a training cell also the program's own
bf16 path (``--bf16_train``, side ``control:program_bf16``) and the
planted fault of ``harness/train.reference_readings`` (``half_batch``).
Prints one JSON line a reading and writes them all to ``--out``."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _emit(rows, out, **kw):
    line = dict(kw)
    rows.append(line)
    print(json.dumps(line), flush=True)
    if out:
        pathlib.Path(out).write_text(json.dumps(rows, indent=1))


def code_look(prog, ref, z):
    """Where the program's codebook choices for the latent ``z`` (its own
    quantizer, run again on ``z``) differ from the reference's float64
    nearest codes: per image the count, and each such position's
    distance gap over the best distance and over |z|^2 + |e|^2."""
    import torch

    fs = prog.model.first_stage_model
    h = prog.model._scale_latent(z, invert=True)
    with torch.no_grad():
        _, codes = fs._quantize_blocks(h)
    hr = ref.scale_latent(z.float(), invert=True)
    per_image, gaps, start = [0] * z.shape[0], [], 0
    for q, d, pc in zip(ref.first_stage_model.ms_quantize,
                        ref.first_stage_model.embed_dim, codes):
        e = q.embedding.weight.detach().double()
        flat = hr[..., start:start + d].reshape(-1, d).double()
        dist = ((flat[:, None, :] - e[None]) ** 2).sum(-1) if flat.shape[
            0] * e.shape[0] < 2 ** 26 else (
            (e * e).sum(1)[None] - 2 * flat @ e.t() + (flat * flat).sum(
                1, keepdim=True))
        best = dist.argmin(1)
        pcf = pc.reshape(-1).long()
        bad = (pcf != best).nonzero().flatten()
        n_pos = flat.shape[0] // z.shape[0]
        for i in bad.tolist():
            per_image[i // n_pos] += 1
            b, p_ = dist[i, best[i]], dist[i, pcf[i]]
            scale = (flat[i] ** 2).sum() + (e[best[i]] ** 2).sum()
            gaps.append([float((p_ - b) / b.clamp_min(1e-30)),
                         float((p_ - b) / scale)])
        start += d
    return per_image, gaps


def sample_readings(cell, seeds, n_control, device, out, diagnose=False,
                    index=0):
    import torch

    from harness import common, sample, weights
    from reference import frido as ref_frido, precision

    rows = []
    prog = sample.Program(cell, seeds[0], device, common.Spans(device))
    prog.batch(seeds[0], sample.WARM_INDEX, keep=False, warm=True)
    ref = ref_frido.build(cell.config, device=device)
    ctrl = ref_frido.build(cell.config, device=device)
    precision.unet_fp8(ctrl)
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog.load_weights(seed)
        prog.kept.clear()
        prog.batch(seed, index)
        kept = prog.kept.pop(index)
        sd = weights.state_dict(ref, seed, device)
        ref.load_state_dict(sd, strict=True)
        exact = sample.reference_outputs(cell, seed, index, kept["z"], ref,
                                         target=kept["image"])
        r = sample.rows_of(sample.program_outputs(kept), exact)
        _emit(rows, out, seed=seed, side="program",
              **{n: float(v.max()) for n, v in r.items()},
              seconds=time.perf_counter() - t0)
        if diagnose:
            per_image, gaps = code_look(prog, ref, kept["z"])
            _emit(rows, out, seed=seed, side="look",
                  image_rel=r["image_rel"].tolist(), flips=per_image,
                  gaps=gaps[:20])
        if k < n_control:
            ctrl.load_state_dict(sd, strict=True)
            c = sample.reference_outputs(cell, seed, index, kept["z"],
                                         ctrl, control=True)
            with torch.no_grad(), precision.exact():
                judged = ref.decode_judged(kept["z"].float(), c["image"])
            rc = sample.rows_of(c, dict(exact, image=judged))
            _emit(rows, out, seed=seed, side="control",
                  **{n: float(v.max()) for n, v in rc.items()})
        del sd, kept, exact
        torch.cuda.empty_cache()
    return rows


def train_readings(cell, seeds, n_control, device, out):
    import gc

    import torch

    from harness import common, train

    def program(seed, compute_dtype=None):
        prog = train.Program(cell, seed, device, common.Spans(device),
                             compute_dtype=compute_dtype)
        grads = None
        for i in range(train.CHECKED):
            prog.step(i)
            if i == 0:
                grads = prog.first_grads()
        readings = {"losses": list(prog.losses), "grads": grads,
                    "change": prog.change_norms()}
        lr = prog.lr
        prog.close()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return readings, lr

    rows = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        readings, lr = program(seed)
        ref = train.reference_readings(cell, seed, device, lr)
        _emit(rows, out, seed=seed, side="program",
              **train.numbers(readings, ref), losses=readings["losses"],
              ref_losses=ref["losses"], seconds=time.perf_counter() - t0)
        if k < n_control:
            ctrl = train.reference_readings(cell, seed, device, lr,
                                            compute_dtype=torch.bfloat16)
            _emit(rows, out, seed=seed, side="control",
                  **train.numbers(ctrl, ref))
            own, _ = program(seed, torch.bfloat16)
            _emit(rows, out, seed=seed, side="control:program_bf16",
                  **train.numbers(own, ref))
            fault = train.reference_readings(cell, seed, device, lr,
                                             fault="half_batch")
            _emit(rows, out, seed=seed, side="fault:half_batch",
                  **train.numbers(fault, ref))
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--batch", type=int, default=0,
                   help="sampling: the index of the batch of each seed")
    p.add_argument("--diagnose", action="store_true",
                   help="sampling: per-image errors and the codebook "
                        "choices that differ from the reference's")
    args = p.parse_args(argv)
    import torch

    from harness import registry

    cell = registry.cell(args.workload, registry.benchmark(HERE.parent))
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.traffic["kind"] == "sample":
        sample_readings(cell, seeds, args.controls, device, args.out,
                        args.diagnose, args.batch)
    else:
        train_readings(cell, seeds, args.controls, device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
