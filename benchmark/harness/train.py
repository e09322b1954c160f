"""A training cell: back-to-back ``DiffusionTrainer.train_step`` calls,
the trainer built as the training CLI (``cli/main.py``) builds it for one
card: the model from the configuration with the seeded weights loaded,
the latent scale factors from the first batch (``scale_by_std``), AdamW
at the configuration's learning rate (``--scale_lr False``) with its
scheduler if any, the EMA, compute in float32 (``--bf16_train`` off).
Inputs are a pool of seeded images and captions made on the card at
set-up; step ``i`` takes rows ``i * batch`` onwards of the pool.

Set-up drives the trainer through its first :data:`CHECKED` steps, on
rows that all differ; the reference follows the same steps from the same
weights, inputs and draws. Compared (:func:`numbers`): each step's loss,
each leaf's norm of the first gradient as AdamW got it (its first moment
after one step over 1 - b1), the median leaf's norm of that gradient's
difference from the reference's, and each leaf's norm of the change of
the parameters and of the EMA after the checked steps. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change and of the median.

Spans: ``train_step`` around each call, ``optim`` around AdamW's step."""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import torch

from harness import common, compare, traffic as tr, weights
from harness import trace as tracing
from harness.registry import Cell
from reference import frido as ref_frido, precision
from reference import train as ref_train

NUMBERS = ("loss_gap", "grad_gap", "grad_err_med", "update_gap")
CHECKED = 3
SMALL_GRAD = 1e-3


class Program:
    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 spans: common.Spans, compute_dtype=None):
        from frido_tpu_torch.config import instantiate_from_config
        from frido_tpu_torch.training import optim
        from frido_tpu_torch.training.trainer import (DiffusionTrainer,
                                                      trainable_parameters)

        self.cell, self.seed, self.device, self.spans = cell, seed, device, \
            spans
        t = self.traffic = cell.traffic
        mcfg = cell.config["model"]
        self.model = instantiate_from_config(mcfg, device=device, seed=seed)
        ref_meta = ref_frido.build(cell.config, device="meta")
        self.start = weights.state_dict(ref_meta, seed, device)
        self.model.load_state_dict(self.start, strict=True)
        self.images, self.tokens = pool(cell, seed, device)
        if mcfg["params"].get("scale_by_std", False):
            self.model.init_scale_by_std(rows(self.images, 0, t["batch"]))
        mp = mcfg["params"]
        self.lr = optim.scaled_learning_rate(
            mcfg["base_learning_rate"], t["batch"], 1, 1, scale_lr=False)
        opt = optim.build_from_config(
            [p for _, p in trainable_parameters(self.model)], self.lr,
            mp.get("scheduler_config"), accumulate_grad_batches=1,
            mu_dtype=None)
        self.trainer = DiffusionTrainer(self.model, opt, use_ema=True,
                                        remat=False,
                                        compute_dtype=compute_dtype)
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        spans.wrap(opt, "step", "optim")
        self.losses: List[float] = []

    def step(self, i: int) -> int:
        b = self.traffic["batch"]
        batch = {"image": rows(self.images, i, b),
                 "tokens": rows(self.tokens, i, b)}
        gen = torch.Generator(device=self.device).manual_seed(
            tr.torch_seed(self.seed, tr.STEP, i))
        with self.spans("train_step"):
            logs = self.trainer.train_step(batch, gen)
        if i < CHECKED:
            self.losses.append(float(logs["loss"]))
        return self.traffic["batch"]

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each trainable leaf's gradient at the first step as AdamW got
        it (its first moment after the step over 1 - b1), on the host; NaN
        where AdamW holds no moment."""
        opt = self.trainer.optimizer
        b1 = opt.defaults["b1"]
        out = {}
        for g in opt.param_groups:
            for p in g["params"]:
                mu = opt.state.get(p, {}).get("mu")
                out[self.names[id(p)]] = (
                    torch.full(p.shape, math.nan) if mu is None
                    else (mu.float() / (1 - b1)).cpu())
        return out

    def change_norms(self) -> Dict[str, float]:
        """Each trainable leaf's and each EMA leaf's (``ema:`` + name)
        norm of its change from the start."""
        out = {}
        for g in self.trainer.optimizer.param_groups:
            for p in g["params"]:
                n = self.names[id(p)]
                out[n] = float((p.detach() - self.start[n]).norm())
        for k, s in self.trainer.ema.shadow.items():
            out["ema:" + k] = float((s - self.start["model." + k]).norm())
        return out

    def close(self) -> None:
        self.model = self.trainer = self.start = None
        self.images = self.tokens = None


def rows(x, i: int, batch: int):
    """Step ``i``'s rows of the pool ``x``: ``batch`` rows from
    ``i * batch`` on, wrapping round."""
    idx = (torch.arange(batch, device=x.device) + i * batch) % x.shape[0]
    return x.index_select(0, idx)


def pool(cell: Cell, seed: int, device):
    """The seeded images and captions every step takes its rows from."""
    t = cell.traffic
    n = t["pool"]
    images = tr.images(t, seed, n, device)
    tokens = tr.captions(t["cond"], tr.rng(seed, tr.CONDITION), n)
    return images, torch.as_tensor(tokens, device=device).long()


def reference_readings(cell: Cell, seed: int, device, lr: float,
                       compute_dtype=None, fault=None) -> Dict[str, Any]:
    """The reference's losses, first gradients (on the host) and change
    norms over the checked steps, from the seed's weights.
    ``compute_dtype`` runs it as ``--bf16_train`` would (the control);
    ``fault`` names a fault planted in it: ``half_batch`` (the loss over
    the first half of each batch)."""
    m = ref_frido.build(cell.config, device=device)
    start = weights.state_dict(m, seed, device)
    m.load_state_dict(start, strict=True)
    images, tokens = pool(cell, seed, device)
    b = cell.traffic["batch"]
    with precision.exact():
        if cell.config["model"]["params"].get("scale_by_std", False):
            m.scale_by_std(rows(images, 0, b))
        rt = ref_train.Trainer(m, lr, compute_dtype=compute_dtype)
        losses, grads = [], {}
        for i in range(CHECKED):
            x, tok = rows(images, i, b), rows(tokens, i, b)
            if fault == "half_batch":
                x, tok = x[:b // 2], tok[:b // 2]
            gen = torch.Generator(device=device).manual_seed(
                tr.torch_seed(seed, tr.STEP, i))
            if fault == "half_batch":
                out = _half_batch_step(rt, x, tok, gen, b)
            else:
                out = rt.step(x, tok, gen)
            losses.append(out["loss"])
            if i == 0:
                grads = {n: g.float().cpu() for n, g in out["grads"].items()}
            del out
        change = {n: float((p.detach() - start[n]).norm())
                  for n, p in rt.params}
        change.update({"ema:" + k: float((s - start["model." + k]).norm())
                       for k, s in rt.ema.items()})
    return {"losses": losses, "grads": grads, "change": change}


def _half_batch_step(rt, x, tok, gen, b):
    """The planted fault: draws for the whole batch, the loss taken over
    its first half."""
    t, noise = ref_train.draws(gen, b, rt.model)
    m = rt.model
    z = m.encode(x).float()
    ctx = m.conditioning(tok)
    loss, _ = m.training_loss(z, ctx, t[:b // 2], noise[:b // 2])
    for _, p in rt.params:
        p.grad = None
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in rt.params}
    rt._adam(grads)
    rt._ema()
    return {"loss": float(loss.detach()), "grads": grads}


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The compared numbers of the program's readings (``prog``) against
    the reference's: ``loss_gap`` (the worst checked step's relative loss
    gap), ``grad_gap`` (the worst leaf's gap of first-gradient norms),
    ``grad_err_med`` (the median leaf's norm of the first gradient's
    difference from the reference's) and ``update_gap`` (the worst
    leaf's gap of change norms, parameters and EMA); each leaf's over the
    larger of the reference leaf's norm and the median leaf's. ``grads``
    are the first step's gradients, leaf by leaf."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
                   else math.inf for p, r in zip(prog["losses"],
                                                 ref["losses"]))
    g = {n: float(v.norm()) for n, v in ref["grads"].items()}
    pg = {n: float(v.norm()) for n, v in prog["grads"].items()}
    med = float(torch.tensor(list(g.values())).median())
    keep = [n for n, v in g.items() if v >= SMALL_GRAD * med]
    grad_gap = max(compare.norm_gaps(pg, g).values())
    rel = [float((prog["grads"][n] - ref["grads"][n]).norm())
           / max(g[n], med, 1e-30) if n in prog["grads"] else math.inf
           for n in keep]
    rel = [r if math.isfinite(r) else math.inf for r in rel]
    params = compare.norm_gaps(prog["change"], ref["change"], keep)
    ema_keep = ["ema:" + n[len("model."):] for n in keep
                if n.startswith("model.")]
    ema = compare.norm_gaps(prog["change"], ref["change"], ema_keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_err_med": float(torch.tensor(rel).median()),
            "update_gap": max(max(params.values()), max(ema.values()))}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, spans: common.Spans):
    """One run of a training cell: (record, checks, failed)."""
    rec = common.Record(kind="train")
    phase = common.Phases(t_start)
    prog = Program(cell, seed, device, spans)
    common.synchronize(device)
    phase("import and build")
    grads = None
    for i in range(CHECKED):
        prog.step(i)
        if i == 0:
            grads = prog.first_grads()
    readings = {"losses": list(prog.losses), "grads": grads,
                "change": prog.change_norms()}
    # the start's memory goes back to the allocator's pool, which the
    # window reuses: emptying the pool here would make the window's
    # first steps allocate anew
    prog.start = None
    common.synchronize(device)
    phase("checked steps")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec.setup_s = time.perf_counter() - t_start

    m = common.measure(lambda i: prog.step(CHECKED + i), seconds, device)
    phase("window")
    rec.units, rec.images, rec.window_s = m["units"], m["images"], \
        m["window_s"]
    rec.extra["unit_s"] = [round(x, 4) for x in m["unit_s"]]
    if device.type == "cuda":
        rec.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        rec.trace, rec.traced_units = tracing.capture(
            lambda k: prog.step(CHECKED + m["started"] + k),
            int(cell.traffic.get("traced_steps", 2)), spans, device)
        phase("traced steps")
        from harness.flops import train_units

        rec.work = train_units(ref_frido.build(cell.config, device="meta"),
                               cell.traffic)
        phase("operation counts")
    lr = prog.lr
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase("free")
    ref = reference_readings(cell, seed, device, lr)
    nums = numbers(readings, ref)
    checks = [compare.check(n, nums[n], cell.limits) for n in NUMBERS]
    phase("reference")
    rec.extra["phases_s"] = phase.seconds
    failed = 0 if compare.verdict(checks) else CHECKED * cell.traffic["batch"]
    return rec, checks, failed
