"""Tiny cells end to end on the CPU: a sound run comes out correct, and a
run with the timed path broken underneath comes out not correct, for
each fault the cell can have (a step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced; one
chip, so no exchange to leave out). The control, the reference in the
program's place one precision lower, fails a limit too. The cells'
limits are the real ones (``limits/<cell>.json``)."""

import json
import time

import pytest
import torch

import bench_tiny as tiny
import run as runmod
from harness import registry, sample

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")
CELLS = {"t2i.sample": ("frido-t2i-f16f8-coco", "captions-plms20-b32"),
         "layout2i.sample": ("frido-layout2i-f8f4-coco-seg",
                             "layouts-dpmpp20-b8"),
         "t2i.train": ("frido-t2i-f16f8-coco", "captions-images-b32")}


def _cell(tmp_path, name):
    cfg, mix = CELLS[name]
    limits = json.loads((tiny.BENCH / "limits" / f"{name}.json").read_text())
    bdir = tiny.write_bench(tmp_path, {name: {
        "config": tiny.tiny_config(cfg), "traffic": tiny.tiny_traffic(mix),
        "limits": limits}})
    return registry.cell(name, json.loads(
        (tmp_path / "BENCHMARK.json").read_text()), bench_dir=bdir)


def _run(cell, trace=False):
    torch.manual_seed(0)
    return runmod.run_cell(cell, SEED, 0.5, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(tmp_path, name):
    result, checks = _run(_cell(tmp_path, name), trace=True)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert [c["name"] for c in checks] == list(
        sample.NUMBERS if "sample" in name else
        ("loss_gap", "grad_gap", "grad_err_med", "update_gap"))
    # off the card nothing device-side is read; the work counts are
    kind = "sample" if "sample" in name else "train"
    assert set(result["metrics"]) == {f"mfu.{kind}"}


def _fault_sample(monkeypatch, fault):
    from frido_tpu_torch.diffusion import samplers
    from frido_tpu_torch.models.frido import FridoDiffusion

    if fault == "state_unchanged":
        for kind in ("plms", "dpmpp"):
            monkeypatch.setitem(samplers._STAGE_FNS, kind,
                                lambda cfg, dd, eps, x_w, gen, emit: x_w)
    elif fault == "half_batch":
        orig = FridoDiffusion._sample

        def half(self, batch_size, context=None, uncond_context=None,
                 *args, **kw):
            h = batch_size // 2
            z = orig(self, h, context[:h], uncond_context[:h], *args, **kw)
            return torch.cat([z, z])

        monkeypatch.setattr(FridoDiffusion, "_sample", half)
    else:
        orig = FridoDiffusion.decode_first_stage

        def altered(self, z, chunk=None):
            img = orig(self, z, chunk).clone()
            img[0] += 0.05
            return img

        monkeypatch.setattr(FridoDiffusion, "decode_first_stage", altered)


def _fault_train(monkeypatch, fault):
    from frido_tpu_torch.models.frido import FridoDiffusion
    from frido_tpu_torch.training.optim import AdamW

    if fault == "state_unchanged":
        monkeypatch.setattr(AdamW, "step", lambda self, closure=None: True)
        return
    orig = FridoDiffusion.training_loss

    def broken(self, z, context, t, noise, compute_dtype=None):
        if fault == "half_batch":
            h = z.shape[0] // 2
            return orig(self, z[:h], context[:h], t[:h], noise[:h],
                        compute_dtype)
        loss, logs = orig(self, z, context, t, noise, compute_dtype)
        return loss * 1.01, logs

    monkeypatch.setattr(FridoDiffusion, "training_loss", broken)


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, name,
                                          fault):
    cell = _cell(tmp_path, name)
    (_fault_sample if "sample" in name else _fault_train)(monkeypatch, fault)
    result, checks = _run(cell)
    assert not result["correct"], checks
    assert result["failed"] > 0


@pytest.mark.parametrize("name", ["t2i.sample", "layout2i.sample"])
def test_sampling_control_fails_a_limit(tmp_path, name):
    """The control of a sampling cell at a size a test run holds: its
    UNet's products in fp8, its decode in bf16 (on the CPU, TF32 does not
    exist: its conditioning is the reference's)."""
    from harness import common, weights
    from reference import frido as ref_frido, precision

    cell = _cell(tmp_path, name)
    prog = sample.Program(cell, SEED, CPU, common.Spans(CPU))
    prog.batch(SEED, 0)
    kept = prog.kept[0]
    ref = ref_frido.build(cell.config, device=CPU)
    ctrl = ref_frido.build(cell.config, device=CPU)
    precision.unet_fp8(ctrl)
    sd = weights.state_dict(ref, SEED, CPU)
    ref.load_state_dict(sd)
    ctrl.load_state_dict(sd)
    exact = sample.reference_outputs(cell, SEED, 0, kept["z"], ref)
    own, _ = sample.checks_of(
        sample.rows_of(sample.program_outputs(kept), exact), cell.limits)
    ctl, _ = sample.checks_of(sample.rows_of(sample.reference_outputs(
        cell, SEED, 0, kept["z"], ctrl, control=True), exact), cell.limits)
    assert all(c["ok"] for c in own), own
    assert not all(c["ok"] for c in ctl), ctl


def test_reference_chain_on_sampled_rows(tmp_path):
    """A mix's ``reference_rows`` runs the reference's chain on that many
    rows drawn from the seed; the conditioning and the decode still cover
    every row."""
    cfg, mix = CELLS["layout2i.sample"]
    limits = json.loads((tiny.BENCH / "limits" / "layout2i.sample.json")
                        .read_text())
    bdir = tiny.write_bench(tmp_path, {"c": {
        "config": tiny.tiny_config(cfg),
        "traffic": tiny.tiny_traffic(mix, batch=4, reference_rows=2),
        "limits": limits}})
    cell = registry.cell("c", json.loads(
        (tmp_path / "BENCHMARK.json").read_text()), bench_dir=bdir)
    result, checks = _run(cell)
    assert result["correct"], checks
    from harness import common, weights
    from reference import frido as ref_frido

    prog = sample.Program(cell, SEED, CPU, common.Spans(CPU))
    prog.batch(SEED, 0)
    kept = prog.kept[0]
    ref = ref_frido.build(cell.config, device=CPU)
    ref.load_state_dict(weights.state_dict(ref, SEED, CPU))
    exact = sample.reference_outputs(cell, SEED, 0, kept["z"], ref,
                                     target=kept["image"])
    rows = sample.rows_of(sample.program_outputs(kept), exact)
    assert exact["rows"].numel() == 2 and exact["image"].shape[0] == 4
    assert int((rows["latent_rel"] > 0).sum()) == 2
    assert bool((rows["image_rel"] > 0).all())
