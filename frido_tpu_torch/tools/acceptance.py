"""The north-star acceptance chain on the port (the counterpart of
``tools/acceptance.sh``): a checkpoint -> the COCO mini-val sampled with
PLMS 200, CFG 1.5 -> FID against the ground-truth inputs.

    CKPT=frido_t2i.ckpt FRIDO_TPU_INCEPTION=pt_inception.pth \\
        DATA_PATH=/data/coco python -m frido_tpu_torch.tools.acceptance \\
        [--device cpu]

The published number for this chain is FID ~= 64.85 on the 1000-image
t2i mini-val (``configs/frido/t2i/frido_f16f8_coco_mini.yaml``, whose
test split's id list the config loader reads from the port's copy in
``frido_tpu_torch/data/eval_ids/``); FID moves a few points with the
diffusion seed, hence ``TOL``.

Assets the repository does not ship (each one missing is named, and the
chain exits 2):

- ``CKPT``: a Lightning Frido t2i ``.ckpt`` (imported through
  ``io/torch_import.py``, its EMA swapped in), or a checkpoint or run
  directory of this port, as the sampling CLI's ``-r`` takes them;
- ``FRIDO_TPU_INCEPTION``: pytorch-fid's InceptionV3 weights (``.pth``
  or ``.npz``);
- a BERT vocab: ``FRIDO_TPU_BERT_VOCAB``, or one vendored once with
  ``python -m frido_tpu_torch.text.vendor /path/to/vocab.txt``;

and COCO 2014 val at the config's ``data_path`` (``DATA_PATH`` overrides
it for every split).

Knobs (environment), the runbook's: ``CFG`` (the mini-val config),
``STEPS=200``, ``BS=10``, ``N=-1``, ``OUT=exp/acceptance``, ``SEED=42``,
``EXPECTED_FID=64.85``, ``TOL=8`` (``EXPECTED_FID=""`` reports the FID
without a gate), ``DATA_PATH``, ``EXTRA_OVERRIDES`` (more ``a.b=c``
dot-list entries, split on blanks).

The chain, in process: ``FRIDO_TPU_STRICT_VOCAB=1`` (an imported
checkpoint must not tokenize through the fallback vocabulary); the
sampling CLI's ``main`` in dataset mode (``-r CKPT -plms -G -gs 1.5 -c
STEPS -bs BS -n N --seed SEED -name acceptance``; in dataset mode the
batch is the config's ``data.params.batch_size``, as in the JAX CLI), then
``cli/eval_fid.py``'s ``main`` on ``$OUT/acceptance/inputs`` against
``$OUT/acceptance/sample``, the FID taken from its return value. Exit
codes: 2 when assets are missing; 1 when sampling wrote nothing or the FID
is outside ``EXPECTED_FID +/- TOL``; 0 on a pass or without a gate.
``$OUT/acceptance/RESULT.json`` (also printed): ``status``
(``pass``/``fail``/``nogate``), ``fid``, ``expected_fid``, ``tol``,
``cfg``, ``steps``, ``seed``. :func:`gate` applies the gate alone to a
FID already measured. The model and the FID tower run on the card unless
given ``--device cpu``. The kernels are the environment's switches':
flash and the VQ argmin by default, all six under ``FRIDO_CONV_MODE=
pallas_fused FRIDO_GN_PALLAS=1 FRIDO_SMALLS_ATTN=1``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict, List, Optional

from frido_tpu_torch.text import vendor

DEFAULTS = {"CFG": "configs/frido/t2i/frido_f16f8_coco_mini.yaml",
            "STEPS": "200", "BS": "10", "N": "-1", "OUT": "exp/acceptance",
            "SEED": "42", "TOL": "8"}
EXPECTED_FID = "64.85"
GUIDANCE = "1.5"


def note(msg: str) -> None:
    print(f"acceptance: {msg}", file=sys.stderr)


def knobs(env=None) -> Dict[str, str]:
    """The runbook's knobs from ``env`` (the process environment by
    default): an empty value takes the default, except ``EXPECTED_FID``,
    where an empty value turns the gate off."""
    env = os.environ if env is None else env
    k = {name: env.get(name) or default for name, default in DEFAULTS.items()}
    k["EXPECTED_FID"] = env.get("EXPECTED_FID", EXPECTED_FID)
    for name in ("CKPT", "FRIDO_TPU_INCEPTION", "FRIDO_TPU_BERT_VOCAB",
                 "DATA_PATH", "EXTRA_OVERRIDES"):
        k[name] = env.get(name, "")
    return k


def missing_assets(k: Dict[str, str]) -> List[str]:
    """One line for each asset the chain lacks."""
    missing = []
    if not k["CKPT"]:
        missing.append("CKPT - path to the torch Frido t2i checkpoint (a "
                       "Lightning .ckpt; the reference's tools/download.sh "
                       "fetches it as frido_t2i.ckpt) or a run directory of "
                       "this port")
    elif not os.path.exists(k["CKPT"]):
        missing.append(f"CKPT={k['CKPT']} does not exist")
    if not k["FRIDO_TPU_INCEPTION"]:
        missing.append("FRIDO_TPU_INCEPTION - pytorch-fid InceptionV3 "
                       "weights (pt_inception-2015-12-05-6726825d.pth or "
                       ".npz)")
    elif not os.path.isfile(k["FRIDO_TPU_INCEPTION"]):
        missing.append(f"FRIDO_TPU_INCEPTION={k['FRIDO_TPU_INCEPTION']} "
                       f"does not exist")
    vendored = os.path.join(vendor.VENDOR_DIR, vendor._BERT_VOCAB)
    if not k["FRIDO_TPU_BERT_VOCAB"] and not os.path.isfile(vendored):
        missing.append("BERT vocab - vendor one: python -m "
                       "frido_tpu_torch.text.vendor /path/to/vocab.txt (or "
                       "set FRIDO_TPU_BERT_VOCAB)")
    return missing


def overrides(k: Dict[str, str]) -> List[str]:
    """``DATA_PATH`` for every split, then ``EXTRA_OVERRIDES``."""
    out = []
    if k["DATA_PATH"]:
        out = [f"data.params.{split}.params.data_path={k['DATA_PATH']}"
               for split in ("train", "validation", "test")]
    return out + k["EXTRA_OVERRIDES"].split()


def result(k: Dict[str, str], status: str, fid: Optional[float]) -> None:
    """Write (and print) ``$OUT/acceptance/RESULT.json``."""
    out = {"status": status, "fid": fid,
           "expected_fid": (json.loads(k["EXPECTED_FID"])
                            if k["EXPECTED_FID"] else None),
           "tol": json.loads(k["TOL"]), "cfg": k["CFG"],
           "steps": json.loads(k["STEPS"]), "seed": json.loads(k["SEED"])}
    d = os.path.join(k["OUT"], "acceptance")
    os.makedirs(d, exist_ok=True)
    line = json.dumps(out)
    with open(os.path.join(d, "RESULT.json"), "w") as f:
        f.write(line + "\n")
    print(line)


def gate(k: Dict[str, str], fid: float) -> int:
    """The verdict on a measured FID: RESULT.json written, the exit code
    returned (1 outside the band, else 0)."""
    if not k["EXPECTED_FID"]:
        note(f"done: FID {fid} (no expected value configured)")
        result(k, "nogate", fid)
        return 0
    expected, tol = float(k["EXPECTED_FID"]), float(k["TOL"])
    if abs(fid - expected) <= tol:
        note(f"PASS: FID {fid} within +/-{k['TOL']} of the reference's "
             f"{k['EXPECTED_FID']}")
        result(k, "pass", fid)
        return 0
    note(f"FAIL: FID {fid} outside +/-{k['TOL']} of the reference's "
         f"{k['EXPECTED_FID']}")
    result(k, "fail", fid)
    return 1


@contextlib.contextmanager
def strict_vocab():
    """``FRIDO_TPU_STRICT_VOCAB=1`` for the block (the runbook exports it
    in its own process; here it is put back after)."""
    old = os.environ.get("FRIDO_TPU_STRICT_VOCAB")
    os.environ["FRIDO_TPU_STRICT_VOCAB"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FRIDO_TPU_STRICT_VOCAB"]
        else:
            os.environ["FRIDO_TPU_STRICT_VOCAB"] = old


def main(argv: Optional[list] = None) -> int:
    """The chain; returns the runbook's exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the model and the FID tower (default: "
                         "the card)")
    args = ap.parse_args(argv)
    k = knobs()
    missing = missing_assets(k)
    if missing:
        for line in missing:
            note(f"MISSING: {line}")
        note("chain not runnable yet; give the assets above and re-run.")
        return 2

    from frido_tpu_torch.cli import eval_fid, sample_diffusion

    device = [] if args.device is None else ["--device", args.device]
    run_dir = os.path.join(k["OUT"], "acceptance")
    note(f"sampling: {k['CFG']}, PLMS {k['STEPS']} steps, CFG {GUIDANCE}, "
         f"ckpt={k['CKPT']}")
    with strict_vocab():
        sample_diffusion.main(
            ["-cfg", k["CFG"], "-r", k["CKPT"], "-o", k["OUT"], "-name",
             "acceptance", "-plms", "-G", "-gs", GUIDANCE, "-c", k["STEPS"],
             "-bs", k["BS"], "-n", k["N"], "--seed", k["SEED"], *device,
             *overrides(k)])
    sample = os.path.join(run_dir, "sample")
    if not (os.path.isdir(sample) and os.listdir(sample)):
        note(f"FAIL: sampling wrote nothing to {sample} - check the "
             f"config's test split (data_path? img_id_file ids are "
             f"12-digit strings)")
        return 1
    inputs = os.path.join(run_dir, "inputs")
    note(f"computing FID (fake={sample}, real={inputs})")
    out = eval_fid.main(["--real", inputs, "--fake", sample, *device])
    return gate(k, out["fid"])


if __name__ == "__main__":
    sys.exit(main())
