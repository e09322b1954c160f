"""Where the flash kernel's time goes: the kernel with phases taken out.

    python -m frido_tpu_torch.tools.flash_phases [--out FILE]

Builds ``csrc/flash_attention.cu`` as it is and four variants of it, each
with lines of its key-tile loop removed (the outputs are then wrong; only
the time is read):

- ``no_loads``: K and V of the next tile are not copied (the first tile is);
- ``no_scores``: the Q K^T products are skipped;
- ``no_pv``: the P V products are skipped;
- ``skeleton``: neither product, so what is left is the loads, the
  barriers and the softmax.

Each is timed by CUDA events at the sites the main path gives the kernel
([32, 1024, 512] fp32 and bf16, [4, 1024, 512] fp32), calling its C entry
point with the port's host plan. One JSON line per site, and all of them in
FILE when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from frido_tpu_torch.ops.cuda import build
from frido_tpu_torch.ops.cuda.attention import flash_plan
from frido_tpu_torch.tools.attention_ab import cuda_ms, seeded

LOADS = "    if (k0 + BK < nk)\n      copy_tile("
SCORES = "    scores<MH, NTS>(qs, ks, L.ldqk, L.dp, m0, kq, g, t, s);\n"
PV = ("    if (nt == 16)\n"
      "      pv<MH, true>(ps, vs, L.ldv, m0, oc0, nt, g, t, acc);\n"
      "    else\n"
      "      pv<MH, false>(ps, vs, L.ldv, m0, oc0, nt, g, t, acc);\n")
VARIANTS = {
    "kernel": [],
    "no_loads": [(LOADS, "    if (false)\n      copy_tile(")],
    "no_scores": [(SCORES, "")],
    "no_pv": [(PV, "")],
    "skeleton": [(SCORES, ""), (PV, "")],
}
SITES = [((32, 1024, 512), torch.float32), ((32, 1024, 512), torch.bfloat16),
         ((4, 1024, 512), torch.float32)]


def build_variants():
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = build.BUILD_DIR / "flash_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"flash_{name}.cu"
        cu.write_text(text)
        lib = out / f"libflash_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_phases needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    rows = []
    for (bh, n, d), dtype in SITES:
        q, k, v = (seeded((bh, n, d), s, dtype) for s in (1, 2, 3))
        out = torch.empty_like(q)
        plan = flash_plan(bh, n, n, d, q.element_size())
        times = {}
        for name, lib in libs.items():
            fn = getattr(lib, "frido_flash_attention_"
                         + ("f32" if dtype == torch.float32 else "bf16"))
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), bh, n, n, d, d ** -0.5, plan.rows,
                        plan.grid[0], plan.copy_bytes, plan.smem,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name} launch failed with {rc}")
            times[name] = cuda_ms(call)
        row = dict(site=[bh, n, n, d], dtype=str(dtype).split(".")[1],
                   rows=plan.rows, card=card, ms=times)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
