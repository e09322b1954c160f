"""Time the conv kernels against an earlier version of their source, on one
card, in one process.

    python -m frido_tpu_torch.tools.conv_ab --old DIR [--out FILE]

DIR holds the earlier ``conv3x3.cu`` (and the headers it includes), for
example ``frido_tpu_torch/csrc`` of an unpacked ``git archive`` of the
parent commit. It is built here with the port's nvcc flags and called
through the C entry points of that version (before the host plan):
``(x, w, b, y, n, cin, h, w, cout, stream)`` and, with the prologue,
``(x, w, b, norm_w, norm_b, gamma, beta, scale, shift, y, n, cin, h, w,
cout, groups, eps, stream)``. The current kernels go through the port's
wrappers. At every conv site ``chip_smoke.py`` times, each is checked
against the plain version (the card tests' tolerances), then timed by CUDA
events in the order old, new, new, old, beside ``F.conv2d`` (cuDNN, TF32
off; for a fused site the conv alone, without the prologue): that is the
time a caller sees, host launch included. The device time alone comes
from 20 calls captured in a CUDA graph and replayed (``*_device_ms``). One
JSON line per site, and all of them in FILE when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

from frido_tpu_torch.ops.cuda import build
from frido_tpu_torch.ops.cuda.conv import (conv3x3, conv3x3_norm_silu,
                                           conv3x3_norm_silu_plain,
                                           conv3x3_plain, conv_plan)
from frido_tpu_torch.tools.attention_ab import cuda_ms, graph_ms, seeded

# (kernel, x shape, cout, dtype, spade): every conv site chip_smoke.py times
SITES = [
    ("conv3x3", (4, 128, 256, 256), 128, torch.float32, None),
    ("conv3x3", (4, 384, 32, 32), 384, torch.bfloat16, None),
    ("conv3x3", (4, 576, 16, 16), 576, torch.bfloat16, None),
    ("conv3x3", (4, 960, 8, 8), 960, torch.bfloat16, None),
    ("conv3x3", (4, 4, 32, 32), 192, torch.bfloat16, None),
    ("conv3x3", (4, 192, 32, 32), 4, torch.bfloat16, None),
    ("conv3x3_norm_silu", (4, 576, 32, 32), 192, torch.bfloat16, True),
    ("conv3x3_norm_silu", (4, 960, 16, 16), 384, torch.bfloat16, True),
    ("conv3x3_norm_silu", (4, 1536, 8, 8), 576, torch.bfloat16, True),
    ("conv3x3_norm_silu", (4, 1920, 4, 4), 960, torch.bfloat16, True),
    ("conv3x3_norm_silu", (4, 1920, 4, 4), 960, torch.bfloat16, False),
]


def build_old(src: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libconv3x3_old.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src / "conv3x3.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"old conv3x3 did not build:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"frido_conv3x3_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"frido_conv3x3_norm_silu_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def old_call(lib, x, w, b, norm=None):
    """The earlier kernel on the same operands; ``norm``: (nscale, nbias,
    gamma, beta) for the fused op (32 groups, eps 1e-5)."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if norm is None:
        rc = getattr(lib, f"frido_conv3x3_{suffix}")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, cin,
            h, wd, cout, stream)
    else:
        ns, nb, g, bt = norm
        stats = torch.empty((2, n, cin), dtype=torch.float32,
                            device=x.device)
        rc = getattr(lib, f"frido_conv3x3_norm_silu_{suffix}")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), ns.data_ptr(),
            nb.data_ptr(), _ptr(g), _ptr(bt), stats[0].data_ptr(),
            stats[1].data_ptr(), y.data_ptr(), n, cin, h, wd, cout, 32, 1e-5,
            stream)
    if rc != 0:
        raise RuntimeError(f"old conv3x3 launch failed with {rc}")
    return y


def max_err(got, want, dtype, fused):
    """max |got - want|, after checking it against the card tests'
    tolerance: 1e-4 of the output RMS (fused bf16: 2^-6 of it), and in
    bf16 + 2^-8 |want|."""
    rms = want.square().mean().sqrt().item()
    atol = (2.0 ** -6 if fused and dtype == torch.bfloat16 else 1e-4) * rms
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -8
    diff = (got.float() - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"|kernel - plain| max {diff.max().item()} "
                             f"exceeds {atol} + {rtol} |plain|")
    return diff.max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("conv_ab needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build(["conv3x3"])
    lib = build_old(args.old.resolve(), build.BUILD_DIR / "old")
    rows = []
    for name, shape, cout, dtype, spade in SITES:
        cin = shape[1]
        x = seeded(shape, 1, dtype)
        w = (seeded((cout, cin, 3, 3), 2, torch.float32)
             / (9 * cin) ** 0.5).to(dtype)
        b = (0.1 * seeded((cout,), 3, torch.float32)).to(dtype)
        fused = name == "conv3x3_norm_silu"
        if fused:
            ns = 1.0 + 0.1 * seeded((cin,), 4, torch.float32)
            nb = 0.1 * seeded((cin,), 5, torch.float32)
            g = bt = None
            if spade:
                g = (0.2 * seeded(shape, 6, torch.float32)).to(dtype)
                bt = (0.2 * seeded(shape, 7, torch.float32)).to(dtype)
            up = (lambda t: None if t is None else t.float())
            want = conv3x3_norm_silu_plain(x.float(), w.float(), b.float(),
                                           ns, nb, 32, 1e-5, up(g), up(bt))
            new = lambda: conv3x3_norm_silu(  # noqa: E731
                x, w, b, ns, nb, 32, 1e-5, g, bt)
            old = lambda: old_call(lib, x, w, b, (ns, nb, g, bt))  # noqa
        else:
            want = conv3x3_plain(x.float(), w.float(), b.float())
            new = lambda: conv3x3(x, w, b)  # noqa: E731
            old = lambda: old_call(lib, x, w, b)  # noqa: E731
        err_new = max_err(new(), want, dtype, fused)
        err_old = max_err(old(), want, dtype, fused)
        old_a, new_a, new_b, old_b = (cuda_ms(f) for f in (old, new, new,
                                                           old))
        library = lambda: F.conv2d(x, w, b, 1, 1)  # noqa: E731
        plan = conv_plan(*shape, cout, x.element_size(), fused, bool(spade))
        row = dict(kernel=name, site=[*shape, cout], spade=spade,
                   dtype=str(dtype).split(".")[1], card=card,
                   old_ms=[old_a, old_b], new_ms=[new_a, new_b],
                   conv2d_ms=cuda_ms(library), old_device_ms=graph_ms(old),
                   new_device_ms=graph_ms(new),
                   conv2d_device_ms=graph_ms(library),
                   speedup=(old_a + old_b) / (new_a + new_b),
                   max_abs_err_new=err_new, max_abs_err_old=err_old,
                   plan=plan._asdict())
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
