"""Time the GroupNorm and VQ argmin kernels against an earlier version of
their sources, on one card, in one process.

    python -m frido_tpu_torch.tools.norm_vq_ab --old DIR [--out FILE]

DIR holds the earlier ``group_norm.cu`` and ``vq_argmin.cu`` (and the
headers they include), for example ``frido_tpu_torch/csrc`` of an unpacked
``git archive`` of the parent commit. They are built here with the port's
nvcc flags and called through the C entry points of that version (before
the host plans): ``(x, w, b, y, n, c, groups, hw, eps, silu, stream)`` and
``(z, e, idx, n, k, d, stream)``. The current kernels go through the
port's wrappers.

At every GroupNorm site of the main path (the decoder's fp32 sites and the
UNet's bf16 ones, batch 4) and at N = 1024, 4096 and 32768 for the VQ
argmin (K = 8192, D = 4), each version is checked against the plain
version (the card tests' tolerances), then timed by CUDA events in the
order old, new, new, old, beside the library call (``F.group_norm``,
which has no SiLU; ``torch.cdist(z, e).argmin(1)``): that is the time a
caller sees, host launch included. For GroupNorm the old kernel is also
timed behind the earlier wrapper's host work (``old_wrapped_ms``: the
device context, the affine casts, the stream object, the autograd
function), which is what the main path paid, and an elementwise op that
moves the same bytes (``torch.mul(x, 1.5, out=y)``: one read, one write)
beside them, as what the card reaches in practice
(``same_bytes_device_ms``). The device time alone comes from 20 calls
captured in a CUDA graph and replayed (``*_device_ms``). One JSON line per
site, and all of them in FILE when given.
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
from frido_tpu_torch.ops.cuda.norm import (group_norm, group_norm_plain,
                                           group_norm_plan)
from frido_tpu_torch.ops.cuda.vq import vq_argmin, vq_argmin_plain, vq_plan
from frido_tpu_torch.tools.attention_ab import cuda_ms, graph_ms, seeded

PEAK_BYTES = 3.35e12      # HBM3 of an H100 SXM
PEAK_FP32_FLOPS = 67e12   # fp32 outside the tensor cores

# (x shape, dtype, eps, silu): every GroupNorm site of the main path
GN_SITES = [
    ((4, 512, 32, 32), torch.float32, 1e-6, True),
    ((4, 512, 64, 64), torch.float32, 1e-6, True),
    ((4, 256, 64, 64), torch.float32, 1e-6, True),
    ((4, 256, 128, 128), torch.float32, 1e-6, True),
    ((4, 128, 128, 128), torch.float32, 1e-6, True),
    ((4, 128, 256, 256), torch.float32, 1e-6, True),
    ((4, 192, 32, 32), torch.bfloat16, 1e-5, True),
    ((4, 384, 16, 16), torch.bfloat16, 1e-6, False),
    ((4, 576, 8, 8), torch.bfloat16, 1e-6, False),
    ((4, 960, 4, 4), torch.bfloat16, 1e-6, False),
]
VQ_SITES = [(1024, 8192, 4), (4096, 8192, 4), (32768, 8192, 4)]
GN_ATOL = 5e-5
BF16_RTOL = 2.0 ** -8
VQ_DIST_ATOL = 1e-5


def build_old(src: pathlib.Path, out: pathlib.Path):
    """The earlier group_norm and vq_argmin libraries, built in parallel."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("group_norm", "vq_argmin"):
        lib_path = out / f"lib{name}_old.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"old {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib_path))
    gn = libs["group_norm"]
    for fn in (gn.frido_group_norm_f32, gn.frido_group_norm_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    vq = libs["vq_argmin"]
    vq.frido_vq_argmin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    vq.frido_vq_argmin.restype = ctypes.c_int
    return gn, vq


def old_gn(lib, x, w32, b32, eps, silu, stream=None):
    """The earlier GroupNorm kernel on the same operands, 32 groups."""
    n, c = x.shape[:2]
    y = torch.empty_like(x)
    fn = (lib.frido_group_norm_f32 if x.dtype == torch.float32
          else lib.frido_group_norm_bf16)
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(), n, c,
            32, x.numel() // (n * c), eps, int(silu), stream)
    if rc != 0:
        raise RuntimeError(f"old group_norm launch failed with {rc}")
    return y


class _OldWrapped(torch.autograd.Function):
    """The earlier wrapper's host work around the old kernel: the autograd
    function on every call, the affine casts, the device context and the
    stream object."""

    @staticmethod
    def forward(ctx, lib, x, w, b, eps, silu):
        ctx.save_for_backward(x, w, b)
        xc = x.contiguous()
        w32 = w.detach().float().contiguous()
        b32 = b.detach().float().contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            return old_gn(lib, xc, w32, b32, eps, silu, stream)


def old_vq(lib, z, e):
    idx = torch.empty(z.shape[0], dtype=torch.int32, device=z.device)
    rc = lib.frido_vq_argmin(z.data_ptr(), e.data_ptr(), idx.data_ptr(),
                             z.shape[0], e.shape[0], z.shape[1],
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old vq_argmin launch failed with {rc}")
    return idx


def gn_err(got, want, dtype):
    """max |got - want| after checking 5e-5 (+ 2^-8 |want| in bf16)."""
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want).abs()
    if not bool((diff <= GN_ATOL + rtol * want.abs()).all()):
        raise AssertionError(f"group_norm |kernel - plain| max "
                             f"{diff.max().item()}")
    return diff.max().item()


def vq_gap(z, e, got, want):
    """How much farther each pick is than the plain pick, in float64."""
    z64, e64 = z.double(), e.double()
    esq = (e64 * e64).sum(1)

    def dist(idx):
        return esq[idx.long()] - 2 * (z64 * e64[idx.long()]).sum(1)

    gap = (dist(got) - dist(want)).abs().max().item()
    if not gap <= VQ_DIST_ATOL:
        raise AssertionError(f"vq_argmin distance gap {gap}")
    return gap


def gn_row(card, gn_lib, shape, dtype, eps, silu):
    c = shape[1]
    x = seeded(shape, 40, dtype)
    w = 1.0 + 0.1 * seeded((c,), 41, torch.float32)
    b = 0.1 * seeded((c,), 42, torch.float32)
    want = group_norm_plain(x.float(), w, b, 32, eps, silu)
    new = lambda: group_norm(x, w, b, 32, eps, silu)  # noqa: E731
    old = lambda: old_gn(gn_lib, x, w, b, eps, silu)  # noqa: E731
    wrapped = lambda: _OldWrapped.apply(  # noqa: E731
        gn_lib, x, w, b, eps, silu)
    err_new = gn_err(new(), want, dtype)
    err_old = gn_err(old(), want, dtype)
    gn_err(wrapped(), want, dtype)
    old_a, new_a, new_b, old_b = (cuda_ms(f) for f in (old, new, new, old))
    wl, bl = w.to(dtype), b.to(dtype)
    library = lambda: F.group_norm(x, 32, wl, bl, eps)  # noqa: E731
    buf = torch.empty_like(x)
    same_bytes = lambda: torch.mul(x, 1.5, out=buf)  # noqa: E731
    nbytes = 2 * x.numel() * x.element_size() + 8 * c
    plan = group_norm_plan(shape[0], c, 32, shape[2] * shape[3],
                           x.element_size())
    return dict(kernel="group_norm", site=list(shape), silu=silu, eps=eps,
                dtype=str(dtype).split(".")[1], card=card,
                old_ms=[old_a, old_b], new_ms=[new_a, new_b],
                old_wrapped_ms=cuda_ms(wrapped),
                group_norm_ms=cuda_ms(library),
                old_device_ms=graph_ms(old), new_device_ms=graph_ms(new),
                group_norm_device_ms=graph_ms(library),
                same_bytes_device_ms=graph_ms(same_bytes),
                bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                max_abs_err_new=err_new, max_abs_err_old=err_old,
                plan=plan._asdict())


def vq_row(card, vq_lib, n, k, d):
    z = seeded((n, d), 20, torch.float32)
    e = seeded((k, d), 21, torch.float32)
    want = vq_argmin_plain(z, e)
    new = lambda: vq_argmin(z, e)  # noqa: E731
    old = lambda: old_vq(vq_lib, z, e)  # noqa: E731
    got_new, got_old = new(), old()
    gap_new = vq_gap(z, e, got_new, want)
    gap_old = vq_gap(z, e, got_old, want)
    old_a, new_a, new_b, old_b = (cuda_ms(f) for f in (old, new, new, old))
    library = lambda: torch.cdist(z, e).argmin(dim=1)  # noqa: E731
    ops = n * k * (2 * d + 1) + k * 2 * d
    return dict(kernel="vq_argmin", site=[n, k, d], card=card,
                old_ms=[old_a, old_b], new_ms=[new_a, new_b],
                cdist_argmin_ms=cuda_ms(library),
                old_device_ms=graph_ms(old), new_device_ms=graph_ms(new),
                cdist_argmin_device_ms=graph_ms(library),
                bound_ms=ops / PEAK_FP32_FLOPS * 1e3, bound_by="operations",
                same_index_new=(got_new == want).float().mean().item(),
                same_index_old=(got_old == want).float().mean().item(),
                max_distance_gap_new=gap_new, max_distance_gap_old=gap_old,
                plan=vq_plan(n, k, d)._asdict())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("norm_vq_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build(["group_norm", "vq_argmin"])
    gn_lib, vq_lib = build_old(args.old.resolve(), build.BUILD_DIR / "old")
    rows = []
    with torch.no_grad():
        for shape, dtype, eps, silu in GN_SITES:
            rows.append(gn_row(card, gn_lib, shape, dtype, eps, silu))
            print(json.dumps(rows[-1]), flush=True)
        for n, k, d in VQ_SITES:
            rows.append(vq_row(card, vq_lib, n, k, d))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
