"""3x3 / stride-1 / pad-1 convolution, plain and with the GroupNorm ->
SPADE -> SiLU prologue: the hand-written Hopper kernels, their host plan
and their plain versions.

Replaces the TPU kernels ``frido_tpu/ops/pallas/conv_pallas.py:177``
``conv3x3_pallas`` (``_conv_kernel`` :74) and ``:376``
``conv3x3_norm_silu_pallas`` (``_fused_kernel`` :199). Source: one
implicit-GEMM kernel on the tensor cores with a prologue template
parameter, ``frido_tpu_torch/csrc/conv3x3.cu``, which says what bounds it
on the card and how its tiles, pipeline and split-K are laid out. One
call is a weight pack launch, the conv and, where the plan splits K, a
reduce launch; the fused op starts with a statistics launch. Each call
counts once.

:func:`conv_plan` picks each launch's tiles, K split and grid on the host;
the C launcher checks the plan against its own layout.

Layouts are the port's: x [N, Cin, H, W], weight [Cout, Cin, 3, 3], bias
[Cout], all in the activation dtype (the caller casts, as ``Conv2d`` does);
the GroupNorm affine [Cin] and SPADE's gamma and beta [N, Cin, H, W].

The plain versions compute in fp32 and round once to the activation
dtype, as the kernels do: :func:`conv3x3_plain` adds the bias in fp32, and
:func:`conv3x3_norm_silu_plain` rounds the prologue's output once before
the conv (the Pallas kernel's single rounding, not ``_reference_fused``'s
three; in fp32 they are the same).

:func:`conv3x3` and :func:`conv3x3_norm_silu` launch the kernel for CUDA
tensors (fp32 or bf16) and raise on anything they cannot take; for CPU
tensors they compute the plain versions. Their backward recomputes through
the plain versions, as ``_conv_bwd`` and ``_make_fused``'s ``bwd`` do: there
is no backward kernel. ``.calls`` counts calls on any device,
``.launches`` the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from frido_tpu_torch.ops.cuda.build import device_context, library
from frido_tpu_torch.ops.norm import group_norm as group_norm_plain


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 conv + bias in fp32, rounded to x's dtype."""
    y = F.conv2d(x.float(), weight.float(), bias.float(), 1, 1)
    return y.to(x.dtype)


def conv3x3_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, nscale: torch.Tensor,
                            nbias: torch.Tensor, num_groups: int, eps: float,
                            gamma: Optional[torch.Tensor] = None,
                            beta: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """GroupNorm -> (SPADE x * (1 + gamma) + beta) -> SiLU in fp32, one
    rounding to x's dtype, then :func:`conv3x3_plain` (zero padding after
    the prologue)."""
    xn = group_norm_plain(x.float(), nscale, nbias, num_groups, eps)
    if gamma is not None:
        xn = xn * (1.0 + gamma.float()) + beta.float()
    return conv3x3_plain(F.silu(xn).to(x.dtype), weight, bias)


SM_COUNT = 132           # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448        # shared memory one block may opt in to (227 KB)
_BM = 64                 # output channels per block
_THREADS = 256
_TWO_BLOCKS = MAX_SMEM // 2 - 1024   # two blocks an SM at or below this


class ConvPlan(NamedTuple):
    """One conv launch (``csrc/conv3x3.cu``): grid (x: pixel tiles, y:
    64-channel Cout tiles, z: K splits); ``nt`` n8 tiles per warp (a
    block's pixel tile holds at most 32 * nt pixels); the pixel tile of
    ``nb`` whole images or ``th`` x ``tw`` of one; ``split`` Cin-chunk
    ranges of ``cps`` chunks each; the input copy width in bytes (0:
    element by element); the raw row stride ``rs`` in elements; the
    dynamic shared memory in bytes."""
    grid: Tuple[int, int, int]
    nt: int
    nb: int
    th: int
    tw: int
    split: int
    cps: int
    xcopy: int
    rs: int
    smem: int

    @property
    def args(self) -> Tuple[int, ...]:
        """The C launcher's plan arguments, in order."""
        return tuple(self[1:])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk(itemsize: int) -> int:
    """Cin channels per K chunk: 16 bf16, 8 fp32 (32 bytes a row)."""
    return 8 if itemsize == 4 else 16


def _smem(itemsize, nb, th, tw, rs, xcopy, fused, spade):
    """Dynamic shared memory in bytes, as ``conv3x3.cu``'s ``Layout``: two
    weight slots, two of raw rows, two compute patches."""
    bk = chunk(itemsize)
    ld = bk + (4 if itemsize == 4 else 8)
    parts = 2 if itemsize == 4 else 1
    ph, pw = th + 2, tw + 2
    npix = nb * ph * pw
    a_bytes = parts * 9 * _BM * ld * itemsize
    x_bytes = bk * nb * ph * rs * itemsize * (3 if spade else 1)
    ss_bytes = _cdiv(2 * nb * bk * 4, 16) * 16 if fused else 0
    return (2 * a_bytes + 2 * (x_bytes + ss_bytes)
            + 2 * parts * npix * ld * itemsize)


def _max_patch(nt: int) -> int:
    """Staged patch pixels a block of ``nt`` n8 tiles a warp may hold."""
    return 384 if nt == 8 else 256


def _geometry(n, h, w, nt):
    """(nb, th, tw) for 32 * nt pixels: as many whole images as fit there
    and in the staged patch, else rows of one image, at most 32 columns
    wide."""
    pixels, patch = 32 * nt, _max_patch(nt)
    if h * w <= pixels and (h + 2) * (w + 2) <= patch:
        nb = min(n, pixels // (h * w))
        while nb * (h + 2) * (w + 2) > patch:
            nb -= 1
        return nb, h, w
    tw = min(w, 32)
    return 1, min(h, pixels // tw, patch // (tw + 2) - 2), tw


def _xcopy(w, tw, itemsize):
    """The widest cp.async (16, 8 or 4 bytes) that divides an input row and
    keeps every tile's first column aligned; 0: element by element."""
    for b in (16, 8, 4):
        vc = b // itemsize
        if b >= itemsize and w * itemsize % b == 0 and (tw >= w or
                                                        tw % vc == 0):
            return b
    return 0


# The host plan's cost model, fitted by hand to device times of the kernel
# at the main path's sites under each tiling and split (H100 80GB HBM3,
# 700 W): the wall time of one chunk of one block with the card full,
# relative to nt = 2 (which runs two blocks an SM where the shared memory
# allows, the wider tiles one), and the split-K partials' cost per million outputs a
# split (written, then read by the reduce launch).
_CHUNK_COST = {2: 1.0, 4: 1.0, 8: 1.5}
_SPLIT_COST = 1.0
_SPLITS = (1, 2, 3, 4, 6, 9)


def _tile_plan(n, cin, h, w, cout, itemsize, fused, spade, nt, nb, th, tw,
               split):
    """The ConvPlan of one tiling and split, or None if it does not fit."""
    xcopy = _xcopy(w, tw, itemsize)
    vc = xcopy // itemsize if xcopy else 1
    nv = 1 + _cdiv(tw + 1, vc)
    rs = _cdiv(nv * vc * itemsize, 16) * 16 // itemsize
    # one raw row vector a thread, and the shared memory
    while nb > 0 and (nb * (th + 2) * nv > _THREADS or _smem(
            itemsize, nb, th, tw, rs, xcopy, fused, spade) > MAX_SMEM):
        nb -= 1
    if nb == 0:
        return None
    nch = _cdiv(cin, chunk(itemsize))
    cps = _cdiv(nch, min(split, nch))
    split = _cdiv(nch, cps)
    smem = _smem(itemsize, nb, th, tw, rs, xcopy, fused, spade)
    tiles = _cdiv(n, nb) * _cdiv(h, th) * _cdiv(w, tw)
    return ConvPlan((tiles, _cdiv(cout, _BM), split), nt, nb, th, tw, split,
                    cps, xcopy, rs, smem)


def _cost(plan: ConvPlan, outputs: int) -> float:
    """Waves x chunks a block x the chunk's cost, + the split partials."""
    occ = 2 if plan.nt == 2 and plan.smem <= _TWO_BLOCKS else 1
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    split = plan.split * outputs / 1e6 if plan.split > 1 else 0.0
    return (_cdiv(blocks, SM_COUNT * occ) * plan.cps * _CHUNK_COST[plan.nt]
            + _SPLIT_COST * split)


@functools.lru_cache(maxsize=4096)
def conv_plan(n: int, cin: int, h: int, w: int, cout: int, itemsize: int,
              fused: bool = False, spade: bool = False) -> ConvPlan:
    """Tiles, split-K and grid of one conv.

    Among pixel tiles of 256, 128, 64 and 32 (nt = 8, 4, 2, 2) with K split
    over Cin chunks 1, 2, 3, 4, 6 or 9 ways, the plan of least modelled time
    (:func:`_cost`) among those that launch a block for every SM. Where
    none fills the card, the 64-pixel tile
    is halved (fewer images, then fewer rows) with every chunk its own
    split until the card is full or the tile is one row."""
    plans = []
    for nt in (8, 4, 2):
        nb, th, tw = _geometry(n, h, w, nt)
        tiles = {(nb, th, tw)}
        if nt == 2:   # also half the tile, for two blocks an SM
            tiles.add((_cdiv(nb, 2), th, tw) if nb > 1 else
                      (nb, _cdiv(th, 2), tw))
        for tile, split in itertools.product(sorted(tiles), _SPLITS):
            plan = _tile_plan(n, cin, h, w, cout, itemsize, fused, spade,
                              nt, *tile, split)
            if plan is not None and plan.split == split and \
                    plan.grid[0] * plan.grid[1] * plan.grid[2] >= SM_COUNT:
                plans.append(plan)
    if plans:
        return min(plans, key=lambda p: (_cost(p, n * h * w * cout), p.nt))
    nb, th, tw = _geometry(n, h, w, 2)
    while True:
        plan = _tile_plan(n, cin, h, w, cout, itemsize, fused, spade, 2, nb,
                          th, tw, _cdiv(SM_COUNT, _cdiv(n, nb) * _cdiv(
                              h, th) * _cdiv(w, tw) * _cdiv(cout, _BM)))
        if plan is None:
            raise ValueError(f"conv3x3 kernel: no plan fits [{n}, {cin}, "
                             f"{h}, {w}] -> {cout}")
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        if blocks >= SM_COUNT or (plan.nb == 1 and th == 1):
            return plan
        if plan.nb > 1:
            nb = _cdiv(plan.nb, 2)
        else:
            th = _cdiv(th, 2)


def _lib() -> ctypes.CDLL:
    lib = library("conv3x3")
    if not getattr(lib, "_frido_typed", False):
        plan = [ctypes.c_int] * len(ConvPlan._fields[1:])
        for fn in (lib.frido_conv3x3_f32, lib.frido_conv3x3_bf16):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + plan \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.frido_conv3x3_norm_silu_f32,
                   lib.frido_conv3x3_norm_silu_bf16):
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
                ctypes.c_float] + plan + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.frido_conv3x3_error_string.argtypes = [ctypes.c_int]
        lib.frido_conv3x3_error_string.restype = ctypes.c_char_p
        lib._frido_typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where its first element is not 16-byte
    aligned (a view at an element offset): the kernels' 16-byte copies
    need it."""
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(x, weight, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or x.numel() == 0:
        raise ValueError(f"conv3x3 kernel takes x [N, Cin, H, W] and weight "
                         f"[Cout, Cin, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[0]
    if bias is None or tuple(weight.shape[1:]) != (x.shape[1], 3, 3) \
            or tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3 kernel: weight {tuple(weight.shape)} and "
                         f"bias {bias if bias is None else tuple(bias.shape)}"
                         f" do not fit x {tuple(x.shape)}")
    for t in (weight, bias):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("x, weight and bias must share dtype and device")
    xc, wc, bc = (_aligned(t) for t in (x, weight, bias))
    n, _, h, w = xc.shape
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    return xc, wc, bc, out


def _workspace(xc, cout, plan):
    """The packed weight [PARTS, 9, Cout, Cin8] (fp32: tf32 hi and lo) and
    the split-K partials (fp32; None without a split)."""
    n, cin, h, w = xc.shape
    per = 16 // xc.element_size()
    cinp = _cdiv(cin, per) * per
    parts = 2 if xc.dtype == torch.float32 else 1
    wp = torch.empty(parts * 9 * cout * cinp, dtype=xc.dtype,
                     device=xc.device)
    ws = None
    if plan.split > 1:
        ws = torch.empty(plan.split * n * cout * h * w, dtype=torch.float32,
                         device=xc.device)
    return wp, ws


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.frido_conv3x3_error_string(rc).decode())


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_conv(x, weight, bias):
    xc, wc, bc, out = _operands(x, weight, bias)
    n, cin, h, w = xc.shape
    cout = out.shape[1]
    plan = conv_plan(n, cin, h, w, cout, xc.element_size())
    wp, ws = _workspace(xc, cout, plan)
    lib = _lib()
    fn = (lib.frido_conv3x3_f32 if x.dtype == torch.float32
          else lib.frido_conv3x3_bf16)
    with device_context(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xc.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
                wp.data_ptr(), _ptr(ws), n, cin, h, w, cout, *plan.args,
                stream)
    _raise_on(lib, rc, "conv3x3")
    conv3x3.launches += 1
    return out


def _launch_fused(x, weight, bias, nscale, nbias, num_groups, eps, gamma,
                  beta):
    xc, wc, bc, out = _operands(x, weight, bias)
    n, cin, h, w = xc.shape
    cout = out.shape[1]
    if cin % num_groups:
        raise ValueError(f"channels {cin} not divisible by groups "
                         f"{num_groups}")
    if nscale.shape != (cin,) or nbias.shape != (cin,):
        raise ValueError(f"norm affine {tuple(nscale.shape)}, "
                         f"{tuple(nbias.shape)} for {cin} channels")
    spade = () if gamma is None else (gamma, beta)
    for t in (nscale, nbias, *spade):
        if t.device != x.device:
            raise ValueError("x, the norm affine and the SPADE tables must "
                             "share a device")
    nw, nb = (t.detach().float().contiguous() for t in (nscale, nbias))
    tables = (0, 0)
    if spade:
        if gamma.shape != xc.shape or beta.shape != xc.shape:
            raise ValueError(f"SPADE tables {tuple(gamma.shape)}, "
                             f"{tuple(beta.shape)} for x {tuple(xc.shape)}")
        gc, bt = (_aligned(t.to(x.dtype)) for t in spade)
        tables = (gc.data_ptr(), bt.data_ptr())
    plan = conv_plan(n, cin, h, w, cout, xc.element_size(), True,
                     bool(spade))
    wp, ws = _workspace(xc, cout, plan)
    stats = torch.empty((2, n, cin), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = (lib.frido_conv3x3_norm_silu_f32 if x.dtype == torch.float32
          else lib.frido_conv3x3_norm_silu_bf16)
    with device_context(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xc.data_ptr(), wc.data_ptr(), bc.data_ptr(), nw.data_ptr(),
                nb.data_ptr(), *tables, stats[0].data_ptr(),
                stats[1].data_ptr(), out.data_ptr(), wp.data_ptr(),
                _ptr(ws), n, cin, h, w, cout, num_groups, float(eps),
                *plan.args, stream)
    _raise_on(lib, rc, "conv3x3_norm_silu")
    conv3x3_norm_silu.launches += 1
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _launch_conv(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = conv3x3_plain(*inputs)
            return torch.autograd.grad(out, inputs, grad)


class _Conv3x3NormSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, nscale, nbias, gamma, beta, num_groups,
                eps):
        ctx.save_for_backward(x, weight, bias, nscale, nbias, gamma, beta)
        ctx.args = (num_groups, eps)
        return _launch_fused(x, weight, bias, nscale, nbias, num_groups, eps,
                             gamma, beta)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        with torch.enable_grad():
            x, weight, bias, nscale, nbias, gamma, beta = inputs
            out = conv3x3_norm_silu_plain(x, weight, bias, nscale, nbias,
                                          *ctx.args, gamma=gamma, beta=beta)
            live = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, live, grad))
        return (*(None if t is None else next(grads) for t in inputs),
                None, None)


def _wants_grad(*tensors) -> bool:
    """The kernel goes under autograd only where a gradient is wanted: the
    node costs host time on every call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _device_of(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 conv + bias of NCHW ``x``, fp32 accumulate,
    result in x's dtype. CUDA tensors go to the kernel (or raise); CPU
    tensors take :func:`conv3x3_plain`."""
    conv3x3.calls += 1
    if _device_of(x, "conv3x3") == "cpu":
        return conv3x3_plain(x, weight, bias)
    if _wants_grad(x, weight, bias):
        return _Conv3x3.apply(x, weight, bias)
    return _launch_conv(x, weight, bias)


conv3x3.calls = 0
conv3x3.launches = 0


def conv3x3_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, nscale: torch.Tensor,
                      nbias: torch.Tensor, num_groups: int, eps: float,
                      gamma: Optional[torch.Tensor] = None,
                      beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm (affine ``nscale``, ``nbias``) -> optional SPADE
    modulation by per-pixel ``gamma``, ``beta`` (both or neither) -> SiLU
    -> 3x3 conv + bias, as one op. CUDA tensors go to the kernels (or
    raise); CPU tensors take :func:`conv3x3_norm_silu_plain`."""
    if (gamma is None) != (beta is None):
        raise ValueError("SPADE gamma and beta come together")
    conv3x3_norm_silu.calls += 1
    if _device_of(x, "conv3x3_norm_silu") == "cpu":
        return conv3x3_norm_silu_plain(x, weight, bias, nscale, nbias,
                                       num_groups, eps, gamma, beta)
    if _wants_grad(x, weight, bias, nscale, nbias, gamma, beta):
        return _Conv3x3NormSilu.apply(x, weight, bias, nscale, nbias, gamma,
                                      beta, int(num_groups), float(eps))
    return _launch_fused(x, weight, bias, nscale, nbias, int(num_groups),
                         float(eps), gamma, beta)


conv3x3_norm_silu.calls = 0
conv3x3_norm_silu.launches = 0
