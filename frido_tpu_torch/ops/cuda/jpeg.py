"""JPEG decode on the card through nvJPEG (``csrc/jpeg_decode.cu``).

The port's counterpart of the libjpeg decode of ``native/frido_native.cpp``
(``decode_jpeg``), which is not a TPU kernel. nvJPEG decodes the coded
planes on the card (its hybrid backend decodes the Huffman stream on the
host and runs the inverse DCT on the card; progressive files included).
The chroma upsampling and the YCbCr -> RGB conversion then run here, as
tensor ops on the card, in libjpeg's integer arithmetic (``jdsample.c``'s
"fancy" triangle upsampling for 2:1 factors, ``jdcolor.c``'s fixed-point
conversion), so the pixels are libjpeg's, and PIL's, up to the inverse
DCT's rounding; nvJPEG's own upsampling and conversion differ from them
by up to 4 levels on a 4:4:4 file and tens of levels at colour edges of
a 4:2:0 one. One image per call, on the caller's current stream.

:func:`decode_jpeg` takes the file's bytes and gives uint8 [H, W, 3] RGB;
a grey (one-component) file is decoded as its one plane and repeated into
the three channels, as PIL's ``convert("RGB")`` does. A four-component
file is decoded as its four coded planes, which are taken as libjpeg
takes them (CMYK, or YCCK after an Adobe marker with transform 2) and
converted as PIL converts CMYK, Adobe-inverted data included
(:func:`planes_to_rgb`). Anything else (another component count, a
layout nvJPEG refuses) raises with the file's name: there is no other
decoder behind this one. :func:`decode_planes` gives the coded planes
alone; :func:`upsample_plane`, :func:`full_planes`, :func:`ycc_to_rgb`,
:func:`cmyk_to_rgb` and :func:`planes_to_rgb` are device-agnostic.
``decode_jpeg.launches`` counts nvJPEG decodes.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from frido_tpu_torch.ops.cuda.build import (device_context, library,
                                            raw_stream)

# nvjpegStatus_t
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
           4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE",
           6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
           9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM",
           -1: "a layout this decoder refuses (not 1, 3 or 4 components, "
               "or an unknown chroma layout)"}
# nvjpegChromaSubsampling_t
SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0", 4: "4:1:1",
               5: "4:1:0", 6: "grey", 7: "4:1:0V", -1: "unknown"}


def _lib() -> ctypes.CDLL:
    lib = library("jpeg_decode")
    if not getattr(lib, "_frido_typed", False):
        lib.fj_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.fj_info.restype = ctypes.c_int
        lib.fj_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.fj_decode.restype = ctypes.c_int
        lib._frido_typed = True
    return lib


def _status(rc: int) -> str:
    return _STATUS.get(rc, f"status {rc}")


def jpeg_info(data: bytes, name: str = "<bytes>"
              ) -> Tuple[int, str, List[Tuple[int, int]]]:
    """(components, chroma layout, each component's plane (width,
    height)) as nvJPEG reads the header; the first plane's size is the
    image's."""
    comps, css = ctypes.c_int(), ctypes.c_int()
    widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    rc = _lib().fj_info(data, len(data), ctypes.byref(comps),
                        ctypes.byref(css), widths, heights)
    if rc != 0:
        raise RuntimeError(f"nvJPEG cannot read the header of {name}: "
                           f"{_status(rc)}")
    n = comps.value
    return n, SUBSAMPLING.get(css.value, str(css.value)), \
        [(widths[c], heights[c]) for c in range(min(max(n, 0), 4))]


def _edge_shift(p: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """``p`` moved by one along ``dim`` (step -1: each element's
    predecessor, +1: its successor), the edge element repeated."""
    n = p.shape[dim]
    if step < 0:
        return torch.cat([p.narrow(dim, 0, 1), p.narrow(dim, 0, n - 1)], dim)
    return torch.cat([p.narrow(dim, 1, n - 1), p.narrow(dim, n - 1, 1)], dim)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim``."""
    out = torch.stack([a, b], dim + 1)
    shape = list(a.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def upsample_plane(p: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """A chroma plane (int32 [h, w]) upsampled by (hs, vs) as libjpeg-turbo
    upsamples it with ``do_fancy_upsampling``: the triangle filters of
    ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample`` and
    ``h2v2_fancy_upsample`` with their alternating rounding biases (the
    2:1 horizontal ones only for planes wider than 2), edges repeated,
    and plain replication for other factors."""
    h, w = p.shape
    if (hs, vs) == (1, 1):
        return p
    if (hs, vs) == (2, 1) and w > 2:
        return _interleave((3 * p + _edge_shift(p, 1, -1) + 1) >> 2,
                           (3 * p + _edge_shift(p, 1, 1) + 2) >> 2, 1)
    if (hs, vs) == (1, 2):
        return _interleave((3 * p + _edge_shift(p, 0, -1) + 1) >> 2,
                           (3 * p + _edge_shift(p, 0, 1) + 2) >> 2, 0)
    if (hs, vs) == (2, 2) and w > 2:
        rows = []
        for near in (_edge_shift(p, 0, -1), _edge_shift(p, 0, 1)):
            c = 3 * p + near                    # the column sums
            rows.append(_interleave((3 * c + _edge_shift(c, 1, -1) + 8) >> 4,
                                    (3 * c + _edge_shift(c, 1, 1) + 7) >> 4,
                                    1))
        return _interleave(rows[0], rows[1], 0)
    return p.repeat_interleave(vs, 0).repeat_interleave(hs, 1)


# jdcolor.c's fixed-point constants: FIX(x) = round(x * 2^16)
_FIX_R_CR, _FIX_G_CB, _FIX_G_CR, _FIX_B_CB = 91881, 22554, 46802, 116130


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
               cr: torch.Tensor) -> torch.Tensor:
    """Full-size int32 Y, Cb, Cr planes -> uint8 [H, W, 3], libjpeg's
    ``ycc_rgb_convert`` (JFIF YCbCr, arithmetic right shifts)."""
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_FIX_R_CR * cr + half) >> 16)
    g = y + ((half - _FIX_G_CB * cb - _FIX_G_CR * cr) >> 16)
    b = y + ((_FIX_B_CB * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def cmyk_to_rgb(c: torch.Tensor, m: torch.Tensor, y: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """Full-size int32 C, M, Y, K planes -> uint8 [H, W, 3], as PIL's
    ``convert("RGB")`` converts CMYK (``Convert.c``, ``cmyk2rgb``): each
    channel ``nk - nk * x / 255`` with ``nk = 255 - k``, the product
    rounded by PIL's ``MULDIV255``."""
    nk = 255 - k
    out = []
    for x in (c, m, y):
        t = x * nk + 128
        out.append(nk - (((t >> 8) + t) >> 8))
    return torch.stack(out, -1).clamp_(0, 255).to(torch.uint8)


def planes_to_rgb(planes: List[torch.Tensor], colorspace: str,
                  adobe: bool) -> torch.Tensor:
    """Full-size int32 coded planes -> uint8 [H, W, 3] as libjpeg decodes
    and PIL converts them: grey repeated; YCbCr through ``ycc_to_rgb``;
    RGB as coded; CMYK as coded, YCCK through libjpeg's
    ``ycck_cmyk_convert`` (YCbCr to RGB, each inverted, K kept); then,
    after an Adobe marker, inverted again (PIL reads such a file as
    ``CMYK;I``) and converted by :func:`cmyk_to_rgb`."""
    if colorspace == "grey":
        g = planes[0].clamp(0, 255).to(torch.uint8)
        return g[..., None].expand(*g.shape, 3).contiguous()
    if colorspace == "ycbcr":
        return ycc_to_rgb(*planes)
    if colorspace == "rgb":
        return torch.stack(planes, -1).clamp_(0, 255).to(torch.uint8)
    if colorspace not in ("cmyk", "ycck"):
        raise ValueError(f"no conversion from {colorspace}")
    if colorspace == "ycck":
        cmy = 255 - ycc_to_rgb(*planes[:3]).to(torch.int32)
        planes = list(cmy.unbind(-1)) + [planes[3]]
    if adobe:
        planes = [255 - p for p in planes]
    return cmyk_to_rgb(*planes)


def decode_planes(data: bytes, device: torch.device,
                  name: str = "<bytes>") -> List[torch.Tensor]:
    """A JPEG file's coded planes on the CUDA ``device``, as the inverse
    DCT leaves them: uint8 Y [H, W], and for a colour file Cb and Cr at
    their own sizes; for a four-component file (CMYK, YCCK) or an RGB one
    the components as coded (``NVJPEG_OUTPUT_UNCHANGED``)."""
    from frido_tpu_torch.data.image_io import jpeg_layout

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_jpeg decodes on the card, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    comps, css, sizes = jpeg_info(data, name)
    if comps not in (1, 3, 4) or (comps != 4 and css == "unknown"):
        raise RuntimeError(f"nvJPEG cannot decode {name}: {comps} "
                           f"components, chroma layout {css}")
    unchanged = comps == 4 or jpeg_layout(data, name).colorspace == "rgb"
    full = max(w * h for w, h in sizes)
    # each plane in a buffer of the largest plane's size, so that a
    # decode that wrote a component at another size than fj_info's could
    # not write past it (the checks against PIL's pixels would show it)
    bufs = [torch.empty(full, dtype=torch.uint8, device=device)
            for _ in sizes]
    ptrs = [b.data_ptr() for b in bufs] + [0] * (4 - comps)
    with device_context(device):
        rc = _lib().fj_decode(data, len(data), *ptrs, comps, int(unchanged),
                              raw_stream(device))
    if rc != 0:
        raise RuntimeError(f"nvJPEG cannot decode {name}: {_status(rc)}")
    decode_jpeg.launches += 1
    return [b[:h * w].view(h, w) for b, (w, h) in zip(bufs, sizes)]


def full_planes(planes: List[torch.Tensor], layout,
                name: str = "<bytes>") -> List[torch.Tensor]:
    """Coded planes -> int32 planes at the image's size, each upsampled by
    its component's sampling factors as libjpeg upsamples it."""
    hmax = max(c[1] for c in layout.components)
    vmax = max(c[2] for c in layout.components)
    w, h = layout.width, layout.height
    out = []
    for p, (_, hc, vc) in zip(planes, layout.components):
        hs, vs = hmax // hc, vmax // vc
        ph, pw = p.shape
        if (pw, ph) != (-(-w * hc // hmax), -(-h * vc // vmax)):
            raise RuntimeError(f"{name}: a {pw}x{ph} plane of a {w}x{h} "
                               f"image at sampling {hc}x{vc} of "
                               f"{hmax}x{vmax}")
        out.append(upsample_plane(p.to(torch.int32), hs, vs)[:h, :w])
    return out


def decode_jpeg(data: bytes, device: torch.device,
                name: str = "<bytes>") -> torch.Tensor:
    """A JPEG file's bytes -> uint8 [H, W, 3] RGB on the CUDA ``device``."""
    from frido_tpu_torch.data.image_io import jpeg_layout

    layout = jpeg_layout(data, name)
    planes = full_planes(decode_planes(data, device, name), layout, name)
    return planes_to_rgb(planes, layout.colorspace,
                         layout.adobe_transform is not None)


decode_jpeg.launches = 0
