"""Image files -> uint8 RGB pixels on a device.

The port's counterpart of PIL's ``Image.open(path).convert("RGB")`` in the
JAX data layer and of ``native_loader.jpeg_dims`` / ``load_one``'s decode:

- :func:`image_size`: (width, height) from the header, without decoding:
  a JPEG's SOF segment (baseline, extended or progressive) or a PNG's
  IHDR;
- :func:`decode_png`: an 8-bit, non-interlaced PNG (grey, RGB, palette,
  with or without alpha, every row filter) through ``zlib`` on the host,
  alpha dropped as ``convert("RGB")`` drops it;
- :func:`load_rgb`: a file to uint8 [H, W, 3] on ``device``. A JPEG on a
  CUDA device goes through nvJPEG (``ops/cuda/jpeg.py``); on the CPU
  through PIL, imported inside that branch only: that is the plain
  version the tests hold the card to. A grey image becomes RGB; a CMYK
  or YCCK (four-component) file is converted as PIL converts it. A JPEG
  of another number of components is refused on every device with the
  file's name; nothing falls back to another decoder;
- :func:`jpeg_layout`: the components, sampling factors and colour space
  (libjpeg's reading of the JFIF and Adobe markers) from the header.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_PNG = b"\x89PNG\r\n\x1a\n"
# start-of-frame markers: baseline, extended, progressive (Huffman)
_SOF = (0xC0, 0xC1, 0xC2)
_NO_LENGTH = {0x01, 0xD8, *range(0xD0, 0xD8)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples


class JpegLayout(NamedTuple):
    """What a JPEG's markers up to its first scan say: its size, its
    components (id, horizontal and vertical sampling factors), whether a
    JFIF (APP0) segment was seen, the Adobe (APP14) transform (None
    without that segment), and the colour space libjpeg decodes it as."""
    width: int
    height: int
    components: Tuple[Tuple[int, int, int], ...]
    jfif: bool
    adobe_transform: Optional[int]
    colorspace: str


def _colorspace(comps, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's guess of the coded colour space (``jdapimin.c``,
    ``default_decompress_parms``): 'grey', 'ycbcr', 'rgb', 'cmyk',
    'ycck', or 'components=N' for a count it does not name."""
    n = len(comps)
    if n == 1:
        return "grey"
    if n == 3:
        if jfif:
            return "ycbcr"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycbcr"
        ids = tuple(c[0] for c in comps)
        return "rgb" if ids == (82, 71, 66) else "ycbcr"   # 'R', 'G', 'B'
    if n == 4:
        if adobe is not None:
            return "cmyk" if adobe == 0 else "ycck"
        return "cmyk"
    return f"components={n}"


def jpeg_layout(data: bytes, name: str = "<bytes>") -> JpegLayout:
    """The :class:`JpegLayout` of a JPEG file's bytes."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name} is not a JPEG")
    pos, frame, jfif, adobe = 2, None, False, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                    # fill byte
            pos += 1
            continue
        if marker in _NO_LENGTH:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker in _SOF and frame is None:
            h, w, n = struct.unpack(">HHB", body[1:6])
            comps = tuple((body[6 + 3 * i], body[7 + 3 * i] >> 4,
                           body[7 + 3 * i] & 15) for i in range(n))
            frame = (w, h, comps)
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:                  # the first scan
            break
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"{name}: JPEG process SOF{marker - 0xC0} is "
                             f"not decoded (baseline, extended or "
                             f"progressive only)")
        pos += 2 + length
    if frame is None:
        raise ValueError(f"{name}: no JPEG frame header")
    w, h, comps = frame
    return JpegLayout(w, h, comps, jfif, adobe,
                      _colorspace(comps, jfif, adobe))


def jpeg_header(data: bytes, name: str = "<bytes>") -> Tuple[int, int, int]:
    """(width, height, components) from a JPEG's start-of-frame segment."""
    layout = jpeg_layout(data, name)
    return layout.width, layout.height, len(layout.components)


def _png_chunks(data: bytes, name: str):
    if not data.startswith(_PNG):
        raise ValueError(f"{name} is not a PNG")
    pos = len(_PNG)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        yield data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n


def image_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) from a JPEG's or a PNG's header."""
    if data.startswith(_PNG):
        for kind, body in _png_chunks(data, name):
            if kind == b"IHDR":
                return struct.unpack(">II", body[:8])
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, _ = jpeg_header(data, name)
    return w, h


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:                       # Sub: a running sum per byte
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            up = prev.tolist()
            vals = line.tolist()
            c = cur.tolist()
            for x in range(stride):
                a = c[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[x - bpp] if x >= bpp else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                c[x] = (vals[x] + pred) & 255
            cur = np.asarray(c, np.int32)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit non-interlaced PNG -> uint8 [H, W, 3] (``convert("RGB")``:
    grey repeated, the palette looked up, alpha dropped)."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise ValueError(f"{name}: only 8-bit, non-interlaced PNGs are read "
                         f"(depth {depth}, colour type {color}, interlace "
                         f"{interlace})")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        return palette[px[..., 0]]
    if c in (1, 2):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _decode_jpeg_cpu(data: bytes, name: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"decoding {name} on the CPU needs PIL, which is not installed; "
            f"on the card nvJPEG decodes it (device='cuda')") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def load_rgb(path, device) -> torch.Tensor:
    """A JPEG or PNG file -> uint8 [H, W, 3] on ``device``."""
    name = str(path)
    with open(path, "rb") as f:
        data = f.read()
    device = torch.device(device)
    if data.startswith(_PNG):
        return torch.from_numpy(decode_png(data, name)).to(device)
    comps = len(jpeg_layout(data, name).components)
    if comps not in (1, 3, 4):
        raise RuntimeError(f"{name}: a JPEG of {comps} components is not "
                           f"decoded (1, 3 or 4 only)")
    if device.type == "cuda":
        from frido_tpu_torch.ops.cuda.jpeg import decode_jpeg

        return decode_jpeg(data, device, name)
    if device.type != "cpu":
        raise ValueError(f"no JPEG decoder for {device}")
    return torch.from_numpy(_decode_jpeg_cpu(data, name).copy())
