"""Image helpers for the sampling CLI (port of
``frido_tpu/utils/visualize.py:23-28,46-60,87-88``): ``to_uint8``,
``make_grid`` and ``save_image``.

The JAX package writes PNGs with PIL, which the port does not need: an
8-bit RGB (or grey) PNG is written here with the standard library's
``zlib`` and ``struct`` (one IDAT chunk, filter 0 on every row), and
:func:`read_png` reads such a file back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}          # channels -> PNG colour type


def to_uint8(x) -> np.ndarray:
    """[-1, 1] float -> uint8, ``clip((x + 1) * 127.5)`` truncated."""
    return np.clip((np.asarray(x, np.float32) + 1) * 127.5, 0, 255).astype(
        np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8,
              pad: int = 2) -> np.ndarray:
    """[N, H, W, C] -> one grid image, ``nrow`` a row, ``pad`` pixels of
    1.0 (white) between and around."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full(((h + pad) * nrows + pad, (w + pad) * ncol + pad, c),
                   1.0, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(pixels: np.ndarray, path: str) -> None:
    """uint8 [H, W, 3], [H, W, 1] or [H, W] -> an 8-bit PNG file."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"write_png takes 1 or 3 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG that :func:`write_png` wrote (8-bit, not interlaced, filter 0)
    -> uint8 [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = len(_SIGNATURE), b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color, _, _, interlace = header
    c = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or c is None or interlace:
        raise ValueError(f"{path}: only 8-bit grey/RGB, not interlaced")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter type 0 is read")
    return rows[:, 1:].reshape(h, w, c).copy()


def save_image(arr, path: str) -> None:
    """A [-1, 1] float image [H, W, C] to a PNG file."""
    write_png(to_uint8(arr), path)
