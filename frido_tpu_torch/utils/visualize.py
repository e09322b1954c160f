"""Image helpers for the sampling CLI and the image logger (port of
``frido_tpu/utils/visualize.py``): ``to_uint8``, ``make_grid``,
``save_image``, ``COLOR_PALETTE``, ``log_txt_as_img`` and
``plot_bbox_conditioning``.

The JAX package draws with PIL, which the port does not need. PNGs: an
8-bit RGB (or grey) PNG is written here with the standard library's
``zlib`` and ``struct`` (one IDAT chunk, filter 0 on every row), and
:func:`read_png` reads such a file back. Text: PIL's default font
(Aileron Regular at size 10, FreeType, basic layout) is kept as a glyph
table, ``glyphs.npz`` beside this file (written by ``python -m
frido_tpu_torch.tools.make_glyphs`` where PIL is): each code point's
coverage bitmap, offset and advance, ``.notdef`` for every code point the
font lacks, and multiline text's line spacing. A line is drawn as PIL
draws it: each glyph's coverage composited over the line's mask at its
pen position (``a + b (255 - a) / 255`` in PIL's integer rounding), the
line's mask blended into the canvas with the ink
(``(c (255 - m) + ink m) / 255``, rounded alike), the origin's fractional
part moving the glyphs by PIL's 26.6 rounding; lines ``line_spacing``
apart. Rectangles are PIL's ``ImageDraw.rectangle(outline=, width=)``:
corners truncated to integers, bands of ``width`` pixels inside them.
The text and box renders equal PIL's at 0 levels
(``tests/test_torch_logging.py``).
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from itertools import cycle
from typing import Callable, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}          # channels -> PNG colour type
GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "glyphs.npz")

# seaborn tab10 (conditional_builder/utils.py:7-8)
COLOR_PALETTE = [(30, 118, 179), (255, 126, 13), (43, 159, 43),
                 (213, 38, 39), (147, 102, 188), (139, 85, 74),
                 (226, 118, 193), (126, 126, 126), (187, 188, 33),
                 (22, 189, 206)]


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


def _div255(a: np.ndarray) -> np.ndarray:
    """PIL's rounded division of a product of two bytes by 255."""
    t = a + 128
    return ((t >> 8) + t) >> 8


@functools.lru_cache(maxsize=1)
def _font():
    with np.load(GLYPHS) as z:
        table = {k: z[k] for k in z.files}
    table["index"] = {int(c): i for i, c in enumerate(table["codepoints"])}
    return table


def _bitmap(font, i: int) -> np.ndarray:
    h, w = font["size"][i]
    s = int(font["start"][i])
    return font["bitmaps"][s:s + h * w].reshape(h, w).astype(np.int64)


def _draw_line(canvas: np.ndarray, xy: Tuple[float, float], line: str,
               ink) -> None:
    """One line of text at ``xy`` (its left edge and ascender line) into
    a uint8 [H, W, 3] canvas, as ``ImageDraw.text``."""
    font = _font()
    notdef = len(font["codepoints"])
    glyphs = [font["index"].get(ord(ch), notdef) for ch in line]
    x0, y0 = int(xy[0]), int(xy[1])
    # the fraction of the origin, in 26.6 units, moves the pen by PIL's
    # rounding: x from half a pixel, y from just over half
    fx, fy = (int(np.floor(np.float32(v - int(v)) * np.float32(64) + 0.5))
              for v in xy)
    x0 += (fx + 32) >> 6
    y0 += (fy + 31) >> 6
    placed, pen = [], 0
    for i in glyphs:
        if font["size"][i].prod():
            ox, oy = font["offset"][i]
            placed.append((x0 + pen + int(ox), y0 + int(oy),
                           _bitmap(font, i)))
        pen += int(font["advance"][i])
    if not placed:
        return
    left = min(x for x, _, _ in placed)
    top = min(y for _, y, _ in placed)
    right = max(x + b.shape[1] for x, _, b in placed)
    bottom = max(y + b.shape[0] for _, y, b in placed)
    mask = np.zeros((bottom - top, right - left), np.int64)
    for x, y, b in placed:
        region = mask[y - top:y - top + b.shape[0],
                      x - left:x - left + b.shape[1]]
        region[...] = b + _div255(region * (255 - b))
    h, w = canvas.shape[:2]
    cy0, cy1 = max(top, 0), min(bottom, h)
    cx0, cx1 = max(left, 0), min(right, w)
    if cy0 >= cy1 or cx0 >= cx1:
        return
    m = mask[cy0 - top:cy1 - top, cx0 - left:cx1 - left, None]
    c = canvas[cy0:cy1, cx0:cx1].astype(np.int64)
    ink = np.asarray(ink, np.int64)
    canvas[cy0:cy1, cx0:cx1] = _div255(c * (255 - m) + ink * m).astype(
        np.uint8)


def draw_text(canvas: np.ndarray, xy: Tuple[float, float], text: str,
              ink=(0, 0, 0)) -> None:
    """``ImageDraw.text(xy, text, fill=ink)`` in PIL's default font, with
    its left-aligned multiline layout, into a uint8 [H, W, 3] canvas."""
    step = int(_font()["line_spacing"])
    for i, line in enumerate(text.split("\n")):
        _draw_line(canvas, (xy[0], xy[1] + i * step), line, ink)


def draw_rectangle(canvas: np.ndarray, box: Sequence[float], ink,
                   width: int = 1) -> None:
    """``ImageDraw.rectangle(box, outline=ink, width=width)`` into a uint8
    [H, W, 3] canvas, as PIL's C loop draws it: the corners truncated to
    integers; for each of ``width`` rings, the top and bottom rows, and the
    left and right columns as PIL's line from ``y0 + width`` toward
    ``y1 - width + 1``, that end excluded (a box lower than twice the
    width draws its columns past its bottom edge, as PIL's does); all
    clipped to the canvas."""
    x0, y0, x1, y1 = (int(v) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"rectangle {box}: x1 < x0 or y1 < y0")
    h, w = canvas.shape[:2]
    ink = np.asarray(ink, np.uint8)

    def fill(ya, yb, xa, xb):     # inclusive
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb,
                                                                    w - 1)
        if ya <= yb and xa <= xb:
            canvas[ya:yb + 1, xa:xb + 1] = ink

    width = max(width, 1)
    start, end = y0 + width, y1 - width + 1
    rows = (start, end - 1) if end >= start else (end + 1, start)
    for i in range(width):
        fill(y0 + i, y0 + i, x0, x1)
        fill(y1 - i, y1 - i, x0, x1)
        fill(*rows, x1 - i, x1 - i)
        fill(*rows, x0 + i, x0 + i)


def _to_float(canvas: np.ndarray) -> np.ndarray:
    return canvas.astype(np.float32) / 127.5 - 1.0


def log_txt_as_img(wh: Tuple[int, int], texts: Sequence,
                   size: int = 10) -> np.ndarray:
    """Captions on white canvases of ``wh`` (width, height), wrapped every
    ``int(40 * width / 256)`` characters -> [B, H, W, 3] in [-1, 1]; a
    list or tuple is drawn as its repr without the brackets. ``size`` is
    unused: the JAX package draws in PIL's default font too."""
    out = []
    for txt in texts:
        canvas = np.full((wh[1], wh[0], 3), 255, np.uint8)
        if isinstance(txt, (list, tuple)):
            txt = "{}".format(txt)[1:-1]
        txt = str(txt)
        nc = int(40 * (wh[0] / 256))
        draw_text(canvas, (0, 0),
                  "\n".join(txt[i:i + nc] for i in range(0, len(txt), nc)))
        out.append(_to_float(canvas))
    return np.stack(out)


def plot_bbox_conditioning(builder, conditional: np.ndarray,
                           label_for_category_no: Callable[[int], str],
                           figure_size: Tuple[int, int],
                           line_width: int = 3) -> np.ndarray:
    """An ``objects_bbox`` token sequence drawn as its boxes in
    ``COLOR_PALETTE``, each with its label inside its top-left corner, and
    the crop in grey, on a white canvas of ``figure_size`` -> [H, W, 3] in
    [-1, 1] (``objects_bbox.py:42-60``)."""
    width, height = figure_size
    canvas = np.full((height, width, 3), 255, np.uint8)
    objs, crop = builder.inverse_build(conditional)
    for (rep, bbox), color in zip(objs, cycle(COLOR_PALETTE)):
        ann = builder.representation_to_annotation(rep)
        label = label_for_category_no(ann.category_no)
        ab = (bbox[0] * width, bbox[1] * height,
              (bbox[0] + bbox[2]) * width, (bbox[1] + bbox[3]) * height)
        draw_rectangle(canvas, ab, color, line_width)
        draw_text(canvas, (ab[0] + line_width, ab[1] + line_width), label)
    if crop is not None:
        draw_rectangle(canvas, (crop[0] * width, crop[1] * height,
                                (crop[0] + crop[2]) * width,
                                (crop[1] + crop[3]) * height),
                       (63, 63, 63), line_width)
    return _to_float(canvas)
