"""The glyph table that ``utils/visualize.py`` draws text with.

    python -m frido_tpu_torch.tools.make_glyphs [--out FILE]

The JAX package renders captions and box labels with PIL's
``ImageDraw.text`` in PIL's default font (``ImageFont.load_default()``:
Aileron Regular at size 10 through FreeType, basic layout: no kerning, no
ligatures, whole-pixel advances). The card machine has no PIL, so this
command, run where PIL is, writes what that drawing needs into one
``.npz`` (default ``frido_tpu_torch/utils/glyphs.npz``):

- ``codepoints`` [G]: every code point whose glyph differs from
  ``.notdef`` (mask, offset or advance), ascending; the glyph of any
  other code point is ``.notdef``, the last entry of the arrays below;
- ``advance`` [G + 1]: the pen's advance in pixels (``getlength``);
- ``offset`` [G + 1, 2]: the glyph's coverage bitmap's top-left corner
  from the text origin, x and y (``getmask2``'s offset plus the bitmap's
  first non-zero column and row);
- ``size`` [G + 1, 2]: the bitmap's height and width, and ``start``
  [G + 1]: where it begins in ``bitmaps``, the coverage bytes of every
  bitmap, row-major, one after the other;
- ``line_spacing``: the step between the lines of multiline text,
  ``getbbox("A")[3]`` plus PIL's default spacing of 4.

It needs numpy and Pillow (the repository's table was written with Pillow
12.1 and FreeType 2.14); it scans every code point, about 40 s.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "utils", "glyphs.npz")
SPACING = 4        # ImageDraw.text's default line spacing


def _glyph(font, ch: str):
    """(advance, (x, y), bitmap) of one character, the bitmap cut to its
    non-zero rows and columns."""
    mask, (ox, oy) = font.getmask2(ch, "L")
    w, h = mask.size
    a = (np.array(mask, np.uint8).reshape(h, w) if w * h
         else np.zeros((0, 0), np.uint8))
    rows, cols = np.nonzero(a.any(1))[0], np.nonzero(a.any(0))[0]
    if not len(rows):
        a, x, y = np.zeros((0, 0), np.uint8), 0, 0
    else:
        a = a[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
        x, y = ox + int(cols[0]), oy + int(rows[0])
    return int(font.getlength(ch)), (x, y), a


def build(font) -> dict:
    """The table's arrays for ``font``."""
    notdef = _glyph(font, "\U0010fffd")     # a private-use code point
    cps, glyphs = [], []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF or cp == 0x0A:
            continue
        g = _glyph(font, chr(cp))
        if g[0] == notdef[0] and g[1] == notdef[1] and np.array_equal(
                g[2], notdef[2]):
            continue
        cps.append(cp)
        glyphs.append(g)
    glyphs.append(notdef)
    sizes = np.array([g[2].shape for g in glyphs], np.int32)
    counts = sizes.prod(1)
    return dict(
        codepoints=np.array(cps, np.int32),
        advance=np.array([g[0] for g in glyphs], np.int32),
        offset=np.array([g[1] for g in glyphs], np.int32),
        size=sizes,
        start=np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64),
        bitmaps=np.concatenate([g[2].reshape(-1) for g in glyphs]),
        line_spacing=np.int32(font.getbbox("A")[3] + SPACING))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    from PIL import ImageFont

    table = build(ImageFont.load_default())
    np.savez_compressed(args.out, **table)
    print(f"{len(table['codepoints'])} glyphs and .notdef -> {args.out}")


if __name__ == "__main__":
    main()
