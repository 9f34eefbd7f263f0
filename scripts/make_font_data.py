"""Write ``quan_ultralytics_tpu_torch/utils/font_data.py``: the text metrics
and glyph bitmaps of the port's text raster (``utils/font.py``).

OpenCV 5.0 draws ``FONT_HERSHEY_SIMPLEX`` with a built-in outline font: a
regular face at thickness 0 or 1 and a bold one from thickness 2. A text
``scale`` is drawn at a pixel height ``H = floor(scale * 1000 / 37 + 0.5)``
(what ``cv2.getTextSize`` returns as the height), each character advances by
an integer that depends on ``H`` alone, and a text is as wide as its
advances plus one. This script records, for H = 1..200 and both faces, each
printable ASCII character's advance (``getTextSize`` of the character
repeated eleven times, less once), as the bits of its increments over H;
and each character's anti-aliased glyph at H = 27 (``putText`` at scale 1,
``LINE_AA``), cropped, with its offset from the pen, as 4-bit coverage.

Needs OpenCV 5 (``cv2``); run from the repository root:

    python scripts/make_font_data.py
"""

from __future__ import annotations

import base64
import zlib
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parents[1] / "quan_ultralytics_tpu_torch" / "utils" / "font_data.py"
CHARS = [chr(c) for c in range(32, 127)]
MAX_HEIGHT = 200
GLYPH_HEIGHT = 27  # the pixel height of scale 1
FACES = {"regular": 1, "bold": 2}  # face -> a thickness that selects it


def scale_for(height: int) -> float:
    return height * 37 / 1000.0


def advance_bits(thickness: int) -> bytes:
    rows = []
    for c in CHARS:
        adv = []
        for h in range(1, MAX_HEIGHT + 1):
            s = scale_for(h)
            (w11, hh), _ = cv2.getTextSize(c * 11, 0, s, thickness)
            (w1, _), _ = cv2.getTextSize(c, 0, s, thickness)
            assert hh == h and (w11 - w1) % 10 == 0 and w1 == (w11 - w1) // 10 + 1, (c, h)
            adv.append((w11 - w1) // 10)
        inc = np.diff(np.array([0] + adv))
        assert set(inc.tolist()) <= {0, 1}, c
        rows.append(np.packbits(inc.astype(np.uint8)))
    return np.concatenate(rows).tobytes()


def glyphs(thickness: int) -> bytes:
    out = bytearray()
    ox, oy = 32, 48
    for c in CHARS:
        canvas = np.zeros((96, 96), np.uint8)
        cv2.putText(canvas, c, (ox, oy), 0, 1.0, 255, thickness, cv2.LINE_AA)
        ys, xs = np.nonzero(canvas)
        if len(xs) == 0:
            out += bytes([128, 128, 0, 0])
            continue
        x0, y0, x1, y1 = xs.min(), ys.min(), xs.max() + 1, ys.max() + 1
        cov = np.rint(canvas[y0:y1, x0:x1] / 255.0 * 15).astype(np.uint8).reshape(-1)
        if len(cov) % 2:
            cov = np.append(cov, 0)
        out += bytes([x0 - ox + 128, y0 - oy + 128, x1 - x0, y1 - y0])
        out += ((cov[0::2] << 4) | cov[1::2]).astype(np.uint8).tobytes()
    return bytes(out)


def blob(data: bytes) -> str:
    text = base64.b64encode(zlib.compress(data, 9)).decode()
    return "\n".join(f'    "{text[i:i + 96]}"' for i in range(0, len(text), 96))


def main() -> None:
    parts = ['"""Text metrics and glyphs of the port\'s text raster, written by',
             "``scripts/make_font_data.py`` from OpenCV 5.0's FONT_HERSHEY_SIMPLEX (see",
             '``utils/font.py``). Generated: do not edit."""', "",
             f"MAX_HEIGHT = {MAX_HEIGHT}", f"GLYPH_HEIGHT = {GLYPH_HEIGHT}", ""]
    for face, th in FACES.items():
        parts.append(f"{face.upper()}_ADVANCE_BITS = (\n{blob(advance_bits(th))})")
        parts.append(f"{face.upper()}_GLYPHS = (\n{blob(glyphs(th))})")
    OUT.write_text("\n".join(parts) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
