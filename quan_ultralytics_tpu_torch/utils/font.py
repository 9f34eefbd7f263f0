"""Text for the port's plots without OpenCV: ``cv2.getTextSize`` and
``cv2.putText`` of ``FONT_HERSHEY_SIMPLEX``.

OpenCV 5.0 draws that font with a built-in outline face, regular at
thickness 0 or 1 and bold from 2. A ``scale`` is drawn at the pixel height
``H = floor(scale * 1000 / 37 + 0.5)``; each character advances by an integer
that depends on ``H`` only, and a text is as wide as its advances plus one.
`text_size` reproduces ``getTextSize``'s width and height exactly from the
advance tables of ``font_data`` (printable ASCII, H = 1..200; other
characters are measured as ``?``). `put_text` places each glyph where
OpenCV's pen puts it, but draws it from a bitmap recorded at H = 27 and
resampled: the glyph pixels are close to OpenCV's, not equal to them.
"""

from __future__ import annotations

import base64
import math
import zlib
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np

from quan_ultralytics_tpu_torch.utils import font_data

FIRST, LAST = 32, 126
N_CHARS = LAST - FIRST + 1


def _face(thickness: int) -> str:
    return "BOLD" if thickness >= 2 else "REGULAR"


def text_height(scale: float) -> int:
    """The pixel height OpenCV draws ``scale`` at (``getTextSize``'s height)."""
    return int(math.floor(scale * 1000.0 / 37.0 + 0.5))


@lru_cache(maxsize=None)
def _advances(face: str) -> np.ndarray:
    """``[N_CHARS, MAX_HEIGHT + 1]`` integer advances (column 0: height 0)."""
    raw = zlib.decompress(base64.b64decode(getattr(font_data, f"{face}_ADVANCE_BITS")))
    bits = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(N_CHARS, -1)[:, :font_data.MAX_HEIGHT]
    return np.concatenate([np.zeros((N_CHARS, 1), np.int64), np.cumsum(bits, axis=1)], axis=1)


@lru_cache(maxsize=None)
def _glyphs(face: str) -> Dict[int, Tuple[int, int, np.ndarray]]:
    """code -> (x offset from the pen, y offset from the baseline, coverage [h, w] in 0..1) at H = 27."""
    raw = zlib.decompress(base64.b64decode(getattr(font_data, f"{face}_GLYPHS")))
    out, at = {}, 0
    for code in range(FIRST, LAST + 1):
        x0, y0, w, h = raw[at] - 128, raw[at + 1] - 128, raw[at + 2], raw[at + 3]
        at += 4
        n = (w * h + 1) // 2
        packed = np.frombuffer(raw[at:at + n], np.uint8)
        at += n
        cov = np.stack([packed >> 4, packed & 15], axis=1).reshape(-1)[:w * h]
        out[code] = (x0, y0, cov.reshape(h, w).astype(np.float32) / 15.0)
    return out


def _codes(text: str) -> np.ndarray:
    codes = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int64)
    return np.where((codes >= FIRST) & (codes <= LAST), codes, ord("?")) - FIRST


def text_size(text: str, scale: float, thickness: int = 1) -> Tuple[int, int]:
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness)[0]``: (width, height)."""
    if not text:
        return 0, 0
    h = text_height(scale)
    if not 0 <= h <= font_data.MAX_HEIGHT:
        raise ValueError(f"scale {scale}: text height {h} px is outside 0..{font_data.MAX_HEIGHT}")
    return int(_advances(_face(thickness))[_codes(text), h].sum()) + 1, h


def put_text(im: np.ndarray, text: str, org: Sequence[int], scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """``cv2.putText(im, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, LINE_AA)`` in place on a uint8 ``[h, w]`` or ``[h, w, 3]``
    image: ``org`` is the left end of the baseline. Each glyph is its
    H = 27 coverage resampled bilinearly to the text's height and blended
    over the image."""
    h = text_height(scale)
    if not text or h <= 0:
        return im
    face = _face(thickness)
    adv = _advances(face)[:, min(h, font_data.MAX_HEIGHT)]
    glyphs = _glyphs(face)
    f = h / font_data.GLYPH_HEIGHT
    color = np.resize(np.asarray(color, np.float32), im.shape[2] if im.ndim == 3 else 1)
    pen = float(org[0])
    for code in _codes(text):
        x0, y0, cov = glyphs[int(code) + FIRST]
        if cov.size:
            _blend(im, cov, pen + x0 * f, float(org[1]) + y0 * f, f, color)
        pen += float(adv[code])
    return im


def _blend(im: np.ndarray, cov: np.ndarray, gx: float, gy: float, f: float, color: np.ndarray) -> None:
    """Blend ``color`` over ``im`` with the coverage ``cov`` scaled by ``f`` and
    placed with its top-left corner at (gx, gy)."""
    gh, gw = cov.shape
    tx0, ty0 = max(int(math.floor(gx)), 0), max(int(math.floor(gy)), 0)
    tx1 = min(int(math.ceil(gx + gw * f)), im.shape[1])
    ty1 = min(int(math.ceil(gy + gh * f)), im.shape[0])
    if tx1 <= tx0 or ty1 <= ty0:
        return
    pad = np.pad(cov, 1)
    sx = (np.arange(tx0, tx1) + 0.5 - gx) / f - 0.5 + 1
    sy = (np.arange(ty0, ty1) + 0.5 - gy) / f - 0.5 + 1
    sx = np.clip(sx, 0, gw + 1 - 1e-6)
    sy = np.clip(sy, 0, gh + 1 - 1e-6)
    ix, iy = np.minimum(sx.astype(np.int64), gw), np.minimum(sy.astype(np.int64), gh)
    fx, fy = (sx - ix)[None, :], (sy - iy)[:, None]
    a = (pad[iy][:, ix] * (1 - fx) + pad[iy][:, ix + 1] * fx) * (1 - fy) \
        + (pad[iy + 1][:, ix] * (1 - fx) + pad[iy + 1][:, ix + 1] * fx) * fy
    region = im[ty0:ty1, tx0:tx1].astype(np.float32)
    if im.ndim == 3:
        a = a[..., None]
    region += (color - region) * a
    im[ty0:ty1, tx0:tx1] = np.clip(np.rint(region), 0, 255).astype(np.uint8)
