"""Sun raster reading without OpenCV: OpenCV 5.0's decoder (``grfmt_sunras.cpp``).

`decode` gives the RGB pixels ``cv2.imread(path, IMREAD_COLOR)`` gives (then
BGR->RGB). The 32-byte big-endian header (magic ``0x59a66a95``, width,
height, depth, length, type, map type, map length), then:

* types ``RT_OLD`` (0) and ``RT_STANDARD`` (1); OpenCV 5.0 reads nothing from
  ``RT_BYTE_ENCODED`` (2) or ``RT_FORMAT_RGB`` (3) files, so neither does
  this reader;
* depths 1 (0 black, 1 white without a map), 8, 24 (B, G, R) and 32 (X, B,
  G, R);
* ``RMT_NONE`` and ``RMT_EQUAL_RGB`` colour maps (all the reds, then the
  greens, then the blues; entries past the map black);
* rows padded to 16 bits.

Anything OpenCV reads nothing from raises `ValueError`.
"""

from __future__ import annotations

import struct

import numpy as np

NAME = "Sun raster"
SIGNATURE = b"\x59\xa6\x6a\x95"
_OLD, _STANDARD = 0, 1
_MAP_NONE, _MAP_EQUAL_RGB = 0, 1


def _header(data: bytes, path) -> dict:
    if len(data) < 32 or data[:4] != SIGNATURE:
        raise ValueError(f"{path}: not a Sun raster file")
    w, h, bpp, _, kind, maptype, maplength = struct.unpack(">iiiIIII", data[4:32])
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    ok = (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and kind in (_OLD, _STANDARD)
          and ((maptype == _MAP_NONE and maplength == 0)
               or (maptype == _MAP_EQUAL_RGB and 0 < maplength <= pal_size and bpp <= 8)))
    if not ok:
        raise ValueError(f"{path}: OpenCV does not read a {bpp}-bit Sun raster of type {kind}, "
                         f"map type {maptype} and map length {maplength}")
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        if len(data) < 32 + maplength:
            raise ValueError(f"{path}: the Sun raster colour map is cut short")
        n = maplength // 3
        palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
    elif bpp <= 8:
        palette[:1 << bpp] = (np.arange(1 << bpp) * 255 // ((1 << bpp) - 1))[:, None]
    return dict(w=w, h=h, bpp=bpp, palette=palette, offset=32 + maplength)


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``, OpenCV's pixels."""
    hdr = _header(data, path)
    w, h, bpp, palette = hdr["w"], hdr["h"], hdr["bpp"], hdr["palette"]
    src = np.frombuffer(data, np.uint8)[hdr["offset"]:]
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    if src.size < pitch * h:
        raise ValueError(f"{path}: the Sun raster data is cut short")
    rows = src[:pitch * h].reshape(h, pitch)
    if bpp == 1:
        return np.ascontiguousarray(palette[np.unpackbits(rows, axis=1)[:, :w]])
    if bpp == 8:
        return np.ascontiguousarray(palette[rows[:, :w]])
    if bpp == 32:
        return np.ascontiguousarray(rows[:, :4 * w].reshape(h, w, 4)[..., 3:0:-1])
    return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
