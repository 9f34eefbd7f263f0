"""GIF reading without OpenCV: the first frame as OpenCV 5.0's decoder
(``grfmt_gif.cpp``) composes it.

`decode` gives the RGB pixels ``cv2.imread(path, IMREAD_COLOR)`` gives (then
BGR->RGB):

* GIF87a and GIF89a; the logical screen's size; the global colour table and
  each image's local one; extension blocks (a graphic-control extension's
  transparent index; comment, application and plain-text blocks skipped);
* the first image's LZW data (``codecs.cpp`` ``gif_lzw_decode``: code sizes
  2-8, clear and end codes, the full 4,096-entry table), interlaced rows
  put back in order;
* the canvas as OpenCV composes it: the screen filled with the global
  table's background colour, the image at its offset, its transparent pixels
  left at the background.

Later frames are not read, as ``cv2.imread`` returns the first. A file
OpenCV reads nothing from (an image outside the screen, an index past its
colour table, LZW data that stops short) raises `ValueError`.
"""

from __future__ import annotations

import struct

import numpy as np

NAME = "GIF"
SIGNATURES = (b"GIF87a", b"GIF89a")


def _sub_blocks(data: bytes, at: int, path) -> tuple:
    """The bytes of the data sub-blocks at ``at`` and the position after their terminator."""
    parts = []
    while True:
        if at >= len(data):
            raise ValueError(f"{path}: the GIF data ends inside a block")
        n = data[at]
        at += 1
        if n == 0:
            return b"".join(parts), at
        parts.append(data[at:at + n])
        at += n


def _table(data: bytes, at: int, flags: int, path) -> tuple:
    if not flags & 0x80:
        return None, at
    n = 2 << (flags & 7)
    if len(data) < at + 3 * n:
        raise ValueError(f"{path}: a GIF colour table is cut short")
    return np.frombuffer(data, np.uint8, 3 * n, at).reshape(n, 3), at + 3 * n


def _interlaced(h: int) -> np.ndarray:
    """The row of the image that each stored row of an interlaced GIF fills."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``, OpenCV's pixels."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    if len(data) < 13 or data[:6] not in SIGNATURES:
        raise ValueError(f"{path}: not a GIF file")
    sw, sh, flags, bg = struct.unpack("<HHBB", data[6:12])
    if sw == 0 or sh == 0:
        raise ValueError(f"{path}: a {sw}x{sh} GIF screen")
    gct, at = _table(data, 13, flags, path)
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if gct is not None:
        if bg >= len(gct):
            raise ValueError(f"{path}: a GIF background index past its colour table")
        canvas[:] = gct[bg]
    transparent = None
    while True:
        if at >= len(data):
            raise ValueError(f"{path}: a GIF without an image")
        kind = data[at]
        at += 1
        if kind == 0x21:  # extension
            if at >= len(data):
                raise ValueError(f"{path}: the GIF data ends inside an extension")
            label = data[at]
            body, at = _sub_blocks(data, at + 1, path)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: a GIF without an image")
        if len(data) < at + 9:
            raise ValueError(f"{path}: a GIF image descriptor is cut short")
        x, y, w, h, iflags = struct.unpack("<HHHHB", data[at:at + 9])
        lct, at = _table(data, at + 9, iflags, path)
        break
    palette = lct if lct is not None else gct
    if palette is None:
        raise ValueError(f"{path}: a GIF image without a colour table")
    if x + w > sw or y + h > sh or w == 0 or h == 0:
        raise ValueError(f"{path}: a {w}x{h} GIF image at ({x}, {y}) outside its {sw}x{sh} screen")
    if at >= len(data) or not 2 <= data[at] <= 8:
        raise ValueError(f"{path}: a GIF LZW code size outside 2-8")
    min_size = data[at]
    lzw, at = _sub_blocks(data, at + 1, path)
    src = np.frombuffer(lzw, np.uint8)
    idx = np.zeros(w * h, np.uint8)
    n = codecs_library().gif_lzw_decode(src.ctypes.data, src.size, min_size, idx.ctypes.data, idx.size)
    if n < idx.size:
        raise ValueError(f"{path}: bad or short GIF LZW data")
    idx = idx.reshape(h, w)
    if iflags & 0x40:
        rows = np.empty_like(idx)
        rows[_interlaced(h)] = idx
        idx = rows
    if int(idx.max()) >= len(palette):
        raise ValueError(f"{path}: a GIF index past its colour table")
    region = canvas[y:y + h, x:x + w]
    pixels = palette[idx]
    if transparent is not None:
        pixels = np.where((idx == transparent)[..., None], region, pixels)
    canvas[y:y + h, x:x + w] = pixels
    return canvas
