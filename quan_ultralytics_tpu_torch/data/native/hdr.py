"""Radiance HDR (RGBE) reading without OpenCV: OpenCV 5.0's decoder
(``grfmt_hdr.cpp`` over ``rgbe.cpp``).

`decode` gives the RGB pixels ``cv2.imread(path, IMREAD_COLOR)`` gives (then
BGR->RGB):

* the header as ``RGBE_ReadHeader`` reads it: lines up to
  ``FORMAT=32-bit_rle_rgbe`` (a blank line before it fails), one blank line,
  then ``-Y <height> +X <width>``;
* the pixels as ``RGBE_ReadPixels_RLE`` reads them (``codecs.cpp``
  ``hdr_read_pixels``): new-style run-length scanlines, or flat RGBE from
  the first scanline that is not one (old-style run pixels are taken as
  pixels, as rgbe.cpp does);
* each RGBE quadruple as float32 ``m * 2^(e - 136)`` (0 where ``e`` is 0),
  times 255, rounded and saturated as ``convertTo(CV_8U, 255)`` does
  (`pxm.saturate_u8`: a value past int32 becomes 0). The file's channels are
  R, G, B.

Anything OpenCV reads nothing from raises `ValueError`.
"""

from __future__ import annotations

import re

import numpy as np

NAME = "Radiance HDR"
SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_SIZE = re.compile(rb"-Y ([-+]?\d+) \+X ([-+]?\d+)")


def _lines(data: bytes):
    """(line with its newline, position after) as fgets with a 128-byte buffer gives them."""
    at = 0
    while at < len(data):
        end = data.find(b"\n", at, at + 127)
        end = min(at + 127, len(data)) if end < 0 else end + 1
        yield data[at:end], end
        at = end


def _header(data: bytes, path):
    lines = _lines(data)
    for line, at in lines:
        if not line or line[:1] in (b"\0", b"\n"):
            raise ValueError(f"{path}: no FORMAT line in the Radiance header")
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            break
    else:
        raise ValueError(f"{path}: no FORMAT line in the Radiance header")
    blank = next(lines, (b"", 0))[0]
    if blank != b"\n":
        raise ValueError(f"{path}: no blank line after the Radiance FORMAT line")
    line, at = next(lines, (b"", 0))
    m = _SIZE.match(line)
    if m is None:
        raise ValueError(f"{path}: no '-Y h +X w' line in the Radiance header")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: a {w}x{h} Radiance image")
    return h, w, at


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``, OpenCV's pixels."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library
    from quan_ultralytics_tpu_torch.data.native.pxm import saturate_u8

    h, w, at = _header(data, path)
    src = np.frombuffer(data, np.uint8)[at:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    st = codecs_library().hdr_read_pixels(src.ctypes.data, src.size, w, h, rgbe.ctypes.data)
    if st:
        raise ValueError(f"{path}: " + ("the Radiance data ends early" if st == 2 else "bad scanline data"))
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0).astype(np.float32)
    px = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return saturate_u8(px * np.float32(255))
