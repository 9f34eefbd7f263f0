"""WebP reading and lossless writing without OpenCV or libwebp.

`decode` gives the RGB pixels of ``cv2.imread(path, IMREAD_COLOR)`` (then
BGR->RGB), which OpenCV 5.0 decodes with libwebp:

* the RIFF container: simple lossy (``VP8 ``) and lossless (``VP8L``) files,
  and extended (``VP8X``) files, whose ICCP, XMP and unknown chunks are
  skipped and whose ALPH chunk leaves the colour pixels as they are (OpenCV
  decodes to BGRA and drops the alpha, unpremultiplied);
* an animated file gives its first frame on a black canvas, at the frame's
  offset and unblended, as libwebp's animation decoder gives it to OpenCV;
* an EXIF chunk's orientation turns the pixels as ``IMREAD_COLOR`` does;
* the bitstreams are decoded in ``webp.cpp``: VP8L, and VP8 key frames with
  libwebp's arithmetic and its fancy upsampler.

`encode` writes a lossless (VP8L) file, which is what ``cv2.imwrite`` writes
by default; the bytes are this encoder's, not libwebp's.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def _chunks(data: bytes, start: int, end: int, path):
    """(fourcc, payload) of each chunk in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if pos + 8 + size > end:
            raise ValueError(f"{path}: the {kind.decode(errors='replace')} chunk runs past the end of the file")
        yield kind, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _parse(data: bytes, path) -> Dict:
    """The image chunk, the canvas size, the first frame's offset and the EXIF chunk."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{path}: not a WebP file")
    riff_end = 8 + struct.unpack("<I", data[4:8])[0]
    if riff_end > len(data):
        raise ValueError(f"{path}: the file is shorter than its RIFF header says")
    out: Dict = {"exif": None, "offset": (0, 0), "canvas": None, "image": None, "animated": False}
    for kind, payload in _chunks(data, 12, riff_end, path):
        if kind == b"VP8X":
            if len(payload) < 10:
                raise ValueError(f"{path}: a short VP8X chunk")
            w = 1 + int.from_bytes(payload[4:7], "little")
            h = 1 + int.from_bytes(payload[7:10], "little")
            out["canvas"] = (h, w)
            out["animated"] = bool(payload[0] & 0x02)
        elif kind in (b"VP8 ", b"VP8L") and out["image"] is None:
            out["image"] = (kind, payload)
        elif kind == b"ANMF" and out["image"] is None:
            if len(payload) < 16:
                raise ValueError(f"{path}: a short ANMF chunk")
            x = 2 * int.from_bytes(payload[0:3], "little")
            y = 2 * int.from_bytes(payload[3:6], "little")
            out["offset"] = (y, x)
            for sub, sub_payload in _chunks(payload, 16, len(payload), path):
                if sub in (b"VP8 ", b"VP8L"):
                    out["image"] = (sub, sub_payload)
                    break
        elif kind == b"EXIF" and out["exif"] is None:
            out["exif"] = payload[6:] if payload[:6] == b"Exif\0\0" else payload
    if out["image"] is None:
        raise ValueError(f"{path}: no VP8 or VP8L image data")
    return out


def _frame_size(kind: bytes, payload: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` from a VP8 or VP8L bitstream's header."""
    if kind == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F:
            raise ValueError(f"{path}: a bad VP8L header")
        bits = int.from_bytes(payload[1:5], "little")
        return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: a bad VP8 frame header")
    w, h = struct.unpack("<HH", payload[6:10])
    return h & 0x3FFF, w & 0x3FFF


def stored_shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` of the canvas (VP8X) or of the frame, unturned, as PIL gives it."""
    info = _parse(data, path)
    return info["canvas"] or _frame_size(*info["image"], path)


def _orientation(info) -> int:
    from quan_ultralytics_tpu_torch.data.native.native import _exif_orientation

    return _exif_orientation(info["exif"]) if info["exif"] else 1


def shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` as `decode` returns it (turned by the EXIF orientation)."""
    from quan_ultralytics_tpu_torch.data.native.native import _turned

    info = _parse(data, path)
    return _turned(info["canvas"] or _frame_size(*info["image"], path), _orientation(info))


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``: OpenCV's pixels."""
    from quan_ultralytics_tpu_torch.data.native.native import apply_orientation, webp_library

    info = _parse(data, path)
    kind, payload = info["image"]
    h, w = _frame_size(kind, payload, path)
    if w == 0 or h == 0:
        raise ValueError(f"{path}: an empty frame")
    if info["canvas"] is not None and not info["animated"] and info["canvas"] != (h, w):
        raise ValueError(f"{path}: the frame size differs from the canvas")
    buf = np.frombuffer(payload, np.uint8)
    rgb = np.empty((h, w, 3), np.uint8)
    lib = webp_library()
    fn = lib.vp8l_decode if kind == b"VP8L" else lib.vp8_decode
    status = fn(buf.ctypes.data, buf.size, rgb.ctypes.data, w, h)
    if status:
        raise ValueError(f"{path}: {lib.webp_error(status).decode()}")
    if info["animated"]:
        ch, cw = info["canvas"]
        y, x = info["offset"]
        if y + h > ch or x + w > cw:
            raise ValueError(f"{path}: the first frame lies outside the canvas")
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[y:y + h, x:x + w] = rgb
        rgb = canvas
    return apply_orientation(rgb, _orientation(info))


PREDICTOR_MODE = 11  # VP8L's "select" predictor, used for the whole image by `encode`


def encode(im: np.ndarray) -> bytes:
    """A lossless WebP file of uint8 ``[h, w, 3]`` RGB or ``[h, w]`` gray."""
    from quan_ultralytics_tpu_torch.data.native.native import webp_library

    rgb = np.ascontiguousarray(np.repeat(im[..., None], 3, axis=-1) if im.ndim == 2 else im)
    h, w = rgb.shape[:2]
    if w > 16384 or h > 16384:
        raise ValueError(f"WebP images are at most 16384 x 16384, got {w} x {h}")
    cap = h * w * 5 + 4096
    out = np.empty(cap, np.uint8)
    n = webp_library().vp8l_encode(rgb.ctypes.data, w, h, PREDICTOR_MODE, out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"cannot encode a {im.shape} image")
    payload = out[:n].tobytes() + (b"\0" if n & 1 else b"")
    return b"RIFF" + struct.pack("<I", 4 + 8 + len(payload)) + b"WEBP" + b"VP8L" + struct.pack("<I", n) + payload

