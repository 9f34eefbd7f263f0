"""PxM (PBM, PGM, PPM), PAM and PFM reading without OpenCV: OpenCV 5.0's
decoders (``grfmt_pxm.cpp``, ``grfmt_pam.cpp``, ``grfmt_pfm.cpp``).

`decode` gives the RGB pixels ``cv2.imread(path, IMREAD_COLOR)`` gives (then
BGR->RGB):

* P1-P6: ASCII (P1-P3, the numbers read by ``codecs.cpp`` ``pnm_ascii``) and
  binary (P4-P6) samples, comments anywhere in the header, maxval 1-65535.
  A number that runs into the end of the file reads nothing, as OpenCV's
  byte stream throws there. As OpenCV reads them, ASCII 8-bit samples are scaled by ``255 / maxval``
  (samples above maxval taken as maxval) while binary 8-bit ones are kept as
  stored, 16-bit samples (maxval above 255) keep their high byte, and a
  1-bit 1 is black. Gray comes out as three equal channels.
* P7 (PAM): upper-case ``WIDTH``, ``HEIGHT``, ``DEPTH`` 1-4, ``MAXVAL`` and
  ``TUPLTYPE`` (BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA,
  each with its depth; without one, depth 1 or 3 at 8 bits), comment lines skipped and
  any other field refused, as OpenCV 5.0 reads them. 16-bit samples keep
  their high byte, 8-bit ones are kept as stored; maxval 1 is OpenCV's bit
  mode (each row's first bytes read as bits, MSB first, 1 white); three
  samples are taken as B, G, R (OpenCV swaps none); with alpha, the first
  three samples as R, G, B or the first as gray. OpenCV 5.0 fills only the
  first pixels of each row of an ``_ALPHA`` file and leaves the rest as
  whatever its buffer held, so there only those pixels agree with it.
* PFM (``PF``, RGB): the scale's sign gives the byte order (negative:
  little-endian), rows run bottom-up; each float is divided by the scale's
  magnitude, rounded and saturated as OpenCV's ``convertTo(CV_8U)`` does
  (`saturate_u8`) (no factor of 255: OpenCV writes
  8-bit images as floats 0-255). A gray ``Pf`` file reads nothing: OpenCV's
  colour read of one fails its own size check.

Anything OpenCV reads nothing from raises `ValueError`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

NAME = "PxM/PAM/PFM"
SIGNATURES = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P7", b"Pf", b"PF")
_SPACE = b" \t\n\v\f\r"
_PAM_KINDS = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}  # depths


def _numbers(data: bytes, pos: int, count: int, path, single_digit: bool = False) -> Tuple[np.ndarray, int]:
    """``count`` numbers from ``pos`` as ReadNumber reads them, and the position after."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(count, 1), np.int32)
    at = ctypes.c_long(pos)
    st = codecs_library().pnm_ascii(src.ctypes.data, src.size, ctypes.byref(at), count, int(single_digit),
                                    out.ctypes.data)
    if st:
        raise ValueError(f"{path}: " + {1: "an unexpected character in a PxM file", 2: "the PxM data ends early",
                                        3: "a PxM number above INT_MAX"}[st])
    return out[:count], at.value


def _pnm_header(data: bytes, path) -> dict:
    kind = data[1:2]
    bpp = {b"1": 1, b"4": 1, b"2": 8, b"5": 8, b"3": 24, b"6": 24}[kind]
    (w, h), at = _numbers(data, 2, 2, path)
    maxval = 1
    if bpp > 1:
        (maxval,), at = _numbers(data, at, 1, path)
    if maxval > 65535 or w <= 0 or h <= 0 or maxval <= 0:
        raise ValueError(f"{path}: OpenCV does not read a {w}x{h} PxM file with maxval {maxval}")
    return dict(w=w, h=h, bpp=bpp, binary=kind >= b"4", maxval=maxval, offset=at)


def _pnm(data: bytes, path) -> np.ndarray:
    hdr = _pnm_header(data, path)
    w, h, bpp, maxval, at = hdr["w"], hdr["h"], hdr["bpp"], hdr["maxval"], hdr["offset"]
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if hdr["binary"]:
            pitch = (w + 7) // 8
            raw = np.frombuffer(data, np.uint8, pitch * h, at) if len(data) >= at + pitch * h else None
            if raw is None:
                raise ValueError(f"{path}: the PBM data ends early")
            bits = np.unpackbits(raw.reshape(h, pitch), axis=1)[:, :w]
        else:
            bits = _numbers(data, at, w * h, path, single_digit=True)[0].reshape(h, w) != 0
        gray = np.where(bits, 0, 255).astype(np.uint8)
        return np.repeat(gray[..., None], 3, -1)
    wide = maxval > 255
    count = w * h * nch
    if hdr["binary"]:
        size = count * (2 if wide else 1)
        if len(data) < at + size:
            raise ValueError(f"{path}: the PxM data ends early")
        px = np.frombuffer(data, ">u2" if wide else np.uint8, count, at)
        px = (px >> 8).astype(np.uint8) if wide else px
    else:
        num = np.minimum(_numbers(data, at, count, path)[0], maxval)
        px = (num >> 8).astype(np.uint8) if wide else (num * 255 // maxval).astype(np.uint8)
    px = px.reshape(h, w, nch)
    return np.repeat(px, 3, -1) if nch == 1 else px.copy()  # a writable array, as cv2.imread gives


def _pam_header(data: bytes, path) -> dict:
    """The fields OpenCV's PAM reader takes: upper-case keys, one a line,
    comment and blank lines skipped, any other key refused."""
    end = data.find(b"\nENDHDR")
    if end < 0:
        raise ValueError(f"{path}: a PAM header without ENDHDR")
    fields = {}
    for line in data[3:end].split(b"\n"):
        line = line.strip()
        if not line or line[:1] == b"#":
            continue
        key, value = (line.split(None, 1) + [b""])[:2]
        key = key.decode("latin-1")
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE"):
            raise ValueError(f"{path}: OpenCV does not read the PAM header field {key!r}")
        fields[key] = value.strip().decode("latin-1")
    try:
        w, h, depth, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError(f"{path}: a PAM header without whole WIDTH, HEIGHT, DEPTH and MAXVAL") from None
    tupltype = fields.get("TUPLTYPE")
    if tupltype is None:  # OpenCV infers the kind of 8-bit files only
        tupltype_ok = depth in (1, 3) and maxval <= 255
    else:
        tupltype_ok = _PAM_KINDS.get(tupltype) == depth
    if w <= 0 or h <= 0 or not 0 < maxval <= 65535 or not tupltype_ok:
        raise ValueError(f"{path}: OpenCV does not read a {w}x{h} PAM file of depth {depth}, maxval {maxval} "
                         f"and TUPLTYPE {tupltype}")
    return dict(w=w, h=h, depth=depth, maxval=maxval, offset=end + 8)


def _pam(data: bytes, path) -> np.ndarray:
    hdr = _pam_header(data, path)
    w, h, depth, maxval, at = hdr["w"], hdr["h"], hdr["depth"], hdr["maxval"], hdr["offset"]
    wide = maxval > 255
    count = w * h * depth
    if len(data) < at + count * (2 if wide else 1):
        raise ValueError(f"{path}: the PAM data ends early")
    if maxval == 1:  # OpenCV's bit mode: each row's first bytes as bits, MSB first, 1 white
        rows = np.frombuffer(data, np.uint8, count, at).reshape(h, w * depth)
        gray = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return np.ascontiguousarray(np.repeat(gray[..., None], 3, -1))
    px = np.frombuffer(data, ">u2" if wide else np.uint8, count, at)
    px = ((px >> 8) if wide else px).astype(np.uint8).reshape(h, w, depth)
    if depth == 3:  # OpenCV takes the three samples as B, G, R
        return np.ascontiguousarray(px[..., ::-1])
    if depth == 4:
        return np.ascontiguousarray(px[..., :3])
    return np.ascontiguousarray(np.repeat(px[..., :1], 3, -1))


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's ``convertTo(CV_8U)`` on x86: rounded to the
    nearest integer (halves to even) by ``cvtps2dq``, which gives INT_MIN for
    NaN and for values outside int32, then saturated (so those become 0)."""
    with np.errstate(invalid="ignore"):
        r = np.rint(x.astype(np.float32))
        r = np.where(np.isfinite(r) & (r < 2.0 ** 31) & (r >= -(2.0 ** 31)), r, 0)
    return np.clip(r, 0, 255).astype(np.uint8)


def _pfm(data: bytes, path) -> np.ndarray:
    if data[1:2] == b"f":  # OpenCV's IMREAD_COLOR read of a gray PFM fails its own check and returns nothing
        raise ValueError(f"{path}: OpenCV reads no gray (Pf) PFM file as colour")
    if data[2:3] != b"\n":
        raise ValueError(f"{path}: a PFM header without a line break after its kind")
    at, fields = 3, []
    for _ in range(3):
        while at < len(data) and data[at] in _SPACE:
            at += 1
        start = at
        while at < len(data) and data[at] not in _SPACE:
            at += 1
        fields.append(data[start:at])
        at += 1
    try:
        w, h, scale = int(fields[0]), int(fields[1]), float(fields[2])
    except ValueError:
        raise ValueError(f"{path}: a bad PFM header") from None
    if w <= 0 or h <= 0 or scale == 0:
        raise ValueError(f"{path}: a {w}x{h} PFM file with scale {scale}")
    count = w * h * 3
    if len(data) < at + 4 * count:
        raise ValueError(f"{path}: the PFM data ends early")
    px = np.frombuffer(data, "<f4" if scale < 0 else ">f4", count, at).astype(np.float32).reshape(h, w, 3)[::-1]
    px = px * np.float32(1.0 / abs(scale))
    return np.ascontiguousarray(saturate_u8(px))


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``, OpenCV's pixels."""
    kind = data[:2]
    if kind in (b"Pf", b"PF"):
        return _pfm(data, path)
    if kind == b"P7":
        return _pam(data, path)
    return _pnm(data, path)
