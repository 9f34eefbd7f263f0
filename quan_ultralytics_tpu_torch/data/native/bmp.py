"""BMP reading and writing without OpenCV: OpenCV 5.0's decoder (``grfmt_bmp.cpp``).

`decode` gives the RGB pixels ``cv2.imread`` gives (then BGR->RGB):

* headers: OS/2 CORE (12 bytes; 16-bit width and height, a 3-byte palette)
  and Windows INFO (40), V4 (108) and V5 (124);
* 1-, 4- and 8-bit palettes (entries past the stored ones are black),
  16-bit 5-5-5 (BI_RGB or BITFIELDS 0x7c00/0x3e0/0x1f) and 5-6-5 (BITFIELDS
  0xf800/0x7e0/0x1f) with the low bits zero, 24-bit, and 32-bit BI_RGB or
  BITFIELDS (alpha dropped): read as B, G, R, A after an INFO header, by the
  header's masks after a V2-V5 one (whole-byte masks only);
* RLE8 and RLE4 (``codecs.cpp``), pixels skipped by end-of-line, end-of-bitmap
  or delta codes filled with the first palette entry; OpenCV's RLE4 ignores
  a delta's rows and reads on after an end-of-bitmap;
* bottom-up and top-down (negative height) rows.

The masks of 16-bit BITFIELDS are read after the header whatever its size,
as OpenCV reads them. Anything OpenCV refuses raises `ValueError`.

`encode` writes what ``cv2.imwrite`` writes: 24-bit bottom-up BI_RGB, or an
8-bit file with a 256-entry gray palette for a gray image.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _header(data: bytes, path) -> dict:
    """The fields OpenCV's ``readHeader`` reads; `ValueError` where it fails."""
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset, size = struct.unpack("<II", data[10:18])
    if size >= 36:
        if len(data) < 14 + 36:
            raise ValueError(f"{path}: the BMP header is cut short")
        w, h, bpp_word, comp = struct.unpack("<iiII", data[18:34])
        bpp = bpp_word >> 16
        clrused = struct.unpack("<i", data[46:50])[0]
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
            or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
            or (bpp == 4 and comp == _RLE4) or (bpp == 8 and comp == _RLE8))
        if not ok:
            raise ValueError(f"{path}: OpenCV does not read a {bpp}-bit BMP with compression {comp}")
        at = 14 + size
        palette = np.zeros((256, 3), np.uint8)
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise ValueError(f"{path}: {clrused} palette entries")
            n = clrused or 1 << bpp
            raw = np.frombuffer(data[at:at + 4 * n], np.uint8)
            if raw.size < 4 * n:
                raise ValueError(f"{path}: the BMP palette is cut short")
            palette[:n] = raw.reshape(n, 4)[:, 2::-1]
        elif bpp == 16:
            if comp == _BITFIELDS:
                red, green, blue = struct.unpack("<III", data[at:at + 12].ljust(12, b"\0"))
                if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                    bpp = 15
                elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                    raise ValueError(f"{path}: 16-bit BITFIELDS masks {red:#x}/{green:#x}/{blue:#x}")
            else:
                bpp = 15
        masks = None
        if bpp == 32 and comp == _BITFIELDS and size >= 52:  # V2-V5 headers carry the masks
            masks = struct.unpack("<III", data[54:66])
            if any(m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000) for m in masks):
                raise NotImplementedError(f"{path}: 32-bit BITFIELDS masks other than whole bytes "
                                          f"({'/'.join(f'{m:#x}' for m in masks)}) are not read")
        return dict(w=w, h=h, bpp=bpp, comp=comp, palette=palette, offset=offset, masks=masks)
    if size == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        if not (w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"{path}: OpenCV does not read this {bpp}-bit OS/2 BMP")
        palette = np.zeros((256, 3), np.uint8)
        if bpp <= 8:
            n = 1 << bpp
            raw = np.frombuffer(data[26:26 + 3 * n], np.uint8)
            if raw.size < 3 * n:
                raise ValueError(f"{path}: the BMP palette is cut short")
            palette[:n] = raw.reshape(n, 3)[:, ::-1]
        return dict(w=w, h=h, bpp=bpp, comp=_RGB, palette=palette, offset=offset, masks=None)
    raise ValueError(f"{path}: a BMP header of {size} bytes")


def stored_shape(data: bytes, path) -> Tuple[int, int]:
    """``(|height|, width)`` from the header."""
    hdr = _header(data, path)
    return abs(hdr["h"]), hdr["w"]


shape = stored_shape  # OpenCV's shape: a BMP has no orientation


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``, OpenCV's pixels."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    hdr = _header(data, path)
    w, h, bpp, comp, palette = hdr["w"], abs(hdr["h"]), hdr["bpp"], hdr["comp"], hdr["palette"]
    src = np.frombuffer(data, np.uint8)[hdr["offset"]:]
    if comp in (_RLE8, _RLE4):
        idx = np.zeros((h, w), np.uint8)
        status = codecs_library().bmp_rle_decode(src.ctypes.data, src.size, int(comp == _RLE4), w, h,
                                                 idx.ctypes.data)
        if status:
            raise ValueError(f"{path}: " + ("the RLE data ends early" if status == 2 else "bad RLE data"))
        rgb = palette[idx]
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if src.size < pitch * h:
            raise ValueError(f"{path}: the BMP pixel data is cut short")
        rows = src[:pitch * h].reshape(h, pitch)
        if bpp in (1, 4, 8):
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(h, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
            rgb = palette[idx]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                rgb = np.stack([(t >> 7) & 0xF8, (t >> 2) & 0xF8, (t << 3) & 0xF8], -1)
            else:
                rgb = np.stack([(t >> 8) & 0xF8, (t >> 3) & 0xFC, (t << 3) & 0xF8], -1)
            rgb = rgb.astype(np.uint8)
        elif hdr["masks"] is not None:  # each channel is the byte its mask selects
            px = rows[:, :4 * w].reshape(h, w, 4)
            rgb = np.stack([px[..., m.bit_length() // 8 - 1] for m in hdr["masks"]], -1)
        else:
            nch = bpp // 8
            rgb = rows[:, :w * nch].reshape(h, w, nch)[..., 2::-1]
    if hdr["h"] > 0:  # bottom-up
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def encode(im: np.ndarray) -> bytes:
    """``cv2.imwrite``'s BMP bytes of uint8 ``[h, w, 3]`` RGB or ``[h, w]`` gray."""
    h, w = im.shape[:2]
    gray = im.ndim == 2
    nch = 1 if gray else 3
    pitch = (w * nch + 3) & -4
    head = 14 + 40 + (1024 if gray else 0)
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :w * nch] = (im if gray else im[..., ::-1]).reshape(h, w * nch)
    out = [b"BM", struct.pack("<IHHI", head + pitch * h, 0, 0, head),
           struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8 * nch, 0, 0, 0, 0, 0, 0)]
    if gray:
        out.append((np.arange(256, dtype=np.uint32) * 0x010101).astype("<u4").tobytes())
    out.append(rows[::-1].tobytes())
    return b"".join(out)
