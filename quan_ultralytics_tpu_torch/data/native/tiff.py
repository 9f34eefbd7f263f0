"""TIFF reading and writing without OpenCV or libtiff.

`decode` gives the RGB pixels of ``cv2.imread(path, IMREAD_COLOR)`` (then
BGR->RGB) as OpenCV 5.0 reads them through libtiff 4.7's RGBA interface
(``TIFFReadRGBAStrip``/``TIFFReadRGBATile``): the first page, little- or
big-endian, in strips or tiles,

* compression 1 (none), 5 (LZW), 8 and 32946 (Deflate, inflated with
  ``zlib``) and 32773 (PackBits); LZW, PackBits and the predictor are in
  ``codecs.cpp``;
* predictor 2 (horizontal differencing) at 8 and 16 bits;
* planar configuration 1 (contiguous) and 2 (separate planes);
* photometric 0 (MinIsWhite, inverted) and 1 (MinIsBlack) at 1, 8 and 16
  bits, 2 (RGB) at 8 and 16 bits and 3 (palette, a 16-bit colour map taken
  as 8-bit when every entry is below 256) at 1 and 8 bits;
* 16-bit samples reduced to 8 bits as libtiff's RGBA interface reduces them:
  (v + 128) // 257 for RGB, the high byte for gray;
* an alpha extra sample: unassociated alpha multiplies RGB (and a separate
  plane's gray) by it, ``(v * a + 127) // 255``, associated or unspecified
  alpha leaves them; the alpha itself is dropped;
* orientation 1-4: 2 and 3 mirror each strip or tile left-right in place, 3
  and 4 flip the image top-bottom, as OpenCV's TIFF decoder does; 5-8 raise
  `ValueError` (OpenCV returns nothing for them).

JPEG (6, 7), CCITT (2, 3, 4) and other compressions, YCbCr, CMYK and CIELab
photometrics, float samples and BigTIFF raise `NotImplementedError`; 2-, 4-,
12-bit and 32-bit samples raise `ValueError`, as OpenCV reads none of them.

`encode` writes an 8-bit gray or RGB TIFF: LZW (the layout OpenCV writes,
with predictor 2 in one strip), Deflate or none, in one strip or in tiles.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I"}
_NOT_PORTED_COMPRESSION = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                           7: "JPEG-in-TIFF", 32809: "ThunderScan", 32771: "CCITT RLEW", 34676: "SGILog",
                           34677: "SGILog24", 34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard",
                           50001: "WebP-in-TIFF"}
_NOT_PORTED_PHOTOMETRIC = {5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab",
                           9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_STRIP_OFFSETS, T_ORIENTATION, T_SPP, T_ROWS_PER_STRIP, T_STRIP_BYTES = 273, 274, 277, 278, 279
T_PLANAR, T_PREDICTOR, T_COLORMAP = 284, 317, 320
T_TILE_WIDTH, T_TILE_LENGTH, T_TILE_OFFSETS, T_TILE_BYTES = 322, 323, 324, 325
T_EXTRA_SAMPLES, T_SAMPLE_FORMAT = 338, 339


def _first_ifd(data: bytes, path) -> Tuple[str, Dict[int, List[int]]]:
    """Byte order ('<' or '>') and the first IFD's tags (numbers only)."""
    if data[:4] in (b"II+\0", b"MM\0+"):
        raise NotImplementedError(f"{path}: BigTIFF files are not read")
    if data[:4] not in (b"II*\0", b"MM\0*"):
        raise ValueError(f"{path}: not a TIFF file")
    end = "<" if data[:2] == b"II" else ">"
    at = struct.unpack(end + "I", data[4:8])[0]
    if at + 2 > len(data):
        raise ValueError(f"{path}: the first IFD lies past the end of the file")
    tags: Dict[int, List[int]] = {}
    for i in range(struct.unpack(end + "H", data[at:at + 2])[0]):
        e = at + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError(f"{path}: the IFD is cut short")
        tag, kind, count = struct.unpack(end + "HHI", data[e:e + 8])
        fmt = _TYPES.get(kind)
        if fmt is None:
            continue
        size = struct.calcsize(fmt) * count
        off = e + 8 if size <= 4 else struct.unpack(end + "I", data[e + 8:e + 12])[0]
        if off + size > len(data):
            raise ValueError(f"{path}: tag {tag} points past the end of the file")
        if kind in (5, 10):  # rationals: numerators only
            vals = list(struct.unpack(end + fmt[0] * (2 * count), data[off:off + size])[::2])
        elif kind in (11, 12):
            vals = [int(v) for v in struct.unpack(end + fmt * count, data[off:off + size])]
        else:
            vals = list(struct.unpack(end + fmt * count, data[off:off + size]))
        tags[tag] = vals
    return end, tags


def _one(tags, tag, default):
    return tags[tag][0] if tag in tags and tags[tag] else default


def _size(tags, path) -> Tuple[int, int]:
    """``(ImageLength, ImageWidth)`` of the first IFD."""
    if T_WIDTH not in tags or T_LENGTH not in tags:
        raise ValueError(f"{path}: no image size")
    return _one(tags, T_LENGTH, 0), _one(tags, T_WIDTH, 0)


def stored_shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` as PIL reports it: the first IFD's size, swapped for
    orientations 5-8 (PIL's TIFF reader turns those)."""
    _, tags = _first_ifd(data, path)
    h, w = _size(tags, path)
    return (w, h) if _one(tags, T_ORIENTATION, 1) in (5, 6, 7, 8) else (h, w)


def shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` as `decode` returns it (orientations 5-8 are refused)."""
    _, tags = _first_ifd(data, path)
    if _one(tags, T_ORIENTATION, 1) in (5, 6, 7, 8):
        raise ValueError(f"{path}: OpenCV does not read TIFF orientation {_one(tags, T_ORIENTATION, 1)}")
    return _size(tags, path)


def _inflate_block(data: bytes, comp: int, size: int, path) -> np.ndarray:
    """The first ``size`` bytes of one decompressed strip or tile."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    out = np.zeros(size, np.uint8)
    if comp == 1:
        raw = np.frombuffer(data[:size], np.uint8)
        out[:raw.size] = raw
        n = raw.size
    elif comp in (8, 32946):
        try:
            raw = zlib.decompressobj().decompress(data, size)
        except zlib.error as e:
            raise ValueError(f"{path}: bad Deflate data ({e})") from None
        out[:len(raw)] = np.frombuffer(raw, np.uint8)
        n = len(raw)
    else:
        src = np.frombuffer(data, np.uint8)
        fn = codecs_library().tiff_lzw_decode if comp == 5 else codecs_library().tiff_packbits_decode
        n = fn(src.ctypes.data, src.size, out.ctypes.data, size)
        if n == -4:
            raise NotImplementedError(f"{path}: old-style (pre-TIFF 6) LZW is not read")
        if n < 0:
            raise ValueError(f"{path}: corrupt LZW data")
    if n < size:
        raise ValueError(f"{path}: a strip or tile holds {n} of its {size} bytes")
    return out


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``: OpenCV's pixels of the first page."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    end, tags = _first_ifd(data, path)
    h, w = _size(tags, path)
    comp = _one(tags, T_COMPRESSION, 1)
    photometric = _one(tags, T_PHOTOMETRIC, -1)
    spp = _one(tags, T_SPP, 1)
    bits = tags.get(T_BITS, [1])[0]
    sample_format = _one(tags, T_SAMPLE_FORMAT, 1)
    planar = _one(tags, T_PLANAR, 1)
    predictor = _one(tags, T_PREDICTOR, 1)
    orientation = _one(tags, T_ORIENTATION, 1)
    if comp in _NOT_PORTED_COMPRESSION:
        raise NotImplementedError(f"{path}: {_NOT_PORTED_COMPRESSION[comp]} compression ({comp}) is not read")
    if comp not in (1, 5, 8, 32946, 32773):
        raise NotImplementedError(f"{path}: TIFF compression {comp} is not read")
    if photometric in _NOT_PORTED_PHOTOMETRIC:
        raise NotImplementedError(f"{path}: {_NOT_PORTED_PHOTOMETRIC[photometric]} photometric ({photometric}) "
                                  "is not read")
    if photometric not in (0, 1, 2, 3):
        raise ValueError(f"{path}: photometric {photometric}")
    if sample_format == 3 or predictor == 3:
        raise NotImplementedError(f"{path}: float TIFF samples are not read")
    if bits not in (1, 8, 16):
        raise ValueError(f"{path}: OpenCV does not read {bits}-bit TIFF samples")
    if bits == 1 and spp != 1:
        raise ValueError(f"{path}: 1-bit samples with {spp} samples a pixel")
    if photometric == 2 and spp < 3:
        raise ValueError(f"{path}: RGB with {spp} samples a pixel")
    if photometric == 3 and bits == 16:
        raise ValueError(f"{path}: 16-bit palette images are not read by OpenCV")
    if orientation in (5, 6, 7, 8):
        raise ValueError(f"{path}: OpenCV does not read TIFF orientation {orientation}")
    if predictor == 2 and bits == 1:
        raise ValueError(f"{path}: horizontal differencing of 1-bit samples")
    extras = tags.get(T_EXTRA_SAMPLES, [])
    alpha = 0  # libtiff's img->alpha: 0, 1 associated, 2 unassociated
    if extras:
        alpha = 1 if extras[0] == 0 and spp > 3 else extras[0] if extras[0] in (1, 2) else 0
    elif spp == 4 and photometric == 2:
        alpha = 1  # libtiff's DEFAULT_EXTRASAMPLE_AS_ALPHA
    separate = planar == 2 and spp > 1

    tiled = T_TILE_WIDTH in tags
    if tiled:
        bw, bh = _one(tags, T_TILE_WIDTH, 0), _one(tags, T_TILE_LENGTH, 0)
        offsets, counts = tags.get(T_TILE_OFFSETS, []), tags.get(T_TILE_BYTES, [])
    else:
        bw, bh = w, min(_one(tags, T_ROWS_PER_STRIP, h), h) or h
        offsets, counts = tags.get(T_STRIP_OFFSETS, []), tags.get(T_STRIP_BYTES, [])
    if bw <= 0 or bh <= 0:
        raise ValueError(f"{path}: bad strip or tile size")
    across, down = -(-w // bw), -(-h // bh)
    planes = spp if separate else 1
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError(f"{path}: {len(offsets)} strips or tiles for {across * down * planes}")
    per_pixel = 1 if separate else spp
    # libtiff's contiguous gray tile routines step over a clipped tile's
    # right part by (tile width - visible width) bytes whatever the sample
    # size: wrong for 16 bits or more than one sample, and OpenCV shows it
    skewed = tiled and photometric in (0, 1) and not separate and (bits == 16 or (bits == 8 and spp > 1))
    row_bytes = (bw * per_pixel * bits + 7) // 8
    dtype = np.dtype(end + "u2") if bits == 16 else np.uint8
    samples = np.zeros((down * bh, across * bw, spp), np.uint16 if bits == 16 else np.uint8)
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = (p * down + ty) * across + tx
                rows = bh if tiled else min(bh, h - ty * bh)
                raw = _inflate_block(data[offsets[k]:offsets[k] + counts[k]], comp, rows * row_bytes, path)
                block = raw.reshape(rows, row_bytes)
                if bits == 1:
                    block = np.unpackbits(block, axis=1)[:, :bw]
                else:
                    block = np.ascontiguousarray(block.view(dtype), samples.dtype)
                    if predictor == 2:
                        codecs_library().tiff_undo_predictor(block.ctypes.data, rows, bw, per_pixel, bits)
                block = block.reshape(rows, bw, per_pixel)
                ys, xs = ty * bh, tx * bw
                if skewed and xs + bw > w:  # libtiff's gray tile skew, in bytes for samples
                    npix, size = w - xs, bits // 8 * spp
                    flat = np.frombuffer(block.astype("<u2" if bits == 16 else np.uint8).tobytes(), np.uint8)
                    stride = npix * size + (bw - npix)
                    take = np.arange(rows)[:, None] * stride + np.arange(npix * size)[None]
                    block = flat[take].copy().view("<u2" if bits == 16 else np.uint8).reshape(rows, npix, spp)
                if separate:
                    samples[ys:ys + rows, xs:xs + bw, p] = block[..., 0]
                else:
                    samples[ys:ys + rows, xs:xs + block.shape[1]] = block
    if orientation in (2, 3):  # libtiff mirrors each strip or tile it hands over
        for tx in range(across):
            xs, xe = tx * bw, min(w, tx * bw + bw)
            samples[:, xs:xe] = samples[:, xs:xe][:, ::-1]
    samples = samples[:h, :w]
    rgb = _to_rgb(samples, tags, photometric, bits, alpha, separate, path)
    if orientation in (3, 4):
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def _to_rgb(samples: np.ndarray, tags, photometric: int, bits: int, alpha: int, separate: bool, path
            ) -> np.ndarray:
    """libtiff's put*tile conversions to 8-bit RGB."""
    if photometric == 2 and bits == 8 and alpha != 2:  # the common case, as stored
        return samples[..., :3]
    s = samples.astype(np.int64)
    if photometric in (0, 1) and not separate:  # the BWmap
        g = s[..., 0]
        if bits == 16:
            g = g >> 8
        elif bits == 1:
            g = g * 255
        if photometric == 0:
            g = 255 - g
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=-1)
    if photometric == 3:
        cmap = np.asarray(tags.get(T_COLORMAP, []), np.int64)
        n = 1 << bits
        if cmap.size < 3 * n:
            raise ValueError(f"{path}: the colour map is cut short")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap[:, s[..., 0]].transpose(1, 2, 0).astype(np.uint8)
    # RGB, and gray in separate planes (libtiff takes it as R = G = B)
    colour = s[..., :3] if photometric == 2 else np.repeat(s[..., :1], 3, axis=-1)
    a_index = 3 if photometric == 2 else 1
    if bits == 16:
        colour = (colour + 128) // 257
    if alpha == 2 and s.shape[-1] > a_index:
        a = s[..., a_index]
        if bits == 16:
            a = (a + 128) // 257
        colour = (colour * a[..., None] + 127) // 255
    return colour.astype(np.uint8)


# ---------------------------------------------------------------- writer


def encode(im: np.ndarray, compression: str = "lzw", predictor: bool = True, tile: Optional[int] = None) -> bytes:
    """A little-endian TIFF file of uint8 ``[h, w]`` gray (MinIsBlack) or
    ``[h, w, 3]`` RGB: ``compression`` "lzw" (``codecs.cpp``), "deflate" or
    "none"; ``predictor`` applies horizontal differencing (with LZW or
    Deflate); ``tile`` writes square tiles of that size (a multiple of 16)
    instead of one strip."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    px = im[..., None] if im.ndim == 2 else im
    h, w, spp = px.shape
    code = {"none": 1, "lzw": 5, "deflate": 8}[compression]
    use_predictor = predictor and code != 1
    bw, bh = (tile, tile) if tile else (w, h)
    blocks = []
    for ty in range(-(-h // bh)):
        for tx in range(-(-w // bw)):
            block = np.zeros((bh, bw, spp), np.uint8)
            part = px[ty * bh:ty * bh + bh, tx * bw:tx * bw + bw]
            block[:part.shape[0], :part.shape[1]] = part
            if use_predictor:
                block = np.diff(block, axis=1, prepend=np.zeros((bh, 1, spp), np.uint8))
            raw = block.tobytes()
            if code == 5:
                src = np.frombuffer(raw, np.uint8)
                cap = len(raw) * 2 + 64
                out = np.empty(cap, np.uint8)
                raw = out[:codecs_library().tiff_lzw_encode(src.ctypes.data, src.size, out.ctypes.data, cap)].tobytes()
            elif code == 8:
                raw = zlib.compress(raw, 6)
            blocks.append(raw)
    tags: Dict[int, Tuple[int, List[int]]] = {
        T_WIDTH: (4, [w]), T_LENGTH: (4, [h]), T_BITS: (3, [8] * spp), T_COMPRESSION: (3, [code]),
        T_PHOTOMETRIC: (3, [1 if spp == 1 else 2]), T_SPP: (3, [spp]), T_PLANAR: (3, [1]),
        T_SAMPLE_FORMAT: (3, [1] * spp), T_PREDICTOR: (3, [2 if use_predictor else 1])}
    if tile:
        tags[T_TILE_WIDTH] = tags[T_TILE_LENGTH] = (4, [tile])
    else:
        tags[T_ROWS_PER_STRIP] = (4, [h])
    # layout: header, pixel blocks, the IFD, then the IFD's out-of-line values
    body = bytearray(struct.pack("<2sHI", b"II", 42, 0))
    offsets = []
    for raw in blocks:
        offsets.append(len(body))
        body += raw + (b"\0" if len(raw) & 1 else b"")
    tags[T_TILE_OFFSETS if tile else T_STRIP_OFFSETS] = (4, offsets)
    tags[T_TILE_BYTES if tile else T_STRIP_BYTES] = (4, [len(b) for b in blocks])
    ifd_at = len(body)
    struct.pack_into("<I", body, 4, ifd_at)
    entries, spill = [], bytearray()
    spill_at = ifd_at + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        kind, vals = tags[tag]
        payload = struct.pack("<" + _TYPES[kind] * len(vals), *vals)
        if len(payload) <= 4:
            entries.append(struct.pack("<HHI", tag, kind, len(vals)) + payload.ljust(4, b"\0"))
        else:
            entries.append(struct.pack("<HHII", tag, kind, len(vals), spill_at + len(spill)))
            spill += payload
    body += struct.pack("<H", len(tags)) + b"".join(entries) + struct.pack("<I", 0) + spill
    return bytes(body)
