"""TIFF reading and writing without OpenCV or libtiff.

`decode` gives the RGB pixels of ``cv2.imread(path, IMREAD_COLOR)`` (then
BGR->RGB) as OpenCV 5.0 reads them through libtiff 4.7's RGBA interface
(``TIFFReadRGBAStrip``/``TIFFReadRGBATile``): the first page of a classic
TIFF or a BigTIFF (8-byte offsets, 20-byte entries, LONG8/SLONG8/IFD8
values), little- or big-endian, in strips or tiles,

* compression 1 (none), 5 (LZW), 8 and 32946 (Deflate, inflated with
  ``zlib``) and 32773 (PackBits); LZW, PackBits and the predictor are in
  ``codecs.cpp``;
* compression 7 (JPEG-in-TIFF): each strip or tile its own JPEG stream after
  the ``JPEGTables`` tables-only stream, decoded by ``imread.cpp``'s JPEG
  decoder at its frame size and cropped; YCbCr (any ``YCbCrSubsampling`` of
  the JPEG's own, GDAL's 4:2:0 tiles among them) is upsampled and converted
  by libjpeg's arithmetic at each strip's or tile's edges, as libtiff's
  ``JPEGCOLORMODE_RGB`` asks; gray, RGB and CMYK come out as stored;
* compression 2, 3 and 4 (CCITT RLE, Group 3 1-D and 2-D, Group 4;
  ``FillOrder`` 2 too), decoded in ``codecs.cpp`` as libtiff's tif_fax3.c
  decodes them, damaged rows cut or padded as it does;
* predictor 2 (horizontal differencing) at 8 and 16 bits;
* planar configuration 1 (contiguous) and 2 (separate planes);
* photometric 0 (MinIsWhite, inverted) and 1 (MinIsBlack) at 1, 8 and 16
  bits, 2 (RGB) at 8 and 16 bits, 3 (palette, a 16-bit colour map taken
  as 8-bit when every entry is below 256) at 1 and 8 bits, 5 (CMYK, InkSet
  1, 8 bits: libtiff's integer ``k * (255 - c) / 255``), 6 (YCbCr, 8 bits:
  the subsampled blocks of ``putcontig8bitYCbCr*tile`` and the fixed-point
  tables of ``TIFFYCbCrToRGBInit`` from ``YCbCrCoefficients`` and
  ``ReferenceBlackWhite``) and 8 (CIELab at 8 and 16 bits: libtiff's float
  ``TIFFCIELabToXYZ`` and ``TIFFXYZToRGB`` with its sRGB display tables);
* 16-bit samples reduced to 8 bits as libtiff's RGBA interface reduces them:
  (v + 128) // 257 for RGB, the high byte for gray;
* an alpha extra sample: unassociated alpha multiplies RGB (and a separate
  plane's gray) by it, ``(v * a + 127) // 255``, associated or unspecified
  alpha leaves them; the alpha itself is dropped;
* orientation 1-4: 2 and 3 mirror each strip or tile left-right in place, 3
  and 4 flip the image top-bottom, as OpenCV's TIFF decoder does; 5-8 raise
  `ValueError` (OpenCV returns nothing for them).

Old-style JPEG (6), ThunderScan, CCITT RLEW, SGILog, JPEG 2000 and other
compressions, and ICCLab, ITULab and LogL/LogLuv photometrics raise
`NotImplementedError`. What OpenCV 5.0 reads nothing of raises `ValueError`:
2-, 4-, 12- and 32-bit samples, float samples, LZMA, Zstandard and
WebP-in-TIFF (not configured in its libtiff), more than four samples a
pixel, CMYK with another InkSet or in 16 bits, planar CMYK with alpha,
planar CIELab, YCbCr with other than three 8-bit samples or subsampled in
planes, and data cut short or damaged past what libtiff repairs.

`encode` writes an 8-bit gray or RGB TIFF: LZW (the layout OpenCV writes,
with predictor 2 in one strip), Deflate or none, in one strip or in tiles.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I", 16: "Q", 17: "q", 18: "Q"}
_NOT_PORTED_COMPRESSION = {6: "old-style JPEG", 32809: "ThunderScan", 32771: "CCITT RLEW", 34676: "SGILog",
                           34677: "SGILog24", 34712: "JPEG 2000"}
# compressions OpenCV 5.0's libtiff is built without: it reads nothing of them
_NOT_CONFIGURED = {34925: "LZMA", 50000: "Zstandard", 50001: "WebP-in-TIFF"}
_NOT_PORTED_PHOTOMETRIC = {9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
_READ_COMPRESSION = (1, 2, 3, 4, 5, 7, 8, 32946, 32773)
_PREDICTED = (5, 8, 32946)  # the codecs that libtiff's predictor runs with (LZW, Deflate)
T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_FILL_ORDER, T_STRIP_OFFSETS, T_ORIENTATION, T_SPP, T_ROWS_PER_STRIP, T_STRIP_BYTES = 266, 273, 274, 277, 278, 279
T_PLANAR, T_T4_OPTIONS, T_PREDICTOR, T_WHITE_POINT, T_COLORMAP = 284, 292, 317, 318, 320
T_TILE_WIDTH, T_TILE_LENGTH, T_TILE_OFFSETS, T_TILE_BYTES = 322, 323, 324, 325
T_INK_SET, T_EXTRA_SAMPLES, T_SAMPLE_FORMAT, T_JPEG_TABLES = 332, 338, 339, 347
T_YCBCR_COEFFICIENTS, T_YCBCR_SUBSAMPLING, T_REFERENCE_BLACK_WHITE = 529, 530, 532


def _first_ifd(data: bytes, path) -> Tuple[str, Dict[int, list]]:
    """Byte order ('<' or '>') and the first IFD's tags: numbers, rationals
    as float32 quotients (libtiff's ``(float)num / (float)den``, 0 for a zero
    denominator), and UNDEFINED values as their bytes."""
    if data[:4] not in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        raise ValueError(f"{path}: not a TIFF file")
    end = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big:  # BigTIFF: offset size 8, then an 8-byte first offset
        if len(data) < 16 or struct.unpack(end + "HH", data[4:8]) != (8, 0):
            raise ValueError(f"{path}: bad BigTIFF header")
        at = struct.unpack(end + "Q", data[8:16])[0]
        n_fmt, count_fmt, entry, inline, off_fmt = "Q", "Q", 20, 8, "Q"
    else:
        at = struct.unpack(end + "I", data[4:8])[0]
        n_fmt, count_fmt, entry, inline, off_fmt = "H", "I", 12, 4, "I"
    head = struct.calcsize(n_fmt)
    if at + head > len(data):
        raise ValueError(f"{path}: the first IFD lies past the end of the file")
    tags: Dict[int, list] = {}
    for i in range(struct.unpack(end + n_fmt, data[at:at + head])[0]):
        e = at + head + entry * i
        if e + entry > len(data):
            raise ValueError(f"{path}: the IFD is cut short")
        tag, kind = struct.unpack(end + "HH", data[e:e + 4])
        count = struct.unpack(end + count_fmt, data[e + 4:e + 4 + struct.calcsize(count_fmt)])[0]
        fmt = _TYPES.get(kind)
        if fmt is None:
            continue
        size = struct.calcsize(fmt) * count
        value_at = e + entry - inline
        off = value_at if size <= inline else struct.unpack(end + off_fmt, data[value_at:value_at + inline])[0]
        if off + size > len(data):
            raise ValueError(f"{path}: tag {tag} points past the end of the file")
        raw = data[off:off + size]
        if kind == 7:
            tags[tag] = raw
        elif kind in (5, 10):
            pairs = np.array(struct.unpack(end + fmt[0] * (2 * count), raw), np.float32).reshape(-1, 2)
            with np.errstate(divide="ignore", invalid="ignore"):
                tags[tag] = list(np.where(pairs[:, 1] == 0, np.float32(0), pairs[:, 0] / pairs[:, 1]))
        else:
            tags[tag] = list(struct.unpack(end + fmt * count, raw))
    return end, tags


def _one(tags, tag, default):
    return tags[tag][0] if tag in tags and len(tags[tag]) else default


def _size(tags, path) -> Tuple[int, int]:
    """``(ImageLength, ImageWidth)`` of the first IFD."""
    if T_WIDTH not in tags or T_LENGTH not in tags:
        raise ValueError(f"{path}: no image size")
    return int(_one(tags, T_LENGTH, 0)), int(_one(tags, T_WIDTH, 0))


def stored_shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` as PIL reports it: the first IFD's size, swapped for
    orientations 5-8 (PIL's TIFF reader turns those)."""
    _, tags = _first_ifd(data, path)
    h, w = _size(tags, path)
    return (w, h) if _one(tags, T_ORIENTATION, 1) in (5, 6, 7, 8) else (h, w)


def shape(data: bytes, path) -> Tuple[int, int]:
    """``(h, w)`` as `decode` returns it; `ValueError` for the kinds OpenCV
    reads nothing of that the tags show (orientations 5-8 among them)."""
    _, tags = _first_ifd(data, path)
    try:
        _refuse(tags, _one(tags, T_COMPRESSION, 1), _one(tags, T_PHOTOMETRIC, -1), _one(tags, T_SPP, 1),
                tags.get(T_BITS, [1])[0], _one(tags, T_PLANAR, 1), path)
    except NotImplementedError:
        pass  # a kind not ported: its size is known, `decode` names it
    return _size(tags, path)


def _inflate_block(data: bytes, comp: int, size: int, path, need: Optional[int] = None) -> np.ndarray:
    """The first ``size`` bytes of one decompressed strip or tile; at least
    ``need`` (default ``size``) must be there, the rest is zero."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    need = size if need is None else need
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
    if n < need:
        raise ValueError(f"{path}: a strip or tile holds {n} of its {need} bytes")
    out[need:] = 0
    return out


def _fax_block(data: bytes, comp: int, tags, rows: int, width: int, path) -> np.ndarray:
    """One CCITT-coded strip or tile: ``uint8 [rows, width]`` bits, black 1.
    Where libtiff fails the strip, the rows it decoded before the fault are
    kept and the rest are white (0), as OpenCV shows them."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    rowbytes = (width + 7) // 8
    out = np.zeros(rows * rowbytes, np.uint8)
    src = np.frombuffer(data, np.uint8)
    two_d = comp == 3 and int(_one(tags, T_T4_OPTIONS, 0)) & 1
    lsb = _one(tags, T_FILL_ORDER, 1) == 2
    codecs_library().tiff_fax_decode(src.ctypes.data, src.size, comp, int(two_d), int(lsb), width, rows,
                                     out.ctypes.data)
    return np.unpackbits(out.reshape(rows, rowbytes), axis=1)[:, :width]


def _ycbcr_block(raw: np.ndarray, rows: int, width: int, hs: int, vs: int, stride: int) -> np.ndarray:
    """Subsampled YCbCr blocks (``hs * vs`` Y, then Cb and Cr), a row of
    blocks every ``stride`` bytes -> ``[rows, width, 3]`` Y, Cb, Cr, each
    pixel with its block's chroma."""
    nby, nbx, size = -(-rows // vs), -(-width // hs), hs * vs + 2
    take = (np.arange(nby)[:, None] * stride + np.arange(nbx * size)[None]).reshape(nby, nbx, size)
    blocks = raw[take]
    y = blocks[..., :hs * vs].reshape(nby, nbx, vs, hs).transpose(0, 2, 1, 3).reshape(nby * vs, nbx * hs)
    cb = np.repeat(np.repeat(blocks[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(blocks[..., -1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], -1)[:rows, :width]


def _refuse(tags, comp: int, photometric: int, spp: int, bits: int, planar: int, path) -> None:
    """Raise for what is not read: `NotImplementedError` for a kind not
    ported, `ValueError` for what OpenCV 5.0 reads nothing of."""
    if comp in _NOT_PORTED_COMPRESSION:
        raise NotImplementedError(f"{path}: {_NOT_PORTED_COMPRESSION[comp]} compression ({comp}) is not read")
    if comp in _NOT_CONFIGURED:
        raise ValueError(f"{path}: OpenCV's libtiff is built without {_NOT_CONFIGURED[comp]} compression ({comp})")
    if comp not in _READ_COMPRESSION:
        raise NotImplementedError(f"{path}: TIFF compression {comp} is not read")
    if photometric in _NOT_PORTED_PHOTOMETRIC:
        raise NotImplementedError(f"{path}: {_NOT_PORTED_PHOTOMETRIC[photometric]} photometric ({photometric}) "
                                  "is not read")
    if photometric not in (0, 1, 2, 3, 5, 6, 8):
        raise ValueError(f"{path}: photometric {photometric}")
    if _one(tags, T_SAMPLE_FORMAT, 1) == 3 or _one(tags, T_PREDICTOR, 1) == 3:
        raise ValueError(f"{path}: OpenCV does not read float TIFF samples")
    if bits not in (1, 8, 16):
        raise ValueError(f"{path}: OpenCV does not read {bits}-bit TIFF samples")
    if not 1 <= spp <= 4:
        raise ValueError(f"{path}: OpenCV reads 1 to 4 samples a pixel, not {spp}")
    if bits == 1 and spp != 1:
        raise ValueError(f"{path}: 1-bit samples with {spp} samples a pixel")
    if comp in (2, 3, 4) and bits != 1:
        raise ValueError(f"{path}: CCITT compression of {bits}-bit samples")
    if comp == 7 and bits != 8:
        raise ValueError(f"{path}: JPEG-in-TIFF of {bits}-bit samples")
    if photometric == 2 and spp < 3:
        raise ValueError(f"{path}: RGB with {spp} samples a pixel")
    if photometric == 3 and bits == 16:
        raise ValueError(f"{path}: 16-bit palette images are not read by OpenCV")
    if photometric == 5 and (_one(tags, T_INK_SET, 1) != 1 or spp < 4 or bits != 8 or (planar == 2 and spp != 4)):
        raise ValueError(f"{path}: OpenCV reads 8-bit CMYK (InkSet 1) of four samples a pixel only")
    if photometric == 6 and comp != 7 and (spp != 3 or bits != 8):
        raise ValueError(f"{path}: OpenCV reads YCbCr of three 8-bit samples only")
    if photometric == 8 and (spp != 3 or planar == 2 or bits == 1):
        raise ValueError(f"{path}: OpenCV reads contiguous CIELab of three 8- or 16-bit samples only")
    orientation = _one(tags, T_ORIENTATION, 1)
    if orientation in (5, 6, 7, 8):
        raise ValueError(f"{path}: OpenCV does not read TIFF orientation {orientation}")
    if _one(tags, T_PREDICTOR, 1) == 2 and bits == 1 and comp in _PREDICTED:
        raise ValueError(f"{path}: horizontal differencing of 1-bit samples")


def decode(data: bytes, path) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]``: OpenCV's pixels of the first page."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library, decode_jpeg_segment, jpeg_frame

    end, tags = _first_ifd(data, path)
    h, w = _size(tags, path)
    comp = _one(tags, T_COMPRESSION, 1)
    photometric = _one(tags, T_PHOTOMETRIC, -1)
    spp = _one(tags, T_SPP, 1)
    bits = tags.get(T_BITS, [1])[0]
    planar = _one(tags, T_PLANAR, 1)
    predictor = _one(tags, T_PREDICTOR, 1) if comp in _PREDICTED else 1
    orientation = _one(tags, T_ORIENTATION, 1)
    _refuse(tags, comp, photometric, spp, bits, planar, path)
    extras = tags.get(T_EXTRA_SAMPLES, [])
    alpha = 0  # libtiff's img->alpha: 0, 1 associated, 2 unassociated
    if extras:
        alpha = 1 if extras[0] == 0 and spp > 3 else extras[0] if extras[0] in (1, 2) else 0
    elif spp == 4 and photometric == 2:
        alpha = 1  # libtiff's DEFAULT_EXTRASAMPLE_AS_ALPHA
    separate = planar == 2 and spp > 1

    tiled = T_TILE_WIDTH in tags
    if tiled:
        bw, bh = int(_one(tags, T_TILE_WIDTH, 0)), int(_one(tags, T_TILE_LENGTH, 0))
        offsets, counts = tags.get(T_TILE_OFFSETS, []), tags.get(T_TILE_BYTES, [])
    else:
        bw, bh = w, int(min(_one(tags, T_ROWS_PER_STRIP, h), h)) or h
        offsets, counts = tags.get(T_STRIP_OFFSETS, []), tags.get(T_STRIP_BYTES, [])
    if bw <= 0 or bh <= 0:
        raise ValueError(f"{path}: bad strip or tile size")
    across, down = -(-w // bw), -(-h // bh)
    planes = spp if separate else 1
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError(f"{path}: {len(offsets)} strips or tiles for {across * down * planes}")
    per_pixel = 1 if separate else spp
    jpeg = comp == 7
    hs, vs = 1, 1
    if photometric == 6:
        if T_YCBCR_SUBSAMPLING in tags:
            hs, vs = (int(v) for v in tags[T_YCBCR_SUBSAMPLING][:2])
        elif jpeg and offsets:  # libtiff's JPEGFixupTagsSubsampling: the first segment's frame
            hs, vs = jpeg_frame(data[offsets[0]:offsets[0] + counts[0]], path)[3]
        else:
            hs, vs = 2, 2  # the TIFF default
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise ValueError(f"{path}: YCbCr subsampling {hs} x {vs}")
        if separate and (hs, vs) != (1, 1):
            raise ValueError(f"{path}: OpenCV does not read YCbCr subsampled in separate planes")
        if not jpeg and (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
            raise ValueError(f"{path}: OpenCV does not read YCbCr subsampled {hs} x {vs}")  # no putcontig8bitYCbCr
        if predictor == 2 and (hs, vs) != (1, 1):
            raise NotImplementedError(f"{path}: horizontal differencing of subsampled YCbCr is not read")
    # libtiff's JPEGCOLORMODE_RGB: libjpeg upsamples and converts contiguous YCbCr, and hands over RGB
    jpeg_ycc = jpeg and photometric == 6 and not separate
    if jpeg_ycc:
        photometric = 2
    subsampled = photometric == 6 and (hs, vs) != (1, 1)
    tables = bytes(tags.get(T_JPEG_TABLES, b""))
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
                segment = data[offsets[k]:offsets[k] + counts[k]]
                if jpeg:
                    block = decode_jpeg_segment(segment, tables, per_pixel, (hs, vs), jpeg_ycc, path)
                    last_strip = not tiled and ty == down - 1
                    if block.shape[1] != bw or block.shape[0] < rows or (block.shape[0] > rows and not last_strip):
                        raise ValueError(f"{path}: a JPEG strip or tile of {block.shape[:2]} for {(rows, bw)}")
                    block = block[:rows]
                elif comp in (2, 3, 4):
                    block = _fax_block(segment, comp, tags, rows, bw, path)[..., None]
                elif subsampled:
                    nby, nbx = -(-rows // vs), -(-bw // hs)
                    size = nby * nbx * (hs * vs + 2)
                    # libtiff reads whole sampling rows, scanline = row bytes // vs at a time
                    need = size if tiled else nby * vs * (nbx * (hs * vs + 2) // vs)
                    # a clipped tile's rows of blocks: libtiff's putcontig8bitYCbCr*tile skip the hidden
                    # blocks, putcontig8bitYCbCr44tile by 10 bytes a block where a block holds 18
                    visible = min(bw, w - tx * bw)
                    stride = nbx * (hs * vs + 2)
                    if (hs, vs) == (4, 4) and visible < bw:
                        stride = -(-visible // 4) * 18 + (bw - visible) // 4 * 10
                    raw = _inflate_block(segment, comp, size, path, need)
                    block = np.zeros((rows, bw, 3), np.uint8)
                    block[:, :visible] = _ycbcr_block(raw, rows, visible, hs, vs, stride)
                else:
                    raw = _inflate_block(segment, comp, rows * row_bytes, path)
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


def _ycbcr_to_rgb(s: np.ndarray, tags, path) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables (float ``Code2V`` from the
    coefficients and reference black and white, then fixed point) and
    TIFFYCbCrtoRGB, on 8-bit Y, Cb, Cr samples."""
    f = np.float32
    luma = [f(v) for v in tags.get(T_YCBCR_COEFFICIENTS, [f(0.299), f(0.587), f(0.114)])[:3]]
    ref = [f(v) for v in tags.get(T_REFERENCE_BLACK_WHITE, [0, 255, 128, 255, 128, 255])[:6]]
    if len(luma) < 3 or len(ref) < 6 or not np.isfinite(luma).all() or luma[1] < f(1e-9):
        raise ValueError(f"{path}: bad YCbCrCoefficients or ReferenceBlackWhite")
    if not all(f(-0x7FFFFFFF + 128) < v < f(0x7FFFFFFF) for v in ref):
        raise ValueError(f"{path}: ReferenceBlackWhite out of range")

    def fix(x):  # FIX: (int32)(x * 65536 + 0.5), in double
        return int(float(x) * 65536.0 + 0.5)

    def clampf(v, lo, hi):
        return lo if not v >= lo else hi if v > hi else v

    f1 = f(2) - f(2) * luma[0]
    d1 = fix(clampf(f1, f(0), f(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clampf(f2, f(0), f(2)))
    f3 = f(2) - f(2) * luma[2]
    d3 = fix(clampf(f3, f(0), f(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clampf(f4, f(0), f(2)))

    def code2v(c, rb, rw, cr):  # ((c - (int32)RB) * (float)CR) / (float)(RW - RB ? RW - RB : 1)
        span = rw - rb
        return f(f(c - int(rb)) * f(cr)) / (span if span != 0 else f(1))

    x = np.arange(-128, 128)
    lim = f(128 * 32)

    def table(rb, rw, cr, shift=0):
        v = np.array([code2v(c + shift, rb, rw, cr) for c in x], np.float32)
        return np.clip(v, -lim, lim).astype(np.int64)  # CLAMPw, then (int32) truncation

    cr = table(ref[4] - f(128), ref[5] - f(128), 127)
    cb = table(ref[2] - f(128), ref[3] - f(128), 127)
    y_tab = table(ref[0], ref[1], 255, 128)
    half = 1 << 15
    cr_r, cb_b = (d1 * cr + half) >> 16, (d3 * cb + half) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + half
    y, b_, r_ = y_tab[s[..., 0]], s[..., 1], s[..., 2]
    rgb = np.stack([y + cr_r[r_], y + ((cb_g[b_] + cr_g[r_]) >> 16), y + cb_b[b_]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cielab_to_rgb(s: np.ndarray, tags, bits: int, path) -> np.ndarray:
    """libtiff's putcontig8bitCIELab8/16: TIFFCIELab16ToXYZ and TIFFXYZToRGB
    in float32, with TIFFCIELabToRGBInit's sRGB tables (1500 steps, gamma
    2.4) and the white point (D50 by default)."""
    f = np.float32
    white = [f(v) for v in tags.get(T_WHITE_POINT, [])[:2]]
    if len(white) < 2:
        total = f(96.4250) + f(100.0) + f(82.4680)
        white = [f(96.4250) / total, f(100.0) / total]
    if white[1] == 0:
        raise ValueError(f"{path}: bad WhitePoint")
    x0 = white[0] / white[1] * f(100)
    y0 = f(100)
    z0 = (f(1) - white[0] - white[1]) / white[1] * f(100)
    if bits == 8:
        l_, a, b = s[..., 0].astype(np.float32) * f(257), s[..., 1].view(np.int8) * f(256), s[..., 2].view(np.int8) * f(256)
    else:
        l_, a, b = s[..., 0].astype(np.float32), s[..., 1].view(np.int16).astype(np.float32), s[..., 2].view(np.int16).astype(np.float32)
    with np.errstate(all="ignore"):
        lum = l_ * f(100) / f(65535)
        low = lum < f(8.856)
        y_low = lum * y0 / f(903.292)
        cby = np.where(low, f(7.787) * (y_low / y0) + f(16) / f(116), (lum + f(16)) / f(116))
        y = np.where(low, y_low, y0 * cby * cby * cby)
        t = a / f(256) / f(500) + cby
        x = np.where(t < f(0.2069), x0 * (t - f(0.13793)) / f(7.787), x0 * t * t * t)
        t = cby - b / f(256) / f(200)
        z = np.where(t < f(0.2069), z0 * (t - f(0.13793)) / f(7.787), z0 * t * t * t)
        matrix = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416], [0.0556, -0.2040, 1.0570]],
                          np.float32)
        step = (f(100) - f(1)) / f(1500)
        gamma = 1.0 / float(f(2.4))  # (float)pow((double)i / range, 1.0 / d_gammaR), then * d_Vrwr in float
        levels = np.array([f(255) * f(pow(i / 1500, gamma)) for i in range(1501)], np.float64)
        out = []
        for row in matrix:
            lin = row[0] * x + row[1] * y + row[2] * z
            lin = np.minimum(np.maximum(lin, f(1)), f(100))
            i = np.minimum(((lin - f(1)) / step).astype(np.int64), 1500)
            v = levels[i]
            out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


def _to_rgb(samples: np.ndarray, tags, photometric: int, bits: int, alpha: int, separate: bool, path
            ) -> np.ndarray:
    """libtiff's put*tile conversions to 8-bit RGB."""
    if photometric == 2 and bits == 8 and alpha != 2:  # the common case, as stored
        return samples[..., :3]
    if photometric == 6:
        return _ycbcr_to_rgb(samples, tags, path)
    if photometric == 8:
        return _cielab_to_rgb(samples, tags, bits, path)
    s = samples.astype(np.int64)
    if photometric == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        k = 255 - s[..., 3:4]
        return (k * (255 - s[..., :3]) // 255).astype(np.uint8)
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


def lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW of ``raw`` (``codecs.cpp``)."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    src = np.frombuffer(raw, np.uint8)
    cap = len(raw) * 2 + 64
    out = np.empty(cap, np.uint8)
    return out[:codecs_library().tiff_lzw_encode(src.ctypes.data, src.size, out.ctypes.data, cap)].tobytes()


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
                raw = lzw_encode(raw)
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
