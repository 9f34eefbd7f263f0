"""Write the BMP, TIFF and WebP fixtures and the digests of the pixels OpenCV decodes.

    python tests/fixtures/make_image_fixtures.py

Writes ``tests/fixtures/image/*`` and ``image_fixtures.json``: for each file
the shape and the SHA-256 of ``cv2.cvtColor(cv2.imread(file), BGR2RGB)``'s
bytes, the stored ``(h, w)`` PIL gives, and, for a file the port refuses,
the exception it raises (``NotImplementedError`` for a kind not ported,
``ValueError`` where OpenCV reads nothing). The card's machine has no OpenCV
or PIL and checks the port's readers against these digests.

* BMP: OpenCV's 24-bit and gray files, and hand-built ones: RLE8 (runs,
  absolute runs, delta, end of line, early end of bitmap), RLE4 top-down,
  an OS/2 1-bit file, 16-bit 5-6-5 and 5-5-5, a 4-bit V4 file and a 32-bit
  V5 file with RGBA masks;
* TIFF: OpenCV's LZW file, PIL's Deflate, PackBits, RGBA, palette, bilevel,
  16-bit gray and JPEG-in-TIFF files, and hand-built ones: big-endian tiles
  with Deflate and predictor 2, 16-bit RGB planes, 16-bit MinIsWhite tiles
  (libtiff's skewed right tiles), orientations 3 and 6;
* WebP: OpenCV's lossless and lossy files (q 5, 50, 95 at 1x1, 17x33 and
  130x70), PIL's lossless RGBA and a lossless file with meta prefix codes and
  the colour cache, palette files of 2, 4, 12 and 200 colours
  (colour indexing with and without bundling), lossy RGBA, lossy with EXIF
  orientation 6, two animations, and, through the libwebp that PIL bundles,
  2, 4 and 8 token partitions, the simple loop filter, sharpness 7 with one segment;
  ``webp_1024_q75.webp`` is the 1024 x 1024 lossy frame the card's decode
  timing reads.

Needs OpenCV 5.0 and PIL 12 (with its bundled libwebp).
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "image"
DIGESTS = HERE / "image_fixtures.json"


def image(h: int, w: int, c: int = 3, seed: int = 0, noise: int = 12) -> np.ndarray:
    """A gradient with noise and filled rectangles, uint8 ``[h, w, c]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1), (xx + yy) * 255 // (h + w),
                   (xx * yy) % 256], -1)[..., :c]
    for _ in range(4):
        y0, x0 = rng.integers(0, max(1, h - 8)), rng.integers(0, max(1, w - 8))
        im[y0:y0 + rng.integers(4, 20), x0:x0 + rng.integers(4, 20)] = rng.integers(0, 256, c)
    return np.clip(im + rng.integers(-noise, noise + 1, im.shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- BMP


def bmp_file(pixels: bytes, w: int, h: int, bpp: int, comp: int = 0, palette=None, header: int = 40,
             masks=None) -> bytes:
    """A BMP file; ``palette`` [n, 3] RGB; ``masks`` in the header (V4/V5) or after it (INFO)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        pal = (p[:, ::-1] if header == 12 else np.concatenate([p[:, ::-1], np.zeros((len(p), 1), np.uint8)], 1)
               ).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, comp, len(pixels), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header >= 108:
            m = list(masks or ()) + [0] * (4 - len(masks or ()))
            info += struct.pack("<IIII", *m[:4]) + b"BGRs" + b"\0" * 48 + (b"\0" * 16 if header == 124 else b"")
    after = struct.pack("<III", *masks[:3]) if masks is not None and header == 40 else b""
    off = 14 + len(info) + len(after) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + after + pal + pixels


def packed_rows(idx: np.ndarray, bpp: int) -> bytes:
    """Palette indices [h, w] as BMP rows of ``bpp`` bits, padded to 4 bytes."""
    h, w = idx.shape
    bits = ((idx[..., None] >> np.arange(bpp - 1, -1, -1)) & 1).astype(np.uint8).reshape(h, w * bpp)
    rows = np.packbits(bits, axis=1)
    pitch = (rows.shape[1] + 3) & -4
    return np.pad(rows, ((0, 0), (0, pitch - rows.shape[1]))).tobytes()


def rle(ops, four_bit: bool = False) -> bytes:
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            out += bytes([op[1], op[2]])
        elif op[0] == "abs":
            d = list(op[1])
            if four_bit:
                packed = [(d[i] << 4) | (d[i + 1] if i + 1 < len(d) else 0) for i in range(0, len(d), 2)]
                packed += [0] * (((((len(d) + 1) >> 1) + 1) & ~1) - len(packed))
                out += bytes([0, len(d)]) + bytes(packed)
            else:
                out += bytes([0, len(d)]) + bytes(d) + (b"\0" if len(d) % 2 else b"")
        elif op[0] == "delta":
            out += bytes([0, 2, op[1], op[2]])
        else:
            out += {"eol": b"\0\0", "eob": b"\0\1"}[op[0]]
    return bytes(out)


def bmp_fixtures(rng):
    import cv2

    files = {}
    im = image(29, 37, seed=1)
    cv2.imwrite(str(OUT / "bmp_cv2_rgb24.bmp"), im[..., ::-1])
    cv2.imwrite(str(OUT / "bmp_cv2_gray8.bmp"), im[..., 1])
    pal = rng.integers(0, 256, (256, 3))
    ops8 = [("run", 5, 3), ("abs", range(10, 23)), ("run", 22, 7), ("eol",), ("run", 40, 1), ("eol",),
            ("run", 3, 9), ("delta", 7, 2), ("run", 6, 4), ("abs", [1, 2, 3]), ("eol",)]
    for k in range(14):  # rows 5-18: whole absolute rows, two runs, and short rows ended early
        ops8 += [[("abs", range(k, k + 40))], [("run", 20, 200 + k), ("run", 20, 100 + k)],
                 [("run", 13, 50 + k)]][k % 3] + [("eol",)]
    files["bmp_rle8_delta.bmp"] = bmp_file(rle(ops8 + [("run", 13, 5), ("eob",)]), 40, 24, 8, 1, pal)
    ops4 = [("run", 9, 0x5A), ("abs", [1, 2, 3, 4, 5]), ("eol",), ("delta", 4, 1), ("run", 7, 0x3C), ("eol",)]
    for k in range(8):
        ops4 += [("run", 31, 0x12 + k), ("eol",)]
    ops4 += [("abs", list(range(15))), ("eol",), ("eol",)]
    files["bmp_rle4_topdown.bmp"] = bmp_file(rle(ops4, True), 31, -12, 4, 2, pal[:16])
    idx = rng.integers(0, 2, (21, 35))
    files["bmp_core_1bit.bmp"] = bmp_file(packed_rows(idx, 1), 35, 21, 1, 0, pal[:2], header=12)
    idx = rng.integers(0, 16, (19, 27))
    files["bmp_v4_4bit.bmp"] = bmp_file(packed_rows(idx, 4), 27, 19, 4, 0, pal[:11], header=108)
    px16 = rng.integers(0, 65536, (17, 23)).astype("<u2")
    rows16 = np.pad(px16.view(np.uint8).reshape(17, 46), ((0, 0), (0, 2))).tobytes()
    files["bmp_bitfields_565.bmp"] = bmp_file(rows16, 23, 17, 16, 3, masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_rgb555.bmp"] = bmp_file(rows16, 23, -17, 16, 0)
    px32 = rng.integers(0, 256, (13, 19 * 4), dtype=np.uint8).tobytes()
    files["bmp_v5_32_rgba_masks.bmp"] = bmp_file(px32, 19, -13, 32, 3, header=124,
                                                  masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    for name, data in files.items():
        (OUT / name).write_bytes(data)


# ---------------------------------------------------------------- TIFF


_TAG_FORMATS = {1: "B", 3: "H", 4: "I", 5: "II", 11: "f", 16: "Q"}


def lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW of ``raw``, by the port's encoder (``codecs.cpp``)."""
    from quan_ultralytics_tpu_torch.data.native.tiff import lzw_encode as encode

    return encode(raw)


def tiff_container(blocks, tags: dict, big_endian: bool = False, big: bool = False, tile: bool = False) -> bytes:
    """A TIFF (``big``: a BigTIFF, 8-byte offsets and 20-byte entries) of
    ready strips or tiles ``blocks`` (bytes each); ``tags`` maps a tag to
    ``(type, values)``: types 1, 3, 4, 11 and 16 take numbers, 5 (RATIONAL)
    ``(numerator, denominator)`` pairs, 7 (UNDEFINED) bytes. The strip or
    tile offsets and byte counts are added (LONG8 in a BigTIFF)."""
    end = ">" if big_endian else "<"
    body = bytearray(struct.pack(end + "2sHHHQ", b"MM" if big_endian else b"II", 43, 8, 0, 0) if big
                     else struct.pack(end + "2sHI", b"MM" if big_endian else b"II", 42, 0))
    offsets = []
    for raw in blocks:
        offsets.append(len(body))
        body += raw + (b"\0" if len(raw) & 1 else b"")
    t = dict(tags)
    word = 16 if big else 4
    t[324 if tile else 273] = (word, offsets)
    t[325 if tile else 279] = (word, [len(b) for b in blocks])
    ifd_at = len(body)
    struct.pack_into(end + ("Q" if big else "I"), body, 8 if big else 4, ifd_at)
    entry, inline = (20, 8) if big else (12, 4)
    entries, spill = [], bytearray()
    spill_at = ifd_at + (8 if big else 2) + entry * len(t) + (8 if big else 4)
    for tag in sorted(t):
        kind, vals = t[tag]
        if kind == 7:
            payload, count = bytes(vals), len(vals)
        elif kind == 5:
            payload, count = struct.pack(end + "II" * len(vals), *[v for pair in vals for v in pair]), len(vals)
        else:
            payload, count = struct.pack(end + _TAG_FORMATS[kind] * len(vals), *vals), len(vals)
        head = struct.pack(end + ("HHQ" if big else "HHI"), tag, kind, count)
        if len(payload) <= inline:
            entries.append(head + payload.ljust(inline, b"\0"))
        else:
            entries.append(head + struct.pack(end + ("Q" if big else "I"), spill_at + len(spill)))
            spill += payload + (b"\0" if len(payload) & 1 else b"")
    body += struct.pack(end + ("Q" if big else "H"), len(t)) + b"".join(entries) + bytes(8 if big else 4) + spill
    return bytes(body)


def tiff_file(px: np.ndarray, tags: dict, big_endian=False, tile=None, planar=False, predictor=False,
              deflate=True, rows_per_strip=None, big=False, compress=None) -> bytes:
    """A TIFF file of ``px`` [h, w, c] (uint8 or uint16) with Deflate or no
    compression (or ``compress``: "lzw"), in strips of ``rows_per_strip`` rows
    (default: one) or square tiles; ``tags`` add to the baseline or replace
    its tags; ``big`` writes a BigTIFF."""
    end = ">" if big_endian else "<"
    h, w, c = px.shape
    bits = px.dtype.itemsize * 8
    bw, bh = (tile, tile) if tile else (w, rows_per_strip or h)
    planes = c if planar else 1
    code = {"lzw": 5}.get(compress, 8 if deflate else 1)
    blocks = []
    for p in range(planes):
        for ty in range(-(-h // bh)):
            for tx in range(-(-w // bw)):
                rows = bh if tile else min(bh, h - ty * bh)
                b = np.zeros((rows, bw, 1 if planar else c), px.dtype)
                part = px[ty * bh:ty * bh + bh, tx * bw:tx * bw + bw]
                part = part[..., p:p + 1] if planar else part
                b[:part.shape[0], :part.shape[1]] = part
                if predictor:
                    b = np.diff(b, axis=1, prepend=np.zeros((rows, 1, b.shape[2]), b.dtype))
                raw = b.astype(end + f"u{bits // 8}").tobytes()
                blocks.append(zlib.compress(raw) if code == 8 else lzw_encode(raw) if code == 5 else raw)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [code]),
         262: (3, [2 if c >= 3 else 1]), 277: (3, [c]), 284: (3, [2 if planar else 1])}
    if predictor:
        t[317] = (3, [2])
    if tile:
        t[322], t[323] = (4, [tile]), (4, [tile])
    else:
        t[278] = (4, [bh])
    t.update(tags)
    return tiff_container(blocks, t, big_endian, big, bool(tile))


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JPEG's (JFIF) RGB -> YCbCr, rounded, uint8 ``[h, w, 3]``: the samples a
    raw YCbCr TIFF stores (any values are valid input)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return np.clip(np.rint(np.stack([y, (b - y) / 1.772 + 128, (r - y) / 1.402 + 128], -1)), 0, 255).astype(np.uint8)


def ycbcr_file(ycc: np.ndarray, hs: int, vs: int, tags=None, tile=None, rows_per_strip=None, compress=None,
               big_endian=False, big=False) -> bytes:
    """A raw YCbCr TIFF (photometric 6) of ``ycc`` [h, w, 3] in libtiff's
    subsampled blocks (``hs * vs`` Y, then Cb and Cr, the chroma the block's
    mean), uncompressed, "lzw", "deflate" or "packbits" (runs of one byte)."""
    h, w, _ = ycc.shape
    bw, bh = (tile, tile) if tile else (w, rows_per_strip or h)
    blocks = []
    for ty in range(-(-h // bh)):
        for tx in range(-(-w // bw)):
            rows = bh if tile else min(bh, h - ty * bh)
            part = ycc[ty * bh:ty * bh + bh, tx * bw:tx * bw + bw]
            nby, nbx = -(-rows // vs), -(-bw // hs)
            pad = np.pad(part, ((0, nby * vs - part.shape[0]), (0, nbx * hs - part.shape[1]), (0, 0)), mode="edge")
            grid = pad.reshape(nby, vs, nbx, hs, 3).transpose(0, 2, 1, 3, 4)
            y = grid[..., 0].reshape(nby, nbx, vs * hs)
            chroma = np.rint(grid[..., 1:].reshape(nby, nbx, vs * hs, 2).mean(2)).astype(np.uint8)
            raw = np.concatenate([y, chroma], -1).tobytes()
            if compress == "lzw":
                raw = lzw_encode(raw)
            elif compress == "deflate":
                raw = zlib.compress(raw)
            elif compress == "packbits":
                raw = b"".join(bytes([0]) + raw[i:i + 1] for i in range(len(raw)))
            blocks.append(raw)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3]), 284: (3, [1]),
         259: (3, [{"lzw": 5, "deflate": 8, "packbits": 32773}.get(compress, 1)]), 530: (3, [hs, vs])}
    if tile:
        t[322], t[323] = (4, [tile]), (4, [tile])
    else:
        t[278] = (4, [bh])
    t.update(tags or {})
    return tiff_container(blocks, t, big_endian, big, bool(tile))


def jpeg_tables_split(stream: bytes):
    """A complete JPEG stream as JPEG-in-TIFF stores it: the abbreviated
    tables-only stream (SOI, its DQT and DHT segments, EOI) for the
    ``JPEGTables`` tag, and the stream without them (and without APPn)."""
    tables, rest, at = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while at < len(stream):
        marker = stream[at + 1]
        if marker == 0xDA:
            rest += stream[at:]
            break
        length = struct.unpack(">H", stream[at + 2:at + 4])[0]
        segment = stream[at:at + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += segment
        elif not 0xE0 <= marker <= 0xEF:
            rest += segment
        at += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def jpeg_tiff(px: np.ndarray, encode, photometric: int, subsampling=(1, 1), tile=None, rows_per_strip=None,
              tables=True, big_endian=False, big=False, tags=None) -> bytes:
    """A JPEG-in-TIFF file (compression 7) of ``px`` [h, w, c]: each strip or
    tile (edge tiles padded by replicating the edge) a JPEG stream from
    ``encode(uint8 [rows, cols, c]) -> bytes``; with ``tables`` the DQT and DHT
    segments move into ``JPEGTables`` (GDAL's and libtiff's layout) and the
    streams keep none. ``photometric``: 1 gray, 2 RGB (the streams hold RGB),
    6 YCbCr (the streams hold JPEG's YCbCr, ``subsampling`` the first
    component's factors), 5 CMYK."""
    h, w, c = px.shape
    bw, bh = (tile, tile) if tile else (w, rows_per_strip or h)
    blocks, table = [], None
    for ty in range(-(-h // bh)):
        for tx in range(-(-w // bw)):
            part = px[ty * bh:ty * bh + bh, tx * bw:tx * bw + bw]
            if tile:
                part = np.pad(part, ((0, bh - part.shape[0]), (0, bw - part.shape[1]), (0, 0)), mode="edge")
            stream = encode(np.ascontiguousarray(part))
            if tables:
                table, stream = jpeg_tables_split(stream)
            blocks.append(stream)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * c), 259: (3, [7]), 262: (3, [photometric]),
         277: (3, [c]), 284: (3, [1])}
    if photometric == 6:
        t[530] = (3, list(subsampling))
        t[532] = (5, [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)])
    if table is not None:
        t[347] = (7, table)
    if tile:
        t[322], t[323] = (4, [tile]), (4, [tile])
    else:
        t[278] = (4, [bh])
    t.update(tags or {})
    return tiff_container(blocks, t, big_endian, big, bool(tile))


def port_jpeg(part: np.ndarray) -> bytes:
    """The port's JPEG encoder (OpenCV's bytes: quality 95, YCbCr 4:2:0, or gray)."""
    from quan_ultralytics_tpu_torch.data.native.native import encode_jpeg

    return encode_jpeg(part[..., 0] if part.shape[-1] == 1 else part)


def gdal_jpeg_tiff(rgb: np.ndarray, tile: int = 256, big: bool = True) -> bytes:
    """GDAL's layout of RGB imagery (``COMPRESS=JPEG PHOTOMETRIC=YCBCR
    TILED=YES``): YCbCr 4:2:0 JPEG tiles sharing ``JPEGTables``, in a
    BigTIFF, by the port's encoder."""
    return jpeg_tiff(rgb, port_jpeg, 6, (2, 2), tile=tile, big=big)


def cmyk_of(rgb: np.ndarray, alpha=None) -> np.ndarray:
    """Naive RGB -> CMYK samples (K the darkest ink), uint8 ``[h, w, 4]``
    (``[h, w, 5]`` with an alpha plane)."""
    ink = 255 - rgb.astype(np.int64)
    k = ink.min(-1, keepdims=True)
    out = np.concatenate([ink - k, k], -1)
    if alpha is not None:
        out = np.concatenate([out, alpha[..., None]], -1)
    return out.astype(np.uint8)


# ---------------------------------------------------------------- CCITT (T.4, T.6) encoders

def _codes():
    """{(black, run): bits} of T.4's terminating, makeup and extended makeup codes."""
    wt = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
          "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
          "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
          "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
          "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
          "00110011 00110100").split()
    wm = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
          "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
          "010011000 010011001 010011010 011000 010011011").split()
    bt = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
          "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
          "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
          "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
          "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
          "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
          "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
          "000000101100 000001011010 000001100110 000001100111").split()
    bm = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
          "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
          "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
          "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
    xm = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
          "000000010111 000000011100 000000011101 000000011110 000000011111").split()
    codes = {}
    for black, term, makeup in ((False, wt, wm), (True, bt, bm)):
        codes.update({(black, i): c for i, c in enumerate(term)})
        codes.update({(black, 64 * (i + 1)): c for i, c in enumerate(makeup)})
        codes.update({(black, 1792 + 64 * i): c for i, c in enumerate(xm)})
    return codes


_CODES = None
_MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
          -3: "0000010"}  # vertical modes by a1 - b1
EOL = "000000000001"


def _span(out: list, run: int, black: bool) -> None:
    """libtiff's putspan: makeup codes of 2560 while the run is 2624 or more, one makeup, one terminating code."""
    global _CODES
    if _CODES is None:
        _CODES = _codes()
    while run >= 2624:
        out.append(_CODES[(black, 2560)])
        run -= 2560
    if run >= 64:
        out.append(_CODES[(black, run // 64 * 64)])
        run %= 64
    out.append(_CODES[(black, run)])


def _changes(row: np.ndarray, colour: int, start: int) -> int:
    """finddiff: the first position at or after ``start`` whose pixel is not ``colour`` (the width if none)."""
    idx = np.flatnonzero(row[start:] != colour)
    return start + int(idx[0]) if idx.size else len(row)


def _row_1d(out: list, row: np.ndarray) -> None:
    x, black = 0, False
    while True:
        end = _changes(row, int(black), x)
        _span(out, end - x, black)
        x, black = end, not black
        if x >= len(row):
            return


def _row_2d(out: list, row: np.ndarray, ref: np.ndarray) -> None:
    """libtiff's Fax3Encode2DRow (1 = black)."""
    w = len(row)
    px = lambda r, i: int(r[i]) if i < w else 0  # noqa: E731
    a0 = 0
    a1 = 0 if row[0] else _changes(row, 0, 0)
    b1 = 0 if ref[0] else _changes(ref, 0, 0)
    while True:
        b2 = _changes(ref, px(ref, b1), b1) if b1 < w else w
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = _changes(row, px(row, a1), a1) if a1 < w else w
                out.append(_MODES["H"])
                first_black = not (a0 + a1 == 0 or px(row, a0) == 0)
                _span(out, a1 - a0, first_black)
                _span(out, a2 - a1, not first_black)
                a0 = a2
            else:
                out.append(_MODES[-d])
                a0 = a1
        else:
            out.append(_MODES["P"])
            a0 = b2
        if a0 >= w:
            return
        colour = px(row, a0)
        a1 = _changes(row, colour, a0)
        b1 = _changes(ref, 1 - colour, a0)
        b1 = _changes(ref, colour, b1) if b1 < w else w


def _pack(bits: str, lsb_first: bool) -> bytes:
    bits += "0" * (-len(bits) % 8)
    data = np.packbits(np.frombuffer(bits.encode(), np.uint8) - 48)
    if lsb_first:
        data = np.unpackbits(data).reshape(-1, 8)[:, ::-1]
        data = np.packbits(data.reshape(-1))
    return data.tobytes()


def fax_encode(black: np.ndarray, mode: str, k: int = 2, align_eol: bool = False, lsb_first: bool = False,
               rtc: bool = True) -> bytes:
    """One strip of CCITT data of ``black`` (bool ``[rows, width]``, True
    black) as libtiff's encoder writes it: ``mode`` "rle" (Modified Huffman
    rows, byte-aligned, no EOL), "g3" (an EOL before each row, 1-D), "g3_2d"
    (EOL + a tag bit, every ``k``-th row 1-D), "g4" (2-D against the
    previous row, an EOFB at the end); ``align_eol`` pads each EOL to end on a
    byte boundary (T4Options bit 2), ``rtc`` ends Group 3 with six EOLs,
    ``lsb_first`` writes FillOrder 2."""
    rows = black.astype(np.uint8)
    ref = np.zeros(rows.shape[1], np.uint8)
    out: list = []

    def eol(tag=None):
        size = sum(map(len, out))
        if align_eol:
            out.append("0" * ((4 - size) % 8))
        out.append(EOL + ("" if tag is None else str(tag)))

    for i, row in enumerate(rows):
        if mode == "rle":
            _row_1d(out, row)
            size = sum(map(len, out))
            out.append("0" * (-size % 8))
        elif mode == "g3":
            eol()
            _row_1d(out, row)
        elif mode == "g3_2d":
            one_d = i % k == 0
            eol(1 if one_d else 0)
            if one_d:
                _row_1d(out, row)
            else:
                _row_2d(out, row, ref)
        else:
            _row_2d(out, row, ref)
        ref = row
    if mode.startswith("g3") and rtc:
        for _ in range(6):
            eol(1 if mode == "g3_2d" else None)
    if mode == "g4":
        out.append(EOL + EOL)
    return _pack("".join(out), lsb_first)


def fax_tiff(black: np.ndarray, mode: str, photometric: int = 0, rows_per_strip=None, tile=None, big=False,
             big_endian=False, **kw) -> bytes:
    """A CCITT TIFF of ``black`` (bool ``[h, w]``): compression 2 ("rle"), 3
    ("g3", "g3_2d": T4Options bit 0) or 4 ("g4"), each strip or tile encoded
    alone by `fax_encode` (``kw``), FillOrder 2 with ``lsb_first``."""
    h, w = black.shape
    bw, bh = (tile, tile) if tile else (w, rows_per_strip or h)
    blocks = []
    for ty in range(-(-h // bh)):
        for tx in range(-(-w // bw)):
            part = black[ty * bh:ty * bh + bh, tx * bw:tx * bw + bw]
            if tile:
                part = np.pad(part, ((0, bh - part.shape[0]), (0, bw - part.shape[1])))
            blocks.append(fax_encode(part, mode, **kw))
    comp = {"rle": 2, "g3": 3, "g3_2d": 3, "g4": 4}[mode]
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [comp]), 262: (3, [photometric]), 277: (3, [1]),
         284: (3, [1])}
    if mode.startswith("g3"):
        t[292] = (4, [(1 if mode == "g3_2d" else 0) | (4 if kw.get("align_eol") else 0)])
    if kw.get("lsb_first"):
        t[266] = (3, [2])
    if tile:
        t[322], t[323] = (4, [tile]), (4, [tile])
    else:
        t[278] = (4, [bh])
    return tiff_container(blocks, t, big_endian, big, bool(tile))


def tiff_fixtures(rng):
    import cv2
    from PIL import Image

    im = image(37, 45, seed=2)
    cv2.imwrite(str(OUT / "tiff_cv2_lzw_pred.tif"), im[..., ::-1])
    Image.fromarray(im).save(OUT / "tiff_pil_deflate.tif", compression="tiff_adobe_deflate")
    Image.fromarray(im[..., 0]).save(OUT / "tiff_pil_packbits_gray.tif", compression="packbits")
    rgba = image(37, 45, 4, seed=3)
    rgba[..., 3] = rng.integers(0, 256, (37, 45))
    Image.fromarray(rgba, "RGBA").save(OUT / "tiff_pil_rgba_lzw.tif", compression="tiff_lzw")
    Image.fromarray(im).convert("P", palette=Image.Palette.ADAPTIVE, colors=40).save(OUT / "tiff_pil_palette.tif")
    Image.fromarray(im[..., 1]).convert("1").save(OUT / "tiff_pil_bilevel.tif")
    Image.fromarray((image(29, 31, 1, seed=4)[..., 0].astype(np.uint16) * 257 + 91)).save(
        OUT / "tiff_pil_gray16.tif", compression="tiff_lzw")
    Image.fromarray(im).save(OUT / "tiff_pil_jpeg.tif", compression="jpeg")
    (OUT / "tiff_tiled_deflate_be_pred.tif").write_bytes(tiff_file(image(41, 53, seed=5), {}, big_endian=True,
                                                                    tile=16, predictor=True))
    rgb16 = rng.integers(0, 65536, (23, 29, 3), dtype=np.uint16)
    (OUT / "tiff_planar_rgb16.tif").write_bytes(tiff_file(rgb16, {}, planar=True, predictor=True))
    gray16 = rng.integers(0, 65536, (35, 37, 1), dtype=np.uint16)
    (OUT / "tiff_tiled_gray16_miniswhite.tif").write_bytes(tiff_file(gray16, {262: (3, [0])}, tile=16))
    (OUT / "tiff_orientation3_tiled.tif").write_bytes(tiff_file(image(35, 37, seed=6), {274: (3, [3])}, tile=16))
    (OUT / "tiff_orientation6.tif").write_bytes(tiff_file(image(20, 30, seed=7), {274: (3, [6])}))


# ---------------------------------------------------------------- WebP


class LibWebP:
    """libwebp's advanced encoder (``WebPConfig``) through ctypes, from the
    copy PIL bundles: token partitions, the loop filter's type and sharpness
    and the segment count, which neither PIL nor OpenCV pass on."""

    FIELDS = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
              "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
              "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
              "preprocessing", "partitions"]
    ABI = 0x0210

    def __init__(self):
        from PIL import Image

        libs = os.path.join(os.path.dirname(Image.__file__), "..", "pillow.libs")
        for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv*"))):
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        self.lib = ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libwebp-*")))[0])

    def encode(self, rgb: np.ndarray, **opts) -> bytes:
        lib = self.lib
        cfg = (ctypes.c_int32 * 64)()
        assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), self.ABI)
        for k, v in opts.items():
            i = self.FIELDS.index(k)
            if k == "quality":
                ctypes.c_float.from_buffer(cfg, 4 * i).value = v
            else:
                cfg[i] = v
        assert lib.WebPValidateConfig(cfg)
        pic = (ctypes.c_uint8 * 1024)()
        assert lib.WebPPictureInitInternal(pic, self.ABI)
        h, w = rgb.shape[:2]
        ints = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
        ints[2], ints[3] = w, h
        rgb = np.ascontiguousarray(rgb)
        assert lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(ctypes.c_void_p), w * 3)
        ints[0] = 0  # encode from YUV
        writer = (ctypes.c_uint8 * 64)()
        lib.WebPMemoryWriterInit(writer)
        # WebPPicture's writer and custom_ptr fields (x86-64 layout)
        ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
        assert lib.WebPEncode(cfg, pic)
        out = ctypes.string_at(ctypes.c_void_p.from_buffer(writer, 0).value,
                               ctypes.c_size_t.from_buffer(writer, 8).value)
        lib.WebPPictureFree(pic)
        lib.WebPMemoryWriterClear(writer)
        return out


def palette_image(h: int, w: int, colors: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    idx = (np.add.outer(np.arange(h) // 3, np.arange(w) // 5) + rng.integers(0, 2, (h, w))) % colors
    return pal[idx]


def webp_fixtures(rng):
    import cv2
    from PIL import Image

    im = image(29, 37, seed=8)
    cv2.imwrite(str(OUT / "webp_cv2_lossless.webp"), im[..., ::-1])
    rgba = image(29, 37, 4, seed=9)
    rgba[..., 3] = rng.integers(0, 2, (29, 37)) * 255
    Image.fromarray(rgba, "RGBA").save(OUT / "webp_pil_lossless_rgba.webp", lossless=True, exact=True)
    Image.fromarray(image(96, 128, seed=3, noise=20)).save(OUT / "webp_lossless_meta_codes.webp", lossless=True,
                                                           quality=100, method=4)
    for colors in (2, 4, 12, 200):
        Image.fromarray(palette_image(23, 41, colors, colors)).save(OUT / f"webp_lossless_{colors}colors.webp",
                                                                    lossless=True, quality=100, method=6)
    for q in (5, 50, 95):
        for h, w in ((1, 1), (17, 33), (70, 130)):
            cv2.imwrite(str(OUT / f"webp_q{q}_{w}x{h}.webp"), image(h, w, seed=q + w)[..., ::-1],
                        [cv2.IMWRITE_WEBP_QUALITY, q])
    Image.fromarray(image(33, 47, 4, seed=10), "RGBA").save(OUT / "webp_q75_alpha.webp", quality=75)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(image(20, 40, seed=11)).save(OUT / "webp_q80_exif6.webp", quality=80, exif=exif)
    frames = [Image.fromarray(image(24, 32, seed=12 + k)) for k in range(2)]
    frames[0].save(OUT / "webp_animated_lossless.webp", save_all=True, append_images=frames[1:], lossless=True,
                   duration=100)
    frames = [Image.fromarray(image(24, 32, 4, seed=14 + k), "RGBA") for k in range(2)]
    frames[0].save(OUT / "webp_animated_lossy.webp", save_all=True, append_images=frames[1:], quality=70,
                   duration=50)
    enc = LibWebP()
    big = image(70, 130, seed=16, noise=20)
    for log2 in (1, 2, 3):  # 2, 4 and 8 token partitions (libwebp writes them at effort 0-2 only)
        (OUT / f"webp_{1 << log2}_partitions.webp").write_bytes(enc.encode(big, method=0, partitions=log2))
    (OUT / "webp_simple_filter.webp").write_bytes(enc.encode(big, filter_type=0, filter_strength=80))
    (OUT / "webp_sharpness7_one_segment.webp").write_bytes(enc.encode(big, filter_sharpness=7, segments=1,
                                                                      quality=30.0))
    yy, xx = np.mgrid[0:1024, 0:1024]
    scene = np.stack([xx // 4, yy // 4, (xx + yy) // 8], -1) + rng.integers(-6, 7, (1024, 1024, 3))
    scene = np.clip(scene, 0, 255).astype(np.uint8)
    for k in range(40):
        y0, x0 = rng.integers(0, 960, 2)
        scene[y0:y0 + rng.integers(16, 64), x0:x0 + rng.integers(16, 64)] = rng.integers(0, 256, 3)
    cv2.imwrite(str(OUT / "webp_1024_q75.webp"), scene[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 75])


# ---------------------------------------------------------------- the newer TIFF and JPEG kinds


def pil_jpeg(subsampling: int, quality: int = 80, **kw):
    """A JPEG encoder for `jpeg_tiff` by PIL (``subsampling`` 0, 1, 2: 4:4:4, 4:2:2, 4:2:0)."""
    from PIL import Image

    def encode(part: np.ndarray) -> bytes:
        buf = io.BytesIO()
        mode = {1: "L", 3: "RGB", 4: "CMYK"}[part.shape[-1]]
        Image.fromarray(part[..., 0] if part.shape[-1] == 1 else part, mode).save(buf, "JPEG", quality=quality,
                                                                                  subsampling=subsampling, **kw)
        return buf.getvalue()

    return encode


def bilevel(h: int, w: int, seed: int) -> np.ndarray:
    """A bool ``[h, w]`` page of black bars and specks (True black)."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), bool)
    for _ in range(max(1, h * w // 300)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        page[y:y + rng.integers(1, 20), x:x + rng.integers(1, 60)] = rng.integers(0, 2)
    return page ^ (rng.random((h, w)) < 0.02)


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth aerial-like RGB scene with a few filled rectangles, uint8 ``[h, w, 3]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (h + w) + 40], -1)
    for _ in range(24):
        y0, x0 = rng.integers(0, max(1, h - 16)), rng.integers(0, max(1, w - 16))
        im[y0:y0 + rng.integers(8, 64), x0:x0 + rng.integers(8, 64)] = rng.integers(0, 256, 3)
    return im.astype(np.uint8)


def kind_fixtures():
    """JPEG-in-TIFF (GDAL's tiled 4:2:0 BigTIFF, 4:2:2 tiles, RGB strips
    without tables, PIL's YCbCr and gray strips), raw YCbCr (PIL's, 4:2:0 LZW
    with a ReferenceBlackWhite, 4:4 tiles), CMYK (PIL's LZW, planar, with
    alpha: OpenCV reads nothing), CIELab, CCITT RLE, Group 3, Group 4 and
    Group 3 2-D with aligned EOLs and FillOrder 2, a BigTIFF of an older
    layout, PIL's CMYK JPEG (and a 1024 x 1024 one for the card's timing);
    refused: old-style JPEG and YCCK (not ported), float samples and LZMA
    (OpenCV reads nothing)."""
    from PIL import Image

    im = image(37, 45, seed=19)
    (OUT / "tiff_gdal_jpeg_ycbcr420_big.tif").write_bytes(gdal_jpeg_tiff(image(52, 75, seed=20), tile=16))
    (OUT / "tiff_jpeg_ycbcr422_tiled_be.tif").write_bytes(
        jpeg_tiff(image(41, 50, seed=21), pil_jpeg(1), 6, (2, 1), tile=16, big_endian=True))
    (OUT / "tiff_jpeg_rgb_no_tables.tif").write_bytes(
        jpeg_tiff(im, pil_jpeg(0, keep_rgb=True), 2, rows_per_strip=16, tables=False))
    Image.fromarray(im).convert("YCbCr").save(OUT / "tiff_pil_jpeg_ycbcr.tif", compression="jpeg")
    Image.fromarray(im[..., 1]).save(OUT / "tiff_pil_jpeg_gray.tif", compression="jpeg")
    Image.fromarray(im).convert("YCbCr").save(OUT / "tiff_pil_ycbcr.tif")
    ref = {532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}
    (OUT / "tiff_ycbcr420_lzw_refbw.tif").write_bytes(
        ycbcr_file(rgb_to_ycbcr(image(37, 45, seed=22)), 2, 2, tags=ref, rows_per_strip=8, compress="lzw"))
    (OUT / "tiff_ycbcr44_tiled.tif").write_bytes(ycbcr_file(rgb_to_ycbcr(image(41, 41, seed=23)), 4, 4, tile=16))
    Image.fromarray(im).convert("CMYK").save(OUT / "tiff_pil_cmyk_lzw.tif", compression="tiff_lzw")
    (OUT / "tiff_cmyk_planar.tif").write_bytes(tiff_file(cmyk_of(image(23, 31, seed=24)), {262: (3, [5])},
                                                         planar=True, rows_per_strip=8))
    alpha = image(23, 31, 1, seed=25)[..., 0]
    (OUT / "tiff_cmyk_alpha.tif").write_bytes(tiff_file(cmyk_of(image(23, 31, seed=24), alpha),
                                                        {262: (3, [5]), 338: (3, [2])}))
    Image.fromarray(im).convert("LAB").save(OUT / "tiff_pil_lab.tif")
    page = Image.fromarray(~bilevel(61, 90, 26)).convert("1")
    for name, comp in (("rle", "tiff_ccitt"), ("g3", "group3"), ("g4", "group4")):
        page.save(OUT / f"tiff_pil_ccitt_{name}.tif", compression=comp)
    (OUT / "tiff_g3_2d_fillorder2.tif").write_bytes(
        fax_tiff(bilevel(61, 90, 27), "g3_2d", rows_per_strip=16, k=4, align_eol=True, lsb_first=True))
    (OUT / "tiff_bigtiff_tiled_deflate_pred.tif").write_bytes(
        tiff_file(image(41, 53, seed=28), {}, tile=16, predictor=True, big=True))  # PIL opens no big-endian BigTIFF
    Image.fromarray(cmyk_of(im), "CMYK").save(OUT / "jpeg_cmyk_pil.jpg", quality=85, subsampling=2)
    Image.fromarray(cmyk_of(scene(1024, 1024, 29)), "CMYK").save(OUT / "jpeg_cmyk_1024.jpg", quality=50)
    # refused by name: not ported (old-style JPEG, YCCK) and read by OpenCV as nothing (float, LZMA)
    (OUT / "tiff_old_jpeg.tif").write_bytes(tiff_file(im, {259: (3, [6])}, deflate=False))
    cmyk = (OUT / "jpeg_cmyk_pil.jpg").read_bytes()
    at = cmyk.index(b"Adobe") + 11  # the APP14 transform byte: 2 is YCCK
    (OUT / "jpeg_ycck_adobe2.jpg").write_bytes(cmyk[:at] + b"\x02" + cmyk[at + 1:])
    Image.fromarray(image(20, 30, 1, seed=30)[..., 0].astype(np.float32)).save(OUT / "tiff_float32.tif")
    (OUT / "tiff_lzma.tif").write_bytes(tiff_file(im, {259: (3, [34925])}, deflate=False))


# ---------------------------------------------------------------- digests


# kinds the port names and refuses: file -> a phrase of its NotImplementedError
NOT_PORTED = {"tiff_old_jpeg.tif": "old-style JPEG", "jpeg_ycck_adobe2.jpg": "YCCK"}


# files PIL does not open (five samples a pixel): their stored size as written
STORED = {"tiff_cmyk_alpha.tif": [23, 31]}


def digest(path: Path) -> dict:
    import cv2
    from PIL import Image

    if path.name in STORED:
        stored = STORED[path.name]
    else:
        with Image.open(path) as im:
            stored = [im.height, im.width]
    ref = cv2.imread(str(path))
    out = {"stored": stored}
    if ref is None:
        out["raises"] = "ValueError"
    else:
        rgb = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
        out.update(shape=list(rgb.shape), sha256=hashlib.sha256(rgb.tobytes()).hexdigest())
    if path.name in NOT_PORTED:
        out["raises"], out["match"] = "NotImplementedError", NOT_PORTED[path.name]
    return out


def main():
    OUT.mkdir(exist_ok=True)
    for p in OUT.iterdir():
        if not p.name.startswith("still_"):  # make_still_fixtures.py's files and entries stay
            p.unlink()
    rng = np.random.default_rng(17)
    bmp_fixtures(rng)
    tiff_fixtures(rng)
    webp_fixtures(rng)
    kind_fixtures()
    table = {k: v for k, v in json.loads(DIGESTS.read_text()).items() if k.startswith("still_")}
    table.update({p.name: digest(p) for p in sorted(OUT.iterdir()) if not p.name.startswith("still_")})
    DIGESTS.write_text(json.dumps(dict(sorted(table.items())), indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(table)} fixtures, {size} bytes")


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parents[1]))  # the port's JPEG and LZW encoders
    main()
