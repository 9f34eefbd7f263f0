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
import json
import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

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


def tiff_file(px: np.ndarray, tags: dict, big_endian=False, tile=None, planar=False, predictor=False,
              deflate=True, rows_per_strip=None) -> bytes:
    """A TIFF file of ``px`` [h, w, c] (uint8 or uint16) with Deflate or no
    compression, in strips of ``rows_per_strip`` rows (default: one) or
    square tiles; ``tags`` add to the baseline or replace its tags."""
    end = ">" if big_endian else "<"
    h, w, c = px.shape
    bits = px.dtype.itemsize * 8
    bw, bh = (tile, tile) if tile else (w, rows_per_strip or h)
    planes = c if planar else 1
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
                blocks.append(zlib.compress(raw) if deflate else raw)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [8 if deflate else 1]),
         262: (3, [2 if c >= 3 else 1]), 277: (3, [c]), 284: (3, [2 if planar else 1])}
    if predictor:
        t[317] = (3, [2])
    if tile:
        t[322], t[323] = (4, [tile]), (4, [tile])
    else:
        t[278] = (4, [bh])
    t.update(tags)
    body = bytearray(struct.pack(end + "2sHI", b"MM" if big_endian else b"II", 42, 0))
    offsets = []
    for raw in blocks:
        offsets.append(len(body))
        body += raw + (b"\0" if len(raw) & 1 else b"")
    t[324 if tile else 273] = (4, offsets)
    t[325 if tile else 279] = (4, [len(b) for b in blocks])
    struct.pack_into(end + "I", body, 4, len(body))
    fmt = {3: "H", 4: "I"}
    entries, spill = [], bytearray()
    spill_at = len(body) + 2 + 12 * len(t) + 4
    for tag in sorted(t):
        kind, vals = t[tag]
        payload = struct.pack(end + fmt[kind] * len(vals), *vals)
        if len(payload) <= 4:
            entries.append(struct.pack(end + "HHI", tag, kind, len(vals)) + payload.ljust(4, b"\0"))
        else:
            entries.append(struct.pack(end + "HHII", tag, kind, len(vals), spill_at + len(spill)))
            spill += payload
    body += struct.pack(end + "H", len(t)) + b"".join(entries) + b"\0\0\0\0" + spill
    return bytes(body)


def tiff_fixtures(rng):
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


# ---------------------------------------------------------------- digests


NOT_PORTED = {"tiff_pil_jpeg.tif"}  # kinds the port names and refuses


def digest(path: Path) -> dict:
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
        out["raises"] = "NotImplementedError"
    return out


def main():
    OUT.mkdir(exist_ok=True)
    for p in OUT.iterdir():
        p.unlink()
    rng = np.random.default_rng(17)
    bmp_fixtures(rng)
    tiff_fixtures(rng)
    webp_fixtures(rng)
    table = {p.name: digest(p) for p in sorted(OUT.iterdir())}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(table)} fixtures, {size} bytes")


if __name__ == "__main__":
    main()
