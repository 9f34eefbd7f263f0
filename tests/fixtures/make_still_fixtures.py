"""Write the still fixtures ``cv2.imread`` takes outside the dataset formats, and their digests.

    python tests/fixtures/make_still_fixtures.py

Writes ``tests/fixtures/image/still_*`` and adds their entries to
``image_fixtures.json`` (each marked ``"still": true``: `native.imread` reads
them, `read_shape` refuses them, as datasets list only PNG, JPEG, BMP, TIFF
and WebP files). Each entry holds the shape and SHA-256 of
``cv2.cvtColor(cv2.imread(file), BGR2RGB)``, or ``"raises": "ValueError"``
where OpenCV reads nothing.

* OpenCV 5.0's writers: binary and ASCII PPM, PGM and PBM, 16-bit PGM and
  PPM, PAM, PFM, Sun raster, Radiance HDR and GIF;
* PIL 12's GIF writer: an interlaced file, an animation with a local colour
  table on each frame, a transparent index, and frames that PIL crops to
  the changed region (offsets inside the screen);
* built here, for the kinds no writer here makes (`pnm`, `pam`, `pfm`,
  `sun`, `hdr`, `gif` below use numpy alone, so ``chip_smoke.py`` writes its
  512 x 512 files with them on the card): odd maxvals in ASCII and binary
  PxM, 16-bit ASCII, comments in the header, PAM's gray, 16-bit and bit-mode
  files, PFM in both byte orders with a scale, Sun raster at 1, 8 (gray and
  colour maps) and 32 bits, Radiance with new-style runs and old-style run
  pixels, GIF with an image offset inside its screen over the background, a
  transparent index, a local table, interlacing and LZW code sizes 2-8, and
  broken files of each kind;
* ``still_gif_512.gif``: the 512 x 512 GIF whose decode ``chip_smoke.py``
  times (the raw kinds it writes there itself).

Needs OpenCV 5.0 and PIL 12 only for their files and the digests.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "image"
DIGESTS = HERE / "image_fixtures.json"


def image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A gradient under a few flat rectangles with a little noise, RGB uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + 2 * yy) % 256], -1)
    for _ in range(3):
        y0, x0 = rng.integers(0, max(1, h - 4)), rng.integers(0, max(1, w - 4))
        im[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
    return np.clip(im + rng.integers(-6, 7, im.shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- writers (numpy only)


def pnm(px: np.ndarray, kind: int, maxval: int = 255, comment: bytes = b"") -> bytes:
    """A P1-P6 file of ``px`` (``[h, w]`` samples, or ``[h, w, 3]`` for P3/P6;
    P1/P4 take 0/1 with 1 black); ASCII kinds end each row with a newline."""
    h, w = px.shape[:2]
    head = b"P%d\n%s%d %d\n" % (kind, comment, w, h) + (b"%d\n" % maxval if kind not in (1, 4) else b"")
    if kind == 4:
        return head + np.packbits(px.astype(np.uint8), axis=1).tobytes()
    if kind in (5, 6):
        return head + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    sep = b"" if kind == 1 else b" "
    rows = [sep.join(b"%d" % v for v in row.reshape(-1)) for row in px]
    return head + b"\n".join(rows) + b"\n"


def pam(px: np.ndarray, maxval: int = 255, tupltype: bytes = b"") -> bytes:
    """A P7 file of ``[h, w, depth]`` samples (big-endian above 255)."""
    h, w, depth = px.shape
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm(px: np.ndarray, scale: float = -1.0) -> bytes:
    """A PF file of float ``[h, w, 3]`` RGB, rows bottom-up, little-endian for a negative scale."""
    h, w = px.shape[:2]
    return b"PF\n%d %d\n%s\n" % (w, h, repr(scale).encode()) + px[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


def sun(px: np.ndarray, bpp: int, cmap: np.ndarray = None, kind: int = 1) -> bytes:
    """A Sun raster of ``px``: 1 or 8 bits of ``[h, w]`` indices (``cmap``
    ``[3, n]``), or 24 (``[h, w, 3]`` RGB, stored B, G, R) or 32 bits
    (``[h, w, 4]`` X, B, G, R as stored); rows padded to 16 bits."""
    h, w = px.shape[:2]
    if bpp == 1:
        rows = np.packbits(px.astype(np.uint8), axis=1)
    elif bpp == 24:
        rows = px[..., ::-1].reshape(h, -1)
    else:
        rows = px.reshape(h, -1)
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    data = np.zeros((h, pitch), np.uint8)
    data[:, :rows.shape[1]] = rows
    cmap = b"" if cmap is None else np.asarray(cmap, np.uint8).tobytes()
    return struct.pack(">Iiiiiiii", 0x59A66A95, w, h, bpp, data.size, kind, 1 if cmap else 0, len(cmap)) + cmap + \
        data.tobytes()


def to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """float ``[h, w, 3]`` -> RGBE ``[h, w, 4]`` uint8 (rgbe.cpp's float2rgbe)."""
    v = rgb.max(-1)
    m, e = np.frexp(v)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    scale = np.where(v > 1e-32, m * 256.0 / np.where(v > 0, v, 1), 0)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, e + 128, 0)
    return out


def hdr(rgbe: np.ndarray, rle: bool = True, header: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n") -> bytes:
    """A Radiance file of RGBE ``[h, w, 4]``: new-style run-length scanlines
    (runs of 3 or more, literals up to 128) or flat pixels."""
    h, w = rgbe.shape[:2]
    out = [header, b"-Y %d +X %d\n" % (h, w)]
    if not rle:
        return b"".join(out) + rgbe.astype(np.uint8).tobytes()
    for row in rgbe:
        line = bytearray([2, 2, w >> 8, w & 255])
        for c in range(4):
            ch = row[:, c].tobytes()
            i = 0
            while i < len(ch):
                j = i
                while j < len(ch) and ch[j] == ch[i] and j - i < 127:
                    j += 1
                if j - i >= 3:
                    line += bytes([128 + j - i, ch[i]])
                    i = j
                    continue
                k = i + 1
                while k < len(ch) and k - i < 128 and not (k + 2 < len(ch) and ch[k] == ch[k + 1] == ch[k + 2]):
                    k += 1
                line += bytes([k - i]) + ch[i:k]
                i = k
        out.append(bytes(line))
    return b"".join(out)


def lzw(idx: np.ndarray, min_size: int) -> bytes:
    """GIF LZW of the indices: a real dictionary coder (codes grow to 12
    bits, a clear code when the table is full), least significant bit first."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table = {bytes([i]): i for i in range(clear)}
    size, nxt = min_size + 1, clear + 2
    codes = [(clear, size)]
    cur = b""
    for v in idx.reshape(-1).tobytes():
        s = cur + bytes([v])
        if s in table:
            cur = s
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            codes.append((clear, size))
            table = {bytes([i]): i for i in range(clear)}
            size, nxt = min_size + 1, clear + 2
        cur = bytes([v])
    if cur:
        codes.append((table[cur], size))
    codes.append((end, size))
    acc = nbits = 0
    out = bytearray()
    for c, n in codes:
        acc |= c << nbits
        nbits += n
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _blocks(b: bytes) -> bytes:
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255] for i in range(0, len(b), 255)) + b"\0"


def _table_bits(table: bytes) -> int:
    return 0x80 | ((len(table) // 3).bit_length() - 2)


def gif(screen: tuple, gct: bytes, bg: int, frames: list, version: bytes = b"GIF89a") -> bytes:
    """A GIF of ``frames``: dicts with ``idx`` ([h, w] indices), ``at``
    ((x, y)), and optionally ``lct`` (bytes), ``transparent``, ``interlace``
    and ``min_size``; a comment extension before the first image."""
    sw, sh = screen
    out = bytearray(version + struct.pack("<HHBBB", sw, sh, _table_bits(gct) if gct else 0, bg, 0) + gct)
    out += b"\x21\xfe" + _blocks(b"port fixture")
    for f in frames:
        h, w = f["idx"].shape
        if f.get("transparent") is not None:
            out += b"\x21\xf9\x04" + bytes([1, 0, 0, f["transparent"]]) + b"\0"
        lct = f.get("lct", b"")
        flags = (_table_bits(lct) if lct else 0) | (0x40 if f.get("interlace") else 0)
        out += b"\x2c" + struct.pack("<HHHHB", *f["at"], w, h, flags) + lct
        rows = f["idx"]
        if f.get("interlace"):
            rows = rows[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                        np.arange(1, h, 2)])]
        size = f.get("min_size", 8)
        out += bytes([size]) + _blocks(lzw(rows, size))
    return bytes(out + b"\x3b")


def big_gif(size: int = 512) -> bytes:
    """A ``size`` x ``size`` GIF of 16 colours: bands and blocks that LZW packs small."""
    yy, xx = np.mgrid[0:size, 0:size]
    idx = ((xx // 64 + yy // 128) % 12).astype(np.uint8)
    idx[size // 4:size // 2, size // 3:2 * size // 3] = 13
    idx[(xx - size // 2) ** 2 + (yy - 3 * size // 4) ** 2 < (size // 8) ** 2] = 14
    gct = bytes(np.array([[i * 16, 255 - i * 12, (i * 53) % 256] for i in range(16)], np.uint8).tobytes())
    return gif((size, size), gct, 0, [dict(idx=idx, at=(0, 0), min_size=4)])


# ---------------------------------------------------------------- the fixtures


def hand_built() -> dict:
    """name -> bytes of the files built here."""
    rng = np.random.default_rng(21)
    im = image(12, 20, seed=3)
    gray = im[..., 1]
    files = {
        "still_p3_maxval100_comments.ppm": pnm((im[:8, :12].astype(int) * 100 // 255), 3, 100, b"# a comment\n"),
        "still_p2_maxval1000.pgm": pnm(gray.astype(int) * 1000 // 255, 2, 1000),
        "still_p1_digits.pbm": pnm(gray > 128, 1),
        "still_p6_maxval100.ppm": pnm(im // 3, 6, 100),
        "still_p5_maxval4000.pgm": pnm(gray.astype(int) * 15, 5, 4000, b"#x\n"),
        "still_pam_gray.pam": pam(gray[..., None], 255, b"GRAYSCALE"),
        "still_pam_rgb16.pam": pam(im.astype(np.uint16) * 250, 65535, b"RGB"),
        "still_pam_rgb_maxval100.pam": pam(im // 3, 100),
        "still_pam_bit_mode.pam": pam(rng.integers(0, 256, (12, 20, 1)), 1, b"BLACKANDWHITE"),
        "still_pfm_be_scale2.pfm": pfm(im[:8, :12].astype(np.float32) * 2 + 0.5, 2.0),
        "still_pfm_le_overflow.pfm": pfm(np.where(im[:8, :12] > 200, 1e12, im[:8, :12].astype(np.float32) - 30)),
        "still_sun_1bit.ras": sun(gray > 100, 1),
        "still_sun_8bit_map.ras": sun(rng.integers(0, 40, (12, 21)), 8, rng.integers(0, 256, (3, 40))),
        "still_sun_8bit_gray.ras": sun(gray, 8),
        "still_sun_32bit.ras": sun(rng.integers(0, 256, (12, 20, 4)), 32),
        "still_hdr_runs.hdr": hdr(to_rgbe(np.repeat(im.astype(np.float32) / 300, 2, 1) * np.float32(1.5))),
        "still_hdr_flat_old_runs.hdr": hdr(np.concatenate([to_rgbe(im.astype(np.float32) / 255)[:, :4],
                                                           np.tile(np.array([1, 1, 1, 2], np.uint8),
                                                                   (12, 1, 1))], 1), rle=False),
    }
    gct = bytes(rng.integers(0, 256, 3 * 16, dtype=np.uint8))
    lct = bytes(rng.integers(0, 256, 3 * 8, dtype=np.uint8))
    idx = (np.arange(10 * 14).reshape(10, 14) * 7 % 16).astype(np.uint8)
    files.update({
        "still_gif_offset_bg.gif": gif((24, 16), gct, 5, [dict(idx=idx, at=(6, 3))]),
        "still_gif_transparent.gif": gif((24, 16), gct, 2, [dict(idx=idx, at=(3, 4), transparent=7),
                                                             dict(idx=idx[::-1], at=(0, 0))]),
        "still_gif_local_interlaced.gif": gif((14, 13), gct, 0, [dict(idx=np.resize(idx % 8, (13, 14)), at=(0, 0),
                                                                      lct=lct, interlace=True, min_size=3)]),
        "still_gif87a_code_size2.gif": gif((14, 10), gct[:12], 1, [dict(idx=idx % 4, at=(0, 0), min_size=2)],
                                           b"GIF87a"),
        "still_gif_long_lzw.gif": gif((48, 48), gct, 0, [dict(idx=rng.integers(0, 16, (48, 48), dtype=np.uint8),
                                                                at=(0, 0), min_size=4)]),
        "still_gif_512.gif": big_gif(),
    })
    # broken files: OpenCV reads nothing of them
    files.update({
        "still_broken_p3_ends_in_number.ppm": b"P3\n2 1\n255\n1 2 3 4 5 6",
        "still_broken_p6_cut.ppm": pnm(im, 6)[:-40],
        "still_broken_pam_lowercase.pam": pam(im)[:3] + pam(im)[3:40].lower() + pam(im)[40:],
        "still_broken_pfm_gray.pfm": b"Pf\n2 1\n-1.0\n" + np.ones(2, "<f4").tobytes(),
        "still_broken_sun_rle.ras": sun(gray, 8, kind=2),
        "still_broken_hdr_no_blank.hdr": hdr(to_rgbe(np.ones((2, 9, 3), np.float32)),
                                              header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n"),
        "still_broken_gif_outside.gif": gif((8, 8), gct, 0, [dict(idx=idx, at=(0, 0))]),
    })
    return files


def writer_files() -> dict:
    """name -> bytes of the files OpenCV's and PIL's writers make."""
    import tempfile

    import cv2
    from PIL import Image

    im = image(12, 20, seed=1)
    bgr = np.ascontiguousarray(im[..., ::-1])
    gray = im[..., 0]
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        def cv2_write(name, px, params=()):
            path = Path(tmp) / name
            assert cv2.imwrite(str(path), px, list(params)), name
            files[name] = path.read_bytes()

        cv2_write("still_cv2_p6.ppm", bgr)
        cv2_write("still_cv2_p5.pgm", gray)
        cv2_write("still_cv2_p4.pbm", gray)
        cv2_write("still_cv2_p3.ppm", bgr[:8, :12], (cv2.IMWRITE_PXM_BINARY, 0))
        cv2_write("still_cv2_p2.pgm", gray[:8, :12], (cv2.IMWRITE_PXM_BINARY, 0))
        cv2_write("still_cv2_p1.pbm", gray, (cv2.IMWRITE_PXM_BINARY, 0))
        cv2_write("still_cv2_16.ppm", bgr.astype(np.uint16) * 257 + 5)
        cv2_write("still_cv2_16.pgm", gray.astype(np.uint16) * 200)
        cv2_write("still_cv2.pam", bgr)
        cv2_write("still_cv2.pfm", bgr)
        cv2_write("still_cv2.ras", bgr)
        cv2_write("still_cv2.hdr", bgr)
        cv2_write("still_cv2.gif", bgr)

        def pil_gif(name, frames, **kw):
            buf = io.BytesIO()
            frames[0].save(buf, "GIF", save_all=len(frames) > 1, append_images=frames[1:], **kw)
            files[name] = buf.getvalue()

        big = image(40, 56, seed=2)
        pil_gif("still_gif_pil_interlaced.gif", [Image.fromarray(big).quantize(64)], interlace=True)
        pil_gif("still_gif_pil_animated_local.gif",
                [Image.fromarray(image(24, 32, seed=s)).quantize(8 + 8 * s) for s in range(3)], duration=40)
        frame = image(24, 32, seed=4)
        moved = frame.copy()
        moved[8:14, 10:20] = (255, 0, 0)
        pil_gif("still_gif_pil_cropped_frames.gif", [Image.fromarray(frame).quantize(16),
                                                      Image.fromarray(moved).quantize(16)], optimize=False)
        p = Image.fromarray(image(20, 24, seed=5)).quantize(8)
        pil_gif("still_gif_pil_transparency.gif", [p], transparency=3)
    return files


def digest(path: Path) -> dict:
    import cv2

    ref = cv2.imread(str(path))
    out = {"still": True}
    if ref is None:
        out["raises"] = "ValueError"
    else:
        rgb = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
        out.update(shape=list(rgb.shape), sha256=hashlib.sha256(rgb.tobytes()).hexdigest())
    return out


def main():
    for p in OUT.glob("still_*"):
        p.unlink()
    files = {**writer_files(), **hand_built()}
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    table = {k: v for k, v in json.loads(DIGESTS.read_text()).items() if not k.startswith("still_")}
    table.update({name: digest(OUT / name) for name in sorted(files)})
    DIGESTS.write_text(json.dumps(dict(sorted(table.items())), indent=1) + "\n")
    size = sum(len(d) for d in files.values())
    print(f"{len(files)} still fixtures, {size} bytes")


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parents[1]))
    main()
