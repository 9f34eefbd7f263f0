"""Write the fixtures of the readers' newer formats and the digests of the pixels OpenCV decodes.

    python tests/fixtures/make_reader_fixtures.py

* ``jpeg_progressive_420_rst.jpg``: a progressive 4:2:0 JPEG with a restart
  interval, written by ``cv2.imwrite`` (IMWRITE_JPEG_PROGRESSIVE);
* ``jpeg_exif6_422.jpg``: a baseline 4:2:2 JPEG written by PIL with EXIF
  orientation 6 (OpenCV's IMREAD_COLOR turns it 90 degrees clockwise);
* ``png_adam7_rgb.png``: an interlaced (Adam7) 8-bit RGB PNG written by
  `write_png` below, every filter type in every pass.

``reader_fixtures.json`` holds, for each, the shape and the SHA-256 of
``cv2.cvtColor(cv2.imread(file), COLOR_BGR2RGB)``'s bytes: the card's machine
has no OpenCV and checks the port's reader against these. Needs OpenCV 5.0
(with libjpeg-turbo) and PIL.
"""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DIGESTS = HERE / "reader_fixtures.json"
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A gradient with noise and filled rectangles, uint8 ``[h, w, c]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w), (xx * yy) % 256], -1)[..., :c]
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        im[y0:y0 + rng.integers(4, 20), x0:x0 + rng.integers(4, 20)] = rng.integers(0, 256, c)
    return np.clip(im + rng.integers(-12, 13, im.shape), 0, 255).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """PNG-filter byte rows ``[n, rowbytes]``, row ``r`` with type ``(first_kind + r) % 5``."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth])
    kind = (np.arange(len(x)) + first_kind) % 5
    out = filtered[kind, np.arange(len(x))].astype(np.uint8)
    return np.concatenate([kind.astype(np.uint8)[:, None], out], 1).tobytes()


def write_png(path, im: np.ndarray, interlace: bool = True) -> None:
    """Write ``im`` (``[h, w, c]``, c in 1, 2, 3, 4; uint8 or uint16) as a PNG,
    Adam7-interlaced unless ``interlace`` is False."""
    h, w, c = im.shape
    depth = 16 if im.dtype == np.uint16 else 8
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = c * depth // 8

    def rows(sub):  # byte rows of a (sub)image, big-endian samples
        return sub.astype(">u2" if depth == 16 else np.uint8).reshape(sub.shape[0], -1).view(np.uint8)

    if interlace:
        raw = b"".join(_filtered(rows(im[y0::dy, x0::dx]), bpp, i)
                       for i, (x0, y0, dx, dy) in enumerate(ADAM7) if x0 < w and y0 < h)
    else:
        raw = _filtered(rows(im), bpp, 0)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + b"".join([
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace))),
        chunk(b"IDAT", zlib.compress(raw, 9)), chunk(b"IEND", b"")]))


def digest(rgb: np.ndarray) -> dict:
    return {"shape": list(rgb.shape), "sha256": hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()}


def main() -> None:
    import cv2
    from PIL import Image

    prog = HERE / "jpeg_progressive_420_rst.jpg"
    cv2.imwrite(str(prog), image(96, 128, 3, 0), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    exif = HERE / "jpeg_exif6_422.jpg"
    ex = Image.Exif()
    ex[0x0112] = 6
    Image.fromarray(image(72, 100, 3, 1)).save(exif, quality=88, subsampling=1, exif=ex.tobytes())
    adam7 = HERE / "png_adam7_rgb.png"
    write_png(adam7, image(45, 67, 3, 2))
    out = {p.name: digest(cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)) for p in (prog, exif, adam7)}
    DIGESTS.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
