"""Image reading and writing on the host, without OpenCV or PIL.

The port's counterpart of ``cv2.imread(path, IMREAD_COLOR)`` followed by
``cvtColor(BGR2RGB)``: `imread` returns an RGB ``uint8 [h, w, 3]`` array with
the pixels OpenCV gives (gray replicated to three channels, alpha dropped).

* PNG: chunks are parsed and their data inflated here with ``zlib``; the row
  filters are undone in C++ (Paeth and Average depend on the left neighbour,
  so a row cannot be vectorised in numpy). 8- and 16-bit gray, gray+alpha,
  RGB and RGBA, palette images and 1/2/4-bit gray and palette images, plain
  or interlaced (Adam7: each of the seven passes unfiltered alone, then put
  in place). 16-bit samples keep their high byte, as OpenCV 5's
  ``IMREAD_COLOR`` gives them.
* JPEG: baseline, extended sequential and progressive Huffman files, decoded
  in C++ with libjpeg-turbo's arithmetic (``imread.cpp``); four-component
  (CMYK, Adobe transform 0) files come out of libjpeg as CMYK and through
  OpenCV's CMYK->BGR; arithmetic-coded, lossless, hierarchical, 12-bit and
  YCCK files raise `NotImplementedError`. The same decoder reads the strips
  and tiles of JPEG-in-TIFF (`decode_jpeg_segment`).
* BMP (`bmp`), TIFF (`tiff`: classic and BigTIFF, JPEG-in-TIFF, CCITT, raw
  YCbCr, CMYK and CIELab among its kinds) and WebP (`webp`, lossless VP8L and
  lossy VP8 key frames): each module's docstring lists what it reads. A file
  is taken by its signature, not its suffix.
* The stills ``cv2.imread`` also takes, read by `imread` only (datasets
  list PNG, JPEG, BMP, TIFF and WebP files, so `read_shape` refuses them):
  PBM/PGM/PPM, PAM and PFM (`pxm`), Sun raster (`sunras`), Radiance HDR
  (`hdr`) and GIF's first frame (`gif`).
* EXIF orientation (a JPEG's APP1 ``Exif`` segment, a PNG's ``eXIf`` chunk,
  a WebP's ``EXIF`` chunk): orientations 2-8 flip and transpose the pixels as
  ``IMREAD_COLOR`` does (`apply_orientation`), and `read_shape` gives the
  turned size; `read_stored_shape` gives the stored one, as PIL does.

`imwrite` is the counterpart of ``cv2.imwrite`` of an RGB (or gray) array,
chosen by the file's suffix:

* JPEG: baseline, quality 95, 4:2:0, the standard Huffman tables, encoded in
  C++ with libjpeg-turbo's arithmetic (``imwrite.cpp``): the bytes OpenCV
  writes for the same pixels (given to OpenCV as BGR).
* PNG: 8-bit gray or RGB, deflated with ``zlib`` (`imwrite_png`); decoded,
  the pixels OpenCV reads back are the array's.
* BMP: OpenCV's bytes (24-bit, or 8-bit with a gray palette).
* TIFF: LZW with horizontal differencing in one strip, the layout OpenCV
  writes (not its bytes); `tiff.encode` writes the other layouts.
* WebP: lossless VP8L (OpenCV's default), this encoder's bytes.

``imread.cpp``, ``imwrite.cpp``, ``codecs.cpp`` and ``webp.cpp`` are compiled with ``g++`` at first use into
``build/`` at the repository root, keyed by a hash of the source and flags,
under a file lock so that concurrent processes build each once
(`utils.native_build`). A missing compiler raises.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from quan_ultralytics_tpu_torch.utils.native_build import BUILD_DIR, build_cxx

SOURCE = Path(__file__).resolve().parent / "imread.cpp"
LIB_NAME = "libquan_torch_imread.so"
WRITE_SOURCE = SOURCE.with_name("imwrite.cpp")
WRITE_LIB_NAME = "libquan_torch_imwrite.so"
CODECS_SOURCE = SOURCE.with_name("codecs.cpp")
CODECS_LIB_NAME = "libquan_torch_codecs.so"
WEBP_SOURCE = SOURCE.with_name("webp.cpp")
WEBP_LIB_NAME = "libquan_torch_webp.so"
JPEG_QUALITY = 95  # cv2.imwrite's default
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# imread.cpp's status codes that mean "a kind of file this reader does not take"
_NOT_IMPLEMENTED = {3, 4, 5, 6, 7, 8, 14, 15}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel

_lib: Optional[ctypes.CDLL] = None
_write_lib: Optional[ctypes.CDLL] = None
_codecs_lib: Optional[ctypes.CDLL] = None
_webp_lib: Optional[ctypes.CDLL] = None

PathLike = Union[str, Path]


def build() -> Path:
    """Compile ``imread.cpp`` if its source or flags changed; return the library path."""
    return build_cxx(SOURCE, LIB_NAME, CXX_FLAGS, BUILD_DIR)


def library() -> ctypes.CDLL:
    """The loaded reader library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.argtypes = [u8p, ctypes.c_int, ctypes.c_long, ctypes.c_int, u8p]
        lib.jpeg_decode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_int, ctypes.c_int]
        i = ctypes.c_int
        lib.jpeg_decode_tiff.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, u8p, i, i, i, i, i, i]
        lib.png_unfilter.restype = lib.jpeg_decode.restype = lib.jpeg_decode_tiff.restype = ctypes.c_int
        lib.imread_error.argtypes = [ctypes.c_int]
        lib.imread_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def write_library() -> ctypes.CDLL:
    """The loaded JPEG encoder (``imwrite.cpp``), built on first call."""
    global _write_lib
    if _write_lib is None:
        lib = ctypes.CDLL(str(build_cxx(WRITE_SOURCE, WRITE_LIB_NAME, CXX_FLAGS, BUILD_DIR,
                                          depends=[SOURCE.with_name("jpeg_tables.h")])))
        lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_long]
        lib.jpeg_encode.restype = ctypes.c_long
        _write_lib = lib
    return _write_lib


def codecs_library() -> ctypes.CDLL:
    """BMP's RLE, TIFF's LZW, PackBits, predictor and CCITT, and the loops of
    the PxM, Radiance and GIF readers (``codecs.cpp``), built on first call."""
    global _codecs_lib
    if _codecs_lib is None:
        lib = ctypes.CDLL(str(build_cxx(CODECS_SOURCE, CODECS_LIB_NAME, CXX_FLAGS, BUILD_DIR)))
        vp, lg = ctypes.c_void_p, ctypes.c_long
        lib.bmp_rle_decode.argtypes = [vp, lg, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
        lib.bmp_rle_decode.restype = ctypes.c_int
        for fn in (lib.tiff_lzw_decode, lib.tiff_lzw_encode, lib.tiff_packbits_decode):
            fn.argtypes = [vp, lg, vp, lg]
            fn.restype = lg
        lib.tiff_undo_predictor.argtypes = [vp, lg, lg, ctypes.c_int, ctypes.c_int]
        lib.tiff_undo_predictor.restype = None
        i = ctypes.c_int
        lib.tiff_fax_decode.argtypes = [vp, lg, i, i, i, i, i, vp]
        lib.tiff_fax_decode.restype = i
        lib.pnm_ascii.argtypes = [vp, lg, ctypes.POINTER(lg), lg, i, vp]
        lib.pnm_ascii.restype = i
        lib.hdr_read_pixels.argtypes = [vp, lg, i, i, vp]
        lib.hdr_read_pixels.restype = i
        lib.gif_lzw_decode.argtypes = [vp, lg, i, vp, lg]
        lib.gif_lzw_decode.restype = lg
        _codecs_lib = lib
    return _codecs_lib


def webp_library() -> ctypes.CDLL:
    """The VP8L and VP8 decoders and the VP8L encoder (``webp.cpp``), built on first call."""
    global _webp_lib
    if _webp_lib is None:
        lib = ctypes.CDLL(str(build_cxx(WEBP_SOURCE, WEBP_LIB_NAME, CXX_FLAGS, BUILD_DIR,
                                        depends=[SOURCE.with_name("webp_tables.h"), SOURCE.with_name("vp8.h")])))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.vp8l_decode, lib.vp8_decode):
            fn.argtypes = [vp, ctypes.c_long, vp, i, i]
            fn.restype = i
        lib.vp8l_encode.argtypes = [vp, i, i, i, vp, ctypes.c_long]
        lib.vp8l_encode.restype = ctypes.c_long
        lib.webp_error.argtypes = [i]
        lib.webp_error.restype = ctypes.c_char_p
        _webp_lib = lib
    return _webp_lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(status: int, path: PathLike) -> None:
    if status:
        msg = f"{path}: {library().imread_error(status).decode()}"
        raise NotImplementedError(msg) if status in _NOT_IMPLEMENTED else ValueError(msg)


# ---------------------------------------------------------------- EXIF


def _exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of a TIFF-structured EXIF block, 1 if absent."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(end + "HH", tiff[at:at + 4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(end + "H", tiff[at + 8:at + 10])[0]
    return 1


def apply_orientation(im: np.ndarray, orientation: int) -> np.ndarray:
    """``im`` ``[h, w, c]`` turned by its EXIF orientation as OpenCV's
    ``IMREAD_COLOR`` turns it (imgcodecs ``ExifTransform``): 2 flips left-right,
    3 turns by 180 degrees, 4 flips top-bottom, 5 transposes, 6-8 transpose and
    then flip left-right, both ways or top-bottom. Other values leave it."""
    if orientation in (5, 6, 7, 8):
        im = im.transpose(1, 0, 2)
    flip = {2: (False, True), 3: (True, True), 4: (True, False), 6: (False, True),
            7: (True, True), 8: (True, False)}.get(orientation)
    if flip is not None:
        im = im[::-1 if flip[0] else 1, ::-1 if flip[1] else 1]
    return np.ascontiguousarray(im)


def _turned(shape: Tuple[int, int], orientation: int) -> Tuple[int, int]:
    """``(h, w)`` after `apply_orientation`."""
    return shape[::-1] if orientation in (5, 6, 7, 8) else shape


# ---------------------------------------------------------------- JPEG


def _jpeg_header(data: bytes, path: PathLike) -> Tuple[int, int, int]:
    """(h, w) from the frame header, and the EXIF orientation (1 without one)."""
    h, w, _, _, orientation = jpeg_frame(data, path)
    return h, w, orientation


def jpeg_frame(data: bytes, path: PathLike) -> Tuple[int, int, int, Tuple[int, int], int]:
    """(h, w, components, the first component's (h, v) sampling factors) from
    the frame header, and the EXIF orientation (1 without one)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos, orientation = 2, 1
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 1
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(seg[6:])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if len(seg) < 9:
                break
            h, w = struct.unpack(">HH", seg[1:5])
            return h, w, seg[5], (seg[7] >> 4, seg[7] & 15), orientation
        if marker in (0xD9, 0xDA):
            break
        pos += 2 + length
    raise ValueError(f"{path}: no JPEG frame header")


def decode_jpeg_segment(data: bytes, tables: bytes, ncomp: int, sampling: Tuple[int, int], ycc: bool,
                        path: PathLike) -> np.ndarray:
    """One strip or tile of a JPEG-in-TIFF file: ``uint8 [h, w, ncomp]`` at the
    frame's size, after the abbreviated ``tables`` stream (``b""`` for none);
    the first component sampled ``sampling`` (h, v) and the others 1 x 1;
    ``ycc`` converts YCbCr to RGB as libjpeg does for libtiff's RGBA reads."""
    h, w = jpeg_frame(data, path)[:2]
    buf, tab = np.frombuffer(data, np.uint8), np.frombuffer(tables or b"\0", np.uint8)
    out = np.empty((h, w, ncomp), np.uint8)
    _check(library().jpeg_decode_tiff(_ptr(tab), len(tables), _ptr(buf), len(data), _ptr(out), h, w, ncomp,
                                      sampling[0], sampling[1], int(ycc)), path)
    return out


def _decode_jpeg(data: bytes, path: PathLike) -> np.ndarray:
    h, w, orientation = _jpeg_header(data, path)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    _check(library().jpeg_decode(_ptr(buf), len(data), _ptr(out), h, w), path)
    return apply_orientation(out, orientation)


# ---------------------------------------------------------------- PNG


def _png_chunks(data: bytes, path: PathLike):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            break
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind.decode(errors='replace')} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: the data ends before the image does")


def _png_header(data: bytes, path: PathLike):
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">IIBBBBB", data[16:29])  # w, h, depth, colour, compression, filter, interlace


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: np.ndarray, w: int, h: int, depth: int, colour: int, path: PathLike
                 ) -> Tuple[np.ndarray, int]:
    """Unfilter ``h`` rows of a ``w``-pixel (sub)image from ``raw``: ``([h, w, c]``
    samples (uint8, or uint16 at depth 16), bytes consumed)."""
    channels = _PNG_CHANNELS[colour]
    rowbytes = (w * channels * depth + 7) // 8
    need = h * (rowbytes + 1)
    if raw.size < need:
        raise ValueError(f"{path}: the image data is shorter than its header says")
    rows = np.empty((h, rowbytes), np.uint8)
    bpp = max(1, channels * depth // 8)
    _check(library().png_unfilter(_ptr(raw), h, rowbytes, bpp, _ptr(rows)), path)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, channels), need
    if depth < 8:  # unpack the samples, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        rows = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if colour == 0:  # libpng's expand_gray_1_2_4_to_8 scales to 0..255
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    return rows.reshape(h, w, channels), need


def _decode_png(data: bytes, path: PathLike) -> np.ndarray:
    w, h, depth, colour, compression, filt, interlace = _png_header(data, path)
    if colour not in _PNG_CHANNELS or compression or filt or interlace > 1:
        raise ValueError(f"{path}: bad PNG header")
    if not (depth in (8, 16) and colour != 3) and not (colour in (0, 3) and depth in (1, 2, 4, 8)):
        raise ValueError(f"{path}: bit depth {depth} is not allowed for colour type {colour}")
    idat, palette, orientation = [], None, 1
    for kind, payload in _png_chunks(data, path):
        if kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"eXIf":
            orientation = _exif_orientation(payload)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        px = _png_samples(raw, w, h, depth, colour, path)[0]
    else:  # Adam7: seven reduced images one after the other, each filtered alone
        px = np.zeros((h, w, _PNG_CHANNELS[colour]), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no rows, not even filter bytes
            sub, used = _png_samples(raw[at:], pw, ph, depth, colour, path)
            px[y0::dy, x0::dx] = sub
            at += used
    if depth == 16:  # IMREAD_COLOR keeps the high byte (libpng's png_set_strip_16)
        px = (px >> 8).astype(np.uint8)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        idx = px[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        out = palette[idx]
    elif colour in (0, 4):
        out = np.repeat(px[..., :1], 3, axis=-1)
    else:
        out = np.ascontiguousarray(px[..., :3])
    return apply_orientation(out, orientation)


# ---------------------------------------------------------------- public


def _format(head: bytes):
    """The module of the other formats whose signature ``head`` starts with, or None."""
    from quan_ultralytics_tpu_torch.data.native import bmp, tiff, webp

    if head[:2] == b"BM":
        return bmp
    if head[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return tiff
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return webp
    return None


def _still(head: bytes):
    """The module of the stills ``cv2.imread`` takes outside the dataset formats
    (PxM, PAM, PFM, Sun raster, Radiance, GIF) whose signature ``head`` starts
    with, or None: chosen by the first bytes, as OpenCV's ``findDecoder``."""
    from quan_ultralytics_tpu_torch.data.native import gif, hdr, pxm, sunras

    if head[:2] in pxm.SIGNATURES:
        return pxm
    if head[:4] == sunras.SIGNATURE:
        return sunras
    if head.startswith(hdr.SIGNATURES):
        return hdr
    if head[:6] in gif.SIGNATURES:
        return gif
    return None


def _unknown(path: PathLike, head: bytes) -> NotImplementedError:
    mod = _still(head)
    if mod is not None:  # read by imread, not by the dataset readers
        return NotImplementedError(f"{path}: a {mod.NAME} file is read by imread only (datasets take PNG, JPEG, "
                                   "BMP, TIFF and WebP)")
    return NotImplementedError(f"{path}: this kind of file is not read (PNG, JPEG, BMP, TIFF, WebP, PxM, PAM, "
                               "PFM, Sun raster, Radiance HDR and GIF are)")


def imread(path: PathLike) -> np.ndarray:
    """RGB ``uint8 [h, w, 3]`` pixels of a PNG, JPEG, BMP, TIFF, WebP, PxM,
    PAM, PFM, Sun raster, Radiance HDR or GIF file (the first frame),
    as OpenCV's IMREAD_COLOR (then BGR->RGB) gives them. Raises
    `FileNotFoundError` for a missing file, `NotImplementedError` for a kind
    of file this reader does not take, `ValueError` where OpenCV reads
    nothing or the file is broken."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data, path)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data, path)
    fmt = _format(data[:12]) or _still(data[:16])
    if fmt is None:
        raise _unknown(path, data)
    return fmt.decode(data, path)


def _png_shape(fh, head: bytes, path: PathLike) -> Tuple[Tuple[int, int], int]:
    """A PNG's stored ``(h, w)`` and its eXIf orientation, from the chunks
    before the image data (their payloads skipped)."""
    w, h = _png_header(head, path)[:2]
    orientation = 1
    while True:
        length, kind = struct.unpack(">I4s", fh.read(8).rjust(8, b"\0"))
        if kind in (b"IDAT", b"IEND", b"\0\0\0\0"):
            break
        if kind == b"eXIf":
            orientation = _exif_orientation(fh.read(length))
            fh.seek(4, 1)
        else:
            fh.seek(length + 4, 1)
    return (h, w), orientation


def read_shape(path: PathLike) -> Tuple[int, int]:
    """``(h, w)`` of an image as `imread` returns it (turned by its EXIF
    orientation, as OpenCV's), from its headers, without decoding it."""
    with open(path, "rb") as fh:
        head = fh.read(33)
        if head[:8] == PNG_SIGNATURE:
            return _turned(*_png_shape(fh, head, path))
        if head[:2] == b"\xff\xd8":
            h, w, orientation = _jpeg_header(head + fh.read(), path)
            return _turned((h, w), orientation)
        fmt = _format(head)
        if fmt is None:
            raise _unknown(path, head)
        data = head + fh.read()
    return fmt.shape(data, path)


def read_stored_shape(path: PathLike) -> Tuple[int, int]:
    """``(h, w)`` of an image as stored, not turned by an EXIF orientation:
    what PIL's ``Image.open(path).size`` gives (reversed), from the headers."""
    with open(path, "rb") as fh:
        head = fh.read(33)
        if head[:8] == PNG_SIGNATURE:
            return _png_shape(fh, head, path)[0]
        if head[:2] == b"\xff\xd8":
            return _jpeg_header(head + fh.read(), path)[:2]
        fmt = _format(head)
        if fmt is None:
            raise _unknown(path, head)
        return fmt.stored_shape(head + fh.read(), path)


def _pixels(im: np.ndarray) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"image writers take uint8 pixels, got {im.dtype}")
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]
    if not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] == 3)) or 0 in im.shape[:2]:
        raise ValueError(f"expected a non-empty [h, w] gray or [h, w, 3] RGB image, got {im.shape}")
    return np.ascontiguousarray(im)


def encode_jpeg(im: np.ndarray) -> bytes:
    """A baseline JPEG file of uint8 ``[h, w, 3]`` RGB or ``[h, w]`` gray
    pixels: the bytes of ``cv2.imencode(".jpg", im_bgr)`` (quality 95)."""
    im = _pixels(im)
    h, w = im.shape[:2]
    nch = 1 if im.ndim == 2 else 3
    cap = h * w * nch + 4096
    while True:
        buf = np.empty(cap, np.uint8)
        n = write_library().jpeg_encode(im.ctypes.data, h, w, nch, JPEG_QUALITY, buf.ctypes.data, cap)
        if n == -2:
            raise ValueError(f"cannot encode a {im.shape} image")
        if n >= 0:
            return buf[:n].tobytes()
        cap *= 4


def imwrite(path: PathLike, im: np.ndarray) -> str:
    """Write uint8 ``[h, w, 3]`` RGB or ``[h, w]`` gray pixels to ``path``, as
    ``cv2.imwrite`` writes the same image (BGR for OpenCV), by suffix:
    ``.jpg``/``.jpeg`` a baseline JPEG at quality 95, ``.png`` an 8-bit PNG,
    ``.bmp`` OpenCV's BMP, ``.tif``/``.tiff`` an LZW TIFF with horizontal
    differencing, ``.webp`` a lossless WebP. Returns the path."""
    from quan_ultralytics_tpu_torch.data.native import bmp, tiff, webp

    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        Path(path).write_bytes(encode_jpeg(im))
    elif suffix == ".png":
        imwrite_png(path, _pixels(im), filters="sub")
    elif suffix == ".bmp":
        Path(path).write_bytes(bmp.encode(_pixels(im)))
    elif suffix in (".tif", ".tiff"):
        Path(path).write_bytes(tiff.encode(_pixels(im)))
    elif suffix == ".webp":
        Path(path).write_bytes(webp.encode(_pixels(im)))
    else:
        raise ValueError(f"{path}: only .jpg, .jpeg, .png, .bmp, .tif, .tiff and .webp files are written")
    return str(path)


def imwrite_png(path: PathLike, im: np.ndarray, palette: Optional[np.ndarray] = None,
                filters: str = "cycle") -> None:
    """Write ``uint8`` pixels as an 8-bit PNG: ``[h, w]`` or ``[h, w, 1]`` gray,
    ``[h, w, 3]`` RGB, ``[h, w, 4]`` RGBA; or, with ``palette`` (``[n, 3]``,
    n <= 256), ``im`` holds palette indices. ``filters="cycle"`` filters row
    ``y`` with type ``y % 5``, so every filter occurs (the readers' tests);
    ``"sub"`` filters every row with type 1."""
    im = np.asarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"imwrite_png takes uint8 pixels, got {im.dtype}")
    if im.ndim == 2:
        im = im[..., None]
    h, w, c = im.shape
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if c != 1 or palette.ndim != 2 or palette.shape[1] != 3 or not 0 < len(palette) <= 256:
            raise ValueError("a palette image is [h, w] indices with a [n <= 256, 3] palette")
        if im.size and int(im.max()) >= len(palette):
            raise ValueError("palette index out of range")
        colour = 3
    else:
        colour = {1: 0, 3: 2, 4: 6}.get(c)
        if colour is None:
            raise ValueError(f"cannot write {c} channels as PNG")
    x = im.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]  # left neighbour
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # above
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]  # above-left
    if filters == "sub":
        kind = np.ones(h, np.int64)
        rows = (x - a).astype(np.uint8)  # mod 256
    else:
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        filtered = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth])  # types 0..4
        kind = np.arange(h) % 5
        rows = filtered[kind, np.arange(h)].astype(np.uint8)  # mod 256
    raw = np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1).tobytes()

    def chunk(kind_: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind_ + payload
                + struct.pack(">I", zlib.crc32(kind_ + payload)))

    out = [PNG_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    if palette is not None:
        out.append(chunk(b"PLTE", palette.tobytes()))
    out += [chunk(b"IDAT", zlib.compress(raw, 6)), chunk(b"IEND", b"")]
    Path(path).write_bytes(b"".join(out))
