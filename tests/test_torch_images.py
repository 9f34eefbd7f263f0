"""The port's BMP, TIFF and WebP readers and writers against OpenCV 5.0 and PIL,
and the data path over every image format against the JAX package.

* every committed fixture (``tests/fixtures/image``, written by
  ``make_image_fixtures.py``) decodes to its OpenCV digest, or raises what
  the table says, and its stored size is PIL's;
* random files written here: BMP at every depth, header and row order;
  TIFF over compression x predictor x planes x tiles x byte order at 8 and
  16 bits, gray, gray + alpha, RGB and RGBA, photometrics and orientations; lossless WebP that reaches
  colour indexing (with and without pixel bundling), the colour cache and
  every encoder effort; lossy WebP over quality, size and PIL's methods;
  decoded exactly as ``cv2.imread``, ``read_shape`` as OpenCV's shape and
  ``read_stored_shape`` as PIL's size;
* the writers: BMP bytes equal OpenCV's, TIFF and WebP read back by OpenCV;
* the newer TIFF kinds, written here by the fixture maker's writers
  and by PIL over seeded random images: JPEG-in-TIFF (gray, RGB, YCbCr at
  1 x 1, 2 x 1 and 2 x 2, strips and tiles, with and without JPEGTables, both
  byte orders, GDAL's tiled 4:2:0 BigTIFF), raw YCbCr at every subsampling
  libtiff reads (and its ReferenceBlackWhite and coefficients), CMYK
  (contiguous and planar), CIELab (8 and 16 bits), CCITT RLE, Group 3 1-D and
  2-D and Group 4 (FillOrder 2, aligned EOLs, damaged rows), BigTIFF of the
  older layouts, and the kinds OpenCV reads nothing of (ValueError);
* one folder that mixes every format and an EXIF-6 JPEG through
  ``YOLODataset`` (images, ``shapes()``, the rect loader's order and batch
  shapes), ``load_source``, ``split_dota`` and the DOTA converter, against the
  JAX package, and another of the newer TIFF and JPEG kinds through the same paths. No
  JAX compile runs here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from quan_ultralytics_tpu_torch.data.native import native, tiff, webp
from quan_ultralytics_tpu_torch.data.native.native import imread, read_shape, read_stored_shape

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TABLE = json.loads((FIXTURES / "image_fixtures.json").read_text())


def _maker():
    """tests/fixtures/make_image_fixtures.py as a module (its BMP and TIFF builders)."""
    spec = importlib.util.spec_from_file_location("make_image_fixtures", FIXTURES / "make_image_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()


def _cv2_rgb(path):
    im = cv2.imread(str(path))
    return None if im is None else cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def _assert_as_opencv(path, stored=None):
    """``imread``, ``read_shape`` and ``read_stored_shape`` of ``path`` against
    OpenCV and PIL (or ``stored`` where PIL does not open the file)."""
    ref = _cv2_rgb(path)
    if ref is None:
        with pytest.raises(ValueError):
            imread(path)
    else:
        got = imread(path)
        assert got.shape == ref.shape, path.name
        np.testing.assert_array_equal(got, ref, err_msg=path.name)
        assert read_shape(path) == ref.shape[:2]
    if stored is not None:
        assert read_stored_shape(path) == stored
        return
    with Image.open(path) as im:
        assert read_stored_shape(path) == (im.height, im.width)


# ---------------------------------------------------------------- committed fixtures


@pytest.mark.parametrize("name", sorted(TABLE))
def test_committed_image_fixture(name):
    ref, path = TABLE[name], FIXTURES / "image" / name
    if ref.get("still"):  # read by imread only (tests/test_torch_stills.py): datasets do not list them
        with pytest.raises(NotImplementedError, match="read by imread only"):
            read_shape(path)
        with pytest.raises(NotImplementedError, match="read by imread only"):
            read_stored_shape(path)
        if ref.get("raises"):
            with pytest.raises(ValueError):
                imread(path)
            return
        got = imread(path)
        assert list(got.shape) == ref["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"]
        return
    assert list(read_stored_shape(path)) == ref["stored"]
    if ref.get("raises") == "NotImplementedError":
        with pytest.raises(NotImplementedError, match=ref["match"]):
            imread(path)
        return
    if ref.get("raises") == "ValueError":
        with pytest.raises(ValueError):
            imread(path)
        with pytest.raises(ValueError):
            read_shape(path)
        return
    got = imread(path)
    assert list(got.shape) == ref["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"]
    assert list(read_shape(path)) == ref["shape"][:2]


def test_fixture_files_are_small():
    assert sum(p.stat().st_size for p in (FIXTURES / "image").iterdir()) < 300_000
    assert set(TABLE) == {p.name for p in (FIXTURES / "image").iterdir()}


# ---------------------------------------------------------------- BMP


BMP_KINDS = [(1, 0, 40), (4, 0, 108), (8, 0, 124), (16, 0, 40), (16, 3, 40), (24, 0, 124), (32, 0, 40),
             (32, 3, 40), (32, 3, 108)]
OS2_KINDS = [(1, 0, 12), (8, 0, 12), (24, 0, 12)]  # an OS/2 header's height is unsigned: bottom-up only


@pytest.mark.parametrize("bpp,comp,header,top_down", [k + (t,) for k in BMP_KINDS for t in (False, True)]
                         + [k + (False,) for k in OS2_KINDS])
def test_bmp_as_opencv(tmp_path, bpp, comp, header, top_down):
    rng = np.random.default_rng(bpp * 7 + header + top_down)
    h, w = 11, 19
    if bpp <= 8:
        data = MAKER.packed_rows(rng.integers(0, 1 << bpp, (h, w)), bpp)
        palette = rng.integers(0, 256, (max(1, (1 << bpp) - 3), 3))
    else:
        pitch = (w * bpp // 8 + 3) & -4
        data = rng.integers(0, 256, (h, pitch), dtype=np.uint8).tobytes()
        palette = None
    masks = None
    if comp == 3:
        masks = (0xF800, 0x7E0, 0x1F) if bpp == 16 else (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        if header >= 108:
            masks = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)  # R, G, B, A: not the INFO order
    path = tmp_path / "a.bmp"
    path.write_bytes(MAKER.bmp_file(data, w, -h if top_down else h, bpp, comp, palette, header, masks))
    _assert_as_opencv(path)


def test_bmp_rle_as_opencv(tmp_path):
    """RLE8 and RLE4 edge cases: runs ending a row, end of line after a full
    row, early end of bitmap, deltas, overruns and cut data."""
    rle = MAKER.rle
    pal = np.random.default_rng(0).integers(0, 256, (256, 3))
    w, h = 10, 6
    cases8 = [[("run", 4, 5), ("abs", [1, 2, 3, 4, 5, 6]), ("eol",)] * 6 + [("eob",)],
              [("run", 10, 7), ("eol",)] * 6, [("run", 3, 9), ("eol",)] * 6 + [("eob",)],
              [("run", 10, 3), ("eol",), ("run", 4, 2), ("eob",)],
              [("run", 2, 1), ("delta", 3, 2), ("run", 2, 4), ("eol",), ("eob",)],
              [("run", 12, 3), ("eob",)], [("run", 10, 3)], [("abs", [1, 2, 3]), ("run", 7, 8), ("eol",)] * 6]
    cases4 = [[("run", 4, 0x5A), ("abs", [1, 2, 3, 4, 5, 6]), ("eol",)] * 6 + [("eob",)],
              [("run", 3, 0x9C), ("eol",)] * 6 + [("eob",)], [("run", 10, 0x3F), ("eol",), ("run", 4, 0x21), ("eob",)],
              [("run", 2, 0x12), ("delta", 3, 2), ("run", 2, 0x43), ("eol",), ("eob",)] + [("eol",)] * 5,
              [("abs", [1, 2, 3]), ("run", 7, 0x8E), ("eol",)] * 6, [("run", 10, 0x31), ("eol",)] * 6]
    for k, ops in enumerate(cases8 + cases4):
        four = k >= len(cases8)
        for top_down in (False, True):
            path = tmp_path / f"rle{k}{top_down}.bmp"
            path.write_bytes(MAKER.bmp_file(rle(ops, four), w, -h if top_down else h, 4 if four else 8,
                                            2 if four else 1, pal[:16] if four else pal))
            _assert_as_opencv(path)


def test_bmp_writer_writes_opencv_bytes(tmp_path):
    rng = np.random.default_rng(1)
    for shape in [(1, 1, 3), (5, 7, 3), (37, 53, 3), (5, 7), (64, 33)]:
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        native.imwrite(tmp_path / "p.bmp", im)
        cv2.imwrite(str(tmp_path / "c.bmp"), im[..., ::-1] if im.ndim == 3 else im)
        assert (tmp_path / "p.bmp").read_bytes() == (tmp_path / "c.bmp").read_bytes()


# ---------------------------------------------------------------- TIFF

# ("none", True): a Predictor tag on uncompressed data, which libtiff ignores (no codec runs it)
TIFF_LAYOUTS = [("none", False), ("none", True), ("deflate", False), ("deflate", True)]


@pytest.mark.parametrize("compression,predictor", TIFF_LAYOUTS)
@pytest.mark.parametrize("tile,planar,big_endian", [(None, False, False), (None, True, True), (16, False, True),
                                                    (16, True, False), (32, False, False)])
def test_tiff_as_opencv(tmp_path, compression, predictor, tile, planar, big_endian):
    """8 and 16 bits; gray, gray + alpha, RGB, RGBA (unassociated alpha); strips of 10 rows or tiles."""
    rng = np.random.default_rng(len(compression) + 2 * predictor + (tile or 0) + planar)
    for dtype in (np.uint8, np.uint16):
        for c in (1, 2, 3, 4):
            im = rng.integers(0, np.iinfo(dtype).max + 1, (37, 45, c), dtype=dtype)
            path = tmp_path / f"t{dtype.__name__}{c}.tif"
            path.write_bytes(MAKER.tiff_file(im, {338: (3, [2])} if c in (2, 4) else {}, big_endian=big_endian,
                                             tile=tile, planar=planar and c > 1, predictor=predictor,
                                             deflate=compression == "deflate", rows_per_strip=10))
            _assert_as_opencv(path, stored=(37, 45) if (dtype, c) == (np.uint16, 2) else None)  # PIL has no LA;16


@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("tile", [None, 16])
def test_tiff_lzw_as_opencv(tmp_path, predictor, tile):
    rng = np.random.default_rng(7 + predictor)
    for shape in [(37, 45), (37, 45, 3), (1, 1, 3), (300, 200, 3)]:
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        im[: shape[0] // 2] //= 32  # repeats, so that the LZW table fills and clears
        (tmp_path / "l.tif").write_bytes(tiff.encode(im, compression="lzw", predictor=predictor, tile=tile))
        _assert_as_opencv(tmp_path / "l.tif")


@pytest.mark.parametrize("photometric", ["miniswhite8", "miniswhite16", "palette16", "palette8", "rgba_assoc",
                                         "rgba_unspecified", "orientation2", "orientation3", "orientation4",
                                         "orientation7"])
@pytest.mark.parametrize("tile", [None, 16])
def test_tiff_photometrics_and_orientations_as_opencv(tmp_path, photometric, tile):
    rng = np.random.default_rng(len(photometric))
    gray8 = rng.integers(0, 256, (37, 45, 1), dtype=np.uint8)
    gray16 = rng.integers(0, 65536, (37, 45, 1), dtype=np.uint16)
    rgb, rgba = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8), rng.integers(0, 256, (37, 45, 4), dtype=np.uint8)
    if photometric.startswith("orientation"):
        im, tags = rgb, {274: (3, [int(photometric[-1:])])}
    else:
        im, tags = {
            "miniswhite8": (gray8, {262: (3, [0])}), "miniswhite16": (gray16, {262: (3, [0])}),
            "palette16": (gray8, {262: (3, [3]), 320: (3, rng.integers(0, 65536, 768).tolist())}),
            "palette8": (gray8, {262: (3, [3]), 320: (3, rng.integers(0, 256, 768).tolist())}),
            "rgba_assoc": (rgba, {338: (3, [1])}), "rgba_unspecified": (rgba, {338: (3, [0])}),
        }[photometric]
    path = tmp_path / "t.tif"
    path.write_bytes(MAKER.tiff_file(im, tags, tile=tile, rows_per_strip=9))
    _assert_as_opencv(path)


@pytest.mark.parametrize("mode,compression", [("RGB", "tiff_lzw"), ("L", "packbits"), ("1", "raw"), ("P", "raw"),
                                              ("RGBA", "tiff_adobe_deflate"), ("I;16", "tiff_lzw"),
                                              ("LA", "tiff_lzw")])
def test_tiff_by_pil_as_opencv(tmp_path, mode, compression):
    rng = np.random.default_rng(5)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (29, 41), dtype=np.uint16))
    else:
        im = Image.fromarray(MAKER.image(29, 41, seed=3)).convert(mode)
    im.save(tmp_path / "p.tif", compression=compression)
    _assert_as_opencv(tmp_path / "p.tif")


def test_tiff_writer_read_back_by_opencv(tmp_path):
    rng = np.random.default_rng(2)
    for shape in [(1, 1, 3), (37, 53, 3), (5, 7), (300, 200, 3)]:
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        for name in ("a.tif", "a.tiff"):
            native.imwrite(tmp_path / name, im)
            ref = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(ref, im[..., ::-1] if im.ndim == 3 else im)
            np.testing.assert_array_equal(imread(tmp_path / name), _cv2_rgb(tmp_path / name))


# ---------------------------------------------------------------- TIFF: JPEG-in-TIFF, YCbCr, CMYK, CIELab, CCITT, BigTIFF

JPEG_TIFF_KINDS = {  # name -> (channels, photometric, first component's sampling, encoder)
    "gray": (1, 1, (1, 1), lambda: MAKER.pil_jpeg(0)), "rgb": (3, 2, (1, 1), lambda: MAKER.pil_jpeg(0, keep_rgb=True)),
    "ycbcr_1x1": (3, 6, (1, 1), lambda: MAKER.pil_jpeg(0)), "ycbcr_2x1": (3, 6, (2, 1), lambda: MAKER.pil_jpeg(1)),
    "ycbcr_2x2": (3, 6, (2, 2), lambda: MAKER.pil_jpeg(2)), "ycbcr_2x2_port": (3, 6, (2, 2), lambda: MAKER.port_jpeg),
    "cmyk": (4, 5, (1, 1), lambda: MAKER.pil_jpeg(0)),
}


@pytest.mark.parametrize("kind", list(JPEG_TIFF_KINDS))
@pytest.mark.parametrize("layout", ["strips", "tiles", "tiles_no_tables_be", "one_strip_big"])
def test_jpeg_in_tiff_as_opencv(tmp_path, kind, layout):
    """Compression 7: each strip or tile its own JPEG stream (after the
    JPEGTables stream, or holding its own tables), sizes that are not
    multiples of the strip, tile or MCU, both byte orders, BigTIFF."""
    c, photometric, sampling, encoder = JPEG_TIFF_KINDS[kind]
    rng = np.random.default_rng(len(kind) * 7 + len(layout))
    for h, w in ((37, 45), (19, 70)):
        px = MAKER.image(h, w, 4, seed=int(rng.integers(1 << 16)))[..., :c]
        kw = {"strips": dict(rows_per_strip=13), "tiles": dict(tile=16),
              "tiles_no_tables_be": dict(tile=32, tables=False, big_endian=True), "one_strip_big": dict(big=True)}[layout]
        path = tmp_path / f"j{h}.tif"
        path.write_bytes(MAKER.jpeg_tiff(px, encoder(), photometric, sampling, **kw))
        _assert_as_opencv(path, stored=(h, w) if kw.get("big_endian") and kw.get("big") else None)


def test_jpeg_in_tiff_by_pil_and_gdal_layout_as_opencv(tmp_path):
    """PIL's (libtiff's) JPEG-in-TIFF writer, and GDAL's tiled 4:2:0 BigTIFF
    at 256 tiles, its tiles' edges upsampled each on its own."""
    for h, w in ((37, 45), (1, 1), (64, 64), (17, 130)):
        im = MAKER.image(h, w, seed=h + w)
        for mode in ("RGB", "YCbCr", "L"):
            Image.fromarray(im).convert(mode).save(tmp_path / "p.tif", compression="jpeg", quality=70)
            _assert_as_opencv(tmp_path / "p.tif")
    (tmp_path / "g.tif").write_bytes(MAKER.gdal_jpeg_tiff(MAKER.scene(300, 520, 3), tile=256))
    _assert_as_opencv(tmp_path / "g.tif")


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("layout", ["strips_lzw", "tiles", "tiles_deflate_be", "one_strip_packbits"])
def test_raw_ycbcr_as_opencv(tmp_path, hs, vs, layout):
    """Photometric 6 without JPEG: libtiff's subsampled blocks (and the
    4 x 4 tile routine's short skip over a clipped tile's hidden blocks), its
    conversion tables from the default and from random ReferenceBlackWhite
    and YCbCrCoefficients (rationals)."""
    rng = np.random.default_rng(hs * 10 + vs + len(layout))
    kw = {"strips_lzw": dict(rows_per_strip=8, compress="lzw"), "tiles": dict(tile=16),
          "tiles_deflate_be": dict(tile=16, compress="deflate", big_endian=True),
          "one_strip_packbits": dict(compress="packbits")}[layout]
    for k, (h, w) in enumerate(((37, 45), (41, 41), (3, 70))):
        ycc = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        tags = {}
        if k:
            tags[532] = (5, [(int(rng.integers(0, 40)), 1), (int(rng.integers(200, 300)), 1),
                             (int(rng.integers(100, 140)), 1), (int(rng.integers(2000, 3000)), 10),
                             (int(rng.integers(200, 280)), 2), (int(rng.integers(200, 300)), 1)])
        if k == 2:
            tags[529] = (5, [(int(rng.integers(200, 400)), 1000), (int(rng.integers(500, 650)), 1000),
                             (int(rng.integers(50, 200)), 1000)])
        path = tmp_path / f"y{k}.tif"
        path.write_bytes(MAKER.ycbcr_file(ycc, hs, vs, tags, **kw))
        _assert_as_opencv(path)


def test_raw_ycbcr_every_value_and_pil_as_opencv(tmp_path):
    """Every (Y, Cb, Cr) pair of a seeded third sample through libtiff's
    default tables, and PIL's YCbCr TIFFs."""
    y, cb = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cr = np.random.default_rng(0).integers(0, 256, (256, 256))
    (tmp_path / "a.tif").write_bytes(MAKER.ycbcr_file(np.stack([y, cb, cr], -1).astype(np.uint8), 1, 1,
                                                      rows_per_strip=64))
    _assert_as_opencv(tmp_path / "a.tif")
    for compression in (None, "tiff_lzw", "tiff_adobe_deflate"):
        Image.fromarray(MAKER.image(29, 41, seed=2)).convert("YCbCr").save(tmp_path / "p.tif", compression=compression)
        _assert_as_opencv(tmp_path / "p.tif")


@pytest.mark.parametrize("planar,tile,compress,big_endian", [(False, None, None, False), (False, 16, "lzw", True),
                                                             (True, None, "deflate", False), (True, 16, None, True)])
def test_cmyk_as_opencv(tmp_path, planar, tile, compress, big_endian):
    """8-bit CMYK: libtiff's integer (255 - k) * (255 - c) / 255, contiguous and planar."""
    rng = np.random.default_rng(planar + 2 * bool(tile))
    px = rng.integers(0, 256, (37, 45, 4), dtype=np.uint8)
    (tmp_path / "c.tif").write_bytes(MAKER.tiff_file(px, {262: (3, [5])}, big_endian=big_endian, tile=tile,
                                                     planar=planar, deflate=compress == "deflate",
                                                     rows_per_strip=10, compress=compress))
    _assert_as_opencv(tmp_path / "c.tif")
    Image.fromarray(px, "CMYK").save(tmp_path / "p.tif", compression=compress and f"tiff_{compress}".replace(
        "tiff_deflate", "tiff_adobe_deflate"))
    _assert_as_opencv(tmp_path / "p.tif")


def test_cielab_as_opencv(tmp_path):
    """CIELab (photometric 8): every L at a grid of a and b, 8 bits, in
    strips and tiles; random 16-bit samples; a WhitePoint tag; PIL's LAB."""
    l_, a, b = np.meshgrid(np.arange(256), np.arange(0, 256, 3), np.arange(1, 256, 5), indexing="ij")
    px = np.stack([l_, a, b], -1).astype(np.uint8).reshape(256, -1, 3)
    (tmp_path / "l.tif").write_bytes(MAKER.tiff_file(px, {262: (3, [8])}, rows_per_strip=32))
    _assert_as_opencv(tmp_path / "l.tif")
    rng = np.random.default_rng(8)
    px16 = rng.integers(0, 65536, (37, 45, 3), dtype=np.uint16)
    (tmp_path / "l16.tif").write_bytes(MAKER.tiff_file(px16, {262: (3, [8])}, tile=16, big_endian=True))
    _assert_as_opencv(tmp_path / "l16.tif", stored=(37, 45))  # PIL opens no 16-bit CIELab
    white = {262: (3, [8]), 318: (5, [(3127, 10000), (3290, 10000)])}  # D65
    (tmp_path / "w.tif").write_bytes(MAKER.tiff_file(px[:64, :64], white, deflate=False))
    _assert_as_opencv(tmp_path / "w.tif")
    Image.fromarray(MAKER.image(29, 41, seed=3)).convert("LAB").save(tmp_path / "p.tif")
    _assert_as_opencv(tmp_path / "p.tif")


FAX_OPTIONS = {"plain": {}, "fill_order_2": dict(lsb_first=True), "aligned_eol": dict(align_eol=True),
               "strips_miniswhite_be": dict(rows_per_strip=7, big_endian=True), "tiles": dict(tile=16),
               "min_is_black": dict(photometric=1)}


@pytest.mark.parametrize("mode", ["rle", "g3", "g3_2d", "g4"])
@pytest.mark.parametrize("options", list(FAX_OPTIONS))
def test_ccitt_as_opencv(tmp_path, mode, options):
    """CCITT RLE, Group 3 1-D and 2-D and Group 4 as libtiff's encoder
    writes them, at widths that reach the extended makeup codes; the pages
    decode to the bilevel image written (bar RLE in tiles, where libtiff's
    bit accumulator shifts a row)."""
    kw = dict(FAX_OPTIONS[options])
    if mode == "rle" and options == "aligned_eol":
        kw = {}
    photometric = kw.pop("photometric", 0)
    for k, (h, w) in enumerate(((37, 45), (9, 2700), (30, 1729))):
        page = MAKER.bilevel(h, w, k + len(mode))
        path = tmp_path / f"f{k}.tif"
        path.write_bytes(MAKER.fax_tiff(page, mode, photometric=photometric, **kw))
        _assert_as_opencv(path, stored=(h, w) if kw.get("big_endian") else None)
        if photometric == 0 and not (mode == "rle" and "tile" in kw):
            np.testing.assert_array_equal(imread(path)[..., 0], np.where(page, 0, 255))


def test_ccitt_by_pil_and_damaged_rows_as_opencv(tmp_path):
    """PIL's (libtiff's) CCITT files; and strips with flipped bits or zeroed
    bytes that still decode to their last row (bad code words end a row, a
    row of the wrong length is cut or padded), held to OpenCV. Strips whose
    data ends before their last row are not compared: OpenCV shows its strip
    buffer's uninitialised bytes there (the port: white)."""
    from quan_ultralytics_tpu_torch.data.native.native import codecs_library

    for compression in ("tiff_ccitt", "group3", "group4"):
        Image.fromarray(~MAKER.bilevel(41, 77, 5)).convert("1").save(tmp_path / "p.tif", compression=compression)
        _assert_as_opencv(tmp_path / "p.tif")
    rng = np.random.default_rng(1)
    compared = 0
    for trial in range(48):
        mode = ("rle", "g3", "g3_2d", "g4")[trial % 4]
        h, w = int(rng.integers(3, 40)), int(rng.integers(5, 120))
        strip = bytearray(MAKER.fax_encode(MAKER.bilevel(h, w, trial), mode))
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, len(strip)))
            if trial % 2:
                strip[at] ^= 1 << int(rng.integers(0, 8))
            else:
                strip[at:at + 2] = bytes(len(strip[at:at + 2]))
        out = np.zeros(h * ((w + 7) // 8), np.uint8)
        src = np.frombuffer(bytes(strip), np.uint8)
        comp = {"rle": 2, "g4": 4}.get(mode, 3)
        if codecs_library().tiff_fax_decode(src.ctypes.data, src.size, comp, int(mode == "g3_2d"), 0, w, h,
                                            out.ctypes.data):
            continue  # the data ended before the last row
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [comp]), 262: (3, [0]), 277: (3, [1]),
                278: (4, [h]), 292: (4, [int(mode == "g3_2d")])}
        (tmp_path / "d.tif").write_bytes(MAKER.tiff_container([bytes(strip)], tags))
        _assert_as_opencv(tmp_path / "d.tif")
        compared += 1
    assert compared >= 20


@pytest.mark.parametrize("compression,predictor,tile,planar,big_endian", [
    ("none", False, None, False, False), ("deflate", True, 16, False, True), ("lzw", True, None, True, False),
    ("deflate", False, 32, True, True)])
def test_bigtiff_as_opencv(tmp_path, compression, predictor, tile, planar, big_endian):
    """BigTIFF (8-byte offsets, 20-byte entries, LONG8 offsets) of the older
    layouts: 8 and 16 bits, gray to RGBA; PIL opens no big-endian BigTIFF."""
    rng = np.random.default_rng(len(compression) + predictor + (tile or 0))
    for dtype in (np.uint8, np.uint16):
        for c in (1, 3, 4):
            im = rng.integers(0, np.iinfo(dtype).max + 1, (37, 45, c), dtype=dtype)
            path = tmp_path / f"b{c}.tif"
            path.write_bytes(MAKER.tiff_file(im, {338: (3, [2])} if c == 4 else {}, big_endian=big_endian,
                                             tile=tile, planar=planar and c > 1, predictor=predictor,
                                             deflate=compression == "deflate", rows_per_strip=10, big=True,
                                             compress="lzw" if compression == "lzw" else None))
            assert path.read_bytes()[2:4] in (b"+\0", b"\0+")
            _assert_as_opencv(path, stored=(37, 45) if big_endian else None)
    Image.fromarray(MAKER.image(29, 41, seed=4)).convert("CMYK").save(tmp_path / "p.tif", big_tiff=True)
    _assert_as_opencv(tmp_path / "p.tif")


# ---------------------------------------------------------------- WebP


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 200, None])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless_webp_as_opencv(tmp_path, colors, method):
    """Palettes of 2, 3-4, 5-16 colours bundle 8, 4 and 2 pixels a byte; more
    colours index without bundling; a gradient takes the predictor and
    cross-colour transforms, meta prefix codes and the colour cache."""
    # a 96 x 128 gradient is the smallest that libwebp codes with meta prefix codes (at efforts 4 and 6)
    im = MAKER.image(96, 128, seed=3, noise=20) if colors is None else MAKER.palette_image(43, 61, colors, method)
    Image.fromarray(im).save(tmp_path / "l.webp", lossless=True, quality=100 if method else 25, method=method)
    _assert_as_opencv(tmp_path / "l.webp")
    cv2.imwrite(str(tmp_path / "c.webp"), im[..., ::-1])
    _assert_as_opencv(tmp_path / "c.webp")


@pytest.mark.parametrize("quality", [1, 10, 30, 50, 75, 90, 100])
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (16, 16), (17, 33), (33, 17), (70, 130)])
def test_lossy_webp_as_opencv(tmp_path, quality, size):
    im = MAKER.image(*size, seed=quality + size[1])
    cv2.imwrite(str(tmp_path / "q.webp"), im[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])
    _assert_as_opencv(tmp_path / "q.webp")


@pytest.mark.parametrize("method", [0, 2, 4, 6])
def test_lossy_webp_by_pil_as_opencv(tmp_path, method):
    rgba = MAKER.image(45, 77, 4, seed=method)
    Image.fromarray(rgba[..., :3]).save(tmp_path / "p.webp", quality=20 + 12 * method, method=method)
    _assert_as_opencv(tmp_path / "p.webp")
    Image.fromarray(rgba, "RGBA").save(tmp_path / "a.webp", quality=60, method=method)  # with an ALPH chunk
    _assert_as_opencv(tmp_path / "a.webp")


@pytest.mark.parametrize("orientation", [2, 3, 5, 6, 8])
def test_webp_exif_orientation_as_opencv(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(MAKER.image(20, 40, seed=orientation)).save(tmp_path / "o.webp", quality=80, exif=exif)
    _assert_as_opencv(tmp_path / "o.webp")


def test_webp_writer_read_back_by_opencv(tmp_path):
    rng = np.random.default_rng(3)
    for shape in [(1, 1, 3), (37, 53, 3), (5, 7), (64, 33, 3)]:
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        im[: shape[0] // 2] = im[:1]  # runs the encoder writes as copies
        native.imwrite(tmp_path / "w.webp", im)
        ref = cv2.imread(str(tmp_path / "w.webp"))
        np.testing.assert_array_equal(ref, im[..., ::-1] if im.ndim == 3 else np.repeat(im[..., None], 3, -1))
        np.testing.assert_array_equal(imread(tmp_path / "w.webp"), _cv2_rgb(tmp_path / "w.webp"))


# ---------------------------------------------------------------- refusals


def test_unported_kinds_raise_named_errors(tmp_path):
    im = MAKER.image(20, 30, seed=1)
    Image.fromarray(im).save(tmp_path / "a.gif")  # imread reads a GIF now; the dataset readers do not
    np.testing.assert_array_equal(imread(tmp_path / "a.gif"), _cv2_rgb(tmp_path / "a.gif"))
    with pytest.raises(NotImplementedError, match="GIF"):
        read_shape(tmp_path / "a.gif")
    (tmp_path / "x.xcf").write_bytes(b"gimp xcf v011" + bytes(40))
    with pytest.raises(NotImplementedError, match="this kind of file is not read"):
        imread(tmp_path / "x.xcf")
    for comp, what in ((6, "old-style JPEG"), (32809, "ThunderScan"), (32771, "CCITT RLEW"), (34712, "JPEG 2000")):
        (tmp_path / "c.tif").write_bytes(MAKER.tiff_file(im, {259: (3, [comp])}, deflate=False))
        with pytest.raises(NotImplementedError, match=what):
            imread(tmp_path / "c.tif")
    (tmp_path / "icc.tif").write_bytes(MAKER.tiff_file(im, {262: (3, [9])}, deflate=False))
    with pytest.raises(NotImplementedError, match="ICCLab"):
        imread(tmp_path / "icc.tif")
    Image.fromarray(im[..., 0].astype(np.float32)).save(tmp_path / "f.tif")
    with pytest.raises(ValueError, match="float"):  # OpenCV 5.0 reads nothing of 32-bit float samples
        imread(tmp_path / "f.tif")
    assert cv2.imread(str(tmp_path / "f.tif")) is None
    (tmp_path / "big.tif").write_bytes(b"II+\0" + bytes(12))  # a BigTIFF header of offset size 0
    with pytest.raises(ValueError, match="BigTIFF"):
        imread(tmp_path / "big.tif")
    with pytest.raises(ValueError, match="only .jpg"):
        native.imwrite(tmp_path / "a.gif", im)
    (tmp_path / "cut.webp").write_bytes(webp.encode(im)[:40])
    with pytest.raises(ValueError):
        imread(tmp_path / "cut.webp")


@pytest.mark.parametrize("kind", ["lzma", "zstd", "webp", "float32", "float32_lzw", "cmyk_alpha", "cmyk_alpha_planar",
                                  "cmyk16", "inkset2", "lab_planar", "ycbcr_2x4", "ycbcr_planar_420", "ycbcr16",
                                  "rgb_five_samples"])
def test_kinds_opencv_reads_nothing_of_raise_value_error(tmp_path, kind):
    """What cv2.imread returns None for raises ValueError: LZMA, Zstandard and
    WebP-in-TIFF (OpenCV's libtiff is built without them), float samples, more
    than four samples, 16-bit or InkSet-2 CMYK, planar CIELab, YCbCr at a
    subsampling libtiff's RGBA reader has no routine for, or subsampled in
    planes, or in 16 bits."""
    rng = np.random.default_rng(len(kind))
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = tmp_path / "k.tif"
    if kind.startswith("float32"):
        Image.fromarray(rgb[..., 0].astype(np.float32)).save(path, compression="tiff_lzw" if "lzw" in kind else None)
    else:
        px, tags, kw = {
            "lzma": (rgb, {259: (3, [34925])}, {}), "zstd": (rgb, {259: (3, [50000])}, {}),
            "webp": (rgb, {259: (3, [50001])}, {}),
            "cmyk_alpha": (MAKER.cmyk_of(rgb, rgb[..., 0]), {262: (3, [5]), 338: (3, [2])}, {}),
            "cmyk_alpha_planar": (MAKER.cmyk_of(rgb, rgb[..., 0]), {262: (3, [5]), 338: (3, [2])}, {"planar": True}),
            "cmyk16": (MAKER.cmyk_of(rgb).astype(np.uint16) * 257, {262: (3, [5])}, {}),
            "inkset2": (MAKER.cmyk_of(rgb), {262: (3, [5]), 332: (3, [2])}, {}),
            "lab_planar": (rgb, {262: (3, [8])}, {"planar": True}),
            "ycbcr_2x4": (rgb, {262: (3, [6]), 530: (3, [2, 4])}, {}),
            "ycbcr_planar_420": (rgb, {262: (3, [6])}, {"planar": True}),
            "ycbcr16": (rgb.astype(np.uint16), {262: (3, [6]), 530: (3, [1, 1])}, {}),
            "rgb_five_samples": (np.concatenate([rgb, rgb[..., :2]], -1), {338: (3, [2, 0])}, {}),
        }[kind]
        path.write_bytes(MAKER.tiff_file(px, tags, deflate=False, **kw))
    assert cv2.imread(str(path)) is None
    with pytest.raises(ValueError):
        imread(path)


# ---------------------------------------------------------------- the slice against the JAX package

FORMATS = [".png", ".jpg", ".bmp", ".tif", ".tiff", ".webp"]


@pytest.fixture(scope="module")
def mixed_set(tmp_path_factory):
    """An OBB/detect set of every format and the EXIF-6 JPEG fixture, each
    with a label file of a few rotated boxes."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(11)
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    sizes = [(48, 64), (64, 40), (57, 64), (64, 64), (33, 64), (64, 50), (40, 44)]
    for i, (ext, (h, w)) in enumerate(zip(FORMATS + [".webp"], sizes)):
        im = MAKER.image(h, w, seed=i)
        name = f"im{i}{ext}"
        if i == len(FORMATS):  # a lossy WebP
            cv2.imwrite(str(img_dir / name), im[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 70])
        else:
            cv2.imwrite(str(img_dir / name), im[..., ::-1])
        cx, cy = rng.uniform(0.3, 0.7, 2)
        (lbl_dir / f"im{i}.txt").write_text(
            f"{i % 3} {cx - .1:.6f} {cy - .1:.6f} {cx + .1:.6f} {cy - .1:.6f} {cx + .1:.6f} {cy + .1:.6f} "
            f"{cx - .1:.6f} {cy + .1:.6f}\n")
    shutil.copy(FIXTURES / "jpeg_exif6_422.jpg", img_dir / "im9.jpg")
    (lbl_dir / "im9.txt").write_text("1 0.2 0.2 0.6 0.2 0.6 0.5 0.2 0.5\n")
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    return root


def test_dataset_over_every_format_matches_jax(mixed_set):
    from quan_ultralytics_tpu.data.build import build_dataloader as jax_loader
    from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader

    cfg = mixed_set / "data.yaml"
    ours, ref = YOLODataset(cfg, "val", task="obb"), JaxDataset(cfg, "val", task="obb")
    assert [s.im_file for s in ours.samples] == [s.im_file for s in ref.samples]
    assert {Path(s.im_file).suffix for s in ours.samples} == set(FORMATS)
    np.testing.assert_array_equal(ours.shapes(), ref.shapes())  # stored sizes: the EXIF-6 JPEG unturned
    assert tuple(ours.shapes()[-1]) == (72, 100)
    kw = dict(imgsz=64, hyp=None, max_labels=4, augment=False, shuffle=False, seed=0, drop_last=False,
              with_meta=True, rect=True)
    dours, dref = YOLODataset(cfg, "val", task="detect"), JaxDataset(cfg, "val", task="detect")
    got, want = list(build_dataloader(dours, 3, **kw)), list(jax_loader(dref, 3, **kw))
    assert [b["im_files"] for b in got] == [b["im_files"] for b in want]
    assert [b["img"].shape for b in got] == [b["img"].shape for b in want]
    for a, b in zip(got, want):
        assert np.abs(a["img"].astype(int) - b["img"].astype(int)).max() <= 1  # F.interpolate vs cv2.resize
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.load_image(i), ref.load_image(i))
    np.testing.assert_array_equal(ours.shapes(), ref.shapes())  # after loading: the turned shapes


def test_load_source_over_every_format_matches_jax(mixed_set):
    from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
    from quan_ultralytics_tpu_torch.data.loaders import load_source

    src = mixed_set / "images" / "val"
    got, want = list(load_source(src)), list(jax_load_source(str(src)))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_dota_and_converter_on_tif_and_bmp_match_jax(tmp_path):
    from quan_ultralytics_tpu.data import split_dota as J
    from quan_ultralytics_tpu.data.converter import convert_dota_to_yolo_obb as jconvert
    from quan_ultralytics_tpu_torch.data import split_dota as T
    from quan_ultralytics_tpu_torch.data.converter import convert_dota_to_yolo_obb

    rng = np.random.default_rng(4)
    for root in (tmp_path / "jax", tmp_path / "port"):
        (root / "images" / "test").mkdir(parents=True)
        (root / "images" / "train").mkdir(parents=True)
        (root / "labelTxt" / "train").mkdir(parents=True)
    scenes = {"S1.tif": MAKER.image(300, 420, seed=1), "S2.bmp": MAKER.image(280, 330, seed=2)}
    for name, im in scenes.items():
        rows = [" ".join(f"{v:.1f}" for v in rng.uniform(0, 250, 8)) + " ship 0" for _ in range(3)]
        for root in (tmp_path / "jax", tmp_path / "port"):
            cv2.imwrite(str(root / "images" / "test" / name), im[..., ::-1])
            cv2.imwrite(str(root / "images" / "train" / name), im[..., ::-1])
            (root / "labelTxt" / "train" / (Path(name).stem + ".txt")).write_text("\n".join(rows) + "\n")
    n_port = T.split_test(str(tmp_path / "port"), str(tmp_path / "port_out"), crop_size=256, gap=64)
    n_jax = J.split_test(str(tmp_path / "jax"), str(tmp_path / "jax_out"), crop_size=256, gap=64)
    assert n_port == n_jax > 4
    got = sorted((tmp_path / "port_out" / "images" / "test").iterdir())
    ref = sorted((tmp_path / "jax_out" / "images" / "test").iterdir())
    assert [p.name for p in got] == [p.name for p in ref]
    for g, r in zip(got, ref):  # the crops: cv2.imwrite's JPEG bytes
        assert g.read_bytes() == r.read_bytes(), g.name
    assert convert_dota_to_yolo_obb(str(tmp_path / "port")) == jconvert(str(tmp_path / "jax")) == 2
    got = sorted((tmp_path / "port" / "labels").rglob("*.txt"))
    ref = sorted((tmp_path / "jax" / "labels").rglob("*.txt"))
    assert [p.name for p in got] == [p.name for p in ref] == ["S1.txt", "S2.txt"]
    for g, r in zip(got, ref):
        assert g.read_bytes() == r.read_bytes()


# ---------------------------------------------------------------- the newer kinds against the JAX package


KIND_NAMES = ["gdal.tif", "cmyk_lzw.tiff", "ycbcr420.tif", "lab.tif", "g4.tif", "g3_2d.tif", "cmyk.jpg"]


def _kind_files(h: int, w: int, seed: int) -> dict:
    """One image of ``h`` x ``w`` in each newer TIFF and JPEG kind: name -> file bytes."""
    im = MAKER.scene(h, w, seed)
    cmyk = io.BytesIO()
    Image.fromarray(MAKER.cmyk_of(im), "CMYK").save(cmyk, "JPEG", quality=80)
    return {"gdal.tif": MAKER.gdal_jpeg_tiff(im, tile=32), "cmyk_lzw.tiff": MAKER.tiff_file(
                MAKER.cmyk_of(im), {262: (3, [5])}, compress="lzw"),
            "ycbcr420.tif": MAKER.ycbcr_file(MAKER.rgb_to_ycbcr(im), 2, 2, rows_per_strip=16, compress="lzw"),
            "lab.tif": MAKER.tiff_file(MAKER.rgb_to_ycbcr(im), {262: (3, [8])}, tile=32),
            "g4.tif": MAKER.fax_tiff(im[..., 1] < 100, "g4", rows_per_strip=20),
            "g3_2d.tif": MAKER.fax_tiff(im[..., 0] < 90, "g3_2d", lsb_first=True, align_eol=True),
            "cmyk.jpg": cmyk.getvalue()}


@pytest.fixture(scope="module")
def kinds_set(tmp_path_factory):
    """An OBB set of the newer TIFF and JPEG kinds (JPEG-YCbCr BigTIFF in GDAL's layout,
    CMYK LZW, raw YCbCr 4:2:0, CIELab, Group 4, Group 3 2-D, CMYK JPEG), each
    image with a label file."""
    root = tmp_path_factory.mktemp("kinds")
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    sizes = [(48, 64), (64, 40), (57, 64), (64, 64), (33, 64), (64, 50), (40, 44)]
    for i, (h, w) in enumerate(sizes):
        name = KIND_NAMES[i]
        (img_dir / f"im{i}_{name}").write_bytes(_kind_files(h, w, i)[name])
        (lbl_dir / f"im{i}_{Path(name).stem}.txt").write_text("0 0.2 0.2 0.6 0.2 0.6 0.6 0.2 0.6\n")
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/val\nval: images/val\nnames:\n  0: a\n")
    return root


def test_dataset_and_load_source_over_newer_kinds_match_jax(kinds_set):
    from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
    from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.data.loaders import load_source

    cfg = kinds_set / "data.yaml"
    ours, ref = YOLODataset(cfg, "val", task="obb"), JaxDataset(cfg, "val", task="obb")
    assert [s.im_file for s in ours.samples] == [s.im_file for s in ref.samples] and len(ours) == len(KIND_NAMES)
    np.testing.assert_array_equal(ours.shapes(), ref.shapes())
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.load_image(i), ref.load_image(i))
    src = kinds_set / "images" / "val"
    got, want = list(load_source(src)), list(jax_load_source(str(src)))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_dota_on_gdal_bigtiff_and_cmyk_scenes_matches_jax(tmp_path):
    from quan_ultralytics_tpu.data import split_dota as J
    from quan_ultralytics_tpu_torch.data import split_dota as T

    scene = MAKER.scene(300, 420, 7)
    files = {"S1.tif": MAKER.gdal_jpeg_tiff(scene, tile=64),
             "S2.tiff": MAKER.tiff_file(MAKER.cmyk_of(scene[:280, :330]), {262: (3, [5])}, compress="lzw", tile=64)}
    for root in (tmp_path / "jax", tmp_path / "port"):
        (root / "images" / "test").mkdir(parents=True)
        for name, data in files.items():
            (root / "images" / "test" / name).write_bytes(data)
    n_port = T.split_test(str(tmp_path / "port"), str(tmp_path / "port_out"), crop_size=200, gap=50)
    n_jax = J.split_test(str(tmp_path / "jax"), str(tmp_path / "jax_out"), crop_size=200, gap=50)
    assert n_port == n_jax > 4
    got = sorted((tmp_path / "port_out" / "images" / "test").iterdir())
    ref = sorted((tmp_path / "jax_out" / "images" / "test").iterdir())
    assert [p.name for p in got] == [p.name for p in ref]
    for g, r in zip(got, ref):  # the crops: cv2.imwrite's JPEG bytes
        assert g.read_bytes() == r.read_bytes(), g.name
