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
* one folder that mixes every format and an EXIF-6 JPEG through
  ``YOLODataset`` (images, ``shapes()``, the rect loader's order and batch
  shapes), ``load_source``, ``split_dota`` and the DOTA converter, against the
  JAX package. No JAX compile runs here.
"""

from __future__ import annotations

import hashlib
import importlib.util
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
    assert list(read_stored_shape(path)) == ref["stored"]
    if ref.get("raises") == "NotImplementedError":
        with pytest.raises(NotImplementedError, match="JPEG-in-TIFF"):
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

TIFF_LAYOUTS = [("none", False), ("deflate", False), ("deflate", True)]


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
    Image.fromarray(im).save(tmp_path / "a.gif")
    with pytest.raises(NotImplementedError, match="GIF"):
        imread(tmp_path / "a.gif")
    with pytest.raises(NotImplementedError, match="GIF"):
        read_shape(tmp_path / "a.gif")
    Image.fromarray(im).save(tmp_path / "j.tif", compression="jpeg")
    with pytest.raises(NotImplementedError, match="JPEG-in-TIFF"):
        imread(tmp_path / "j.tif")
    Image.fromarray(im).convert("1").save(tmp_path / "g4.tif", compression="group4")
    with pytest.raises(NotImplementedError, match="CCITT"):
        imread(tmp_path / "g4.tif")
    Image.fromarray(im).convert("YCbCr").save(tmp_path / "y.tif")
    with pytest.raises(NotImplementedError, match="YCbCr"):
        imread(tmp_path / "y.tif")
    Image.fromarray(im).convert("CMYK").save(tmp_path / "k.tif")
    with pytest.raises(NotImplementedError, match="CMYK"):
        imread(tmp_path / "k.tif")
    Image.fromarray(im[..., 0].astype(np.float32)).save(tmp_path / "f.tif")
    with pytest.raises(NotImplementedError, match="float"):
        imread(tmp_path / "f.tif")
    (tmp_path / "big.tif").write_bytes(b"II+\0" + bytes(12))
    with pytest.raises(NotImplementedError, match="BigTIFF"):
        imread(tmp_path / "big.tif")
    with pytest.raises(ValueError, match="only .jpg"):
        native.imwrite(tmp_path / "a.gif", im)
    (tmp_path / "cut.webp").write_bytes(webp.encode(im)[:40])
    with pytest.raises(ValueError):
        imread(tmp_path / "cut.webp")


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
