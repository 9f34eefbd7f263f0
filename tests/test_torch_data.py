"""The port's host data path against OpenCV and the JAX package, on the CPU.

* Image readers (`data/native`): PNG exact against ``cv2.imread`` for files
  OpenCV writes (its adaptive filters; gray, 1-bit gray, RGB, RGBA) and for
  the port's own writer (gray, RGB, RGBA, palette; every filter type); JPEG
  exact against ``cv2.imread`` for 4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1 and gray
  at quality 75 and 95, with and without restart intervals, at odd sizes; the
  committed fixtures decode to their committed OpenCV pixels; ``read_shape``
  equals the decoded shape; what the readers do not take raises.
  Progressive JPEG (written by OpenCV and by PIL, 4:4:4, 4:2:2, 4:2:0 and
  gray, with and without restart intervals), EXIF orientations 1-8 (JPEG and
  PNG, written through PIL), 16-bit gray, gray+alpha, RGB and RGBA PNG, and
  Adam7 PNG (written here from a known image at 1, 2, 4, 8 and 16 bits) all
  exact against ``cv2.imread`` (OpenCV 5.0); the committed fixtures of these
  against their OpenCV pixel digests (tests/fixtures/reader_fixtures.json).
* ``min_area_rect`` against ``cv2.minAreaRect``: every one of the five
  numbers within 1e-4 (absolute; pixels and degrees) on seeded rectangles at
  every angle, squares, axis-aligned boxes, integer-rounded rectangles,
  irregular quadrilaterals and small polygons.
* Data configs, ``YOLODataset`` and ``build_dataloader`` against the JAX
  package: the same samples, names and nc; batches at r = 1 (the longer side
  equals imgsz, pad only) with ``img`` exact, ``bboxes`` within 1e-5, the
  rest exact, tail padding and ``drop_last`` included; resized batches with
  ``img`` within one gray level (the port letterboxes with torch's bilinear
  resize, the JAX package with OpenCV's).
"""

import math
import shutil
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from quan_ultralytics_tpu.data import augment as jaug
from quan_ultralytics_tpu.data.build import build_dataloader as jax_loader
from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
from quan_ultralytics_tpu.data.dataset import xyxyxyxy2xywhr_np
from quan_ultralytics_tpu_torch.cfg.datasets import DATASETS, load_data_cfg, parse_data_yaml
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data import augment as taug
from quan_ultralytics_tpu_torch.data.dataset import available_memory
from quan_ultralytics_tpu_torch.data.native import native
from quan_ultralytics_tpu_torch.data.native.native import imread, imwrite_png, read_shape

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
SIZES = [(1, 1), (2, 3), (17, 33), (64, 64), (123, 250)]


def _image(h, w, c, seed=0):
    """A gradient with noise: smooth enough for JPEG, noisy enough for every PNG filter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                   (xx + yy) * 255 // max(h + w - 2, 1), (xx * yy) % 256], -1)[..., :c]
    return np.clip(im + rng.integers(-30, 31, im.shape), 0, 255).astype(np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------- PNG


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_written_by_opencv_decodes_exactly(tmp_path, size, channels):
    im = _image(*size, channels)
    p = tmp_path / "a.png"
    cv2.imwrite(str(p), im)  # OpenCV's writer picks filters adaptively
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))


def test_one_bit_png_decodes_exactly(tmp_path):
    im = (_image(37, 45, 1)[..., 0] > 127).astype(np.uint8) * 255
    p = tmp_path / "bilevel.png"
    cv2.imwrite(str(p), im, [cv2.IMWRITE_PNG_BILEVEL, 1])
    assert p.read_bytes()[24] == 1  # bit depth
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
def test_png_writer_roundtrip_and_opencv(tmp_path, size, kind):
    p = tmp_path / "own.png"
    if kind == "palette":
        palette = np.random.default_rng(1).integers(0, 256, (200, 3), dtype=np.uint8)
        idx = (_image(*size, 1)[..., 0] % 200).astype(np.uint8)
        imwrite_png(p, idx, palette=palette)
        want = palette[idx]
    else:
        im = _image(*size, {"gray": 1, "rgb": 3, "rgba": 4}[kind])
        imwrite_png(p, im[..., 0] if kind == "gray" else im)
        want = np.repeat(im, 3, -1) if kind == "gray" else im[..., :3]
    got = imread(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(p))
    # rows cycle through the five filter types
    raw = zlib.decompress(p.read_bytes()[p.read_bytes().index(b"IDAT") + 4:-16])
    rowbytes = len(raw) // size[0]
    assert [raw[y * rowbytes] for y in range(size[0])] == [y % 5 for y in range(size[0])]


# ---------------------------------------------------------------- JPEG


SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "gray": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (64, 64), (123, 250)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality,restart", [(75, 0), (95, 3)])
def test_jpeg_decodes_as_opencv(tmp_path, size, sampling, quality, restart):
    im = _image(*size, 1 if sampling == "gray" else 3, seed=quality)
    p = tmp_path / "a.jpg"
    cv2.imwrite(str(p), im, [cv2.IMWRITE_JPEG_QUALITY, quality,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                             cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))
    assert read_shape(p) == size


@pytest.mark.parametrize("name", ["jpeg_420_q90_rst", "jpeg_422_q75_odd", "jpeg_gray_q95"])
def test_committed_jpeg_fixtures(name):
    got = imread(FIXTURES / f"{name}.jpg")
    np.testing.assert_array_equal(got, np.load(FIXTURES / f"{name}.npy"))
    np.testing.assert_array_equal(got, _cv2_rgb(FIXTURES / f"{name}.jpg"))


def test_timing_fixture_decodes_as_opencv():
    got = imread(FIXTURES / "jpeg_1024_q75.jpg")
    assert got.shape == (1024, 1024, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(FIXTURES / "jpeg_1024_q75.jpg"))


def test_read_shape_matches_opencv(tmp_path):
    for i, (h, w) in enumerate([(5, 7), (300, 200), (1024, 1365)]):
        im = _image(h, w, 3, seed=i)
        for ext in (".png", ".jpg"):
            p = tmp_path / f"s{i}{ext}"
            cv2.imwrite(str(p), im)
            assert read_shape(p) == cv2.imread(str(p)).shape[:2] == (h, w)


def _with_exif_orientation(jpg: bytes, orientation: int) -> bytes:
    tiff = b"MM\x00\x2a\x00\x00\x00\x08" + struct.pack(">H", 1) + struct.pack(
        ">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00\x00\x00\x00"
    app1 = b"Exif\x00\x00" + tiff
    return jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpg[2:]


def _with_marker(jpg: bytes, old: int, new: int) -> bytes:
    """The file with its first ``FF old`` marker made ``FF new``."""
    i = jpg.index(bytes([0xFF, old]))
    return jpg[:i + 1] + bytes([new]) + jpg[i + 2:]


def test_unsupported_images_raise(tmp_path):
    """What the readers refuse: arithmetic-coded, lossless, hierarchical,
    12-bit and YCCK JPEG, other formats, cut and missing files. The kinds once
    refused here (progressive and CMYK JPEG, 16-bit and interlaced PNG,
    EXIF-rotated files) decode as OpenCV decodes them."""
    from PIL import Image

    im = _image(16, 16, 3)
    plain = tmp_path / "plain.jpg"
    cv2.imwrite(str(plain), im)
    jpg = plain.read_bytes()
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless"), (0xC6, "hierarchical")):
        (tmp_path / f"m{marker}.jpg").write_bytes(_with_marker(jpg, 0xC0, marker))
        with pytest.raises(NotImplementedError, match=what):
            imread(tmp_path / f"m{marker}.jpg")
    sof = jpg.index(b"\xff\xc0")
    (tmp_path / "p12.jpg").write_bytes(jpg[:sof + 4] + b"\x0c" + jpg[sof + 5:])
    with pytest.raises(NotImplementedError, match="8-bit"):
        imread(tmp_path / "p12.jpg")
    Image.fromarray(im).convert("CMYK").save(tmp_path / "cmyk.jpg")
    cmyk = (tmp_path / "cmyk.jpg").read_bytes()
    at = cmyk.index(b"Adobe") + 11  # APP14's transform: 2 is YCCK
    (tmp_path / "ycck.jpg").write_bytes(cmyk[:at] + b"\x02" + cmyk[at + 1:])
    with pytest.raises(NotImplementedError, match="YCCK"):
        imread(tmp_path / "ycck.jpg")
    prog = tmp_path / "progressive.jpg"
    cv2.imwrite(str(prog), im, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), (im.astype(np.uint16) * 257))
    adam7 = tmp_path / "adam7.png"
    _fixture_maker().write_png(adam7, im)
    (tmp_path / "rotated.jpg").write_bytes(_with_exif_orientation(jpg, 6))
    upright = tmp_path / "upright.jpg"
    upright.write_bytes(_with_exif_orientation(jpg, 1))
    for p in (prog, deep, adam7, tmp_path / "rotated.jpg", upright, tmp_path / "cmyk.jpg"):
        np.testing.assert_array_equal(imread(p), _cv2_rgb(p), err_msg=p.name)
    Image.fromarray(im).save(tmp_path / "a.gif")  # a GIF is read now, as cv2.imread reads its first frame
    np.testing.assert_array_equal(imread(tmp_path / "a.gif"), _cv2_rgb(tmp_path / "a.gif"))
    (tmp_path / "a.xcf").write_bytes(b"gimp xcf file\0" + bytes(64))  # a kind no reader takes
    with pytest.raises(NotImplementedError, match="this kind of file is not read"):
        imread(tmp_path / "a.xcf")
    (tmp_path / "cut.jpg").write_bytes(jpg[:len(jpg) // 2])
    with pytest.raises(ValueError, match="ends before"):
        imread(tmp_path / "cut.jpg")
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "missing.png")


@pytest.mark.parametrize("subsampling", [None, 0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_jpeg_as_opencv(tmp_path, subsampling, progressive):
    """Four-component JPEG with Adobe's APP14 (transform 0), as PIL writes it
    at every subsampling (its first component's factors; the others 1 x 1):
    libjpeg's CMYK, then OpenCV's CMYK -> BGR."""
    from PIL import Image

    rng = np.random.default_rng((subsampling or 3) + 4 * progressive)
    kw = {} if subsampling is None else {"subsampling": subsampling}  # None: PIL's default
    for size in [(1, 1), (37, 53), (64, 64), (17, 130)]:
        px = np.clip(np.add.outer(np.arange(size[0]) * 5, np.arange(size[1]) * 3)[..., None]
                     + rng.integers(0, 60, size + (4,)), 0, 255).astype(np.uint8)
        p = tmp_path / f"c{size[0]}.jpg"
        Image.fromarray(px, "CMYK").save(p, quality=int(rng.integers(40, 96)), progressive=progressive, **kw)
        np.testing.assert_array_equal(imread(p), _cv2_rgb(p))
        assert read_shape(p) == size


# ---------------------------------------------------------------- progressive JPEG, EXIF, 16-bit and Adam7 PNG


def _fixture_maker():
    """tests/fixtures/make_reader_fixtures.py as a module (its Adam7 PNG writer)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_reader_fixtures",
                                                  FIXTURES / "make_reader_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _markers(data: bytes):
    return {data[i + 1] for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] not in (0, 0xFF)}


@pytest.mark.parametrize("size", [(1, 1), (37, 53), (121, 200)])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("restart", [0, 3])
def test_progressive_jpeg_by_opencv_decodes_as_opencv(tmp_path, size, sampling, restart):
    im = _image(*size, 1 if sampling == "gray" else 3, seed=restart)
    p = tmp_path / "p.jpg"
    cv2.imwrite(str(p), im, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                             cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    found = _markers(p.read_bytes())
    assert 0xC2 in found and (0xDD in found) == bool(restart)  # progressive; restart intervals
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))
    assert read_shape(p) == size


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_jpeg_by_pil_decodes_as_opencv(tmp_path, subsampling):
    from PIL import Image

    for i, size in enumerate([(37, 53), (64, 48), (150, 97)]):
        p = tmp_path / f"p{i}.jpg"
        Image.fromarray(_image(*size, 3, seed=i)).save(p, quality=80, progressive=True,
                                                        subsampling=subsampling)
        assert 0xC2 in _markers(p.read_bytes())
        np.testing.assert_array_equal(imread(p), _cv2_rgb(p), err_msg=str(size))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv(tmp_path, orientation):
    """JPEG and PNG written through PIL with each orientation: the pixels and
    ``read_shape`` as OpenCV's IMREAD_COLOR turns them."""
    from PIL import Image

    ex = Image.Exif()
    ex[0x0112] = orientation
    im = Image.fromarray(_image(29, 46, 3, seed=orientation))
    for name in ("o.jpg", "o.png"):
        p = tmp_path / name
        im.save(p, exif=ex.tobytes())
        ref = _cv2_rgb(p)
        np.testing.assert_array_equal(imread(p), ref, err_msg=name)
        assert read_shape(p) == ref.shape[:2], name


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_sixteen_bit_png_as_opencv(tmp_path, channels):
    """16-bit PNG reduced to 8 bits as OpenCV 5.0's IMREAD_COLOR reduces it
    (the high byte); gray+alpha written by this suite's PNG writer (OpenCV writes
    no two-channel PNG), the rest by OpenCV."""
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 65536, (19, 31, channels), dtype=np.uint16)
    px[0, :8, 0] = [0, 127, 128, 255, 256, 32767, 32768, 65535]  # the rounding's edges
    p = tmp_path / "d.png"
    if channels == 2:
        _fixture_maker().write_png(p, px, interlace=False)
    else:
        cv2.imwrite(str(p), px[..., ::-1] if channels >= 3 else px)
    assert p.read_bytes()[24] == 16
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (8, 8), (45, 67), (130, 9)])
@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba", "rgb16", "gray2", "palette4"])
def test_adam7_png_as_opencv(tmp_path, size, kind):
    """An interlaced PNG built here from a known image (every filter type in
    every pass) decodes to that image and to OpenCV's pixels."""
    maker = _fixture_maker()
    h, w = size
    c = {"gray": 1, "gray_alpha": 2, "rgb": 3, "rgba": 4, "rgb16": 3}.get(kind, 1)
    im = _image(h, w, c, seed=h * w)
    p = tmp_path / "i.png"
    if kind == "rgb16":
        px = im.astype(np.uint16) * 257 + np.random.default_rng(0).integers(0, 256, im.shape).astype(np.uint16)
        maker.write_png(p, px)
        want = (px >> 8).astype(np.uint8)
    elif kind in ("gray2", "palette4"):  # sub-byte samples, written by swapping the depth and packing
        depth = 2 if kind == "gray2" else 4
        idx = (im[..., 0] >> (8 - depth)).astype(np.uint8)
        _write_packed_adam7(p, idx, depth, colour=0 if kind == "gray2" else 3)
        if kind == "gray2":
            want = np.repeat((idx * (255 // 3))[..., None], 3, -1)
        else:
            want = _PALETTE[idx]
    else:
        maker.write_png(p, im)
        want = np.repeat(im[..., :1], 3, -1) if c <= 2 else im[..., :3]
    assert p.read_bytes()[28] == 1  # interlaced
    np.testing.assert_array_equal(imread(p), want)
    np.testing.assert_array_equal(imread(p), _cv2_rgb(p))


_PALETTE = np.random.default_rng(5).integers(0, 256, (16, 3)).astype(np.uint8)


def _write_packed_adam7(path, idx: np.ndarray, depth: int, colour: int) -> None:
    """An Adam7 PNG of ``depth``-bit samples ``idx`` (gray, or palette indices into `_PALETTE`)."""
    maker = _fixture_maker()
    h, w = idx.shape
    raw = b""
    for x0, y0, dx, dy in maker.ADAM7:
        sub = idx[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        bits = np.unpackbits(sub[..., None], axis=-1)[..., 8 - depth:].reshape(sub.shape[0], -1)
        rows = np.packbits(bits, axis=1)
        raw += b"".join(b"\x00" + r.tobytes() for r in rows)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    body = [chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 1))]
    if colour == 3:
        body.append(chunk(b"PLTE", _PALETTE.tobytes()))
    body += [chunk(b"IDAT", zlib.compress(raw)), chunk(b"IEND", b"")]
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + b"".join(body))


def test_committed_reader_fixtures():
    """The committed progressive, EXIF-rotated and Adam7 fixtures against their
    OpenCV pixel digests, and against OpenCV itself."""
    import hashlib
    import json

    for name, ref in json.loads((FIXTURES / "reader_fixtures.json").read_text()).items():
        got = imread(FIXTURES / name)
        assert list(got.shape) == ref["shape"] and read_shape(FIXTURES / name) == tuple(ref["shape"][:2]), name
        assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"], name
        np.testing.assert_array_equal(got, _cv2_rgb(FIXTURES / name), err_msg=name)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library()


# ---------------------------------------------------------------- minAreaRect


def _rect(cx, cy, w, h, t):
    c, s = math.cos(t), math.sin(t)
    return np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                     for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))],
                    np.float32)


def _rect_cases():
    rng = np.random.default_rng(0)
    out = {"every angle": [_rect(*rng.uniform(0, 1024, 2), *rng.uniform(1, 300, 2), math.radians(a))
                           for a in np.arange(-180, 180, 0.5)]}
    out["squares"] = [_rect(*rng.uniform(0, 1024, 2), *(2 * [rng.uniform(1, 300)]), rng.uniform(-4, 4))
                      for _ in range(300)]
    out["axis-aligned"] = [_rect(*rng.uniform(0, 1024, 2), *rng.uniform(1, 300, 2), k * math.pi / 2)
                           for k in rng.integers(-4, 5, 300)]
    out["rounded to pixels"] = [np.round(_rect(*rng.uniform(0, 1024, 2), *rng.uniform(1, 300, 2),
                                               rng.uniform(-4, 4))) for _ in range(600)]
    out["irregular quadrilaterals"] = [rng.uniform(0, 100, (4, 2)).astype(np.float32) for _ in range(1500)]
    out["small integer points"] = [rng.integers(0, 5, (4, 2)).astype(np.float32) for _ in range(300)]
    out["polygons"] = [rng.uniform(0, 100, (int(rng.integers(5, 12)), 2)).astype(np.float32)
                       for _ in range(200)]
    for pts in out["every angle"][:50]:  # corner order and start do not matter to the result
        out["every angle"].append(np.roll(pts[::-1], 1, axis=0))
    return out


@pytest.mark.parametrize("kind", list(_rect_cases()))
def test_min_area_rect_matches_opencv(kind):
    worst = 0.0
    for pts in _rect_cases()[kind]:
        (cx, cy), (w, h), a = cv2.minAreaRect(pts)
        got = taug.min_area_rect(pts)
        err = np.abs(np.array([cx, cy, w, h, a]) - np.array([*got[0], *got[1], got[2]])).max()
        assert err <= 1e-4, (kind, pts.tolist(), (cx, cy, w, h, a), got)
        worst = max(worst, err)
    assert -90 <= got[2] < 0


def test_min_area_rect_opencv_convention():
    assert taug.min_area_rect(np.array([[0, 0], [4, 0], [4, 2], [0, 2]], np.float32)) == \
        ((2.0, 1.0), (2.0, 4.0), -90.0)
    for pts in ([[0, 0], [1, 1]], [[0, 0], [0, 1]], [[3, 4]], [[0, 0], [1, 1], [2, 2], [3, 3]]):
        pts = np.array(pts, np.float32)
        np.testing.assert_allclose(np.hstack(taug.min_area_rect(pts)[:2] + (taug.min_area_rect(pts)[2],)),
                                   np.hstack(cv2.minAreaRect(pts)[:2] + (cv2.minAreaRect(pts)[2],)),
                                   atol=1e-6)


def test_corner_helpers_match_jax():
    rng = np.random.default_rng(3)
    corners = np.stack([_rect(*rng.uniform(0, 640, 2), *rng.uniform(2, 200, 2), rng.uniform(-3, 3))
                        for _ in range(64)])
    np.testing.assert_allclose(taug.corners_to_xywhr(corners), jaug.corners_to_xywhr(corners),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(taug.corners_to_xywhr(corners / 640), xyxyxyxy2xywhr_np(corners / 640),
                               rtol=0, atol=1e-6)
    xywh = rng.uniform(0, 1, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(taug.xywh_to_corners(xywh), jaug.xywh_to_corners(xywh))
    np.testing.assert_array_equal(taug.corners_to_xyxy(corners, 500, 400),
                                  jaug.corners_to_xyxy(corners, 500, 400))


# ---------------------------------------------------------------- configs


def test_dataset_literals_equal_yaml():
    cfg_dir = REPO / "quan_ultralytics_tpu" / "cfg" / "datasets"
    assert set(DATASETS) == {p.name for p in cfg_dir.glob("*.yaml")}
    for name, literal in DATASETS.items():
        ref = yaml.safe_load((cfg_dir / name).read_text())
        assert literal == ref, name
        assert load_data_cfg(cfg_dir / name) == ref, name


@pytest.mark.parametrize("cfg", [
    {"path": "/data/x", "train": "images/train", "val": "images/val", "names": {0: "a", 1: "b c"}},
    {"path": "rel dir", "names": ["plane", "yes", "1", "x: y", "it's", "#tag"], "nc": 6, "scale": 0.5,
     "flag": True, "none": None, "test": "images/test # not a comment"},
])
def test_data_yaml_reader_matches_pyyaml(cfg):
    text = yaml.dump(cfg)
    assert parse_data_yaml(text) == yaml.safe_load(text) == cfg
    text = "# a comment\n" + text.replace("\n", "  # trailing\n", 1)
    assert parse_data_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["names: [a, b]", "a:\n  b:\n    c: 1", "x: {a: 1}", "k: &a v",
                                  "k: \"esc\\tape\"", "x: 1\nx: 2", "  - a"])
def test_data_yaml_reader_refuses_the_rest(text):
    with pytest.raises(ValueError):
        parse_data_yaml(text)


# ---------------------------------------------------------------- dataset and loader


def _write_set(root: Path, sizes, task="obb", nc=3, seed=0, ext=".png"):
    """A labelled set written with OpenCV: random images, 0-5 rotated (obb) or
    axis-aligned (detect) boxes each, one image without a label file."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            cv2.imwrite(str(root / "images" / split / f"im{i}{ext}"),
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            if i == 1:
                continue  # no label file
            lines = []
            for _ in range(int(rng.integers(0, 6))):
                c = int(rng.integers(0, nc))
                if task == "obb":
                    pts = _rect(*rng.uniform(0.25, 0.75, 2), *rng.uniform(0.05, 0.4, 2), rng.uniform(-3, 3))
                    lines.append(" ".join([str(c)] + [f"{v:.6f}" for v in pts.reshape(-1)]))
                else:
                    v = [*rng.uniform(0.3, 0.7, 2), *rng.uniform(0.05, 0.4, 2)]
                    lines.append(" ".join([str(c)] + [f"{x:.6f}" for x in v]))
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    cfg = {"path": str(root), "train": "images/train", "val": "images/val",
           "names": {i: f"c{i}" for i in range(nc)}}
    (root / "data.yaml").write_text(yaml.dump(cfg))
    return root / "data.yaml"


# r = 1 at imgsz 64: the longer side of every image is 64
PAD_ONLY = [(64, 64), (48, 64), (64, 40), (64, 64), (33, 64), (64, 57), (64, 64)]
RESIZED = [(80, 120), (50, 30), (128, 128), (97, 61), (64, 200)]


@pytest.fixture(scope="module")
def pad_only_set(tmp_path_factory):
    return _write_set(tmp_path_factory.mktemp("pad_only"), PAD_ONLY)


def test_dataset_matches_jax(pad_only_set):
    for split in ("train", "val"):
        for cfg in (pad_only_set, load_data_cfg(pad_only_set)):
            ours = YOLODataset(cfg, split, task="obb")
            ref = JaxDataset(pad_only_set, split, task="obb")
            assert ours.names == ref.names and ours.nc == ref.nc == 3
            assert len(ours) == len(ref) == len(PAD_ONLY)
            for a, b in zip(ours.samples, ref.samples):
                assert a.im_file == b.im_file
                np.testing.assert_array_equal(a.cls, b.cls)
                np.testing.assert_array_equal(a.bboxes, b.bboxes)
            np.testing.assert_array_equal(ours.shapes(), ref.shapes())
    # the segment task runs: these 8-value rows are 4-point polygons, resampled as the JAX package does
    ours, ref = YOLODataset(pad_only_set, "val", task="segment"), JaxDataset(pad_only_set, "val", task="segment")
    assert len(ours) == len(ref) == len(PAD_ONLY)
    for a, b in zip(ours.samples, ref.samples):
        np.testing.assert_array_equal(a.cls, b.cls)
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        assert a.bboxes.shape[1:] == (64,)


@pytest.mark.parametrize("cache", [None, "ram", "disk"])
def test_dataset_cache(tmp_path, cache):
    data = _write_set(tmp_path, PAD_ONLY[:3])
    ds = YOLODataset(data, "val", task="obb", cache=cache)
    assert ds.cache == cache  # the set fits in memory
    for _ in range(2):
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds.load_image(i), _cv2_rgb(ds.samples[i].im_file))
    if cache == "disk":
        assert len(list((tmp_path / "images" / "val" / ".npy_cache").glob("*.npy"))) == 3
    assert available_memory() > 0


def _assert_batches_equal(ours, ref, img_atol=0):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        diff = np.abs(a["img"].astype(int) - b["img"].astype(int))
        assert a["img"].dtype == b["img"].dtype == np.uint8 and diff.max() <= img_atol
        np.testing.assert_allclose(a["bboxes"], b["bboxes"], rtol=0, atol=1e-5)
        for k in set(a) - {"img", "bboxes"}:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    return ours


@pytest.mark.parametrize("batch,drop_last,shuffle", [(3, False, False), (3, True, True), (4, False, True),
                                                    (16, False, False)])
def test_loader_matches_jax_pad_only(pad_only_set, batch, drop_last, shuffle):
    kw = dict(imgsz=64, hyp=None, max_labels=8, augment=False, shuffle=shuffle, seed=5,
              drop_last=drop_last, with_meta=True)
    ours = YOLODataset(pad_only_set, "val", task="obb")
    ref = JaxDataset(pad_only_set, "val", task="obb")
    got = _assert_batches_equal(build_dataloader(ours, batch, **kw), jax_loader(ref, batch, **kw))
    n = len(PAD_ONLY)
    want = ([batch] * (n // batch) if drop_last and batch <= n
            else [min(batch, n - i) for i in range(0, n, batch)])
    assert [b["n_real"] for b in got] == want and all(len(b["im_files"]) == batch for b in got)
    # without meta, as the train loader runs
    kw.update(with_meta=False, augment=True)
    _assert_batches_equal(build_dataloader(ours, batch, **kw), jax_loader(ref, batch, **kw))


@pytest.mark.parametrize("task", ["obb", "detect"])
def test_loader_matches_jax_resized(tmp_path, task):
    data = _write_set(tmp_path, RESIZED, task=task, seed=2, ext=".jpg")
    ours, ref = YOLODataset(data, "train", task=task), JaxDataset(data, "train", task=task)
    kw = dict(imgsz=64, hyp=None, max_labels=6, augment=False, shuffle=True, seed=1, drop_last=False,
              with_meta=True)
    _assert_batches_equal(build_dataloader(ours, 2, **kw), jax_loader(ref, 2, **kw), img_atol=1)
    if task == "detect":  # rect and multi-scale batches (detect only: OBB batches are square)
        for extra in (dict(rect=True, shuffle=False), dict(multi_scale=True, with_meta=False)):
            _assert_batches_equal(build_dataloader(ours, 2, **{**kw, **extra}),
                                  jax_loader(ref, 2, **{**kw, **extra}), img_atol=1)


def test_loader_refuses_augmentation(pad_only_set):
    # the train augmentations run (tests/test_torch_augment.py); rect batching refuses them
    ds = YOLODataset(pad_only_set, "train", task="obb")
    with pytest.raises(ValueError, match="rect batching"):
        next(build_dataloader(ds, 2, 64, hyp=jaug.AugmentHyp(), augment=True, rect=True))
    assert next(build_dataloader(ds, 2, 64, hyp=jaug.AugmentHyp(), augment=True))["img"].shape == (2, 64, 64, 3)
    rgb = torch.from_numpy(_image(30, 40, 3))
    assert taug.letterbox(rgb, 64)[0].shape == (64, 64, 3)
