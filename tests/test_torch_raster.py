"""The port's image writers, raster and text against OpenCV 5.0 and matplotlib,
on the CPU (``tests/test_torch_plotting.py`` holds the plots built on them).

* JPEG (``native.encode_jpeg`` / ``imwrite``): the bytes of
  ``cv2.imencode(".jpg")`` (quality 95, 4:2:0) for RGB and gray images whose
  sides are and are not multiples of 16, so decoded within 0 gray levels of
  OpenCV's own file (the stated bound is 1); the port's reader reads them as
  ``cv2.imread`` does. PNG: decoded by ``cv2.imread``, equal.
* Raster (``data/native/pixels``): ``polylines`` (open and closed),
  ``line``, ``rectangle`` outlined and filled, ``circle`` filled and
  outlined, at thickness 1-5, ``LINE_AA`` and ``LINE_8``, on RGB and gray
  images, with points inside and outside the image: equal to cv2; the convex
  fill of fixed-point polygons (the edges of thick lines) equal.
  ``box_points`` and ``resize_nearest`` equal to ``cv2.boxPoints`` and
  ``cv2.resize(INTER_NEAREST)``.
* Text: ``text_size`` equal to ``cv2.getTextSize`` (printable ASCII, scales
  0.05-7, thickness 0-5). The glyphs are a recorded divergence: inside the
  text box the mean absolute difference from ``cv2.putText`` is held below
  12 gray levels on white-on-grey text.

Four tests (cases loop inside them): pytest-xdist's ``--dist loadfile``
queues files by their number of tests, and this file then comes after every
long JAX test file, so it runs beside them and does not delay them.
"""

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu_torch.data.native import native
from quan_ultralytics_tpu_torch.data.native import pixels as px
from quan_ultralytics_tpu_torch.utils import font

CHARS = [chr(c) for c in range(32, 127)]


def _bgr(im):
    return cv2.cvtColor(im, cv2.COLOR_RGB2BGR) if im.ndim == 3 else im


JPEG_SHAPES = [(16, 16, 3), (48, 64, 3), (17, 33, 3), (1, 1, 3), (5, 200, 3), (37, 23, 3), (16, 32), (31, 7),
               (64, 48)]


def test_jpeg_is_opencvs_bytes(tmp_path):
    for shape in JPEG_SHAPES:
        _check_jpeg(shape, tmp_path)


def _check_jpeg(shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    noisy = rng.integers(0, 256, shape, dtype=np.uint8)
    ramp = np.clip(np.add.outer(np.arange(shape[0]) * 5, np.arange(shape[1]) * 3).reshape(shape[:2] + (1,) * (len(shape) - 2))
                   + rng.integers(0, 24, shape), 0, 255).astype(np.uint8)
    for im in (noisy, ramp):
        ref = cv2.imencode(".jpg", _bgr(im))[1].tobytes()
        assert native.encode_jpeg(im) == ref
        path = tmp_path / "a.jpg"
        native.imwrite(path, im)
        mode = cv2.IMREAD_COLOR if im.ndim == 3 else cv2.IMREAD_GRAYSCALE
        ours = cv2.imread(str(path), mode).astype(int)
        theirs = cv2.imdecode(np.frombuffer(ref, np.uint8), mode).astype(int)
        assert np.abs(ours - theirs).max() <= 1
        expect = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(native.imread(path), expect)


def test_png_decodes_equal_in_opencv_and_writers_refuse_other_files(tmp_path):
    _check_refusals(tmp_path)
    for shape in [(1, 1), (9, 13), (9, 13, 3), (64, 48, 3), (33, 2, 1)]:
        im = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
        path = native.imwrite(tmp_path / "a.png", im)
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, _bgr(im.reshape(shape[:2]) if im.ndim == 3 and shape[2] == 1 else im))


def _check_refusals(tmp_path):
    with pytest.raises(ValueError, match="only .jpg"):
        native.imwrite(tmp_path / "a.gif", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(TypeError):
        native.imwrite(tmp_path / "a.jpg", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        native.imwrite(tmp_path / "a.png", np.zeros((4, 4, 2), np.uint8))


def test_lines_polygons_rectangles_circles_equal_opencv():
    for line_type in (px.LINE_AA, px.LINE_8):
        for channels in (3, 1):
            _check_shapes(line_type, channels)
    _check_fill_convex_poly_with_fractional_bits()


def _check_shapes(line_type, channels):
    rng = np.random.default_rng(line_type + channels)
    for t in range(120):
        h, w = (int(v) for v in rng.integers(12, 90, 2))
        shape = (h, w, 3) if channels == 3 else (h, w)
        base = rng.integers(0, 256, shape, dtype=np.uint8)
        col = tuple(int(c) for c in rng.integers(0, 256, 3))[:channels]
        th = int(rng.integers(1, 6))
        lo, hi = (0, min(h, w)) if t % 2 else (-12, max(h, w) + 12)  # inside, or crossing the border
        pts = rng.integers(lo, hi, (int(rng.integers(2, 6)), 2)).astype(np.int32)
        closed = bool(t % 3)
        for draw_cv, draw_px in (
            (lambda a: cv2.polylines(a, [pts], closed, col, th, line_type),
             lambda a: px.polylines(a, [pts], closed, col, th, line_type)),
            (lambda a: cv2.line(a, tuple(map(int, pts[0])), tuple(map(int, pts[1])), col, th, line_type),
             lambda a: px.line(a, pts[0], pts[1], col, th, line_type)),
            (lambda a: cv2.rectangle(a, tuple(map(int, pts[0])), tuple(map(int, pts[1])), col, th, line_type),
             lambda a: px.rectangle(a, pts[0], pts[1], col, th, line_type)),
            (lambda a: cv2.rectangle(a, tuple(map(int, pts[0])), tuple(map(int, pts[1])), col, -1, line_type),
             lambda a: px.rectangle(a, pts[0], pts[1], col, -1, line_type)),
            (lambda a: cv2.circle(a, tuple(map(int, pts[0])), th * 2 + 1, col, -1, line_type),
             lambda a: px.circle(a, pts[0], th * 2 + 1, col, -1, line_type)),
            (lambda a: cv2.circle(a, tuple(map(int, pts[0])), th + 3, col, th, line_type),
             lambda a: px.circle(a, pts[0], th + 3, col, th, line_type)),
        ):
            a, b = base.copy(), base.copy()
            draw_cv(a)
            draw_px(b)
            np.testing.assert_array_equal(b, a, err_msg=f"case {t}: {pts.tolist()} th {th}")


def _check_fill_convex_poly_with_fractional_bits():
    rng = np.random.default_rng(7)
    for t in range(300):
        h, w = (int(v) for v in rng.integers(10, 50, 2))
        bp = cv2.boxPoints(((*rng.uniform(-5, 55, 2),), (*rng.uniform(1, 30, 2),), float(rng.uniform(0, 180))))
        q = np.round(bp * 65536).astype(np.int64)
        for lt in (px.LINE_8, px.LINE_AA):
            a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
            cv2.fillConvexPoly(a, q, (200, 90, 10), lt, 16)
            px.fill_convex_poly(b, q, (200, 90, 10), lt, 16)
            np.testing.assert_array_equal(b, a)


def test_box_points_resize_and_text_size_equal_opencv():
    _check_text()
    rng = np.random.default_rng(0)
    for _ in range(500):
        c, s, ang = rng.uniform(-100, 1100, 2), rng.uniform(0, 300, 2), float(rng.uniform(-200, 200))
        ref = cv2.boxPoints(((float(c[0]), float(c[1])), (float(s[0]), float(s[1])), ang))
        np.testing.assert_array_equal(px.box_points(c, s, ang), ref)
    for _ in range(100):
        sh, sw = (int(v) for v in rng.integers(1, 60, 2))
        dh, dw = (int(v) for v in rng.integers(1, 200, 2))
        im = rng.integers(0, 256, (sh, sw), dtype=np.uint8)
        np.testing.assert_array_equal(px.resize_nearest(im, (dw, dh)),
                                      cv2.resize(im, (dw, dh), interpolation=cv2.INTER_NEAREST))


def _check_text():
    rng = np.random.default_rng(1)
    for _ in range(1500):
        scale, th = float(rng.uniform(0.05, 7.0)), int(rng.integers(0, 6))
        text = "".join(rng.choice(CHARS, int(rng.integers(0, 24))))
        assert font.text_size(text, scale, th) == cv2.getTextSize(text, 0, scale, th)[0], (text, scale, th)
    for scale, th in ((2 / 3, 1), (1.0, 2), (4 / 3, 3), (5 / 3, 4)):
        a = np.full((90, 520, 3), 90, np.uint8)
        b = a.copy()
        text = "plane 0.87 small-vehicle 1.00"
        cv2.putText(a, text, (5, 60), 0, scale, (255, 255, 255), th, cv2.LINE_AA)
        font.put_text(b, text, (5, 60), scale, (255, 255, 255), th)
        w, h = font.text_size(text, scale, th)
        box = (slice(60 - h - 2, 60 + h // 2), slice(3, 7 + w))
        assert np.abs(a[box].astype(int) - b[box]).mean() < 12, (scale, th)
        assert (b[box] != 90).any() and (b[:box[0].start] == 90).all() and (b[box[0].stop:] == 90).all()


