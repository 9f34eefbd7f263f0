"""The pixel work of the train augmentations, without OpenCV: numpy in and out,
C++ (``augment.cpp``) in between.

Each function gives OpenCV 5.0's pixels for the call it replaces (see
``augment.cpp``): the warps, the 8-bit colour conversions (HSV, gray, Lab),
the box and median filters, CLAHE and the filled polygons of
``drawContours``. Arrays are uint8, ``[h, w, 3]`` RGB unless a function says
one channel.

``augment.cpp`` is compiled with ``g++`` at first use into ``build/`` at the
repository root, keyed by a hash of its source and flags, under a file lock
(`utils.native_build`); a missing compiler raises. ctypes releases the GIL
for each call, so loader threads run them at once. `optical_flow_pyr_lk` is
the Lucas-Kanade tracker of BoT-SORT's motion compensation
(`trackers.gmc`), held to ``cv2.calcOpticalFlowPyrLK``.

The raster of the port's plots (``draw.cpp``, a library of its own built the
same way) draws in place on uint8 ``[h, w]`` or ``[h, w, 3]`` images with
OpenCV 5.0's pixels: `polylines`, `line`, `rectangle`, `fill_convex_poly` and
`circle`, at any thickness, ``LINE_8`` or ``LINE_AA``. `box_points` and
`resize_nearest` are ``cv2.boxPoints`` and ``cv2.resize(INTER_NEAREST)`` in
numpy.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from quan_ultralytics_tpu_torch.utils.native_build import BUILD_DIR, build_cxx

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
LIB_NAME = "libquan_torch_augment.so"
DRAW_SOURCE = SOURCE.with_name("draw.cpp")
DRAW_LIB_NAME = "libquan_torch_draw.so"
# no -ffast-math, no -march=native and no contraction into fused multiply-adds:
# the float32 warp and colour steps round alike on every machine
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
BORDER = 114

_lib: Optional[ctypes.CDLL] = None
_draw_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I, _L, _D = ctypes.c_int, ctypes.c_long, ctypes.c_double
_SIGNATURES = {
    "aug_warp_affine": [_P, _I, _I, _P, _I, _I, _P, _I],
    "aug_warp_perspective": [_P, _I, _I, _P, _I, _I, _P, _I],
    "aug_rgb_to_hsv": [_P, _P, _L],
    "aug_hsv_to_rgb": [_P, _P, _L, _I],
    "aug_rgb_to_gray": [_P, _P, _L],
    "aug_rgb_to_lab": [_P, _P, _L],
    "aug_lab_to_rgb": [_P, _P, _L],
    "aug_blur": [_P, _I, _I, _I, _P, _I],
    "aug_median_blur": [_P, _I, _I, _I, _P, _I],
    "aug_clahe": [_P, _I, _I, _P, _D, _I, _I],
    "aug_fill_polygons": [_P, _I, _I, _P, _P, _I],
    "aug_optical_flow_lk": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _D, _D],
}
_DRAW_SIGNATURES = {
    "draw_polyline": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I],
    "draw_fill_convex": [_P, _I, _I, _I, _P, _I, _P, _I, _I],
    "draw_circle": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I],
}
LINE_8, LINE_AA = 8, 16  # cv2.LINE_8, cv2.LINE_AA


def build() -> Path:
    """Compile ``augment.cpp`` if its source or flags changed; return the library path."""
    return build_cxx(SOURCE, LIB_NAME, CXX_FLAGS, BUILD_DIR)


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _lib = lib
    return _lib


def draw_library() -> ctypes.CDLL:
    """The loaded raster library (``draw.cpp``), built on first call."""
    global _draw_lib
    if _draw_lib is None:
        lib = ctypes.CDLL(str(build_cxx(DRAW_SOURCE, DRAW_LIB_NAME, CXX_FLAGS, BUILD_DIR)))
        for name, argtypes in _DRAW_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _draw_lib = lib
    return _draw_lib


def _rgb(im: np.ndarray) -> np.ndarray:
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"expected a uint8 [h, w, 3] image, got {im.dtype} {im.shape}")
    return np.ascontiguousarray(im)


def _gray(im: np.ndarray) -> np.ndarray:
    if im.dtype != np.uint8 or im.ndim != 2:
        raise ValueError(f"expected a uint8 [h, w] image, got {im.dtype} {im.shape}")
    return np.ascontiguousarray(im)


def _warp(fn: str, im: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    src = _rgb(im)
    w, h = dsize
    out = np.empty((h, w, 3), np.uint8)
    m = np.ascontiguousarray(m, np.float64)
    getattr(library(), fn)(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, h, w, m.ctypes.data,
                           BORDER)
    return out


def warp_affine(im: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(im, m, dsize, borderValue=(114, 114, 114))``: bilinear,
    the forward 2x3 matrix ``m``, ``dsize`` = (width, height)."""
    return _warp("aug_warp_affine", im, np.asarray(m).reshape(2, 3), dsize)


def warp_perspective(im: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(im, m, dsize, borderValue=(114, 114, 114))``."""
    return _warp("aug_warp_perspective", im, np.asarray(m).reshape(3, 3), dsize)


def _pointwise(fn: str, im: np.ndarray, channels: int = 3) -> np.ndarray:
    src = _rgb(im)
    out = np.empty(src.shape[:2] + ((channels,) if channels > 1 else ()), np.uint8)
    getattr(library(), fn)(src.ctypes.data, out.ctypes.data, src.shape[0] * src.shape[1])
    return out


def rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_RGB2HSV)``: hue in [0, 180)."""
    return _pointwise("aug_rgb_to_hsv", im)


def hsv_to_rgb(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_HSV2RGB)`` (OpenCV rounds the last pixels of a
    row apart from the rest: the row width matters)."""
    src = _rgb(im)
    out = np.empty_like(src)
    library().aug_hsv_to_rgb(src.ctypes.data, out.ctypes.data, src.shape[0] * src.shape[1], src.shape[1])
    return out


def rgb_to_gray(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_RGB2GRAY)``: one channel ``[h, w]``."""
    return _pointwise("aug_rgb_to_gray", im, channels=1)


def rgb_to_lab(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_RGB2LAB)``."""
    return _pointwise("aug_rgb_to_lab", im)


def lab_to_rgb(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_LAB2RGB)``."""
    return _pointwise("aug_lab_to_rgb", im)


def _filter(fn: str, im: np.ndarray, k: int) -> np.ndarray:
    if k % 2 == 0 or k < 1:
        raise ValueError(f"kernel size {k}: expected an odd size")
    src = _rgb(im)
    out = np.empty_like(src)
    getattr(library(), fn)(src.ctypes.data, src.shape[0], src.shape[1], 3, out.ctypes.data, k)
    return out


def blur(im: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(im, (k, k))``: the normalised box filter, BORDER_REFLECT_101."""
    return _filter("aug_blur", im, k)


def median_blur(im: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(im, k)``: BORDER_REPLICATE."""
    return _filter("aug_median_blur", im, k)


def clahe(im: np.ndarray, clip_limit: float) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (8, 8)).apply(im)`` of a one-channel image."""
    src = _gray(im)
    out = np.empty_like(src)
    library().aug_clahe(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, float(clip_limit), 8, 8)
    return out


def fill_polygons(mask: np.ndarray, polygons: Sequence[np.ndarray]) -> np.ndarray:
    """``cv2.drawContours(mask, polygons, -1, 1, cv2.FILLED)`` in place on a
    one-channel uint8 mask: each polygon ``[k, 2]`` of int32 (x, y) points;
    where polygons overlap, the even-odd rule decides."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous uint8 [h, w] mask, got {mask.dtype} {mask.shape}")
    polys = [np.asarray(p).reshape(-1, 2) for p in polygons]
    if not polys:
        return mask
    if any(p.dtype != np.int32 for p in polys):
        raise ValueError("polygon points must be int32, as OpenCV's contours")
    pts = np.ascontiguousarray(np.concatenate(polys))
    if pts.size and np.abs(pts).max() >= 1 << 20:
        raise ValueError("polygon points must lie within +-2^20")
    counts = np.array([len(p) for p in polys], np.int32)
    library().aug_fill_polygons(mask.ctypes.data, mask.shape[0], mask.shape[1], pts.ctypes.data,
                                counts.ctypes.data, len(polys))
    return mask


# cv2.calcOpticalFlowPyrLK's defaults: a 21 x 21 window, 3 levels above the frame,
# 30 iterations or a step below 0.01 px, a minimum eigenvalue of 1e-4
LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG = 21, 3, 30, 0.01, 1e-4


def optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)`` on uint8 ``[h, w]``
    images: ``(next points [n, 1, 2] float32, status [n, 1] uint8)`` for
    float32 ``pts [n, 1, 2]``."""
    prev, nxt = _gray(prev), _gray(nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"the images differ in size: {prev.shape}, {nxt.shape}")
    p = np.ascontiguousarray(pts, dtype=np.float32).reshape(-1, 2)
    out = np.empty_like(p)
    status = np.empty(len(p), np.uint8)
    library().aug_optical_flow_lk(prev.ctypes.data, nxt.ctypes.data, prev.shape[0], prev.shape[1],
                                  p.ctypes.data, len(p), out.ctypes.data, status.ctypes.data, LK_WIN,
                                  LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG)
    return out.reshape(-1, 1, 2), status.reshape(-1, 1)


# ------------------------------------------------------------------ raster


def _canvas(im: np.ndarray) -> Tuple[int, int, int]:
    if (im.dtype != np.uint8 or not im.flags.c_contiguous or not im.flags.writeable
            or not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] in (1, 3)))):
        raise ValueError(f"expected a writable C-contiguous uint8 [h, w] or [h, w, 3] image, "
                         f"got {im.dtype} {im.shape}")
    return im.shape[0], im.shape[1], 1 if im.ndim == 2 else im.shape[2]


def _colour(color, nch: int) -> np.ndarray:
    """A colour as OpenCV's Scalar: missing channels are 0 (a bare number on
    an RGB image colours its first channel only)."""
    c = np.zeros(4)
    v = np.atleast_1d(np.asarray(color, np.float64))[:4]
    c[:len(v)] = v
    return np.ascontiguousarray(np.clip(np.rint(c), 0, 255).astype(np.uint8))


def _xy(pts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), np.int64)


def polylines(im: np.ndarray, polygons: Sequence, closed: bool, color, thickness: int = 1,
              line_type: int = LINE_8) -> np.ndarray:
    """``cv2.polylines(im, polygons, closed, color, thickness, line_type)`` in
    place: each polygon ``[k, 2]`` of integer (x, y) points."""
    h, w, nch = _canvas(im)
    if not 1 <= thickness <= 32767:
        raise ValueError(f"thickness {thickness}: expected 1..32767")
    col = _colour(color, nch)
    for poly in polygons:
        xy = _xy(poly)
        draw_library().draw_polyline(im.ctypes.data, h, w, nch, xy.ctypes.data, len(xy), int(bool(closed)),
                                     col.ctypes.data, int(thickness), int(line_type), 0)
    return im


def line(im: np.ndarray, p1, p2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """``cv2.line(im, p1, p2, color, thickness, line_type)`` in place."""
    return polylines(im, [np.array([p1, p2])], False, color, thickness, line_type)


def fill_convex_poly(im: np.ndarray, pts, color, line_type: int = LINE_8, shift: int = 0) -> np.ndarray:
    """``cv2.fillConvexPoly(im, pts, color, line_type, shift)`` in place."""
    h, w, nch = _canvas(im)
    xy, col = _xy(pts), _colour(color, nch)
    draw_library().draw_fill_convex(im.ctypes.data, h, w, nch, xy.ctypes.data, len(xy), col.ctypes.data,
                                    int(line_type), int(shift))
    return im


def rectangle(im: np.ndarray, p1, p2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """``cv2.rectangle(im, p1, p2, color, thickness, line_type)`` in place;
    ``thickness < 0`` fills."""
    (x1, y1), (x2, y2) = (int(v) for v in p1[:2]), (int(v) for v in p2[:2])
    quad = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])
    if thickness >= 0:
        return polylines(im, [quad], True, color, max(int(thickness), 1) if thickness else 1, line_type)
    return fill_convex_poly(im, quad, color, line_type)


def circle(im: np.ndarray, center, radius: int, color, thickness: int = 1,
           line_type: int = LINE_8) -> np.ndarray:
    """``cv2.circle(im, center, radius, color, thickness, line_type)`` in
    place; ``thickness < 0`` fills."""
    h, w, nch = _canvas(im)
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    col = _colour(color, nch)
    draw_library().draw_circle(im.ctypes.data, h, w, nch, int(center[0]), int(center[1]), int(radius),
                               col.ctypes.data, int(thickness), int(line_type))
    return im


def box_points(center, size, angle: float) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: the four corners of a
    rotated rectangle (angle in degrees), float32 ``[4, 2]``, in OpenCV's
    order and with its float32 rounding."""
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    return np.array([(cx - a * h - b * w, cy + b * h - a * w), (cx + a * h - b * w, cy - b * h - a * w),
                     (cx + a * h + b * w, cy - b * h + a * w), (cx - a * h + b * w, cy + b * h + a * w)],
                    np.float32)


def resize_nearest(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=INTER_NEAREST)``, ``dsize`` =
    (width, height): source index ``floor(i / (d / s))`` in double."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = im.shape[:2]
    ifx, ify = 1.0 / (dw / sw), 1.0 / (dh / sh)
    xs = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), sh - 1)
    return np.ascontiguousarray(im[ys[:, None], xs[None, :]])
