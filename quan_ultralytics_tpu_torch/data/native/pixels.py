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
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from quan_ultralytics_tpu_torch.utils.native_build import BUILD_DIR, build_cxx

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
LIB_NAME = "libquan_torch_augment.so"
# no -ffast-math, no -march=native and no contraction into fused multiply-adds:
# the float32 warp and colour steps round alike on every machine
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
BORDER = 114

_lib: Optional[ctypes.CDLL] = None
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
