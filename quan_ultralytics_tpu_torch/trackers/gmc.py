"""Global motion compensation for BoT-SORT without OpenCV (counterpart of the
OpenCV calls in the JAX package's ``trackers/bot_sort.py`` ``GMC.apply``;
reference ultralytics/trackers/utils/gmc.py, sparse optical flow).

The card's machine has no cv2, so each step is the port's own, on the host,
after OpenCV 5.0's definitions:

* the gray conversion: ``cv2.cvtColor(COLOR_RGB2GRAY)``
  (`data.native.pixels.rgb_to_gray`, C++);
* `downscale`: ``cv2.resize`` to ``(w // f, h // f)`` with INTER_LINEAR,
  which OpenCV runs as an area average when the factor divides both sides
  (the case of even frame sides at the default factor 2); otherwise a
  bilinear resize within one gray level of OpenCV's;
* `good_features_to_track`: Shi-Tomasi corners (``cornerMinEigenVal`` of
  Sobel derivatives over a box block, threshold at ``QUALITY`` of the
  maximum, 3 x 3 local maxima, strongest first, ``MIN_DISTANCE`` apart);
* pyramidal Lucas-Kanade: ``cv2.calcOpticalFlowPyrLK``
  (`data.native.pixels.optical_flow_pyr_lk`, C++ in ``augment.cpp``:
  ``pyrDown`` pyramids, Scharr derivatives, bilinear windows in 14-bit fixed
  point, 30 iterations or a step below 0.01 px);
* `estimate_affine_partial_2d`: a 4-DOF (rotation, uniform scale,
  translation) RANSAC over 2-point samples drawn from an explicit
  ``np.random.Generator``, refined by least squares on the inliers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quan_ultralytics_tpu_torch.data.native import pixels

# cv2.goodFeaturesToTrack's arguments in the reference GMC: at most 200 corners, at
# least 0.01 of the strongest's response, 8 px apart, a 3 x 3 block
MAX_CORNERS, QUALITY, MIN_DISTANCE, BLOCK = 200, 0.01, 8, 3
# cv2.estimateAffinePartial2D's RANSAC defaults: 3 px, 2000 samples at most, 0.99 confidence
RANSAC_THRESH, RANSAC_MAX_ITERS, RANSAC_CONFIDENCE = 3.0, 2000, 0.99
RANSAC_CHUNK = 64  # RANSAC samples drawn and scored at a time


def downscale(gray: np.ndarray, factor: int) -> np.ndarray:
    """uint8 ``[h, w]`` -> ``[h // factor, w // factor]``, as ``cv2.resize`` with
    INTER_LINEAR: a rounded area average where the factor divides both sides,
    else bilinear with half-pixel centres, rounded."""
    h, w = gray.shape
    oh, ow = h // factor, w // factor
    if oh * factor == h and ow * factor == w:
        s = gray.astype(np.int32).reshape(oh, factor, ow, factor).sum(axis=(1, 3))
        n = factor * factor
        return ((s + n // 2) // n).astype(np.uint8)

    def axis(n_in: int, n_out: int):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.clip(np.floor(f).astype(np.int64), 0, n_in - 1)
        t = np.clip(f - i0, 0.0, 1.0)
        return i0, np.minimum(i0 + 1, n_in - 1), t

    y0, y1, ty = axis(h, oh)
    x0, x1, tx = axis(w, ow)
    g = gray.astype(np.float64)
    rows = g[y0] * (1 - ty)[:, None] + g[y1] * ty[:, None]
    out = rows[:, x0] * (1 - tx) + rows[:, x1] * tx
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _reflect(a: np.ndarray, p: int) -> np.ndarray:
    """Pad by ``p`` with OpenCV's BORDER_REFLECT_101 (numpy's 'reflect')."""
    return np.pad(a, p, mode="reflect")


def _min_eigen(gray: np.ndarray, block: int) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, block, ksize=3)`` in float32."""
    g = _reflect(gray.astype(np.float64), 1)
    h, w = gray.shape
    scale = 1.0 / (4 * block * 255.0)

    def at(dy, dx):
        return g[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = ((at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))) * scale
    dy = ((at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))) * scale
    dx, dy = dx.astype(np.float32), dy.astype(np.float32)
    r = block // 2

    def box(a):
        p = _reflect(a.astype(np.float64), r)
        s = np.zeros((h, w))
        for i in range(block):
            for j in range(block):
                s += p[i:i + h, j:j + w]
        return s.astype(np.float32)

    a = box(dx * dx) * np.float32(0.5)
    b = box(dx * dy)
    c = box(dy * dy) * np.float32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features_to_track(gray: np.ndarray) -> Optional[np.ndarray]:
    """Shi-Tomasi corners of uint8 ``gray``: ``[n, 1, 2]`` float32 (x, y), the
    strongest first, or None where there is none
    (``cv2.goodFeaturesToTrack(gray, MAX_CORNERS, QUALITY, MIN_DISTANCE, blockSize=BLOCK)``)."""
    eig = _min_eigen(gray, BLOCK)
    h, w = eig.shape
    thresh = np.float32(float(eig.max()) * QUALITY)
    eig = np.where(eig > thresh, eig, np.float32(0))
    pad = np.pad(eig, 1, mode="constant", constant_values=-np.inf)
    dil = np.max(np.stack([pad[i:i + h, j:j + w] for i in range(3) for j in range(3)]), axis=0)
    keep = (eig != 0) & (eig == dil)
    keep[0, :] = keep[-1, :] = keep[:, 0] = keep[:, -1] = False
    ys, xs = np.nonzero(keep)
    vals = eig[ys, xs]
    # strongest first; among equals the later pixel first (OpenCV's greaterThanPtr)
    order = np.lexsort((-(ys * w + xs), -vals))
    cell = MIN_DISTANCE
    gw = (w + cell - 1) // cell
    grid = {}
    md2 = MIN_DISTANCE * MIN_DISTANCE
    corners = []
    for k in order:
        x, y = int(xs[k]), int(ys[k])
        cx, cy = x // cell, y // cell
        good = True
        for yy in range(max(cy - 1, 0), cy + 2):
            for xx in range(max(cx - 1, 0), min(cx + 1, gw - 1) + 1):
                for px, py in grid.get((yy, xx), ()):
                    if (x - px) ** 2 + (y - py) ** 2 < md2:
                        good = False
                        break
                if not good:
                    break
            if not good:
                break
        if good:
            grid.setdefault((cy, cx), []).append((x, y))
            corners.append((x, y))
            if len(corners) == MAX_CORNERS:
                break
    if not corners:
        return None
    return np.array(corners, np.float32).reshape(-1, 1, 2)


def _similarity_from_pairs(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """4-DOF models ``[k, 2, 3]`` through the point pairs ``src[k, 2, 2]`` ->
    ``dst[k, 2, 2]`` (OpenCV's AffinePartial2DEstimatorCallback::runKernel)."""
    x1, y1, x2, y2 = src[:, 0, 0], src[:, 0, 1], src[:, 1, 0], src[:, 1, 1]
    X1, Y1, X2, Y2 = dst[:, 0, 0], dst[:, 0, 1], dst[:, 1, 0], dst[:, 1, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1.0 / ((x1 - x2) ** 2 + (y1 - y2) ** 2)
        s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
        s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
        s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
                  - (X1 * x2 - X2 * x1) * (x1 - x2))
        s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2)
                  - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.stack([np.stack([s0, -s1, s2], 1), np.stack([s1, s0, s3], 1)], 1)


def _update_iters(conf: float, outlier: float, model_points: int, max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters."""
    tiny = np.finfo(np.float64).tiny
    num = max(1.0 - conf, tiny)
    denom = 1.0 - (1.0 - min(max(outlier, 0.0), 1.0)) ** model_points
    if denom < tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else int(round(num / denom))


def estimate_affine_partial_2d(src: np.ndarray, dst: np.ndarray,
                               rng: np.random.Generator) -> Optional[np.ndarray]:
    """RANSAC fit of ``dst ~ [[a, -b, tx], [b, a, ty]] src`` (float64 ``[2, 3]``) over
    the point pairs ``[n, 1, 2]``; None for fewer than 2 pairs or no model
    (``cv2.estimateAffinePartial2D`` with RANSAC, its threshold, iterations and
    confidence; its samples are drawn from ``rng``). The best sample's
    inliers (squared error at most ``RANSAC_THRESH^2``) are refit by least
    squares, where OpenCV runs Levenberg-Marquardt on the same linear
    problem."""
    s = src.reshape(-1, 2).astype(np.float64)
    d = dst.reshape(-1, 2).astype(np.float64)
    n = len(s)
    if n < 2:
        return None
    max_iters, thresh = RANSAC_MAX_ITERS, RANSAC_THRESH
    best, best_count, niters, it = -1, 1, max_iters, 0
    best_inl = None
    while it < niters:  # samples in chunks; the adaptive count is checked sample by sample
        k = min(RANSAC_CHUNK, max_iters - it)
        i = rng.integers(0, n, k)
        j = (i + rng.integers(1, n, k)) % n  # two distinct points a sample
        models = _similarity_from_pairs(np.stack([s[i], s[j]], 1), np.stack([d[i], d[j]], 1))
        proj = np.matmul(models[:, None, :, :2], s[None, :, :, None])[..., 0] + models[:, None, :, 2]
        with np.errstate(invalid="ignore"):
            inl = ((proj - d[None]) ** 2).sum(-1) <= thresh * thresh
        counts = inl.sum(1)
        for c in range(k):
            if it >= niters:
                break
            if counts[c] > best_count:
                best, best_count, best_inl = it, int(counts[c]), inl[c]
                niters = _update_iters(RANSAC_CONFIDENCE, (n - best_count) / n, 2, niters)
            it += 1
    if best < 0:
        return None
    m = best_inl
    sx, sy = s[m, 0], s[m, 1]
    A = np.zeros((2 * m.sum(), 4))
    A[0::2] = np.stack([sx, -sy, np.ones_like(sx), np.zeros_like(sx)], 1)
    A[1::2] = np.stack([sy, sx, np.zeros_like(sx), np.ones_like(sx)], 1)
    a, b, tx, ty = np.linalg.lstsq(A, d[m].reshape(-1), rcond=None)[0]
    return np.array([[a, -b, tx], [b, a, ty]])


class GMC:
    """Sparse-flow global motion compensation (reference utils/gmc.py; the JAX
    package's ``GMC`` with OpenCV's calls replaced by the port's).

    ``apply(frame)`` returns the ``[2, 3]`` float32 affine that maps the last
    frame's coordinates to this one's (identity on the first frame, and on a
    frame whose size differs from the last one's). ``rng`` draws the RANSAC
    samples.
    """

    def __init__(self, downscale: int = 2, rng: Optional[np.random.Generator] = None):
        self.downscale = max(1, downscale)
        self.prev_gray: Optional[np.ndarray] = None
        self.rng = np.random.default_rng(0) if rng is None else rng

    def apply(self, frame: np.ndarray) -> np.ndarray:
        gray = pixels.rgb_to_gray(np.asarray(frame))
        if self.downscale > 1:
            gray = downscale(gray, self.downscale)
        H = np.eye(2, 3, dtype=np.float32)
        if self.prev_gray is not None and self.prev_gray.shape == gray.shape:
            pts = good_features_to_track(self.prev_gray)
            if pts is not None and len(pts) >= 6:
                nxt, status = pixels.optical_flow_pyr_lk(self.prev_gray, gray, pts)
                good = status.reshape(-1).astype(bool)
                if good.sum() >= 6:
                    M = estimate_affine_partial_2d(pts[good], nxt[good], self.rng)
                    if M is not None:
                        H = M.astype(np.float32)
                        H[:, 2] *= self.downscale
        self.prev_gray = gray
        return H
