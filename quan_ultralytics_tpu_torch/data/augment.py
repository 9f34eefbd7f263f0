"""Host-side data pipeline geometry and the train augmentations (counterpart of
the JAX package's ``data/augment.py``): the letterbox, the reference
``v8_transforms`` chain (mosaic in ``build.py``, then copy-paste, the random
affine or perspective warp, mixup, the photometric list, HSV and flips), and
the oriented-box helpers that turn 8-corner labels into xywhr.

Labels are point sets (box corners), transformed in numpy line for line as
the JAX package does, so they agree with it to float64 rounding. The pixel
work (warps, colour conversions, filters, CLAHE, polygon masks) is C++ in
``native/augment.cpp`` (`native.pixels`) and gives OpenCV 5.0's pixels. The
random draws are the JAX package's, in its order, from the generator a
sample is given.

The letterbox's resize runs in PyTorch on the frame's device (bilinear,
half-pixel centres, no antialiasing, as OpenCV's ``INTER_LINEAR``) and rounds
back to uint8; the padding is gray 114. `min_area_rect` is OpenCV's
``minAreaRect`` in numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.data.native import pixels


@dataclass
class AugmentHyp:
    """Augmentation gains (the reference's cfg/default.yaml)."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mixup: float = 0.0
    copy_paste: float = 0.0


def resize_linear(im: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of a uint8 ``[h, w, 3]`` frame to ``size = (H, W)``
    (``cv2.resize``'s INTER_LINEAR sampling: half-pixel centres, no
    antialias), rounded back to uint8: within one gray level of OpenCV's
    11-bit fixed-point result."""
    t = im.permute(2, 0, 1)[None].float()
    t = F.interpolate(t, size=size, mode="bilinear", align_corners=False, antialias=False)
    return t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def letterbox(im: torch.Tensor, new_shape: Union[int, Tuple[int, int]], scaleup: bool = True,
              center: bool = True) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize and pad a uint8 ``[h, w, 3]`` frame to ``new_shape`` keeping aspect.

    Returns (uint8 image ``[H, W, 3]``, gain, (pad_w, pad_h)).
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    H, W = new_shape
    h, w = im.shape[:2]
    r = min(H / h, W / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h * r), round(w * r)
    if (nh, nw) != (h, w):
        im = resize_linear(im, (nh, nw))
    top, left = ((H - nh) // 2, (W - nw) // 2) if center else (0, 0)
    out = torch.full((H, W, 3), 114, dtype=torch.uint8, device=im.device)
    out[top:top + nh, left:left + nw] = im
    return out, r, (left, top)


# ---------------------------------------------------------------------------
# Train augmentations (the JAX package's augment.py:70-262)
# ---------------------------------------------------------------------------


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """OpenCV's ``getRotationMatrix2D``: the 2x3 matrix that turns by ``angle``
    degrees (counter-clockwise) and scales by ``scale`` about ``center``."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def random_hsv(im: np.ndarray, hyp: AugmentHyp, rng: np.random.Generator) -> np.ndarray:
    """HSV jitter (reference augment.py:1303 RandomHSV): three gains, one LUT
    each on the 8-bit HSV channels."""
    if hyp.hsv_h == hyp.hsv_s == hyp.hsv_v == 0:
        return im
    r = rng.uniform(-1, 1, 3) * [hyp.hsv_h, hyp.hsv_s, hyp.hsv_v] + 1
    hsv = pixels.rgb_to_hsv(im)
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(im.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(im.dtype)
    hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
    return pixels.hsv_to_rgb(hsv)


def _affine_matrix(imgsz: int, hyp: AugmentHyp, rng: np.random.Generator,
                   border: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Compose the perspective/rotation/shear/translate matrix (reference
    augment.py:1040-1090 RandomPerspective.affine_transform); returns it and the
    scale drawn."""
    C = np.eye(3)
    C[0, 2] = -imgsz / 2
    C[1, 2] = -imgsz / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-hyp.perspective, hyp.perspective)
    P[2, 1] = rng.uniform(-hyp.perspective, hyp.perspective)
    R = np.eye(3)
    a = rng.uniform(-hyp.degrees, hyp.degrees)
    s = rng.uniform(1 - hyp.scale, 1 + hyp.scale)
    R[:2] = get_rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-hyp.shear, hyp.shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-hyp.shear, hyp.shear) * math.pi / 180)
    T = np.eye(3)
    out_w = imgsz + border[1] * 2
    out_h = imgsz + border[0] * 2
    T[0, 2] = rng.uniform(0.5 - hyp.translate, 0.5 + hyp.translate) * out_w
    T[1, 2] = rng.uniform(0.5 - hyp.translate, 0.5 + hyp.translate) * out_h
    return T @ S @ R @ P @ C, s


def random_perspective(im: np.ndarray, corners: np.ndarray, cls: np.ndarray, hyp: AugmentHyp,
                       rng: np.random.Generator, border: Tuple[int, int] = (0, 0)):
    """Affine (or perspective) warp of the image and its ``[n, P, 2]`` pixel
    point labels; the boxes that survive are filtered as the reference's
    box_candidates (augment.py:1214-1230): hull width and height over 2 px,
    area ratio over 0.1, aspect under 100, centre inside. Returns (im, corners,
    cls)."""
    imgsz = im.shape[0]
    out_w, out_h = imgsz + border[1] * 2, imgsz + border[0] * 2
    M, s = _affine_matrix(imgsz, hyp, rng, border)
    if hyp.perspective:
        im = pixels.warp_perspective(im, M, (out_w, out_h))
    else:
        im = pixels.warp_affine(im, M[:2], (out_w, out_h))
    n = corners.shape[0]
    if n:
        P = corners.shape[1]
        pts = np.concatenate([corners.reshape(-1, 2), np.ones((n * P, 1))], axis=1) @ M.T
        pts = pts[:, :2] / pts[:, 2:3] if hyp.perspective else pts[:, :2]
        new_corners = pts.reshape(n, P, 2)
        w1, h1 = np.moveaxis(corners.max(axis=1) - corners.min(axis=1), -1, 0)
        w2, h2 = np.moveaxis(new_corners.max(axis=1) - new_corners.min(axis=1), -1, 0)
        eps = 1e-9
        ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
        keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * s * s + eps) > 0.1) & (ar < 100)
        c = new_corners.mean(axis=1)
        keep &= (c[:, 0] >= 0) & (c[:, 0] < out_w) & (c[:, 1] >= 0) & (c[:, 1] < out_h)
        corners, cls = new_corners[keep], cls[keep]
    return im, corners, cls


def flip_corners(im: np.ndarray, corners: np.ndarray, hyp: AugmentHyp, rng: np.random.Generator):
    """Up-down, then left-right flips of the image and its point labels."""
    h, w = im.shape[:2]
    if rng.random() < hyp.flipud:
        im = np.flipud(im)
        if corners.size:
            corners = corners.copy()
            corners[..., 1] = h - corners[..., 1]
    if rng.random() < hyp.fliplr:
        im = np.fliplr(im)
        if corners.size:
            corners = corners.copy()
            corners[..., 0] = w - corners[..., 0]
    return np.ascontiguousarray(im), corners


def mixup(im1, c1, cls1, im2, c2, cls2, rng: np.random.Generator):
    """MixUp (reference augment.py:867): a beta(32, 32) blend of the images in
    float32, truncated back to uint8, and the union of the labels."""
    r = rng.beta(32.0, 32.0)
    im = (im1.astype(np.float32) * r + im2.astype(np.float32) * (1 - r)).astype(im1.dtype)
    corners = np.concatenate([c1, c2]) if (c1.size or c2.size) else c1
    return im, corners, np.concatenate([cls1, cls2])


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area, ``[N, M]``, of xyxy pixel boxes
    (reference utils/metrics.py bbox_ioa)."""
    ix1 = np.maximum(box1[:, None, 0], box2[None, :, 0])
    iy1 = np.maximum(box1[:, None, 1], box2[None, :, 1])
    ix2 = np.minimum(box1[:, None, 2], box2[None, :, 2])
    iy2 = np.minimum(box1[:, None, 3], box2[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None] + eps)


def _hulls(corners: np.ndarray) -> np.ndarray:
    """Unclipped axis-aligned hull xyxy ``[n, 4]`` of point sets ``[n, P, 2]``."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)


def copy_paste(im, corners, cls, rng: np.random.Generator, p: float = 0.5):
    """Polygon CopyPaste, the reference's 'flip' mode (augment.py:1634-1733):
    the candidates are the horizontally flipped instances whose hull's IoA with
    every instance is under 0.30; the ``round(p * n)`` least occluding of them
    are pasted, copying the flipped image's pixels inside their polygons, and
    their flipped labels are appended.

    The flipped image's column x is the image's column ``w - 1 - x``, so the
    mask is filled from the polygons at ``w - 1 - x``; the labels keep
    ``w - x``, the flipped coordinate of a point (the JAX package fills the
    mask from ``w - x``, one column to the right of the pixels it copies).
    """
    n = corners.shape[0]
    if n == 0 or p == 0:
        return im, corners, cls
    h, w = im.shape[:2]
    flipped = corners.copy()
    flipped[..., 0] = w - flipped[..., 0]
    ioa = bbox_ioa(_hulls(flipped), _hulls(corners))  # [n, n]
    cand = np.nonzero((ioa < 0.30).all(axis=1))[0]
    if cand.size == 0:
        return im, corners, cls
    cand = cand[np.argsort(ioa.max(axis=1)[cand])]  # least occluding first
    sel = cand[: round(p * cand.size)]
    if sel.size == 0:
        return im, corners, cls
    mask = np.zeros((h, w), np.uint8)
    pixels.fill_polygons(mask, [(flipped[j] - [1, 0]).astype(np.int32) for j in sel])
    out = im.copy()
    np.copyto(out, im[:, ::-1], where=mask[..., None].astype(bool))
    return out, np.concatenate([corners, flipped[sel]]), np.concatenate([cls, cls[sel]])


def photometric_augment(im: np.ndarray, rng: np.random.Generator, p: float = 1.0) -> np.ndarray:
    """The reference's default Albumentations list (augment.py:1735,
    1847-1850): Blur, MedianBlur, ToGray and CLAHE, each at p = 0.01, pixels
    only. The blurs draw an odd kernel from {3, 5, 7}; CLAHE draws its clip
    limit from U(1, 4) and runs on the Lab L channel with an 8 x 8 grid."""
    if p <= 0 or rng.random() >= p:
        return im
    if rng.random() < 0.01:
        im = pixels.blur(im, 2 * int(rng.integers(1, 4)) + 1)
    if rng.random() < 0.01:
        im = pixels.median_blur(im, 2 * int(rng.integers(1, 4)) + 1)
    if rng.random() < 0.01:
        im = np.repeat(pixels.rgb_to_gray(im)[..., None], 3, axis=2)
    if rng.random() < 0.01:
        lab = pixels.rgb_to_lab(im)
        lab[..., 0] = pixels.clahe(np.ascontiguousarray(lab[..., 0]), float(rng.uniform(1.0, 4.0)))
        im = pixels.lab_to_rgb(lab)
    return im


# ---------------------------------------------------------------------------
# Oriented-box geometry on the host (the JAX package's augment.py:265-292 and
# dataset.py:34, which call cv2.minAreaRect)
# ---------------------------------------------------------------------------

_F32 = np.float32


def _sklansky(pts: List[Tuple[float, float]], start: int, end: int, stack: List[int],
              nsign: int, sign2: int) -> int:
    """One chain of OpenCV's Sklansky scan (convhull.cpp ``Sklansky_``) over
    points sorted by (x, y); fills ``stack`` and returns its length."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[start] == pts[end]:
        stack[0] = start
        return 1
    stack[0:3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = nexty - cury
        if (by > 0) - (by < 0) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            conv = ay * bx - ax * by  # float64, as OpenCV's _DotTp for float points
            if (conv > 0) - (conv < 0) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return size - 1


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """OpenCV's ``convexHull(points, clockwise=false, returnPoints=true)`` of
    float points, in its order: the calipers' start and ties depend on it."""
    total = len(points)
    order = sorted(range(total), key=lambda i: (points[i, 0], points[i, 1]))
    pts = [(float(points[i, 0]), float(points[i, 1])) for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if pts[miny][1] > pts[i][1]:
            miny = i
        if pts[maxy][1] < pts[i][1]:
            maxy = i
    hull: List[int] = []
    if pts[0] == pts[-1]:
        hull.append(order[0])
    else:
        st_a, st_b = [0] * (total + 2), [0] * (total + 2)
        tl = _sklansky(pts, 0, maxy, st_a, -1, 1)
        tr = _sklansky(pts, total - 1, maxy, st_b, -1, -1)
        tl_s, tl_n, tr_s, tr_n = st_b, tr, st_a, tl  # counter-clockwise: the upper chains swap
        hull += [order[tl_s[i]] for i in range(tl_n - 1)]
        hull += [order[tr_s[i]] for i in range(tr_n - 1, 0, -1)]
        stop = tr_s[1] if tr_n > 2 else (tl_s[tl_n - 2] if tl_n > 2 else -1)
        st_c, st_d = [0] * (total + 2), [0] * (total + 2)
        bl = _sklansky(pts, 0, miny, st_c, 1, -1)
        br = _sklansky(pts, total - 1, miny, st_d, 1, 1)
        if stop >= 0:
            check = st_c[1] if bl > 2 else (st_d[2 - bl] if bl + br > 2 else -1)
            if check == stop or (check >= 0 and pts[check] == pts[stop]):
                bl, br = min(bl, 2), min(br, 2)  # collinear: the lower chain mirrors the upper
        hull += [order[st_c[i]] for i in range(bl - 1)]
        hull += [order[st_d[i]] for i in range(br - 1, 0, -1)]
        n = len(hull)
        if n >= 3:  # OpenCV's cyclic shift toward an ascending or descending index sequence
            mn = mx = lt = 0
            for i in range(1, n):
                idx = hull[i]
                lt += hull[i - 1] < idx
                if 1 < lt <= i - 2:
                    break
                if idx < hull[mn]:
                    mn = i
                if idx > hull[mx]:
                    mx = i
            mm = abs(mx - mn)
            if (mm == 1 or mm == n - 1) and (lt <= 1 or lt >= n - 2):
                asc = (mx + 1) % n == mn
                i0 = j = mn if asc else mx
                if i0 > 0:
                    shifted = []
                    for i in range(n):
                        cur = hull[j]
                        shifted.append(cur)
                        nj = j + 1 if j + 1 < n else 0
                        if i < n - 1 and asc != (cur < hull[nj]):
                            break
                        j = nj
                    if len(shifted) == n:
                        hull = shifted
    return points[hull]


def _rotating_calipers(p: np.ndarray):
    """OpenCV's ``rotatingCalipers(..., CALIPERS_MINAREARECT)`` (rotcalipers.cpp),
    in float32 as it computes: corner, width vector, height vector. The caliper
    that turns next is the one whose edge, turned into the first caliper's
    frame, makes the smallest angle with it (a cross-product test)."""
    n = len(p)
    P = [(_F32(x), _F32(y)) for x, y in p]
    vect, inv = [], []
    left = bottom = right = top = 0
    left_x = right_x = P[0][0]
    top_y = bottom_y = P[0][1]
    pt0 = P[0]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = P[i + 1 if i + 1 < n else 0]
        dx, dy = pt[0] - pt0[0], pt[1] - pt0[1]
        vect.append((dx, dy))
        inv.append(_F32(1.0 / math.sqrt(float(dx) ** 2 + float(dy) ** 2)))
        pt0 = pt
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for i in range(n):  # the hull must turn somewhere
        bx, by = float(vect[i][0]), float(vect[i][1])
        if ax * by - ay * bx != 0:
            break
        ax, ay = bx, by
    else:
        raise ValueError("min_area_rect: degenerate hull")
    seq = [bottom, right, top, left]
    minarea = _F32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[s] for s in seq]
        rot = [v[0], (v[1][1], -v[1][0]), (-v[2][0], -v[2][1]), (-v[3][1], v[3][0])]
        main = 0
        for i in range(1, 4):
            if rot[main][0] * rot[i][1] - rot[i][0] * rot[main][1] < 0:
                main = i
        pi = seq[main]
        lead_x, lead_y = vect[pi][0] * inv[pi], vect[pi][1] * inv[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y),
                          (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = P[seq[1]][0] - P[seq[3]][0], P[seq[1]][1] - P[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx, dy = P[seq[2]][0] - P[seq[0]][0], P[seq[2]][1] - P[seq[0]][1]
        height = dy * base_a - dx * base_b
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * P[i_left][0] + P[i_left][1] * b1
    c2 = a2 * P[i_bottom][0] + P[i_bottom][1] * b2
    idet = _F32(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``((cx, cy), (w, h), angle in degrees)`` of the least-area rectangle
    around ``points`` ``[n, 2]``: OpenCV's ``minAreaRect``, its convex hull, its
    rotating calipers in float32 and its convention for which side is the
    width and for the angle (``((2, 1), (2, 4), -90)`` for the 4x2 box at the
    origin)."""
    hull = _convex_hull(np.asarray(points, np.float32).reshape(-1, 2))
    n = len(hull)
    if n > 2:
        o, v1, v2 = _rotating_calipers(hull)
        cx = o[0] + (v1[0] + v2[0]) * _F32(0.5)
        cy = o[1] + (v1[1] + v2[1]) * _F32(0.5)
        w = _F32(math.sqrt(float(v1[0]) ** 2 + float(v1[1]) ** 2))
        h = _F32(math.sqrt(float(v2[0]) ** 2 + float(v2[1]) ** 2))
        angle = math.atan2(float(v1[1]), float(v1[0]))
    elif n == 2:
        (x0, y0), (x1, y1) = hull
        cx, cy = (x0 + x1) * _F32(0.5), (y0 + y1) * _F32(0.5)
        dx, dy = float(x1) - float(x0), float(y1) - float(y0)
        w, h = _F32(math.sqrt(dx * dx + dy * dy)), _F32(0)
        angle = math.atan2(dy, dx)
    else:
        cx, cy = hull[0] if n else (_F32(0), _F32(0))
        w = h = _F32(0)
        angle = 0.0
    # degrees rounded once to float32, then OpenCV 5's range [-90, 0), each
    # quarter turn swapping the sides
    angle = _F32(math.degrees(angle))
    while angle >= 0:
        angle, w, h = angle - _F32(90), h, w
    while angle < -90:
        angle, w, h = angle + _F32(90), h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(angle)


def corners_to_xywhr(corners: np.ndarray) -> np.ndarray:
    """Pixel-space ``[n, 4, 2]`` corners -> ``[n, 5]`` xywhr (radians) via
    `min_area_rect` (the reference's ops.py:549 xyxyxyxy2xywhr)."""
    out = np.zeros((corners.shape[0], 5), np.float32)
    for i, c in enumerate(np.asarray(corners, np.float32)):
        (cx, cy), (bw, bh), angle = min_area_rect(c)
        out[i] = [cx, cy, bw, bh, angle / 180 * math.pi]
    return out


def xywh_to_corners(xywh: np.ndarray) -> np.ndarray:
    """Axis-aligned xywh ``[n, 4]`` (normalized or pixels) -> ``[n, 4, 2]`` corners."""
    x, y, w, h = xywh[:, 0], xywh[:, 1], xywh[:, 2], xywh[:, 3]
    x1, y1, x2, y2 = x - w / 2, y - h / 2, x + w / 2, y + h / 2
    return np.stack([np.stack([x1, y1], -1), np.stack([x2, y1], -1),
                     np.stack([x2, y2], -1), np.stack([x1, y2], -1)], axis=1)


def corners_to_xyxy(corners: np.ndarray, w: int, h: int) -> np.ndarray:
    """``[n, k, 2]`` points -> their clipped axis-aligned hull, xyxy ``[n, 4]``."""
    mn, mx = corners.min(axis=1), corners.max(axis=1)
    return np.stack([np.clip(mn[:, 0], 0, w), np.clip(mn[:, 1], 0, h),
                     np.clip(mx[:, 0], 0, w), np.clip(mx[:, 1], 0, h)], axis=1)
