"""Host-side geometry of the data pipeline (counterpart of the JAX package's
``data/augment.py``): the letterbox, and the oriented-box helpers that turn
8-corner labels into xywhr.

The letterbox's resize runs in PyTorch on the frame's device (bilinear,
half-pixel centres, no antialiasing, as OpenCV's ``INTER_LINEAR``) and rounds
back to uint8; the padding is gray 114. `min_area_rect` is OpenCV's
``minAreaRect`` in numpy. The train-time augmentations are not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


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
        t = im.permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
        im = t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    top, left = ((H - nh) // 2, (W - nw) // 2) if center else (0, 0)
    out = torch.full((H, W, 3), 114, dtype=torch.uint8, device=im.device)
    out[top:top + nh, left:left + nw] = im
    return out, r, (left, top)


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
