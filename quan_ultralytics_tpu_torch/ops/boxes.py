"""Box math: anchors, DFL decode, rotated boxes, IoU / CIoU, probiou and
fixed-shape NMS (counterpart of the JAX ``ops/boxes.py``).

Rotated NMS is the reference's one-shot "fast-NMS": an all-pairs
upper-triangular suppression over a fixed candidate pool, batched over
images; axis-aligned NMS iterates that map to the greedy fixed point. Sorts
are stable, so ties keep index order as ``jnp.argsort`` and ``lax.top_k`` do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Anchors and distance decoding (reference utils/tal.py:333-386)
# ---------------------------------------------------------------------------

def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 grid_cell_offset: float = 0.5,
                 device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centers (feature-grid units) ``[A, 2]`` (x, y) and per-anchor strides ``[A, 1]``."""
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(stride_list)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances -> xywh or xyxy boxes."""
    lt, rb = distance[..., :2], distance[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) clipped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:]
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return torch.clamp(d, 0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor,
              anchor_points: torch.Tensor) -> torch.Tensor:
    """Rotated decode (reference tal.py:366-386): rotate the ltrb offset by the
    predicted angle before shifting the anchor. Returns xywh."""
    lt, rb = pred_dist[..., :2], pred_dist[..., 2:]
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    half = (rb - lt) / 2
    xf, yf = half[..., 0:1], half[..., 1:2]
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], dim=-1) + anchor_points, lt + rb], dim=-1)


# ---------------------------------------------------------------------------
# Format conversions (reference utils/ops.py:412-607)
# ---------------------------------------------------------------------------

def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2, x[..., 4:]], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    x1y1, x2y2 = x[..., :2], x[..., 2:4]
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1, x[..., 4:]], dim=-1)


def xywhr2xyxyxyxy(x: torch.Tensor) -> torch.Tensor:
    """xywhr -> 4 corner points ``[..., 4, 2]`` (reference ops.py:572)."""
    ctr, w, h, angle = x[..., :2], x[..., 2:3], x[..., 3:4], x[..., 4:5]
    cos, sin = torch.cos(angle), torch.sin(angle)
    vec1 = torch.cat([w / 2 * cos, w / 2 * sin], dim=-1)
    vec2 = torch.cat([-h / 2 * sin, h / 2 * cos], dim=-1)
    pt1 = ctr + vec1 + vec2
    pt2 = ctr + vec1 - vec2
    pt3 = ctr - vec1 - vec2
    pt4 = ctr - vec1 + vec2
    return torch.stack([pt1, pt2, pt3, pt4], dim=-2)


def regularize_rboxes(rboxes: torch.Tensor) -> torch.Tensor:
    """Canonicalize xywhr so w >= h and angle in [0, pi/2) (reference ops.py:791)."""
    x, y, w, h, t = rboxes.unbind(-1)
    swap = w < h
    w_ = torch.where(swap, h, w)
    h_ = torch.where(swap, w, h)
    t_ = torch.remainder(torch.where(swap, t + math.pi / 2, t), math.pi)
    return torch.stack([x, y, w_, h_, t_], dim=-1)


def _stack(like, parts):
    return torch.stack(parts, dim=-1) if isinstance(like, torch.Tensor) else np.stack(parts, axis=-1)


def scale_boxes(boxes, ratio_pad, ori_shape=None):
    """Letterboxed-pixel xyxy boxes ``[..., 4]`` -> source-image pixels
    (reference utils/ops.py:92), clipped to ``ori_shape`` ``(h0, w0)`` when
    given. ``ratio_pad`` is ``(r, dw, dh)`` of the letterbox. numpy arrays or
    torch tensors."""
    r, dw, dh = ratio_pad[0], ratio_pad[1], ratio_pad[2]
    x1, y1 = (boxes[..., 0] - dw) / r, (boxes[..., 1] - dh) / r
    x2, y2 = (boxes[..., 2] - dw) / r, (boxes[..., 3] - dh) / r
    if ori_shape is not None:
        h0, w0 = ori_shape[0], ori_shape[1]
        x1, x2 = x1.clip(0, w0), x2.clip(0, w0)
        y1, y2 = y1.clip(0, h0), y2.clip(0, h0)
    return _stack(boxes, [x1, y1, x2, y2])


def scale_rboxes(rboxes, ratio_pad):
    """Letterboxed-pixel xywhr boxes ``[..., 5]`` -> source-image pixels: the
    centre shifted and scaled, the sides scaled, the angle kept (reference
    obb/val.py pred_to_json). numpy arrays or torch tensors."""
    r, dw, dh = ratio_pad[0], ratio_pad[1], ratio_pad[2]
    return _stack(rboxes, [(rboxes[..., 0] - dw) / r, (rboxes[..., 1] - dh) / r,
                           rboxes[..., 2] / r, rboxes[..., 3] / r, rboxes[..., 4]])


# ---------------------------------------------------------------------------
# IoU family (reference utils/metrics.py:80-277)
# ---------------------------------------------------------------------------

def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, ciou: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """IoU or CIoU of broadcast-aligned boxes on the last axis (reference
    metrics.py:80-135), with its asymmetric ``+eps`` on the heights of xyxy boxes."""
    if xywh:
        b1, b2 = xywh2xyxy(box1[..., :4]), xywh2xyxy(box2[..., :4])
        w1, h1 = box1[..., 2], box1[..., 3]
        w2, h2 = box2[..., 2], box2[..., 3]
    else:
        b1, b2 = box1, box2
        w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1] + eps
        w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1] + eps
    inter_w = (torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
    inter_h = (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0)
    inter = inter_w * inter_h
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    if not ciou:
        return iou
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():  # alpha is a constant of the gradient (the reference's no_grad)
        # v == 0 gives alpha == 0 where the denominator rounds to 0 (bf16: 1 + 1e-7
        # is 1, so iou == 1 would give 0/0)
        alpha = torch.where(v > 0, v / (v - iou + (1 + eps)), torch.zeros_like(v))
    return iou - (rho2 / c2 + v * alpha)


# ---------------------------------------------------------------------------
# probiou (reference utils/metrics.py:178-277), f32 path
# ---------------------------------------------------------------------------

def _covariance(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian form of an xywhr box (reference metrics.py:178-196)."""
    a = boxes[..., 2] ** 2 / 12
    b = boxes[..., 3] ** 2 / 12
    c = boxes[..., 4]
    cos, sin = torch.cos(c), torch.sin(c)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU between broadcast-aligned xywhr boxes
    (reference metrics.py:198-249, arXiv:2106.06072)."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    det1 = torch.clamp(a1 * b1 - c1 ** 2, min=0)
    det2 = torch.clamp(a2 * b2 - c2 ** 2, min=0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                   / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / den * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / den * 0.5
    bd = torch.clamp(t1 + t2 + t3, eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


# ---------------------------------------------------------------------------
# Fixed-shape rotated NMS (reference utils/ops.py:146-333)
# ---------------------------------------------------------------------------

def _probiou_pairs_over(b: torch.Tensor, iou_threshold: float, eps: float = 1e-7) -> torch.Tensor:
    """All-pairs ``probiou(b_i, b_j) >= iou_threshold`` for ``b`` ``[..., n, 5]``
    -> ``[..., n, n]``, tested in the Bhattacharyya-distance domain
    (probiou is a decreasing function of it), which spares two
    transcendentals per pair; the per-box sqrt(det) is taken once per box."""
    x, y = b[..., 0], b[..., 1]
    a, bb, c = _covariance(b)
    sd = torch.sqrt(torch.clamp(a * bb - c ** 2, min=0))
    A = a[..., :, None] + a[..., None, :]
    Bb = bb[..., :, None] + bb[..., None, :]
    C = c[..., :, None] + c[..., None, :]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    den = A * Bb - C ** 2 + eps
    t12 = (0.25 * (A * dy ** 2 + Bb * dx ** 2) - 0.5 * C * dx * dy) / den
    t3 = 0.5 * torch.log(den / (4 * sd[..., :, None] * sd[..., None, :] + eps) + eps)
    bd = torch.clamp(t12 + t3, eps, 100.0)
    c_thr = -math.log(1.0 - (1.0 - iou_threshold) ** 2 + eps)
    return bd <= c_thr


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45) -> torch.Tensor:
    """One-shot rotated fast-NMS (reference ops.py:146-179), batched over leading dims.

    boxes ``[..., n, 5]`` xywhr, scores ``[..., n]``. Sorts by score, builds
    the all-pairs threshold matrix and keeps boxes not suppressed by any
    higher-scoring box. Returns a keep mask in the *input* order.
    """
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    over = _probiou_pairs_over(b, iou_threshold)
    n = boxes.shape[-2]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=boxes.device), diagonal=1)
    keep_sorted = ~(over & upper).any(dim=-2)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def nms_axis_aligned(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
                     passes: int = 4) -> torch.Tensor:
    """Fixed-shape NMS of xyxy boxes, iterated to the greedy fixed point (JAX
    ``nms_axis_aligned``, DEVIATIONS.md section 1), batched over leading dims.

    Greedy keep is the fixed point of ``keep_i = not any(j < i: keep_j and
    iou_ij >= thr)`` in score order. Iterating that map from all-true
    ``passes`` times resolves suppression chains up to that depth exactly
    (sequential greedy, as torchvision's ``nms``); each pass is one masked
    ``[n, n]`` reduction. Returns a keep mask in the *input* order.
    """
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    ious = bbox_iou(b[..., :, None, :], b[..., None, :, :], xywh=False)
    n = boxes.shape[-2]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=boxes.device), diagonal=1)
    sup = (ious >= iou_threshold) & upper  # sup[j, i]: the higher-scoring j hits i
    keep_sorted = torch.ones(order.shape, dtype=torch.bool, device=boxes.device)
    for _ in range(passes):
        keep_sorted = ~(sup & keep_sorted[..., :, None]).any(dim=-2)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def non_max_suppression(
    pred: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    nc: int = 80,
    rotated: bool = False,
    max_nms: int = 30000,
    max_wh: float = 7680.0,
    agnostic: bool = False,
    extra_dim: int = 0,
    defer_argmax: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape batched NMS (reference ops.py:181-333, best-class-only path).

    Args:
      pred: ``[B, A, 4 + nc (+ 1) (+ extra_dim)]`` decoded predictions: xywh
        boxes in pixels and class scores (`decode_detect`), then the angle when
        ``rotated`` (`decode_obb`); the last ``extra_dim`` columns (mask
        coefficients or decoded keypoints) ride through unchanged (reference
        ops.py:181 ``nm``).
    Returns:
      detections ``[B, max_det, 6 (+ extra_dim)]`` = (xyxy, conf, cls, extras),
      or ``[B, max_det, 7]`` = (xywhr, conf, cls) when ``rotated``, zero rows
      past the valid count, and the valid mask ``[B, max_det]``.

    The class offset ``cls * max_wh`` (up to 79 x 7680 = 606,720 px) is added
    in f32 whatever the boxes' dtype: bf16's step there is 4,096 px.

    ``defer_argmax`` (JAX's ``QUAN_NMS_DEFER_ARGMAX``): the class id is the
    argmax of the gathered candidate rows instead of a gather of the whole
    tensor's argmax; the same detections.
    """
    B, A, _ = pred.shape
    n_keep = min(max_nms, A, 2048)  # candidate pool per image
    boxes = pred[..., :4]
    cls = pred[..., 4:4 + nc]
    conf = cls.amax(dim=-1)
    score = torch.where(conf > conf_thres, conf, torch.zeros_like(conf))
    score_top, idx = _top_k(score, n_keep)

    def take(t):  # gather candidate rows [B, A, k] -> [B, n_keep, k]
        return torch.gather(t, 1, idx[..., None].expand(B, n_keep, t.shape[-1]))

    boxes_t = take(boxes)
    cls_t = take(cls).argmax(dim=-1) if defer_argmax else torch.gather(cls.argmax(dim=-1), 1, idx)
    valid_t = score_top > conf_thres
    offset = (torch.zeros_like(score_top, dtype=torch.float32) if agnostic
              else cls_t.to(torch.float32) * max_wh)
    if rotated:
        angle = take(pred[..., 4 + nc:5 + nc])
        nms_boxes = torch.cat([boxes_t[..., :2] + offset[..., None], boxes_t[..., 2:4], angle], dim=-1)
        keep = nms_rotated(nms_boxes, score_top, iou_thres)
        out_boxes = torch.cat([boxes_t, angle], dim=-1)
    else:
        out_boxes = xywh2xyxy(boxes_t)
        keep = nms_axis_aligned(out_boxes.float() + offset[..., None], score_top, iou_thres)
    keep = keep & valid_t

    final_score = torch.where(keep, score_top, torch.zeros_like(score_top))
    k = min(max_det, n_keep)
    sc, order = _top_k(final_score, k)
    rows = torch.gather(out_boxes, 1, order[..., None].expand(B, k, out_boxes.shape[-1]))
    cls_o = torch.gather(cls_t, 1, order).to(torch.float32)
    cols = [rows, sc[..., None], cls_o[..., None]]
    if extra_dim:
        extras = take(pred[..., pred.shape[-1] - extra_dim:])
        cols.append(torch.gather(extras, 1, order[..., None].expand(B, k, extra_dim)))
    det = torch.cat(cols, dim=-1)
    ok = sc > conf_thres
    det = torch.where(ok[..., None], det, torch.zeros_like(det))
    if k < max_det:  # pad to the fixed max_det rows
        det = torch.cat([det, det.new_zeros(B, max_det - k, det.shape[-1])], dim=1)
        ok = torch.cat([ok, ok.new_zeros(B, max_det - k)], dim=1)
    return det, ok
