"""Detection metrics: AP / mAP for axis-aligned and oriented boxes, with mask
IoU and keypoint OKS as the similarity of the segment and pose tasks
(counterpart of the JAX package's ``utils/metrics.py``, its numeric part).

Host-side NumPy re-implementation of the reference metric pipeline
(ultralytics/utils/metrics.py: ap_per_class :537, DetMetrics :798,
OBBMetrics :1226). Matching logic follows the reference: per-image IoU
matching at 10 thresholds (0.5:0.95), greedy de-duplication by IoU order,
101-point interpolated AP. Rotated IoU uses probiou like the reference's
OBBValidator (models/yolo/obb/val.py:40). The plots (the four validation
curves and the confusion matrices) are drawn by the port's raster
(`utils.plotting.Chart`) from the arrays the JAX package hands matplotlib, at
its file names and pixel sizes. Two labels differ from the JAX package's on
purpose: a dict of names labels the confusion matrix by its values (JAX: its
keys), and a list of names labels the curves by name (JAX: a function object).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

# numpy 2 renamed trapz; the card's machine may have either
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _probiou_np(obb1: np.ndarray, obb2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs probiou [N,5] x [M,5] -> [N,M] (numpy mirror of
    ops/boxes.py batch_probiou)."""
    def cov(b):
        a = b[:, 2] ** 2 / 12
        bb = b[:, 3] ** 2 / 12
        c = b[:, 4]
        cos, sin = np.cos(c), np.sin(c)
        return a * cos**2 + bb * sin**2, a * sin**2 + bb * cos**2, (a - bb) * cos * sin

    x1, y1 = obb1[:, 0:1], obb1[:, 1:2]
    x2, y2 = obb2[None, :, 0], obb2[None, :, 1]
    a1, b1, c1 = (v[:, None] for v in cov(obb1))
    a2, b2, c2 = (v[None, :] for v in cov(obb2))
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / den * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / den * 0.5
    det1 = np.clip(a1 * b1 - c1**2, 0, None)
    det2 = np.clip(a2 * b2 - c2**2, 0, None)
    t3 = np.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2) / (4 * np.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = np.clip(t1 + t2 + t3, eps, 100.0)
    return 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)


def _box_iou_np(b1: np.ndarray, b2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs IoU for xyxy boxes [N,4] x [M,4] -> [N,M]."""
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (a1[:, None] + a2[None, :] - inter + eps)


IOUV = np.linspace(0.5, 0.95, 10)

# COCO keypoint OKS sigmas (reference utils/metrics.py OKS_SIGMA)
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
                      1.07, 1.07, 0.87, 0.87, 0.89, 0.89], np.float32) / 10.0


def mask_iou_np(gt_masks, pred_masks, eps: float = 1e-7):
    """Binary mask IoU ``[N, H, W]`` x ``[M, H, W]`` -> ``[N, M]`` (reference
    metrics.py mask_iou, as a product of the flattened masks in f32: the pixel
    counts are exact below 2^24). numpy arrays, or torch tensors (the
    Validator's, on the device)."""
    def flat(m):
        m = m.reshape(m.shape[0], -1)
        return m.float() if isinstance(m, torch.Tensor) else m.astype(np.float32)

    g, p = flat(gt_masks), flat(pred_masks)
    inter = g @ p.T
    return inter / (g.sum(1)[:, None] + p.sum(1)[None, :] - inter + eps)


def kpt_oks_np(gt_kpts: np.ndarray, gt_area: np.ndarray, pred_kpts: np.ndarray,
               sigmas: Optional[np.ndarray] = None, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity ``[N, nk, 3]`` x ``[M, nk, >=2]`` -> ``[N, M]``
    (reference metrics.py kpt_iou): ``exp(-d^2 / (2 area (2 sigma)^2))`` a
    keypoint, averaged over the visible ones of the ground truth. The sigmas
    are `OKS_SIGMA` for 17 keypoints and ``1 / nk`` otherwise."""
    nk = gt_kpts.shape[1]
    s = sigmas if sigmas is not None else (OKS_SIGMA if nk == 17 else np.full(nk, 1.0 / nk, np.float32))
    d2 = ((gt_kpts[:, None, :, :2] - pred_kpts[None, :, :, :2]) ** 2).sum(-1)  # [N, M, nk]
    vis = (gt_kpts[:, :, 2] > 0)[:, None, :]
    e = d2 / (2.0 * (2.0 * s[None, None, :]) ** 2 * (gt_area[:, None, None] + eps))
    return (np.exp(-e) * vis).sum(-1) / np.maximum(vis.sum(-1), 1)

def match_predictions(pred_cls: np.ndarray, gt_cls: np.ndarray, iou: np.ndarray) -> np.ndarray:
    """Reference BaseValidator.match_predictions: for each IoU threshold,
    greedily match predictions to gts of the same class.

    Args: iou [n_gt, n_pred]. Returns bool [n_pred, 10]."""
    correct = np.zeros((pred_cls.shape[0], IOUV.size), dtype=bool)
    cc = gt_cls[:, None] == pred_cls[None, :]
    iou = iou * cc  # zero out cross-class
    for i, t in enumerate(IOUV):
        matches = np.nonzero(iou >= t)
        matches = np.array(matches).T  # [k, 2] (gt, pred)
        if matches.shape[0]:
            order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
            matches = matches[order]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1], i] = True
    return correct


class ConfusionMatrix:
    """Detection/classification confusion matrix (reference metrics.py:294).

    Detect task: matrix is ``[nc+1, nc+1]`` (last row/col = background),
    indexed [predicted, ground-truth]. Detections below ``conf`` are dropped
    (0.25 is substituted when the 0.001 val default is passed, matching the
    reference); matches require IoU (or probiou for rotated) > ``iou_thres``
    and are deduplicated best-IoU-first per gt and per prediction.
    """

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45,
                 task: str = "detect"):
        self.task = task
        self.nc = nc
        self.matrix = np.zeros((nc + 1, nc + 1) if task == "detect" else (nc, nc))
        self.conf = 0.25 if conf in (None, 0.001) else conf
        self.iou_thres = iou_thres

    def process_cls_preds(self, preds, targets):
        for p, t in zip(np.asarray(preds).astype(int), np.asarray(targets).astype(int)):
            self.matrix[p, t] += 1

    def process_batch(self, pred_boxes: np.ndarray, pred_conf: np.ndarray,
                      pred_cls: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray,
                      rotated: bool = False):
        """One image. Boxes: xyxy (or xywhr when rotated), same pixel space."""
        gt_cls = np.asarray(gt_cls).astype(int)
        keep = np.asarray(pred_conf) > self.conf
        pred_boxes, pred_cls = np.asarray(pred_boxes)[keep], np.asarray(pred_cls).astype(int)[keep]
        if gt_cls.shape[0] == 0:
            for dc in pred_cls:
                self.matrix[dc, self.nc] += 1  # false positive
            return
        if pred_cls.shape[0] == 0:
            for gc in gt_cls:
                self.matrix[self.nc, gc] += 1  # background FN
            return
        iou = (_probiou_np(gt_boxes, pred_boxes) if rotated
               else _box_iou_np(gt_boxes, pred_boxes))
        gi, pi = np.nonzero(iou > self.iou_thres)
        matches = np.stack([gi, pi, iou[gi, pi]], 1) if gi.size else np.zeros((0, 3))
        if gi.size > 1:
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        m0, m1 = matches[:, 0].astype(int), matches[:, 1].astype(int)
        for i, gc in enumerate(gt_cls):
            j = m0 == i
            if j.sum() == 1:
                self.matrix[pred_cls[m1[j]][0], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # missed (true background)
        for i, dc in enumerate(pred_cls):
            if not np.any(m1 == i):
                self.matrix[dc, self.nc] += 1  # predicted on background

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return (tp[:-1], fp[:-1]) if self.task == "detect" else (tp, fp)

    def summary(self, names=None) -> str:
        """Compact textual rendering (stands in for the seaborn heatmap)."""
        n = self.matrix.shape[0]
        labels = list(names) if names else [str(i) for i in range(self.nc)]
        if self.task == "detect":
            labels = labels + ["bg"]
        w = max(6, max(len(str(l)) for l in labels) + 1)
        lines = ["pred\\gt".ljust(w) + "".join(str(l).rjust(w) for l in labels)]
        for i in range(n):
            lines.append(str(labels[i]).ljust(w)
                         + "".join(f"{int(self.matrix[i, j])}".rjust(w) for j in range(n)))
        return "\n".join(lines)

    def plot_data(self, names=None, normalize: bool = True):
        """(array, tick labels) of the confusion-matrix image: columns are the
        ground truth, rows the predictions; normalised, each column divided by
        its total. ``names`` (a list, or a dict of class index -> name) gives
        the labels when it names every class."""
        array = self.matrix / ((self.matrix.sum(0, keepdims=True) + 1e-9) if normalize else 1.0)
        if isinstance(names, dict):
            names = [names.get(i, str(i)) for i in range(self.nc)] if len(names) == self.nc else None
        labels = [str(v) for v in names] if names and len(names) == self.nc else [str(i) for i in range(self.nc)]
        if self.task == "detect":
            labels = labels + ["background"]
        return array, labels

    def plot(self, save_dir, names=None, normalize=True):
        """Confusion-matrix image (reference metrics.py ConfusionMatrix.plot
        :397-440; the JAX package's 12 x 9 in @ 200 dpi, 2400 x 1800 px):
        the matrix coloured by "Blues" from 0 to its maximum with a colour
        bar, each cell's value written when there are fewer than 30 classes
        (white on cells above half the maximum), "True" and "Predicted" axes.
        Returns the written path."""
        from quan_ultralytics_tpu_torch.utils.plotting import Chart, blues_table

        array, labels = self.plot_data(names, normalize)
        n = array.shape[0]
        title = "Confusion Matrix" + " Normalized" * normalize
        chart = Chart((12, 9), 200)
        u = chart.unit
        x0, y0 = int(0.12 * chart.width), int(0.08 * chart.height)
        side = min(int(0.70 * chart.width), int(0.80 * chart.height))
        cell = side / max(n, 1)
        vmax = float(array.max()) if array.size and array.max() > 0 else 1.0
        lut = blues_table()
        idx = np.clip((array / vmax * 256).astype(np.int64), 0, 255)
        for i in range(n):
            for j in range(n):
                ya, yb = int(round(y0 + i * cell)), int(round(y0 + (i + 1) * cell)) - 1
                xa, xb = int(round(x0 + j * cell)), int(round(x0 + (j + 1) * cell)) - 1
                chart.im[ya:yb + 1, xa:xb + 1] = lut[idx[i, j]]
                v = array[i, j]
                if n < 30 and v >= (0.005 if normalize else 1):
                    chart.text(f"{v:.2f}" if normalize else f"{int(v)}", ((xa + xb) // 2, (ya + yb) // 2 + int(4 * u)),
                               0.32, (255, 255, 255) if v > vmax / 2 else (0, 0, 0), anchor="center")
        for k, lab in enumerate(labels):
            c = int(round(x0 + (k + 0.5) * cell)), int(round(y0 + (k + 0.5) * cell))
            chart.text(lab, (c[0] + int(3 * u), y0 + side + int(6 * u)), 0.32, anchor="right", vertical=True)
            chart.text(lab, (x0 - int(6 * u), c[1] + int(3 * u)), 0.32, anchor="right")
        chart.text("True", (x0 + side // 2, chart.height - int(12 * u)), 0.45, anchor="center")
        chart.text("Predicted", (int(18 * u), y0 + side // 2), 0.45, anchor="center", vertical=True)
        chart.text(title, (x0 + side // 2, y0 - int(10 * u)), 0.5, anchor="center")
        bx = x0 + side + int(20 * u)  # colour bar
        for y in range(side):
            chart.im[y0 + y, bx:bx + int(14 * u)] = lut[255 - int(y / max(side - 1, 1) * 255)]
        for t in np.linspace(0, vmax, 6):
            y = y0 + side - 1 - int(round(t / vmax * (side - 1)))
            chart.text(f"{t:.2f}" if normalize else f"{t:.0f}", (bx + int(18 * u), y + int(4 * u)), 0.32)
        out = Path(save_dir) / f"{title.lower().replace(' ', '_')}.png"
        chart.save(out)
        return out


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP (reference metrics.py compute_ap)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return _trapezoid(np.interp(x, mrec, mpre), x)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter over fraction ``f`` of the curve (reference metrics.py
    smooth :456)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray,
                 nc: int, eps: float = 1e-16) -> Dict[str, np.ndarray]:
    """Reference metrics.py:537 — AP per class over the 10 IoU thresholds,
    plus the confidence-axis P/R/F1 curves and the IoU-0.5 PR curve used by
    the reference's val plot artifacts. Reported per-class P/R are taken at
    the confidence maximizing the smoothed MEAN F1 (reference :618-620)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, counts = np.unique(target_cls.astype(int), return_counts=True)
    npts = 1000
    px = np.linspace(0, 1, npts)  # confidence axis
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, npts))
    r_curve = np.zeros((nc, npts))
    prec_values = np.zeros((nc, 101))  # precision at 101 recall pts, IoU .5
    rx = np.linspace(0, 1, 101)
    n_gt_per_class = np.zeros(nc, int)
    for ci, c in enumerate(classes):
        if 0 <= c < nc:
            n_gt_per_class[c] = counts[ci]
        mask = pred_cls == c
        n_gt = counts[ci]
        n_p = mask.sum()
        if n_p == 0 or n_gt == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_gt + eps)
        precision = tpc / (tpc + fpc)
        # curves vs confidence (conf descending -> negate for interp)
        r_curve[c] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        p_curve[c] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[c, j] = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                mrec = np.concatenate(([0.0], recall[:, 0], [1.0]))
                mpre = np.concatenate(([1.0], precision[:, 0], [0.0]))
                mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
                prec_values[c] = np.interp(rx, mrec, mpre)
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = int(smooth(f1_curve.mean(0), 0.1).argmax()) if len(classes) else 0
    return {"ap": ap, "precision": p_curve[:, i], "recall": r_curve[:, i],
            "classes": classes, "px": px, "p_curve": p_curve,
            "r_curve": r_curve, "f1_curve": f1_curve, "rx": rx,
            "prec_values": prec_values, "n_gt": n_gt_per_class}


@dataclass
class DetMetrics:
    """Accumulates per-image matches and produces mAP (reference :798/:1226;
    set rotated=True for the OBB variant)."""

    nc: int
    rotated: bool = False
    _tp: List[np.ndarray] = field(default_factory=list)
    _conf: List[np.ndarray] = field(default_factory=list)
    _pred_cls: List[np.ndarray] = field(default_factory=list)
    _target_cls: List[np.ndarray] = field(default_factory=list)

    def update(self, pred_boxes: np.ndarray, pred_conf: np.ndarray, pred_cls: np.ndarray,
               gt_boxes: np.ndarray, gt_cls: np.ndarray,
               iou: Optional[np.ndarray] = None):
        """pred_boxes: [n,4] xyxy or [n,5] xywhr; gt_boxes likewise.

        iou: optional precomputed [n_gt, n_pred] similarity (mask IoU / OKS)
        — used instead of box IoU when given (reference Segment/PoseValidator
        _process_batch with masks/kpts)."""
        n = pred_boxes.shape[0]
        if gt_boxes.shape[0] == 0:
            if n:
                self._tp.append(np.zeros((n, IOUV.size), bool))
                self._conf.append(pred_conf)
                self._pred_cls.append(pred_cls)
            self._target_cls.append(gt_cls)
            return
        if n == 0:
            self._target_cls.append(gt_cls)
            return
        if iou is None:
            iou = _probiou_np(gt_boxes, pred_boxes) if self.rotated else _box_iou_np(gt_boxes, pred_boxes)
        self._tp.append(match_predictions(pred_cls, gt_cls, iou))
        self._conf.append(pred_conf)
        self._pred_cls.append(pred_cls)
        self._target_cls.append(gt_cls)

    def compute(self) -> Dict[str, float]:
        if not self._tp:
            self.last = None
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0}
        tp = np.concatenate(self._tp)
        conf = np.concatenate(self._conf)
        pred_cls = np.concatenate(self._pred_cls)
        target_cls = np.concatenate(self._target_cls) if self._target_cls else np.zeros(0)
        res = ap_per_class(tp, conf, pred_cls, target_cls, self.nc)
        self.last = res  # per-class data for table/plots
        seen = np.unique(target_cls.astype(int))
        ap = res["ap"][seen] if len(seen) else res["ap"][:0]
        return {
            "mAP50": float(ap[:, 0].mean()) if ap.size else 0.0,
            "mAP50-95": float(ap.mean()) if ap.size else 0.0,
            "precision": float(res["precision"][seen].mean()) if len(seen) else 0.0,
            "recall": float(res["recall"][seen].mean()) if len(seen) else 0.0,
        }

    def per_class_table(self, names=None) -> str:
        """Reference val-summary table (validator LOGGER output + DetMetrics
        class_result, metrics.py:798): one row per seen class with Instances,
        P, R, mAP50, mAP50-95, headed by the all-classes row."""
        if getattr(self, "last", None) is None:
            self.compute()
        res = self.last
        if res is None:
            return "(no predictions)"
        names = names or {}
        seen = res["classes"]
        rows = []
        ap = res["ap"]
        head = f"{'Class':>18} {'Instances':>10} {'P':>8} {'R':>8} {'mAP50':>8} {'mAP50-95':>9}"
        all_ap = ap[seen] if len(seen) else ap[:0]
        rows.append(f"{'all':>18} {int(res['n_gt'].sum()):>10} "
                    f"{res['precision'][seen].mean() if len(seen) else 0:>8.3f} "
                    f"{res['recall'][seen].mean() if len(seen) else 0:>8.3f} "
                    f"{all_ap[:, 0].mean() if all_ap.size else 0:>8.3f} "
                    f"{all_ap.mean() if all_ap.size else 0:>9.3f}")
        for c in seen:
            nm = str(names.get(int(c), int(c)) if isinstance(names, dict)
                     else (names[int(c)] if int(c) < len(names) else int(c)))
            rows.append(f"{nm:>18} {res['n_gt'][c]:>10} {res['precision'][c]:>8.3f} "
                        f"{res['recall'][c]:>8.3f} {ap[c, 0]:>8.3f} {ap[c].mean():>9.3f}")
        return "\n".join([head] + rows)

    def curves(self, names=None) -> List[Dict]:
        """The four validation charts as data (reference metrics.py
        plot_pr_curve :456 / plot_mc_curve :481): each ``{file, title,
        xlabel, ylabel, x, series}`` with ``series`` a list of (label, y,
        linewidth, colour or None): one line a seen class, then the
        all-classes line (the mean precision at IoU 0.5 for the PR curve, the
        smoothed mean for F1, P and R). Empty without predictions."""
        if getattr(self, "last", None) is None:
            self.compute()
        res = self.last
        if res is None:
            return []
        names = names or {}
        seen = res["classes"]

        def label(c) -> str:
            if isinstance(names, dict):
                return str(names.get(int(c), int(c)))
            return str(names[int(c)]) if int(c) < len(names) else str(c)

        pr = [(f"{label(c)} {res['ap'][c, 0]:.3f}", res["prec_values"][c], 1, None) for c in seen]
        if len(seen):
            pr.append((f"all classes {res['ap'][seen, 0].mean():.3f} mAP@0.5",
                       res["prec_values"][seen].mean(0), 3, "blue"))
        out = [{"file": "PR_curve.png", "title": "Precision-Recall Curve", "xlabel": "Recall",
                "ylabel": "Precision", "x": res["rx"], "series": pr}]
        for key, ylabel, fname in (("f1_curve", "F1", "F1_curve.png"), ("p_curve", "Precision", "P_curve.png"),
                                   ("r_curve", "Recall", "R_curve.png")):
            series = [(label(c), res[key][c], 1, None) for c in seen]
            if len(seen):
                y = smooth(res[key][seen].mean(0), 0.05)
                series.append((f"all classes {y.max():.2f} at {res['px'][y.argmax()]:.3f}", y, 3, "blue"))
            out.append({"file": fname, "title": f"{ylabel}-Confidence Curve", "xlabel": "Confidence",
                        "ylabel": ylabel, "x": res["px"], "series": series})
        return out

    def plot(self, save_dir, names=None):
        """Write the reference's four validation curves (`curves`):
        ``PR_curve.png``, ``F1_curve.png``, ``P_curve.png``, ``R_curve.png``,
        9 x 6 in @ 200 dpi (1800 x 1200 px), both axes 0..1, the legend to
        the right. Returns the list of written paths."""
        from quan_ultralytics_tpu_torch.utils.plotting import BLUE, SERIES_COLORS, Chart

        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        out = []
        for spec in self.curves(names):
            chart = Chart((9, 6), 200)
            ax = chart.axes((0.08, 0.1, 0.66, 0.82), (0, 1), (0, 1), spec["title"], spec["xlabel"], spec["ylabel"])
            for k, (lab, y, lw, color) in enumerate(spec["series"]):
                ax.plot(spec["x"], y, BLUE if color == "blue" else SERIES_COLORS[k % len(SERIES_COLORS)], lw, lab)
            ax.legend()
            out.append(Path(chart.save(save_dir / spec["file"])))
        return out
