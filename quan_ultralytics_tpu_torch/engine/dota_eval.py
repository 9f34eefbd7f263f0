"""DOTA submission writer: merged-image Task1 output files (counterpart of the
JAX package's ``engine/dota_eval.py``).

Reference: models/yolo/obb/val.py pred_to_json / eval_json — patch-level
predictions (from split_dota windows named ``{stem}__{x}_{y}``) are shifted
back to source-image coordinates, merged per image with rotated NMS, and
written as DOTA Task1 files ``Task1_{class}.txt`` with lines
``image_id score x1 y1 x2 y2 x3 y3 x4 y4``.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from quan_ultralytics_tpu_torch.utils.metrics import _probiou_np

PATCH_RE = re.compile(r"^(.*)__(\d+)_(\d+)$")


def _xywhr_to_corners(b: np.ndarray) -> np.ndarray:
    ctr, w, h, t = b[:, :2], b[:, 2:3], b[:, 3:4], b[:, 4:5]
    cos, sin = np.cos(t), np.sin(t)
    v1 = np.concatenate([w / 2 * cos, w / 2 * sin], axis=1)
    v2 = np.concatenate([-h / 2 * sin, h / 2 * cos], axis=1)
    return np.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2], axis=1)


def _nms_rotated_np(boxes: np.ndarray, scores: np.ndarray, thr: float = 0.3) -> np.ndarray:
    order = np.argsort(-scores)
    b = boxes[order]
    ious = _probiou_np(b, b)
    n = len(b)
    upper = np.triu(np.ones((n, n), bool), k=1)
    keep_sorted = ~(((ious >= thr) & upper).any(axis=0))
    return order[keep_sorted]


class DOTASubmission:
    """Accumulate per-patch predictions, merge, and write Task1 files."""

    def __init__(self, class_names: Sequence[str]):
        self.names = list(class_names)
        self._per_image: Dict[str, List[np.ndarray]] = defaultdict(list)

    def add_patch(self, patch_stem: str, xywhr: np.ndarray, conf: np.ndarray, cls: np.ndarray):
        """xywhr in patch pixels; patch_stem like 'P0006__1024_2048'."""
        m = PATCH_RE.match(patch_stem)
        if m:
            image_id, ox, oy = m.group(1), float(m.group(2)), float(m.group(3))
        else:
            image_id, ox, oy = patch_stem, 0.0, 0.0
        if len(xywhr) == 0:
            self._per_image.setdefault(image_id, [])
            return
        shifted = xywhr.copy()
        shifted[:, 0] += ox
        shifted[:, 1] += oy
        rows = np.concatenate([shifted, conf[:, None], cls[:, None]], axis=1)
        self._per_image[image_id].append(rows)

    def merge(self, iou_thr: float = 0.3) -> Dict[str, np.ndarray]:
        merged = {}
        for image_id, chunks in self._per_image.items():
            if not chunks:
                merged[image_id] = np.zeros((0, 7), np.float32)
                continue
            rows = np.concatenate(chunks)
            keep_all = []
            for c in np.unique(rows[:, 6]):
                idx = np.nonzero(rows[:, 6] == c)[0]
                keep = _nms_rotated_np(rows[idx, :5], rows[idx, 5], iou_thr)
                keep_all.append(idx[keep])
            merged[image_id] = rows[np.concatenate(keep_all)] if keep_all else rows[:0]
        return merged

    def write(self, out_dir: str, iou_thr: float = 0.3) -> List[str]:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        merged = self.merge(iou_thr)
        files = []
        handles = {}
        try:
            for ci, name in enumerate(self.names):
                p = out / f"Task1_{name}.txt"
                handles[ci] = open(p, "w")
                files.append(str(p))
            for image_id, rows in sorted(merged.items()):
                corners = _xywhr_to_corners(rows[:, :5]) if len(rows) else np.zeros((0, 4, 2))
                for r, cs in zip(rows, corners):
                    line = f"{image_id} {r[5]:.6f} " + " ".join(f"{v:.2f}" for v in cs.reshape(-1))
                    handles[int(r[6])].write(line + "\n")
        finally:
            for fh in handles.values():
                fh.close()
        return files
