"""Box and instance algebra for label sets: format conversion, flip, scale,
clip (counterpart of the JAX ``utils/instance.py``, numpy as there; reference
utils/instance.py Bboxes :34-183, Instances :185-420).

A container that carries boxes (any format), optional segments (polygons)
and keypoints through geometric transforms together. The loader's
corner-point pipeline (`data.augment`) uses plain arrays; this module is for
external tooling. Where the JAX module asserts, this one raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


def _convert(b: np.ndarray, src: str, dst: str) -> np.ndarray:
    if src == dst or len(b) == 0:
        return b.copy()
    x = b.astype(np.float32).copy()
    # normalize to xyxy
    if src == "xywh":
        cx, cy, w, h = x.T
        x = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    elif src == "ltwh":
        l, t, w, h = x.T
        x = np.stack([l, t, l + w, t + h], 1)
    if dst == "xyxy":
        return x
    x1, y1, x2, y2 = x.T
    if dst == "xywh":
        return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1)
    return np.stack([x1, y1, x2 - x1, y2 - y1], 1)  # ltwh


def _check_format(format: str) -> None:
    if format not in _FORMATS:
        raise ValueError(f"box format must be one of {_FORMATS}, got {format!r}")


class Bboxes:
    """Format-aware box container (reference instance.py:34-183)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        _check_format(format)
        b = np.asarray(bboxes, np.float32)
        if b.ndim == 1:
            b = b[None]
        if b.ndim != 2 or b.shape[1] != 4:
            raise ValueError(f"boxes must be [n, 4], got {b.shape}")
        self.bboxes = b
        self.format = format

    def convert(self, format: str) -> None:
        _check_format(format)
        self.bboxes = _convert(self.bboxes, self.format, format)
        self.format = format

    def areas(self) -> np.ndarray:
        b = _convert(self.bboxes, self.format, "xyxy")
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def mul(self, scale) -> None:
        s = np.asarray(scale, np.float32)
        if s.ndim == 0:
            s = np.full(4, float(s))
        self.bboxes = self.bboxes * s

    def add(self, offset) -> None:
        o = np.asarray(offset, np.float32)
        if o.ndim == 0:
            o = np.full(4, float(o))
        self.bboxes = self.bboxes + o

    def __len__(self):
        return len(self.bboxes)

    def __getitem__(self, idx) -> "Bboxes":
        return Bboxes(np.atleast_2d(self.bboxes[idx]), self.format)


class Instances:
    """Boxes + optional segments/keypoints moving together through geometric
    transforms (reference instance.py:185-420)."""

    def __init__(self, bboxes: np.ndarray, segments: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None, bbox_format: str = "xywh",
                 normalized: bool = True):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = np.zeros((len(self._bboxes), 0, 2), np.float32) if segments is None else np.asarray(segments, np.float32)
        self.keypoints = keypoints if keypoints is None else np.asarray(keypoints, np.float32)
        self.normalized = normalized

    @property
    def bboxes(self) -> np.ndarray:
        return self._bboxes.bboxes

    @property
    def bbox_areas(self) -> np.ndarray:
        return self._bboxes.areas()

    def convert_bbox(self, format: str) -> None:
        self._bboxes.convert(format)

    def scale(self, sx: float, sy: float, bbox_only: bool = False) -> None:
        self._bboxes.mul((sx, sy, sx, sy))
        if not bbox_only:
            self.segments[..., 0] *= sx
            self.segments[..., 1] *= sy
            if self.keypoints is not None:
                self.keypoints[..., 0] *= sx
                self.keypoints[..., 1] *= sy

    def denormalize(self, w: int, h: int) -> None:
        if not self.normalized:
            return
        self.scale(w, h)
        self.normalized = False

    def normalize(self, w: int, h: int) -> None:
        if self.normalized:
            return
        self.scale(1 / w, 1 / h)
        self.normalized = True

    def add_padding(self, padw: float, padh: float) -> None:
        if self.normalized:
            raise ValueError("add_padding works in pixels: denormalize first")
        self._bboxes.add((padw, padh, padw, padh))
        self.segments[..., 0] += padw
        self.segments[..., 1] += padh
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh

    def flipud(self, h: float) -> None:
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        y1, y2 = b[:, 1].copy(), b[:, 3].copy()
        b[:, 1], b[:, 3] = h - y2, h - y1
        self.convert_bbox(fmt)
        self.segments[..., 1] = h - self.segments[..., 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]

    def fliplr(self, w: float) -> None:
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        x1, x2 = b[:, 0].copy(), b[:, 2].copy()
        b[:, 0], b[:, 2] = w - x2, w - x1
        self.convert_bbox(fmt)
        self.segments[..., 0] = w - self.segments[..., 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]

    def clip(self, w: float, h: float) -> None:
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        self.convert_bbox(fmt)
        self.segments[..., 0] = self.segments[..., 0].clip(0, w)
        self.segments[..., 1] = self.segments[..., 1].clip(0, h)

    def remove_zero_area_boxes(self) -> np.ndarray:
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
            self.segments = self.segments[good]
            if self.keypoints is not None:
                self.keypoints = self.keypoints[good]
        return good

    def __len__(self):
        return len(self._bboxes)
