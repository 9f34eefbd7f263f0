"""ByteTrack multi-object tracker (counterpart of the JAX package's
``trackers/byte_tracker.py``; reference ultralytics/trackers/byte_tracker.py).

Two-stage association: high-score detections match tracks by IoU first,
low-score detections rescue the unmatched tracks second; lost tracks persist
``track_buffer`` frames. Assignment is optimal min-cost matching
(`trackers.matching.linear_assignment`); `greedy_assignment` is kept as the
JAX package keeps it. Host-side numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from quan_ultralytics_tpu_torch.trackers.kalman import KalmanFilterXYAH
from quan_ultralytics_tpu_torch.trackers.matching import linear_assignment


def iou_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """1 - IoU of xyxy boxes ``[n, 4]`` x ``[m, 4]``."""
    if len(a) == 0 or len(b) == 0:
        return np.ones((len(a), len(b)), np.float32)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return 1.0 - inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def greedy_assignment(cost: np.ndarray, thresh: float):
    """Greedy min-cost matching; returns ``(matches, unmatched rows, unmatched columns)``."""
    matches = []
    if cost.size:
        flat = [(cost[i, j], i, j) for i in range(cost.shape[0]) for j in range(cost.shape[1])
                if cost[i, j] <= thresh]
        used_a, used_b = set(), set()
        for _, i, j in sorted(flat):
            if i not in used_a and j not in used_b:
                matches.append((i, j))
                used_a.add(i)
                used_b.add(j)
    ua = [i for i in range(cost.shape[0]) if i not in {m[0] for m in matches}]
    ub = [j for j in range(cost.shape[1]) if j not in {m[1] for m in matches}]
    return matches, ua, ub


class STrack:
    """One track. ``_count`` numbers the tracks of the process, as the JAX package's does."""

    _count = 0

    def __init__(self, xyxy, score, cls, fmt: str = "xyah"):
        x1, y1, x2, y2 = xyxy
        w, h = x2 - x1, y2 - y1
        self.fmt = fmt  # the Kalman measurement space: xyah (ByteTrack) | xywh (BoT-SORT)
        if fmt == "xyah":
            self.xyah = np.array([x1 + w / 2, y1 + h / 2, w / max(h, 1e-9), h])
        else:
            self.xyah = np.array([x1 + w / 2, y1 + h / 2, w, h])
        self.score = float(score)
        self.cls = int(cls)
        self.track_id = 0
        self.mean = None
        self.cov = None
        self.is_activated = False
        self.state = "new"  # new | tracked | lost | removed
        self.frame_id = 0
        self.start_frame = 0

    @property
    def xyxy(self) -> np.ndarray:
        c = self.xyah if self.mean is None else self.mean[:4]
        if self.fmt == "xyah":
            x, y, a, h = c
            w = a * h
        else:
            x, y, w, h = c
        return np.array([x - w / 2, y - h / 2, x + w / 2, y + h / 2])

    def activate(self, kf, frame_id: int) -> None:
        STrack._count += 1
        self.track_id = STrack._count
        self.mean, self.cov = kf.initiate(self.xyah)
        self.state = "tracked"
        self.is_activated = frame_id == 1
        self.frame_id = self.start_frame = frame_id

    def update(self, det: "STrack", kf, frame_id: int) -> None:
        """Take a matched detection, on a tracked or a lost track (the JAX
        package's ``update`` and ``re_activate`` do the same)."""
        self.mean, self.cov = kf.update(self.mean, self.cov, det.xyah)
        self.state = "tracked"
        self.is_activated = True
        self.frame_id = frame_id
        self.score = det.score
        self.cls = det.cls

    def predict(self, kf) -> None:
        if self.state != "tracked":
            # a lost track's size stops changing: xyah zeroes the h velocity
            # (reference byte_tracker.py multi_predict), xywh the w and h ones
            # (reference bot_sort.py STrack.predict mean[6:8])
            self.mean[7] = 0
            if self.fmt == "xywh":
                self.mean[6] = 0
        self.mean, self.cov = kf.predict(self.mean, self.cov)


class BYTETracker:
    def __init__(self, track_high_thresh: float = 0.5, track_low_thresh: float = 0.1,
                 new_track_thresh: float = 0.6, match_thresh: float = 0.8, track_buffer: int = 30):
        self.kf = KalmanFilterXYAH()
        self.high = track_high_thresh
        self.low = track_low_thresh
        self.new_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.buffer = track_buffer
        self.tracked: List[STrack] = []
        self.lost: List[STrack] = []
        self.frame_id = 0
        self.fmt = "xyah"

    def _dists(self, tracks: List[STrack], dets: List[STrack]) -> np.ndarray:
        return iou_distance(np.array([t.xyxy for t in tracks]).reshape(-1, 4),
                            np.array([d.xyxy for d in dets]).reshape(-1, 4))

    def update(self, xyxy: np.ndarray, scores: np.ndarray, cls: np.ndarray) -> np.ndarray:
        """One frame's detections -> ``[n, 7]``: xyxy, track_id, score, cls of the
        activated tracks."""
        self.frame_id += 1
        dets_high = [STrack(b, s, c, self.fmt) for b, s, c in zip(xyxy, scores, cls) if s >= self.high]
        dets_low = [STrack(b, s, c, self.fmt) for b, s, c in zip(xyxy, scores, cls)
                    if self.low <= s < self.high]

        # unconfirmed: activated in the last frame and not matched since; they get
        # their own association round and die on one miss (reference
        # byte_tracker.py: unmatched unconfirmed tracks are removed)
        unconfirmed = [t for t in self.tracked if not t.is_activated]
        pool = [t for t in self.tracked if t.is_activated] + self.lost
        for t in pool:
            t.predict(self.kf)

        # stage 1: the high-score detections
        matches, ut, ud = linear_assignment(self._dists(pool, dets_high), self.match_thresh)
        for ti, di in matches:
            pool[ti].update(dets_high[di], self.kf, self.frame_id)

        # stage 2: the low-score detections rescue the still-tracked leftovers
        leftover = [pool[i] for i in ut if pool[i].state == "tracked"]
        matches2, ut2, _ = linear_assignment(self._dists(leftover, dets_low), 0.5)
        for ti, di in matches2:
            leftover[ti].update(dets_low[di], self.kf, self.frame_id)
        for i in ut2:
            leftover[i].state = "lost"
        for i in ut:
            t = pool[i]
            if t.state == "lost" and self.frame_id - t.frame_id > self.buffer:
                t.state = "removed"

        # stage 3: unconfirmed tracks against the remaining high-score detections
        # (the reference's threshold 0.7); a miss removes the track at once
        remaining = [dets_high[i] for i in ud]
        matches3, ut3, ud3 = linear_assignment(self._dists(unconfirmed, remaining), 0.7)
        for ti, di in matches3:
            unconfirmed[ti].update(remaining[di], self.kf, self.frame_id)
        for i in ut3:
            unconfirmed[i].state = "removed"

        # new tracks from the high-score detections still unmatched
        for di in ud3:
            det = remaining[di]
            if det.score >= self.new_thresh:
                det.activate(self.kf, self.frame_id)

        all_tracks = pool + unconfirmed + [d for d in dets_high if d.track_id and d not in pool]
        self.tracked = [t for t in all_tracks if t.state == "tracked"]
        self.lost = [t for t in all_tracks if t.state == "lost"]

        out = [np.concatenate([t.xyxy, [t.track_id, t.score, t.cls]])
               for t in self.tracked if t.is_activated]
        return np.array(out).reshape(-1, 7)
