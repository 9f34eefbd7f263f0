"""BoT-SORT tracker: ByteTrack with camera-motion compensation and an optional
ReID hook (counterpart of the JAX package's ``trackers/bot_sort.py``;
reference ultralytics/trackers/bot_sort.py).

The global motion compensation (`trackers.gmc.GMC`) estimates a per-frame
affine from sparse optical flow and warps the predicted track centres
before association. The JAX package calls OpenCV for it; this package has
its own numpy steps (`trackers/gmc.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quan_ultralytics_tpu_torch.trackers.byte_tracker import BYTETracker
from quan_ultralytics_tpu_torch.trackers.gmc import GMC
from quan_ultralytics_tpu_torch.trackers.kalman import KalmanFilterXYWH

__all__ = ["BOTSORT", "GMC"]


class BOTSORT(BYTETracker):
    def __init__(self, track_high_thresh: float = 0.5, track_low_thresh: float = 0.1,
                 new_track_thresh: float = 0.6, match_thresh: float = 0.8, track_buffer: int = 30,
                 gmc: bool = True, reid_fn=None):
        super().__init__(track_high_thresh, track_low_thresh, new_track_thresh,
                         match_thresh, track_buffer)
        self.kf = KalmanFilterXYWH()  # BoT-SORT's xywh model
        self.fmt = "xywh"
        self.gmc = GMC() if gmc else None
        self.reid_fn = reid_fn  # optional: frame, boxes -> embeddings

    def _compensate(self, H: np.ndarray) -> None:
        """Move the tracks' centres by the camera's motion (reference bot_sort.py multi_gmc)."""
        R, t = H[:2, :2], H[:2, 2]
        for tr in self.tracked + self.lost:
            if tr.mean is not None:
                tr.mean[:2] = R @ tr.mean[:2] + t

    def update(self, xyxy: np.ndarray, scores: np.ndarray, cls: np.ndarray,
               frame: Optional[np.ndarray] = None) -> np.ndarray:
        if self.gmc is not None and frame is not None:
            self._compensate(self.gmc.apply(frame))
        return super().update(xyxy, scores, cls)
