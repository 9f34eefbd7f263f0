"""Kalman filters for box tracking: constant velocity in xyah (ByteTrack) or
xywh (BoT-SORT) space (counterpart of the JAX package's ``trackers/kalman.py``;
reference ultralytics/trackers/utils/kalman_filter.py).

Host-side numpy: tracking is a per-frame O(tracks) job on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class KalmanFilterXYAH:
    """State ``[x, y, a(spect), h, vx, vy, va, vh]``."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._F = np.eye(8)
        for i in range(4):
            self._F[i, 4 + i] = dt
        self._H = np.eye(4, 8)
        self._std_pos = 1.0 / 20
        self._std_vel = 1.0 / 160

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.zeros(8)
        mean[:4] = measurement
        h = measurement[3]
        std = [2 * self._std_pos * h, 2 * self._std_pos * h, 1e-2, 2 * self._std_pos * h,
               10 * self._std_vel * h, 10 * self._std_vel * h, 1e-5, 10 * self._std_vel * h]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        h = mean[3]
        std = [self._std_pos * h, self._std_pos * h, 1e-2, self._std_pos * h,
               self._std_vel * h, self._std_vel * h, 1e-5, self._std_vel * h]
        return np.diag(np.square(std))

    def _innovation_cov(self, mean: np.ndarray) -> np.ndarray:
        h = mean[3]
        std = [self._std_pos * h, self._std_pos * h, 1e-1, self._std_pos * h]
        return np.diag(np.square(std))

    def predict(self, mean: np.ndarray, cov: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + self._motion_cov(mean)
        return mean, cov

    def update(self, mean: np.ndarray, cov: np.ndarray,
               measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        S = self._H @ cov @ self._H.T + self._innovation_cov(mean)
        K = cov @ self._H.T @ np.linalg.inv(S)
        innovation = measurement - self._H @ mean
        mean = mean + K @ innovation
        cov = (np.eye(8) - K @ self._H) @ cov
        return mean, cov


class KalmanFilterXYWH(KalmanFilterXYAH):
    """BoT-SORT's variant: state ``[x, y, w, h, ...]``, noise scaled by w and h."""

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.zeros(8)
        mean[:4] = measurement
        w, h = measurement[2], measurement[3]
        std = [2 * self._std_pos * w, 2 * self._std_pos * h, 2 * self._std_pos * w, 2 * self._std_pos * h,
               10 * self._std_vel * w, 10 * self._std_vel * h, 10 * self._std_vel * w, 10 * self._std_vel * h]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        w, h = mean[2], mean[3]
        std = [self._std_pos * w, self._std_pos * h, self._std_pos * w, self._std_pos * h,
               self._std_vel * w, self._std_vel * h, self._std_vel * w, self._std_vel * h]
        return np.diag(np.square(std))

    def _innovation_cov(self, mean: np.ndarray) -> np.ndarray:
        w, h = mean[2], mean[3]
        std = [self._std_pos * w, self._std_pos * h, self._std_pos * w, self._std_pos * h]
        return np.diag(np.square(std))
