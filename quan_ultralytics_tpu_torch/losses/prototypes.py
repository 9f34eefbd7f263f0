"""Standalone quaternion loss prototypes (counterpart of the JAX
``losses/prototypes.py``; reference utils/loss.py:19-255): the reference's
``QuaternionOBBLoss`` criteria that are not wired into training (the trained
path is `losses.detect.obb_loss`), as functions for users of those classes.
"""

from __future__ import annotations

from typing import Optional

import torch

from quan_ultralytics_tpu_torch.losses.detect import _angle_to_quaternion, quaternion_angular_loss


def quaternion_obb_loss(pred_angles: torch.Tensor, target_angles: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Geodesic orientation loss between two sets of angles (loss.py:19-61):
    the mean, or the ``weights``-weighted mean, of the SO(3) distances."""
    d = quaternion_angular_loss(_angle_to_quaternion(pred_angles[..., None]),
                                _angle_to_quaternion(target_angles[..., None]))
    if weights is not None:
        return (d * weights).sum() / weights.sum().clamp(min=1.0)
    return d.mean()


def temporal_smoothness_loss(angles_t: torch.Tensor, angles_tm1: torch.Tensor) -> torch.Tensor:
    """The mean geodesic distance between consecutive frames' orientations
    (loss.py:63-89)."""
    return quaternion_angular_loss(_angle_to_quaternion(angles_t[..., None]),
                                   _angle_to_quaternion(angles_tm1[..., None])).mean()
