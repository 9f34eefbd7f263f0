"""Poincare-ball quaternion ops (counterpart of the JAX ``ops/qgeo.py``;
reference classification/quaternion/qconv_geoopt.py, an experimental path off
the main one): Mobius addition, the exponential and log maps at the origin,
and a tangent-space quaternion conv

    y = expmap0(qconv(logmap0(x)))

the "hyperbolic layer" construction (HNN, Ganea et al.) that the geoopt
version approximates.
"""

from __future__ import annotations

from typing import Optional

import torch

from quan_ultralytics_tpu_torch.ops.qconv import qconv2d


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1, keepdim=True)


def mobius_add(x: torch.Tensor, y: torch.Tensor, c: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """Mobius addition on the c-ball (the gyrovector sum), over the last axis."""
    x2, y2 = _sq_norm(x), _sq_norm(y)
    xy = (x * y).sum(dim=-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    den = 1 + 2 * c * xy + c ** 2 * x2 * y2
    return num / den.clamp(min=eps)


def expmap0(v: torch.Tensor, c: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """Exponential map at the origin: tangent vector -> ball point."""
    sqrt_c = c ** 0.5
    n = torch.sqrt(_sq_norm(v).clamp(min=eps))
    return torch.tanh(sqrt_c * n) * v / (sqrt_c * n)


def logmap0(x: torch.Tensor, c: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """Log map at the origin: ball point -> tangent vector."""
    sqrt_c = c ** 0.5
    n = torch.sqrt(_sq_norm(x).clamp(eps, (1 - eps) / c))
    return torch.atanh(sqrt_c * n) * x / (sqrt_c * n)


def poincare_qconv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                     c: float = 1.0, stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """Hyperbolic quaternion conv: each quaternion (the size-4 axis of
    ``x [B, H, W, 4, C]``, inside the unit ball as the poincare RGB mapping
    gives it) is mapped to the tangent space at the origin, convolved by
    `qconv2d` (``w`` in the port's ``[4, C_out, C_in / g, kH, kW]``), and
    mapped back."""
    v = logmap0(x.movedim(-2, -1), c).movedim(-1, -2)
    y = qconv2d(v, w, bias, stride=stride, padding=padding, dilation=dilation, groups=groups)
    return expmap0(y.movedim(-2, -1), c).movedim(-1, -2)
