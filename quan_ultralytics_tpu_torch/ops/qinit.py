"""Quaternion-aware weight initialization (counterpart of the JAX
``ops/qinit.py``; reference classification/quaternion/init.py:8-240, QInit):
weight quaternions with a chi(4)-distributed magnitude scaled by the He or
Glorot criterion and a uniformly random unit 3-axis and phase,
``w = |w| (cos t + sin t (u_i i + u_j j + u_k k))``. An alternative to the
default scaled kaiming-uniform draw of `models.conv.QConv2D`.

JAX draws from its PRNG keys and this from a ``torch.Generator``: the
distributions are the same, the values are not.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def quaternion_chi_init(criterion: str = "he") -> Callable[..., torch.Tensor]:
    """An initializer ``init(shape, generator=None, dtype=float32)`` of
    quaternion conv weights in the port's layout ``[4, C_out, C_in, kH, kW]``
    (the JAX one's is ``[4, kH, kW, C_in, C_out]``; the fans are the same)."""
    if criterion not in ("he", "glorot"):
        raise ValueError(f"criterion must be 'he' or 'glorot', got {criterion!r}")

    def init(shape: Sequence[int], generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if shape[0] != 4:
            raise ValueError(f"quaternion weights have 4 components first, got {tuple(shape)}")
        _, cout, cin, kh, kw = shape
        fan_in, fan_out = kh * kw * cin, kh * kw * cout
        sigma = 1.0 / math.sqrt(2.0 * fan_in) if criterion == "he" else 1.0 / math.sqrt(fan_in + fan_out)
        comp = tuple(shape[1:])
        g = torch.randn((4, *comp), generator=generator, dtype=dtype)
        magnitude = torch.sqrt((g * g).sum(0)) * sigma  # chi with 4 degrees of freedom
        v = torch.randn((3, *comp), generator=generator, dtype=dtype)
        v = v / torch.sqrt((v * v).sum(0)).clamp(min=1e-12)  # a random unit axis
        phase = torch.rand(comp, generator=generator, dtype=dtype) * (2 * math.pi) - math.pi
        s = magnitude * torch.sin(phase)
        return torch.stack([magnitude * torch.cos(phase), s * v[0], s * v[1], s * v[2]])

    return init
