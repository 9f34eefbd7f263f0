"""RGB -> quaternion input mappings (counterpart of the JAX ``ops/mappings.py``).

Input layout is NHWC ``[B, H, W, 3]``; output is BHWQC ``[B, H, W, 4, 1]``.
"""

from __future__ import annotations

import torch

MAPPING_TYPES = ("poincare", "hamilton", "luminance", "mean_brightness", "raw_normalized")


def rgb_to_quaternion(x: torch.Tensor, mapping_type: str = "poincare") -> torch.Tensor:
    """Map RGB ``[B, H, W, 3]`` to one quaternion channel ``[B, H, W, 4, 1]``.

    * ``poincare`` (default): with ``n = |x|^2``, real part ``(1 - n) / (1 + n)``
      and vector part ``2x / (1 + n)``.
    * ``hamilton``: real part 0, vector = RGB.
    * ``luminance``: Rec.601 luma real part + min-max-normalized RGB.
    * ``mean_brightness``: channel mean real part + raw RGB vector.
    * ``raw_normalized``: mean of normalized RGB + normalized RGB.

    The ``min()`` / ``max()`` of the normalized variants are global scalar
    reductions over the whole batch tensor, as in the reference.
    """
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    if mapping_type == "poincare":
        norm_sq = torch.sum(x * x, dim=-1)
        denom = 1.0 + norm_sq
        real = (1.0 - norm_sq) / denom
        vec = 2.0 * x / denom[..., None]
        q = torch.stack([real, vec[..., 0], vec[..., 1], vec[..., 2]], dim=-1)
    elif mapping_type == "hamilton":
        q = torch.stack([torch.zeros_like(r), r, g, b], dim=-1)
    elif mapping_type == "luminance":
        luma = 0.299 * r + 0.587 * g + 0.114 * b
        xn = _global_minmax_normalize(x)
        q = torch.stack([luma, xn[..., 0], xn[..., 1], xn[..., 2]], dim=-1)
    elif mapping_type == "mean_brightness":
        q = torch.stack([x.mean(dim=-1), r, g, b], dim=-1)
    elif mapping_type == "raw_normalized":
        xn = _global_minmax_normalize(x)
        q = torch.stack([xn.mean(dim=-1), xn[..., 0], xn[..., 1], xn[..., 2]], dim=-1)
    else:
        raise ValueError(f"unknown mapping_type {mapping_type!r}; choose from {MAPPING_TYPES}")
    return q[..., None]  # [B, H, W, 4, 1]


def _global_minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo)
