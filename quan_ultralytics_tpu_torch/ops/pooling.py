"""Quaternion-aware spatial pooling and resizing on BHWQC tensors
(counterpart of the JAX ``ops/pooling.py``): per-component 2D ops that leave
the quaternion axis intact."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.qconv import from_nchw, to_nchw

IntOr2 = Union[int, Tuple[int, int]]


def qmax_pool(x: torch.Tensor, kernel: IntOr2, stride: Optional[IntOr2] = None,
              padding: IntOr2 = 0) -> torch.Tensor:
    """Max pool over H, W of a ``[B, H, W, 4, C]`` tensor (padding never wins the max)."""
    y = F.max_pool2d(to_nchw(x), kernel, stride if stride is not None else kernel, padding)
    return from_nchw(y, x.shape[3])


def qavg_pool_global(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Global average pool over H, W (adaptive average pool to 1 x 1)."""
    return x.mean(dim=(1, 2), keepdim=keepdims)


def qavg_pool(x: torch.Tensor, kernel: IntOr2, stride: Optional[IntOr2] = None,
              padding: IntOr2 = 0) -> torch.Tensor:
    """Average pool over H, W of a ``[B, H, W, 4, C]`` tensor. The zero padding
    counts: every window divides by ``kh * kw``."""
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    y = F.pad(to_nchw(x), (pw, pw, ph, ph))
    y = F.avg_pool2d(y, kernel, stride if stride is not None else kernel)
    return from_nchw(y, x.shape[3])


def qupsample(x: torch.Tensor, scale: int = 2, mode: str = "nearest") -> torch.Tensor:
    """Nearest upsample of H, W by an integer factor; quaternion axis untouched."""
    if mode != "nearest":
        raise ValueError(f"unsupported upsample mode {mode!r}")
    B, H, W, Q, C = x.shape
    y = x[:, :, None, :, None].expand(B, H, scale, W, scale, Q, C)
    return y.reshape(B, H * scale, W * scale, Q, C)
