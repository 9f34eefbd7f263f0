"""Quaternion activation functions (counterpart of the JAX ``ops/activations.py``;
reference ultralytics/nn/modules/activation.py:24-127 and
classification/quaternion/qactivation.py).

Two families:

  * split-type: the real activation on every component (``qsilu``, ``qrelu``,
    ``qtanh``, ``qsigmoid``, ``qleaky_relu``, ``qhardtanh``, ``qprelu``); on
    the BHWQC layout these are the elementwise ops;
  * norm-aware: ``qrerelu`` scales each whole quaternion by
    ``relu(|q|) / |q|``, keeping its phase.

The models use plain SiLU, which equals ``qsilu`` here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def qsilu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def qrelu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def qtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def qsigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def qleaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def qhardtanh(x: torch.Tensor, min_val: float = -1.0, max_val: float = 1.0) -> torch.Tensor:
    return torch.clamp(x, min_val, max_val)


def qprelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with a learnable per-channel (or scalar) slope ``alpha``."""
    return torch.where(x >= 0, x, alpha * x)


def qrerelu(x: torch.Tensor, dim: int = -2, eps: float = 1e-8) -> torch.Tensor:
    """Norm-rectifying activation: each quaternion (along ``dim``, the
    component axis of BHWQC) times ``relu(|q|) / (|q| + eps)``, with
    ``|q| = sqrt(sum q^2 + eps)``; components shrink together."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)
    return x * (F.relu(norm) / (norm + eps))


ACTIVATIONS = {
    "silu": qsilu,
    "relu": qrelu,
    "tanh": qtanh,
    "sigmoid": qsigmoid,
    "leaky_relu": qleaky_relu,
    "hardtanh": qhardtanh,
    "rerelu": qrerelu,
}
