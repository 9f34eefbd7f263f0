"""Quaternion classification models: the Q-WRN and Q-ResNet families
(counterpart of the JAX ``classification/models.py``).

Reference: classification/models/quaternion_models.py (QWideResNet :12-90,
QResNet34 :92-255, ImageNet variants :336-511) and quaternion_blocks.py. All
use pre-activation (IQBN -> SiLU -> QConv2D) residual blocks and classify by
the norm of each class's output quaternion, taken over the true quaternion
axis (the JAX package's reading of the reference's flattened norm).

Inputs are RGB ``[B, H, W, 3]``; the first QConv2D maps them to quaternions.
Parameters are float32 and ``dtype`` is the compute dtype (None: the
input's). Submodule names are the flax names (``conv1``,
``stage{s}_block{b}``, ``bn``, ``classifier``, ``stem_conv``, ``stem_bn``,
``fc1``, ``fc2``), so `utils.weights` carries weights across by name.

Two dropouts, as in the JAX package: `Dropout` (flax ``nn.Dropout``:
element-wise, kept values scaled by ``1 / (1 - p)``) in the wide blocks and
before the ImageNet heads, and `QuaternionDropout` (whole quaternions, no
rescale) in `QuaternionBasicBlock`. Both draw from their ``generator``
attribute (`set_generator`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.models.block import QuaternionDropout
from quan_ultralytics_tpu_torch.models.conv import IQBN, QConv2D, QDense
from quan_ultralytics_tpu_torch.ops.pooling import qavg_pool_global, qmax_pool


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train, each element kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``; the identity in eval or at ``p = 0``."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every dropout of ``model`` draw its masks from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, (Dropout, QuaternionDropout)):
            mod.generator = generator


def _conv(c1, c2, k, s=1, p=None, mapping_type="poincare", dtype=None):
    # `auto` at models/conv.py's thresholds folds every layer of Q-WRN-16-2 (C_out at
    # most 32 a component): a step at batch 128 takes 4.84 ms of device time so, 7.95
    # grouped (the JAX library's default) on an H100 80GB HBM3 (chip_smoke.py phase 35)
    return QConv2D(c1, c2, k, s, p, mapping_type=mapping_type, dtype=dtype, impl="auto")


class QWideBasicBlock(nn.Module):
    """Pre-activation wide block (reference quaternion_blocks.py:7-49). The
    shortcut (projection or identity) takes the pre-activated input."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, drop_rate: float = 0.0,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(mapping_type=mapping_type, dtype=dtype)
        self.bn1 = IQBN(c_in, dtype=dtype)
        self.shortcut = (_conv(c_in, c_out, 1, stride, **kw)
                         if stride != 1 or c_in != c_out else None)
        self.conv1 = _conv(c_in, c_out, 3, stride, 1, **kw)
        self.bn2 = IQBN(c_out, dtype=dtype)
        self.drop = Dropout(drop_rate) if drop_rate > 0 else None
        self.conv2 = _conv(c_out, c_out, 3, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(x))
        residual = self.shortcut(h) if self.shortcut is not None else h
        y = F.silu(self.bn2(self.conv1(h)))
        if self.drop is not None:
            y = self.drop(y)
        return self.conv2(y) + residual


class QuaternionBasicBlock(nn.Module):
    """Pre-activation ResNet block (reference quaternion_blocks.py:61-155).
    The shortcut takes the raw input."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, drop_rate: float = 0.0,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(mapping_type=mapping_type, dtype=dtype)
        self.shortcut = (_conv(c_in, c_out, 1, stride, **kw)
                         if stride != 1 or c_in != c_out else None)
        self.bn1 = IQBN(c_in, dtype=dtype)
        self.conv1 = _conv(c_in, c_out, 3, stride, 1, **kw)
        self.bn2 = IQBN(c_out, dtype=dtype)
        self.drop = QuaternionDropout(drop_rate) if drop_rate > 0 else None
        self.conv2 = _conv(c_out, c_out, 3, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.shortcut(x) if self.shortcut is not None else x
        y = F.silu(self.bn1(x))
        y = F.silu(self.bn2(self.conv1(y)))
        if self.drop is not None:
            y = self.drop(y)
        return self.conv2(y) + identity


def quaternion_norm_logits(x: torch.Tensor) -> torch.Tensor:
    """``[B, 4, nc]`` quaternion features -> ``[B, nc]`` float32 norms (the class logits)."""
    return torch.sqrt(torch.clamp((x.float() ** 2).sum(dim=-2), min=1e-12))


class _Stages(nn.Module):
    """Shared forward of the families: stem, ``stage{s}_block{b}`` blocks, head."""

    def _add_stages(self, block, widths: Sequence[int], blocks: Sequence[int],
                    strides: Sequence[int], cin: int, drop_rate: float, mapping_type: str,
                    dtype: Optional[torch.dtype]) -> None:
        self.block_names = []
        for s, (w, nb, stride) in enumerate(zip(widths, blocks, strides)):
            for b in range(nb):
                name = f"stage{s + 1}_block{b}"
                self.add_module(name, block(cin if b == 0 else w, w, stride if b == 0 else 1,
                                            drop_rate, mapping_type, dtype))
                self.block_names.append(name)
            cin = w

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class QWideResNet(_Stages):
    """WRN-depth-k (reference quaternion_models.py:12-90): a 16-wide stem conv,
    three wide stages of ``(depth - 4) / 6`` blocks at 16k, 32k, 64k, IQBN,
    SiLU, global average pool and a QDense classifier."""

    def __init__(self, depth: int = 16, width: int = 2, num_classes: int = 10,
                 drop_rate: float = 0.0, mapping_type: str = "poincare",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n, k = (depth - 4) // 6, width
        stages = [16, 16 * k, 32 * k, 64 * k]
        self.conv1 = _conv(3, stages[0], 3, 1, 1, mapping_type, dtype)
        self._add_stages(QWideBasicBlock, stages[1:], (n, n, n), (1, 2, 2), stages[0],
                         drop_rate, mapping_type, dtype)
        self.bn = IQBN(stages[3], dtype=dtype)
        self.classifier = QDense(stages[3], num_classes * 4, mapping_type=mapping_type, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._blocks(self.conv1(x))
        x = qavg_pool_global(F.silu(self.bn(x)), keepdims=False)  # [B, 4, C]
        return quaternion_norm_logits(self.classifier(x))


class QResNetCIFAR(_Stages):
    """CIFAR Q-ResNet-18/34 (reference quaternion_models.py:92-255): a
    ``base_width`` stem, three stages, a two-layer QDense head."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6), num_classes: int = 10,
                 drop_rate: float = 0.0, base_width: int = 16, mapping_type: str = "poincare",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bw = base_width
        widths = [bw, bw * 2, bw * 4]
        self.stem_conv = _conv(3, bw, 3, 1, 1, mapping_type, dtype)
        self.stem_bn = IQBN(bw, dtype=dtype)
        self._add_stages(QuaternionBasicBlock, widths, blocks, (1, 2, 2), bw, drop_rate,
                         mapping_type, dtype)
        self.fc1 = QDense(widths[-1], 256, mapping_type=mapping_type, dtype=dtype)
        self.fc2 = QDense(256, num_classes * 4, mapping_type=mapping_type, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._blocks(F.silu(self.stem_bn(self.stem_conv(x))))
        x = F.silu(self.fc1(qavg_pool_global(x, keepdims=False)))
        return quaternion_norm_logits(self.fc2(x))


class _ImageNetNet(_Stages):
    """7x7/2 stem + IQBN + SiLU + 3x3/2 max pool, the stages, global pool,
    dropout 0.5 and a QDense classifier."""

    def _stem_and_head(self, bw: int, c_last: int, num_classes: int, mapping_type: str,
                       dtype: Optional[torch.dtype]) -> None:
        self.stem_conv = _conv(3, bw, 7, 2, 3, mapping_type, dtype)
        self.stem_bn = IQBN(bw, dtype=dtype)
        self.head_drop = Dropout(0.5)
        self.classifier = QDense(c_last, num_classes * 4, mapping_type=mapping_type, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = qmax_pool(F.silu(self.stem_bn(self.stem_conv(x))), 3, 2, 1)
        x = qavg_pool_global(self._blocks(x), keepdims=False)
        return quaternion_norm_logits(self.classifier(self.head_drop(x)))


class QResNetImageNet(_ImageNetNet):
    """ImageNet Q-ResNet-34 (reference quaternion_models.py:173-255): four
    stages of `QuaternionBasicBlock` at base_width x (1, 2, 4, 8)."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 drop_rate: float = 0.1, base_width: int = 64, mapping_type: str = "poincare",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bw = base_width
        widths = [bw, bw * 2, bw * 4, bw * 8]
        self._stem_and_head(bw, widths[-1], num_classes, mapping_type, dtype)
        self._add_stages(QuaternionBasicBlock, widths, blocks, (1, 2, 2, 2), bw, drop_rate,
                         mapping_type, dtype)


class QWideResNetImageNet(_ImageNetNet):
    """ImageNet WRN-50-k (reference quaternion_models.py:256-313): a 64-wide
    stem, `QWideBasicBlock` stages (3, 4, 6, 3) at 64 k 2^s."""

    def __init__(self, width_factor: int = 2, num_classes: int = 1000, drop_rate: float = 0.2,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None):
        super().__init__()
        bw = 64
        widths = [bw * width_factor * (2 ** i) for i in range(4)]
        self._stem_and_head(bw, widths[-1], num_classes, mapping_type, dtype)
        self._add_stages(QWideBasicBlock, widths, (3, 4, 6, 3), (1, 2, 2, 2), bw, drop_rate,
                         mapping_type, dtype)


class QWRN16ImageNet(_ImageNetNet):
    """ImageNet WRN-16 (reference QWRN16_4I, quaternion_models.py:512-569): a
    64-wide stem, three wide stages of 2 blocks at 64 k (1, 2, 4)."""

    def __init__(self, width_factor: int = 2, num_classes: int = 1000, drop_rate: float = 0.2,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None):
        super().__init__()
        bw, k = 64, width_factor
        widths = [bw * k, bw * 2 * k, bw * 4 * k]
        self._stem_and_head(bw, widths[-1], num_classes, mapping_type, dtype)
        self._add_stages(QWideBasicBlock, widths, (2, 2, 2), (1, 2, 2), bw, drop_rate,
                         mapping_type, dtype)


MODEL_FACTORIES: Dict[str, Callable[..., nn.Module]] = {
    # reference CLI names (classification.py:43-291)
    "qwrn16_2": lambda nc, drop, mt, dtype=None: QWideResNet(16, 2, nc, drop, mt, dtype),
    "qwrn16_4": lambda nc, drop, mt, dtype=None: QWideResNet(16, 4, nc, drop, mt, dtype),
    "qwrn16_8": lambda nc, drop, mt, dtype=None: QWideResNet(16, 8, nc, drop, mt, dtype),
    "qrn18": lambda nc, drop, mt, dtype=None: QResNetCIFAR((2, 2, 2), nc, drop, 16, mt, dtype),
    "qrn34": lambda nc, drop, mt, dtype=None: QResNetCIFAR((3, 4, 6), nc, drop, 16, mt, dtype),
    "qrn34_imagenet": lambda nc, drop, mt, dtype=None: QResNetImageNet((3, 4, 6, 3), nc, drop, 64, mt,
                                                                       dtype),
    "qrn18_i": lambda nc, drop, mt, dtype=None: QResNetImageNet((2, 2, 2, 2), nc, drop, 64, mt, dtype),
    "qwrn50_2": lambda nc, drop, mt, dtype=None: QWideResNetImageNet(2, nc, drop, mt, dtype),
    "qwrn16_4i": lambda nc, drop, mt, dtype=None: QWRN16ImageNet(2, nc, drop, mt, dtype),
}


def create_model(name: str, num_classes: int, drop_rate: float = 0.0,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A classification model by its reference CLI name, built on the CPU with
    weights drawn from torch's default generator (see `reset_parameters`)."""
    if name not in MODEL_FACTORIES:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODEL_FACTORIES)}")
    return MODEL_FACTORIES[name](num_classes, drop_rate, mapping_type, dtype)


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every QConv2D and QDense weight of ``model`` anew, in module order,
    from ``generator`` (IQBN starts at gamma 1, beta 0, mean 0, var 1)."""
    for mod in model.modules():
        if isinstance(mod, (QConv2D, QDense)):
            mod.reset_parameters(generator)
    return model
