"""Quaternion convolution and normalization modules (counterpart of the JAX ``models/conv.py``).

Channel counts are in total quaternion-channel space (multiples of 4; each
component has ``C // 4``), and ``c1 == 3`` marks the RGB first layer, which
maps the image to one quaternion channel first. Activations are BHWQC
``[B, H, W, 4, C]``. Parameters stay float32; ``dtype`` is the compute dtype
(None: the input's).

Parameter names follow the JAX package's flax paths (``conv.w``, ``bn.gamma``,
``bn.mean``, ...) so that ``utils/weights.py`` can carry its variables over.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.kernels.qconv_fused import fold_iqbn, qconv1x1_fused
from quan_ultralytics_tpu_torch.ops.mappings import rgb_to_quaternion
from quan_ultralytics_tpu_torch.ops.mixing import MIX_MATRIX
from quan_ultralytics_tpu_torch.ops.pooling import qupsample
from quan_ultralytics_tpu_torch.ops.qconv import (autopad, fold_dense_kernel, qconv2d, qconv2d_folded,
                                                  qconv2d_int8, qdense)
from quan_ultralytics_tpu_torch.parallel.mesh import active_mesh

IntOr2 = Union[int, Tuple[int, int]]

# Per-(mapping, component) init scale factors, reference conv.py:237-245.
SCALE_FACTORS = {
    "luminance": (1.0, 1.0, 1.0, 1.0),
    "mean_brightness": (1.0, 0.75, 0.75, 0.75),
    "raw_normalized": (1.0, 1.0, 1.0, 1.0),
    "hamilton": (1.0, 1.0, 1.0, 1.0),
    "poincare": (1.0, 1.0, 1.0, 1.0),
}
_DEFAULT_SCALES = (0.5, 0.5, 0.5, 0.5)

# `auto` folds a layer whose per-component C_out is below this threshold:
# FOLD_MAX_TRAIN inside `train_graph()`, FOLD_MAX_EVAL everywhere else (the
# JAX package's rule; its TPU values are 32 and 128). Set from device busy ms
# on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 35, mean of two rounds):
# QUAN-YOLO11n-OBB's infer @1024, batch 8, bf16 takes 10.09 ms at 128, 10.63
# at 64, 11.68 at 32, 15.67 at 16, 10.10 folded and 17.98 grouped; its train
# micro-step 48.26 ms at 128 (53.90 at 32, 74.30 grouped); a Q-WRN-16-2 step
# at batch 128 @32 4.84 ms at 128 (5.42 at 32, 7.95 grouped). The mixing pass
# that `grouped` adds is an elementwise chain over the whole activation, and
# at these widths (C_out 4-96 a component) the 4x FLOPs of folding are cheap.
FOLD_MAX_EVAL = 128
FOLD_MAX_TRAIN = 128

# Whether the forward running now builds the detection trainer's graph (the
# JAX package's `train_graph()`, which only its detection trainer enters): a
# context variable, so each thread sees its own value and the caller's comes
# back on exit, also after an exception.
_TRAIN_GRAPH = contextvars.ContextVar("quan_torch_train_graph", default=False)


@contextlib.contextmanager
def train_graph():
    """Mark the forwards run inside as the detection trainer's: `auto` convs
    fold up to ``FOLD_MAX_TRAIN`` there, as they do inside the JAX package's
    ``train_graph()``. ``module.training`` alone does not change the form."""
    token = _TRAIN_GRAPH.set(True)
    try:
        yield
    finally:
        _TRAIN_GRAPH.reset(token)


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class QConv2D(nn.Module):
    """Separable quaternion 2D convolution (reference conv.py:70-499).

    ``w``: ``[4, C_out/4, C_in/4/g, kH, kW]``, one OIHW kernel per component,
    initialized like the reference's per-component scaled kaiming-uniform.
    ``b``: optional real bias ``[C_out/4]``. ``impl``: ``grouped`` (one conv
    with groups 4g, then the mixing), ``folded`` (the mixing folded into one
    dense kernel; g == 1 only) or ``auto`` (folded when C_out/4 is below the
    fold threshold and g == 1, else grouped; the threshold is
    ``FOLD_MAX_TRAIN`` inside `train_graph`, else ``FOLD_MAX_EVAL``). The three
    give the same values. ``int8`` is the inference-only serving form
    (`qconv2d_int8`, the JAX ``QUAN_QCONV_IMPL=int8``): an ungrouped conv with
    ``c2 >= int8_min_c`` (JAX's ``QUAN_INT8_MIN_C``) quantizes its folded
    kernel and its input; narrower ones run folded, grouped ones grouped.
    Its activation scale is the ``act_absmax`` buffer that
    `ops.quant.calibrate_int8` adds (static), else each call's |x| max. The
    buffer exists only after calibration, so an uncalibrated state dict is
    unchanged.
    """

    def __init__(self, c1: int, c2: int, k: IntOr2 = 1, s: IntOr2 = 1,
                 p: Optional[IntOr2] = None, g: int = 1, d: IntOr2 = 1,
                 use_bias: bool = True, mapping_type: str = "poincare",
                 dtype: Optional[torch.dtype] = None, impl: str = "grouped",
                 int8_min_c: int = 0):
        super().__init__()
        if c2 % 4:
            raise ValueError(f"c2={c2} must be a multiple of 4")
        if c1 != 3 and c1 % 4:
            raise ValueError(f"c1={c1} must be a multiple of 4 (or 3 for RGB)")
        if impl not in ("grouped", "folded", "auto", "int8"):
            raise ValueError(f"unknown impl {impl!r}")
        self.c1, self.c2, self.g = c1, c2, g
        self.k, self.s, self.d = _pair(k), _pair(s), _pair(d)
        self.pad = autopad(k, p, d)
        self.mapping_type = mapping_type
        self.dtype = dtype
        self.impl = impl
        self.int8_min_c = int8_min_c
        self.calibrating = False  # `ops.quant.calibrate_int8` collects |x| max into `calib_absmax`
        self.calib_absmax: Optional[torch.Tensor] = None
        cin = 1 if c1 == 3 else c1 // 4
        if cin % g:
            raise ValueError(f"per-component c1 {cin} is not divisible by g={g}")
        self.cin, self.cout = cin, c2 // 4
        self.w = nn.Parameter(torch.empty(4, self.cout, cin // g, *self.k))
        self.b = nn.Parameter(torch.empty(self.cout)) if use_bias else None
        # kept on the module's device: a host-to-device copy of it on every
        # folded call would make the host wait for the card each time
        self.register_buffer("mix", torch.tensor(MIX_MATRIX), persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        scales = SCALE_FACTORS.get(self.mapping_type, _DEFAULT_SCALES)
        fan_in = self.k[0] * self.k[1] * (self.cin // self.g)
        with torch.no_grad():
            for i, s in enumerate(scales):
                a = math.sqrt(5.0) * s
                bound = math.sqrt(3.0) * math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(max(fan_in, 1))
                nn.init.uniform_(self.w[i], -bound, bound, generator=generator)
            if self.b is not None:
                bound = scales[0] / math.sqrt(max(fan_in, 1))
                nn.init.uniform_(self.b, -bound, bound, generator=generator)

    def _impl(self) -> str:
        if self.impl == "int8":
            return "folded" if self.c2 < self.int8_min_c else "int8"
        if self.impl != "auto":
            return self.impl
        fold_max = FOLD_MAX_TRAIN if _TRAIN_GRAPH.get() else FOLD_MAX_EVAL
        return "folded" if (self.cout < fold_max and self.g == 1) else "grouped"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.c1 == 3:
            if x.ndim != 4 or x.shape[-1] != 3:
                raise ValueError(f"RGB first layer expects NHWC, got {tuple(x.shape)}")
            # the mapping runs in the compute dtype, as in the JAX package
            x = rgb_to_quaternion(x.to(self.dtype or x.dtype), self.mapping_type)
        elif x.shape[-1] != self.cin or x.shape[-2] != 4:
            raise ValueError(f"expected [..., 4, {self.cin}], got {tuple(x.shape)}")
        x = x.to(self.dtype or x.dtype)
        impl = self._impl()
        if impl == "int8" and self.g == 1:
            dk = fold_dense_kernel(self.w, self.mix)
            return qconv2d_int8(x, dk, self.b, stride=self.s, padding=self.pad, dilation=self.d,
                                act_absmax=self._int8_act_absmax(x))
        if impl == "folded" and self.g == 1:
            dk = fold_dense_kernel(self.w, self.mix)
            return qconv2d_folded(x, dk, self.b, stride=self.s, padding=self.pad, dilation=self.d)
        return qconv2d(x, self.w, self.b, stride=self.s, padding=self.pad, dilation=self.d,
                       groups=self.g)


    def _int8_act_absmax(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The int8 activation scale's |x| max (the JAX ``_int8_act_absmax``):
        while calibrating, the running max is updated and the call runs with
        its own (dynamic) scale; after calibration the stored one."""
        if self.calibrating:
            m = x.detach().abs().amax().float()
            self.calib_absmax = m if self.calib_absmax is None else torch.maximum(self.calib_absmax, m)
            return None
        return getattr(self, "act_absmax", None)


class IQBN(nn.Module):
    """Independent Quaternion Batch Norm (reference conv.py:501-571).

    Separate statistics and affine per (component, channel): ``gamma``,
    ``beta`` and the running ``mean``, ``var`` are ``[4, C/4]``. Training takes
    batch statistics over (B, H, W) with the biased variance plus the
    reference's extra 1e-8, which feeds both the running update and the
    normalization. The affine ``scale, shift`` is computed in f32 and cast to
    the compute dtype before it is applied. Inside `parallel.mesh.data_parallel`
    the statistics are the global batch's over every rank (DEVIATIONS.md
    section 2: JAX normalises with the sharded batch's global moments), so the
    running ``mean`` and ``var`` come out equal on every rank.
    """

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if c % 4:
            raise ValueError(f"c={c} must be a multiple of 4")
        C = c // 4
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.gamma = nn.Parameter(torch.ones(4, C))
        self.beta = nn.Parameter(torch.zeros(4, C))
        self.register_buffer("mean", torch.zeros(4, C))
        self.register_buffer("var", torch.ones(4, C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            mesh = active_mesh()
            if mesh is None:
                mean = xf.mean(dim=(0, 1, 2))
                var = xf.var(dim=(0, 1, 2), unbiased=False) + 1e-8
            else:  # the global batch's moments, as JAX's GSPMD reduction over a sharded batch
                mean, var = mesh.global_moments(xf)
                var = var + 1e-8
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1.0 - m).add_(m * mean)
                self.var.mul_(1.0 - m).add_(m * var)
        else:
            mean, var = self.mean, self.var
        dtype = self.dtype or x.dtype
        inv = torch.rsqrt(var + self.eps)
        scale = (self.gamma * inv).to(dtype)
        shift = (self.beta - self.gamma * mean * inv).to(dtype)
        return x.to(dtype) * scale + shift


class IQLN(nn.Module):
    """Quaternion layer norm (reference conv.py:588-611): per sample and
    component, normalized over (H, W, C) with the biased variance in f32, then
    ``weight`` and ``bias`` (``[4, C/4]``); returned in the input's dtype."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        if c % 4:
            raise ValueError(f"c={c} must be a multiple of 4")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(4, c // 4))
        self.bias = nn.Parameter(torch.zeros(4, c // 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 4), keepdim=True)
        var = xf.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Conv(nn.Module):
    """QConv2D + IQBN + SiLU, the universal block (reference conv.py:788-813).

    ``fused_1x1``: in eval, a 1x1, stride-1, unpadded, ungrouped, non-RGB conv
    runs as one fused conv + mixing + folded-IQBN + SiLU kernel
    (`qconv1x1_fused`), the counterpart of the JAX package's ``QUAN_FUSED_1X1``.
    The parameters are the same either way.
    """

    def __init__(self, c1: int, c2: int, k: IntOr2 = 1, s: IntOr2 = 1,
                 p: Optional[IntOr2] = None, g: int = 1, d: IntOr2 = 1, act: bool = True,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None,
                 impl: str = "grouped", fused_1x1: bool = False):
        super().__init__()
        self.conv = QConv2D(c1, c2, k, s, p, g, d, use_bias=False, mapping_type=mapping_type,
                            dtype=dtype, impl=impl)
        self.bn = IQBN(c2, dtype=dtype)
        self.act = act
        self.dtype = dtype
        self.fused = (fused_1x1 and _pair(k) == (1, 1) and _pair(s) == (1, 1)
                      and p in (None, 0, (0, 0)) and g == 1 and c1 != 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not self.training:
            bn = self.bn
            scale, shift = fold_iqbn(bn.gamma, bn.beta, bn.mean, bn.var, bn.eps)
            return qconv1x1_fused(x.to(self.dtype or x.dtype), self.conv.w, scale, shift,
                                  apply_silu=self.act)
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act else y


def DWConv(c1: int, c2: int, k: IntOr2 = 1, s: IntOr2 = 1, d: IntOr2 = 1, act: bool = True,
           **kw) -> Conv:
    """Depth-wise quaternion conv: groups = gcd(c1//4, c2//4) (reference conv.py:918-923)."""
    return Conv(c1, c2, k, s, g=math.gcd(c1 // 4, c2 // 4), d=d, act=act, **kw)


class QUpsample(nn.Module):
    """Nearest upsample over BHWQC (reference conv.py:1218-1246)."""

    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        self.scale, self.mode = scale, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qupsample(x, self.scale, self.mode)


class QDense(nn.Module):
    """Quaternion dense layer with the full Hamilton product (reference
    classification/quaternion/qconv.py:878-998) on ``[..., 4, f_in / 4]``.

    ``w``: ``[4, f_in/4, f_out/4]`` and ``b``: ``[4, f_out/4]``, float32,
    drawn per component like the JAX initializer: ``w`` uniform within
    ``sqrt(3) * sqrt(2 / (1 + 5 s^2)) / sqrt(fi)``, ``b`` within ``s / sqrt(fi)``,
    with ``s`` the mapping's scale factor of the component.
    """

    def __init__(self, f_in: int, f_out: int, use_bias: bool = True,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if f_in % 4 or f_out % 4:
            raise ValueError(f"f_in={f_in} and f_out={f_out} must be multiples of 4")
        self.fi, self.fo = f_in // 4, f_out // 4
        self.mapping_type, self.dtype = mapping_type, dtype
        self.w = nn.Parameter(torch.empty(4, self.fi, self.fo))
        self.b = nn.Parameter(torch.empty(4, self.fo)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        scales = SCALE_FACTORS.get(self.mapping_type, _DEFAULT_SCALES)
        with torch.no_grad():
            for i, s in enumerate(scales):
                a = math.sqrt(5.0) * s
                bound = math.sqrt(3.0) * math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(self.fi)
                nn.init.uniform_(self.w[i], -bound, bound, generator=generator)
            if self.b is not None:
                for i, s in enumerate(scales):
                    bound = s / math.sqrt(self.fi)
                    nn.init.uniform_(self.b[i], -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.fi or x.shape[-2] != 4:
            raise ValueError(f"expected [..., 4, {self.fi}], got {tuple(x.shape)}")
        return qdense(x.to(self.dtype or x.dtype), self.w, self.b)
