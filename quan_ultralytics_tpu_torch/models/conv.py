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
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from quan_ultralytics_tpu_torch.ops.kernels.qconv_fused import fold_iqbn, qconv1x1_fused
from quan_ultralytics_tpu_torch.ops.mappings import rgb_to_quaternion
from quan_ultralytics_tpu_torch.ops.mixing import MIX_MATRIX
from quan_ultralytics_tpu_torch.ops.pooling import qupsample
from quan_ultralytics_tpu_torch.ops.qconv import (autopad, fold_dense_kernel, packed_conv_kernel, packed_pads,
                                                  packed_qconv, qconv2d, qconv2d_folded, qconv2d_int8, qdense)
from quan_ultralytics_tpu_torch.ops.stem import (expand, l0_index, l0_s2d4_index, l1_index,
                                                 packed_index, s2d4_rgb_mapped)
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

    The stem forms (ops/stem.py; the parameters are the plain conv's,
    rearranged at apply time by one gather through the ``stem_index`` buffer):

    * ``stem_mode="phase_out"``: layer 0 of the phase-composite stem, a k=3,
      s=2 conv whose output is space-to-depth packed phase-major (on the RGB
      layer the input is packed by 4 first, `ops.stem.s2d4_rgb_mapped`);
      ``"phase_in"``: layer 1, consuming that packing. Grouped or folded as
      ``impl`` resolves (int8: grouped, as in JAX).
    * ``packed="out" | "in" | "both"``: the deep-packed stem's channel-major
      r=2 packing of the output, the input or both (`ops.qconv.qconv2d_packed`,
      ``packed_impl``: ``folded``, ``grouped`` or ``int8``; None: ``int8`` when
      ``impl`` is, else ``folded``, as JAX's ``QUAN_PACKED_IMPL``). On the RGB
      layer ``stem_l0`` picks the input: ``"prepack"`` (packed by 4) or
      ``"fine"`` (the mapped image as it is: a k=5, s=4 conv), JAX's
      ``QUAN_STEM_L0``.
    * ``stem_remat`` (RGB layer, training under grad): the mapping and the
      conv run inside one `torch.utils.checkpoint`, so the backward recomputes
      the mapped image instead of keeping it (JAX's ``QUAN_STEM_REMAT``; the
      JAX package wraps the deep-packed layer 0 so, and the port every form of
      layer 0).

    In eval without grad, the expanded (and folded) kernel of a stem form is
    kept and reused until the weights change (their version counter).
    """

    def __init__(self, c1: int, c2: int, k: IntOr2 = 1, s: IntOr2 = 1,
                 p: Optional[IntOr2] = None, g: int = 1, d: IntOr2 = 1,
                 use_bias: bool = True, mapping_type: str = "poincare",
                 dtype: Optional[torch.dtype] = None, impl: str = "grouped",
                 int8_min_c: int = 0, stem_mode: Optional[str] = None,
                 packed: Optional[str] = None, stem_l0: str = "prepack",
                 stem_remat: bool = False, packed_impl: Optional[str] = None):
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
        self.stem_remat = stem_remat
        self._init_stem(stem_mode, packed, stem_l0, packed_impl)
        self.reset_parameters()

    def _init_stem(self, stem_mode, packed, stem_l0, packed_impl) -> None:
        """The stem form's geometry and index map (see the class docstring)."""
        self.stem_mode, self.packed, self.packed_impl = stem_mode, packed, packed_impl
        self.stem = None
        self._kernel_cache = None
        if stem_mode is None and packed is None:
            return
        if stem_mode is not None and packed is not None:
            raise ValueError("stem_mode and packed exclude each other")
        if stem_mode not in (None, "phase_out", "phase_in") or packed not in (None, "in", "out", "both"):
            raise ValueError(f"unknown stem_mode {stem_mode!r} or packed {packed!r}")
        if stem_l0 not in ("prepack", "fine"):
            raise ValueError(f"unknown stem_l0 {stem_l0!r}")
        if packed_impl not in (None, "folded", "grouped", "int8"):
            raise ValueError(f"unknown packed_impl {packed_impl!r}")
        if self.g != 1 or self.d != (1, 1) or self.s[0] != self.s[1] or self.pad[0] != self.pad[1]:
            raise ValueError("a stem form takes g=1, d=1 and a square stride and padding")
        first = self.c1 == 3
        if stem_mode is not None:
            if self.k != (3, 3) or self.s != (2, 2):
                raise ValueError(f"stem_mode {stem_mode!r} takes k=3, s=2")
            # phase_out: expand_w_l0 (k=5, s=4), on the RGB layer the r=4
            # prepack and expand_w_l0_s2d4; phase_in: expand_w_l1
            if stem_mode == "phase_in":
                ri, ro, pl, S, idx = 2, 1, 1, 1, l1_index(self.cout, self.cin)
            elif first:
                ri, ro, pl, S, idx = 4, 2, 1, 1, l0_s2d4_index(self.cout, self.cin)
            else:
                ri, ro, pl, S, idx = 1, 2, 1, 4, l0_index(self.cout, self.cin)
        else:
            ri, ro = {"in": (2, 1), "out": (1, 2), "both": (2, 2)}[packed]
            if first:
                ri = 4 if stem_l0 == "prepack" else 1
            idx, pl, S = packed_index(self.cout, self.cin, *self.k, self.s[0], self.pad[0], ri, ro)
        self.stem = {"ri": ri, "ro": ro, "pl": pl, "S": S, "KH": idx.shape[3], "KW": idx.shape[4]}
        self.register_buffer("stem_index", torch.as_tensor(idx), persistent=False)

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

    def _stem_impl(self) -> str:
        if self.stem_mode is not None:  # the JAX phase convs are grouped; folded where the port folds
            return "folded" if self._impl() == "folded" else "grouped"
        impl = self.packed_impl or ("int8" if self.impl == "int8" else "folded")
        return "folded" if impl == "int8" and self.c2 < self.int8_min_c else impl

    def _stem_kernel(self, impl: str, dtype: torch.dtype) -> torch.Tensor:
        """The stem form's conv kernel (`packed_conv_kernel` of the expanded
        weights), in ``dtype`` (int8: f32, quantized by the conv). Kept in eval
        without grad, against the weights' version, pointer, device and dtype."""
        w = self.w
        keep = (not (torch.is_grad_enabled() and w.requires_grad) and w.device.type != "meta"
                and not torch.compiler.is_compiling() and not is_fake(w))
        key = (impl, dtype, w._version, w.data_ptr(), w.device) if keep else None
        if keep and self._kernel_cache is not None and self._kernel_cache[0] == key:
            return self._kernel_cache[1]
        kernel = packed_conv_kernel(expand(w, self.stem_index), self.mix, impl)
        kernel = kernel.float() if impl == "int8" else kernel.to(dtype)
        self._kernel_cache = (key, kernel) if keep else None
        return kernel

    def _stem_conv(self, x: torch.Tensor, impl: str) -> torch.Tensor:
        st = self.stem
        pr_h, pr_w = packed_pads(x.shape[1], x.shape[2], self.k, self.s[0], self.pad, st["ri"], st["ro"],
                                 st["KH"], st["KW"], st["pl"], st["S"])
        b = self.b
        if b is not None and st["ro"] > 1:  # the bias repeats over the output's phases
            b = b.repeat(4) if self.stem_mode == "phase_out" else b.repeat_interleave(4)
        return packed_qconv(x, self._stem_kernel(impl, x.dtype), b, stride=st["S"], pl=st["pl"],
                            pr_h=pr_h, pr_w=pr_w, impl=impl,
                            act_absmax=self._int8_act_absmax(x) if impl == "int8" else None)

    def _map(self, x: torch.Tensor) -> torch.Tensor:
        """The RGB layer's mapping, in the compute dtype as in the JAX package:
        ``[B, H, W, 4, 1]``, or packed by 4 (``[B, H/4, W/4, 4, 16]``) for a stem form
        whose input is (`ops.stem.s2d4_rgb_mapped`)."""
        x = x.to(self.dtype or x.dtype)
        if self.stem is not None and self.stem["ri"] == 4:
            return s2d4_rgb_mapped(x, self.mapping_type)
        return rgb_to_quaternion(x, self.mapping_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.c1 == 3:
            if x.ndim != 4 or x.shape[-1] != 3:
                raise ValueError(f"RGB first layer expects NHWC, got {tuple(x.shape)}")
            if self.stem_remat and self.training and torch.is_grad_enabled():
                # mapping and conv in one checkpoint: the mapped image is recomputed, not kept
                return checkpoint(lambda t: self._conv(self._map(t)), x, use_reentrant=False)
            return self._conv(self._map(x))
        want = self.cin * (4 if self.stem_mode == "phase_in" or self.packed in ("in", "both") else 1)
        if x.shape[-1] != want or x.shape[-2] != 4:
            raise ValueError(f"expected [..., 4, {want}], got {tuple(x.shape)}")
        return self._conv(x)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype)
        if self.stem is not None:
            return self._stem_conv(x, self._stem_impl())
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

    ``phase_packed`` / ``packed_cmajor``: the input is the stem's space-to-depth
    packing ``[..., 4, 4C]``, phase-major ``(a, b, c)`` or channel-major ``(c,
    a, b)`` (ops/stem.py). The statistics reduce over the phases too, which
    gives the unpacked ones (the phases partition the positions), and the
    affine is tiled or repeated over them.
    """

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None, phase_packed: bool = False,
                 packed_cmajor: bool = False):
        super().__init__()
        if c % 4:
            raise ValueError(f"c={c} must be a multiple of 4")
        C = c // 4
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.phase_packed, self.packed_cmajor = phase_packed, packed_cmajor
        self.gamma = nn.Parameter(torch.ones(4, C))
        self.beta = nn.Parameter(torch.zeros(4, C))
        self.register_buffer("mean", torch.zeros(4, C))
        self.register_buffer("var", torch.ones(4, C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.phase_packed or self.packed_cmajor
        if self.training:
            xf, dims = x.float(), (0, 1, 2)
            if packed:
                B, H, W, Q, C4 = xf.shape
                C = C4 // 4
                xf = xf.reshape(B, H, W, Q, C, 4) if self.packed_cmajor else xf.reshape(B, H, W, Q, 4, C)
                dims = (0, 1, 2, 5) if self.packed_cmajor else (0, 1, 2, 4)
            mesh = active_mesh()
            if mesh is None:
                mean = xf.mean(dim=dims)
                var = xf.var(dim=dims, unbiased=False) + 1e-8
            else:  # the global batch's moments, as JAX's GSPMD reduction over a sharded batch
                mean, var = mesh.global_moments(xf, dims)
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
        if self.phase_packed:
            scale, shift = scale.repeat(1, 4), shift.repeat(1, 4)
        elif self.packed_cmajor:
            scale, shift = scale.repeat_interleave(4, dim=-1), shift.repeat_interleave(4, dim=-1)
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

    ``stem_mode``, ``packed`` and the stem options go to the `QConv2D` (and the
    packing to the `IQBN`); a stem-form layer never takes the fused kernel,
    as in JAX.
    """

    def __init__(self, c1: int, c2: int, k: IntOr2 = 1, s: IntOr2 = 1,
                 p: Optional[IntOr2] = None, g: int = 1, d: IntOr2 = 1, act: bool = True,
                 mapping_type: str = "poincare", dtype: Optional[torch.dtype] = None,
                 impl: str = "grouped", fused_1x1: bool = False, stem_mode: Optional[str] = None,
                 packed: Optional[str] = None, **stem):
        super().__init__()
        self.conv = QConv2D(c1, c2, k, s, p, g, d, use_bias=False, mapping_type=mapping_type,
                            dtype=dtype, impl=impl, stem_mode=stem_mode, packed=packed, **stem)
        self.bn = IQBN(c2, dtype=dtype, phase_packed=stem_mode == "phase_out",
                       packed_cmajor=packed in ("out", "both"))
        self.act = act
        self.dtype = dtype
        self.fused = (fused_1x1 and _pair(k) == (1, 1) and _pair(s) == (1, 1)
                      and p in (None, 0, (0, 0)) and g == 1 and c1 != 3
                      and stem_mode is None and packed is None)

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
