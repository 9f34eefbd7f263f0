"""Heads: QER and QERPreserve extraction, Detect, HybridDetect, OBB, Segment,
Pose and Classify (counterpart of the JAX ``models/head.py``).

The heads return raw per-level maps; decoding to boxes is a separate
function (`decode_detect`, `decode_obb`, `decode_segment`, `decode_pose`),
as in the JAX package. Submodule names follow its flax names (``cv2_0_0``,
``detect``, ``proto``, ``proj``, ...).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.models.block import Proto, dfl
from quan_ultralytics_tpu_torch.models.conv import Conv, DWConv
from quan_ultralytics_tpu_torch.ops.boxes import dist2bbox, dist2rbox, make_anchors
from quan_ultralytics_tpu_torch.ops.qconv import to_nchw


class QER(nn.Module):
    """Quaternion-to-Real extraction (reference head.py:26-47): flatten the
    quaternion axis into channels, q-major ``[B, H, W, 4C]``, and apply a real
    conv with bias that learns the component mixing. Returns ``[B, H, W, c2]``.

    ``proj`` is an ``nn.Conv2d`` (OIHW); its init follows flax's ``nn.Conv``
    default (lecun-normal kernel), the bias is ``bias_init_value`` or 0.
    ``dtype`` None computes in the promotion of the input and parameter dtypes.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, bias_init_value: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c1, self.dtype = c1, dtype
        self.bias_init_value = bias_init_value
        self.proj = nn.Conv2d(c1, c2, k, padding=k // 2, bias=True)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.proj.weight, self.proj.weight[0].numel(), generator)
            self.proj.bias.fill_(self.bias_init_value or 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _extract(x, self.proj, self.c1, self.dtype)


def _extract(x: torch.Tensor, conv: nn.Conv2d, c1: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``[B, H, W, 4, C]`` flattened q-major to ``4C`` real channels, through
    ``conv`` (with its bias), in ``dtype`` (None: the promotion of the input's
    and the weight's); ``[B, H, W, c2]``."""
    _, _, _, Q, C = x.shape
    if Q * C != c1:
        raise ValueError(f"expected {c1} flattened channels, got {Q * C}")
    dtype = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
    y = F.conv2d(to_nchw(x.to(dtype)), conv.weight.to(dtype), conv.bias.to(dtype), padding=conv.padding)
    return y.permute(0, 2, 3, 1)


class QERPreserve(nn.Module):
    """Quaternion extraction with a learnable mixing (reference head.py:50-83):
    QER's computation with a xavier-normal kernel (flax's ``xavier_normal``: a
    normal truncated at 2 sigma, variance 2 / (fan_in + fan_out)) and a zero
    bias. ``mix`` is an ``nn.Conv2d`` (OIHW; HWIO in the JAX package)."""

    def __init__(self, c1: int, c2: int, k: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c1, self.dtype = c1, dtype
        self.mix = nn.Conv2d(c1, c2, k, padding=k // 2, bias=True)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        w = self.mix.weight
        rf = w[0, 0].numel()
        std = math.sqrt(2.0 / (w.shape[1] * rf + w.shape[0] * rf)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.mix.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _extract(x, self.mix, self.c1, self.dtype)


class Detect(nn.Module):
    """YOLO detect head (reference head.py:87-260).

    Per level: box branch cv2 = Conv, Conv, QER -> 4 reg_max logits; class
    branch cv3 = (DWConv, Conv) x 2, QER -> nc logits. Returns the per-level
    ``[B, H, W, 4 reg_max + nc]`` maps.
    """

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, **kw):
        super().__init__()
        self.nc, self.nl, self.reg_max = nc, len(ch), reg_max
        dtype = kw.get("dtype")
        c2 = max(ch[0] // 2, reg_max * 4)
        c3 = max(ch[0], min(nc, 256))
        for i, c in enumerate(ch):
            setattr(self, f"cv2_{i}_0", Conv(c, c2, 3, **kw))
            setattr(self, f"cv2_{i}_1", Conv(c2, c2, 3, **kw))
            setattr(self, f"cv2_{i}_2", QER(c2, 4 * reg_max, 1, bias_init_value=1.0, dtype=dtype))
            setattr(self, f"cv3_{i}_0a", DWConv(c, c, 3, **kw))
            setattr(self, f"cv3_{i}_0b", Conv(c, c3, 1, **kw))
            setattr(self, f"cv3_{i}_1a", DWConv(c3, c3, 3, **kw))
            setattr(self, f"cv3_{i}_1b", Conv(c3, c3, 1, **kw))
            cls_bias = math.log(5 / nc / (640 / strides[i]) ** 2)
            setattr(self, f"cv3_{i}_2", QER(c3, nc, 1, bias_init_value=cls_bias, dtype=dtype))

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, x in enumerate(xs):
            b = x
            for name in ("cv2_{}_0", "cv2_{}_1", "cv2_{}_2"):
                b = getattr(self, name.format(i))(b)
            c = x
            for name in ("cv3_{}_0a", "cv3_{}_0b", "cv3_{}_1a", "cv3_{}_1b", "cv3_{}_2"):
                c = getattr(self, name.format(i))(c)
            outs.append(torch.cat([b, c], dim=-1))
        return outs


class HybridDetect(nn.Module):
    """Detect with a lighter class branch (reference head.py:287-320): per level
    a box branch cv2 = Conv 3x3, Conv 3x3, QER -> 4 reg_max logits (width
    ``max(ch[0] / 4, 4 reg_max)``) and a class branch cv3 = Conv 3x3, QER -> nc
    logits (width ``max(ch[0], min(nc, 100))``). Its output is Detect's: the
    per-level ``[B, H, W, 4 reg_max + nc]`` maps, so decode, the loss, NMS and
    the validator take it as they take Detect's."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, **kw):
        super().__init__()
        self.nc, self.nl, self.reg_max = nc, len(ch), reg_max
        dtype = kw.get("dtype")
        c2 = max(ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            setattr(self, f"cv2_{i}_0", Conv(c, c2, 3, **kw))
            setattr(self, f"cv2_{i}_1", Conv(c2, c2, 3, **kw))
            setattr(self, f"cv2_{i}_2", QER(c2, 4 * reg_max, 1, bias_init_value=1.0, dtype=dtype))
            setattr(self, f"cv3_{i}_0", Conv(c, c3, 3, **kw))
            cls_bias = math.log(5 / nc / (640 / strides[i]) ** 2)
            setattr(self, f"cv3_{i}_1", QER(c3, nc, 1, bias_init_value=cls_bias, dtype=dtype))

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, x in enumerate(xs):
            b = x
            for name in ("cv2_{}_0", "cv2_{}_1", "cv2_{}_2"):
                b = getattr(self, name.format(i))(b)
            c = getattr(self, f"cv3_{i}_1")(getattr(self, f"cv3_{i}_0")(x))
            outs.append(torch.cat([b, c], dim=-1))
        return outs


class OBB(nn.Module):
    """Oriented-box head (reference head.py:322-354): Detect + an angle branch
    cv4 = Conv, Conv, QER -> ne logits, mapped in f32 to ``(sigmoid - 0.25) pi``.
    Returns ``(feats, angles)``."""

    def __init__(self, nc: int, ch: Sequence[int], ne: int = 1,
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16, **kw):
        super().__init__()
        self.nl = len(ch)
        c4 = max(ch[0] // 4, ne * 4)  # keep quaternion-divisible
        for i, c in enumerate(ch):
            setattr(self, f"cv4_{i}_0", Conv(c, c4, 3, **kw))
            setattr(self, f"cv4_{i}_1", Conv(c4, c4, 3, **kw))
            setattr(self, f"cv4_{i}_2", QER(c4, ne, 1, dtype=kw.get("dtype")))
        self.detect = Detect(nc, ch, strides, reg_max, **kw)

    def forward(self, xs: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        angles = []
        for i, x in enumerate(xs):
            a = getattr(self, f"cv4_{i}_0")(x)
            a = getattr(self, f"cv4_{i}_1")(a)
            a = getattr(self, f"cv4_{i}_2")(a)
            angles.append((torch.sigmoid(a.float()) - 0.25) * math.pi)
        return self.detect(xs), angles


# the standard deviation of a unit normal truncated at 2 sigma: flax divides by it
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: a normal truncated at 2 sigma, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _ceil4(n: int) -> int:
    return (n + 3) // 4 * 4


class Segment(nn.Module):
    """Instance-segmentation head (reference head.py:263-285): Detect, a
    `Proto` on P3, and per level a mask-coefficient branch cv4 = Conv, Conv,
    QER -> nm raw coefficients. Returns ``(feats, mc, proto)``: ``proto``
    ``[B, 2H3, 2W3, nm]`` real-valued, ``mc`` per level ``[B, H, W, nm]``."""

    def __init__(self, nc: int, ch: Sequence[int], nm: int = 32, npr: int = 256,
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16, **kw):
        super().__init__()
        self.proto = Proto(ch[0], npr, nm, **kw)
        c4 = max(ch[0] // 4, _ceil4(nm))  # quaternion-divisible
        for i, c in enumerate(ch):
            setattr(self, f"cv4_{i}_0", Conv(c, c4, 3, **kw))
            setattr(self, f"cv4_{i}_1", Conv(c4, c4, 3, **kw))
            setattr(self, f"cv4_{i}_2", QER(c4, nm, 1, dtype=kw.get("dtype")))
        self.detect = Detect(nc, ch, strides, reg_max, **kw)

    def forward(self, xs: Sequence[torch.Tensor]):
        proto = self.proto(xs[0])
        mc = [getattr(self, f"cv4_{i}_2")(getattr(self, f"cv4_{i}_1")(getattr(self, f"cv4_{i}_0")(x)))
              for i, x in enumerate(xs)]
        return self.detect(xs), mc, proto


class Pose(nn.Module):
    """Keypoint head (reference head.py:357-392): Detect and per level cv4 =
    Conv, Conv, QER -> nk * ndim raw keypoint maps. Returns ``(feats, kpts)``;
    `decode_kpts` maps them to pixels."""

    def __init__(self, nc: int, ch: Sequence[int], kpt_shape: Sequence[int] = (17, 3),
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16, **kw):
        super().__init__()
        nk = int(kpt_shape[0]) * int(kpt_shape[1])
        c4 = max(ch[0] // 4, _ceil4(nk))
        for i, c in enumerate(ch):
            setattr(self, f"cv4_{i}_0", Conv(c, c4, 3, **kw))
            setattr(self, f"cv4_{i}_1", Conv(c4, c4, 3, **kw))
            setattr(self, f"cv4_{i}_2", QER(c4, nk, 1, dtype=kw.get("dtype")))
        self.detect = Detect(nc, ch, strides, reg_max, **kw)

    def forward(self, xs: Sequence[torch.Tensor]):
        kpts = [getattr(self, f"cv4_{i}_2")(getattr(self, f"cv4_{i}_1")(getattr(self, f"cv4_{i}_0")(x)))
                for i, x in enumerate(xs)]
        return self.detect(xs), kpts


class Classify(nn.Module):
    """Classification head (the JAX package's working ``Classify``; the
    reference's, head.py:409-431, pools a 5-D tensor as if it were 4-D):
    ``conv`` = Conv(c1, 1280, 1) (a fused 1x1 site under ``fused_1x1``), the
    mean over H and W, the ``[B, 4, 320]`` features flattened q-major, and
    ``linear``, a real dense layer to ``c2`` logits with float32 parameters
    (flax ``nn.Dense``: lecun-normal weight, zero bias) run in ``dtype``
    (None: the promotion of the input's and the parameters' dtypes).
    Returns ``[B, c2]``."""

    def __init__(self, c1: int, c2: int, **kw):
        super().__init__()
        c_ = 1280
        self.dtype = kw.get("dtype")
        self.conv = Conv(c1, c_, 1, 1, **kw)
        self.linear = nn.Linear(c_, c2)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draws ``linear`` (``conv`` draws its own weights)."""
        with torch.no_grad():
            _lecun_normal_(self.linear.weight, self.linear.in_features, generator)
            self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x).mean(dim=(1, 2))  # [B, 4, C]
        x = x.reshape(x.shape[0], -1)
        dtype = self.dtype or torch.promote_types(x.dtype, self.linear.weight.dtype)
        return F.linear(x.to(dtype), self.linear.weight.to(dtype), self.linear.bias.to(dtype))


def flatten_levels(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[B, H, W, C]`` per level -> ``[B, sum(H W), C]``."""
    B = feats[0].shape[0]
    return torch.cat([f.reshape(B, -1, f.shape[-1]) for f in feats], dim=1)


def _anchors(feats: Sequence[torch.Tensor], strides: Sequence[int]):
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    return make_anchors(shapes, strides, 0.5, device=feats[0].device)


def decode_detect(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int,
                  reg_max: int = 16) -> torch.Tensor:
    """Inference decode (reference head.py:191-219): DFL -> dist2bbox -> scale
    by strides, sigmoid class scores. Returns ``[B, A, 4 + nc]`` (xywh pixels)."""
    anchors, stride_t = _anchors(feats, strides)
    x = flatten_levels(feats)
    dist = dfl(x[..., :4 * reg_max], reg_max)
    boxes = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return torch.cat([boxes, torch.sigmoid(x[..., 4 * reg_max:].float())], dim=-1)


def decode_obb(feats: Sequence[torch.Tensor], angles: Sequence[torch.Tensor],
               strides: Sequence[int], nc: int, reg_max: int = 16) -> torch.Tensor:
    """OBB inference decode (reference head.py:338-354). Returns
    ``[B, A, 4 + nc + 1]`` = (xywh in pixels, class scores, angle in radians), f32."""
    anchors, stride_t = _anchors(feats, strides)
    x = flatten_levels(feats)
    ang = flatten_levels(angles)
    dist = dfl(x[..., :4 * reg_max], reg_max)
    boxes = dist2rbox(dist, ang, anchors[None]) * stride_t[None]
    return torch.cat([boxes, torch.sigmoid(x[..., 4 * reg_max:].float()), ang], dim=-1)


def decode_segment(feats: Sequence[torch.Tensor], mc: Sequence[torch.Tensor], strides: Sequence[int],
                   nc: int, reg_max: int = 16) -> torch.Tensor:
    """Segment decode (reference head.py:276-285): the detect decode with the
    mask coefficients appended, ``[B, A, 4 + nc + nm]`` f32; the masks are
    ``sigmoid(mc @ proto)`` after NMS."""
    return torch.cat([decode_detect(feats, strides, nc, reg_max), flatten_levels(mc).float()], dim=-1)


def decode_kpts(kpts: Sequence[torch.Tensor], strides: Sequence[int],
                kpt_shape: Sequence[int]) -> torch.Tensor:
    """Keypoint decode (reference head.py:379-392): in f32, xy = (raw * 2 +
    anchor - 0.5) * stride and visibility = sigmoid. Returns ``[B, A, nk, ndim]``
    in input pixels."""
    anchors, stride_t = _anchors(kpts, strides)
    x = flatten_levels(kpts)
    B, A, _ = x.shape
    nk, ndim = kpt_shape
    y = x.reshape(B, A, nk, ndim).float()
    xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    if ndim == 3:
        return torch.cat([xy, torch.sigmoid(y[..., 2:3])], dim=-1)
    return xy


def decode_pose(feats: Sequence[torch.Tensor], kpts: Sequence[torch.Tensor], strides: Sequence[int],
                nc: int, kpt_shape: Sequence[int] = (17, 3), reg_max: int = 16) -> torch.Tensor:
    """Pose decode (reference head.py:369-377): the detect decode with the decoded
    keypoints flattened on, ``[B, A, 4 + nc + nk * ndim]`` f32."""
    k = decode_kpts(kpts, strides, kpt_shape)
    return torch.cat([decode_detect(feats, strides, nc, reg_max), k.reshape(*k.shape[:2], -1)], dim=-1)
