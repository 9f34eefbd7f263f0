"""Quaternion network blocks of the QUAN-YOLO11 graph (counterpart of the JAX ``models/block.py``).

Channel arguments are in total quaternion-channel space (multiples of 4);
every ``Conv`` is QConv2D+IQBN+SiLU. Concatenation is along the
per-component channel axis C, the last axis of BHWQC. Submodule names follow
the JAX package's flax names (``cv1``, ``m0``, ``attn``, ...).

The keyword arguments ``dtype``, ``impl`` and ``fused_1x1`` are handed down
to every ``Conv`` (see models/conv.py); ``fused_attn`` goes to the attention.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from quan_ultralytics_tpu_torch.models.conv import Conv, QConv2D
from quan_ultralytics_tpu_torch.ops.kernels.qattn import qattention_fused, qattention_plain
from quan_ultralytics_tpu_torch.ops.pooling import qmax_pool, qupsample


def qconcat(xs: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Channel concat of BHWQC tensors (reference Concat, conv.py:1139-1149)."""
    return torch.cat(list(xs), dim=dim)


class QuaternionDropout(nn.Module):
    """Drops whole quaternions (reference block.py:135-154): in train, one
    Bernoulli keep mask ``[B, H, W, 1, C]`` broadcast over the component axis,
    with no ``1 / (1 - p)`` rescale (as the reference); the identity in eval or
    at ``p = 0``. The mask is drawn from ``generator`` (None: torch's default
    generator of the input's device)."""

    def __init__(self, p: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        B, H, W, _, C = x.shape
        keep = torch.rand((B, H, W, 1, C), generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype)


def _packed_kw(kw: dict, packed: bool) -> dict:
    """A block's Conv keyword arguments, with the deep-packed stem's
    ``packed="both"`` when its activations stay packed (ops/stem.py)."""
    return {**kw, "packed": "both"} if packed else kw


class Bottleneck(nn.Module):
    """Standard bottleneck (reference block.py:447-461). ``packed``: the input and
    output are the deep-packed stem's channel-major r=2 packing."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5, packed: bool = False, **kw):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1, **_packed_kw(kw, packed))
        self.cv2 = Conv(c_, c2, k[1], 1, g=g, **_packed_kw(kw, packed))
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference block.py:362-377); ``packed`` as
    `Bottleneck`'s (the concat of two packed tensors is the packing of theirs)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3, bottleneck_e: float = 1.0, packed: bool = False, **kw):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        pkw = _packed_kw(kw, packed)
        self.cv1 = Conv(c1, c_, 1, 1, **pkw)
        self.cv2 = Conv(c1, c_, 1, 1, **pkw)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, k=(k, k), e=bottleneck_e,
                                                packed=packed, **kw))
        self.cv3 = Conv(2 * c_, c2, 1, **pkw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        b = self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(qconcat([a, b]))


def C3k(c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3, packed=False, **kw) -> C3:
    """C3 with a custom bottleneck kernel size (reference block.py:888-897)."""
    return C3(c1, c2, n, shortcut, g, e, k=k, bottleneck_e=1.0, packed=packed, **kw)


class C3k2(nn.Module):
    """Faster CSP bottleneck, YOLO11's workhorse (reference block.py:876-885).
    ``packed``: the deep-packed stem's channel-major layout throughout; the split
    then takes the first ``c/4`` channels' groups of 4 phase entries."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, packed: bool = False, **kw):
        super().__init__()
        c = int(c2 * e)  # hidden width in total quaternion channels
        self.n, self.cpc = n, (c // 4) * (4 if packed else 1)
        pkw = _packed_kw(kw, packed)
        self.cv1 = Conv(c1, 2 * c, 1, 1, **pkw)
        for i in range(n):
            m = (C3k(c, c, 2, shortcut, g, packed=packed, **kw) if c3k
                 else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5, packed=packed, **kw))
            self.add_module(f"m{i}", m)
        self.cv2 = Conv((2 + n) * c, c2, 1, **pkw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        ys = [y[..., :self.cpc], y[..., self.cpc:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(qconcat(ys))


class QSPPF(nn.Module):
    """Quaternion SPPF (reference block.py:270-303): 1x1 reduce, three chained
    k=5 stride-1 max pools, concat, 1x1 expand."""

    def __init__(self, c1: int, c2: int, k: int = 5, **kw):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1, **kw)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(qmax_pool(y[-1], self.k, 1, self.k // 2))
        return self.cv2(qconcat(y))


class QAttention(nn.Module):
    """Per-component multi-head attention (reference block.py:1485-1546).

    qkv and proj are 1x1 quaternion convs, the positional encoding a 3x3
    depth-wise quaternion conv; softmax(Q K^T scale) V runs independently per
    quaternion component and head. ``fused_attn``: a CUDA tensor goes through
    the fused kernel (``ops/kernels/qattn.py``), for any N; otherwise, and on
    the CPU, the einsum + softmax path runs.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5,
                 dtype: Optional[torch.dtype] = None, impl: str = "grouped",
                 fused_attn: bool = True):
        super().__init__()
        C = dim // 4
        self.num_heads = num_heads
        self.head_dim = C // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.nh_kd = self.key_dim * num_heads
        self.fused_attn = fused_attn
        h_per_comp = C + self.nh_kd * 2
        self.qkv = QConv2D(dim, h_per_comp * 4, 1, use_bias=False, dtype=dtype, impl=impl)
        self.pe = QConv2D(dim, dim, 3, p=1, g=C, use_bias=False, dtype=dtype, impl=impl)
        self.proj = QConv2D(dim, dim, 1, use_bias=False, dtype=dtype, impl=impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, Q, C = x.shape
        N = H * W
        nh, kd = self.num_heads, self.key_dim
        qkv = self.qkv(x)

        def heads(t, d):  # [B, H, W, 4, heads*d] -> [B, 4, heads, N, d]
            return t.reshape(B, N, Q, nh, d).permute(0, 2, 3, 1, 4)

        qh = heads(qkv[..., :self.nh_kd], kd)
        kh = heads(qkv[..., self.nh_kd:2 * self.nh_kd], kd)
        vh = heads(qkv[..., 2 * self.nh_kd:], self.head_dim)
        attend = qattention_fused if self.fused_attn else qattention_plain
        o = attend(qh, kh, vh, kd ** -0.5)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, H, W, Q, C)
        o = o + self.pe(o)
        return self.proj(o)


class QPSABlock(nn.Module):
    """Attention + FFN block with residuals (reference block.py:1382-1407)."""

    def __init__(self, c: int, attn_ratio: float = 1.0, num_heads: int = 8,
                 shortcut: bool = True, fused_attn: bool = True, **kw):
        super().__init__()
        self.attn = QAttention(c, num_heads, attn_ratio, dtype=kw.get("dtype"),
                               impl=kw.get("impl", "grouped"), fused_attn=fused_attn)
        self.ffn0 = Conv(c, c * 2, 1, **kw)
        self.ffn1 = Conv(c * 2, c, 1, act=False, **kw)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn(x)
        x = x + a if self.shortcut else a
        f = self.ffn1(self.ffn0(x))
        return x + f if self.shortcut else f


class QC2PSA(nn.Module):
    """C2-style split with a PSA attention branch (reference block.py:1548-1593)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, fused_attn: bool = True,
                 **kw):
        super().__init__()
        c = int(c1 * e)
        self.n, self.cpc = n, c // 4
        self.cv1 = Conv(c1, 2 * c, 1, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", QPSABlock(c, attn_ratio=0.5, num_heads=max(1, c // 16),
                                               fused_attn=fused_attn, **kw))
        self.cv2 = Conv(2 * c, c2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        a, b = y[..., :self.cpc], y[..., self.cpc:]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(qconcat([a, b]))


class C2f(nn.Module):
    """Classic C2f (reference block.py:337-360): C3k2's topology with
    (3,3)-(3,3) e=1.0 bottlenecks, no shortcut by default."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5, **kw):
        super().__init__()
        c = int(c2 * e)
        self.n, self.cpc = n, c // 4
        self.cv1 = Conv(c1, 2 * c, 1, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0, **kw))
        self.cv2 = Conv((2 + n) * c, c2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        ys = [y[..., :self.cpc], y[..., self.cpc:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(qconcat(ys))


class QPSA(nn.Module):
    """Standalone PSA block (reference block.py:1410-1483): 1x1 reduce, split,
    attention (``attn_ratio`` 1, so key and value widths are equal) and FFN on
    one half, concat, 1x1 expand."""

    def __init__(self, c1: int, c2: int, e: float = 0.5, fused_attn: bool = True, **kw):
        super().__init__()
        c = (int(c1 * e) // 4) * 4
        self.cpc = c // 4
        self.cv1 = Conv(c1, 2 * c, 1, **kw)
        self.attn = QAttention(c, num_heads=max(c // 16, 1), attn_ratio=1.0, dtype=kw.get("dtype"),
                               impl=kw.get("impl", "grouped"), fused_attn=fused_attn)
        self.ffn0 = Conv(c, c * 2, 1, **kw)
        self.ffn1 = Conv(c * 2, c, 1, act=False, **kw)
        self.cv2 = Conv(2 * c, c2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        a, b = y[..., :self.cpc], y[..., self.cpc:]
        a = self.ffn1(self.ffn0(self.attn(a)))
        return self.cv2(qconcat([a, b]))


class Proto(nn.Module):
    """Mask prototypes of the segment head (reference block.py:156-174, the JAX
    package's design): Conv 3x3 -> nearest upsample x2 -> Conv 3x3 -> QER to
    ``c2`` real channels. Returns ``[B, 2H, 2W, c2]``. The reference's
    ConvTranspose path cannot take the 5-D quaternion tensors its own Conv
    gives (broken upstream); this is the alternative its comment names."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32, **kw):
        super().__init__()
        from quan_ultralytics_tpu_torch.models.head import QER  # head imports this module

        self.cv1 = Conv(c1, c_, 3, **kw)
        self.cv2 = Conv(c_, c_, 3, **kw)
        self.cv3 = QER(c_, c2, 1, dtype=kw.get("dtype"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(qupsample(self.cv1(x), 2, "nearest")))


def dfl(x: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution Focal Loss integral (reference block.py:64-83):
    ``[B, A, 4 * reg_max]`` logits -> ``[B, A, 4]`` expected distances (f32)."""
    B, A, _ = x.shape
    p = torch.softmax(x.reshape(B, A, 4, reg_max).float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return p @ proj
