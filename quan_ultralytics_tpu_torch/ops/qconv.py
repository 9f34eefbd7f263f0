"""Separable quaternion convolution (counterpart of the JAX ``ops/qconv.py``).

    s_d = conv2d(x_d, w_d)            # 4 independent per-component convs
    y   = M @ s  (+ bias_r on every component)

The component axis is flattened into channels (component-major) and ONE
grouped convolution with ``groups = 4 * g`` computes all four ``s_d``; the
constant mixing follows as elementwise adds. The folded form puts the mixing
into a dense kernel: one ungrouped conv with 4x the essential FLOPs and no
mixing pass. Both give the same values.

Weight layout: ``w`` is ``[4, C_out, C_in / g, kH, kW]``, i.e. one PyTorch
OIHW kernel per component, so the grouped kernel is ``w.reshape(4 * C_out,
C_in / g, kH, kW)`` without a copy. (The JAX package stores HWIO per
component, ``[4, kH, kW, C_in / g, C_out]``; ``utils/weights.py`` transposes.)

Activations are BHWQC ``[B, H, W, 4, C]``. The ``[B, H, W, 4C]`` view permuted
to NCHW has channels-last strides, which cuDNN consumes without a copy and
answers in the same format.

`qdense` is the quaternion dense layer (full Hamilton product) on
``[..., 4, F]`` features.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.mixing import MIX_MATRIX, mix_components
from quan_ultralytics_tpu_torch.ops.stem import expand_w_l0, expand_w_l0_s2d4, expand_w_l1, expand_w_packed

IntOr2 = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def autopad(k: IntOr2, p: Optional[IntOr2] = None, d: IntOr2 = 1) -> Tuple[int, int]:
    """'same'-style padding rule, matching reference conv.py:62-68."""
    kh, kw = _pair(k)
    dh, dw = _pair(d)
    if dh > 1:
        kh = dh * (kh - 1) + 1
    if dw > 1:
        kw = dw * (kw - 1) + 1
    if p is None:
        return (kh // 2, kw // 2)
    return _pair(p)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 4, C]`` -> an NCHW view ``[B, 4C, H, W]`` with channels-last strides."""
    B, H, W, Q, C = x.shape
    return x.reshape(B, H, W, Q * C).permute(0, 3, 1, 2)


def from_nchw(y: torch.Tensor, q: int = 4) -> torch.Tensor:
    """NCHW ``[B, 4C, H, W]`` -> BHWQC ``[B, H, W, 4, C]`` (a view for channels-last input)."""
    B, C4, H, W = y.shape
    return y.permute(0, 2, 3, 1).reshape(B, H, W, q, C4 // q)


def qconv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: IntOr2 = 1,
    padding: IntOr2 = 0,
    dilation: IntOr2 = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Separable quaternion conv on BHWQC tensors.

    Args:
      x: input ``[B, H, W, 4, C_in]``.
      w: weights ``[4, C_out, C_in // groups, kH, kW]``; cast to ``x.dtype``.
      bias: optional real bias ``[C_out]`` (reference ``bias_r``), added to all
        four mixed components after the mixing (``M[:, 0] == 1``).
      groups: grouped conv within each component.

    Returns ``[B, H_out, W_out, 4, C_out]`` in ``x.dtype``.
    """
    if x.ndim != 5 or x.shape[3] != 4:
        raise ValueError(f"expected BHWQC input, got {tuple(x.shape)}")
    if w.ndim != 5 or w.shape[0] != 4:
        raise ValueError(f"expected [4, Cout, Cin/g, kH, kW] weights, got {tuple(w.shape)}")
    _, cout, cin_pg, kh, kw = w.shape
    if cin_pg * groups != x.shape[4]:
        raise ValueError(f"cin {x.shape[4]} != groups {groups} * {cin_pg}")
    kernel = w.reshape(4 * cout, cin_pg, kh, kw).to(x.dtype)
    s = F.conv2d(to_nchw(x), kernel, None, _pair(stride), _pair(padding), _pair(dilation),
                 4 * groups)
    y = mix_components(from_nchw(s), dim=-2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def fold_dense_kernel(w: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Fold the mixing matrix ``mix`` (`MIX_MATRIX` on ``w``'s device) into one
    dense OIHW kernel (groups == 1 only).

    ``K[(q, co), (d, ci)] = M[q, d] * w[d, co, ci]``: a single ungrouped conv
    ``[4 C_out, 4 C_in, kH, kW]`` with 4x the essential FLOPs and no mixing pass.
    """
    _, cout, cin, kh, kw = w.shape
    k = torch.einsum("qd,doihw->qodihw", mix.to(w.dtype), w)
    return k.reshape(4 * cout, 4 * cin, kh, kw)


def qconv2d_folded(
    x: torch.Tensor,
    dense_kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: IntOr2 = 1,
    padding: IntOr2 = 0,
    dilation: IntOr2 = 1,
) -> torch.Tensor:
    """qconv through a pre-folded dense kernel (see `fold_dense_kernel`)."""
    cout4, cin4 = dense_kernel.shape[:2]
    if cin4 != 4 * x.shape[4]:
        raise ValueError(f"dense kernel takes {cin4} channels, input has 4 * {x.shape[4]}")
    y = F.conv2d(to_nchw(x), dense_kernel.to(x.dtype), None, _pair(stride), _pair(padding),
                 _pair(dilation))
    y = from_nchw(y)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _hamilton(p: torch.Tensor) -> torch.Tensor:
    """``[..., 4(a), 4(d), F]`` products ``a_d`` -> ``[..., 4, F]`` by the Hamilton signs."""
    (r_r, r_i, r_j, r_k), (i_r, i_i, i_j, i_k), (j_r, j_i, j_j, j_k), (k_r, k_i, k_j, k_k) = (
        t.unbind(-2) for t in p.unbind(-3))
    return torch.stack([r_r - i_i - j_j - k_k,
                        r_i + i_r + j_k - k_j,
                        r_j - i_k + j_r + k_i,
                        r_k + i_j - j_i + k_r], dim=-2)


def qdense(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quaternion dense layer with the full Hamilton product (reference
    classification/quaternion/qconv.py:878-998).

    Four shared real linears ``w_d`` act on every input component, ``a_d =
    linear_d(x_a)``, and the 16 products combine as

        out_r = r_r - i_i - j_j - k_k
        out_i = r_i + i_r + j_k - k_j
        out_j = r_j - i_k + j_r + k_i
        out_k = r_k + i_j - j_i + k_r

    Args:
      x: ``[..., 4, F_in]``.
      w: ``[4, F_in, F_out]`` (component order r, i, j, k); cast to ``x.dtype``.
      bias: optional ``[4, F_out]``, added to every product ``a_d``, so it passes
        through the Hamilton signs too (the real output picks up
        ``b_r - b_i - b_j - b_k``).

    Returns ``[..., 4, F_out]``. A float32 product runs in full float32, never
    TF32 (the JAX package's einsum runs at ``Precision.HIGHEST``).
    """
    if x.shape[-2] != 4 or w.ndim != 3 or w.shape[0] != 4 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"qdense: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = torch.einsum("...af,dfo->...ado", x, w.to(x.dtype))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if bias is not None:
        p = p + bias.to(p.dtype)  # [d, F_out] broadcasts over the 'a' axis
    return _hamilton(p)


# `int8_matmul`'s launches of `torch._int_mm` on a card (chip_smoke.py counts them)
int8_launches = 0


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w [N, K]^T`` of int8 values as exact int32: a float64
    product, exact while every partial sum stays below 2^53 (|acc| <=
    127^2 K), on any device."""
    return (a.double() @ w.double().t()).to(torch.int32)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w [N, K]^T``, int8 x int8 -> exact int32, as XLA's s8 x s8
    conv with ``preferred_element_type=int32``.

    On a card: ``torch._int_mm`` (cuBLASLt's int8 tensor-core product), which
    takes M > 16 and K, N multiples of 8: the operands are padded with exact
    zeros and the result cut back. On the CPU: `int8_matmul_plain`.
    """
    global int8_launches
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {a.dtype} and {w.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w)
    if a.device.type != "cuda":
        raise RuntimeError(f"no int8 product on {a.device}")
    M, K = a.shape
    N = w.shape[0]
    k8, n8 = -(-K // 8) * 8, -(-N // 8) * 8
    m_pad = max(M, 24)  # more than 16 rows, a multiple of 8 when padded
    a_p = _pad_to(_pad_to(a, 1, k8), 0, m_pad).contiguous()
    w_p = _pad_to(_pad_to(w, 1, k8), 0, n8).contiguous()
    int8_launches += 1
    return torch._int_mm(a_p, w_p.t())[:M, :N]


def int8_im2col(xq: torch.Tensor, k: Tuple[int, int], stride: Tuple[int, int],
                padding: Tuple[int, int], dilation: Tuple[int, int]) -> Tuple[torch.Tensor, int, int]:
    """NHWC int8 ``[B, H, W, C]`` -> its patches ``[B Ho Wo, kH kW C]`` (taps
    row-major, channels last; zero padding), Ho and Wo."""
    B, H, W, C = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = k, stride, padding, dilation
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return xq.reshape(B * H * W, C), H, W
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    p = xp.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)[..., ::dh, ::dw]
    Ho, Wo = p.shape[1], p.shape[2]  # p: [B, Ho, Wo, C, kh, kw]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(B * Ho * Wo, kh * kw * C), Ho, Wo


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (round half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_accumulator(x: torch.Tensor, dense_kernel: torch.Tensor, *, stride: IntOr2 = 1,
                     padding: IntOr2 = 0, dilation: IntOr2 = 1, eps: float = 1e-8,
                     act_absmax: Optional[torch.Tensor] = None, matmul=None):
    """The int8 conv's int32 accumulator and scales: ``(acc [B, Ho, Wo, 4 C_out]
    int32, sx, swt [4 C_out])`` of `qconv2d_int8`; ``matmul`` is its int8
    product (`int8_matmul`; `int8_matmul_plain` to hold it to its plain version)."""
    B, H, W, _, cin = x.shape
    cout4, cin4, kh, kw = dense_kernel.shape
    if cin4 != 4 * cin:
        raise ValueError(f"dense kernel takes {cin4} channels, input has 4 * {cin}")
    xf = x.reshape(B, H, W, 4 * cin).float()
    amax = xf.abs().amax() if act_absmax is None else act_absmax.float().to(xf.device)
    sx = amax / 127.0 + eps
    xq = quantize_int8(xf, sx)
    kf = dense_kernel.float()
    swt = kf.abs().amax(dim=(1, 2, 3)) / 127.0 + eps  # per output channel
    wq = quantize_int8(kf, swt[:, None, None, None])
    cols, Ho, Wo = int8_im2col(xq, (kh, kw), _pair(stride), _pair(padding), _pair(dilation))
    acc = (matmul or int8_matmul)(cols, wq.permute(0, 2, 3, 1).reshape(cout4, kh * kw * cin4))
    return acc.reshape(B, Ho, Wo, cout4), sx, swt


def qconv2d_int8(
    x: torch.Tensor,
    dense_kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: IntOr2 = 1,
    padding: IntOr2 = 0,
    dilation: IntOr2 = 1,
    eps: float = 1e-8,
    act_absmax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The int8 qconv (the JAX ``qconv2d_int8``, an inference-only opt-in): the
    folded dense kernel (`fold_dense_kernel`, OIHW) quantized per output
    channel, the activation per tensor (scale ``absmax / 127 + eps``; the
    calibrated ``act_absmax`` when given, else this call's), int8 x int8 ->
    int32 exactly (`int8_matmul`), then ``acc * (sx * swt)`` in f32, the
    bias, and the input's dtype.
    """
    acc, sx, swt = int8_accumulator(x, dense_kernel, stride=stride, padding=padding,
                                    dilation=dilation, eps=eps, act_absmax=act_absmax)
    B, Ho, Wo, cout4 = acc.shape
    y = (acc.float() * (sx * swt)).reshape(B, Ho, Wo, 4, cout4 // 4)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- packed (space-to-depth) convs
#
# The phase-composite and deep-packed stem (ops/stem.py): the same separable
# qconv on space-to-depth packed activations, its weights rearranged by one
# gather. Each is a cuDNN conv, as its JAX counterpart is an XLA conv. The
# forms: `grouped` (groups = 4, then the mixing; the JAX phase convs'),
# `folded` (the mixing folded into one dense kernel; the JAX packed conv's
# default) and `int8` (that kernel quantized, `qconv2d_int8`; packed only).
# The bias of a packed output repeats over its phases.


def packed_pads(H: int, W: int, k: Tuple[int, int], s: int, p: Tuple[int, int], ri: int, ro: int,
                KH: int, KW: int, pl: int, S: int) -> Tuple[int, int]:
    """Bottom and right padding of a packed conv (left and top: ``pl``) on a
    packed input ``[H, W]``, so that its output covers the original conv's."""
    jh = ((H * ri + 2 * p[0] - k[0]) // s + 1) // ro
    jw = ((W * ri + 2 * p[1] - k[1]) // s + 1) // ro
    return S * (jh - 1) + KH - 1 - pl - (H - 1), S * (jw - 1) + KW - 1 - pl - (W - 1)


def _conv_padded(x: torch.Tensor, kernel: torch.Tensor, stride: int, pl: int, pr_h: int, pr_w: int,
                 groups: int) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` padded ``pl`` top and left, ``pr_h`` bottom and
    ``pr_w`` right: conv padding ``pl`` and a crop where ``pr <= pl`` (no copy
    of the input), else an explicit pad."""
    if pr_h <= pl and pr_w <= pl:
        y = F.conv2d(x, kernel, None, stride, pl, 1, groups)
        KH, KW = kernel.shape[2:]
        ho = (x.shape[2] + pl + pr_h - KH) // stride + 1
        wo = (x.shape[3] + pl + pr_w - KW) // stride + 1
        return y if y.shape[2:] == (ho, wo) else y[:, :, :ho, :wo]
    return F.conv2d(F.pad(x, (pl, pr_w, pl, pr_h)), kernel, None, stride, 0, 1, groups)


def packed_conv_kernel(wk: torch.Tensor, mix: torch.Tensor, impl: str) -> torch.Tensor:
    """An expanded per-component kernel ``[4, C_out', C_in', KH, KW]`` as the conv
    kernel of ``impl``: grouped ``[4 C_out', C_in', KH, KW]``, else folded
    ``[4 C_out', 4 C_in', KH, KW]`` (`fold_dense_kernel`)."""
    if impl == "grouped":
        _, co, ci, kh, kw = wk.shape
        return wk.reshape(4 * co, ci, kh, kw)
    return fold_dense_kernel(wk, mix)


def packed_qconv(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor], *, stride: int,
                 pl: int, pr_h: int, pr_w: int, impl: str,
                 act_absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A packed qconv of BHWQC ``x`` through its `packed_conv_kernel`; ``bias``
    as repeated over the output's phases. Returns BHWQC in ``x.dtype``."""
    if impl == "int8":
        xp = F.pad(x, (0, 0, 0, 0, pl, pr_w, pl, pr_h))
        return qconv2d_int8(xp, kernel, bias, stride=stride, padding=0, act_absmax=act_absmax)
    y = _conv_padded(to_nchw(x), kernel.to(x.dtype), stride, pl, pr_h, pr_w,
                     4 if impl == "grouped" else 1)
    y = from_nchw(y)
    if impl == "grouped":
        y = mix_components(y, dim=-2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _run_packed(x, wk, bias_p, k, s, p, ri, ro, pl, S, impl, mix, act_absmax=None):
    if impl not in ("grouped", "folded", "int8"):
        raise ValueError(f"unknown packed impl {impl!r}")
    KH, KW = wk.shape[3:]
    pr_h, pr_w = packed_pads(x.shape[1], x.shape[2], k, s, p, ri, ro, KH, KW, pl, S)
    kernel = packed_conv_kernel(wk, torch.tensor(MIX_MATRIX, device=wk.device) if mix is None else mix, impl)
    return packed_qconv(x, kernel, bias_p, stride=S, pl=pl, pr_h=pr_h, pr_w=pr_w, impl=impl,
                        act_absmax=act_absmax)


def _stem_check(x: torch.Tensor, w: torch.Tensor, groups: int, cin: int) -> None:
    if groups != 1:
        # phase-major packed outputs put the phase outermost, so a grouped
        # conv's channel groups would cross the phases
        raise ValueError(f"the phase-composite stem takes groups=1, got {groups}")
    if w.shape[3:] != (3, 3):
        raise ValueError(f"the phase-composite stem takes 3x3 kernels, got {tuple(w.shape)}")
    if x.ndim != 5 or x.shape[3] != 4 or x.shape[4] != cin:
        raise ValueError(f"expected [B, H, W, 4, {cin}], got {tuple(x.shape)}")


def qconv2d_phase0(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   groups: int = 1, impl: str = "grouped", mix: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Stem layer 0, phase-composite: the k=3, s=2, p=1 qconv with its output
    space-to-depth packed, as one k=5, s=4 conv (`ops.stem.expand_w_l0`).

    x ``[B, H, W, 4, cin]``, w ``[4, cout, cin, 3, 3]`` -> ``[B, H/4, W/4, 4,
    4*cout]`` (a component's channels phase-major)."""
    _stem_check(x, w, groups, w.shape[2])
    b = None if bias is None else bias.repeat(4)
    return _run_packed(x, expand_w_l0(w), b, (3, 3), 2, (1, 1), 1, 2, 1, 4, impl, mix)


def qconv2d_phase0_packed(x_packed: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          impl: str = "grouped", mix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stem layer 0 on an r=4 packed input (`ops.stem.s2d4_rgb_mapped`): a k=2,
    s=1 conv over 16*cin channels (`ops.stem.expand_w_l0_s2d4`); the output is
    `qconv2d_phase0`'s.

    x ``[B, H/4, W/4, 4, 16*cin]``, w ``[4, cout, cin, 3, 3]`` -> ``[B, H/4, W/4, 4, 4*cout]``."""
    _stem_check(x_packed, w, 1, 16 * w.shape[2])
    b = None if bias is None else bias.repeat(4)
    return _run_packed(x_packed, expand_w_l0_s2d4(w), b, (3, 3), 2, (1, 1), 4, 2, 1, 1, impl, mix)


def qconv2d_phase1(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   groups: int = 1, impl: str = "grouped", mix: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Stem layer 1, phase-composite: the k=3, s=2, p=1 qconv on the phase-major
    packed output of `qconv2d_phase0`, as one k=2, s=1 conv padded top-left
    (`ops.stem.expand_w_l1`), giving the ORIGINAL (unpacked) output.

    x ``[B, H', W', 4, 4*cin]``, w ``[4, cout, cin, 3, 3]`` -> ``[B, H', W', 4, cout]``."""
    _stem_check(x, w, groups, 4 * w.shape[2])
    return _run_packed(x, expand_w_l1(w), bias, (3, 3), 2, (1, 1), 2, 1, 1, 1, impl, mix)


def qconv2d_packed(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   stride: IntOr2 = 1, padding: IntOr2 = 0, ri: int = 2, ro: int = 2,
                   impl: str = "folded", act_absmax: Optional[torch.Tensor] = None,
                   mix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable qconv on channel-major space-to-depth packed activations (the
    deep-packed stem, `ops.stem.expand_w_packed`).

    Args:
      x: ``[B, Hc, Wc, 4, C_in * ri * ri]`` packed input (``ri == 1``: unpacked).
      w: the plain conv's weights ``[4, C_out, C_in, kH, kW]``, rearranged here.
      stride, padding: the plain conv's; square only.
      impl: ``folded`` (the default, as JAX's ``QUAN_PACKED_IMPL``),
        ``grouped`` or ``int8`` (``act_absmax``: the calibrated |x| max).

    Returns ``[B, Ho, Wo, 4, C_out * ro * ro]`` packed (``ro == 1``: unpacked).
    """
    _, cout, cin, kh, kw = w.shape
    if x.ndim != 5 or x.shape[3] != 4 or x.shape[4] != cin * ri * ri:
        raise ValueError(f"expected [B, Hc, Wc, 4, {cin}*{ri}^2], got {tuple(x.shape)}")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if sh != sw or ph != pw:
        raise ValueError("packed conv: square stride and padding only")
    wk, pl, S = expand_w_packed(w, sh, ph, ri, ro)
    b = None if bias is None else bias.repeat_interleave(ro * ro)
    return _run_packed(x, wk, b, (kh, kw), sh, (ph, pw), ri, ro, pl, S, impl, mix, act_absmax)
