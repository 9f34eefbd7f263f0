"""Fused per-component attention, forward (K1) and backward (K2): wrappers, plain
versions, launch counts, and the autograd Function that joins them.

Counterpart of the JAX ``ops/pallas/qattn.py`` (``_attn`` with its custom VJP).
The kernels are ``csrc/qattn_fwd.cu`` and ``csrc/qattn_bwd.cu``; see their
headers for the designs. ``softmax(scale Q K^T) V`` runs independently per
(batch, quaternion component, head), and the N x N score block never reaches
device memory, forward or backward: the backward recomputes it from q, k, v.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from quan_ultralytics_tpu_torch.ops.kernels import _build

# (dk, dv) pairs the kernels are instantiated for (csrc/qattn_{fwd,bwd}.cu:dispatch)
SUPPORTED = {(1, 1), (1, 2), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 16),
             (16, 16), (16, 32), (32, 32)}
_DTYPES = (torch.float32, torch.bfloat16)  # the dtypes the kernels take
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

launches = 0  # K1 launches made by `qattention_fwd` (its operator's CUDA implementation), both dtypes
launches_mma = 0  # of those, bf16 launches of the tensor-core kernel
launches_simt = 0  # and f32 launches of the CUDA-core kernel
launches_stats = 0  # of all K1 launches, those that also wrote the row statistics
launches_bwd = 0  # K2 launches (one C call: three kernels in bf16, two in f32) by `qattention_bwd`
KEY_BLOCK = 128  # keys per block of the bf16 K2 (csrc/qattn_bwd.cu:kRows): one dQ partial each

# K1 against `qattention_fwd_plain` and K2 against `qattention_bwd_plain`, on the same
# inputs, per dtype: (rtol, atol, mean_rel). Each element within rtol |ref| + atol, and
# mean |got - ref| within mean_rel mean |ref| (`kernel_error`). f32 differs by summation
# order. In bf16 another summation order moves an output (or an E or U) across a bf16
# rounding boundary now and then: a one-ulp error in a few elements. A rounding point
# skipped or misplaced moves a large share of the outputs by an ulp, and so does the f32
# forward or backward of the same inputs: both miss these limits (tests/test_torch_kernels.py
# holds that on the CPU; chip_smoke.py checks the f32 forward and backward on the card).
FWD_TOL = {torch.float32: (2e-4, 2e-5, 1e-5), torch.bfloat16: (2e-2, 2e-3, 1e-4)}
BWD_TOL = {torch.float32: (1e-3, 1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-3, 1e-4)}


def kernel_error(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype, table: dict):
    """``(max abs error, mean abs error / mean |ref|, within table[dtype])`` of one
    output of a kernel against its plain version's (``table``: `FWD_TOL` for K1,
    `BWD_TOL` for K2)."""
    rtol, atol, mean_rel = table[dtype]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rel = float(err.mean() / ref.abs().mean().clamp(min=1e-30))
    ok = bool(torch.isfinite(got).all()) and bool((err <= rtol * ref.abs() + atol).all())
    return float(err.max()), rel, ok and rel <= mean_rel


def qattention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The einsum + softmax path (JAX models/block.py:229-232): scores in the
    activation dtype, softmax in f32, probabilities cast to ``v.dtype``."""
    attn = torch.einsum("bqhnd,bqhmd->bqhnm", q, k) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return torch.einsum("bqhnm,bqhmd->bqhnd", attn, v)


def _round(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype``, as JAX rounds a weakly typed constant."""
    return float(torch.tensor(x, dtype=dtype))


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float):
    """``(q2, s2)``: q scaled into the exp2 domain and rounded to its dtype, and the
    f32 scores ``q2 k^T`` (K1's and K2's first step)."""
    f = torch.float32
    q2 = (q.to(f) * _round(scale * _LOG2E, q.dtype)).to(q.dtype).to(f)
    return q2, q2 @ k.to(f).transpose(-1, -2)


def _stats_of(s2: torch.Tensor) -> torch.Tensor:
    m = s2.amax(dim=-1)
    return torch.stack([m, 1.0 / torch.exp2(s2 - m[..., None]).sum(dim=-1)])


def qattention_stats_plain(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The row statistics K1 writes for the backward: ``[2, ..., N]`` f32 holding
    each query row's score max m and reciprocal sum r = 1 / rowsum(exp2(s - m)),
    in the log2 domain at the TPU kernel's rounding points."""
    return _stats_of(_scores(q, k, scale)[1])


def qattention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """``softmax(scale q k^T) v`` step by step at the rounding points of the TPU
    kernel (JAX ``ops/pallas/qattn.py:_attn_kernel``) and of K1: q2 =
    round_T(q round_T(scale log2e)); f32 scores s2 = q2 k^T, keys >= N masked by
    N itself; m = rowmax, e = exp2(s2 - m) and r = 1 / rowsum(e) in f32; the
    output round_T((round_V(e) v in f32) r), normalized on [N, dv].

    Any leading shape ``[..., N, d]``; q2, m and r are the ones K2's plain
    version (`qattention_bwd_plain`) uses."""
    s2 = _scores(q, k, scale)[1]
    m, r = _stats_of(s2)
    e = torch.exp2(s2 - m[..., None])
    f = torch.float32
    return ((e.to(v.dtype).to(f) @ v.to(f)) * r[..., None]).to(v.dtype)


def new_stats(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[2, ..., N]`` f32 buffer for the row statistics of ``q``."""
    return torch.empty(2, *q.shape[:-1], dtype=torch.float32, device=q.device)


def qattention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, scale: float, stats: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` of ``softmax(scale q k^T) v`` for the cotangent ``do``,
    step by step at the rounding points of the TPU kernel
    (JAX ``ops/pallas/qattn.py:_attn_bwd_kernel``) and of K2.

    Any leading shape ``[..., N, d]``; products run in f32, and each value
    the TPU kernel keeps in the input dtype is rounded to it here. ``stats``
    (``[2, ..., N]``, m and r) are the forward's row statistics; None
    recomputes them with `qattention_stats_plain`, which gives the same values.
    """
    T = q.dtype
    f = torch.float32
    q2, s2 = _scores(q, k, scale)
    if stats is None:
        stats = _stats_of(s2)
    ks = (k.to(f) * _round(scale, T)).to(T).to(f)
    e = torch.exp2(s2 - stats[0][..., None])
    r = stats[1][..., None]
    dor = (do.to(f) * r).to(do.dtype).to(f)
    dv = e.to(v.dtype).to(f).transpose(-1, -2) @ dor
    dp = do.to(f) @ v.to(f).transpose(-1, -2)
    rse = (dp * e).sum(dim=-1, keepdim=True)
    u = (e * (dp - r * rse)).to(T).to(f)
    dq = (u @ ks) * r
    dk = u.transpose(-1, -2) @ (q2 * (r * _LN2)).to(T).to(f)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(G, N, dk, dv) of the q, k, v the kernels take; raises on anything else
    (the device is checked apart: `_build.check_device`)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 5 or k.shape != q.shape or v.shape[:-1] != q.shape[:-1]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Q, H, N, dk = q.shape
    dv = v.shape[-1]
    if (dk, dv) not in SUPPORTED:
        raise ValueError(f"(dk, dv) = ({dk}, {dv}) is not one of {sorted(SUPPORTED)}")
    return B * Q * H, N, dk, dv


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_stats(stats: torch.Tensor, q: torch.Tensor) -> None:
    if stats.shape != (2, *q.shape[:-1]) or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats must be contiguous float32 {(2, *q.shape[:-1])} on {q.device}, "
                         f"got {stats.dtype} {tuple(stats.shape)} on {stats.device}")


def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                stats: Optional[torch.Tensor]) -> torch.Tensor:
    """CUDA implementation of ``quan_torch::qattention_fwd``: launch K1 (the bf16
    kernel on the tensor cores or the f32 one on the CUDA cores, by dtype) on
    the contiguous q, k, v that `qattention_fwd` checked, writing the row
    statistics into ``stats`` when it is given."""
    global launches, launches_mma, launches_simt, launches_stats
    B, Q, H, N, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty_like(v)
    lib = _build.library()
    if q.dtype == torch.bfloat16:
        # the kernel copies k and v into shared memory in pieces of up to 16 bytes
        k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k, v))
        fn, name = lib.qattn_fwd_bf16, "qattn_fwd_bf16"
    else:
        fn, name = lib.qattn_fwd_f32, "qattn_fwd_f32"
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(), B * Q * H, N, dk, dv, scale * _LOG2E,
                q.device.index or 0, _stream(q))
    _build.check(status, name)
    launches += 1
    if q.dtype == torch.bfloat16:
        launches_mma += 1
    else:
        launches_simt += 1
    launches_stats += stats is not None
    return out


def _fwd_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              stats: Optional[torch.Tensor]) -> torch.Tensor:
    return v.new_empty(v.shape)


_fwd_op = _build.register_op(
    "qattention_fwd(Tensor q, Tensor k, Tensor v, float scale, Tensor(a!)? stats) -> Tensor",
    _fwd_launch, _fwd_fake)


def qattention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on CUDA q, k, v (no autograd) through the registered operator
    ``torch.ops.quan_torch.qattention_fwd``: the bf16 kernel on the tensor
    cores or the f32 one on the CUDA cores, by dtype. With ``stats``
    (`new_stats`) it also writes each query row's m and r there, for
    `qattention_bwd`. A fake or meta tensor gets the output's shape from the
    operator (what `torch.export` traces)."""
    _check(q, k, v)
    _build.check_device("q, k, v", q, k, v)
    if stats is not None:
        _check_stats(stats, q)
    return _fwd_op(q.contiguous(), k.contiguous(), v.contiguous(), scale, stats)


def qattention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                   scale: float, stats: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` of `qattention_fused` for the cotangent ``do`` (shaped like
    its output), given the forward's row statistics ``stats``. A CPU tensor
    takes `qattention_bwd_plain` (``stats`` optional there); a CUDA tensor
    launches K2 (the bf16 kernels or the f32 ones, by dtype) or raises."""
    if q.device.type == "cpu":
        return qattention_bwd_plain(q, k, v, do, scale, stats)
    global launches_bwd
    G, N, dk, dv = _check(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if do.shape != v.shape or do.device != v.device:
        raise ValueError(f"do {tuple(do.shape)} on {do.device} must match v {tuple(v.shape)}")
    if stats is None:
        raise ValueError("K2 needs the forward's row statistics: run K1 with stats=new_stats(q)")
    _check_stats(stats, q)
    qf, kf, vf = (t.contiguous() for t in (q, k, v))
    dof = do.to(v.dtype).contiguous()
    dq, dk_, dv_ = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    lib, ptrs = _build.library(), [t.data_ptr() for t in (qf, kf, vf, dof, stats)]
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        cbuf = torch.empty(G, N, **f32)  # r rse per row
        part = torch.empty(-(-N // KEY_BLOCK), G, N, dk, **f32)  # dQ per key block
        status = lib.qattn_bwd_bf16(*ptrs, cbuf.data_ptr(), part.data_ptr(), dq.data_ptr(),
                                    dk_.data_ptr(), dv_.data_ptr(), G, N, dk, dv, scale,
                                    scale * _LOG2E, q.device.index or 0, _stream(q))
    else:
        rse = torch.empty(G, N, **f32)
        status = lib.qattn_bwd_f32(*ptrs, rse.data_ptr(), dq.data_ptr(), dk_.data_ptr(),
                                   dv_.data_ptr(), G, N, dk, dv, scale, scale * _LOG2E,
                                   q.device.index or 0, _stream(q))
    _build.check(status, "qattn_bwd")
    launches_bwd += 1
    return dq, dk_, dv_


class QAttention(torch.autograd.Function):
    """K1 forward and K2 backward as one differentiable op (the JAX custom VJP
    ``_attn``): the forward saves ``(q, k, v)`` and, when a backward will
    follow, the row statistics K1 wrote; the backward recomputes the softmax
    from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, with_stats: bool):
        q, k, v = (t.contiguous() for t in (q, k, v))
        stats = new_stats(q) if with_stats else None
        out = qattention_fwd(q, k, v, scale, stats)  # the registered operator
        ctx.save_for_backward(q, k, v, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        dq, dk, dv = qattention_bwd(q, k, v, do, ctx.scale, stats)
        return dq, dk, dv, None, None


def qattention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """``softmax(q @ k^T * scale) @ v`` per (batch, component, head).

    q, k: ``[B, 4, H, N, dk]``; v: ``[B, 4, H, N, dv]``. Returns
    ``[B, 4, H, N, dv]`` in ``v.dtype``. A CPU tensor takes `qattention_plain`,
    which autograd differentiates; a CUDA tensor goes through `QAttention`
    (K1 forward, K2 backward; float32 or bfloat16, any N) or raises.
    K1 writes the row statistics for K2 only under grad with an input that
    requires it.
    """
    if q.device.type == "cpu":
        return qattention_plain(q, k, v, scale)
    # K1 writes the row statistics only when a backward will follow; without one
    # the operator is called alone (the graph `torch.export` captures)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return QAttention.apply(q, k, v, scale, True)
    return qattention_fwd(q, k, v, scale)
