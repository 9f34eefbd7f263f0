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

import torch

from quan_ultralytics_tpu_torch.ops.kernels import _build

# (dk, dv) pairs the kernels are instantiated for (csrc/qattn_{fwd,bwd}.cu:dispatch)
SUPPORTED = {(1, 1), (1, 2), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 16),
             (16, 16), (16, 32), (32, 32)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

launches = 0  # K1 launches made by `qattention_fused`
launches_bwd = 0  # K2 launches (one C call, two kernels) made by `qattention_bwd`

# K2 against `qattention_bwd_plain` on the same inputs, per dtype: (rtol, atol, mean_rel).
# Each element within rtol |ref| + atol, and mean |got - ref| within mean_rel mean |ref|.
# f32 differs by summation order. In bf16 another summation order moves an output (or a
# U or E) across a bf16 rounding boundary now and then: a one-ulp error in a few
# elements. A rounding point skipped or misplaced moves a large share of the outputs by
# an ulp, and so does the f32 backward: both miss these limits (tests/test_torch_kernels.py
# holds that on the CPU; chip_smoke.py checks the f32 backward on the card).
BWD_TOL = {torch.float32: (1e-3, 1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-3, 1e-4)}


def bwd_error(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype):
    """``(max abs error, mean abs error / mean |ref|, within BWD_TOL[dtype])`` of
    one gradient of K2 against the plain backward's."""
    rtol, atol, mean_rel = BWD_TOL[dtype]
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


def qattention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, scale: float):
    """``(dq, dk, dv)`` of ``softmax(scale q k^T) v`` for the cotangent ``do``,
    step by step at the rounding points of the TPU kernel
    (JAX ``ops/pallas/qattn.py:_attn_bwd_kernel``) and of K2.

    Any leading shape ``[..., N, d]``; products run in f32, and each value
    the TPU kernel keeps in the input dtype is rounded to it here.
    """
    T = q.dtype
    f = torch.float32
    q2 = (q.to(f) * _round(scale * _LOG2E, T)).to(T).to(f)
    ks = (k.to(f) * _round(scale, T)).to(T).to(f)
    s2 = q2 @ k.to(f).transpose(-1, -2)  # [..., N, N] log2-domain scores
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    dor = (do.to(f) * r).to(do.dtype).to(f)
    dv = e.to(v.dtype).to(f).transpose(-1, -2) @ dor
    dp = do.to(f) @ v.to(f).transpose(-1, -2)
    rse = (dp * e).sum(dim=-1, keepdim=True)
    u = (e * (dp - r * rse)).to(T).to(f)
    dq = (u @ ks) * r
    dk = u.transpose(-1, -2) @ (q2 * (r * _LN2)).to(T).to(f)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(G, N, dk, dv) of CUDA q, k, v the kernels take; raises on anything else."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
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


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch K1 on contiguous CUDA q, k, v."""
    global launches
    G, N, dk, dv = _check(q, k, v)
    out = torch.empty_like(v)
    status = _build.library().qattn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G, N, dk, dv,
        scale * _LOG2E, _DTYPES[q.dtype], q.device.index or 0, _stream(q))
    _build.check(status, "qattn_fwd")
    launches += 1
    return out


def qattention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                   scale: float):
    """``(dq, dk, dv)`` of `qattention_fused` for the cotangent ``do`` (shaped like
    its output). A CPU tensor takes `qattention_bwd_plain`; a CUDA tensor
    launches K2 or raises."""
    if q.device.type == "cpu":
        return qattention_bwd_plain(q, k, v, do, scale)
    global launches_bwd
    G, N, dk, dv = _check(q, k, v)
    if do.shape != v.shape or do.device != v.device:
        raise ValueError(f"do {tuple(do.shape)} on {do.device} must match v {tuple(v.shape)}")
    qf, kf, vf = (t.contiguous() for t in (q, k, v))
    dof = do.to(v.dtype).contiguous()
    dq, dk_, dv_ = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    stats = torch.empty(3, G, N, dtype=torch.float32, device=q.device)  # m, r, rse per row
    status = _build.library().qattn_bwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(), dq.data_ptr(),
        dk_.data_ptr(), dv_.data_ptr(), stats.data_ptr(), G, N, dk, dv, scale,
        scale * _LOG2E, _DTYPES[q.dtype], q.device.index or 0, _stream(q))
    _build.check(status, "qattn_bwd")
    launches_bwd += 1
    return dq, dk_, dv_


class QAttention(torch.autograd.Function):
    """K1 forward and K2 backward as one differentiable op (the JAX custom VJP
    ``_attn``): the forward saves ``(q, k, v)`` only, the backward recomputes
    the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        q, k, v = (t.contiguous() for t in (q, k, v))
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _fwd_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = qattention_bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None


def qattention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """``softmax(q @ k^T * scale) @ v`` per (batch, component, head).

    q, k: ``[B, 4, H, N, dk]``; v: ``[B, 4, H, N, dv]``. Returns
    ``[B, 4, H, N, dv]`` in ``v.dtype``. A CPU tensor takes `qattention_plain`,
    which autograd differentiates; a CUDA tensor goes through `QAttention`
    (K1 forward, K2 backward; float32 or bfloat16, any N) or raises.
    """
    if q.device.type == "cpu":
        return qattention_plain(q, k, v, scale)
    return QAttention.apply(q, k, v, scale)
