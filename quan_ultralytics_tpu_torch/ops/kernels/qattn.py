"""Fused per-component attention, forward (K1): wrapper, plain version, launch count.

Counterpart of the JAX ``ops/pallas/qattn.py`` forward. The kernel is
``csrc/qattn_fwd.cu``; see its header for the design. ``softmax(scale Q K^T) V``
runs independently per (batch, quaternion component, head), and the N x N
score block never reaches device memory.
"""

from __future__ import annotations

import math

import torch

from quan_ultralytics_tpu_torch.ops.kernels import _build

# (dk, dv) pairs the kernel is instantiated for (csrc/qattn_fwd.cu:dispatch)
SUPPORTED = {(1, 1), (1, 2), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 16),
             (16, 16), (16, 32), (32, 32)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)

launches = 0  # kernel launches made by `qattention_fused`


def qattention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The einsum + softmax path (JAX models/block.py:229-232): scores in the
    activation dtype, softmax in f32, probabilities cast to ``v.dtype``."""
    attn = torch.einsum("bqhnd,bqhmd->bqhnm", q, k) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return torch.einsum("bqhnm,bqhmd->bqhnd", attn, v)


def qattention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """``softmax(q @ k^T * scale) @ v`` per (batch, component, head).

    q, k: ``[B, 4, H, N, dk]``; v: ``[B, 4, H, N, dv]``. Returns
    ``[B, 4, H, N, dv]`` in ``v.dtype``. A CPU tensor takes `qattention_plain`;
    a CUDA tensor launches the kernel (float32 or bfloat16, any N) or raises.
    """
    if q.device.type == "cpu":
        return qattention_plain(q, k, v, scale)
    global launches
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
    G = B * Q * H
    qf, kf, vf = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(vf)
    status = _build.library().qattn_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), G, N, dk, dv,
        scale * _LOG2E, _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "qattn_fwd")
    launches += 1
    return out
