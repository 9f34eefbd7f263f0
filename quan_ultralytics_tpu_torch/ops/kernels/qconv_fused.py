"""Fused 1x1 quaternion conv + folded IQBN + SiLU (K3): wrapper, plain version, launch count.

Counterpart of the JAX ``ops/pallas/qconv_fused.py``. The kernels are in
``csrc/qconv1x1_fused.cu`` (see its header for the designs): bf16 runs on the
tensor cores, f32 on the CUDA cores; the wrapper picks by dtype. For
inference only: the IQBN running statistics are folded into a
per-(component, channel) affine by `fold_iqbn`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.kernels import _build
from quan_ultralytics_tpu_torch.ops.qconv import qconv2d

_DTYPES = (torch.float32, torch.bfloat16)  # the dtypes the kernels take

launches = 0  # kernel launches made by `qconv1x1_fused` (its operator's CUDA implementation), both dtypes
launches_mma = 0  # of those, bf16 launches of the tensor-core kernel
launches_simt = 0  # and f32 launches of the CUDA-core kernel

# K3 against `qconv1x1_fused_plain` on the same inputs, per dtype: (rtol, atol), each
# element within rtol |ref| + atol max(1, max |ref|). f32 differs by summation order; bf16
# keeps the plain version's rounding points (f32 inside, one cast at the end), so the two
# sit at most a bf16 ulp or two apart.
K3_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-2, 1e-2)}


def fold_iqbn(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """IQBN eval affine -> ``(scale, shift)``, each ``[4, C]``."""
    inv = gamma * torch.rsqrt(var + eps)
    return inv, beta - mean * inv


def _weights(w: torch.Tensor, ci: int) -> torch.Tensor:
    """``[4, Co, Ci, 1, 1]`` or ``[4, Co, Ci]`` -> ``[4, Co, Ci]``."""
    if w.shape[0] != 4 or w.shape[2] != ci or (w.ndim == 5 and w.shape[3:] != (1, 1)) \
            or w.ndim not in (3, 5):
        raise ValueError(f"expected [4, Co, {ci}(, 1, 1)] weights, got {tuple(w.shape)}")
    return w.reshape(4, w.shape[1], ci)


def qconv1x1_fused_plain(x: torch.Tensor, w: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         apply_silu: bool = True) -> torch.Tensor:
    """`qconv2d` followed by the affine and SiLU, with the kernel's rounding
    points: the weights in ``x.dtype``, everything after in f32, one cast to
    ``x.dtype`` at the end."""
    w = _weights(w, x.shape[-1]).to(x.dtype)
    y = qconv2d(x.float(), w.float()[..., None, None])
    if scale is not None:
        y = y * scale.float() + shift.float()
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            apply_silu: bool) -> torch.Tensor:
    """CUDA implementation of ``quan_torch::qconv1x1_fused``: launch the kernel of
    ``x.dtype`` on contiguous ``[B, H, W, 4, Ci]`` x, ``[4, Co, Ci]`` w in
    ``x.dtype`` and float32 ``[4, Co]`` scale and shift, all on one CUDA
    device (what `qconv1x1_fused` checks and lays out before it calls the
    operator)."""
    global launches, launches_mma, launches_simt
    B, H, W, _, ci = x.shape
    co = w.shape[1]
    out = torch.empty(B, H, W, 4, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    if x.dtype == torch.bfloat16:
        # the kernel copies x and w in pieces of up to 16 bytes
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
        fn, name = lib.qconv1x1_mma_bf16, "qconv1x1_mma_bf16"
    else:
        fn, name = lib.qconv1x1_simt_f32, "qconv1x1_simt_f32"
    status = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                B * H * W, ci, co, int(apply_silu), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    launches += 1
    if x.dtype == torch.bfloat16:
        launches_mma += 1
    else:
        launches_simt += 1
    return out


def _fake(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          apply_silu: bool) -> torch.Tensor:
    return x.new_empty((*x.shape[:4], w.shape[1]))


_op = _build.register_op(
    "qconv1x1_fused(Tensor x, Tensor w, Tensor scale, Tensor shift, bool apply_silu) -> Tensor",
    _launch, _fake)


def qconv1x1_fused(x: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   apply_silu: bool = True) -> torch.Tensor:
    """1x1 separable qconv + mixing + affine + optional SiLU, one pass.

    x: ``[B, H, W, 4, Ci]``; w: ``[4, Co, Ci, 1, 1]`` (or ``[4, Co, Ci]``), cast
    to ``x.dtype`` as in the JAX kernel; scale, shift: ``[4, Co]`` (None: no
    affine). Returns ``[B, H, W, 4, Co]`` in ``x.dtype``. A CPU tensor takes
    `qconv1x1_fused_plain`; a CUDA tensor launches the kernel of its dtype
    (bf16: tensor cores, Ci up to about 700 and any Co, split into channel
    tiles where the weights of all of Co do not fit a block; f32: CUDA cores)
    through the registered operator ``torch.ops.quan_torch.qconv1x1_fused``,
    or raises. A fake or meta tensor gets the output's shape from the
    operator (what `torch.export` traces).
    """
    if x.device.type == "cpu":
        return qconv1x1_fused_plain(x, w, scale, shift, apply_silu)
    if x.ndim != 5 or x.shape[3] != 4:
        raise ValueError(f"expected BHWQC input, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    wk = _weights(w, x.shape[-1])
    co = wk.shape[1]
    if scale is None:
        scale = torch.ones(4, co, device=x.device)
        shift = torch.zeros(4, co, device=x.device)
    if scale.shape != (4, co) or shift.shape != (4, co):
        raise ValueError(f"scale/shift must be [4, {co}], got {tuple(scale.shape)}, {tuple(shift.shape)}")
    _build.check_device("x, w, scale, shift", x, wk, scale, shift)
    return _op(x.contiguous(), wk.to(x.dtype).contiguous(), scale.float().contiguous(),
               shift.float().contiguous(), apply_silu)
