"""Phase-composite (space-to-depth) stem convolutions (counterpart of the JAX ``ops/stem.py``).

The same convolutions as the plain stem, evaluated on space-to-depth packed
activations: only the *weights* are rearranged, at apply time, so the
parameters and checkpoints are the plain model's.

  * layer 0: a k=3, s=2, p=1 conv evaluated at the 4 stride-2 phases at
    once: one k=5, s=4 conv whose outputs are the space-to-depth packing of
    the original outputs, ``[H/2, W/2, C] -> [H/4, W/4, 4C]`` with
    phase-major channel order ``(a, b, c)``.
  * layer 1: a k=3, s=2, p=1 conv consuming that packed layout: a k=2, s=1
    conv with top-left padding, producing the ORIGINAL layer-1 output.

Derivation: with ``Y[u, v] = sum_{d in [0,3)^2} W[d] X[2u+d-1, 2v+d-1]`` and
the packing ``Z[i, j, (a, b)] = Y[2i+a, 2j+b]``:

  - ``Z[i, j, (a, b)] = sum_d W[d] X[4i+2a+d-1, ...]``: tap ``p = 2a+d`` in
    [0, 5), so ``W5[(a, b, co), p, q] = W3[co, p-2a, q-2b]`` where
    ``0 <= p-2a <= 2``, else 0; a conv with k=5, s=4, pad 1.
  - layer 1 on Z: ``out[i, j] = sum_d W[d] Y[2i+d-1, 2j+d-1]``; Y's row
    ``2i+d-1`` is Z's row ``i-1+pa`` at phase ``a`` with ``d-1 = 2pa+a-2``,
    valid for ``(pa, a)`` in {(0, 1), (1, 0), (1, 1)}; a k=2, s=1 conv
    padded (1, 0) top-left.

`expand_w_packed` is the general rule (a conv of stride ``s``, padding
``p`` on input packed by ``ri`` and output packed by ``ro``, channel-major
``(c, a, b)``), of which the three stem expansions are the (1, 2), (2, 1)
and (4, 2) instances; the deep-packed stem keeps layers 0 to 2K+1 of the
graph on the packed grids with it (`models.tasks.QUANYOLO`).

Weights are in the port's layout, ``[4, C_out, C_in, kH, kW]`` (an OIHW
kernel per component, `models.conv.QConv2D.w`). Each expansion is ONE
gather through an index map that depends on the shapes only (`*_index`,
computed once per shape in numpy): entry ``n`` of the map is the zero slot
appended to the flattened weights, so structural zeros cost nothing extra
and the gradient of the gather reaches the weights.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.mappings import rgb_to_quaternion


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``[..., H, W, C] -> [..., H/r, W/r, r*r*C]``, phase-major ``(a, b, c)``."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // r, r, W // r, r, C)
    x = x.movedim(-4, -3)  # [..., H/r, W/r, a, b, C]
    return x.reshape(*lead, H // r, W // r, r * r * C)


def depth_to_space_cmajor(z: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of the channel-major packing: ``[B, Hc, Wc, 4, C*r*r]`` (packed
    channel ``c*r*r + a*r + b``, `expand_w_packed`'s order) ->
    ``[B, Hc*r, Wc*r, 4, C]``."""
    B, Hc, Wc, Q, Cr = z.shape
    C = Cr // (r * r)
    z = z.reshape(B, Hc, Wc, Q, C, r, r)    # [..., q, c, a, b]
    z = z.permute(0, 1, 5, 2, 6, 3, 4)      # [B, Hc, a, Wc, b, q, c]
    return z.reshape(B, Hc * r, Wc * r, Q, C)


def depth_to_space_phasemajor(z: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of the phase-major packing (`expand_w_l0`'s order, packed
    channel ``a*r*C + b*C + c``): ``[B, Hc, Wc, 4, C*r*r] -> [B, Hc*r, Wc*r, 4, C]``."""
    B, Hc, Wc, Q, Cr = z.shape
    C = Cr // (r * r)
    z = z.reshape(B, Hc, Wc, Q, r, r, C)    # [..., q, a, b, c]
    z = z.permute(0, 1, 4, 2, 5, 3, 6)      # [B, Hc, a, Wc, b, q, c]
    return z.reshape(B, Hc * r, Wc * r, Q, C)


def s2d4_rgb_mapped(x_rgb: torch.Tensor, mapping_type: str) -> torch.Tensor:
    """RGB ``[B, H, W, 3]`` -> quaternion-mapped, r=4 packed ``[B, H/4, W/4, 4, 16]``.

    The per-pixel mapping commutes with the packing; the packed channels of a
    component are phase-major ``(a4, b4)``, `expand_w_l0_s2d4`'s order (with
    one input channel that is also `expand_w_packed`'s channel-major order).
    """
    B, H, W, _ = x_rgb.shape
    q = rgb_to_quaternion(x_rgb, mapping_type)[..., 0]  # [B, H, W, 4]
    q = q.reshape(B, H // 4, 4, W // 4, 4, 4)           # [B, Hc, a4, Wc, b4, quat]
    q = q.permute(0, 1, 3, 5, 2, 4)                     # [B, Hc, Wc, quat, a4, b4]
    return q.reshape(B, H // 4, W // 4, 4, 16)


def _packed_taps_1d(k: int, s: int, p: int, ri: int, ro: int):
    """Tap map of a 1-D conv on a fine grid with packed input and output.

    The conv's output fine row ``u = ro*j + a_out`` takes input fine row
    ``x = s*u + d - p``. With the input packed by ``ri`` (``x = ri*i + a_in``)
    and the output by ``ro``, each tap ``(a_out, d)`` maps to exactly one
    packed tap ``i = S*j + m`` with ``S = s*ro/ri`` and ``m = (s*a_out + d - p
    - a_in) / ri`` (``a_in`` fixed by the remainder).

    Returns ``(taps, m_min, K, S)``: taps ``[(m, a_in, a_out, d)]``, and the
    packed conv's kernel size ``K`` with left padding ``-m_min``.
    """
    if (s * ro) % ri:
        raise ValueError(f"incompatible packing: s={s} ro={ro} ri={ri}")
    S = (s * ro) // ri
    taps = []
    for a_out in range(ro):
        for d in range(k):
            v = s * a_out + d - p
            a_in = v % ri
            taps.append(((v - a_in) // ri, a_in, a_out, d))
    m_min = min(t[0] for t in taps)
    K = max(t[0] for t in taps) - m_min + 1
    return taps, m_min, K, S


def _components(m: np.ndarray, n: int) -> np.ndarray:
    """A per-component index map (entries in [0, n], n = the zero slot) ->
    the map over all four components ``[4, ...]`` (zero slot ``4n``)."""
    off = (np.arange(4) * n).reshape((4,) + (1,) * m.ndim)
    return np.where(m[None] < n, m[None] + off, 4 * n).astype(np.int64)


@lru_cache(maxsize=None)
def l0_index(cout: int, cin: int) -> np.ndarray:
    """`expand_w_l0`'s map: ``[4, 4*cout, cin, 5, 5]`` into ``[4, cout, cin, 3, 3]``."""
    n = cout * cin * 9
    src = np.arange(n).reshape(cout, cin, 3, 3)
    out = np.full((2, 2, cout, cin, 5, 5), n)
    for a in range(2):
        for b in range(2):
            out[a, b, :, :, 2 * a:2 * a + 3, 2 * b:2 * b + 3] = src
    return _components(out.reshape(4 * cout, cin, 5, 5), n)


@lru_cache(maxsize=None)
def l1_index(cout: int, cin: int) -> np.ndarray:
    """`expand_w_l1`'s map: ``[4, cout, 4*cin, 2, 2]`` (input phase-major ``(a, b, ci)``)."""
    n = cout * cin * 9
    src = np.arange(n).reshape(cout, cin, 3, 3)
    out = np.full((cout, 2, 2, cin, 2, 2), n)  # [co, a, b, ci, pa, qb]
    for pa in range(2):
        for a in range(2):
            d = 2 * pa + a - 2  # row offset in the 3x3 kernel, -1..1 valid
            if not -1 <= d <= 1:
                continue
            for qb in range(2):
                for b in range(2):
                    e = 2 * qb + b - 2
                    if -1 <= e <= 1:
                        out[:, a, b, :, pa, qb] = src[:, :, d + 1, e + 1]
    return _components(out.reshape(cout, 4 * cin, 2, 2), n)


@lru_cache(maxsize=None)
def l0_s2d4_index(cout: int, cin: int) -> np.ndarray:
    """`expand_w_l0_s2d4`'s map: ``[4, 4*cout, 16*cin, 2, 2]``.

    Input channels ``(a4, b4, ci)`` phase-major on the fine grid packed by 4,
    output channels ``(a2, b2, co)`` on the stride-2 grid packed by 2. Output
    row ``u = 2i + a2`` takes input row ``4i + 2*a2 + d - 1 = 4*(i + pm - 1) +
    a4`` with ``d = a4 - 2*a2 + 4*pm - 3``, valid for ``0 <= d <= 2``: a k=2,
    s=1 conv padded 1 top-left.
    """
    n = cout * cin * 9
    src = np.arange(n).reshape(cout, cin, 3, 3)
    out = np.full((2, 2, cout, 4, 4, cin, 2, 2), n)  # [a2, b2, co, a4, b4, ci, pm, qn]
    for pm in range(2):
        for a2 in range(2):
            for a4 in range(4):
                d = a4 - 2 * a2 + 4 * pm - 3
                if not 0 <= d <= 2:
                    continue
                for qn in range(2):
                    for b2 in range(2):
                        for b4 in range(4):
                            e = b4 - 2 * b2 + 4 * qn - 3
                            if 0 <= e <= 2:
                                out[a2, b2, :, a4, b4, :, pm, qn] = src[:, :, d, e]
    return _components(out.reshape(4 * cout, 16 * cin, 2, 2), n)


@lru_cache(maxsize=None)
def packed_index(cout: int, cin: int, kh: int, kw: int, s: int, p: int, ri: int, ro: int
                 ) -> Tuple[np.ndarray, int, int]:
    """`expand_w_packed`'s map ``[4, cout*ro*ro, cin*ri*ri, KH, KW]`` (channel-major
    ``(c, a, b)``), its left padding and its stride."""
    th, mh_min, KH, S = _packed_taps_1d(kh, s, p, ri, ro)
    tw, mw_min, KW, _ = _packed_taps_1d(kw, s, p, ri, ro)
    n = cout * cin * kh * kw
    src = np.arange(n).reshape(cout, cin, kh, kw)
    out = np.full((cout, ro, ro, cin, ri, ri, KH, KW), n)  # [co, a2, b2, ci, a4, b4, m, n]
    for m, a4, a2, d in th:
        for nn_, b4, b2, e in tw:
            out[:, a2, b2, :, a4, b4, m - mh_min, nn_ - mw_min] = src[:, :, d, e]
    return _components(out.reshape(cout * ro * ro, cin * ri * ri, KH, KW), n), -mh_min, S


def expand(w: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather ``w`` (``[4, C_out, C_in, kH, kW]``) through an index map of this
    module (on ``w``'s device): one pad and one gather; differentiable."""
    return F.pad(w.reshape(-1), (0, 1))[index]


def _index(a: np.ndarray, w: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=w.device)


def expand_w_l0(w: torch.Tensor) -> torch.Tensor:
    """``[4, cout, cin, 3, 3] -> [4, 4*cout, cin, 5, 5]``, output phase-major ``(a, b, co)``."""
    _, cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the phase-composite stem takes 3x3 kernels, got {kh}x{kw}")
    return expand(w, _index(l0_index(cout, cin), w))


def expand_w_l1(w: torch.Tensor) -> torch.Tensor:
    """``[4, cout, cin, 3, 3] -> [4, cout, 4*cin, 2, 2]`` consuming phase-major input."""
    _, cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the phase-composite stem takes 3x3 kernels, got {kh}x{kw}")
    return expand(w, _index(l1_index(cout, cin), w))


def expand_w_l0_s2d4(w: torch.Tensor) -> torch.Tensor:
    """Layer 0 on an r=4 packed input, emitting the r=2 packed output:
    ``[4, cout, cin, 3, 3] -> [4, 4*cout, 16*cin, 2, 2]`` (see `l0_s2d4_index`)."""
    _, cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the phase-composite stem takes 3x3 kernels, got {kh}x{kw}")
    return expand(w, _index(l0_s2d4_index(cout, cin), w))


def expand_w_packed(w: torch.Tensor, s: int, p: int, ri: int, ro: int
                    ) -> Tuple[torch.Tensor, int, int]:
    """The packed conv of a stride-``s``, padding-``p`` conv on input packed by
    ``ri`` and output packed by ``ro`` (1: unpacked): ``(kernel [4, cout*ro*ro,
    cin*ri*ri, KH, KW], left padding, stride)`` with channel-major ``(c, a, b)``
    packed channels. `expand_w_l0`, `expand_w_l1` and `expand_w_l0_s2d4` are the
    (1, 2), (2, 1) and (4, 2) cases in phase-major order."""
    _, cout, cin, kh, kw = w.shape
    idx, pl, S = packed_index(cout, cin, kh, kw, s, p, ri, ro)
    return expand(w, _index(idx, w)), pl, S

