"""The quaternion component-mixing matrix (counterpart of the JAX ``ops/mixing.py``).

The separable quaternion convolution is ``y = M @ s`` where ``s_d`` is an
independent per-component real convolution and ``M`` is the "Zhou separable
(CORRECTED)" sign matrix of the reference CUDA kernels:

    y_r =  s_r + s_i + s_j + s_k
    y_i =  s_r - s_i - s_j + s_k
    y_j =  s_r + s_i - s_j - s_k
    y_k =  s_r - s_i + s_j - s_k

``M @ M.T == 4 I``, so autograd of this forward is the reference backward.
"""

import numpy as np
import torch

# Rows: output component (r, i, j, k). Columns: per-component conv sum s_d.
MIX_MATRIX = np.array(
    [
        [1.0, 1.0, 1.0, 1.0],
        [1.0, -1.0, -1.0, 1.0],
        [1.0, 1.0, -1.0, -1.0],
        [1.0, -1.0, 1.0, -1.0],
    ],
    dtype=np.float32,
)


def mix_components(s: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Apply the 4x4 mixing matrix along the quaternion component axis.

    Written as a butterfly of eight adds (``a = s_r + s_i``, ``b = s_j + s_k``,
    ``c = s_r - s_i``, ``d = s_j - s_k``) rather than a matmul, so no tiny
    GEMM is launched. ``dim`` defaults to the Q axis of BHWQC.
    """
    sr, si, sj, sk = s.unbind(dim)
    a, b = sr + si, sj + sk
    c, d = sr - si, sj - sk
    return torch.stack([a + b, c - d, a - b, c + d], dim=dim)
