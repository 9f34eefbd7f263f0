"""QUAN in PyTorch: the CUDA port of the JAX/Pallas package ``quan_ultralytics_tpu``.

The structure mirrors the JAX package module for module (``ops/qconv.py``
here is ``ops/qconv.py`` there), so each counterpart is found by path. The
activation layout at every public function is the same BHWQC
``[B, H, W, 4, C]`` as in JAX; inside a convolution the ``[B, H, W, 4C]`` view
is permuted to an NCHW tensor with channels-last strides, which cuDNN takes
without a copy.

The Pallas kernels of the JAX package are CUDA C++ kernels here
(``csrc/``), built with ``nvcc`` at first use (``ops/kernels/_build.py``).
Each has a plain PyTorch version beside it, which its wrapper takes only for
a tensor that lies on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card present they raise instead of falling back. This package never
imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from quan_ultralytics_tpu_torch.ops.mixing import MIX_MATRIX, mix_components  # noqa: F401
