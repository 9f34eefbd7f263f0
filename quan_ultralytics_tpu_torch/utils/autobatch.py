"""AutoBatch: a batch size from an analytic memory model (counterpart of the
JAX package's ``utils/autobatch.py``).

The reference's utils/autobatch.py probes CUDA memory fractions at run time;
the JAX package, and this port after it, estimate the activation memory of a
batch from the layer specs and fit it into a fraction of the device's
memory.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from quan_ultralytics_tpu_torch.models.tasks import resolve_device


def device_hbm_bytes(device: Optional[Union[str, torch.device]] = None,
                     default_gb: float = 16.0) -> float:
    """Memory of ``device`` (``cuda`` unless named): the card's total memory;
    ``default_gb`` GiB (the JAX package's default) when the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return default_gb * (1 << 30)
    return float(torch.cuda.get_device_properties(dev).total_memory)


def estimate_activation_bytes_per_image(model, imgsz: int, dtype_bytes: int = 2) -> float:
    """Sum of the layers' output activation sizes, times 3 for the backward's residuals."""
    total = 0.0
    for s in model.specs:
        if s.c2 <= 0 or s.stride <= 0:
            continue
        hw = (imgsz / s.stride) ** 2
        total += hw * s.c2 * dtype_bytes
    return total * 3.0


def auto_batch(model, imgsz: int = 640, fraction: float = 0.60,
               params_bytes: Optional[float] = None, max_batch: int = 1024,
               device: Optional[Union[str, torch.device]] = None) -> int:
    """The largest power-of-two batch whose activations fit ``fraction`` of the
    device's memory (the reference's autobatch.py:14-105 default 0.6), the
    parameters, gradients and two optimizer moments (4 x ``params_bytes``)
    set aside; ``device`` defaults to the model's."""
    if device is None:
        device = next(model.parameters()).device
    hbm = device_hbm_bytes(device) * fraction
    per_img = estimate_activation_bytes_per_image(model, imgsz)
    fixed = (params_bytes or 0.0) * 4
    avail = max(hbm - fixed, per_img)
    b = int(avail // per_img)
    return int(min(max(2 ** int(np.log2(max(b, 1))), 1), max_batch))
