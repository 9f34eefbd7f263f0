"""Post-training int8 quantization: activation-range calibration (counterpart
of the JAX ``ops/quant.py``).

A model built with ``impl="int8"`` (`models.conv.QConv2D`) serves with the
folded conv kernels quantized per output channel and activations per
tensor (`ops.qconv.qconv2d_int8`). Without calibrated ranges each conv takes
its activation scale from the call's own |x| max, an extra reduction a
layer. `calibrate_int8` runs representative batches through the model and
keeps a running per-conv |x| max as an ``act_absmax`` buffer (the JAX
``quant`` collection; `utils.weights` carries it both ways), and the model
then serves with static scales.

Usage::

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", impl="int8")
    calibrate_int8(model, batches)          # a handful of batches
    Predictor(model, imgsz=1024)(frames)    # static scales
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn

from quan_ultralytics_tpu_torch.models.conv import QConv2D


@torch.no_grad()
def calibrate_int8(model: nn.Module, batches: Iterable) -> nn.Module:
    """Collect every int8 conv's activation |x| max over ``batches`` (image
    batches ``[B, H, W, 3]``: float in [0, 1], or uint8, divided by 255 as the
    Predictor does) in eval mode, and store it in the conv as the
    ``act_absmax`` buffer (a 0-d float32), replacing an earlier calibration.
    Returns ``model``. Raises when no batch came or no conv took the int8
    path (the model was not built with ``impl="int8"``), as JAX does.
    """
    convs = [m for m in model.modules() if isinstance(m, QConv2D)]
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    for m in convs:
        m.calibrating, m.calib_absmax = True, None
    try:
        for img in batches:
            x = torch.as_tensor(img).to(device)
            model(x.float() / 255.0 if x.dtype == torch.uint8 else x)
        found = [m for m in convs if m.calib_absmax is not None]
        if not found:
            raise ValueError("calibration collected no scales: no batches, or no conv "
                             "took the int8 path (build the model with impl='int8')")
        for m in found:
            m.register_buffer("act_absmax", m.calib_absmax.reshape(()).clone())
    finally:
        for m in convs:
            m.calibrating, m.calib_absmax = False, None
        model.train(was_training)
    return model
