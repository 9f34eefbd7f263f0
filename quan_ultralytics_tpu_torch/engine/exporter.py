"""Export: a runnable inference graph, or the weights in the JAX payload
(counterpart of the JAX package's ``engine/exporter.py``; reference
engine/exporter.py :185-1500 and nn/autobackend.py :54).

* ``exported`` (``*.pt2``): ``torch.export`` of forward + decode at a fixed
  ``(batch, imgsz)`` with the weights inside, saved by ``torch.export.save``
  with the JAX package's ``meta`` dict as the extra file ``meta.json`` (the
  counterpart of JAX's ``jax.export`` artifact, ``export_compiled``). On the
  card the graph calls the fused attention and the fused 1x1 convs as the
  registered operators ``quan_torch::qattention_fwd`` and
  ``quan_torch::qconv1x1_fused``, so loading it needs this package's kernel
  modules imported (`ExportedBackend` does that); a graph exported on the
  CPU holds ATen operators only and loads with torch alone.
* ``params`` (``*.pkl``): ``{model_yaml, nc, names, params, batch_stats}`` as
  numpy in the flax layout (`utils.weights.export_jax_variables`), which
  ``YOLO("m.pkl")`` of either package reads.

The JAX package's other formats need software this package does not use:
``tflite``, ``saved_model`` (``pb``) and ``onnx`` go through TensorFlow (and
tf2onnx), and ``stablehlo`` is XLA's IR; each raises with the reason.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import List, NoReturn, Optional

import torch
import torch.nn as nn

from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

META_FILE = "meta.json"  # the extra file of a .pt2 that holds the JAX package's meta dict


class _Inference(nn.Module):
    """forward + decode of a model: ``[b, H, W, 3]`` float32 in [0, 1] -> decoded predictions."""

    def __init__(self, model: DetectionModel):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model.decode(self.model(img))


def export_compiled(model: DetectionModel, imgsz: int = 640, batch: int = 1, path: str = "model.pt2",
                    names: Optional[List[str]] = None, model_yaml: Optional[str] = None) -> str:
    """``torch.export`` forward + decode of ``model`` (in eval, on its device)
    for ``[batch, imgsz, imgsz, 3]`` float32 frames, and save it with the
    meta dict (task, nc, names, imgsz, batch, model_yaml, strides)."""
    if model.task not in ("detect", "obb"):
        raise ValueError(f"exported predict supports detect and obb, got {model.task}")
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            x = torch.zeros(batch, imgsz, imgsz, 3, device=dev)
            program = torch.export.export(_Inference(model), (x,), strict=False)
    finally:
        model.train(was_training)
    meta = {"task": model.task, "nc": model.nc, "names": names, "imgsz": imgsz, "batch": batch,
            "model_yaml": model_yaml, "strides": [int(s) for s in model.strides]}
    torch.export.save(program, path, extra_files={META_FILE: json.dumps(meta)})
    return str(path)


def _import_kernel_ops() -> None:
    """Register the operators an exported graph may call."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused  # noqa: F401


class ExportedBackend:
    """Runtime of a ``.pt2`` artifact (reference nn/autobackend.py:54
    AutoBackend): forward + decode with no model code, on the device it was
    exported on; detect and OBB artifacts only, as in the JAX package.

    It has the surface of a `DetectionModel` that `engine.predictor.Predictor`
    and ``YOLO.predict`` use: ``task``, ``nc``, ``extra_dim``, ``parameters()``,
    ``eval()``, a call on ``[b, H, W, 3]`` float32 frames and ``decode`` of its
    result. Its graph already decodes, so `decode` passes the predictions
    through, and the graph is fixed in eval mode, so `eval` changes nothing.
    ``imgsz`` and ``batch`` are the fixed sizes it was exported at."""

    extra_dim = 0

    def __init__(self, path: str):
        _import_kernel_ops()
        extra = {META_FILE: ""}
        program = torch.export.load(str(path), extra_files=extra)
        self.meta = json.loads(extra[META_FILE])
        self.task = self.meta["task"]
        if self.task not in ("detect", "obb"):
            raise ValueError(f"exported predict supports detect and obb, got {self.task}")
        self.nc = self.meta["nc"]
        self.names = self.meta.get("names")
        self.imgsz = self.meta["imgsz"]
        self.batch = self.meta["batch"]
        self._fn = program.module()

    def parameters(self):
        return self._fn.parameters()

    def eval(self) -> "ExportedBackend":
        return self

    @staticmethod
    def decode(pred: torch.Tensor) -> torch.Tensor:
        return pred

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """``[b, H, W, 3]`` float32 -> decoded predictions ``[b, A, ...]``; a batch
        other than the exported one runs in pieces of it, the last zero-padded."""
        img = img.float().to(next(self.parameters()).device)
        outs = []
        for i in range(0, img.shape[0], self.batch):
            part = img[i:i + self.batch]
            n = part.shape[0]
            if n < self.batch:
                part = torch.cat([part, part.new_zeros((self.batch - n, *part.shape[1:]))])
            outs.append(self._fn(part)[:n])
        return torch.cat(outs)


def export_params(model: DetectionModel, model_yaml: str, names: Optional[List[str]] = None,
                  path: str = "model.pkl") -> str:
    """The JAX facade's ``export_params`` payload: ``{model_yaml, nc, names,
    params, batch_stats}`` with the weights as numpy in the flax layout."""
    variables = export_jax_variables(model)
    payload = {"model_yaml": model_yaml, "nc": model.nc, "names": names,
               "params": variables["params"], "batch_stats": variables["batch_stats"]}
    Path(path).write_bytes(pickle.dumps(payload))
    return str(path)


def refuse(format: str) -> NoReturn:
    """Raise for the JAX package's formats this package does not write, with the reason."""
    if format == "stablehlo":
        raise ValueError("format='stablehlo' is XLA's IR, which PyTorch does not produce; "
                         "format='exported' is its counterpart (a torch.export .pt2)")
    if format in ("tflite", "saved_model", "pb"):
        raise RuntimeError(f"format={format!r} needs TensorFlow (jax2tf and the TFLite converter "
                           "in the JAX package), which this package does not use; export "
                           "format='exported' or format='params' instead")
    if format == "onnx":
        raise RuntimeError("format='onnx' needs TensorFlow and the `tf2onnx` package (the JAX "
                           "package converts a SavedModel), which this package does not use; "
                           "export format='exported' or format='params' instead")
    raise ValueError(f"unknown export format {format!r} (exported|params; the JAX package also "
                     "writes stablehlo|tflite|saved_model|onnx)")
