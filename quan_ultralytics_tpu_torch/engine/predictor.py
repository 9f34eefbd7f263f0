"""Predictor: uint8 frames -> Results (counterpart of the JAX ``engine/predictor.py``, OBB task).

Every step after the upload runs on the model's device: letterbox, the
/255 normalize, forward, `decode_obb`, rotated fast-NMS. The kept boxes come
back to the host, are mapped to the source frame and regularized. A path
(an image file or a directory of them) is read by `data.loaders.load_source`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from quan_ultralytics_tpu_torch.data.augment import letterbox
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.ops.boxes import (non_max_suppression, regularize_rboxes,
                                                   xywhr2xyxyxyxy)


@dataclass
class Results:
    """Detections of one frame (reference engine/results.py:187, OBB :1596)
    with the user-facing surface: verbose / save_txt / summary / tojson."""

    orig_shape: tuple
    boxes: np.ndarray  # [n, 7]: xywhr in source pixels, conf, cls
    names: Optional[List[str]] = None
    task: str = "obb"
    orig_img: Any = None  # the source frame as given (numpy array or tensor)

    @property
    def xyxy(self) -> Optional[np.ndarray]:
        return self.boxes[:, :4] if self.task != "obb" else None

    @property
    def xywhr(self) -> Optional[np.ndarray]:
        return self.boxes[:, :5] if self.task == "obb" else None

    @property
    def conf(self) -> np.ndarray:
        return self.boxes[:, -2]

    @property
    def cls(self) -> np.ndarray:
        return self.boxes[:, -1]

    def __len__(self) -> int:
        return self.boxes.shape[0]

    def _name(self, c: int) -> str:
        return self.names[c] if self.names and c < len(self.names) else str(c)

    def _corners(self) -> np.ndarray:
        """OBB corner form ``[n, 4, 2]`` (reference results.py OBB.xyxyxyxy)."""
        return xywhr2xyxyxyxy(torch.from_numpy(self.boxes[:, :5])).numpy()

    def plot(self, filename: Optional[str] = None) -> np.ndarray:
        """Annotated frames need a line and text rasterizer and an image
        writer, which come with the port's ``utils/plotting.py``."""
        raise NotImplementedError("Results.plot is not ported yet (ROADMAP Queue 1 item 3b)")

    def verbose(self) -> str:
        """Per-class count string, '4 planes, 1 ship, ' style
        (reference results.py:599 Results.verbose)."""
        if not len(self):
            return "(no detections), "
        counts: Dict[int, int] = {}
        for c in self.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self._name(c)}{'s' * (n > 1)}, "
                       for c, n in sorted(counts.items()))

    def save_txt(self, txt_file: Union[str, Path], save_conf: bool = False) -> None:
        """Append the reference's label lines (results.py:620 Results.save_txt):
        'cls x1 y1 ... x4 y4 [conf]', corners normalized by the frame's size."""
        h0, w0 = self.orig_shape
        corners = self._corners()
        lines = []
        for i, row in enumerate(self.boxes):
            c, conf = int(row[-1]), float(row[-2])
            vals = (corners[i] / np.array([w0, h0])).reshape(-1).tolist()
            if save_conf:
                vals.append(conf)
            lines.append(" ".join([str(c)] + [f"{v:.6g}" for v in vals]))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        with open(txt_file, "a") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))

    def summary(self, decimals: int = 5) -> List[Dict]:
        """List-of-dicts form with the four corners (reference results.py:700)."""
        out = []
        for row, pts in zip(self.boxes, self._corners()):
            c = int(row[-1])
            out.append({
                "name": self._name(c), "class": c,
                "confidence": round(float(row[-2]), decimals),
                "box": {k: round(float(v), decimals) for k, v in zip(
                    ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"), pts.reshape(-1))},
            })
        return out

    def tojson(self, decimals: int = 5) -> str:
        """JSON string of `summary` (reference results.py:735 Results.to_json)."""
        return json.dumps(self.summary(decimals=decimals), indent=2)


class Predictor:
    """OBB prediction with a port `DetectionModel` on the model's device."""

    def __init__(self, model: DetectionModel, imgsz: int = 640, conf: float = 0.25,
                 iou: float = 0.45, max_det: int = 300, names: Optional[List[str]] = None):
        if model.task != "obb":
            raise NotImplementedError(f"task {model.task!r} is not ported yet; only 'obb' is")
        self.model = model
        self.imgsz, self.conf, self.iou, self.max_det = imgsz, conf, iou, max_det
        self.names = names
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def infer(self, x: torch.Tensor):
        """uint8 ``[B, imgsz, imgsz, 3]`` on the device -> (det ``[B, max_det, 7]``:
        xywhr, conf, cls in the input's pixels; keep mask ``[B, max_det]``)."""
        img = x.float() / 255.0
        pred = self.model.decode(self.model(img))
        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, nc=self.model.nc, rotated=True)

    def __call__(self, images: Union[str, Path, np.ndarray, torch.Tensor,
                                     Sequence[Union[np.ndarray, torch.Tensor]]]) -> List[Results]:
        """uint8 RGB frames ``[h, w, 3]`` (one, or a list of any sizes), or a
        path to an image file or a directory of them -> one Results each."""
        if isinstance(images, (str, Path)):
            images = list(load_source(images))
        elif isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 3:
            images = [images]
        batch, meta = [], []
        for im in images:
            t = torch.as_tensor(im).to(self.device, non_blocking=True)
            if t.dtype != torch.uint8 or t.ndim != 3 or t.shape[-1] != 3:
                raise ValueError(f"expected uint8 [h, w, 3] frames, got {t.dtype} {tuple(t.shape)}")
            lb, r, (dw, dh) = letterbox(t, self.imgsz)
            batch.append(lb)
            meta.append((t.shape[0], t.shape[1], r, dw, dh))
        det, ok = self.infer(torch.stack(batch))
        det, ok = det.cpu(), ok.cpu()

        results = []
        for b, (h0, w0, r, dw, dh) in enumerate(meta):
            d = det[b][ok[b]]
            d[:, 0] = (d[:, 0] - dw) / r
            d[:, 1] = (d[:, 1] - dh) / r
            d[:, 2:4] /= r
            d[:, :5] = regularize_rboxes(d[:, :5])
            results.append(Results((h0, w0), d.numpy(), self.names, "obb", orig_img=images[b]))
        return results
