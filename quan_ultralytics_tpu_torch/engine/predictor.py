"""Predictor: uint8 frames -> Results (counterpart of the JAX
``engine/predictor.py``: the detect, OBB, segment and pose tasks).

Every step after the upload runs on the model's device: letterbox, the
/255 normalize, forward, decode (`decode_detect`, `decode_obb`,
`decode_segment` or `decode_pose`), NMS (axis-aligned or rotated; the mask
coefficients or keypoints ride along). Segment masks are assembled there
too (`process_masks`). The kept boxes come back to the host and are
mapped to the source frame: xyxy boxes and keypoints clipped to it, xywhr
boxes regularized. A path (an image file or a directory of them) is read
by `data.loaders.load_source`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.data.augment import letterbox
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.ops.boxes import (non_max_suppression, regularize_rboxes,
                                                   xywhr2xyxyxyxy)
from quan_ultralytics_tpu_torch.parallel.mesh import Mesh, gather_rows, replicate

if TYPE_CHECKING:
    from quan_ultralytics_tpu_torch.engine.exporter import ExportedBackend


@dataclass
class Results:
    """Detections of one frame (reference engine/results.py:187, OBB :1596,
    Masks :1305, Keypoints :1417) with the user-facing surface: verbose /
    save_txt / summary / tojson."""

    orig_shape: tuple
    # [n, 6]: xyxy, conf, cls (detect, segment, pose); [n, 7]: xywhr, conf, cls (OBB); source pixels
    boxes: np.ndarray
    names: Optional[List[str]] = None
    task: str = "obb"
    orig_img: Any = None  # the source frame as given (numpy array or tensor)
    masks: Optional[np.ndarray] = None  # segment: [n, h0, w0] bool
    keypoints: Optional[np.ndarray] = None  # pose: [n, nk, ndim], source pixels (and visibility)

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
        """The source frame annotated with the detections (reference
        results.py:484; the JAX ``Results.plot``): masks blended at 0.6 / 0.4
        in a colour of their index, boxes or rotated boxes with "{name}
        {conf:.2f}" labels, keypoints with visibility above 0.5 as green
        filled circles of radius 3. Returns the RGB array; ``filename``
        writes it (a ``.jpg`` is OpenCV's JPEG of it)."""
        from quan_ultralytics_tpu_torch.data.native import pixels
        from quan_ultralytics_tpu_torch.data.native.native import imwrite
        from quan_ultralytics_tpu_torch.utils.plotting import Annotator

        if self.orig_img is None:
            raise ValueError("Results.plot needs orig_img (predict stores it)")
        im = self.orig_img
        im = (im.detach().cpu().numpy() if isinstance(im, torch.Tensor) else np.asarray(im)).copy()
        if self.masks is not None and len(self.masks):
            for i, mk in enumerate(self.masks):
                color = np.array([(37 * (i + 1)) % 255, (97 * (i + 1)) % 255,
                                  (173 * (i + 1)) % 255], np.uint8)
                mk = np.asarray(mk, bool)
                im[mk] = (0.6 * im[mk] + 0.4 * color).astype(np.uint8)
        ann = Annotator(im, self.names)
        for row in self.boxes:
            c = int(row[-1])
            label = f"{self._name(c)} {row[-2]:.2f}"
            (ann.obb_label if self.task == "obb" else ann.box_label)(
                row[:5] if self.task == "obb" else row[:4], label, c)
        if self.keypoints is not None:
            for k in self.keypoints:
                for x, y, v in k[:, :3]:
                    if v > 0.5:
                        pixels.circle(ann.im, (int(x), int(y)), 3, (0, 255, 0), -1)
        out = ann.result()
        if filename:
            Path(filename).parent.mkdir(parents=True, exist_ok=True)
            imwrite(str(filename), out)
        return out

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
        """Append the reference's label lines (results.py:620 Results.save_txt),
        normalized by the frame's size: detect and segment 'cls xc yc w h
        [conf]', OBB 'cls x1 y1 ... x4 y4 [conf]' (the four corners), pose
        'cls xc yc w h' and 'x y vis' a keypoint, then '[conf]'."""
        h0, w0 = self.orig_shape
        corners = self._corners() if self.task == "obb" else None
        lines = []
        for i, row in enumerate(self.boxes):
            c, conf = int(row[-1]), float(row[-2])
            if corners is not None:
                vals = (corners[i] / np.array([w0, h0])).reshape(-1).tolist()
            else:
                x1, y1, x2, y2 = row[:4]
                vals = [(x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0, (x2 - x1) / w0, (y2 - y1) / h0]
            if self.keypoints is not None:
                k = self.keypoints[i].astype(np.float64)
                k[:, 0] /= w0
                k[:, 1] /= h0
                vals += k.reshape(-1).tolist()
            if save_conf:
                vals.append(conf)
            lines.append(" ".join([str(c)] + [f"{v:.6g}" for v in vals]))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        with open(txt_file, "a") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))

    def summary(self, decimals: int = 5) -> List[Dict]:
        """List-of-dicts form (reference results.py:700): the box as x1 y1 x2 y2
        (detect, segment, pose) or the four corners (OBB); pose adds the
        keypoints' x, y and visibility."""
        if self.task == "obb":
            keys, boxes = ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"), self._corners().reshape(-1, 8)
        else:
            keys, boxes = ("x1", "y1", "x2", "y2"), self.boxes[:, :4]
        out = []
        for i, (row, box) in enumerate(zip(self.boxes, boxes)):
            c = int(row[-1])
            item = {
                "name": self._name(c), "class": c,
                "confidence": round(float(row[-2]), decimals),
                "box": {k: round(float(v), decimals) for k, v in zip(keys, box)},
            }
            if self.keypoints is not None:
                k = self.keypoints[i]
                item["keypoints"] = {name: [round(float(v), decimals) for v in k[:, j]]
                                     for j, name in enumerate(("x", "y", "visible"))}
            out.append(item)
        return out

    def tojson(self, decimals: int = 5) -> str:
        """JSON string of `summary` (reference results.py:735 Results.to_json)."""
        return json.dumps(self.summary(decimals=decimals), indent=2)


MASK_CHUNK = 32  # masks resized at a time: 32 frame-sized f32 masks at 1080p are 265 MB


def process_masks(mc: torch.Tensor, proto: torch.Tensor, boxes: torch.Tensor, imgsz: int,
                  orig: Tuple[int, int], ratio_pad: Tuple[float, int, int]) -> torch.Tensor:
    """Masks of one frame's kept detections in its source pixels (the JAX
    Predictor's ``_process_masks``; reference ops.process_mask + scale_masks):
    ``sigmoid(mc @ proto)`` in f32 at proto resolution, cut to the letterbox's
    content (its edges rounded half to even, as Python's ``round``), resized
    bilinearly (half-pixel centres, as ``cv2.resize``'s INTER_LINEAR) to the
    frame, above 0.5 and inside the box (truncated to whole pixels).

    mc ``[n, nm]``, proto ``[Hp, Wp, nm]``, boxes ``[n, 4]`` xyxy source pixels,
    ``orig`` ``(h0, w0)``, ``ratio_pad`` ``(r, dw, dh)``. Returns bool ``[n, h0, w0]``
    on the device of ``proto``.
    """
    h0, w0 = orig
    r, dw, dh = ratio_pad
    n, dev = mc.shape[0], proto.device
    out = torch.zeros((n, h0, w0), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    Hp, Wp, nm = proto.shape
    sy, sx = Hp / imgsz, Wp / imgsz
    y0, y1 = max(int(round(dh * sy)), 0), max(int(round((dh + h0 * r) * sy)), 1)
    x0, x1 = max(int(round(dw * sx)), 0), max(int(round((dw + w0 * r) * sx)), 1)
    m = torch.sigmoid(mc.float().to(dev) @ proto.float().reshape(-1, nm).T).reshape(n, Hp, Wp)
    crop = m[:, y0:y1, x0:x1]
    b = boxes.to(dev)
    xa, ya = b[:, 0].clamp(min=0).long(), b[:, 1].clamp(min=0).long()
    xb, yb = b[:, 2].clamp(max=w0).long(), b[:, 3].clamp(max=h0).long()
    xx = torch.arange(w0, device=dev)
    yy = torch.arange(h0, device=dev)
    for i in range(0, n, MASK_CHUNK):
        j = slice(i, i + MASK_CHUNK)
        full = F.interpolate(crop[None, j], size=(h0, w0), mode="bilinear", align_corners=False)[0]
        keep = (((xx >= xa[j, None]) & (xx < xb[j, None]))[:, None, :]
                & ((yy >= ya[j, None]) & (yy < yb[j, None]))[:, :, None])
        out[j] = (full > 0.5) & keep
    return out


class Predictor:
    """Prediction with a port `DetectionModel` on the model's device (the
    detect, OBB, segment and pose tasks), or with an exported artifact
    (`engine.exporter.ExportedBackend`, detect and OBB at its fixed
    ``imgsz``, which has the model's surface used here)."""

    def __init__(self, model: Union[DetectionModel, "ExportedBackend"], imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 names: Optional[List[str]] = None, mesh: Optional[Mesh] = None,
                 defer_argmax: bool = False):
        self.model = model
        self.imgsz, self.conf, self.iou, self.max_det = imgsz, conf, iou, max_det
        self.defer_argmax = defer_argmax  # NMS's class id from the candidate rows (JAX's QUAN_NMS_DEFER_ARGMAX)
        self.names = names
        self.device = next(model.parameters()).device
        self.mesh = mesh
        if mesh is not None and isinstance(model, torch.nn.Module):
            replicate(mesh, model)

    @torch.inference_mode()
    def infer(self, x: torch.Tensor):
        """uint8 ``[B, H, W, 3]`` on the device -> (det ``[B, max_det, 6 +
        extra]``: xyxy, conf, cls and the segment task's mask coefficients or
        the pose task's decoded keypoints, or ``[B, max_det, 7]``: xywhr, conf,
        cls for OBB, in the input's pixels; keep mask ``[B, max_det]``; the
        segment task's prototypes ``[B, Hp, Wp, nm]``, else None), as the JAX
        package's jitted ``_infer``.

        Under a mesh (the JAX ``mesh=``) each rank infers its rows of ``x``
        and the results are gathered, so every rank returns the whole
        batch's; a batch whose rows do not divide runs whole on every rank."""
        mesh = self.mesh
        if mesh is None or not mesh.shards(x.shape[0]):
            return self._infer(x)
        return tuple(gather_rows(mesh, t) for t in self._infer(x[mesh.rows(x.shape[0])]))

    def _infer(self, x: torch.Tensor):
        img = x.float() / 255.0
        out = self.model(img)
        det, ok = non_max_suppression(self.model.decode(out), conf_thres=self.conf, iou_thres=self.iou,
                                      max_det=self.max_det, nc=self.model.nc,
                                      rotated=self.model.task == "obb", extra_dim=self.model.extra_dim,
                                      defer_argmax=self.defer_argmax)
        return det, ok, out[2] if self.model.task == "segment" else None

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
        det, ok, proto = self.infer(torch.stack(batch))
        det, ok = det.cpu(), ok.cpu()

        task, extra = self.model.task, self.model.extra_dim
        results = []
        for b, (h0, w0, r, dw, dh) in enumerate(meta):
            d = det[b][ok[b]]
            extras, d = d[:, d.shape[1] - extra:], d[:, :d.shape[1] - extra]
            masks = keypoints = None
            if task == "obb":
                d[:, 0] = (d[:, 0] - dw) / r
                d[:, 1] = (d[:, 1] - dh) / r
                d[:, 2:4] /= r
                d[:, :5] = regularize_rboxes(d[:, :5])
            else:  # xyxy, clipped to the frame (JAX predictor.py:283-285)
                d[:, [0, 2]] = ((d[:, [0, 2]] - dw) / r).clamp(0, w0)
                d[:, [1, 3]] = ((d[:, [1, 3]] - dh) / r).clamp(0, h0)
            if task == "segment":
                with torch.inference_mode():
                    masks = process_masks(extras, proto[b], d[:, :4], self.imgsz, (h0, w0),
                                          (r, dw, dh)).cpu().numpy()
            elif task == "pose":
                k = extras.reshape(len(d), *self.model.kpt_shape).clone()
                k[..., 0] = ((k[..., 0] - dw) / r).clamp(0, w0)
                k[..., 1] = ((k[..., 1] - dh) / r).clamp(0, h0)
                keypoints = k.numpy()
            results.append(Results((h0, w0), d.numpy(), self.names, task, orig_img=images[b],
                                   masks=masks, keypoints=keypoints))
        return results
