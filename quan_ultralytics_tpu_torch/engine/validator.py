"""Validator: run a model over a labelled split and compute mAP, axis-aligned
(detect, segment, pose) or rotated (OBB), and the segment task's mask mAP
and the pose task's OKS mAP (counterpart of the JAX package's
``engine/validator.py``).

Per batch, one upload of the uint8 images (from pinned memory when the model
is on the card) and one device pass, `Predictor.infer`'s: forward, decode
and NMS under ``torch.inference_mode``; the kept detections come back to the
host once. The segment task's masks and their IoU are computed on the
device, an image at a time (the prototypes stay there). Matching, AP, the
confusion matrix, COCO-style JSON and the DOTA Task1 files are host work,
as in JAX (reference engine/validator.py
BaseValidator, models/yolo/detect/val.py, obb/val.py, segment/val.py and
pose/val.py).

The Validator runs on the device of the model's parameters; a model on the
card is validated there. ``rect`` batches (not OBB, as in JAX) are each
letterboxed to their own stride-32 shape. With a ``mesh`` (the JAX option)
every rank loads each batch, infers its rows of it, and gathers the
detections (`Predictor.infer`), so every rank's matching and metrics are
the single-process ones.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.data.build import build_dataloader
from quan_ultralytics_tpu_torch.data.dataset import YOLODataset
from quan_ultralytics_tpu_torch.data.native import pixels
from quan_ultralytics_tpu_torch.engine.dota_eval import DOTASubmission
from quan_ultralytics_tpu_torch.engine.predictor import Predictor
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.ops.boxes import scale_boxes, scale_rboxes, xywh2xyxy
from quan_ultralytics_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, kpt_oks_np, mask_iou_np


def _crop_to_boxes(m: torch.Tensor, boxes: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Each mask ``[n, H, W]`` above 0.5 and inside its xyxy box scaled by (sx, sy)."""
    H, W = m.shape[1:]
    yy = torch.arange(H, device=m.device)[None, :, None]
    xx = torch.arange(W, device=m.device)[None, None, :]
    b = boxes[:, :, None, None]
    inside = (xx >= b[:, 0] * sx) & (xx < b[:, 2] * sx) & (yy >= b[:, 1] * sy) & (yy < b[:, 3] * sy)
    return (m > 0.5) & inside


class Validator:
    def __init__(self, model: DetectionModel, imgsz: int = 640, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, mesh=None):
        self.model = model
        self.imgsz = imgsz
        # the device pass is the Predictor's: forward, decode, NMS (sharded under a mesh)
        self.predictor = Predictor(model, imgsz=imgsz, conf=conf, iou=iou, max_det=max_det, mesh=mesh)
        self.infer = self.predictor.infer
        self.speed: Dict[str, float] = {}

    def _mask_iou(self, batch, b: int, gmask: np.ndarray, mc: np.ndarray, proto: torch.Tensor,
                  pred_boxes: np.ndarray, native: bool) -> Optional[np.ndarray]:
        """Mask IoU ``[n_gt, n_pred]`` of image ``b`` (reference segment/val.py
        _process_batch with masks), computed on the prototypes' device:
        ``sigmoid(mc @ proto)`` in f32, then either at proto resolution against
        the loader's masks (reference process_mask), or with ``native`` resized
        bilinearly to the input's resolution against the polygons filled there
        (reference process_mask_native; DEVIATIONS.md section 5); each mask cut
        to its box. Only the IoU matrix comes back to the host (at 640 a batch's
        300 masks an image are 491 MB in f32)."""
        n_gt = int(gmask.sum())
        if not (n_gt and len(mc)):
            return None
        Hb, Wb = batch["img"].shape[1:3]
        Hp, Wp, nm = proto.shape
        dev = proto.device
        with torch.inference_mode():
            prob = torch.sigmoid(torch.from_numpy(mc).to(dev) @ proto.float().reshape(-1, nm).T)
            prob = prob.reshape(-1, Hp, Wp)
            boxes = torch.from_numpy(pred_boxes).to(dev)
            if native:
                prob = F.interpolate(prob[None], size=(Hb, Wb), mode="bilinear", align_corners=False)[0]
                gtm = np.zeros((n_gt, Hb, Wb), np.uint8)
                for j, poly in enumerate(batch["polys"][b][:n_gt]):
                    pixels.fill_polygons(gtm[j], [poly.astype(np.int32)])
                pm = _crop_to_boxes(prob, boxes, 1.0, 1.0)
            else:
                gtm = batch["masks"][b][gmask]
                pm = _crop_to_boxes(prob, boxes, Wp / Wb, Hp / Hb)
            return mask_iou_np(torch.from_numpy(gtm).to(dev) > 0, pm).cpu().numpy()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(img)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __call__(self, ds: YOLODataset, batch_size: int = 8, max_labels: int = 256,
                 save_json: Optional[str] = None, save_submission: Optional[str] = None,
                 rect: bool = False, mask_native: bool = False,
                 save_dir: Optional[str] = None) -> Dict[str, float]:
        """Validate on ``ds``; returns ``{mAP50, mAP50-95, precision, recall}``
        of the boxes, and for the segment task ``mAP50(M)`` and ``mAP50-95(M)``
        of the masks, for the pose task ``mAP50(P)`` and ``mAP50-95(P)`` by OKS
        (with the ground truth's box area times 0.53 as its scale).

        save_json: COCO-style detections in source-image coordinates (reference
          detect/val.py pred_to_json): ``bbox`` ``[x1, y1, w, h]``, and the OBB
          task's ``angle``.
        save_submission: a DOTA Task1 directory (OBB only): patch predictions
          mapped back to their source image by the ``{stem}__{x}_{y}`` naming,
          merged with rotated NMS, written as ``Task1_{class}.txt`` (`DOTASubmission`).
        rect: rectangular batches (not OBB; reference data/base.py
          set_rectangle): sorted by aspect ratio, each letterboxed to its own
          stride-32 shape; ground truths are scaled by the batch's width and height.
        mask_native: segment only: score the masks at the network input's
          resolution (upsampled, the ground truth filled from the letterboxed
          polygons) instead of at the prototypes' (the default).
        save_dir: the per-class table as ``per_class.txt``, the four curves
          (``PR_curve.png``, ``F1_curve.png``, ``P_curve.png``, ``R_curve.png``)
          and both confusion matrices (``confusion_matrix.png``,
          ``confusion_matrix_normalized.png``), as the JAX Validator writes them.

        ``self.confusion`` and ``self.metrics`` hold the run's confusion matrix
        and accumulated matches; ``self.speed`` the host-clock ms a batch of
        loading and letterboxing (``load_ms``), the device pass with its copies
        (``infer_ms``) and matching (``match_ms``), and ``img_s``.
        """
        rotated = self.model.task == "obb"
        if rotated and rect:
            raise ValueError("rect batching is not supported for the OBB task")
        if save_submission and not rotated:
            raise ValueError("DOTA submissions are an OBB-task output")
        task, n_extra = self.model.task, self.model.extra_dim
        metrics = DetMetrics(nc=self.model.nc, rotated=rotated)
        # the second metric head: mask mAP (segment) or OKS mAP (pose)
        metrics2 = DetMetrics(nc=self.model.nc) if task in ("segment", "pose") else None
        self.confusion = ConfusionMatrix(nc=self.model.nc)
        json_dets: Optional[List[Dict]] = [] if save_json else None
        submission = DOTASubmission(ds.names) if save_submission else None
        was_training = self.model.training
        self.model.eval()
        times = {"load_ms": 0.0, "infer_ms": 0.0, "match_ms": 0.0}
        n_batches = n_images = 0
        t_all = time.perf_counter()
        loader = build_dataloader(ds, batch_size, self.imgsz, hyp=None, max_labels=max_labels,
                                  augment=False, shuffle=False, drop_last=False, with_meta=True,
                                  rect=rect)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(loader, None)
                if batch is None:
                    break
                t1 = time.perf_counter()
                det, ok, proto = self.infer(self._upload(batch["img"]))
                det, ok = det.float().cpu().numpy(), ok.cpu().numpy()
                t2 = time.perf_counter()
                Hb, Wb = batch["img"].shape[1:3]  # (imgsz, imgsz) unless rect
                # the tail batch repeats indices to fill up; only n_real are scored
                n_real = int(batch.get("n_real", det.shape[0]))
                for b in range(min(det.shape[0], n_real)):
                    keep = ok[b]
                    extras = det[b, keep, det.shape[2] - n_extra:]
                    gmask = batch["mask"][b]
                    gb = batch["bboxes"][b][gmask]  # normalized xywhr (OBB) or xywh
                    if rotated:
                        pred_boxes = det[b, keep, :5]  # xywhr, letterbox pixels
                        conf, cls = det[b, keep, 5], det[b, keep, 6]
                        gt_boxes = gb.copy()
                        gt_boxes[:, :4] *= Hb  # OBB batches are square
                        src_boxes = scale_rboxes(pred_boxes, batch["ratio_pad"][b])
                    else:
                        pred_boxes = det[b, keep, :4]  # xyxy, letterbox pixels
                        conf, cls = det[b, keep, 4], det[b, keep, 5]
                        scale = np.array([Wb, Hb, Wb, Hb], np.float32)
                        gt_boxes = xywh2xyxy(torch.from_numpy(gb * scale)).numpy()
                        src_boxes = scale_boxes(pred_boxes, batch["ratio_pad"][b], batch["ori_shape"][b])
                    gt_cls = batch["cls"][b][gmask].astype(np.float32)
                    metrics.update(pred_boxes, conf, cls.astype(np.float32), gt_boxes, gt_cls)
                    self.confusion.process_batch(pred_boxes, conf, cls, gt_boxes, gt_cls,
                                                 rotated=rotated)
                    if task == "segment":
                        iou2 = self._mask_iou(batch, b, gmask, extras, proto[b], pred_boxes,
                                              mask_native and "polys" in batch)
                    elif task == "pose":
                        gk = batch["keypoints"][b][gmask].astype(np.float32)
                        gk[..., 0] *= Wb
                        gk[..., 1] *= Hb
                        area = np.maximum((gt_boxes[:, 2] - gt_boxes[:, 0])
                                          * (gt_boxes[:, 3] - gt_boxes[:, 1]), 1.0) * 0.53
                        pk = extras.reshape(-1, *self.model.kpt_shape)
                        iou2 = kpt_oks_np(gk, area, pk) if len(gk) and len(pk) else None
                    if metrics2 is not None:
                        metrics2.update(pred_boxes, conf, cls.astype(np.float32), gt_boxes, gt_cls, iou=iou2)
                    stem = Path(batch["im_files"][b]).stem
                    if submission is not None:
                        submission.add_patch(stem, src_boxes, conf, cls)
                    if json_dets is not None:
                        for bi in range(len(src_boxes)):
                            extra = {}
                            if rotated:
                                x, y, w, h, r = src_boxes[bi][:5]
                                box = [float(x - w / 2), float(y - h / 2), float(w), float(h)]
                                extra = {"angle": float(r)}
                            else:
                                x1, y1, x2, y2 = src_boxes[bi][:4]
                                box = [float(x1), float(y1), float(x2 - x1), float(y2 - y1)]
                            json_dets.append({
                                "image_id": stem, "category_id": int(cls[bi]),
                                "bbox": [round(v, 3) for v in box],
                                "score": round(float(conf[bi]), 5), **extra,
                            })
                times["load_ms"] += 1e3 * (t1 - t0)
                times["infer_ms"] += 1e3 * (t2 - t1)
                times["match_ms"] += 1e3 * (time.perf_counter() - t2)
                n_batches += 1
                n_images += min(det.shape[0], n_real)
        finally:
            loader.close()
            self.model.train(was_training)
        if json_dets is not None:
            Path(save_json).write_text(json.dumps(json_dets))
        if submission is not None:
            submission.write(save_submission)
        out = metrics.compute()
        if metrics2 is not None:
            suffix = "(M)" if task == "segment" else "(P)"
            out.update({f"{k}{suffix}": v for k, v in metrics2.compute().items() if k.startswith("mAP")})
        self.metrics = metrics
        if save_dir is not None:
            d = Path(save_dir)
            d.mkdir(parents=True, exist_ok=True)
            metrics.plot(d, ds.names)
            self.confusion.plot(d, ds.names, normalize=False)
            self.confusion.plot(d, ds.names, normalize=True)
            (d / "per_class.txt").write_text(metrics.per_class_table(ds.names) + "\n")
        wall = time.perf_counter() - t_all
        self.speed = {k: v / max(n_batches, 1) for k, v in times.items()}
        self.speed["img_s"] = n_images / wall if wall > 0 else float("nan")
        return out
