"""Detection and OBB training losses (counterpart of the JAX ``losses/detect.py``).

Reference ultralytics/utils/loss.py v8DetectionLoss (:398-502) and v8OBBLoss
(:853-1047, with the QUAN quaternion angular term). Ground truths arrive as
padded fixed-size tensors with a validity mask, and every data-dependent
branch is a ``where``. The loss runs in f32 whatever the model's compute
dtype. `detect_terms` is the core the segment and pose losses build on.

Inside `parallel.mesh.data_parallel` a rank's loss is its part of the global
batch's: the normalisers (``target_scores_sum``, the foreground count) are
summed over the ranks and the batch size is the global one, so the ranks'
losses and gradients sum to the single-process ones (JAX's sharded step).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.losses.tal import AssignResult, task_aligned_assigner
from quan_ultralytics_tpu_torch.models.block import dfl as dfl_decode
from quan_ultralytics_tpu_torch.models.head import flatten_levels
from quan_ultralytics_tpu_torch.ops.boxes import (bbox2dist, bbox_iou, dist2bbox, dist2rbox, make_anchors,
                                                   probiou, xywh2xyxy)
from quan_ultralytics_tpu_torch.parallel.mesh import global_rows, global_sum


class LossHyp(NamedTuple):
    """Loss gains (reference cfg/default.yaml:99-101 and the QUAN extras, loss.py:866-867)."""

    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    lambda_angular: float = 0.5
    lambda_reg: float = 0.05


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (no reduction)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss (reference loss.py:306-330): cross-entropy
    against the two integer bins around the target, linearly weighted, as a
    two-hot contraction. ``pred_dist`` ``[..., 4, reg_max]`` logits, ``target``
    ``[..., 4]``; returns ``[...]``, the mean over the four sides."""
    t = target.clamp(0, reg_max - 1 - 0.01)
    tl = torch.floor(t).long()
    tr = tl + 1
    wl = tr.float() - t
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    bins = torch.arange(reg_max, device=pred_dist.device)
    w2 = (wl[..., None] * (bins == tl[..., None])
          + wr[..., None] * (bins == tr.clamp(0, reg_max - 1)[..., None]))
    return -(logp * w2).sum(dim=-1).mean(dim=-1)


def _split_preds(feats: Sequence[torch.Tensor], nc: int, reg_max: int):
    """Per-level head maps -> (box logits ``[B, A, 4 reg_max]``, class logits ``[B, A, nc]``), f32."""
    x = flatten_levels(feats).float()
    if x.shape[-1] != 4 * reg_max + nc:
        raise ValueError(f"head channels {x.shape[-1]} != 4*{reg_max}+{nc}")
    return x[..., :4 * reg_max], x[..., 4 * reg_max:]


def detection_loss(
    feats: Sequence[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    hyp: LossHyp = LossHyp(),
    assigner_bf16: bool = False,
    assigner_impl: str = "dense",
    topk_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Axis-aligned v8 detection loss (reference loss.py:398-502).

    batch: ``cls`` ``[B, M]`` int, ``bboxes`` ``[B, M, 4]`` normalized xywh,
    ``mask`` ``[B, M]`` bool. ``assigner_bf16``, ``assigner_impl`` and
    ``topk_impl`` as in `obb_loss`.
    Returns ``(total, aux)`` with ``total`` = sum of the weighted terms times
    the batch size (the reference's ``loss.sum() * batch_size``).
    """
    loss_iou, loss_cls, loss_dfl, assign, ctx = detect_terms(
        feats, batch, strides, nc, reg_max, assigner_bf16=assigner_bf16,
        assigner_impl=assigner_impl, topk_impl=topk_impl)
    total = (hyp.box * loss_iou + hyp.cls * loss_cls + hyp.dfl * loss_dfl) * global_rows(ctx["B"])
    aux = {
        "box": hyp.box * loss_iou,
        "cls": hyp.cls * loss_cls,
        "dfl": hyp.dfl * loss_dfl,
        "num_fg": assign.fg_mask.sum(),
    }
    return total, aux


def detect_terms(
    feats: Sequence[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    assigner_bf16: bool = False,
    assigner_impl: str = "dense",
    topk_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, AssignResult, Dict[str, Any]]:
    """The detect loss's core, shared with the segment and pose losses: the
    assigner and the class BCE, box CIoU and DFL terms (loss.py:339-355, :486).
    Returns ``(loss_iou, loss_cls, loss_dfl, assign, ctx)``; ``ctx`` carries the
    geometry the task-specific terms need."""
    pred_distri, pred_scores = _split_preds(feats, nc, reg_max)
    B, A, _ = pred_scores.shape
    dev = pred_scores.device
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors, stride_t = make_anchors(shapes, strides, 0.5, device=dev)
    imgsz_h = feats[0].shape[1] * strides[0]
    imgsz_w = feats[0].shape[2] * strides[0]
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=dev)

    gt_xyxy = xywh2xyxy(batch["bboxes"][..., :4].float() * scale)
    mask_gt = batch["mask"].bool() & (gt_xyxy.sum(-1) > 0)

    # decode in grid units -> [B, A, 4] xyxy
    pd = dfl_decode(pred_distri, reg_max)
    pred_bboxes = dist2bbox(pd, anchors[None], xywh=False)

    assign = task_aligned_assigner(  # the assigner takes no gradient
        torch.sigmoid(pred_scores.detach()),
        pred_bboxes.detach() * stride_t[None],
        anchors * stride_t,
        batch["cls"],
        gt_xyxy,
        mask_gt,
        num_classes=nc,
        topk=10,
        alpha=0.5,
        beta=6.0,
        bf16_metric=assigner_bf16,
        impl=assigner_impl,
        topk_impl=topk_impl,
    )
    target_scores_sum = global_sum(assign.target_scores.sum()).clamp(min=1.0)
    fg = assign.fg_mask

    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / target_scores_sum

    # box CIoU + DFL on the foreground, masked, not gathered
    tb = assign.target_bboxes / stride_t[None]  # grid units, xyxy
    weight = assign.target_scores.sum(-1) * fg
    safe_tb = torch.where(fg[..., None], tb, pred_bboxes)  # no NaN on padding
    iou = bbox_iou(pred_bboxes, safe_tb, xywh=False, ciou=True)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchors[None], safe_tb, reg_max - 1)
    dflv = _dfl_loss(pred_distri.reshape(B, A, 4, reg_max), target_ltrb, reg_max)
    loss_dfl = (dflv * weight).sum() / target_scores_sum

    ctx = {"B": B, "A": A, "anchors": anchors, "stride_t": stride_t, "weight": weight,
           "target_scores_sum": target_scores_sum, "imgsz": (imgsz_h, imgsz_w), "fg": fg}
    return loss_iou, loss_cls, loss_dfl, assign, ctx


def _angle_to_quaternion(angles: torch.Tensor) -> torch.Tensor:
    """z-axis rotation quaternion [cos t/2, 0, 0, sin t/2] (loss.py:870-883)."""
    half = angles / 2
    z = torch.zeros_like(half)
    return torch.cat([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def quaternion_angular_loss(q_pred: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """SO(3) geodesic distance 2 arccos |<q_p, q_t>|, double cover included
    (reference loss.py:884-911)."""
    qp = q_pred / torch.linalg.vector_norm(q_pred, dim=-1, keepdim=True).clamp(min=1e-12)
    qt = q_target / torch.linalg.vector_norm(q_target, dim=-1, keepdim=True).clamp(min=1e-12)
    dot = (qp * qt).sum(-1).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    return 2.0 * torch.arccos(dot.abs())


def obb_loss(
    preds: Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    hyp: LossHyp = LossHyp(),
    assigner_bf16: bool = False,
    assigner_impl: str = "dense",
    topk_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OBB loss with the QUAN quaternion angular term (loss.py:853-1047).

    preds: ``(feats, angles)`` of the OBB head, angles in [-pi/4, 3pi/4].
    batch: ``cls`` ``[B, M]`` int, ``bboxes`` ``[B, M, 5]`` normalized xywhr
    (x, y, w, h in [0, 1], r in radians), ``mask`` ``[B, M]`` bool.
    ``assigner_bf16`` runs the assigner's metric chain in bf16 (the trainer
    passes True; a standalone call keeps exact f32). ``assigner_impl``
    (``dense`` | ``sparse``) and ``topk_impl`` (``iter`` | ``chunk``, None: by
    ``topk``) pick the assigner's form (`losses.tal.task_aligned_assigner`):
    the same targets either way.
    Returns ``(total, aux)`` with ``total`` = sum of the weighted terms times
    the batch size (the reference's ``loss.sum() * batch_size``).
    """
    feats, angles = preds
    pred_distri, pred_scores = _split_preds(feats, nc, reg_max)
    pred_angle = flatten_levels(angles).float()  # [B, A, 1]
    B, A, _ = pred_scores.shape
    dev = pred_scores.device
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors, stride_t = make_anchors(shapes, strides, 0.5, device=dev)
    imgsz_h = feats[0].shape[1] * strides[0]
    imgsz_w = feats[0].shape[2] * strides[0]

    gt = batch["bboxes"].float()
    gt_xywhr = torch.cat([gt[..., 0:1] * imgsz_w, gt[..., 1:2] * imgsz_h, gt[..., 2:3] * imgsz_w,
                          gt[..., 3:4] * imgsz_h, gt[..., 4:5]], dim=-1)
    # tiny-rbox filter (loss.py:966-968)
    mask_gt = batch["mask"].bool() & (gt_xywhr[..., 2] >= 2) & (gt_xywhr[..., 3] >= 2)

    # rotated decode in grid units -> [B, A, 5] (loss.py:1029-1047)
    pd = dfl_decode(pred_distri, reg_max)
    pred_rbox = torch.cat([dist2rbox(pd, pred_angle, anchors[None]), pred_angle], dim=-1)

    seen = pred_rbox.detach()  # the assigner takes no gradient
    assign = task_aligned_assigner(
        torch.sigmoid(pred_scores.detach()),
        torch.cat([seen[..., :4] * stride_t[None], seen[..., 4:5]], dim=-1),
        anchors * stride_t,
        batch["cls"],
        gt_xywhr,
        mask_gt,
        num_classes=nc,
        topk=10,
        alpha=0.5,
        beta=6.0,
        rotated=True,
        bf16_metric=assigner_bf16,
        impl=assigner_impl,
        topk_impl=topk_impl,
    )
    target_scores_sum = global_sum(assign.target_scores.sum()).clamp(min=1.0)
    fg = assign.fg_mask

    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / target_scores_sum

    # rotated box loss: probiou + DFL (loss.py:357-379), masked, not gathered
    tb = torch.cat([assign.target_bboxes[..., :4] / stride_t[None], assign.target_bboxes[..., 4:5]],
                   dim=-1)
    weight = assign.target_scores.sum(-1) * fg
    safe_tb = torch.where(fg[..., None], tb, pred_rbox)
    iou = probiou(pred_rbox, safe_tb)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchors[None], xywh2xyxy(safe_tb[..., :4]), reg_max - 1)
    dflv = _dfl_loss(pred_distri.reshape(B, A, 4, reg_max), target_ltrb, reg_max)
    loss_dfl = (dflv * weight).sum() / target_scores_sum

    # quaternion angular loss (QUAN, loss.py:1010-1027)
    q_pred = _angle_to_quaternion(pred_rbox[..., 4:5])
    q_tgt = _angle_to_quaternion(safe_tb[..., 4:5])
    loss_ang = (quaternion_angular_loss(q_pred, q_tgt) * weight).sum() / target_scores_sum
    # unit-norm regulariser (loss.py:913-922), mean over foreground; ~0, since
    # q_pred is unit by construction, kept for the value's parity
    norm_sq = (q_pred ** 2).sum(-1)
    reg = (((norm_sq - 1.0) ** 2) * fg).sum() / global_sum(fg.sum()).clamp(min=1)
    loss_quat = loss_ang + hyp.lambda_reg * reg

    total = (hyp.box * loss_iou + hyp.cls * loss_cls + hyp.dfl * loss_dfl
             + hyp.lambda_angular * loss_quat) * global_rows(B)
    aux = {
        "box": hyp.box * loss_iou,
        "cls": hyp.cls * loss_cls,
        "dfl": hyp.dfl * loss_dfl,
        "quat": hyp.lambda_angular * loss_quat,
        "num_fg": fg.sum(),
    }
    return total, aux
