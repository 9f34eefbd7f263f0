"""Segmentation and pose losses (counterpart of the JAX ``losses/segpose.py``;
reference utils/loss.py:504-786, v8SegmentationLoss and v8PoseLoss).

Fixed-shape versions: the reference gathers the dynamic foreground set; here
the task-specific terms run on the top-K anchors by assignment weight (K
static, ``max_fg``). Background and padding anchors carry zero weight, so the
sums are the reference's whenever an image has at most K foreground
anchors. Beyond K, the tie order of `_top_k` (index order, as ``lax.top_k``)
decides which anchors enter, as in the JAX package. Everything runs in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from quan_ultralytics_tpu_torch.losses.detect import LossHyp, _bce_logits, detect_terms
from quan_ultralytics_tpu_torch.models.head import decode_kpts, flatten_levels
from quan_ultralytics_tpu_torch.ops.boxes import _top_k
from quan_ultralytics_tpu_torch.parallel.mesh import global_rows, global_sum
from quan_ultralytics_tpu_torch.utils.metrics import OKS_SIGMA


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, k]]`` for ``x`` ``[B, N, ...]`` and ``idx`` ``[B, K]`` -> ``[B, K, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _topk_fg(ctx, assign, K: int):
    """The top-K anchors by assignment weight: (idx ``[B, K]``, weight ``[B, K]``,
    their assigned ground truth ``[B, K]``)."""
    sel_w, sel_idx = _top_k(ctx["weight"], K)
    return sel_idx, sel_w, torch.gather(assign.target_gt_idx, 1, sel_idx)


def segmentation_loss(
    preds: Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor], torch.Tensor],
    batch: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nc: int,
    reg_max: int = 16,
    hyp: LossHyp = LossHyp(),
    max_fg: int = 64,
    assigner_bf16: bool = False,
    assigner_impl: str = "dense",
    topk_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detect terms + mask BCE (reference loss.py:504-604): each selected
    anchor's mask ``mc @ proto`` (f32 logits) against its target's mask, inside
    the target box (``x1 <= x < x2`` in proto pixels), summed and divided by the
    box's area in proto pixels (at least 1).

    batch, beyond `detection_loss`'s: ``masks`` ``[B, M, Hp, Wp]`` instance masks
    at proto resolution (0/1, any dtype: uint8 from the loader).
    """
    feats, mc, proto = preds
    loss_iou, loss_cls, loss_dfl, assign, ctx = detect_terms(
        feats, batch, strides, nc, reg_max, assigner_bf16=assigner_bf16,
        assigner_impl=assigner_impl, topk_impl=topk_impl)
    B, A = ctx["B"], ctx["A"]
    Hp, Wp = proto.shape[1:3]
    imgsz_h, imgsz_w = ctx["imgsz"]
    dev = proto.device

    sel_idx, sel_w, tgt_gt = _topk_fg(ctx, assign, min(max_fg, A))
    sel_mc = _gather_rows(flatten_levels(mc).float(), sel_idx)  # [B, K, nm]
    pm = torch.einsum("bkn,bhwn->bkhw", sel_mc, proto.float())
    gtm = _gather_rows(batch["masks"], tgt_gt).float()  # [B, K, Hp, Wp]

    # the assigned target box in proto pixels (reference crop_mask)
    box = _gather_rows(assign.target_bboxes, sel_idx)  # [B, K, 4] xyxy input pixels
    sx, sy = Wp / imgsz_w, Hp / imgsz_h
    x1, y1, x2, y2 = box[..., 0] * sx, box[..., 1] * sy, box[..., 2] * sx, box[..., 3] * sy
    xx = torch.arange(Wp, dtype=torch.float32, device=dev)
    yy = torch.arange(Hp, dtype=torch.float32, device=dev)
    inside = (((xx >= x1[..., None]) & (xx < x2[..., None]))[..., None, :]
              & ((yy >= y1[..., None]) & (yy < y2[..., None]))[..., :, None])

    bce = _bce_logits(pm, gtm) * inside
    area = ((x2 - x1) * (y2 - y1)).clamp(min=1.0)
    per_anchor = bce.sum(dim=(2, 3)) / area  # [B, K]
    loss_mask = (per_anchor * (sel_w > 0)).sum() / ctx["target_scores_sum"]

    total = (hyp.box * loss_iou + hyp.cls * loss_cls + hyp.dfl * loss_dfl + hyp.box * loss_mask) * global_rows(B)
    aux = {"box": hyp.box * loss_iou, "cls": hyp.cls * loss_cls, "dfl": hyp.dfl * loss_dfl,
           "seg": hyp.box * loss_mask, "num_fg": assign.fg_mask.sum()}
    return total, aux


def pose_loss(
    preds: Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nc: int,
    kpt_shape: Tuple[int, int] = (17, 3),
    reg_max: int = 16,
    hyp: LossHyp = LossHyp(),
    pose_gain: float = 12.0,
    kobj_gain: float = 1.0,
    max_fg: int = 64,
    assigner_bf16: bool = False,
    assigner_impl: str = "dense",
    topk_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detect terms + the OKS-style keypoint location loss (reference
    KeypointLoss, loss.py:90-110) + the visibility BCE (loss.py:687-786). The
    sigmas are `OKS_SIGMA` for 17 keypoints and ``1 / nk`` otherwise.

    batch, beyond `detection_loss`'s: ``keypoints`` ``[B, M, nk, 3]``: x, y
    normalized to [0, 1] and the visibility flag.
    """
    feats, kpts = preds
    loss_iou, loss_cls, loss_dfl, assign, ctx = detect_terms(
        feats, batch, strides, nc, reg_max, assigner_bf16=assigner_bf16,
        assigner_impl=assigner_impl, topk_impl=topk_impl)
    B, A = ctx["B"], ctx["A"]
    imgsz_h, imgsz_w = ctx["imgsz"]
    nk, ndim = kpt_shape
    dev = ctx["anchors"].device

    sel_idx, sel_w, tgt_gt = _topk_fg(ctx, assign, min(max_fg, A))
    sel_k = _gather_rows(decode_kpts(kpts, strides, kpt_shape), sel_idx)  # [B, K, nk, ndim] pixels
    sel_g = _gather_rows(batch["keypoints"].float(), tgt_gt)  # [B, K, nk, 3] normalized
    g_xy = sel_g[..., :2] * torch.tensor([imgsz_w, imgsz_h], dtype=torch.float32, device=dev)
    kpt_mask = (sel_g[..., 2] > 0).float()  # [B, K, nk]

    tb = _gather_rows(assign.target_bboxes, sel_idx)
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1.0)

    sigmas = (torch.from_numpy(OKS_SIGMA) if nk == 17 else torch.full((nk,), 1.0 / nk)).to(dev)
    d2 = ((sel_k[..., :2] - g_xy) ** 2).sum(-1)  # [B, K, nk]
    e = d2 / (2.0 * (2.0 * sigmas) ** 2 * (area[..., None] + 1e-9))
    kpt_loss_factor = nk / kpt_mask.sum(-1, keepdim=True).clamp(min=1.0)
    fg_sel = (sel_w > 0).float()[..., None]
    loc = ((kpt_loss_factor * (1.0 - torch.exp(-e)) * kpt_mask * fg_sel).sum()
           / global_sum((kpt_mask * fg_sel).sum()).clamp(min=1.0))

    if ndim == 3:  # visibility: BCE(raw visibility logit, labelled visible)
        raw = flatten_levels(kpts).reshape(B, A, nk, ndim).float()
        sel_v = _gather_rows(raw, sel_idx)[..., 2]
        loss_kobj = (_bce_logits(sel_v, kpt_mask) * fg_sel).sum() / global_sum(fg_sel.sum() * nk).clamp(min=1.0)
    else:
        loss_kobj = torch.zeros((), device=dev)

    total = (hyp.box * loss_iou + hyp.cls * loss_cls + hyp.dfl * loss_dfl
             + pose_gain * loc + kobj_gain * loss_kobj) * global_rows(B)
    aux = {"box": hyp.box * loss_iou, "cls": hyp.cls * loss_cls, "dfl": hyp.dfl * loss_dfl,
           "pose": pose_gain * loc, "kobj": kobj_gain * loss_kobj, "num_fg": assign.fg_mask.sum()}
    return total, aux
