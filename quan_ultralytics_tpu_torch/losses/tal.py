"""Task-aligned assigner, dense path (counterpart of the JAX ``losses/tal.py``).

Reference ultralytics/utils/tal.py:14-331 (TaskAlignedAssigner and
RotatedTaskAlignedAssigner) as fixed-shape tensor math: ground truths arrive
padded to ``M`` with a validity mask, and every data-dependent branch is a
``where``. Overlaps are CIoU for axis-aligned xyxy boxes and probiou for
rotated xywhr boxes. The metric chain runs in f32, or in bf16 with
``bf16_metric`` (the JAX trainer's choice); targets and the final
normalisation stay f32.

Not ported yet: the chunked top-k (``_exact_topk_idx``, the JAX package's
choice for ``topk > 16``) and the sparse assigner (``impl="sparse"``). Those
cases raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.boxes import bbox_iou, probiou, xywhr2xyxyxyxy

MAX_ITER_TOPK = 16  # `_iter_topk_idx` serves topk up to this; the JAX package sorts beyond


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # [B, A] int32
    target_bboxes: torch.Tensor  # [B, A, 4|5]
    target_scores: torch.Tensor  # [B, A, nc] f32
    fg_mask: torch.Tensor        # [B, A] bool
    target_gt_idx: torch.Tensor  # [B, A] int64


def _candidates_in_gts(anc: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Axis-aligned: anchor strictly inside the xyxy gt box (tal.py:252-276).
    ``anc`` ``[1, 1, A, 2]`` against gt ``[B, M, 4]`` -> ``[B, M, A]``."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:4]
    return torch.cat([anc - lt, rb - anc], dim=-1).amin(dim=-1) > eps


def _candidates_in_rotated_gts(anc: torch.Tensor, gt_bboxes: torch.Tensor) -> torch.Tensor:
    """Rotated: point in the rotated rectangle by edge projections (tal.py:305-331)."""
    corners = xywhr2xyxyxyxy(gt_bboxes)  # [B, M, 4, 2]
    a, b, d = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
    ab = (b - a)[..., None, :]
    ad = (d - a)[..., None, :]
    ap = anc - a[..., None, :]  # [B, M, A, 2]
    norm_ab = (ab * ab).sum(-1)
    norm_ad = (ad * ad).sum(-1)
    ap_ab = (ap * ab).sum(-1)
    ap_ad = (ap * ad).sum(-1)
    return (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)


def _iter_topk_idx(metrics: torch.Tensor, topk: int) -> torch.Tensor:
    """Top-k indices over the last axis by ``topk`` argmax-and-mask passes,
    in rank order with ``lax.top_k``'s tie order: ``torch.argmax`` returns
    the lowest index among equal values, as ``jnp.argmax`` does.
    ``metrics`` must be free of NaN (the assigner masks it to >= 0)."""
    iota = torch.arange(metrics.shape[-1], device=metrics.device)
    m = metrics
    idxs = []
    for _ in range(topk):
        i = torch.argmax(m, dim=-1)
        idxs.append(i)
        m = torch.where(iota == i[..., None], torch.full_like(m, -torch.inf), m)
    return torch.stack(idxs, dim=-1)


def _select_topk_mask(metrics: torch.Tensor, topk: int, valid_gt: torch.Tensor) -> torch.Tensor:
    """Reference select_topk_candidates (tal.py:160-193) with its index-0 quirk:
    an invalid gt row puts all its k picks on index 0, and a count above 1 is
    dropped. Scattering ``valid_gt`` with a max combiner gives that mask
    (JAX ``_select_topk_mask``); for ``topk == 1`` the single index-0 pick is
    kept, as the reference keeps it."""
    if topk > MAX_ITER_TOPK:
        raise NotImplementedError(
            f"topk={topk}: the chunked top-k for topk > {MAX_ITER_TOPK} is not ported yet")
    idx = _iter_topk_idx(metrics, topk)  # [B, M, k], distinct in a row
    val = valid_gt[..., None].expand(idx.shape).to(metrics.dtype)
    if topk == 1:
        val = torch.ones_like(val)
        idx = torch.where(valid_gt[..., None], idx, torch.zeros_like(idx))
    mask = torch.zeros_like(metrics)
    return mask.scatter_reduce(-1, idx, val, reduce="amax", include_self=True)


def task_aligned_assigner(
    pd_scores: torch.Tensor,   # [B, A, nc] sigmoid probabilities
    pd_bboxes: torch.Tensor,   # [B, A, 4] xyxy or [B, A, 5] xywhr (pixels)
    anc_points: torch.Tensor,  # [A, 2] pixels
    gt_labels: torch.Tensor,   # [B, M] int
    gt_bboxes: torch.Tensor,   # [B, M, 4|5]
    mask_gt: torch.Tensor,     # [B, M] bool
    num_classes: int,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    rotated: bool = False,
    bf16_metric: bool = False,
    impl: str = "dense",
) -> AssignResult:
    """The dense assigner (JAX ``_assigner_jit``). ``bf16_metric`` runs the
    [B, M, A] metric chain (class scores, overlaps, metric powers, top-k) in
    bf16; it is passed by the caller, never read from the environment.
    Overlaps: CIoU of xyxy boxes, or probiou of xywhr boxes when ``rotated``,
    clipped at 0, in f32.
    """
    if impl != "dense":
        raise NotImplementedError(f"impl={impl!r}: only the dense assigner is ported")
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    pd_scores = pd_scores.float()
    pd_bboxes = pd_bboxes.float()
    gt_bboxes = gt_bboxes.float()

    cand_fn = _candidates_in_rotated_gts if rotated else _candidates_in_gts
    mask_in_gts = cand_fn(anc_points[None, None], gt_bboxes)
    mask = mask_in_gts & mask_gt[..., None]  # [B, M, A]

    # alignment metric (tal.py:137-156): the anchor's score for the gt class
    # times its overlap, both zero outside the candidate mask
    gt_lab = gt_labels.long().clamp(0, nc - 1)
    mdt = torch.bfloat16 if bf16_metric else torch.float32
    lab_oh = F.one_hot(gt_lab, nc).to(mdt)  # [B, M, nc]
    scores_for_gt = torch.einsum("bmn,ban->bma", lab_oh, pd_scores.to(mdt))  # exact: one product
    zero = torch.zeros((), dtype=mdt, device=pd_scores.device)
    bbox_scores = torch.where(mask, scores_for_gt, zero)
    # overlaps in f32; only the [B, M, A] result drops to the metric dtype
    g, p = gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]
    iou = probiou(g, p) if rotated else bbox_iou(g, p, xywh=False, ciou=True)
    overlaps = torch.where(mask, iou.clamp(min=0).to(mdt), zero)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    mask_topk = _select_topk_mask(align_metric, topk, mask_gt)
    mask_pos = mask_topk * mask_in_gts.to(mdt) * mask_gt[..., None].to(mdt)

    # an anchor claimed by several gts goes to the one of highest overlap (tal.py:277-296)
    fg_count = mask_pos.sum(dim=-2)  # [B, A]
    mask_multi = (fg_count > 1)[:, None, :]
    max_overlap_gt = overlaps.argmax(dim=1)  # [B, A]
    is_max = (torch.arange(M, device=mask_pos.device)[None, :, None]
              == max_overlap_gt[:, None, :]).to(mdt)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=-2) > 0
    target_gt_idx = mask_pos.argmax(dim=-2)  # [B, A]

    # targets (tal.py:195-250): a gather is the JAX one-hot contraction, exactly
    target_labels = torch.gather(gt_lab, 1, target_gt_idx).to(torch.int32)
    D = gt_bboxes.shape[-1]
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(B, A, D))
    target_scores = F.one_hot(target_labels.long(), num_classes).float() * fg_mask[..., None]

    # normalise by each gt's best alignment (tal.py:117-125)
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(dim=-1, keepdim=True)  # [B, M, 1]
    pos_overlap = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(dim=-2)[..., None]  # [B, A, 1]
    target_scores = target_scores * norm.float()
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
