"""Task-aligned assigner (counterpart of the JAX ``losses/tal.py``).

Reference ultralytics/utils/tal.py:14-331 (TaskAlignedAssigner and
RotatedTaskAlignedAssigner) as fixed-shape tensor math: ground truths arrive
padded to ``M`` with a validity mask, and every data-dependent branch is a
``where``. Overlaps are CIoU for axis-aligned xyxy boxes and probiou for
rotated xywhr boxes. The metric chain runs in f32, or in bf16 with
``bf16_metric`` (the JAX trainer's choice); targets and the final
normalisation stay f32.

Two forms, the same outputs bit for bit (ties and the reference's index-0
quirks included): ``impl="dense"`` builds the ``[B, M, A]`` metric chain;
``impl="sparse"`` streams the metric through anchor chunks keeping only a
running top-k, then resolves the targets on the ``M * topk`` picked anchors
(`_assigner_sparse`). The top-k is ``topk_impl="iter"`` (``topk`` argmax
passes, ``topk <= 16``) or ``"chunk"`` (a two-level chunked sort,
`_exact_topk_idx`); the default is ``iter`` up to 16 and ``chunk`` beyond, as
in JAX. Each is a keyword argument where JAX reads ``QUAN_ASSIGNER_IMPL`` and
``QUAN_TOPK_IMPL``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.ops.boxes import _top_k, bbox_iou, probiou, xywhr2xyxyxyxy

MAX_ITER_TOPK = 16  # `_iter_topk_idx` serves topk up to this; `_exact_topk_idx` beyond
TOPK_CHUNK = 128  # `_exact_topk_idx`'s chunk of the anchor axis


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


def _exact_topk_idx(metrics: torch.Tensor, topk: int, chunk: int = TOPK_CHUNK) -> torch.Tensor:
    """Exact top-k indices over the last axis by two-level selection (JAX
    ``_exact_topk_idx``): the top-k of each ``chunk`` of the axis, then the
    top-k of those ``(A / chunk) * k`` survivors. Exact (a global top-k value
    is in its chunk's top-k) and in ``lax.top_k``'s tie order: the survivors
    are ordered by (chunk, rank), for equal values the global index order."""
    B, M, A = metrics.shape
    if A <= 4 * chunk:
        return _top_k(metrics, topk)[1]
    pad = (-A) % chunk
    if pad:  # metrics are >= 0, so the -inf padding is never picked
        metrics = F.pad(metrics, (0, pad), value=-torch.inf)
    nch = (A + pad) // chunk
    k1 = min(topk, chunk)
    v1, i1 = _top_k(metrics.reshape(B, M, nch, chunk), k1)
    gidx = (torch.arange(nch, device=metrics.device)[:, None] * chunk + i1).reshape(B, M, nch * k1)
    _, sel = _top_k(v1.reshape(B, M, nch * k1), topk)
    return torch.gather(gidx, -1, sel)


def _overlaps(gt_bboxes: torch.Tensor, pd_bboxes: torch.Tensor, rotated: bool) -> torch.Tensor:
    """Pairwise overlaps ``[B, M, S]`` of gt ``[B, M, D]`` and predicted ``[B, S, D]``
    boxes, clipped at 0, in f32: probiou (xywhr) or CIoU (xyxy)."""
    g, p = gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]
    iou = probiou(g, p) if rotated else bbox_iou(g, p, xywh=False, ciou=True)
    return iou.clamp(min=0)


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


def resolve_topk_impl(topk: int, topk_impl: Optional[str] = None) -> str:
    """``topk_impl`` as the assigner takes it: None gives ``iter`` for ``topk <=
    16`` and ``chunk`` beyond; ``iter`` with ``topk > 16`` raises, as in JAX."""
    impl = topk_impl or ("iter" if topk <= MAX_ITER_TOPK else "chunk")
    if impl not in ("iter", "chunk"):
        raise ValueError(f"unknown topk_impl {impl!r} (iter|chunk)")
    if impl == "iter" and topk > MAX_ITER_TOPK:
        raise ValueError(f"topk_impl='iter' supports topk <= {MAX_ITER_TOPK}, got {topk}")
    return impl


def _select_topk_mask(metrics: torch.Tensor, topk: int, valid_gt: torch.Tensor,
                      topk_impl: Optional[str] = None) -> torch.Tensor:
    """Reference select_topk_candidates (tal.py:160-193) with its index-0 quirk:
    an invalid gt row puts all its k picks on index 0, and a count above 1 is
    dropped. Scattering ``valid_gt`` with a max combiner gives that mask
    (JAX ``_select_topk_mask``); for ``topk == 1`` the single index-0 pick is
    kept, as the reference keeps it."""
    if resolve_topk_impl(topk, topk_impl) == "iter":
        idx = _iter_topk_idx(metrics, topk)  # [B, M, k], distinct in a row
    else:
        idx = _exact_topk_idx(metrics, topk)
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
    topk_impl: Optional[str] = None,
) -> AssignResult:
    """The assigner (JAX ``_assigner_jit``). ``bf16_metric`` runs the [B, M, A]
    metric chain (class scores, overlaps, metric powers, top-k) in bf16; it is
    passed by the caller, never read from the environment. Overlaps: CIoU of
    xyxy boxes, or probiou of xywhr boxes when ``rotated``, clipped at 0, in
    f32. ``impl``: ``dense`` or ``sparse`` (`_assigner_sparse`: the same
    outputs, bitwise, without the dense intermediates); ``topk_impl``: see
    `resolve_topk_impl` (the sparse form merges chunks with sorts whatever it
    says, after checking it).
    """
    if impl not in ("dense", "sparse"):
        raise ValueError(f"unknown assigner impl {impl!r} (dense|sparse)")
    topk_impl = resolve_topk_impl(topk, topk_impl)
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    pd_scores = pd_scores.float()
    pd_bboxes = pd_bboxes.float()
    gt_bboxes = gt_bboxes.float()

    cand_fn = _candidates_in_rotated_gts if rotated else _candidates_in_gts
    if impl == "sparse":
        return _assigner_sparse(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                                num_classes, cand_fn, rotated, topk, alpha, beta, eps, bf16_metric)
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
    overlaps = torch.where(mask, _overlaps(gt_bboxes, pd_bboxes, rotated).to(mdt), zero)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    mask_topk = _select_topk_mask(align_metric, topk, mask_gt, topk_impl)
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


def _scan_topk_idx(metric_chunk, chunks, B: int, M: int, topk: int, mdt: torch.dtype,
                   device) -> torch.Tensor:
    """Top-k anchor indices per gt without the ``[B, M, A]`` metric (JAX
    ``_scan_topk_idx``): ``metric_chunk(*chunk) -> [B, M, CH]`` for each
    ``(offset, *chunk)`` of ``chunks`` (CH a multiple of 128), merged into a
    running ``[B, M, k]`` top-k. The tie order is ``lax.top_k``'s over the
    whole axis: the carry (earlier chunks, value-descending then index-
    ascending) precedes the chunk's candidates in the merge, and within a chunk
    the two-level selection keeps (sub-chunk, rank), i.e. index order."""
    vals = torch.full((B, M, topk), -torch.inf, dtype=mdt, device=device)
    idx = torch.zeros((B, M, topk), dtype=torch.long, device=device)
    for off, *xi in chunks:
        al = metric_chunk(*xi)  # [B, M, CH]
        CH = al.shape[-1]
        k1 = min(topk, 128)
        v1, i1 = _top_k(al.reshape(B, M, CH // 128, 128), k1)
        gi = (torch.arange(CH // 128, device=device)[:, None] * 128 + i1).reshape(B, M, -1) + off
        nv, sel = _top_k(torch.cat([vals, v1.reshape(B, M, -1)], dim=-1), topk)
        idx = torch.gather(torch.cat([idx, gi], dim=-1), -1, sel)
        vals = nv
    return idx


def _assigner_sparse(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                     num_classes: int, cand_fn, rotated: bool, topk: int, alpha: float, beta: float, eps: float,
                     bf16_metric: bool) -> AssignResult:
    """Sparse task-aligned assignment (JAX ``_assigner_sparse``): the chunked
    top-k, then the resolution on the ``S = M * topk`` picked anchors only.

    Bitwise the dense chain's outputs (top-k and argmax tie order and the
    reference's index-0 quirks included), without its ``[B, M, A]``
    intermediates: phase A streams the metric through anchor chunks with a
    ``[B, M, k]`` carry; phase B recomputes overlaps and metrics at the picks
    (``[B, M, S]``) and scatters the per-anchor results into ``[B, A]`` maps.
    Reference ultralytics/utils/tal.py:58-296.
    """
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    D = pd_bboxes.shape[-1]
    dev = pd_scores.device
    if topk > A:
        raise ValueError(f"the sparse assigner needs topk ({topk}) <= anchors ({A})")
    mdt = torch.bfloat16 if bf16_metric else torch.float32
    zero = torch.zeros((), dtype=mdt, device=dev)
    gt_lab = gt_labels.long().clamp(0, nc - 1)
    lab_oh = F.one_hot(gt_lab, nc).to(mdt)  # [B, M, nc]

    def chunk_metric(anc, sc, pb):  # anc [CH, 2], sc [B, CH, nc], pb [B, CH, D] -> [B, M, CH]
        msk = cand_fn(anc[None, None], gt_bboxes) & mask_gt[..., None]
        bs = torch.where(msk, torch.einsum("bmn,ban->bma", lab_oh, sc.to(mdt)), zero)
        ov = torch.where(msk, _overlaps(gt_bboxes, pb, rotated).to(mdt), zero)
        return bs ** alpha * ov ** beta

    # phase A: about 8 chunks, each a multiple of 128 anchors; padded anchors sit
    # at (-1e9, -1e9), inside no gt (metric 0), at indices >= A, so a real
    # anchor wins every tie with them, as against the dense form's -inf padding
    CH = 128 * max(1, -(-A // (128 * 8)))
    Ap = -(-A // CH) * CH
    pad = Ap - A
    anc_p = F.pad(anc_points.float(), (0, 0, 0, pad), value=-1e9)
    sc_p = F.pad(pd_scores, (0, 0, 0, pad))
    pb_p = F.pad(pd_bboxes, (0, 0, 0, pad))
    chunks = [(c * CH, anc_p[c * CH:(c + 1) * CH], sc_p[:, c * CH:(c + 1) * CH], pb_p[:, c * CH:(c + 1) * CH])
              for c in range(Ap // CH)]
    idx = _scan_topk_idx(chunk_metric, chunks, B, M, topk, mdt, dev)  # [B, M, k]

    # phase B: resolution at the picks (always real anchors: a real anchor's
    # metric >= 0 beats the padding's 0 on index)
    S = M * topk
    sel = idx.reshape(B, S)
    ap_sel = anc_points.float()[sel]                                       # [B, S, 2]
    pb_sel = torch.gather(pd_bboxes, 1, sel[..., None].expand(B, S, D))    # [B, S, D]
    ps_sel = torch.gather(pd_scores, 1, sel[..., None].expand(B, S, nc))   # [B, S, nc]
    msk_sel = cand_fn(ap_sel[:, None], gt_bboxes) & mask_gt[..., None]    # [B, M, S]
    bs_sel = torch.where(msk_sel, torch.einsum("bmn,bsn->bms", lab_oh, ps_sel.to(mdt)), zero)
    ov_sel = torch.where(msk_sel, _overlaps(gt_bboxes, pb_sel, rotated).to(mdt), zero)
    al_sel = bs_sel ** alpha * ov_sel ** beta                              # [B, M, S]

    # column s belongs to gt s // topk; its own pick is active where the anchor
    # lies in that (valid) gt: mask_pos = mask_topk * mask_in_gts * mask_gt
    m_col = torch.arange(M, device=dev).repeat_interleave(topk)            # [S]
    pre = msk_sel[:, m_col, torch.arange(S, device=dev)]                   # [B, S]
    fg_cnt = torch.zeros((B, A), dtype=torch.long, device=dev).scatter_add(1, sel, pre.long())
    multi = torch.gather(fg_cnt, 1, sel) > 1                               # [B, S]
    m_star = ov_sel.argmax(dim=1)                                          # [B, S]
    inactive = torch.full_like(m_star, M)
    # the gt each column assigns its anchor to, M where none (tal.py:277-296)
    active_m = torch.where(multi, m_star, torch.where(pre, m_col[None].expand(B, S), inactive))
    active = active_m < M
    a_col = active_m.clamp(max=M - 1)

    tgt = torch.full((B, A), M, dtype=torch.long, device=dev).scatter_reduce(
        1, sel, active_m, reduce="amin", include_self=True)
    fg_mask = tgt < M
    target_gt_idx = torch.where(fg_mask, tgt, torch.zeros_like(tgt))

    # targets at the active anchors; the others keep gt 0's, as the dense
    # form's argmax of a zero column gives
    big = torch.iinfo(torch.long).max
    lab_col = torch.where(active, torch.gather(gt_lab, 1, a_col), torch.full_like(a_col, big))
    lab_img = torch.full((B, A), big, dtype=torch.long, device=dev).scatter_reduce(
        1, sel, lab_col, reduce="amin", include_self=True)
    target_labels = torch.where(fg_mask, lab_img, gt_lab[:, :1]).to(torch.int32)
    box_col = torch.gather(gt_bboxes, 1, a_col[..., None].expand(B, S, D))
    box_col = torch.where(active[..., None], box_col, torch.full_like(box_col, torch.inf))
    box_img = torch.full((B, A, D), torch.inf, device=dev).scatter_reduce(
        1, sel[..., None].expand(B, S, D), box_col, reduce="amin", include_self=True)
    target_bboxes = torch.where(fg_mask[..., None], box_img, gt_bboxes[:, :1].expand(B, A, D))
    target_scores = F.one_hot(target_labels.long(), num_classes).float() * fg_mask[..., None]

    # normalise (tal.py:117-125): each gt's maxima over the anchors assigned to it
    act3 = torch.arange(M, device=dev)[None, :, None] == active_m[:, None, :]  # [B, M, S]
    pos_align = torch.where(act3, al_sel, zero).amax(dim=-1)              # [B, M]
    pos_overlap = torch.where(act3, ov_sel, zero).amax(dim=-1)
    po_col = torch.gather(pos_overlap, 1, a_col)
    pa_col = torch.gather(pos_align, 1, a_col)
    al_col = torch.gather(al_sel, 1, a_col[:, None, :])[:, 0]
    norm_col = torch.where(active, al_col * po_col / (pa_col + eps), zero)
    norm = torch.zeros((B, A), dtype=mdt, device=dev).scatter_reduce(
        1, sel, norm_col, reduce="amax", include_self=True)
    target_scores = target_scores * norm.float()[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
