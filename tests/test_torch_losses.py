"""The port's losses against the JAX package: the rotated task-aligned
assigner (f32 and the bf16 metric chain), the OBB loss and its gradients,
and the loss's parts, on seeded numpy inputs, f32 on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.losses import detect as jd
from quan_ultralytics_tpu.losses import tal as jtal
from quan_ultralytics_tpu.ops.boxes import bbox2dist as jax_bbox2dist
from quan_ultralytics_tpu.ops.boxes import make_anchors as jax_make_anchors
from quan_ultralytics_tpu_torch.losses import detect as td
from quan_ultralytics_tpu_torch.losses import tal as ttal
from quan_ultralytics_tpu_torch.ops.boxes import bbox2dist
from torch_port_helpers import assert_close, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

NC, IMGSZ, STRIDES = 7, 128, (8, 16, 32)


def _assigner_case(kind: str, seed: int = 0, B: int = 3, M: int = 8):
    """Rotated assigner inputs: ``random``; ``ties`` (one predicted box
    everywhere, two score levels: many exact metric ties); ``empty`` (no
    valid gt); ``padded`` (a few valid gts per image, the rest padding, one
    of them thin).

    Each predicted box is a gt box moved a little, as a model's boxes are
    after some training, so that the overlaps are well above 0. Near 0,
    probiou cancels (1 - sqrt(1 - exp(-d))) and its value differs between
    XLA's and PyTorch's exp in the third digit; raised to the 6th power,
    that reorders near-equal metrics at the top-k boundary.
    """
    rng = np.random.default_rng(seed)
    shapes = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]
    anchors, stride_t = jax_make_anchors(shapes, STRIDES, 0.5)
    anc = np.asarray(anchors * stride_t)
    A = anc.shape[0]
    scores = rng.uniform(0, 1, (B, A, NC)).astype(np.float32)
    gt = np.concatenate([rng.uniform(IMGSZ * 0.2, IMGSZ * 0.8, (B, M, 2)),
                         rng.uniform(16, IMGSZ / 2, (B, M, 2)),
                         rng.uniform(-1.5, 1.5, (B, M, 1))], -1).astype(np.float32)
    near = gt[np.arange(B)[:, None], rng.integers(0, M, (B, A))]  # [B, A, 5]
    boxes = (near + np.concatenate([rng.normal(0, 3, (B, A, 2)), rng.normal(0, 2, (B, A, 2)),
                                    rng.normal(0, 0.1, (B, A, 1))], -1)).astype(np.float32)
    labels = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    if kind == "ties":
        boxes = np.tile(boxes[:, :1], (1, A, 1))
        scores = np.where(scores > 0.5, 0.5, 0.25).astype(np.float32)
    elif kind == "empty":
        mask[:] = False
    elif kind == "padded":
        mask[:] = False
        for b, nv in enumerate((3, 0, 5)):
            mask[b, :nv] = True
        gt[0, 1, 3] = 1.5  # a thin box
        gt[~mask] = 0.0
    return scores, boxes, anc, labels, gt, mask


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["random", "ties", "empty", "padded"])
def test_rotated_assigner_matches_jax(kind, bf16):
    """Selection (fg_mask, target_gt_idx, target_labels) identical; target
    boxes and scores (in [0, 1]) within 1e-5 in f32. With the bf16 metric
    chain the selection is still compared exactly; the normalized scores
    carry bf16 rounding (2^-8 relative)."""
    args = _assigner_case(kind)
    ref = jtal.task_aligned_assigner(*(jnp.asarray(a) for a in args), num_classes=NC, rotated=True,
                                     bf16_metric=bf16, impl="dense", topk_impl="iter")
    got = ttal.task_aligned_assigner(*(to_torch(a) for a in args), num_classes=NC, rotated=True,
                                     bf16_metric=bf16)
    if kind != "empty":
        assert np.asarray(ref.fg_mask).any()
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.target_scores.dtype == torch.float32
    assert_close(got.target_bboxes, ref.target_bboxes, rtol=1e-5, atol=1e-6)
    tol = 1e-2 if bf16 else 1e-5
    assert_close(got.target_scores, ref.target_scores, rtol=tol, atol=tol)


def test_axis_aligned_candidates_match_jax():
    rng = np.random.default_rng(4)
    anc = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    ctr, wh = rng.uniform(10, 54, (2, 5, 2)), rng.uniform(4, 30, (2, 5, 2))
    gt = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    ref = jtal._candidates_in_gts(jnp.asarray(anc)[None, None], jnp.asarray(gt))
    got = ttal._candidates_in_gts(to_torch(anc)[None, None], to_torch(gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("topk", [1, 3, 10])
def test_select_topk_mask_matches_jax(topk):
    """Ties broken toward the lowest index, and the index-0 quirk of invalid rows."""
    rng = np.random.default_rng(topk)
    metrics = rng.uniform(0, 1, (2, 5, 300)).astype(np.float32)
    metrics[..., 100:120] = metrics[..., 0:20]  # exact ties
    metrics[..., 200:] = 0.0
    valid = rng.uniform(size=(2, 5)) > 0.4
    ref = jtal._select_topk_mask(jnp.asarray(metrics), topk, jnp.asarray(valid), topk_impl="iter")
    got = ttal._select_topk_mask(to_torch(metrics), topk, to_torch(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ttal._iter_topk_idx(to_torch(metrics), topk).numpy(),
                                  np.asarray(jtal._iter_topk_idx(jnp.asarray(metrics), topk)))


def test_assigner_refuses_what_is_not_ported():
    """What the assigner refuses, rotated and axis-aligned alike: the iterative
    top-k beyond topk 16 (as JAX's explicit ``topk_impl='iter'``) and unknown
    forms; the chunked top-k (topk > 16) and the sparse assigner, once refused
    here, run and give the dense form's targets."""
    args = [to_torch(a) for a in _assigner_case("random", B=1)]

    def xyxy(t):  # the xywhr boxes' axis-aligned extent
        return torch.cat([t[..., :2] - t[..., 2:4] / 2, t[..., :2] + t[..., 2:4] / 2], -1)

    aligned = [args[0], xyxy(args[1]), args[2], args[3], xyxy(args[4]), args[5]]
    for rotated, a in ((True, args), (False, aligned)):
        with pytest.raises(ValueError, match="topk <= 16"):
            ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, topk=17, topk_impl="iter")
        with pytest.raises(ValueError, match="dense|sparse"):
            ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, impl="banded")
        dense = ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, topk=17)
        sparse = ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, topk=17, impl="sparse")
        for name in ttal.AssignResult._fields:
            assert torch.equal(getattr(dense, name), getattr(sparse, name)), name
    assert ttal.task_aligned_assigner(*aligned, num_classes=NC).fg_mask.any()


# ---------------------------------------------------------------- the loss


def _head_outputs(seed: int, B: int = 2, nc: int = 3, imgsz: int = 64):
    rng = np.random.default_rng(seed)
    feats = [(rng.normal(size=(B, imgsz // s, imgsz // s, 64 + nc)) * 2).astype(np.float32)
             for s in STRIDES]
    angles = [rng.uniform(-math.pi / 4, 3 * math.pi / 4, (B, imgsz // s, imgsz // s, 1))
              .astype(np.float32) for s in STRIDES]
    return feats, angles


def _obb_batch(seed: int, B: int = 2, M: int = 6, nc: int = 3, empty: bool = False):
    """Normalized xywhr targets; per image some valid rows, padding, and one
    box under 2 px (the tiny-rbox filter drops it)."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.1, 0.5, (B, M, 2)),
                            rng.uniform(-1.2, 1.2, (B, M, 1))], -1).astype(np.float32)
    boxes[:, 0, 3] = 0.02  # 1.3 px at imgsz 64
    mask = np.zeros((B, M), bool)
    if not empty:
        mask[0, :5] = True
        mask[1, :3] = True
    return {"cls": rng.integers(0, nc, (B, M)).astype(np.int32), "bboxes": boxes, "mask": mask}


@pytest.mark.parametrize("case", ["f32", "bf16_assigner", "empty"])
def test_obb_loss_and_gradients_match_jax(case):
    """Total and aux terms at 1e-5 relative; gradients with respect to the
    head outputs (box and class logits, angles) at 1e-5 of max|grad|."""
    nc, bf16 = 3, case == "bf16_assigner"
    feats, angles = _head_outputs(5)
    batch = _obb_batch(6, empty=case == "empty")

    def jloss(f, a):
        return jd.obb_loss((f, a), {k: jnp.asarray(v) for k, v in batch.items()}, STRIDES, nc,
                           assigner_bf16=bf16)

    (ref, raux), rgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(f) for f in feats], [jnp.asarray(a) for a in angles])
    tf = [to_torch(f).requires_grad_() for f in feats]
    ta = [to_torch(a).requires_grad_() for a in angles]
    got, aux = td.obb_loss((tf, ta), {k: to_torch(v) for k, v in batch.items()}, STRIDES, nc,
                           assigner_bf16=bf16)
    grads = torch.autograd.grad(got, tf + ta)

    assert_close(got, ref, rtol=1e-5, atol=1e-7)
    assert set(aux) == set(raux)
    for k in aux:
        assert_close(aux[k], raux[k], rtol=1e-5, atol=1e-7, err_msg=k)
    if case == "empty":
        assert int(aux["num_fg"]) == 0
    else:
        assert int(aux["num_fg"]) > 0
    for g, r in zip(grads, list(rgrads[0]) + list(rgrads[1])):
        assert_close(g, r, rtol=1e-4, atol=1e-5)


def test_loss_parts_match_jax():
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(4, 30)) * 4).astype(np.float32)
    targets = rng.uniform(0, 1, (4, 30)).astype(np.float32)
    assert_close(td._bce_logits(to_torch(logits), to_torch(targets)),
                 jd._bce_logits(jnp.asarray(logits), jnp.asarray(targets)), rtol=1e-6, atol=1e-7)
    dist = rng.normal(size=(3, 7, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 16, (3, 7, 4)).astype(np.float32)  # both clip ends hit
    assert_close(td._dfl_loss(to_torch(dist), to_torch(target), 16),
                 jd._dfl_loss(jnp.asarray(dist), jnp.asarray(target), 16), rtol=1e-6, atol=1e-7)
    ang = rng.uniform(-4, 4, (2, 9, 2, 1)).astype(np.float32)
    qa, qb = (td._angle_to_quaternion(to_torch(a)) for a in (ang[..., 0, :], ang[..., 1, :]))
    ra, rb = (jd._angle_to_quaternion(jnp.asarray(a)) for a in (ang[..., 0, :], ang[..., 1, :]))
    assert_close(qa, ra, rtol=1e-6, atol=1e-7)
    # arccos near +-1 turns a 1-ulp difference of the dot into ~5e-6 rad
    assert_close(td.quaternion_angular_loss(qa, qb), jd.quaternion_angular_loss(ra, rb),
                 rtol=1e-5, atol=1e-5)
    anc = rng.uniform(0, 8, (1, 20, 2)).astype(np.float32)
    box = np.concatenate([anc - rng.uniform(-2, 20, (1, 20, 2)), anc + rng.uniform(-2, 20, (1, 20, 2))],
                         -1).astype(np.float32)
    assert_close(bbox2dist(to_torch(anc), to_torch(box), 15),
                 jax_bbox2dist(jnp.asarray(anc), jnp.asarray(box), 15), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- the sparse assigner and the chunked top-k


def _rand_assigner_case(seed, imgsz, B=3, M=8, nc=7, rotated=False, tie_heavy=False, n_valid=None):
    """tests/test_losses.py's ``_rand_assigner_case``: random predicted boxes
    anywhere (many overlaps near 0), optional exact metric ties."""
    rng = np.random.default_rng(seed)
    shapes = [(imgsz // s, imgsz // s) for s in STRIDES]
    anchors, stride_t = jax_make_anchors(shapes, STRIDES, 0.5)
    anc = np.asarray(anchors * stride_t)
    A = anc.shape[0]
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    ctr = rng.uniform(0, imgsz, (B, A, 2)).astype(np.float32)
    wh = rng.uniform(4, imgsz / 2, (B, A, 2)).astype(np.float32)
    if rotated:
        boxes = np.concatenate([ctr, wh, rng.uniform(-1.5, 1.5, (B, A, 1)).astype(np.float32)], -1)
    else:
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    gctr = rng.uniform(imgsz * 0.2, imgsz * 0.8, (B, M, 2)).astype(np.float32)
    gwh = rng.uniform(8, imgsz / 2, (B, M, 2)).astype(np.float32)
    if rotated:
        gt = np.concatenate([gctr, gwh, rng.uniform(-1.5, 1.5, (B, M, 1)).astype(np.float32)], -1)
    else:
        gt = np.concatenate([gctr - gwh / 2, gctr + gwh / 2], -1)
    if tie_heavy:
        boxes = np.tile(boxes[:, :1], (1, A, 1))
        scores = np.where(scores > 0.5, 0.5, 0.25).astype(np.float32)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask = np.zeros((B, M), bool)
    for b in range(B):
        mask[b, :int(rng.integers(0, M + 1)) if n_valid is None else n_valid] = True
    return [to_torch(a) for a in (scores, boxes, anc, labels, gt, mask)]


SPARSE_CASES = {
    "axis_aligned": ((0, 256), {}), "rotated": ((1, 128), {"rotated": True}),
    "bf16": ((2, 256), {"bf16_metric": True}), "rotated_bf16": ((3, 128), {"rotated": True, "bf16_metric": True}),
    "ties": ((4, 256), {"tie_heavy": True}), "rotated_ties": ((5, 128), {"rotated": True, "tie_heavy": True}),
    "no_gt": ((6, 128), {"n_valid": 0}), "all_gt": ((7, 128), {"n_valid": 8}), "topk1": ((8, 128), {"topk": 1}),
    "many_chunks": ((9, 512), {"B": 2}), "topk32": ((10, 256), {"topk": 32}),
    "rotated_topk32_bf16": ((11, 256), {"rotated": True, "topk": 32, "bf16_metric": True}),
}


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_assigner_equals_dense_bitwise(case):
    """tests/test_losses.py's sparse cases: every output of ``impl="sparse"``
    equals the dense form's bit for bit (dtype too), ties and the index-0
    quirks included; and the dense form's under ``topk_impl`` iter and chunk."""
    (seed, imgsz), kw = SPARSE_CASES[case]
    case_kw = {k: kw[k] for k in ("rotated", "tie_heavy", "n_valid", "B") if k in kw}
    args = _rand_assigner_case(seed, imgsz, **case_kw)
    run = {k: kw[k] for k in ("rotated", "bf16_metric", "topk") if k in kw}
    dense = ttal.task_aligned_assigner(*args, num_classes=7, impl="dense", **run)
    sparse = ttal.task_aligned_assigner(*args, num_classes=7, impl="sparse", **run)
    others = [sparse]
    if run.get("topk", 10) <= 16:
        others.append(ttal.task_aligned_assigner(*args, num_classes=7, topk_impl="chunk", **run))
    for other in others:
        for name in ttal.AssignResult._fields:
            a, b = getattr(dense, name), getattr(other, name)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"


@pytest.mark.parametrize("kind", ["random", "ties", "padded"])
@pytest.mark.parametrize("topk", [10, 32])
def test_sparse_and_chunked_assigner_match_jax(kind, topk):
    """The port's sparse assigner against JAX's sparse one (and its chunked
    top-k at topk 32): the selection exactly, boxes and scores as
    `test_rotated_assigner_matches_jax` holds them."""
    args = _assigner_case(kind)
    ref = jtal.task_aligned_assigner(*(jnp.asarray(a) for a in args), num_classes=NC, rotated=True,
                                     topk=topk, bf16_metric=False, impl="sparse", topk_impl="chunk")
    got = ttal.task_aligned_assigner(*(to_torch(a) for a in args), num_classes=NC, rotated=True,
                                     topk=topk, impl="sparse")
    assert np.asarray(ref.fg_mask).any()
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert_close(got.target_bboxes, ref.target_bboxes, rtol=1e-5, atol=1e-6)
    assert_close(got.target_scores, ref.target_scores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topk", [1, 10, 17, 40])
def test_chunked_topk_matches_jax(topk):
    """`_exact_topk_idx` (A = 700 > 4 chunks, exact ties across chunks, a
    zero tail) equals JAX's: values, order and lowest-index ties; and the
    select mask built on it."""
    rng = np.random.default_rng(topk)
    metrics = rng.uniform(0, 1, (2, 5, 700)).astype(np.float32)
    metrics[..., 300:340] = metrics[..., 0:40]  # ties across chunks
    metrics[..., 600:] = 0.0
    ref = np.asarray(jtal._exact_topk_idx(jnp.asarray(metrics), topk))
    np.testing.assert_array_equal(ttal._exact_topk_idx(to_torch(metrics), topk).numpy(), ref)
    valid = rng.uniform(size=(2, 5)) > 0.4
    ref_mask = jtal._select_topk_mask(jnp.asarray(metrics), topk, jnp.asarray(valid), topk_impl="chunk")
    got_mask = ttal._select_topk_mask(to_torch(metrics), topk, to_torch(valid), topk_impl="chunk")
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_obb_loss_sparse_assigner_equals_dense():
    """Through obb_loss: the sparse assigner's loss and gradients equal the
    dense form's bit for bit (tests/test_losses.py's end-to-end case)."""
    feats, angles = _head_outputs(3, nc=15)
    batch = {k: to_torch(v) for k, v in _obb_batch(3, nc=15).items()}
    out = []
    for impl in ("dense", "sparse"):
        tf = [to_torch(f).requires_grad_() for f in feats]
        ta = [to_torch(a).requires_grad_() for a in angles]
        total, aux = td.obb_loss((tf, ta), batch, STRIDES, 15, assigner_impl=impl, topk_impl="chunk")
        out.append((total, aux, torch.autograd.grad(total, tf + ta)))
    (t0, a0, g0), (t1, a1, g1) = out
    assert torch.equal(t0, t1) and int(a0["num_fg"]) > 0
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_nms_defer_argmax_keeps_the_same_detections(monkeypatch):
    """``defer_argmax`` (the class id from the gathered candidate rows) gives
    the default's detections, and JAX's ``QUAN_NMS_DEFER_ARGMAX=1`` ones, on
    rotated and axis-aligned predictions with tied class scores."""
    from quan_ultralytics_tpu.ops import boxes as jbx
    from quan_ultralytics_tpu_torch.ops import boxes as tbx

    rng = np.random.default_rng(12)
    nc, A = 5, 600
    xywhr = np.concatenate([rng.uniform(0, 256, (2, A, 2)), rng.uniform(4, 40, (2, A, 2))], -1)
    cls = rng.uniform(0, 1, (2, A, nc))
    cls[:, :50, 1] = cls[:, :50, 3]  # tied best classes
    for rotated in (True, False):
        pred = np.concatenate([xywhr, cls] + ([rng.uniform(-0.7, 2.3, (2, A, 1))] if rotated else []),
                              -1).astype(np.float32)
        kw = dict(conf_thres=0.25, iou_thres=0.45, nc=nc, rotated=rotated, max_det=100)
        det, ok = tbx.non_max_suppression(to_torch(pred), **kw)
        det2, ok2 = tbx.non_max_suppression(to_torch(pred), defer_argmax=True, **kw)
        assert torch.equal(det, det2) and torch.equal(ok, ok2) and int(ok.sum()) > 0
        monkeypatch.setenv("QUAN_NMS_DEFER_ARGMAX", "1")
        rdet, rok = jbx.non_max_suppression(jnp.asarray(pred), **kw)
        monkeypatch.delenv("QUAN_NMS_DEFER_ARGMAX")
        np.testing.assert_array_equal(ok2.numpy(), np.asarray(rok))
        np.testing.assert_array_equal(det2[..., 6 if rotated else 5].numpy(),
                                      np.asarray(rdet)[..., 6 if rotated else 5])
        assert_close(det2, rdet, rtol=1e-5, atol=1e-5)
