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
    """The chunked top-k (topk > 16) and the sparse assigner raise, rotated and
    axis-aligned alike; the axis-aligned dense assigner runs."""
    args = [to_torch(a) for a in _assigner_case("random", B=1)]

    def xyxy(t):  # the xywhr boxes' axis-aligned extent
        return torch.cat([t[..., :2] - t[..., 2:4] / 2, t[..., :2] + t[..., 2:4] / 2], -1)

    aligned = [args[0], xyxy(args[1]), args[2], args[3], xyxy(args[4]), args[5]]
    for rotated, a in ((True, args), (False, aligned)):
        with pytest.raises(NotImplementedError, match="chunked top-k"):
            ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, topk=17)
        with pytest.raises(NotImplementedError, match="dense"):
            ttal.task_aligned_assigner(*a, num_classes=NC, rotated=rotated, impl="sparse")
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
