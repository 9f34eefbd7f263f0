"""The port's axis-aligned detect task against the JAX package on the CPU.

Box math (`bbox_iou` IoU and CIoU in f32 and bf16, `xyxy2xywh`), the
fixed-point `nms_axis_aligned` (also against a sequential greedy oracle)
and the axis-aligned `non_max_suppression`; the assigner with CIoU overlaps;
`detection_loss` and its gradients; one port `Trainer.step` of a detect
model (port side only: its optimizer and EMA are held by
``test_torch_train.py``); the detect `Predictor`, `Results` formats and the
`Validator` with ``rect`` off and on.

yolo11n-quan (nc=3) at imgsz 64 with seeded JAX variables
(``jax_variables``) carried by ``load_jax_variables``. The images' longer
side is 64, so the square letterbox only pads; ``rect`` batches are resized,
and there the JAX loader is given the port's letterbox so that both
Validators see the same pixels (the letterboxes' one-level difference is
``test_torch_cli.py``'s). No JAX train step is compiled.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.data import build as jax_build
from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
from quan_ultralytics_tpu.engine.predictor import Predictor as JaxPredictor
from quan_ultralytics_tpu.engine.predictor import Results as JaxResults
from quan_ultralytics_tpu.engine.validator import Validator as JaxValidator
from quan_ultralytics_tpu.losses import detect as jd
from quan_ultralytics_tpu.losses import tal as jtal
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.models.tasks import parse_model as jax_parse_model
from quan_ultralytics_tpu.ops import boxes as jbx
from quan_ultralytics_tpu.ops.boxes import make_anchors as jax_make_anchors
from quan_ultralytics_tpu_torch.cfg.models import YOLO11_QUAN
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data.augment import letterbox
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.engine.predictor import Predictor, Results
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.engine.validator import Validator
from quan_ultralytics_tpu_torch.losses import detect as td
from quan_ultralytics_tpu_torch.losses import tal as ttal
from quan_ultralytics_tpu_torch.models.tasks import (DetectionModel, fused_1x1_sites, parse_model,
                                                     resolve_model_cfg)
from quan_ultralytics_tpu_torch.ops import boxes as tbx
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ, BATCH = "yolo11n-quan.yaml", 3, 64, 4
STRIDES = (8, 16, 32)


def _tol(ref):
    """The decode tolerance of the port's tests: 1e-4 max|ref| + 1e-5."""
    return 1e-4 * (float(np.abs(ref).max()) if ref.size else 0.0) + 1e-5


# ---------------------------------------------------------------- config


def test_detect_config_resolves_to_the_jax_graph():
    """``yolo11n-quan.yaml`` resolves to the literal (held equal to its YAML by
    ``test_torch_guards.py``), whose layer specs are the JAX package's, with a
    Detect head: the task is ``detect``, and the fused 1x1 sites include the
    head's class branch."""
    cfg, scale = resolve_model_cfg(CFG)
    assert cfg is YOLO11_QUAN and scale == "n"
    specs, save, nc = parse_model(cfg, scale, NC)
    jspecs, jsave, jnc = jax_parse_model(cfg, scale, NC)
    assert [(s.i, s.f, s.module, s.args, s.n, s.c2, s.stride) for s in specs] == \
           [(s.i, s.f, s.module, s.args, s.n, s.c2, s.stride) for s in jspecs]
    assert (save, nc) == (jsave, jnc) and specs[-1].module == "Detect"
    model = DetectionModel.from_yaml(CFG, nc=80, device="cpu", fused_1x1=True)
    assert model.task == JaxDetectionModel.from_yaml(CFG, nc=80).task == "detect"
    assert model.strides == STRIDES
    sites = fused_1x1_sites(model, 2, 640)
    head = [m for n, m in model.named_modules() if ".cv3_" in n and n.endswith(("_0b", "_1b"))]
    assert len(head) == 6 and all(m.fused for m in head)
    assert len(sites) == len([m for m in model.modules() if getattr(m, "fused", False)])
    rect = fused_1x1_sites(model, 2, (480, 640))  # a rect batch: 3/4 of the pixels at every site
    assert [(ci, co, 3 * p // 4) for ci, co, p in sites] == rect


# ---------------------------------------------------------------- box math


def _xyxy(n, seed, lo=0.0, hi=60.0):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ciou", [False, True])
@pytest.mark.parametrize("xywh", [False, True])
def test_bbox_iou_matches_jax(xywh, ciou, dtype):
    """All pairs of 24 x 20 boxes, 4 of them identical (iou == 1). f32 within
    1e-6 relative and 1e-6; bf16 (each op rounded to bf16 in both packages,
    XLA may keep excess precision between ops) within 2e-2 absolute, values
    in [-1.5, 1]. The identical pairs give IoU exactly 1 and a finite CIoU
    (no 0/0 in alpha)."""
    a, b = _xyxy(24, 0), _xyxy(20, 1)
    b[:4] = a[:4]
    if xywh:
        a, b = (np.concatenate([(x[:, :2] + x[:, 2:]) / 2, x[:, 2:] - x[:, :2]], 1) for x in (a, b))
    ja, jb = (jnp.asarray(x, dtype) for x in (a, b))
    ta, tb = (to_torch(x).to(getattr(torch, dtype)) for x in (a, b))
    ref = np.asarray(jbx.bbox_iou(ja[:, None], jb[None], xywh=xywh, ciou=ciou).astype(jnp.float32))
    got = tbx.bbox_iou(ta[:, None], tb[None], xywh=xywh, ciou=ciou)
    assert got.dtype == ta.dtype and torch.isfinite(got).all()
    tol = (1e-6, 1e-6) if dtype == "float32" else (0.0, 2e-2)
    assert_close(got, ref, *tol)
    same = got.float().numpy()[np.arange(4), np.arange(4)]
    if not ciou or dtype == "bfloat16":
        np.testing.assert_array_equal(same, ref[np.arange(4), np.arange(4)])
    if not (xywh and dtype == "bfloat16"):  # xywh -> xyxy rounds the corners in bf16
        assert np.all(np.abs(same - 1) <= (1e-6 if dtype == "float32" else 0.0))


def test_ciou_gradient_matches_jax():
    """Gradients of sum(CIoU) with respect to both box sets, f32, within 1e-5
    of max|grad|: ``alpha`` is a constant of the gradient in both packages."""
    a, b = _xyxy(16, 2), _xyxy(16, 3)
    b[:3] = a[:3] + 0.5

    def jf(x, y):
        return jbx.bbox_iou(x, y, xywh=False, ciou=True).sum()

    ref = jax.grad(jf, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (to_torch(x).requires_grad_() for x in (a, b))
    got = torch.autograd.grad(tbx.bbox_iou(ta, tb, xywh=False, ciou=True).sum(), (ta, tb))
    for g, r in zip(got, ref):
        assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_xyxy2xywh_matches_jax():
    x = np.concatenate([_xyxy(12, 4), np.random.default_rng(4).uniform(0, 1, (12, 2))], 1).astype(np.float32)
    assert_close(tbx.xyxy2xywh(to_torch(x)), jbx.xyxy2xywh(jnp.asarray(x)), rtol=0, atol=0)
    assert_close(tbx.xywh2xyxy(tbx.xyxy2xywh(to_torch(x))), x, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------- NMS


def _greedy_nms(boxes: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    """Sequential greedy NMS (torchvision's semantics), the oracle."""
    keep = np.zeros(len(boxes), bool)
    for i in np.argsort(-scores, kind="stable"):
        ok = True
        for j in np.nonzero(keep)[0]:
            w = max(min(boxes[i, 2], boxes[j, 2]) - max(boxes[i, 0], boxes[j, 0]), 0)
            h = max(min(boxes[i, 3], boxes[j, 3]) - max(boxes[i, 1], boxes[j, 1]), 0)
            area = [(b[2] - b[0]) * (b[3] - b[1]) for b in (boxes[i], boxes[j])]
            if w * h / (area[0] + area[1] - w * h + 1e-7) >= thr:
                ok = False
                break
        keep[i] = ok
    return keep


@pytest.mark.parametrize("thr", [0.45, 0.7])
def test_nms_axis_aligned_matches_jax_and_greedy(thr):
    """The 8 crowded trials of 64 boxes of tests/test_boxes.py (the same
    draws), batched in one call: the keep masks equal the JAX package's and
    the sequential greedy's (their chains resolve within ``passes=4``)."""
    rng = np.random.RandomState(0)
    trials = []
    for _ in range(8):
        ctr = rng.rand(64, 2) * 30.0
        wh = 5.0 + rng.rand(64, 2) * 20.0
        trials.append((np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32),
                       rng.rand(64).astype(np.float32)))
    boxes, scores = (np.stack(t) for t in zip(*trials))
    got = tbx.nms_axis_aligned(to_torch(boxes), to_torch(scores), thr).numpy()
    for t, (b, s) in enumerate(trials):
        np.testing.assert_array_equal(got[t], np.asarray(jbx.nms_axis_aligned(jnp.asarray(b), jnp.asarray(s), thr)))
        np.testing.assert_array_equal(got[t], _greedy_nms(b, s, thr), err_msg=f"trial {t}")


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_nms_suppression_chains(depth):
    """A chain of boxes, each hitting the next and no other, in score order:
    greedy keeps every other one. Four passes resolve it up to depth 4; at
    depth 5 the port keeps what the JAX package keeps."""
    boxes = np.array([[5.0 * i, 0.0, 5.0 * i + 10.0, 10.0] for i in range(depth)], np.float32)
    scores = np.linspace(0.9, 0.5, depth).astype(np.float32)
    got = tbx.nms_axis_aligned(to_torch(boxes), to_torch(scores), 0.3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbx.nms_axis_aligned(jnp.asarray(boxes), jnp.asarray(scores), 0.3)))
    if depth <= 4:
        np.testing.assert_array_equal(got, np.arange(depth) % 2 == 0)


def _pred(seed, B=2, A=300, nc=80):
    """Decoded detect predictions ``[B, A, 4 + nc]``: xywh on an integer grid
    with even sides (exact in bf16, corners too) and scores with ties, the
    best class mostly one of the last 10 (class offsets of 70 x 7680 px and
    more)."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(8, 120, (B, A, 2))
    wh = 2 * rng.integers(2, 24, (B, A, 2))
    scores = np.round(rng.uniform(0, 1, (B, A, nc)) ** 4 * np.where(np.arange(nc) < nc - 10, 0.2, 1.0), 2)
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axis_aligned_non_max_suppression_matches_jax(dtype, agnostic):
    """80 classes (class offsets up to 79 x 7680 px), scores with ties: the
    keep masks and the detections (xyxy, conf, cls) are the JAX package's,
    exactly. bf16 predictions keep what their f32 values keep: the offset is
    added in f32."""
    pred = _pred(7)
    if dtype == "bfloat16":
        pred = np.asarray(jnp.asarray(pred, jnp.bfloat16).astype(jnp.float32))
    kw = dict(conf_thres=0.05, iou_thres=0.45, max_det=300, nc=80, agnostic=agnostic)
    ref, rok = jbx.non_max_suppression(jnp.asarray(pred, dtype), rotated=False, **kw)
    got, ok = tbx.non_max_suppression(to_torch(pred).to(getattr(torch, dtype)), rotated=False, **kw)
    assert got.shape == (2, 300, 6) and ok.shape == (2, 300)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    over = (pred[..., 4:].max(-1) > 0.05).sum(-1)
    assert (10 < ok.sum(-1).numpy()).all() and (ok.sum(-1).numpy() < over).all()  # NMS suppressed some
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    if dtype == "bfloat16":
        f32, f32_ok = tbx.non_max_suppression(to_torch(pred), rotated=False, **kw)
        np.testing.assert_array_equal(ok.numpy(), f32_ok.numpy())
        np.testing.assert_array_equal(got.float().numpy(), f32.numpy())


# ---------------------------------------------------------------- assigner and loss


def _assigner_case(kind: str, seed: int = 0, B: int = 3, M: int = 8, nc: int = 7, imgsz: int = 128):
    """Axis-aligned assigner inputs (xyxy pixels): ``random``; ``ties`` (one
    predicted box everywhere, two score levels); ``empty`` (no valid gt);
    ``padded`` (a few valid gts an image, the rest zero padding). Each
    predicted box is a gt box moved a little, as a model's boxes are after
    some training."""
    rng = np.random.default_rng(seed)
    shapes = [(imgsz // s, imgsz // s) for s in STRIDES]
    anchors, stride_t = jax_make_anchors(shapes, STRIDES, 0.5)
    anc = np.asarray(anchors * stride_t)
    A = anc.shape[0]
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    ctr = rng.uniform(imgsz * 0.2, imgsz * 0.8, (B, M, 2))
    wh = rng.uniform(16, imgsz / 2, (B, M, 2))
    gt = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    near = gt[np.arange(B)[:, None], rng.integers(0, M, (B, A))]
    boxes = (near + rng.normal(0, 3, (B, A, 4))).astype(np.float32)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
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
        gt[~mask] = 0.0
    return scores, boxes, anc, labels, gt, mask


@pytest.mark.parametrize("kind", ["random", "ties", "empty", "padded"])
def test_axis_aligned_assigner_matches_jax(kind):
    """f32: the selection (fg_mask, target_gt_idx, target_labels) equal; target
    boxes and scores (in [0, 1]) within 1e-5."""
    args = _assigner_case(kind)
    ref = jtal.task_aligned_assigner(*(jnp.asarray(a) for a in args), num_classes=7,
                                     bf16_metric=False, impl="dense", topk_impl="iter")
    got = ttal.task_aligned_assigner(*(to_torch(a) for a in args), num_classes=7)
    if kind != "empty":
        assert np.asarray(ref.fg_mask).any()
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert_close(got.target_bboxes, ref.target_bboxes, rtol=1e-6, atol=1e-6)
    assert_close(got.target_scores, ref.target_scores, rtol=1e-5, atol=1e-5)


def test_axis_aligned_assigner_bf16_selects_as_f32():
    """The bf16 metric chain (the trainer's default) on a case without
    near-ties (well-separated gts, predicted boxes on them): the same
    foreground and labels as f32, normalized scores within 5% and 5e-3 (as
    tests/test_losses.py holds the JAX package's); outputs stay f32."""
    rng = np.random.default_rng(1)
    shapes = [(128 // s, 128 // s) for s in STRIDES]
    anchors, stride_t = jax_make_anchors(shapes, STRIDES, 0.5)
    anc = to_torch(np.asarray(anchors * stride_t))
    A = anc.shape[0]
    gt = torch.tensor([[[8.0, 8.0, 56.0, 56.0], [72.0, 72.0, 120.0, 120.0]]])
    boxes = gt[0, (anc[:, 0] > 64).long()][None] + torch.from_numpy(rng.normal(0, 2, (1, A, 4))).float()
    scores = torch.from_numpy(rng.uniform(0.1, 0.9, (1, A, 4))).float()
    args = (scores, boxes, anc, torch.tensor([[1, 3]]), gt, torch.ones(1, 2, dtype=torch.bool))
    r32 = ttal.task_aligned_assigner(*args, num_classes=4)
    r16 = ttal.task_aligned_assigner(*args, num_classes=4, bf16_metric=True)
    assert r16.target_scores.dtype == torch.float32 and r32.fg_mask.sum() >= 10
    assert torch.equal(r16.fg_mask, r32.fg_mask)
    assert torch.equal(r16.target_labels[r32.fg_mask], r32.target_labels[r32.fg_mask])
    np.testing.assert_allclose(r16.target_scores.numpy(), r32.target_scores.numpy(), rtol=0.05, atol=5e-3)


def _head_outputs(seed: int, B: int = 2, nc: int = 3, imgsz: int = 64):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, imgsz // s, imgsz // s, 64 + nc)) * 2).astype(np.float32) for s in STRIDES]


def _detect_batch(seed: int, B: int = 2, M: int = 6, nc: int = 3, empty: bool = False):
    """Normalized xywh targets; per image some valid rows and padding (one
    padded row of zeros, which the sum filter drops)."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.1, 0.5, (B, M, 2))],
                           -1).astype(np.float32)
    boxes[:, -1] = 0.0
    mask = np.zeros((B, M), bool)
    if not empty:
        mask[0, :5] = True
        mask[1, :3] = True
        mask[0, -1] = True  # a valid row of zeros
    return {"cls": rng.integers(0, nc, (B, M)).astype(np.int32), "bboxes": boxes, "mask": mask}


@pytest.mark.parametrize("case", ["f32", "bf16_assigner", "empty"])
def test_detection_loss_and_gradients_match_jax(case):
    """Total and aux terms (box, cls, dfl, num_fg) at 1e-5 relative; gradients
    with respect to the head outputs at 1e-4 relative and 1e-5 of max|grad|."""
    nc, bf16 = 3, case == "bf16_assigner"
    feats = _head_outputs(5)
    batch = _detect_batch(6, empty=case == "empty")

    def jloss(f):
        return jd.detection_loss(f, {k: jnp.asarray(v) for k, v in batch.items()}, STRIDES, nc,
                                 assigner_bf16=bf16)

    (ref, raux), rgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(f) for f in feats])
    tf = [to_torch(f).requires_grad_() for f in feats]
    got, aux = td.detection_loss(tf, {k: to_torch(v) for k, v in batch.items()}, STRIDES, nc,
                                 assigner_bf16=bf16)
    grads = torch.autograd.grad(got, tf)
    assert_close(got, ref, rtol=1e-5, atol=1e-7)
    assert set(aux) == set(raux) == {"box", "cls", "dfl", "num_fg"}
    for k in aux:
        assert_close(aux[k], raux[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert (int(aux["num_fg"]) == 0) == (case == "empty")
    for g, r in zip(grads, rgrads):
        assert_close(g, r, rtol=1e-4, atol=1e-5)


def test_trainer_step_on_a_detect_model():
    """One port `Trainer.step` of yolo11n-quan (f32, nbs = batch: an update a
    micro-step): its loss is `detection_loss` of the same train-mode forward,
    and the weights move."""
    torch.manual_seed(0)
    model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"img": rng.integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8), **_detect_batch(4)}
    ref_model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu")
    ref_model.load_state_dict(model.state_dict())
    ref_model.train()
    ref, _ = td.detection_loss(ref_model(torch.from_numpy(batch["img"]).float() / 255.0),
                               {k: to_torch(v) for k, v in batch.items()}, STRIDES, NC, assigner_bf16=True)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, dtype="float32"), steps_per_epoch=4, device="cpu")
    w0 = [p.detach().clone() for p in tr.params]
    loss, aux = tr.step(batch)
    assert set(aux) == {"box", "cls", "dfl", "num_fg", "nan_skipped"} and float(aux["nan_skipped"]) == 0
    assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(a, b) for a, b in zip(w0, tr.params))


# ---------------------------------------------------------------- predictor and results


@pytest.fixture(scope="module")
def pair():
    """The JAX model with seeded variables and the port model carrying them.
    The box branches' biases favour the low DFL bins (-0.6 a bin), so that the
    random model's boxes are a few strides wide and lie mostly in the frame
    (with the draws' N(0, 0.1) biases they span several frames)."""
    jm = JaxDetectionModel.from_yaml(CFG, nc=NC)
    v = jax_variables(jm.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=2)
    for i in range(3):
        v["params"]["model_23"][f"cv2_{i}_2"]["proj"]["bias"] = np.tile(-0.6 * np.arange(16, dtype=np.float32), 4)
    tm = DetectionModel.from_yaml(CFG, nc=NC, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def test_predictor_matches_jax(pair):
    """Frames whose longer side is 64 (the letterbox only pads): per frame the
    same kept count and classes, and xyxy (in source pixels, clipped to the
    frame), conf within 1e-4 max|ref| + 1e-5."""
    jm, v, tm = pair
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((64, 64), (48, 64), (64, 40))]
    ref = JaxPredictor(jm, imgsz=IMGSZ, conf=0.25)(v, frames)
    got = Predictor(tm, imgsz=IMGSZ, conf=0.25)(frames)
    assert sum(len(r.boxes) for r in ref) > 0
    for g, r, f in zip(got, ref, frames):
        assert g.task == "detect" and g.boxes.shape[1] == 6 and len(g) == len(r.boxes)
        np.testing.assert_array_equal(g.cls, r.boxes[:, 5])
        np.testing.assert_allclose(g.boxes, r.boxes, rtol=0, atol=_tol(r.boxes))
        assert (g.xyxy >= 0).all() and (g.xyxy[:, [0, 2]] <= f.shape[1]).all()
        assert (g.xyxy[:, [1, 3]] <= f.shape[0]).all()


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 1), (2, 0)])
def test_results_detect_formats_match_jax(tmp_path, seed, n):
    """verbose, xyxy, the 'cls xc yc w h [conf]' label lines and the JSON
    summary of detect Results equal the JAX package's (numbers within 1e-6)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2)), rng.uniform(0.2, 1, (n, 1)),
                            rng.integers(0, 3, (n, 1))], 1).astype(np.float32)
    names = ["person", "bicycle", "car"]
    got = Results((80, 100), boxes, names=names, task="detect")
    ref = JaxResults((80, 100), boxes, names=names, task="detect")
    assert got.verbose() == ref.verbose() and got.xywhr is None
    np.testing.assert_array_equal(got.xyxy, ref.xyxy)
    assert json.loads(got.tojson()) == json.loads(ref.tojson())
    for save_conf in (False, True):
        got.save_txt(tmp_path / "port.txt", save_conf=save_conf)
        ref.save_txt(tmp_path / "jax.txt", save_conf=save_conf)
    gl, rl = ((tmp_path / f).read_text().splitlines() for f in ("port.txt", "jax.txt"))
    assert len(gl) == len(rl) == 2 * n
    for a, b in zip(gl, rl):
        a, b = a.split(), b.split()
        assert a[0] == b[0] and len(a) == len(b) in (5, 6)
        np.testing.assert_allclose([float(x) for x in a[1:]], [float(x) for x in b[1:]], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- validator

# (h, w): four wide and two tall frames, longer side 64. rect batches them as
# (64, 96) and (96, 64) at imgsz 64 (the reference's half-stride pad)
SIZES = [(32, 64), (40, 64), (44, 64), (48, 64), (64, 48), (64, 40)]


def _write_set(root, detections=None, seed=0):
    """Seeded PNGs labelled with 1-4 random boxes each and, given
    ``detections`` (per image, rows of xyxy source pixels and a class), those
    too. Returns the data set's config dict."""
    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True, exist_ok=True)
    (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(SIZES):
        imwrite_png(root / "images" / "val" / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows = [(int(rng.integers(0, NC)), *rng.uniform(0.3, 0.7, 2), *rng.uniform(0.1, 0.5, 2))
                for _ in range(int(rng.integers(1, 5)))]
        for x1, y1, x2, y2, c in (detections[i] if detections else []):
            rows.append((int(c), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h))
        (root / "labels" / "val" / f"im{i}.txt").write_text(
            "\n".join(" ".join([str(c)] + [f"{v:.6f}" for v in r]) for c, *r in rows) + "\n")
    return {"path": str(root), "train": "images/val", "val": "images/val", "names": {0: "a", 1: "b", 2: "c"}}


def _area(xyxy):
    return np.prod(xyxy[:, 2:4] - xyxy[:, :2], -1)


def _port_letterbox(im, new_shape, scaleup=True, center=True):
    """The port's letterbox in the JAX loader's place (numpy in and out)."""
    out, r, pad = letterbox(torch.from_numpy(np.ascontiguousarray(im)), new_shape, scaleup, center)
    return out.numpy(), r, pad


@pytest.fixture(scope="module")
def val_runs(pair, tmp_path_factory):
    """Both Validators with rect off and on, on a set labelled also with the
    JAX model's top 3 detections of each image that lie at least 0.7 in the
    frame (the last with another class), clipped to it. The JAX loader
    letterboxes with the port's letterbox here."""
    jm, v, tm = pair
    tmp = tmp_path_factory.mktemp("detect_val")
    jval, tval = JaxValidator(jm, imgsz=IMGSZ), Validator(tm, imgsz=IMGSZ)
    own = []
    cfg = _write_set(tmp)
    for batch in build_dataloader(YOLODataset(cfg, "val"), BATCH, IMGSZ, hyp=None, augment=False,
                                  shuffle=False, drop_last=False, with_meta=True):
        det, ok, _ = jval._infer(v, jnp.asarray(batch["img"]))
        for b in range(batch["n_real"]):
            d = np.asarray(det)[b][np.asarray(ok)[b]].astype(np.float64)
            src = tbx.scale_boxes(d[:, :4], batch["ratio_pad"][b])
            d[:, :4] = tbx.scale_boxes(d[:, :4], batch["ratio_pad"][b], batch["ori_shape"][b])
            d = d[_area(d) >= 0.7 * _area(src)][:3]
            d[-1, 5] = (d[-1, 5] + 1) % NC
            own.append(d[:, [0, 1, 2, 3, 5]])
    cfg = _write_set(tmp, detections=own)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_build, "letterbox", _port_letterbox)
        for rect in (False, True):
            for name, run in (("jax", lambda **kw: jval(v, JaxDataset(cfg, "val"), batch_size=BATCH, **kw)),
                              ("port", lambda **kw: tval(YOLODataset(cfg, "val"), batch_size=BATCH, **kw))):
                js = tmp / f"{name}_{rect}.json"
                metrics = run(save_json=str(js), rect=rect)
                out[name, rect] = {"metrics": metrics, "json": json.loads(js.read_text()),
                                   "confusion": (jval if name == "jax" else tval).confusion.matrix.copy()}
    return out


@pytest.mark.parametrize("rect", [False, True])
def test_validator_matches_jax(val_runs, rect):
    """Metrics within 1e-3 (mAP50 above 0), the confusion matrix equal, and the
    COCO JSON (``bbox`` ``[x1, y1, w, h]`` in source pixels, rounded to 3
    decimals, and the score, to 5) equal after parsing, numbers within 1.5e-3
    (a value within 5e-4 may round one step apart), detections in the same order."""
    got, ref = val_runs["port", rect], val_runs["jax", rect]
    assert ref["metrics"]["mAP50"] > 0 and set(got["metrics"]) == set(ref["metrics"])
    for k in ref["metrics"]:
        assert abs(got["metrics"][k] - ref["metrics"][k]) <= 1e-3, (k, got["metrics"][k], ref["metrics"][k])
    np.testing.assert_array_equal(got["confusion"], ref["confusion"])
    assert len(got["json"]) == len(ref["json"]) > 0
    for a, b in zip(got["json"], ref["json"]):
        assert set(a) == set(b) == {"image_id", "category_id", "bbox", "score"}
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["bbox"] + [a["score"]], b["bbox"] + [b["score"]], rtol=0, atol=1.5e-3)


def test_rect_batches_are_not_square(val_runs, tmp_path):
    """rect letterboxes each batch to its own shape (so the attention sees
    another N); the OBB Validator refuses rect, and the detect one a DOTA
    submission, as the JAX package does."""
    cfg = _write_set(tmp_path)
    shapes = [b["img"].shape[1:3] for b in build_dataloader(
        YOLODataset(cfg, "val"), BATCH, IMGSZ, hyp=None, augment=False, shuffle=False, drop_last=False,
        rect=True)]
    assert shapes == [(64, 96), (96, 64)]
    assert val_runs["port", True]["metrics"] != val_runs["port", False]["metrics"]
    obb_dir = tmp_path / "obb" / "images" / "val"
    obb_dir.mkdir(parents=True)
    imwrite_png(obb_dir / "im0.png", np.zeros((64, 32, 3), np.uint8))  # no labels
    obb_cfg = {"path": str(tmp_path / "obb"), "val": "images/val", "names": {0: "a"}}
    obb = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=1, device="cpu")
    with pytest.raises(ValueError, match="rect"):
        Validator(obb, imgsz=IMGSZ)(YOLODataset(obb_cfg, "val", task="obb"), rect=True)
    with pytest.raises(ValueError, match="OBB"):
        Validator(DetectionModel.from_yaml(CFG, nc=NC, device="cpu"), imgsz=IMGSZ)(
            YOLODataset(cfg, "val"), save_submission=str(tmp_path / "sub"))
