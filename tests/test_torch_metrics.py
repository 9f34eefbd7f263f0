"""The port's metrics, DOTA submission, box scaling, callbacks and checkpoint
lookup against the JAX package on seeded inputs, on the CPU.

Everything here is float64 numpy on both sides, the same arithmetic in the
same order, so results are held to rtol 1e-12. A perfect prediction scores
0.995 in mAP50 and mAP50-95 in both packages, as in the reference: the
101-point interpolation's last step, from recall 1 to the sentinel point at
precision 0, costs half of its 0.01 width.
"""

import csv
import math

import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.engine import dota_eval as jd
from quan_ultralytics_tpu.ops import boxes as jb
from quan_ultralytics_tpu.utils import callbacks as jcb
from quan_ultralytics_tpu.utils import checkpoint as jck
from quan_ultralytics_tpu.utils import metrics as jm
from quan_ultralytics_tpu_torch.engine import dota_eval as td
from quan_ultralytics_tpu_torch.ops import boxes as tb
from quan_ultralytics_tpu_torch.utils import callbacks as tcb
from quan_ultralytics_tpu_torch.utils import checkpoint as tck
from quan_ultralytics_tpu_torch.utils import metrics as tm

RTOL = 1e-12
NC = 5


def _rboxes(rng, n, scale=100.0):
    return np.concatenate([rng.uniform(0, scale, (n, 2)), rng.uniform(2, scale / 3, (n, 2)),
                           rng.uniform(-math.pi / 2, math.pi, (n, 1))], 1)


def _xyxy(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, scale / 3, (n, 2))], 1)


def _images(seed, rotated, n_images=12):
    """Per image (pred boxes, conf, cls, gt boxes, gt cls): predictions are the
    ground truth jittered, plus false positives, some images empty on either side."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        n_gt = 0 if i % 5 == 4 else int(rng.integers(1, 8))
        gt = _rboxes(rng, n_gt) if rotated else _xyxy(rng, n_gt)
        gt_cls = rng.integers(0, NC, n_gt).astype(np.float64)
        jitter = gt + rng.normal(0, 2.0, gt.shape) * ([1, 1, 1, 1, 0.05] if rotated else 1)
        fp = _rboxes(rng, int(rng.integers(0, 4))) if rotated else _xyxy(rng, int(rng.integers(0, 4)))
        pred = np.concatenate([jitter, fp]) if i % 7 != 3 else gt[:0]
        cls = np.concatenate([np.where(rng.random(n_gt) < 0.8, gt_cls, rng.integers(0, NC, n_gt)),
                              rng.integers(0, NC, len(fp))])[:len(pred)].astype(np.float64)
        conf = rng.uniform(0.001, 1.0, len(pred))
        conf[:2] = 0.5  # a tie
        out.append((pred, conf, cls, gt, gt_cls))
    return out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


def test_iou_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, 9), _rboxes(rng, 7)
    _close(tm._probiou_np(a, b), jm._probiou_np(a, b))
    a, b = _xyxy(rng, 9), _xyxy(rng, 7)
    _close(tm._box_iou_np(a, b), jm._box_iou_np(a, b))
    iou = rng.uniform(0.3, 1.0, (6, 9))
    iou[0, :2] = 0.75  # ties
    pc, gc = rng.integers(0, 3, 9), rng.integers(0, 3, 6)
    np.testing.assert_array_equal(tm.match_predictions(pc, gc, iou), jm.match_predictions(pc, gc, iou))


def test_ap_helpers_match_jax():
    rng = np.random.default_rng(1)
    rec = np.sort(rng.uniform(0, 1, 50))
    prec = rng.uniform(0, 1, 50)
    _close(tm.compute_ap(rec, prec), jm.compute_ap(rec, prec))
    y = rng.uniform(0, 1, 1000)
    _close(tm.smooth(y, 0.1), jm.smooth(y, 0.1))
    tp = rng.random((200, 10)) < 0.6
    conf, pcls, tcls = rng.uniform(0, 1, 200), rng.integers(0, NC, 200), rng.integers(0, NC - 1, 120)
    ours, ref = tm.ap_per_class(tp, conf, pcls, tcls, NC), jm.ap_per_class(tp, conf, pcls, tcls, NC)
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k])


@pytest.mark.parametrize("rotated", [True, False])
def test_det_metrics_and_confusion_match_jax(rotated):
    ours, ref = tm.DetMetrics(nc=NC, rotated=rotated), jm.DetMetrics(nc=NC, rotated=rotated)
    cm_o, cm_r = tm.ConfusionMatrix(nc=NC), jm.ConfusionMatrix(nc=NC)
    for pred, conf, cls, gt, gt_cls in _images(2, rotated):
        ours.update(pred, conf, cls, gt, gt_cls)
        ref.update(pred, conf, cls, gt, gt_cls)
        cm_o.process_batch(pred, conf, cls, gt, gt_cls, rotated=rotated)
        cm_r.process_batch(pred, conf, cls, gt, gt_cls, rotated=rotated)
    a, b = ours.compute(), ref.compute()
    assert set(a) == set(b) and 0 < a["mAP50"] < 1
    for k in b:
        _close(a[k], b[k])
    names = [f"class{i}" for i in range(NC)]
    assert ours.per_class_table(names) == ref.per_class_table(names)
    np.testing.assert_array_equal(cm_o.matrix, cm_r.matrix)
    for x, y in zip(cm_o.tp_fp(), cm_r.tp_fp()):
        np.testing.assert_array_equal(x, y)
    assert cm_o.summary(names) == cm_r.summary(names)
    assert cm_o.matrix.sum() > 0


def test_perfect_predictions_score_the_ceiling():
    rng = np.random.default_rng(3)
    ours, ref = tm.DetMetrics(nc=NC, rotated=True), jm.DetMetrics(nc=NC, rotated=True)
    for _ in range(4):
        gt = _rboxes(rng, 6)
        gt_cls = rng.integers(0, NC, 6).astype(np.float64)
        conf = rng.uniform(0.5, 1, 6)
        ours.update(gt, conf, gt_cls, gt, gt_cls)
        ref.update(gt, conf, gt_cls, gt, gt_cls)
    out = ours.compute()
    assert out == ref.compute()
    assert out["mAP50"] == pytest.approx(0.995, abs=1e-12)
    assert out["mAP50-95"] == pytest.approx(0.995, abs=1e-12)
    assert out["precision"] == out["recall"] == pytest.approx(1.0, abs=1e-12)


def test_empty_metrics_and_plots(tmp_path):
    """Empty metrics compute as JAX's; their plots are ported: no curve is
    written without predictions (as in JAX), the empty confusion matrix is."""
    assert tm.DetMetrics(nc=3).compute() == jm.DetMetrics(nc=3).compute()
    assert tm.DetMetrics(nc=3).plot(tmp_path) == jm.DetMetrics(nc=3).plot(tmp_path) == []
    assert tm.ConfusionMatrix(nc=3).plot(tmp_path).name == "confusion_matrix_normalized.png"
    assert (tmp_path / "confusion_matrix_normalized.png").exists()


def test_dota_submission_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    names = [f"name{i}" for i in range(NC)]
    ours, ref = td.DOTASubmission(names), jd.DOTASubmission(names)
    for stem in ["P0001__0_0", "P0001__824_0", "P0001__0_824", "P0002__0_0", "P0003", "P0004__0_0"]:
        n = 0 if stem == "P0004__0_0" else int(rng.integers(3, 12))
        boxes = _rboxes(rng, n, scale=1024.0)
        boxes[n // 2:, :2] = boxes[:n - n // 2, :2] + rng.normal(0, 3, (n - n // 2, 2))  # overlaps
        conf, cls = rng.uniform(0, 1, n), rng.integers(0, NC, n).astype(np.float64)
        ours.add_patch(stem, boxes, conf, cls)
        ref.add_patch(stem, boxes, conf, cls)
    fo, fr = ours.write(tmp_path / "ours"), ref.write(tmp_path / "ref")
    assert [p.split("/")[-1] for p in fo] == [p.split("/")[-1] for p in fr] == \
        [f"Task1_{n}.txt" for n in names]
    lines = 0
    for a, b in zip(fo, fr):
        assert open(a).read() == open(b).read()
        lines += len(open(a).read().splitlines())
    assert lines > 0
    b = _rboxes(rng, 20)
    s = rng.uniform(0, 1, 20)
    np.testing.assert_array_equal(td._nms_rotated_np(b, s), jd._nms_rotated_np(b, s))
    _close(td._xywhr_to_corners(b), jd._xywhr_to_corners(b))
    assert td.PATCH_RE.pattern == jd.PATCH_RE.pattern


def test_scale_boxes_match_jax():
    rng = np.random.default_rng(5)
    ratio_pad = np.array([0.625, 0.0, 112.0], np.float32)
    xyxy, xywhr = _xyxy(rng, 10, 1024.0).astype(np.float32), _rboxes(rng, 10, 1024.0).astype(np.float32)
    for ori in (None, np.array([600.0, 900.0])):
        ref = jb.scale_boxes(xyxy, ratio_pad, ori)
        np.testing.assert_array_equal(tb.scale_boxes(xyxy, ratio_pad, ori), ref)
        np.testing.assert_allclose(tb.scale_boxes(torch.from_numpy(xyxy), torch.from_numpy(ratio_pad),
                                                  ori).numpy(), ref, rtol=1e-6)
    ref = jb.scale_rboxes(xywhr, ratio_pad)
    np.testing.assert_array_equal(tb.scale_rboxes(xywhr, ratio_pad), ref)
    np.testing.assert_allclose(tb.scale_rboxes(torch.from_numpy(xywhr), torch.from_numpy(ratio_pad)).numpy(),
                               ref, rtol=1e-6)


def test_callbacks_and_csv_match_jax(tmp_path):
    assert tcb.EVENTS == jcb.EVENTS
    rows = [{"epoch": 0, "loss": 1.5, "mAP50": 0.1}, {"epoch": 1, "loss": 1.25, "mAP50": 0.2}]
    for mod, d in ((tcb, tmp_path / "ours"), (jcb, tmp_path / "ref")):
        cb, seen = mod.Callbacks(), []
        mod.CSVLogger(d).attach(cb)
        cb.add("on_fit_epoch_end", seen.append)
        for r in rows:
            cb.run("on_fit_epoch_end", r)
        assert seen == rows
        with pytest.raises(ValueError, match="unknown callback event"):
            cb.add("on_nothing", print)
    assert (tmp_path / "ours" / "results.csv").read_text() == (tmp_path / "ref" / "results.csv").read_text()
    assert list(csv.DictReader(open(tmp_path / "ours" / "results.csv")))[1]["loss"] == "1.25"


def test_checkpoint_latest_matches_jax(tmp_path):
    assert tck.latest(tmp_path / "none") is None is jck.latest(tmp_path / "none")
    assert tck.latest(tmp_path) is None
    for n in (2, 10, 9):
        (tmp_path / f"epoch{n}.ckpt").write_bytes(b"")
    assert tck.latest(tmp_path) == jck.latest(tmp_path) == str(tmp_path / "epoch10.ckpt")
    (tmp_path / "last.ckpt").write_bytes(b"")
    assert tck.latest(tmp_path) == jck.latest(tmp_path) == str(tmp_path / "last.ckpt")
