"""The port's annotations against OpenCV 5.0 and the JAX package, on the CPU
(``tests/test_torch_raster.py`` holds the writers, the raster and the text
metrics they are built on, ``tests/test_torch_charts.py`` the charts).

* ``Results.plot`` (OBB, detect, segment, pose), ``plot_results`` and the
  Annotator against the JAX functions on the same inputs: equal outside the
  labels' text (each label's box grown by 2 px and by its descent);
  ``plot_images`` (no labels) and ``feature_visualization`` (no text) equal;
  the port model's features against the JAX model's (f32, weights carried by
  ``load_jax_variables``) within 2e-4 relative, and their feature grids within
  one gray level.
* ``yolo-torch obb predict save=True visualize=<dir>`` writes ``im{i}.jpg``
  and one feature PNG a layer.

Four tests (cases loop inside them): pytest-xdist's ``--dist loadfile``
queues files by their number of tests, and this file then comes after every
long JAX test file, so it runs beside them and does not delay them.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.engine.predictor import Results as JaxResults
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.utils import plotting as jplot
from quan_ultralytics_tpu_torch import cli
from quan_ultralytics_tpu_torch.data.native import native
from quan_ultralytics_tpu_torch.data.native import pixels as px
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.engine.predictor import Results
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils import plotting as tplot
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _bgr(im):
    return cv2.cvtColor(im, cv2.COLOR_RGB2BGR) if im.ndim == 3 else im


# ------------------------------------------------------------------ annotations


def _glyph_mask(shape, ann, rows, task):
    """True outside every label's text: its box grown by 2 px and by its descent."""
    keep = np.ones(shape[:2], bool)
    for row in rows:
        c = int(row[-1])
        if task == "obb":
            pts = px.box_points((float(row[0]), float(row[1])), (float(row[2]), float(row[3])),
                                float(row[4]) * 180 / math.pi)
            org = (int(pts[0][0]), int(pts[0][1]))
        else:
            org = (int(row[0]), int(row[1]))
        (x1, y1), (x2, y2) = ann.label_box(org, f"{NAMES[c]} {row[-2]:.2f}")
        h = y2 - y1
        keep[max(y1 - 2, 0):max(y2 + h // 2 + 2, 0), max(x1 - 2, 0):max(x2 + 3, 0)] = False
    return keep


NAMES = ["plane", "ship", "storage-tank", "baseball-diamond"]


def _frame(h=300, w=400, seed=0):
    return (np.random.default_rng(seed).integers(0, 90, (h, w, 3)) + 80).astype(np.uint8)


def _rows(task, h, w, seed=0):
    rng = np.random.default_rng(seed)
    n = 6
    conf, cls = rng.uniform(0.2, 1, n), rng.integers(0, len(NAMES), n)
    if task == "obb":
        xy = rng.uniform([0, 0], [w, h], (n, 2))
        return np.column_stack([xy, rng.uniform(8, 90, (n, 2)), rng.uniform(-1.5, 1.5, n), conf, cls])
    x1y1 = rng.uniform([0, 0], [w - 20, h - 20], (n, 2))
    x2y2 = np.minimum(x1y1 + rng.uniform(8, 120, (n, 2)), [w, h])
    return np.column_stack([x1y1, x2y2, conf, cls])


def test_results_plot_equals_jax_outside_the_glyphs(tmp_path):
    for task in ("obb", "detect", "segment", "pose"):
        _check_results_plot(task, tmp_path)


def _check_results_plot(task, tmp_path):
    im = _frame()
    rows = _rows(task, *im.shape[:2])
    extra = {}
    if task == "segment":
        rng = np.random.default_rng(5)
        extra["masks"] = rng.uniform(0, 1, (len(rows),) + im.shape[:2]) > 0.7
    if task == "pose":
        rng = np.random.default_rng(6)
        kp = np.concatenate([rng.uniform(-5, [405, 305], (len(rows), 17, 2)), rng.uniform(0, 1, (len(rows), 17, 1))], 2)
        extra["keypoints"] = kp
    got = Results(im.shape[:2], rows, names=NAMES, task=task, orig_img=torch.from_numpy(im), **extra).plot(
        filename=str(tmp_path / "a.jpg"))
    ref = JaxResults(im.shape[:2], rows, names=NAMES, task=task, orig_img=im, **extra).plot()
    keep = _glyph_mask(im.shape, tplot.Annotator(im.copy(), NAMES), rows, task)
    assert keep.mean() > 0.6
    np.testing.assert_array_equal(got[keep], ref[keep])
    assert np.abs(got.astype(int) - ref).mean() < 2
    assert (tmp_path / "a.jpg").read_bytes() == cv2.imencode(".jpg", _bgr(got))[1].tobytes()


def test_plot_results_and_images_equal_jax(tmp_path):
    im = _frame(seed=1)
    rows = _rows("detect", *im.shape[:2], seed=2)
    r = JaxResults(im.shape[:2], rows, names=NAMES, task="detect", orig_img=im)
    got = tplot.plot_results(r, str(tmp_path / "p.jpg"), source_im=im)
    ref = jplot.plot_results(r, str(tmp_path / "j.jpg"), source_im=im)
    keep = _glyph_mask(im.shape, tplot.Annotator(im.copy(), NAMES), rows, "detect")
    np.testing.assert_array_equal(got[keep], ref[keep])
    rng = np.random.default_rng(3)
    for boxes in (rng.uniform(0.1, 0.6, (5, 8, 5)), rng.uniform(0.1, 0.6, (5, 8, 4))):
        batch = {"img": rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8), "bboxes": boxes.astype(np.float32),
                 "cls": rng.integers(0, 4, (5, 8)), "mask": rng.uniform(0, 1, (5, 8)) > 0.3}
        got = tplot.plot_images(batch, str(tmp_path / "b.jpg"))
        np.testing.assert_array_equal(got, jplot.plot_images(batch, str(tmp_path / "c.jpg")))


@pytest.fixture(scope="module")
def feature_pair():
    """The OBB model's features at imgsz 32 from both packages, same weights."""
    jm = JaxDetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15)
    x = np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    v = jax_variables(jm.module, jnp.asarray(x), train=False)
    _, jfeats = jax.jit(jm.features)(v, jnp.asarray(x))
    tm = load_jax_variables(DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu",
                                                     fused_1x1=False), v).eval()
    with torch.no_grad():
        _, tfeats = tm.features(to_torch(x))
    return {i: np.asarray(f) for i, f in jfeats.items()}, tfeats


def test_feature_grids_equal_jax(feature_pair, tmp_path):
    jfeats, tfeats = feature_pair
    assert sorted(jfeats) == sorted(tfeats)
    for i in sorted(jfeats):
        assert_close(tfeats[i], jfeats[i], rtol=2e-4, atol=2e-5)
        # the same features give the same PNG; the port's own within one level
        p, j = tmp_path / f"p{i}.png", tmp_path / f"j{i}.png"
        tplot.feature_visualization(jfeats[i], p)
        jplot.feature_visualization(jfeats[i], str(j))
        np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), cv2.imread(str(j), cv2.IMREAD_UNCHANGED))
        own = tplot.feature_grid(tfeats[i]).astype(int)
        assert np.abs(own - cv2.imread(str(j), cv2.IMREAD_UNCHANGED)).max() <= 1




def test_cli_predict_saves_and_visualizes(tmp_path, capsys):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    for i, (h, w) in enumerate(((60, 80), (64, 64))):
        native.imwrite(src / f"f{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    torch.manual_seed(0)
    pkl = YOLO("yolo11n-obb-quan.yaml", nc=15, device="cpu").export(format="params", path=str(tmp_path / "m.pkl"))
    assert cli.main(["obb", "predict", f"model={pkl}", f"source={src}", "imgsz=64", "conf=0.0", "device=cpu",
                     "save=True", f"save_dir={tmp_path / 'pred'}", f"visualize={tmp_path / 'vis'}"]) == 0
    for i, hw in enumerate(((60, 80), (64, 64))):
        assert native.imread(tmp_path / "pred" / f"im{i}.jpg").shape[:2] == hw
        pngs = sorted((tmp_path / "vis" / f"im{i}").glob("stage*_features.png"))
        assert len(pngs) == 23 and pngs[0].name == "stage0_Conv_features.png"
    assert "image 2/2" in capsys.readouterr().out
