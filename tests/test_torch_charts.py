"""The port's charts against matplotlib and the JAX package, on the CPU.

* The curves ``DetMetrics.curves`` draws equal the arrays the JAX
  ``DetMetrics.plot`` hands matplotlib (recomputed from its ``last``), with the
  same labels where JAX's are right; the confusion matrix's array equal; the
  files have JAX's names and pixel sizes (1800 x 1200, 2400 x 1800). The two
  label fixes (a dict of names labels the matrix by value, a list labels the
  curves by name) are held as divergences.
* ``Validator(save_dir=)`` writes the six images.
* "Blues" within one level of matplotlib's; the classification
  ``ExperimentManager`` writes ``curves.png`` at the JAX ``plot_curves``'
  size (400 x 300 a panel).

Four tests: pytest-xdist's ``--dist loadfile`` queues files by their number
of tests, and this file then comes after every long JAX test file, so it
runs beside them and does not delay them.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
from matplotlib import colormaps

from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.utils import metrics as jmetrics
from quan_ultralytics_tpu.utils import plotting as jplot
from quan_ultralytics_tpu_torch.classification import train as ttrain
from quan_ultralytics_tpu_torch.data.native import native
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils import metrics as tmetrics
from quan_ultralytics_tpu_torch.utils import plotting as tplot
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _metrics_pair():
    rng = np.random.default_rng(0)
    tm, jm = tmetrics.DetMetrics(nc=3), jmetrics.DetMetrics(nc=3)
    for _ in range(12):
        gt = rng.uniform(0, 100, (5, 2))
        gt = np.concatenate([gt, gt + rng.uniform(10, 30, (5, 2))], 1)
        args = (gt + rng.normal(0, 3, gt.shape), rng.uniform(0, 1, 5), rng.integers(0, 3, 5), gt,
                rng.integers(0, 3, 5))
        tm.update(*args)
        jm.update(*args)
    tm.compute()
    jm.compute()
    return tm, jm


def test_curves_draw_the_jax_arrays(tmp_path):
    tm, jm = _metrics_pair()
    names = {0: "plane", 1: "ship", 2: "tank"}
    res = jm.last
    seen = res["classes"]
    specs = tm.curves(names)
    assert [s["file"] for s in specs] == ["PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"]
    pr = specs[0]
    np.testing.assert_array_equal(pr["x"], res["rx"])
    for (lab, y, lw, _), c in zip(pr["series"], seen):
        np.testing.assert_array_equal(y, res["prec_values"][c])
        assert lab == f"{names[c]} {res['ap'][c, 0]:.3f}" and lw == 1
    np.testing.assert_array_equal(pr["series"][-1][1], res["prec_values"][seen].mean(0))
    for spec, key in zip(specs[1:], ("f1_curve", "p_curve", "r_curve")):
        np.testing.assert_array_equal(spec["x"], res["px"])
        for (lab, y, _, _), c in zip(spec["series"], seen):
            np.testing.assert_array_equal(y, res[key][c])
            assert lab == names[c]
        y = jmetrics.smooth(res[key][seen].mean(0), 0.05)
        np.testing.assert_array_equal(spec["series"][-1][1], y)
        assert spec["series"][-1][0] == f"all classes {y.max():.2f} at {res['px'][y.argmax()]:.3f}"
    # a list of names labels by name here; the JAX lambda gives a function object
    assert tm.curves(["plane", "ship", "tank"])[1]["series"][0][0] in ("plane", "ship", "tank")
    # files: JAX's names and pixel sizes
    got = tm.plot(tmp_path / "p", names)
    ref = jm.plot(tmp_path / "j", names)
    assert [p.name for p in got] == [p.name for p in ref]
    for a, b in zip(got, ref):
        assert native.imread(a).shape == cv2.imread(str(b)).shape == (1200, 1800, 3)


def test_confusion_matrix_draws_the_jax_array(tmp_path):
    rng = np.random.default_rng(1)
    tcm, jcm = tmetrics.ConfusionMatrix(3), jmetrics.ConfusionMatrix(3)
    tcm.matrix = jcm.matrix = rng.integers(0, 20, (4, 4)).astype(float)
    names = ["plane", "ship", "tank"]
    for normalize in (False, True):
        array, labels = tcm.plot_data(names, normalize)
        ref = jcm.matrix / ((jcm.matrix.sum(0, keepdims=True) + 1e-9) if normalize else 1.0)
        np.testing.assert_array_equal(array, ref)
        assert labels == names + ["background"]
        for d in ("p", "j"):
            (tmp_path / d).mkdir(exist_ok=True)
        got = tcm.plot(tmp_path / "p", names, normalize=normalize)
        want = jcm.plot(tmp_path / "j", names, normalize=normalize)
        assert got.name == want.name
        assert native.imread(got).shape == cv2.imread(str(want)).shape == (1800, 2400, 3)
    # a dict of names: labelled by its values (JAX labels by its keys)
    assert tcm.plot_data(dict(enumerate(names)))[1] == names + ["background"]


def test_validator_writes_the_six_images(tmp_path):
    from test_torch_val import _write_set

    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    data = _write_set(tmp_path / "set")
    jm = JaxDetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15)  # seeded weights that detect something
    v = jax_variables(jm.module, jnp.zeros((1, 64, 64, 3)), train=False)
    tm = load_jax_variables(DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu"), v)
    Validator(tm, imgsz=64)(YOLODataset(data, "val", task="obb"), batch_size=4, save_dir=str(tmp_path / "out"))
    sizes = {"PR_curve.png": (1200, 1800), "F1_curve.png": (1200, 1800), "P_curve.png": (1200, 1800),
             "R_curve.png": (1200, 1800), "confusion_matrix.png": (1800, 2400),
             "confusion_matrix_normalized.png": (1800, 2400)}
    for name, hw in sizes.items():
        assert native.imread(tmp_path / "out" / name).shape[:2] == hw, name
    assert (tmp_path / "out" / "per_class.txt").exists()


def test_blues_and_curves_png(tmp_path):
    """"Blues" within one level of matplotlib's; two logged epochs draw a
    ``curves.png`` of the JAX ``plot_curves``' size."""
    _check_blues()
    _check_curves_png(tmp_path)


def _check_blues():
    ref = colormaps["Blues"](np.linspace(0, 1, 256), bytes=True)[:, :3].astype(int)
    assert np.abs(tplot.blues_table().astype(int) - ref).max() <= 1


def _check_curves_png(tmp_path):
    cfg = ttrain.ClsConfig(model="qwrn16_2", exp_dir=str(tmp_path))
    exp = ttrain.ExperimentManager(cfg, name="run")
    for e in range(2):
        exp.log_epoch(e, 2.0 / (e + 1), 0.1 * e, {"val_loss": 1.5, "top1": 0.2 * e, "top5": 0.5}, 0.1)
    got = native.imread(exp.dir / "curves.png")
    ref = jplot.plot_curves(exp.metrics, str(tmp_path / "j.png"))
    assert got.shape == cv2.imread(ref).shape == (600, 1600, 3)  # six keys: 4 + 2 panels of 400 x 300
