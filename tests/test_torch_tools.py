"""The port's host tooling against the JAX package's: the tuner
(``engine/tuner.py``), AutoBatch (``utils/autobatch.py``), the profiler's
summary and the layer table (``utils/profiler.py``, ``DetectionModel.info``),
the benchmark table (``utils/benchmarks.py``), and the facade's ``embed`` and
``track`` (``engine/model.py``).

* Tuner: the same seed and fitness function give the JAX tuner's history,
  value for value, and the same JSON files.
* ``auto_batch`` gives JAX's batch for the same device memory; ``summary``
  and ``info`` give JAX's integers and lines for the OBB and detect n specs.
* ``embed`` and ``track`` (a directory of PNG frames) at imgsz 64 on 64 x 64
  frames (the letterbox only casts) with seeded weights (``fill_variables``) in both packages:
  embeddings within 1e-4 max|ref| + 1e-5 (f32 summation order through the
  graph), tracks with the JAX facade's IDs and boxes within the decode
  tolerance 1e-4 max|ref| + 1e-5 of the port's tests. The JAX side compiles
  one Predictor (the tracker's) and, for ``embed``, the JAX model's
  ``features`` under ``jax.jit`` (its facade's ``embed`` otherwise applies the
  graph op by op: three times the seconds).
"""

import json
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu import trackers as jtrackers
from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
from quan_ultralytics_tpu.engine import tuner as jtuner
from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.trackers.byte_tracker import STrack as JaxSTrack
from quan_ultralytics_tpu.utils import autobatch as jautobatch
from quan_ultralytics_tpu.utils import benchmarks as jbenchmarks
from quan_ultralytics_tpu.utils.profiler import conv_flops as jax_conv_flops
from quan_ultralytics_tpu_torch import trackers as ttrackers
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.engine import tuner
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.trackers.byte_tracker import STrack
from quan_ultralytics_tpu_torch.utils import autobatch, benchmarks, profiler
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

IMGSZ, NC = 64, 3
SPECS = [("yolo11n-obb-quan.yaml", 15), ("yolo11n-quan.yaml", 80)]


def _tol(ref):
    return 1e-4 * (float(np.abs(ref).max()) if ref.size else 0.0) + 1e-5


# ---------------------------------------------------------------- tuner


def _fitness(hyp):
    """A deterministic fitness with its optimum inside the space."""
    return -((hyp["lr0"] - 0.02) ** 2) * 1e3 - (hyp["momentum"] - 0.9) ** 2 - abs(hyp["box"] - 5.0) * 1e-2


def test_tuner_history_equals_jax(tmp_path):
    assert tuner.SPACE == jtuner.SPACE
    base = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 5e-4, "warmup_epochs": 3.0,
            "box": 7.5, "cls": 0.5, "dfl": 1.5, "not_a_gene": 1.0, "mosaic": 0.0}
    got = tuner.Tuner(_fitness, base, save_dir=str(tmp_path / "port"), seed=3)
    ref = jtuner.Tuner(_fitness, base, save_dir=str(tmp_path / "jax"), seed=3)
    assert got(iterations=8) == ref(iterations=8)
    assert got.history == ref.history and len(got.history) == 8
    assert len({h["lr0"] for h in got.history}) > 1  # it mutated
    for name in ("tune_results.json", "best_hyperparameters.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    for seed in range(3):
        assert tuner.mutate(base, random.Random(seed)) == jtuner.mutate(base, random.Random(seed))


# ---------------------------------------------------------------- autobatch, summary, info


def _jax_model_and_shapes(name, nc):
    jm = JaxDetectionModel.from_yaml(name, nc=nc)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                                                   train=False))
    return jm, shapes


@pytest.fixture(scope="module")
def spec_models():
    return {name: (_jax_model_and_shapes(name, nc), DetectionModel.from_yaml(name, nc=nc, device="cpu"))
            for name, nc in SPECS}


@pytest.mark.parametrize("name", [n for n, _ in SPECS])
@pytest.mark.parametrize("imgsz", [640, 1024])
def test_summary_and_info_equal_jax(spec_models, name, imgsz):
    (jm, shapes), tm = spec_models[name]
    got_lines, ref_lines = [], []
    got = tm.info(imgsz=imgsz, log=got_lines.append)
    ref = jm.info(shapes, imgsz=imgsz, log=ref_lines.append)
    assert got == ref and got_lines == ref_lines
    assert got == profiler.summary(tm, imgsz) and got["params"] > 0 and got["approx_conv_gflops"] > 0
    for args in ((4, 64, 3, 320, 320), (64, 128, 1, 80, 80), (256, 256, 3, 20, 20)):
        assert profiler.conv_flops(*args) == jax_conv_flops(*args)


@pytest.mark.parametrize("name", [n for n, _ in SPECS])
@pytest.mark.parametrize("hbm_gb,params_bytes", [(16.0, None), (80.0, None), (80.0, 2.8e6 * 4), (0.5, None)])
def test_auto_batch_equals_jax(spec_models, monkeypatch, name, hbm_gb, params_bytes):
    (jm, _), tm = spec_models[name]
    monkeypatch.setattr(jautobatch, "device_hbm_bytes", lambda *a, **k: hbm_gb * (1 << 30))
    monkeypatch.setattr(autobatch, "device_hbm_bytes", lambda *a, **k: hbm_gb * (1 << 30))
    for imgsz in (640, 1024):
        assert (autobatch.estimate_activation_bytes_per_image(tm, imgsz)
                == jautobatch.estimate_activation_bytes_per_image(jm, imgsz))
        got = autobatch.auto_batch(tm, imgsz, params_bytes=params_bytes)
        assert got == jautobatch.auto_batch(jm, imgsz, params_bytes=params_bytes) and got >= 1


def test_device_hbm_bytes_takes_the_default_only_for_the_cpu(monkeypatch):
    assert autobatch.device_hbm_bytes("cpu") == 16 * (1 << 30)
    assert autobatch.device_hbm_bytes("cpu", default_gb=2.0) == 2 * (1 << 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autobatch.device_hbm_bytes()


# ---------------------------------------------------------------- benchmark and profiler


def test_benchmark_rows_on_the_cpu(capsys):
    rows = benchmarks.benchmark(models=("yolo11n-quan.yaml",), imgsz=(IMGSZ,), batch=2,
                                dtypes=("float32", "bfloat16"), iters=1, nc=NC, device="cpu")
    assert [list(r) for r in rows] == [["model", "imgsz", "dtype", "batch", "ms_per_batch", "img_per_s"]] * 2
    assert [(r["dtype"], r["imgsz"], r["batch"]) for r in rows] == [("float32", 64, 2), ("bfloat16", 64, 2)]
    assert all(r["ms_per_batch"] > 0 and r["img_per_s"] > 0 for r in rows)
    benchmarks.print_table(rows)
    got = capsys.readouterr().out
    jbenchmarks.print_table(rows)
    assert got == capsys.readouterr().out
    lines = got.splitlines()
    assert len(lines) == 3 and lines[0].split() == list(rows[0])


def test_profiler_prefixes_trace_and_time(tmp_path):
    m = DetectionModel.from_yaml("yolo11n-quan.yaml", nc=NC, device="cpu")
    x = torch.rand(1, IMGSZ, IMGSZ, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, feats = m.features(x)
        for i in (0, 5, 10, 22):
            torch.testing.assert_close(m(x, upto=i), feats[i], rtol=0, atol=0)
        full = m(x)
        last = m(x, upto=len(m.specs) - 1)
        assert all(torch.equal(a, b) for a, b in zip(full, last))
    rows = profiler.profile_layers(m, x, iters=1)
    assert [r["i"] for r in rows] == list(range(len(m.specs)))
    assert all(r["cum_ms"] > 0 for r in rows) and rows[-1]["module"] == "Detect"
    assert profiler.time_fn(lambda: m(x), iters=2, warmup=1) > 0
    with torch.no_grad(), profiler.trace(str(tmp_path / "tr")):
        m(x)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------- embed and track


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A JAX facade checkpoint of the detect model (nc 3) with seeded weights,
    read by the port's facade on the CPU."""
    tmp = tmp_path_factory.mktemp("tools")
    jy = JaxYOLO("yolo11n-quan.yaml", nc=NC)
    v = jax_variables(jy.model.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=5)
    pkl = tmp / "det.pkl"
    jy._save_ckpt(pkl, SimpleNamespace(ema_params=v["params"], batch_stats=v["batch_stats"],
                                       params=v["params"], step=jnp.int32(0)))
    return {"jax": JaxYOLO(str(pkl)), "port": YOLO(str(pkl), device="cpu")}


def _frames(n=6):
    """64 x 64 frames: a seeded noise background under two rectangles moving
    3 px right and 2 px down a frame."""
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 120, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    out = []
    for t in range(n):
        im = bg.copy()
        im[8 + 2 * t:28 + 2 * t, 6 + 3 * t:30 + 3 * t] = (250, 40, 40)
        im[36:60, 40 - 2 * t:58 - 2 * t] = (30, 220, 60)
        out.append(im)
    return out


def test_embed_matches_jax(seeded, monkeypatch):
    frames = _frames(3)
    layers = [4, 10, 22]  # 22 = len(specs) - 2, the default layer
    jm = seeded["jax"].model
    jitted = jax.jit(lambda v, x, keep: type(jm).features(jm, v, x, layers=keep), static_argnums=2)
    monkeypatch.setattr(jm, "features", lambda v, x, layers=None: jitted(v, x, tuple(layers)))
    got = seeded["port"].embed(frames, layers=layers, imgsz=IMGSZ)
    ref = seeded["jax"].embed(frames, layers=layers, imgsz=IMGSZ)
    assert got.dtype == np.float32 and got.shape == ref.shape and got.shape[0] == 3
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))
    default = seeded["port"].embed(frames, imgsz=IMGSZ)
    np.testing.assert_array_equal(default, got[:, got.shape[1] - default.shape[1]:])


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
def test_track_matches_jax(seeded, tracker, tmp_path):
    """Each facade tracks a directory of PNG frames (each package's
    ``load_source``, as its CLI reads one) with a tracker it was given
    (``persist``) whose thresholds sit below the seeded model's top scores
    (0.58-0.59; the default new-track threshold is 0.6)."""
    frames = _frames()
    for i, im in enumerate(frames):
        imwrite_png(tmp_path / f"f{i}.png", im)
    runs = []
    kw = dict(track_high_thresh=0.5, new_track_thresh=0.55)
    for facade, strack, pkg, load in ((seeded["port"], STrack, ttrackers, load_source),
                                      (seeded["jax"], JaxSTrack, jtrackers, jax_load_source)):
        strack._count = 0
        facade._tracker = pkg.BOTSORT(**kw) if tracker == "botsort" else pkg.BYTETracker(**kw)
        runs.append(facade.track(load(str(tmp_path)), imgsz=IMGSZ, conf=0.1, tracker=tracker, persist=True))
    got, ref = runs
    assert len(got) == len(ref) == len(frames) and sum(len(r) for r in ref) > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g[:, 4], r[:, 4])
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol(r))
    again = seeded["port"].track(frames[:2], imgsz=IMGSZ, conf=0.1, tracker=tracker, persist=True)
    assert seeded["port"]._tracker.frame_id == len(frames) + 2 and len(again) == 2
    with pytest.raises(ValueError, match="bytetrack or botsort"):
        seeded["port"].track(frames, tracker="sort")
