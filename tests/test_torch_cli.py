"""The port's entry points on the CPU against the JAX package's: config
(``cfg/``), the ``yolo`` CLI (``cli.py``), settings, the integrations' bus,
predict sources (``data/loaders.py``), ``Results`` and the ``YOLO`` facade
(``engine/model.py``) with its checkpoints.

yolo11n-obb-quan (nc=3) at imgsz 64 on a seeded PNG set written with the
port's writer whose images' longer side is 64, so that both packages'
letterboxes only pad: the letterboxed frames are the same (where a frame is
resized, JAX's C++ ``letterbox_native`` and the port's torch letterbox differ
by at most one gray level; `test_letterboxes_differ_by_one_level_at_most`
states by how much). Weights are drawn by ``fill_variables``.

* JAX to port: a checkpoint written by the JAX facade's own ``_save_ckpt``
  unpickles with numpy alone (no JAX, no flax); ``YOLO(pkl).predict`` of both
  packages keeps the same boxes within 1e-4 max|ref| + 1e-5, and ``val``
  metrics agree within 5e-3.
* Port to JAX: the port's CLI trains 2 epochs on the CPU and writes
  ``last.pkl``, ``best.pkl``, ``results.csv`` and ``results.json``; the JAX
  facade predicts from ``best.pkl`` what the port predicts.
* The detect task: ``detect train`` (yolo11n-quan.yaml when no ``model=``
  is given), ``detect val`` with ``rect`` and ``detect predict save_txt=True``
  on the CPU, the saved label lines held to the JAX facade's predictions.
* No JAX training runs; the JAX side only predicts and validates.
"""

import ast
import json
import math
import pickle
import shutil
import subprocess
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu import cfg as jcfg
from quan_ultralytics_tpu import cli as jcli
from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
from quan_ultralytics_tpu.data.native import letterbox_native
from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO
from quan_ultralytics_tpu.engine.predictor import Results as JaxResults
from quan_ultralytics_tpu.utils import integrations as jinteg
from quan_ultralytics_tpu_torch import cfg as tcfg
from quan_ultralytics_tpu_torch import cli as tcli
from quan_ultralytics_tpu_torch.data.augment import letterbox
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.data.native.native import imread, imwrite_png
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.engine.predictor import Results
from quan_ultralytics_tpu_torch.utils import integrations as tinteg
from quan_ultralytics_tpu_torch.utils import settings as tsettings
from quan_ultralytics_tpu_torch.utils.weights import (export_jax_variables, load_jax_variables,
                                                      read_checkpoint)
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

REPO = Path(__file__).resolve().parents[1]
CFG, NC, IMGSZ, NAMES = "yolo11n-obb-quan.yaml", 3, 64, ["plane", "ship", "storage-tank"]
SIZES = [(64, 64), (48, 64), (64, 40), (64, 64), (56, 64), (64, 48)]
CONF = 0.001


def _tol(ref):
    """The decode tolerance of the port's tests: 1e-4 max|ref| + 1e-5."""
    return 1e-4 * (float(np.abs(ref).max()) if ref.size else 0.0) + 1e-5


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("name", ["default.yaml", "recipes/dota_obb.yaml", "recipes/coco_detect.yaml"])
def test_config_files_are_the_jax_files(name):
    port = REPO / "quan_ultralytics_tpu_torch" / "cfg" / name
    assert port.read_bytes() == (REPO / "quan_ultralytics_tpu" / "cfg" / name).read_bytes()
    if name == "default.yaml":
        assert tcfg.CFG_PATH == port
        got, ref = tcfg.load_default(), jcfg.load_default()
        assert got == ref and [type(v) for v in got.values()] == [type(v) for v in ref.values()]


def _outcome(fn, pkg):
    """fn's result, or its exception's type and message with the package's
    config path replaced by a marker."""
    try:
        return fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e.args[0]).replace(str(pkg.CFG_PATH), "<CFG_PATH>")


RECIPE = REPO / "quan_ultralytics_tpu" / "cfg" / "recipes" / "dota_obb.yaml"
GET_CFG_CASES = [
    ({}, None), ({"epochs": "3", "mosaic": 0.5, "save": "false", "cache": True}, None),
    ({"imgsz": 512}, RECIPE), ({"lr0": 0.02}, {"epochs": 7, "batch": 4}),
    ({"nope": 1}, None), ({"mosaic": 1.5}, None), ({"auto_augment": "bad"}, None),
    ({"cache": "gpu"}, None), ({"copy_paste_mode": "mixup", "cache": "disk"}, None),
]


@pytest.mark.parametrize("overrides,user_cfg", GET_CFG_CASES)
def test_get_cfg_matches_jax(overrides, user_cfg):
    got = _outcome(lambda: vars(tcfg.get_cfg(dict(overrides), cfg=user_cfg)), tcfg)
    ref = _outcome(lambda: vars(jcfg.get_cfg(dict(overrides), cfg=user_cfg)), jcfg)
    assert got == ref
    if isinstance(ref, dict):
        assert [type(v) for v in got.values()] == [type(v) for v in ref.values()]


@pytest.mark.parametrize("overrides", [
    {"epochs": "5", "save_dir": "x", "max_labels": 64, "device": "cpu"}, {"hsv_h": 2},
    {"unknown_key": 1}, {"save_txt": "yes", "cache": False, "conf": 0}, {"nc": 3, "batch": 2.0},
])
def test_validate_overrides_matches_jax(overrides):
    assert (_outcome(lambda: tcfg.validate_overrides(dict(overrides)), tcfg)
            == _outcome(lambda: jcfg.validate_overrides(dict(overrides)), jcfg))


# ---------------------------------------------------------------- CLI surface


@pytest.mark.parametrize("argv", [["a=1", "b=0.5", "c=x.yaml", "d=True", "e=[1, 2]", "f=a=b"],
                                  ["noequals"], []])
def test_parse_kv_matches_jax(argv):
    def run(mod):
        try:
            return mod.parse_kv(argv)
        except SystemExit as e:
            return "exit", e.code
    assert run(tcli) == run(jcli)


@pytest.mark.parametrize("argv", [[], ["obb"], ["obb", "fly"], ["obb", "train"], ["obb", "val"],
                                  ["obb", "predict"], ["obb", "train", "data=x.yaml", "epochs=-"],
                                  ["obb", "val", "data=x.yaml", "bogus=1"],
                                  ["obb", "predict", "source=x.png", "conf=3"]])
def test_usage_errors_match_jax(argv, capsys):
    codes = []
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            mod.main(list(argv))
        codes.append(str(e.value.code).replace(str(tcfg.CFG_PATH), "<CFG_PATH>")
                     .replace(str(jcfg.CFG_PATH), "<CFG_PATH>"))
    assert codes[0] == codes[1] and codes[0] not in ("0", "None")


@pytest.mark.parametrize("argv", [["obb", "export", "model=yolo11n-obb-quan.yaml", "format=params"],
                                  ["detect", "track", "source=x.mp4", "model=m.pkl"], ["tune", "data=x.yaml"],
                                  ["benchmark", "imgsz=64", "device=cpu", "batch=2", "iters=1"],
                                  ["classify", "export", "model=qwrn16_2"]])
def test_modes_not_ported_exit_nonzero(argv, tmp_path, monkeypatch, capsys):
    """The four modes that were not ported route now (the name is kept): ``obb
    export`` writes its file, ``tune`` reaches ``YOLO.tune`` with its keys (as
    the JAX package's ``test_tune_mode_dispatch``), ``benchmark`` prints the
    table; ``track`` of a video source goes through ``load_source`` as the
    JAX CLI's does (a missing clip gives no frames, so both print nothing and
    exit 0; the model a ``.pkl`` the port writes, which the JAX facade reads
    without compiling its init op by op); ``classify export`` still exits
    non-zero, naming, as the JAX CLI does, classify's one mode."""
    monkeypatch.chdir(tmp_path)
    mode = "classify" if argv[0] == "classify" else argv[1] if argv[0] in tcli.TASKS else argv[0]
    if mode == "export":
        assert tcli.main(argv + ["path=m.pkl", "device=cpu"]) == 0
        assert read_checkpoint(tmp_path / "m.pkl")["model_yaml"] == "yolo11n-obb-quan.yaml"
        assert "exported: m.pkl" in capsys.readouterr().out
    elif mode == "tune":
        calls = {}

        def fake_tune(self, data, **kw):
            calls.update(data=data, **kw)
            return {"lr0": 0.01}

        monkeypatch.setattr(YOLO, "tune", fake_tune)
        assert tcli.main(argv + ["iterations=2", "epochs=1", "device=cpu"]) == 0
        assert calls == {"data": "x.yaml", "iterations": 2, "epochs": 1}
        assert "{'lr0': 0.01}" in capsys.readouterr().out
    elif mode == "benchmark":
        assert tcli.main(argv) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].split() == ["model", "imgsz", "dtype", "batch", "ms_per_batch", "img_per_s"]
        assert lines[1].split()[:4] == ["yolo11n-obb-quan.yaml", "64", "bfloat16", "2"]
    elif mode == "track":
        YOLO("yolo11n-quan.yaml", device="cpu").export(format="params", path="m.pkl")
        assert tcli.main(argv + ["device=cpu"]) == 0
        got = capsys.readouterr().out
        assert jcli.main(list(argv)) == 0
        assert got == capsys.readouterr().out == ""
    else:
        for mod in (tcli, jcli):
            with pytest.raises(SystemExit, match="classify supports mode=train"):
                mod.main(list(argv))


def test_track_mode(tmp_path, capsys):
    """``detect track source=<dir>`` prints a line a frame (the JAX package's
    ``test_track_mode``, its frames written as PNG)."""
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        im = np.full((64, 64, 3), 30, np.uint8)
        im[10:35, 10 + 4 * i:35 + 4 * i] = (255, 0, 0)
        imwrite_png(src / f"f{i}.png", im)
    for tracker in ("bytetrack", "botsort.yaml"):
        assert tcli.main(["detect", "track", "model=yolo11n-quan.yaml", f"source={src}", "imgsz=64",
                          "conf=0.001", f"tracker={tracker}", "device=cpu"]) == 0
        out = capsys.readouterr().out
        assert "frame 0:" in out and "frame 2:" in out and "frame 3:" not in out


def test_no_silent_cpu_run(monkeypatch, tmp_path):
    """Without a card and without device=cpu, the CLI and YOLO refuse to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["obb", "predict", f"source={tmp_path}"], ["obb", "val", "data=x.yaml"],
                 ["obb", "train", "data=x.yaml", "device=cuda"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert "no CUDA device" in str(e.value.code)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO(CFG)
    assert YOLO(CFG, device="cpu").model.strides[0] == 8


def test_module_runs_as_a_program_and_exits_nonzero_on_errors():
    r = subprocess.run([sys.executable, "-m", "quan_ultralytics_tpu_torch.cli", "obb", "fly"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "usage: yolo" in r.stderr


def test_settings_mode(tmp_path, monkeypatch, capsys):
    file = tmp_path / "cfg" / "settings.json"
    monkeypatch.setenv("QUAN_TORCH_SETTINGS", str(file))
    monkeypatch.setattr(tsettings, "SETTINGS", tsettings.SettingsManager())
    assert tsettings.SETTINGS.file == file
    assert tcli.main(["settings"]) == 0
    assert json.loads(capsys.readouterr().out) == tsettings._DEFAULTS
    assert not file.exists()  # reading writes nothing
    assert tcli.main(["settings", "tensorboard=False", "wandb=False"]) == 0
    on_disk = json.loads(file.read_text())
    assert on_disk["tensorboard"] is False and on_disk["wandb"] is False
    assert tsettings.SettingsManager()["tensorboard"] is False  # a new process reads it back
    for bad in (["settings", "nope=1"], ["settings", "wandb=1"]):
        with pytest.raises(SystemExit, match="settings error"):
            tcli.main(bad)
    assert tcli.main(["settings", "reset"]) == 0
    assert json.loads(file.read_text()) == tsettings._DEFAULTS
    file.write_text(json.dumps({**tsettings._DEFAULTS, "settings_version": "0.1", "mlflow": False}))
    assert tsettings.SettingsManager()["mlflow"] is True  # another version is not loaded


def test_settings_files_of_the_two_packages_differ(monkeypatch):
    from quan_ultralytics_tpu.utils import settings as jsettings

    monkeypatch.delenv("QUAN_TORCH_SETTINGS", raising=False)
    monkeypatch.delenv("QUAN_TPU_SETTINGS", raising=False)
    assert tsettings._path() != jsettings._path()
    assert tsettings._path().parent.name == "quan_ultralytics_tpu_torch"


# ---------------------------------------------------------------- integrations, both packages


def _build(pkg, tmp_path):
    return pkg.build_callbacks(str(tmp_path), args={"project": "p", "name": "n", "epochs": 2})


@pytest.fixture(params=["jax", "port"])
def integ(request, monkeypatch):
    """Each package's build_callbacks with every integration's setting on and
    TensorBoard off (the JAX package's settings dict, the port's own)."""
    from quan_ultralytics_tpu.utils.settings import SETTINGS as jax_settings

    for s in (jax_settings, tsettings.SETTINGS):
        for k in ("wandb", "mlflow", "comet"):
            monkeypatch.setitem(s, k, True)
        monkeypatch.setitem(s, "tensorboard", False)
    return {"jax": jinteg, "port": tinteg}[request.param]


def test_bus_without_any_integration(integ, tmp_path):
    cb = _build(integ, tmp_path)
    cb.run("on_fit_epoch_end", {"epoch": 0, "loss": 1.5, "fitness": -1.5})
    cb.run("on_train_end", None)
    csv = (tmp_path / "results.csv").read_text()
    assert "loss" in csv and "1.5" in csv


def test_mlflow_adapter_records_lifecycle(integ, tmp_path, monkeypatch):
    calls = []
    fake = types.ModuleType("mlflow")
    fake.__version__ = "0.0-fake"
    fake.set_tracking_uri = lambda uri: calls.append(("uri", uri))
    fake.set_experiment = lambda name: calls.append(("exp", name))
    fake.active_run = lambda: None
    fake.start_run = lambda run_name=None: calls.append(("start", run_name))
    fake.log_params = lambda p: calls.append(("params", dict(p)))
    fake.log_metrics = lambda m, step=None: calls.append(("metrics", dict(m), step))
    fake.log_artifact = lambda p: calls.append(("artifact", p))
    fake.end_run = lambda: calls.append(("end",))
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    cb = _build(integ, tmp_path)
    assert ("start", "n") in calls and ("exp", "p") in calls
    cb.run("on_fit_epoch_end", {"epoch": 1, "loss": 2.0, "mAP(50)": 0.3})
    assert ("metrics", {"epoch": 1.0, "loss": 2.0, "mAP50": 0.3}, 1) in calls
    best = tmp_path / "best.ckpt"
    best.write_bytes(b"x")
    cb.run("on_train_end", best)
    assert ("artifact", str(best)) in calls and calls[-1] == ("end",)


def test_wandb_adapter_is_gated_by_its_setting(integ, tmp_path, monkeypatch):
    calls = []
    fake = types.ModuleType("wandb")
    fake.__version__ = "0.0-fake"
    fake.run = None
    fake.init = lambda **kw: calls.append(("init", kw["project"], kw["name"]))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    _build(integ, tmp_path)
    assert calls == [("init", "p", "n")]
    settings = (tsettings.SETTINGS if integ is tinteg
                else __import__("quan_ultralytics_tpu.utils.settings", fromlist=["SETTINGS"]).SETTINGS)
    monkeypatch.setitem(settings, "wandb", False)
    calls.clear()
    _build(integ, tmp_path)
    assert calls == []


def test_a_broken_integration_does_not_break_the_bus(integ, tmp_path, monkeypatch):
    fake = types.ModuleType("comet_ml")
    fake.__version__ = "0.0-fake"

    class Experiment:
        def __init__(self, **kw):
            pass

        def log_parameters(self, a):
            pass

        def log_metrics(self, m, step=None):
            raise ConnectionError("no network")

        def end(self):
            pass

    fake.Experiment = Experiment
    monkeypatch.setitem(sys.modules, "comet_ml", fake)
    cb = _build(integ, tmp_path)
    if integ is tinteg:
        cb.run("on_fit_epoch_end", {"epoch": 0, "loss": 1.0})  # warns, goes on
    else:
        with pytest.warns(UserWarning, match="no network"):
            cb.run("on_fit_epoch_end", {"epoch": 0, "loss": 1.0})
    assert "1.0" in (tmp_path / "results.csv").read_text()


def test_tensorboard_where_it_imports(tmp_path, monkeypatch):
    monkeypatch.setitem(tsettings.SETTINGS, "tensorboard", True)
    pytest.importorskip("torch.utils.tensorboard", reason="tensorboard is not installed")
    cb = _build(tinteg, tmp_path)
    cb.run("on_fit_epoch_end", {"epoch": 0, "loss": 1.0})
    cb.run("on_train_end", None)
    assert list(tmp_path.glob("events.out.tfevents.*"))


# ---------------------------------------------------------------- sources and Results


def test_load_source_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "src"
    d.mkdir()
    for i, (h, w) in enumerate(SIZES[:3]):
        imwrite_png(d / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    shutil.copy(REPO / "tests" / "fixtures" / "jpeg_420_q90_rst.jpg", d / "im9.jpg")
    (d / "notes.txt").write_text("not an image")
    arr = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    for src in (d, d / "im1.png", str(d / "im9.jpg"), [d / "im0.png", arr]):
        got, ref = list(load_source(src)), list(jax_load_source(src))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.dtype == np.uint8 and np.array_equal(g, r)
    assert [im.shape for im in load_source(d)] == [(64, 64, 3), (48, 64, 3), (64, 40, 3),
                                                   imread(d / "im9.jpg").shape]
    broken = tmp_path / "broken.png"
    broken.write_bytes((d / "im0.png").read_bytes()[:60])
    for fn in (load_source, jax_load_source):
        for bad in (broken, tmp_path / "missing.png", tmp_path / "missing"):
            with pytest.raises(FileNotFoundError):
                list(fn(bad))
    # a missing video: cv2.VideoCapture opens nothing, so neither package yields a frame
    assert list(load_source(tmp_path / "clip.mp4")) == list(jax_load_source(str(tmp_path / "clip.mp4"))) == []


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 1), (2, 0)])
def test_results_output_matches_jax(tmp_path, seed, n):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(5, 95, (n, 2)), rng.uniform(4, 40, (n, 2)),
                            rng.uniform(-0.7, 0.7, (n, 1)), rng.uniform(0.2, 1, (n, 1)),
                            rng.integers(0, 3, (n, 1))], 1).astype(np.float32)
    im = np.zeros((80, 100, 3), np.uint8)
    got = Results((80, 100), boxes, names=NAMES, task="obb", orig_img=im)
    ref = JaxResults((80, 100), boxes, names=NAMES, task="obb", orig_img=im)
    assert got.verbose() == ref.verbose()
    assert got.xyxy is None and ref.xyxy is None and np.array_equal(got.xywhr, ref.xywhr)
    g, r = json.loads(got.tojson()), json.loads(ref.tojson())
    assert [{k: v for k, v in a.items() if k != "box"} for a in g] == \
           [{k: v for k, v in a.items() if k != "box"} for a in r]
    for a, b in zip(g, r):  # corners: float32 from torch vs jnp, 5 decimals
        assert a["box"].keys() == b["box"].keys()
        assert all(abs(a["box"][k] - b["box"][k]) <= 2e-5 * max(1.0, abs(b["box"][k])) for k in b["box"])
    for save_conf in (False, True):
        got.save_txt(tmp_path / f"port{save_conf}.txt", save_conf=save_conf)
        ref.save_txt(tmp_path / f"jax{save_conf}.txt", save_conf=save_conf)
        gl = (tmp_path / f"port{save_conf}.txt").read_text().splitlines()
        rl = (tmp_path / f"jax{save_conf}.txt").read_text().splitlines()
        assert len(gl) == len(rl) == n
        for a, b in zip(gl, rl):
            a, b = a.split(), b.split()
            assert a[0] == b[0] and len(a) == len(b) == 9 + save_conf
            np.testing.assert_allclose([float(v) for v in a[1:]], [float(v) for v in b[1:]],
                                       rtol=1e-5, atol=1e-6)
    out = got.plot()  # ported: tests/test_torch_plotting.py holds it to the JAX one outside the glyphs
    assert out.shape == im.shape and out.dtype == np.uint8
    if n == 0:
        np.testing.assert_array_equal(out, ref.plot())


# ---------------------------------------------------------------- facade and checkpoints


def _write_set(root, seed=0, labels=None):
    """Seeded PNGs (longer side 64) in train and val, labelled with 1-4 random
    rotated boxes each and, given ``labels`` (per image, rows of 8 normalized
    corners and a class), with those too. Returns the data yaml."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i, (h, w) in enumerate(SIZES):
            imwrite_png(root / "images" / split / f"im{i}.png",
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                cx, cy, t = *rng.uniform(0.3, 0.7, 2), rng.uniform(-1, 1)
                bw, bh = rng.uniform(0.1, 0.4, 2)
                c, s = math.cos(t), math.sin(t)
                pts = [(cx + dx * c - dy * s, cy + dx * s + dy * c)
                       for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2), (bw / 2, bh / 2), (-bw / 2, bh / 2))]
                rows.append(" ".join([str(int(rng.integers(0, NC)))] + [f"{v:.6f}" for p in pts for v in p]))
            rows += (labels or {}).get(i, [])
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                         + "".join(f"  {i}: {n}\n" for i, n in enumerate(NAMES)))
    return yaml_path


def _assert_same_boxes(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.orig_shape == r.orig_shape and len(g) == len(r)
        np.testing.assert_array_equal(g.cls, r.cls)
        np.testing.assert_allclose(g.boxes, r.boxes, rtol=0, atol=_tol(r.boxes))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX facade's own ``_save_ckpt`` from seeded
    variables, and a data set labelled with the model's top detections (so that
    validation scores matches and misses)."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    jy = JaxYOLO(CFG, nc=NC)
    v = jax_variables(jy.model.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=3)
    jy.names = NAMES
    pkl = tmp / "jax.pkl"
    jy._save_ckpt(pkl, SimpleNamespace(ema_params=v["params"], batch_stats=v["batch_stats"],
                                       params=v["params"], step=jnp.int32(7)))
    data = _write_set(tmp / "data")
    port = YOLO(str(pkl), device="cpu")
    own = {}
    for i, r in enumerate(port.predict(tmp / "data" / "images" / "val", imgsz=IMGSZ, conf=CONF)):
        h, w = r.orig_shape
        corners = r._corners()[:3] / np.array([w, h])
        own[i] = [" ".join([str(int(c))] + [f"{x:.6f}" for x in pts.reshape(-1)])
                  for c, pts in zip(r.cls[:3], corners)]
    data = _write_set(tmp / "data", labels=own)
    return {"pkl": pkl, "data": data, "variables": v, "dir": tmp}


def test_a_jax_checkpoint_unpickles_without_jax(jax_ckpt):
    code = ("import sys, pickle; sys.modules.update(jax=None, flax=None, jaxlib=None, optax=None); "
            f"p = pickle.loads(open({str(jax_ckpt['pkl'])!r}, 'rb').read()); "
            "assert p['step'] == 7 and p['names'][0] == 'plane'; "
            "assert not [m for m, v in sys.modules.items() if v is not None and m.startswith(('jax', 'flax'))]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    payload = read_checkpoint(jax_ckpt["pkl"])
    assert set(payload) == {"model_yaml", "nc", "names", "params", "batch_stats", "raw_params", "step"}
    evil = jax_ckpt["dir"] / "evil.pkl"
    evil.write_bytes(pickle.dumps({"x": SimpleNamespace()}))
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        read_checkpoint(evil)


def test_export_jax_variables_inverts_load(jax_ckpt):
    v = jax_ckpt["variables"]
    port = YOLO(str(jax_ckpt["pkl"]), device="cpu")
    out = export_jax_variables(port.model)

    def flat(tree, prefix=()):
        for k, x in tree.items():
            yield from flat(x, prefix + (k,)) if isinstance(x, dict) else [(prefix + (k,), x)]

    for col in ("params", "batch_stats"):
        got, ref = dict(flat(out[col])), dict(flat(v[col]))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(ref[k])), k
    again = YOLO(CFG, nc=NC, device="cpu").model
    load_jax_variables(again, out)
    for (n, a), b in zip(port.model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n


def test_jax_checkpoint_predicts_alike_in_both_packages(jax_ckpt):
    src = jax_ckpt["data"].parent / "images" / "val"
    port = YOLO(str(jax_ckpt["pkl"]), device="cpu")
    assert port.names == NAMES and port.task == "obb"
    got = port.predict(src, imgsz=IMGSZ, conf=CONF)
    ref = JaxYOLO(str(jax_ckpt["pkl"])).predict(str(src), imgsz=IMGSZ, conf=CONF)
    assert sum(len(r) for r in ref) > 0
    _assert_same_boxes(got, ref)
    assert [g.verbose() for g in got] == [r.verbose() for r in ref]
    assert port(src, imgsz=IMGSZ, conf=CONF)[0].boxes.shape == got[0].boxes.shape


def test_letterboxes_differ_by_one_level_at_most():
    """JAX's C++ letterbox (float, /255) against the port's torch letterbox
    (uint8) where a frame is resized: the same gain and padding, values at
    most one gray level apart."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for h, w in ((96, 72), (80, 100), (130, 64), (200, 150)):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref, r_ref, pad_ref = letterbox_native(im, IMGSZ)
        got, r, pad = letterbox(torch.from_numpy(im), IMGSZ)
        assert pad == pad_ref and r == pytest.approx(r_ref, rel=1e-6)
        worst = max(worst, float(np.abs(ref * 255 - got.numpy()).max()))
    assert worst <= 1.0 + 1e-3, worst


def test_jax_checkpoint_validates_alike_in_both_packages(jax_ckpt, capsys):
    data = str(jax_ckpt["data"])
    port = YOLO(str(jax_ckpt["pkl"]), device="cpu")
    got = port.val(data, imgsz=IMGSZ, batch=4)
    out = capsys.readouterr().out
    jy = JaxYOLO(str(jax_ckpt["pkl"]))
    ref = jy.val(data, imgsz=IMGSZ, batch=4)
    assert ref["mAP50"] > 0 and set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 5e-3, (k, got[k], ref[k])
    assert "mAP50-95" in out and "pred\\gt" in out  # the per-class table and the confusion matrix
    np.testing.assert_array_equal(port.confusion.matrix, jy.confusion.matrix)


def test_port_cli_trains_and_jax_reads_its_checkpoint(jax_ckpt, tmp_path, monkeypatch, capsys):
    for k, v in tsettings.SETTINGS.items():  # no logger client is reached, whatever is installed
        if v is True:
            monkeypatch.setitem(tsettings.SETTINGS, k, False)
    run, data = tmp_path / "run", str(jax_ckpt["data"])
    assert tcli.main(["obb", "train", "model=yolo11n-obb-quan.yaml", f"data={data}", "epochs=2",
                      "batch=2", "imgsz=64", "close_mosaic=1", "device=cpu", f"save_dir={run}"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "epoch 1:" in out
    for name in ("last.pkl", "best.pkl", "results.csv", "results.json", "last.ckpt", "best.ckpt"):
        assert (run / name).exists(), name
    rows = json.loads((run / "results.json").read_text())
    assert [r["epoch"] for r in rows] == [0, 1] and all(math.isfinite(r["loss"]) for r in rows)
    payload = read_checkpoint(run / "best.pkl")
    assert payload["nc"] == NC and payload["names"] == NAMES and payload["step"] in (3, 6)
    assert read_checkpoint(run / "last.pkl")["step"] == 6  # 3 micro-steps an epoch
    src = jax_ckpt["data"].parent / "images" / "val"
    got = YOLO(str(run / "best.pkl"), device="cpu").predict(src, imgsz=IMGSZ, conf=CONF)
    ref = JaxYOLO(str(run / "best.pkl")).predict(str(src), imgsz=IMGSZ, conf=CONF)
    _assert_same_boxes(got, ref)
    # val and predict through the CLI, with the per-image line and save_txt
    assert tcli.main(["obb", "val", f"model={run / 'best.pkl'}", f"data={data}", "imgsz=64", "batch=4",
                      "device=cpu"]) == 0
    assert "mAP50" in capsys.readouterr().out
    pred = tmp_path / "pred"
    assert tcli.main(["obb", "predict", f"model={run / 'best.pkl'}", f"source={src}", "imgsz=64",
                      f"conf={CONF}", "save_txt=True", "save_conf=True", f"save_dir={pred}",
                      "device=cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("image ")]
    assert lines == [f"image {i + 1}/{len(got)} {r.orig_shape[1]}x{r.orig_shape[0]} {r.verbose()}"
                     for i, r in enumerate(got)]
    for i, r in enumerate(got):
        txt = (pred / "labels" / f"im{i}.txt")
        assert len(txt.read_text().splitlines()) == len(r)


# ---------------------------------------------------------------- the detect task


def _write_detect_set(root, seed=0):
    """Seeded PNGs (longer side 64) in train and val, each labelled with 1-4
    random axis-aligned boxes ('cls xc yc w h', normalized). Returns the data yaml."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i, (h, w) in enumerate(SIZES):
            imwrite_png(root / "images" / split / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            rows = [" ".join([str(int(rng.integers(0, NC)))] + [f"{v:.6f}" for v in (
                *rng.uniform(0.3, 0.7, 2), *rng.uniform(0.1, 0.5, 2))]) for _ in range(int(rng.integers(1, 5)))]
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                         + "".join(f"  {i}: {n}\n" for i, n in enumerate(("person", "car", "dog"))))
    return yaml_path


def test_port_cli_runs_the_detect_task(tmp_path, monkeypatch, capsys):
    """``detect train`` without ``model=`` builds yolo11n-quan.yaml and trains 2
    epochs on the CPU; ``detect val`` and ``detect predict save_txt=True`` of its
    best.pkl run, and the saved 'cls xc yc w h conf' lines hold the JAX
    facade's predictions from the same best.pkl: classes equal, the numbers
    within 1e-5 of max(1, |value|) (%.6g) plus the decode tolerance of a box
    over the frame's side."""
    for k, v in tsettings.SETTINGS.items():  # no logger client is reached, whatever is installed
        if v is True:
            monkeypatch.setitem(tsettings.SETTINGS, k, False)
    data = _write_detect_set(tmp_path / "data")
    run = tmp_path / "run"
    assert tcli.main(["detect", "train", f"data={data}", "epochs=2", "batch=2", "imgsz=64",
                      "close_mosaic=1", "device=cpu", f"save_dir={run}"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "epoch 1:" in out
    payload = read_checkpoint(run / "best.pkl")
    assert payload["model_yaml"] == tcli.DEFAULT_MODELS["detect"] == "yolo11n-quan.yaml"
    assert payload["nc"] == NC and payload["names"] == ["person", "car", "dog"]
    rows = json.loads((run / "results.json").read_text())
    assert [r["epoch"] for r in rows] == [0, 1] and all(math.isfinite(r["loss"]) for r in rows)
    best = run / "best.pkl"
    assert tcli.main(["detect", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=4",
                      "device=cpu", "rect=True"]) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"mAP50", "mAP50-95", "precision", "recall"}
    src, pred = tmp_path / "data" / "images" / "val", tmp_path / "pred"
    assert tcli.main(["detect", "predict", f"model={best}", f"source={src}", "imgsz=64", f"conf={CONF}",
                      "save_txt=True", "save_conf=True", f"save_dir={pred}", "device=cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("image ")]
    ref = JaxYOLO(str(best)).predict(str(src), imgsz=IMGSZ, conf=CONF)
    assert len(lines) == len(ref) == len(SIZES) and sum(len(r.boxes) for r in ref) > 0
    for i, r in enumerate(ref):
        saved = np.array((pred / "labels" / f"im{i}.txt").read_text().split(), np.float64).reshape(-1, 6)
        h, w = r.orig_shape
        x1, y1, x2, y2, conf, c = r.boxes.astype(np.float64).T
        want = np.stack([(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h, conf], 1)
        assert len(saved) == len(want)
        np.testing.assert_array_equal(saved[:, 0], c)
        tol = 1e-5 * np.maximum(1.0, np.abs(want)) + _tol(r.boxes[:, :4]) / min(h, w)
        assert (np.abs(saved[:, 1:] - want) <= tol).all(), i


# ---------------------------------------------------------------- the segment and pose tasks


def _write_segpose_set(root, task, seed=0):
    """Seeded PNGs (longer side 64) in train and val: segment images labelled
    with 1-4 polygons of 5-12 points, pose images with 1-3 figures of 17
    keypoints (x, y, visibility). Returns the data yaml."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i, (h, w) in enumerate(SIZES):
            imwrite_png(root / "images" / split / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            rows = []
            for _ in range(int(rng.integers(1, 5 if task == "segment" else 4))):
                ctr, wh = rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.5, 2)
                if task == "segment":
                    t = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(5, 13))))
                    vals = (ctr + np.stack([np.cos(t), np.sin(t)], 1) * wh / 2).reshape(-1)
                    c = int(rng.integers(0, NC))
                else:
                    k = ctr + rng.uniform(-0.5, 0.5, (17, 2)) * wh
                    vals = [*ctr, *wh, *np.concatenate([k, rng.integers(0, 3, (17, 1))], 1).reshape(-1)]
                    c = 0
                rows.append(" ".join([str(c)] + [f"{v:.6f}" for v in vals]))
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    names = ("person", "car", "dog") if task == "segment" else ("person",)
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                         + "".join(f"  {i}: {n}\n" for i, n in enumerate(names)))
    return yaml_path


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_port_cli_runs_the_segment_and_pose_tasks(task, tmp_path, monkeypatch, capsys):
    """``segment|pose train`` without ``model=`` builds the task's default model
    (yolo11n-seg-quan.yaml, yolo11n-pose-quan.yaml) and trains 2 epochs on the
    CPU; ``val`` reports the box and the mask (M) or OKS (P) metrics; ``predict
    save_txt=True`` of its best.pkl saves the lines of the JAX facade's
    predictions from the same best.pkl: classes equal, the numbers (pose: the
    keypoints' x, y and visibility too) within 1e-5 of max(1, |value|) (%.6g)
    plus the decode tolerance over the frame's side."""
    for k, v in tsettings.SETTINGS.items():  # no logger client is reached, whatever is installed
        if v is True:
            monkeypatch.setitem(tsettings.SETTINGS, k, False)
    data = _write_segpose_set(tmp_path / "data", task)
    run = tmp_path / "run"
    assert tcli.main([task, "train", f"data={data}", "epochs=2", "batch=2", "imgsz=64",
                      "close_mosaic=1", "device=cpu", f"save_dir={run}"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "epoch 1:" in out
    payload = read_checkpoint(run / "best.pkl")
    assert payload["model_yaml"] == tcli.DEFAULT_MODELS[task] == {"segment": "yolo11n-seg-quan.yaml",
                                                                  "pose": "yolo11n-pose-quan.yaml"}[task]
    best = run / "best.pkl"
    assert tcli.main([task, "val", f"model={best}", f"data={data}", "imgsz=64", "batch=4", "device=cpu"]) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    sfx = "(M)" if task == "segment" else "(P)"
    assert set(metrics) == {"mAP50", "mAP50-95", "precision", "recall", f"mAP50{sfx}", f"mAP50-95{sfx}"}
    src, pred = tmp_path / "data" / "images" / "val", tmp_path / "pred"
    assert tcli.main([task, "predict", f"model={best}", f"source={src}", "imgsz=64", f"conf={CONF}",
                      "save_txt=True", "save_conf=True", f"save_dir={pred}", "device=cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("image ")]
    ref = JaxYOLO(str(best)).predict(str(src), imgsz=IMGSZ, conf=CONF)
    assert len(lines) == len(ref) == len(SIZES) and sum(len(r.boxes) for r in ref) > 0
    for i, r in enumerate(ref):
        saved = np.array((pred / "labels" / f"im{i}.txt").read_text().split(), np.float64)
        h, w = r.orig_shape
        x1, y1, x2, y2, conf, c = r.boxes.astype(np.float64).T
        cols = [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h]
        if task == "pose":
            k = r.keypoints.astype(np.float64) / [w, h, 1.0]
            cols += list(k.reshape(len(k), -1).T)
        want = np.stack(cols + [conf], 1)
        saved = saved.reshape(len(want), -1)
        np.testing.assert_array_equal(saved[:, 0], c)
        tol = 1e-5 * np.maximum(1.0, np.abs(want)) + _tol(r.boxes[:, :4]) / min(h, w)
        assert (np.abs(saved[:, 1:] - want) <= tol).all(), i
