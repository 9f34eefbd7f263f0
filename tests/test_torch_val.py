"""The slice as a whole on the CPU: the port's OBB Validator and the epoch loop
(`Trainer.fit`) against the JAX package.

* Validator: yolo11n-obb-quan (nc=15, the DOTA classes), f32, imgsz 64,
  batch 4, conf 0.001, with the JAX variables carried by
  ``load_jax_variables``, on a seeded PNG set written with OpenCV whose
  images' longer side is 64 (so both loaders give the same pixels) and whose
  stems use the DOTA patch naming. The labels are the random model's own
  top detections (some with another class) and random boxes, so that both
  matches and misses are scored. Per image, the same number of kept
  detections and every kept row (xywhr, conf, cls) within 1e-4 of
  max(1, |value|); then the metrics within 1e-3 absolute, the confusion
  matrix equal, and ``save_json`` and the Task1 files equal after parsing
  (numbers within 1e-3). The JAX Validator compiles once, in one
  module-scoped fixture.
* ``Trainer.fit`` bookkeeping against the JAX ``Trainer.fit`` given the same
  stub step and ``validate_fn``: history, log lines, ``results.json``, which
  epochs ``last.ckpt`` and ``best.ckpt`` hold, early stopping and the
  callback events. No JAX train step is compiled.
* One real CPU ``fit`` of the port, 2 epochs at imgsz 64 through the loader
  and the Validator on the EMA weights, then a restored trainer's third epoch.
"""

import json
import math
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
from quan_ultralytics_tpu.engine import trainer as jt
from quan_ultralytics_tpu.engine.validator import Validator as JaxValidator
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.utils.callbacks import Callbacks as JaxCallbacks
from quan_ultralytics_tpu_torch.cfg.datasets import DOTA_V1
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.engine import trainer as tt
from quan_ultralytics_tpu_torch.engine.validator import Validator
from quan_ultralytics_tpu_torch.models import conv as tconv
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.ops.boxes import scale_rboxes
from quan_ultralytics_tpu_torch.utils.callbacks import EVENTS, Callbacks, CSVLogger
from quan_ultralytics_tpu_torch.utils.checkpoint import latest
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ, BATCH = "yolo11n-obb-quan.yaml", 15, 64, 4
STEMS = ["P0001__0_0", "P0001__824_0", "P0002__0_0", "P0003", "P0004__0_824", "P0005__0_0"]
SIZES = [(64, 64), (48, 64), (64, 40), (64, 64), (57, 64), (64, 64)]


def _corners(cx, cy, bw, bh, t):
    c, s = math.cos(t), math.sin(t)
    return [(cx + dx * c - dy * s, cy + dx * s + dy * c)
            for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2), (bw / 2, bh / 2), (-bw / 2, bh / 2))]


def _write_set(root, seed=0, detections=None):
    """Seeded images (smooth noise) written with OpenCV as PNG, each labelled
    with 2-9 random rotated boxes over the 15 classes, and, given
    ``detections`` (per image, rows of xywhr in source pixels and a class),
    with those boxes too."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for k, (stem, (h, w)) in enumerate(zip(STEMS, SIZES)):
            im = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
            cv2.imwrite(str(root / "images" / split / f"{stem}.png"), im)
            rows = [(int(rng.integers(0, NC)), _corners(*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.08, 0.4, 2),
                                                          rng.uniform(-3, 3)))
                    for _ in range(int(rng.integers(2, 10)))]
            for x, y, bw, bh, t, c in (detections[k] if detections else []):
                rows.append((int(c), [(px / w, py / h) for px, py in _corners(x, y, bw, bh, t)]))
            lines = [" ".join([str(c)] + [f"{v:.6f}" for p in pts for v in p]) for c, pts in rows]
            (root / "labels" / split / f"{stem}.txt").write_text("\n".join(lines) + "\n")
    cfg = {"path": str(root), "train": "images/train", "val": "images/val", "names": DOTA_V1["names"]}
    (root / "data.yaml").write_text(yaml.dump(cfg))
    return root / "data.yaml"


@pytest.fixture(scope="module")
def tpu_fold_threshold():
    """The port's graph as the validator tests have held it: the JAX package's TPU fold
    threshold in eval (32). At the H100 default (128) one box width of the JSON rounds to
    239.052 against JAX's 239.051 (4e-6 relative): one unit of the 3-decimal rounding."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tconv, "FOLD_MAX_EVAL", 32)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def val_runs(tmp_path_factory, tpu_fold_threshold):
    """Both Validators on the same set and weights, with every output: the
    JAX one's jitted inference compiled once (batch 4 at 64)."""
    tmp = tmp_path_factory.mktemp("val")
    data = _write_set(tmp)
    jm = JaxDetectionModel.from_yaml(CFG, nc=NC)
    v = jax_variables(jm.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False)
    tm = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", fused_1x1=False)  # no fused 1x1, as in JAX
    load_jax_variables(tm, v)
    jval, tval = JaxValidator(jm, imgsz=IMGSZ), Validator(tm, imgsz=IMGSZ)
    # label each image with the JAX model's top 4 detections too, the last of them
    # with another class
    tds = YOLODataset(data, "val", task="obb")
    own = []
    for batch in build_dataloader(tds, BATCH, IMGSZ, hyp=None, augment=False, shuffle=False,
                                  drop_last=False, with_meta=True):
        det, ok, _ = jval._infer(v, jnp.asarray(batch["img"]))
        for b in range(batch["n_real"]):
            d = np.asarray(det)[b][np.asarray(ok)[b]][:4].astype(np.float64)
            d[:, :5] = scale_rboxes(d[:, :5], batch["ratio_pad"][b])
            d[-1, 6] = (d[-1, 6] + 1) % NC
            own.append(d[:, [0, 1, 2, 3, 4, 6]])
    data = _write_set(tmp, detections=own)
    jds, tds = JaxDataset(data, "val", task="obb"), YOLODataset(data, "val", task="obb")
    out = {}
    for name, run in (("jax", lambda **kw: jval(v, jds, batch_size=BATCH, **kw)),
                      ("port", lambda **kw: tval(tds, batch_size=BATCH, **kw))):
        d = tmp / name
        metrics = run(save_json=str(tmp / f"{name}.json"), save_submission=str(d / "sub"),
                      save_dir=str(d) if name == "port" else None)
        out[name] = {"metrics": metrics, "json": json.loads((tmp / f"{name}.json").read_text()),
                     "sub": {p.name: p.read_text() for p in sorted((d / "sub").glob("*.txt"))},
                     "confusion": (jval if name == "jax" else tval).confusion.matrix.copy()}
    # per-batch detections of both on the port loader's batches (the same pixels at r = 1)
    dets = []
    for batch in build_dataloader(tds, BATCH, IMGSZ, hyp=None, max_labels=256, augment=False,
                                  shuffle=False, drop_last=False, with_meta=True):
        jdet, jok, _ = jval._infer(v, jnp.asarray(batch["img"]))
        tdet, tok, _ = tval.infer(torch.from_numpy(batch["img"]))
        for b in range(batch["n_real"]):
            dets.append((np.asarray(jdet)[b][np.asarray(jok)[b]], tdet[b][tok[b]].numpy()))
    return out, dets, tmp, tval


def test_validator_keeps_the_same_detections(val_runs):
    _, dets, _, _ = val_runs
    assert len(dets) == len(STEMS)
    for i, (ref, got) in enumerate(dets):
        assert len(got) == len(ref) > 0, f"image {i}: {len(got)} vs {len(ref)} kept"
        # rows in score order; near-equal scores may swap neighbours, so match each
        # port row to the nearest JAX row
        d = np.abs(got[:, None, :] - ref[None, :, :]) / np.maximum(1.0, np.abs(ref[None, :, :]))
        worst = d.max(-1)
        assert worst.min(1).max() <= 1e-4 and worst.min(0).max() <= 1e-4, f"image {i}"


def test_validator_metrics_match_jax(val_runs):
    out, _, tmp, tval = val_runs
    a, b = out["port"]["metrics"], out["jax"]["metrics"]
    assert set(a) == set(b) == {"mAP50", "mAP50-95", "precision", "recall"}
    for k in b:
        assert 0.0 < a[k] < 1.0 and abs(a[k] - b[k]) <= 1e-3, (k, a[k], b[k])
    np.testing.assert_array_equal(out["port"]["confusion"], out["jax"]["confusion"])
    assert (tmp / "port" / "per_class.txt").read_text().startswith(" " * 13 + "Class")
    assert set(tval.speed) == {"load_ms", "infer_ms", "match_ms", "img_s"}


def test_validator_outputs_match_jax(val_runs):
    out, _, _, _ = val_runs
    ours, ref = out["port"]["json"], out["jax"]["json"]
    assert len(ours) == len(ref) > 0
    key = lambda r: (r["image_id"], r["category_id"], r["score"], r["bbox"][0])  # noqa: E731
    for a, b in zip(sorted(ours, key=key), sorted(ref, key=key)):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose([a["score"], a["angle"], *a["bbox"]],
                                   [b["score"], b["angle"], *b["bbox"]], rtol=0, atol=1e-3)
    assert list(out["port"]["sub"]) == list(out["jax"]["sub"]) == \
        sorted(f"Task1_{n}.txt" for n in DOTA_V1["names"].values())
    for name in out["jax"]["sub"]:
        rows = [sorted(ln.split() for ln in out[k]["sub"][name].splitlines()) for k in ("port", "jax")]
        assert len(rows[0]) == len(rows[1]), name
        for a, b in zip(*rows):
            assert a[0] == b[0]  # image ids, merged over patches: P0001, P0002, ...
            np.testing.assert_allclose(np.float64(a[1:]), np.float64(b[1:]), rtol=0, atol=1e-2)


# ---------------------------------------------------------------- fit bookkeeping


def _losses(epoch, i):
    return 3.0 / (1 + epoch) + 0.1 * i


# mAP rises, then stalls: epoch 2 is the best, and with patience 2 both stop after epoch 5
MAPS = [(0.1, 0.05), (0.3, 0.2), (0.5, 0.3), (0.4, 0.25), (0.5, 0.3), (0.2, 0.1), (0.9, 0.9)]


def _loader(epoch):
    return [{"epoch": np.float32(epoch), "i": np.float32(i)} for i in range(3)]


def _fit_jax(tmp, validate, epochs, patience):
    model = JaxDetectionModel.from_yaml(CFG, nc=NC)
    tr = jt.Trainer(model, jt.TrainConfig(epochs=epochs, patience=patience), steps_per_epoch=3)
    tr._train_step = lambda state, b: (state, _losses(float(b["epoch"]), float(b["i"])), {})
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params={"w": jnp.zeros(2)}, batch_stats={},
                          opt_state=(), ema_params={"w": jnp.zeros(2)})
    calls = {"n": 0}

    def validate_fn(_state):
        m50, m = MAPS[calls["n"]]
        calls["n"] += 1
        return {"mAP50": m50, "mAP50-95": m}

    events, logs = [], []
    cb = JaxCallbacks()
    for e in EVENTS:
        cb.add(e, lambda *a, e=e: events.append(e))
    tr.fit(state, _loader, validate_fn if validate else None, save_dir=str(tmp), log=logs.append,
           callbacks=cb, close_mosaic_hook=lambda ep: events.append(f"close_mosaic {ep}"),
           close_mosaic=2)
    saved = {n: pickle.loads((tmp / n).read_bytes())["epoch"] for n in ("last.ckpt", "best.ckpt")}
    return tr.history, logs, events, saved


def _fit_port(tmp, validate, epochs, patience):
    model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu")
    tr = tt.Trainer(model, tt.TrainConfig(epochs=epochs, patience=patience, dtype="float32"),
                    steps_per_epoch=3, device="cpu")
    tr.step = lambda b: (torch.tensor(_losses(float(b["epoch"]), float(b["i"]))), {})
    calls = {"n": 0}

    def validate_fn(trainer):
        assert trainer is tr
        m50, m = MAPS[calls["n"]]
        calls["n"] += 1
        return {"mAP50": m50, "mAP50-95": m}

    events, logs = [], []
    cb = Callbacks()
    for e in EVENTS:
        cb.add(e, lambda *a, e=e: events.append(e))
    history = tr.fit(_loader, validate_fn if validate else None, save_dir=tmp, log=logs.append,
                     callbacks=cb, close_mosaic_hook=lambda ep: events.append(f"close_mosaic {ep}"),
                     close_mosaic=2)
    assert history is tr.history
    saved = {n: pickle.loads((tmp / n).read_bytes())["epoch"] for n in ("last.ckpt", "best.ckpt")}
    return tr.history, logs, events, saved


def _assert_rows(got, ref):
    """The same epochs and keys, every value within 1e-6 relative (the JAX loss
    is a float32 array mean), wall times left out."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert list(a) == list(b)
        for k in b:
            if k != "time_s":
                assert a[k] == pytest.approx(b[k], rel=1e-6), k


@pytest.mark.parametrize("validate,epochs,patience", [(True, 7, 2), (False, 4, 100), (True, 3, 0)])
def test_fit_bookkeeping_matches_jax(tmp_path, validate, epochs, patience):
    ours = _fit_port(tmp_path / "port", validate, epochs, patience)
    ref = _fit_jax(tmp_path / "jax", validate, epochs, patience)
    _assert_rows(ours[0], ref[0])
    strip = lambda lines: [" ".join(w for w in ln.split() if not w.startswith("time_s=")) for ln in lines]  # noqa: E731
    assert strip(ours[1]) == strip(ref[1])
    assert ours[2] == ref[2]  # callback events, in order
    assert ours[3] == ref[3]  # the epochs in last.ckpt and best.ckpt
    for k in ("port", "jax"):
        rows = json.loads((tmp_path / k / "results.json").read_text())
        _assert_rows(rows, ours[0])
    if validate and patience == 2:
        assert len(ours[0]) == 6 and ours[3] == {"last.ckpt": 5, "best.ckpt": 2}


# ---------------------------------------------------------------- a real CPU fit


def test_fit_trains_and_validates_the_ema(tmp_path):
    data = _write_set(tmp_path / "data", seed=3)  # random labels
    tds, vds = YOLODataset(data, "train", task="obb"), YOLODataset(data, "val", task="obb")
    model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", seed=1)
    cfg = tt.TrainConfig(batch=2, nbs=2, epochs=2, dtype="float32", warmup_epochs=0)
    tr = tt.Trainer(model, cfg, steps_per_epoch=3, device="cpu")
    val = Validator(model, imgsz=IMGSZ)

    def validate_fn(trainer):  # the EMA weights, and the training ones back afterwards
        before = [p.detach().clone() for p in trainer.params]
        with trainer.ema_weights() as m:
            assert all(torch.equal(p, e) for p, e in zip(m.parameters(), trainer.ema))
            metrics = val(vds, batch_size=4)
        assert all(torch.equal(a, b) for a, b in zip(before, trainer.params))
        assert not all(torch.equal(a, b) for a, b in zip(before, trainer.ema))
        return metrics

    ema0 = [e.clone() for e in tr.ema]
    cb = Callbacks()
    CSVLogger(tmp_path / "run").attach(cb)
    loader = lambda e: build_dataloader(tds, 2, IMGSZ, hyp=None, augment=False, seed=e)  # noqa: E731
    history = tr.fit(loader, validate_fn, save_dir=tmp_path / "run", callbacks=cb, log=lambda s: None)
    assert len(history) == 2 and all(math.isfinite(r["loss"]) for r in history)
    assert all(0 <= r[k] <= 1 for r in history for k in ("mAP50", "mAP50-95", "precision", "recall"))
    assert tr.opt.count == 6 and not all(torch.equal(a, b) for a, b in zip(ema0, tr.ema))
    for name in ("last.ckpt", "best.ckpt", "results.json", "results.csv"):
        assert (tmp_path / "run" / name).exists(), name
    assert latest(tmp_path / "run") == str(tmp_path / "run" / "last.ckpt")
    # a restored trainer runs the third epoch
    model2 = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", seed=2)
    tr2 = tt.Trainer(model2, cfg, steps_per_epoch=3, device="cpu")
    start = tr2.restore_checkpoint(latest(tmp_path / "run"))
    assert start == 2
    h2 = tr2.fit(loader, lambda t: {}, epochs=3, start_epoch=start, save_dir=tmp_path / "run",
                 log=lambda s: None)
    assert [r["epoch"] for r in h2] == [2] and math.isfinite(h2[0]["loss"]) and tr2.opt.count == 9
