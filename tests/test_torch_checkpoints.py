"""Checkpoints that cross packages, on the CPU: the detection trainer's
``last.ckpt`` written by either package resumes in the other and gives the
other's next update; the port writes the optax state of the JAX
``build_optimizer`` exactly, as optax's own classes for JAX's ``pickle.load``
(the optax module paths it names are the installed optax's); and a port
classification checkpoint resumes under the JAX classification CLI's
``--resume``.

The detection model is a small detect graph (five stride-2 Convs and a Detect
head, nc 3) read from a YAML file, f32, batch 2 at 64 with ``nbs`` 4
(accumulate 2), so that a checkpoint falls between two micro-steps of an
accumulation. The JAX train step is compiled once for the module.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quan_ultralytics_tpu.classification.cli as jcli
import quan_ultralytics_tpu.classification.data as jdata
import quan_ultralytics_tpu.classification.models as jmodels
import quan_ultralytics_tpu.classification.train as jtrain
import quan_ultralytics_tpu_torch.classification.cli as tcli
import quan_ultralytics_tpu_torch.classification.models as tmodels
import quan_ultralytics_tpu_torch.classification.train as ttrain
from quan_ultralytics_tpu.engine import trainer as jt
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu_torch.engine import trainer as tt
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils.weights import (OPTAX_MODULES, OptaxState, from_jax_tree, load_jax_variables,
                                                       read_checkpoint)
from torch_port_helpers import assert_close, jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

SMALL_YAML = """\
# a small detect graph: five stride-2 Convs, a Detect head on P3-P5
nc: 3
scales:
  n: [0.50, 0.25, 1024]
backbone:
  - [-1, 1, Conv, [64, 3, 2]]    # 0 P1/2
  - [-1, 1, Conv, [128, 3, 2]]   # 1 P2/4
  - [-1, 1, Conv, [256, 3, 2]]   # 2 P3/8
  - [-1, 1, Conv, [512, 3, 2]]   # 3 P4/16
  - [-1, 1, Conv, [1024, 3, 2]]  # 4 P5/32
head:
  - [[2, 3, 4], 1, Detect, [nc]]  # 5
"""
B, M, IMGSZ, STEPS_PER_EPOCH = 2, 6, 64, 3
CFG = dict(epochs=4, batch=B, nbs=4, dtype="float32", assigner_bf16=False)
# the next update of each package from the same checkpoint: per leaf, max |update difference|
# <= UPDATE_RTOL * max |update| + 2 f32 ulps of the leaf's max |value| (f32: the gradients
# differ by summation order, and each package rounds the updated leaf to f32)
UPDATE_RTOL = 1e-4
ULP = float(np.finfo(np.float32).eps)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, M, 2)), rng.uniform(0.1, 0.4, (B, M, 2))], -1)
    return {"img": rng.integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "cls": rng.integers(0, 3, (B, M)).astype(np.int32), "bboxes": boxes.astype(np.float32),
            "mask": np.arange(M)[None] < np.array([[5], [3]])}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(YAML path, seeded JAX variables, the JAX Trainer, its compiled train step,
    the JAX state after 0..4 micro-steps)."""
    d = tmp_path_factory.mktemp("small")
    path = d / "yolo11n-small-quan.yaml"
    path.write_text(SMALL_YAML)
    jm = JaxDetectionModel.from_yaml(str(path))
    v = jax_variables(jm.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=0)
    cfg = jt.TrainConfig(imgsz=IMGSZ, **CFG)
    tr = jt.Trainer(jm, cfg, STEPS_PER_EPOCH)
    tr.tx = jt.build_optimizer(cfg, v["params"], STEPS_PER_EPOCH)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tr.tx.init(v["params"]), ema_params=v["params"])
    step = tr.make_train_step()
    states = [state]
    for i in range(4):
        states.append(step(states[-1], {k: jnp.asarray(a) for k, a in _batch(i).items()})[0])
    return path, v, tr, step, [jax.device_get(s) for s in states]


def _port_trainer(path, **overrides):
    model = DetectionModel.from_yaml(path, device="cpu")
    return tt.Trainer(model, tt.TrainConfig(**{**CFG, **overrides}), steps_per_epoch=STEPS_PER_EPOCH,
                      device="cpu")


def _port_state(trainer):
    """{what: {port name: array}} of a port Trainer: params, ema, batch_stats, trace, acc."""
    names = trainer.param_names
    as_np = lambda ts: {n: t.detach().numpy().copy() for n, t in zip(names, ts)}  # noqa: E731
    return {"params": as_np(trainer.params), "ema": as_np(trainer.ema), "trace": as_np(trainer.opt.trace),
            "acc": as_np(trainer.opt.acc),
            "batch_stats": {n: b.numpy().copy() for n, b in trainer.model.state_dict().items() if n not in names}}


def _jax_state(state):
    """The same of a JAX TrainState (MultiStepsState around the three groups)."""
    opt = state.opt_state
    trace = {}
    for group in tt.GROUPS:
        trace.update(from_jax_tree(opt.inner_opt_state.inner_states[group].inner_state[2].inner_state[0].trace))
    return {"params": from_jax_tree(state.params), "ema": from_jax_tree(state.ema_params), "trace": trace,
            "acc": from_jax_tree(opt.acc_grads), "batch_stats": from_jax_tree(state.batch_stats)}


def _counters_of_jax(state):
    opt = state.opt_state
    counts = {int(opt.inner_opt_state.inner_states[g].inner_state[2].count) for g in tt.GROUPS}
    assert len(counts) == 1
    return int(state.step), counts.pop(), int(opt.mini_step)


def _assert_next_update_equal(before, port_after, jax_after):
    """Every leaf's change from ``before`` within UPDATE_RTOL of the JAX change's max."""
    for what in ("params", "ema", "trace", "acc", "batch_stats"):
        for n, b in before[what].items():
            dj, dp = jax_after[what][n] - b, port_after[what][n] - b
            lim = UPDATE_RTOL * float(np.abs(dj).max()) + 2 * ULP * float(np.abs(b).max())
            assert float(np.abs(dp - dj).max()) <= lim, f"{what} {n}"


def test_optax_module_paths_are_the_installed_optax(small):
    """Each class the port names in a checkpoint is defined in the module it names."""
    *_, states = small
    found = {}

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            found[type(node).__name__] = type(node).__module__
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(states[0].opt_state)
    walk(jtrain.build_cls_optimizer(jtrain.ClsConfig(), 1).init({"w": jnp.zeros(2)}))
    assert set(OPTAX_MODULES) <= set(found)
    assert {k: found[k] for k in OPTAX_MODULES} == OPTAX_MODULES


@pytest.mark.parametrize("nbs", [2, 4])
def test_port_optimizer_state_is_the_jax_optax_state(small, tmp_path, nbs):
    """A fresh port trainer's checkpoint, read with pickle (optax importable), holds
    the optax state of ``build_optimizer`` for the same parameters: the same tree
    (classes, keys, masked leaves), dtypes and shapes; zero traces and counts; and
    the first update's hyperparameters within 1e-6 (accumulate 1 and 2)."""
    path, v, *_ = small
    trainer = _port_trainer(path, nbs=nbs)
    load_jax_variables(trainer.model, v)
    trainer.save_checkpoint(tmp_path / "last.ckpt", epoch=0)
    got = pickle.loads((tmp_path / "last.ckpt").read_bytes())
    assert set(got) == {"epoch", "step", "params", "batch_stats", "ema_params", "opt_state"}
    cfg = jt.TrainConfig(imgsz=IMGSZ, **{**CFG, "nbs": nbs})
    ref = jt.build_optimizer(cfg, v["params"], STEPS_PER_EPOCH).init(v["params"])
    assert jax.tree_util.tree_structure(got["opt_state"]) == jax.tree_util.tree_structure(ref)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(got["opt_state"])[0], jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), jax.tree_util.keystr(p)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(p))
    assert jax.tree_util.tree_structure(got["params"]) == jax.tree_util.tree_structure(v["params"])


def test_jax_checkpoint_resumes_in_the_port(small, tmp_path):
    """JAX `Trainer.save_checkpoint` after 3 micro-steps (one update, one micro-step
    accumulated) resumes in the port: the state as saved, the counters, and the
    port's 4th micro-step (an update) equal to JAX's within UPDATE_RTOL."""
    path, _, tr, _, states = small
    tr.save_checkpoint(tmp_path / "last.ckpt", states[3], epoch=0)
    trainer = _port_trainer(path)
    assert trainer.restore_checkpoint(tmp_path / "last.ckpt") == 1
    assert (trainer.steps, trainer.opt.count, trainer.opt.mini_step) == _counters_of_jax(states[3]) == (3, 1, 1)
    before, ref = _port_state(trainer), _jax_state(states[3])
    for what, leaves in before.items():
        for n, a in leaves.items():
            assert np.array_equal(a, ref[what][n]), f"{what} {n}"
    trainer.step(_batch(3))
    assert (trainer.steps, trainer.opt.count, trainer.opt.mini_step) == _counters_of_jax(states[4]) == (4, 2, 0)
    _assert_next_update_equal(before, _port_state(trainer), _jax_state(states[4]))


def test_port_checkpoint_resumes_in_jax(small, tmp_path):
    """The port's own 3 micro-steps from the same weights, saved by the port and
    restored by JAX `Trainer.restore_checkpoint`: the state's tree is the JAX
    state's (the step compiled for JAX's own restored file takes it without a new
    trace), and JAX's 4th micro-step equals the port's within UPDATE_RTOL."""
    path, v, tr, step, states = small
    trainer = _port_trainer(path)
    load_jax_variables(trainer.model, v)
    with torch.no_grad():
        torch._foreach_copy_(trainer.ema, trainer.params)
    for i in range(3):
        trainer.step(_batch(i))
    trainer.save_checkpoint(tmp_path / "last.ckpt", epoch=2)
    restored, start = tr.restore_checkpoint(tmp_path / "last.ckpt")
    assert start == 3 and _counters_of_jax(restored) == (3, 1, 1)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(states[3])
    before = _port_state(trainer)
    for what, leaves in _jax_state(restored).items():
        for n, a in leaves.items():
            assert np.array_equal(a, before[what][n]), f"{what} {n}"
    batch = {k: jnp.asarray(a) for k, a in _batch(3).items()}
    tr.save_checkpoint(tmp_path / "jax.ckpt", states[3], epoch=2)
    step(tr.restore_checkpoint(tmp_path / "jax.ckpt")[0], batch)  # JAX's own file, restored: host arrays
    compiled = step._cache_size()
    after = jax.device_get(step(restored, batch)[0])
    assert step._cache_size() == compiled  # the port's file gives the same shapes, dtypes and tree
    trainer.step(_batch(3))
    assert _counters_of_jax(after) == (trainer.steps, trainer.opt.count, trainer.opt.mini_step) == (4, 2, 0)
    _assert_next_update_equal(before, _port_state(trainer), _jax_state(after))


def test_port_checkpoint_reads_without_optax(small, tmp_path):
    """`read_checkpoint` reads the port's own file with numpy alone: optax states
    come back as stand-ins holding the same fields."""
    path, v, *_ = small
    trainer = _port_trainer(path)
    trainer.save_checkpoint(tmp_path / "last.ckpt", epoch=0)
    got = read_checkpoint(tmp_path / "last.ckpt")["opt_state"]
    assert isinstance(got, OptaxState) and got.name == "MultiStepsState"
    assert type(got).__module__ == OPTAX_MODULES["MultiStepsState"]
    inner = got[2][0]["weight"][0][2]
    assert inner.name == "InjectStatefulHyperparamsState" and int(inner[0]) == 0


class _Imports:
    """Pickles as ``importlib.import_module(name)``."""

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        import importlib

        return importlib.import_module, (self.name,)


class _Reads:
    """Pickles as ``getattr(obj, name)``."""

    def __init__(self, obj, name):
        self.obj, self.name = obj, name

    def __reduce__(self):
        return getattr, (self.obj, self.name)


@pytest.mark.parametrize("payload", [_Imports("os"), _Reads(_Imports("os"), "system"), _Reads("text", "upper")])
def test_read_checkpoint_runs_no_other_import_or_attribute(tmp_path, payload):
    """The reader takes ``import_module`` and ``getattr`` only as the writer uses
    them, on optax modules and their classes: anything else raises."""
    (tmp_path / "x.ckpt").write_bytes(pickle.dumps({"opt_state": payload}))
    with pytest.raises(pickle.UnpicklingError):
        read_checkpoint(tmp_path / "x.ckpt")


# ------------------------------------------------------------------ classification


@pytest.fixture
def wrn10(monkeypatch):
    """A reduced factory name in both packages: QWideResNet(10, 1), and a small
    synthetic set (16 train, 8 test images) in both CLIs, which train in f32."""
    monkeypatch.setitem(jmodels.MODEL_FACTORIES, "qwrn10_1",
                        lambda nc, drop, mt, dtype=None: jmodels.QWideResNet(10, 1, nc, drop, mt, dtype))
    monkeypatch.setitem(tmodels.MODEL_FACTORIES, "qwrn10_1",
                        lambda nc, drop, mt, dtype=None: tmodels.QWideResNet(10, 1, nc, drop, mt, dtype))
    small_set = functools.partial(jdata.make_synthetic, n_train=16, n_test=8)
    monkeypatch.setattr(jcli, "make_synthetic", small_set)
    monkeypatch.setattr(tcli, "make_synthetic", small_set)
    monkeypatch.setattr(jcli, "ClsConfig", functools.partial(jtrain.ClsConfig, dtype="float32"))
    monkeypatch.setattr(tcli, "ClsConfig", functools.partial(ttrain.ClsConfig, dtype="float32"))
    return "qwrn10_1"


def test_port_cls_checkpoint_resumes_under_the_jax_cli(wrn10, tmp_path):
    """QWideResNet(10, 1), f32, batch 8: one epoch through the port's CLI, then
    ``--resume <its last.pkl> --epochs 2`` through the JAX CLI and through the
    port's: the same epoch and step in both, parameters, IQBN statistics and the
    momentum trace within 1e-4 relative and 1e-4 of max(1, max|leaf|) (as the
    port's train step is held to JAX's in tests/test_torch_classify.py), the
    count as JAX's optax chain holds it."""
    args = ["--model", wrn10, "--dataset", "synthetic", "--batch_size", "8"]
    assert tcli.main(args + ["--epochs", "1", "--exp_dir", str(tmp_path / "first"), "--device", "cpu"]) == 0
    (first,) = (tmp_path / "first").iterdir()
    ck = first / "last.pkl"
    assert read_checkpoint(ck)["step"] == 2
    assert jcli.main(args + ["--epochs", "2", "--resume", str(ck), "--exp_dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--epochs", "2", "--resume", str(ck), "--exp_dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    (jdir,), (pdir,) = (tmp_path / "jax").iterdir(), (tmp_path / "port").iterdir()
    ref, got = pickle.loads((jdir / "last.pkl").read_bytes()), read_checkpoint(pdir / "last.pkl")
    assert (ref["epoch"], ref["step"]) == (got["epoch"], got["step"]) == (1, 4)
    for collection in ("params", "batch_stats"):
        r, g = from_jax_tree(ref[collection]), from_jax_tree(got[collection])
        assert set(r) == set(g)
        for n in r:
            assert_close(g[n], r[n], rtol=1e-4, atol=1e-4, err_msg=n)
    trace, count = ttrain.read_opt_state(got["opt_state"])
    assert count == int(ref["opt_state"][1][1].count) == 4
    r = from_jax_tree(ref["opt_state"][1][0].trace)
    for n, a in from_jax_tree(trace).items():
        assert_close(a, r[n], rtol=1e-4, atol=1e-4, err_msg=n)
    assert isinstance(ref["opt_state"][1][0], optax.TraceState)
