"""The slice as a whole: the train step of yolo11n-obb-quan (nc=3, imgsz 64,
batch 2, f32) in the port against the JAX ``Trainer``, three micro-steps on
one fixed batch from the JAX ``init_state`` weights, with accumulate 1
(nbs=2) and accumulate 2 (nbs=4), default warmup; and the trainer's
mechanics: per-group clipping, schedules, the NaN guard, checkpoints.

The JAX step runs as the Trainer builds it (``make_train_step``), eagerly,
with the gradient of its loss and the optimizer's update compiled ahead
(see `_jax_runs`). Both sides run the assigner's metric chain in f32
(``assigner_bf16=False``): in bf16 a near-tie flipped by a 1-ulp difference
of the parameters changes which anchors train (the bf16 chain is held to
the JAX package in tests/test_torch_losses.py).

Compared: the losses of the three free-running steps; and, one step at a
time, the state that one port step makes from each JAX state (parameters,
batch statistics, EMA, momentum, accumulator, counters) against the JAX
state after that step. At accumulate 2 the accumulator after step 1 holds
step 1's gradients, so they are compared leaf by leaf. The free-running
states are not compared: at this size (batch 2, 2x2 cells at P5, a first
bias step of lr 0.1) training is chaotic, and in the port alone a 1e-6
relative change of the initial weights moves ``model.0.bn.beta`` by 2.5e-2
of 1.1 after three updates.

Tolerances: the free-running step-1 loss and terms within 1e-4 relative
(reached: 8e-7 for the total, 1.1e-5 for a term), later ones 1e-3 (reached:
3.1e-4); the loss of a step from a JAX state 1e-5 (reached: 8e-7); every
state leaf within 1e-3 of its max |value| plus 1e-7 (reached: 6.3e-4, step
1's gradient of a leaf whose gradients are 1e-4 of the largest), the
absolute term for leaves whose exact gradient is 0 and whose computed one
is f32 noise (~1e-8).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quan_ultralytics_tpu.engine import trainer as jt
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu_torch.engine import trainer as tt
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils.weights import _flatten, _port_leaf, load_jax_variables
from torch_port_helpers import assert_close, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ, B, M = "yolo11n-obb-quan.yaml", 3, 64, 2, 6
STEPS_PER_EPOCH = 4
LOW_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LEAF_RTOL, LEAF_ATOL = 1e-3, 1e-7  # of max|leaf|, absolute


def _batch(seed: int = 0):
    """uint8 frames and normalized xywhr targets: valid rows, padding, one box under 2 px."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, M, 2)), rng.uniform(0.15, 0.5, (B, M, 2)),
                            rng.uniform(-1.2, 1.2, (B, M, 1))], -1).astype(np.float32)
    boxes[0, 2, 2] = 0.02
    mask = np.zeros((B, M), bool)
    mask[0, :4] = True
    mask[1, :2] = True
    return {"img": rng.integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "cls": rng.integers(0, NC, (B, M)).astype(np.int32), "bboxes": boxes, "mask": mask}


def _port_tree(tree) -> dict:
    """A JAX leaf tree (params-shaped; optax's masked leaves skipped) ->
    {port name: array in the port's layout}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, v in leaves:
        if hasattr(v, "shape"):
            name, arr = _port_leaf(tuple(str(p.key) for p in path), np.asarray(v))
            out[name] = arr
    return out


def _jax_runs():
    """{nbs: (JAX states after 0..3 steps, the 3 steps' losses)}.

    The Trainer's step runs eagerly (``make_train_step().__wrapped__``), with
    its two costly parts compiled ahead: the gradient of ``loss_fn`` (one
    program for both cases: the loss does not depend on nbs), served to the
    step's ``jax.value_and_grad`` call, and the optimizer's update. Compiling
    the whole step costs minutes on the CPU. The model's init is compiled at
    a low XLA optimization level.
    """
    jm = JaxDetectionModel.from_yaml(CFG, nc=NC)
    jm.init = jax.jit(jm.init, static_argnames="imgsz", compiler_options=LOW_OPT)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    runs, loss_fn = {}, None
    value_and_grad = jax.value_and_grad
    with pytest.MonkeyPatch.context() as mp:
        for nbs in (2, 4):
            cfg = jt.TrainConfig(epochs=10, batch=B, imgsz=IMGSZ, nbs=nbs, dtype="float32",
                                 assigner_bf16=False)
            trainer = jt.Trainer(jm, cfg, steps_per_epoch=STEPS_PER_EPOCH)
            state = trainer.init_state()
            if loss_fn is None:
                loss_fn = trainer.loss_fn
                vg = jax.jit(value_and_grad(loss_fn, has_aux=True))
                mp.setattr(jax, "value_and_grad",
                           lambda f, **kw: vg if f is loss_fn else value_and_grad(f, **kw))
            trainer.loss_fn = loss_fn
            trainer.tx = optax.GradientTransformationExtraArgs(
                trainer.tx.init, jax.jit(trainer.tx.update))
            step = trainer.make_train_step().__wrapped__
            states, losses = [jax.device_get(state)], []
            for _ in range(3):
                state, loss, aux = step(state, batch)
                states.append(jax.device_get(state))
                losses.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
            runs[nbs] = (states, losses)
    return runs


def _port_trainer_at(state, nbs: int, **model_kw):
    """A port Trainer holding the JAX train state ``state``: weights, batch
    statistics, EMA, and the optimizer's momentum, accumulator and counters;
    ``model_kw`` go to the model (the stem's form)."""
    model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", **model_kw)
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})
    cfg = tt.TrainConfig(epochs=10, batch=B, nbs=nbs, dtype="float32", assigner_bf16=False)
    trainer = tt.Trainer(model, cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
    names = trainer.param_names
    opt = state.opt_state
    inner = opt.inner_opt_state if nbs > B else opt
    trace = {}
    for group in tt.GROUPS:  # chain(clip, decay, inject(sgd)): the trace of sgd's trace()
        inj = inner.inner_states[group].inner_state[2]
        trace.update(_port_tree(inj.inner_state[0].trace))
        trainer.opt.count = int(inj.count)
    with torch.no_grad():
        ema = _port_tree(state.ema_params)
        torch._foreach_copy_(trainer.ema, [torch.from_numpy(ema[n]) for n in names])
        torch._foreach_copy_(trainer.opt.trace, [torch.from_numpy(trace[n]) for n in names])
        if nbs > B:
            acc = _port_tree(opt.acc_grads)
            torch._foreach_copy_(trainer.opt.acc, [torch.from_numpy(acc[n]) for n in names])
            trainer.opt.mini_step = int(opt.mini_step)
    trainer.steps = int(state.step)
    return trainer


def _port_state(trainer) -> dict:
    """{what: {name: tensor}} of a port Trainer, keyed like `_jax_state`."""
    names = trainer.param_names
    out = {"params": dict(zip(names, trainer.params)), "ema": dict(zip(names, trainer.ema)),
           "trace": dict(zip(names, trainer.opt.trace)),
           "batch_stats": {n: b for n, b in trainer.model.state_dict().items() if n not in names}}
    if trainer.accumulate > 1:
        out["acc"] = dict(zip(names, trainer.opt.acc))
    return out


def _jax_state(state, nbs: int) -> dict:
    opt = state.opt_state
    inner = opt.inner_opt_state if nbs > B else opt
    trace = {}
    for group in tt.GROUPS:
        trace.update(_port_tree(inner.inner_states[group].inner_state[2].inner_state[0].trace))
    out = {"params": _port_tree(state.params), "ema": _port_tree(state.ema_params), "trace": trace,
           "batch_stats": _port_tree(state.batch_stats)}
    if nbs > B:
        out["acc"] = _port_tree(opt.acc_grads)
    return out


def _port_run(state0, nbs: int):
    """Three free-running port steps from the JAX initial state: (losses, EMA after 0..3 steps)."""
    trainer = _port_trainer_at(state0, nbs)
    losses, emas = [], [[e.clone() for e in trainer.ema]]
    for _ in range(3):
        loss, aux = trainer.step(_batch())
        losses.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
        emas.append([e.clone() for e in trainer.ema])
    return trainer, losses, emas


@pytest.fixture(scope="module")
def runs():
    """{nbs: (JAX states after 0..3 steps, JAX losses, port trainer after 3 steps,
    port losses, port EMA after 0..3 steps)}."""
    return {nbs: (states, jlosses, *_port_run(states[0], nbs))
            for nbs, (states, jlosses) in _jax_runs().items()}


def _assert_leaves(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    for name, r in ref.items():
        r = np.asarray(r, np.float32)
        g = got[name].detach().float().numpy()
        err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, \
            f"{what} {name}: max err {err:.3e} vs max|ref| {scale:.3e}"


@pytest.mark.parametrize("nbs", [2, 4])
def test_train_losses_match_jax_step_by_step(runs, nbs):
    _, jlosses, trainer, plosses, _ = runs[nbs]
    assert trainer.accumulate == nbs // B
    for i, (p, j) in enumerate(zip(plosses, jlosses)):
        assert set(p) == set(j), i
        assert p["nan_skipped"] == j["nan_skipped"] == 0.0
        assert p["num_fg"] == j["num_fg"] > 0, i
        for k in ("loss", "box", "cls", "dfl", "quat"):
            assert p[k] == pytest.approx(j[k], rel=1e-4 if i == 0 else 1e-3), f"step {i + 1} {k}"
    # the update of step 1 (accumulate 1) or step 2 (accumulate 2) moved the loss
    assert plosses[2]["loss"] != plosses[0]["loss"]


@pytest.mark.parametrize("nbs", [2, 4])
def test_each_step_from_the_jax_state_matches_jax(runs, nbs):
    """One port step from JAX state k-1 gives JAX state k, for k = 1, 2, 3:
    loss, parameters, batch statistics, EMA, momentum, accumulator (at
    accumulate 2; after micro-step 1 it holds that step's gradients) and
    the counters."""
    states, jlosses, _, _, _ = runs[nbs]
    for k in (1, 2, 3):
        trainer = _port_trainer_at(states[k - 1], nbs)
        loss, _ = trainer.step(_batch())
        assert float(loss) == pytest.approx(jlosses[k - 1]["loss"], rel=1e-5), k
        ref, got = _jax_state(states[k], nbs), _port_state(trainer)
        assert set(got) == set(ref)
        for what in ref:
            _assert_leaves(got[what], ref[what], f"step {k} {what}")
        assert trainer.steps == int(states[k].step) == k
        opt = states[k].opt_state
        if nbs > B:
            assert (trainer.opt.count, trainer.opt.mini_step) == (int(opt.gradient_step),
                                                                  int(opt.mini_step))
        else:
            assert trainer.opt.count == int(opt.inner_states["bias"].inner_state[2].count) == k


@pytest.mark.parametrize("stem", [{"stem_s2d": True}, {"stem_deep": 1}, {"stem_deep": 2},
                                  {"stem_deep": 1, "stem_remat": True}])
def test_stem_forms_step_from_the_jax_state_matches_jax(runs, stem):
    """The port's phase-composite and deep-packed stems (the JAX Trainer builds
    its model with the JAX default, stem_s2d): one step from JAX state 1 at
    accumulate 1 gives JAX state 2, loss and every state leaf as above."""
    states, jlosses, _, _, _ = runs[2]
    trainer = _port_trainer_at(states[1], 2, **stem)
    loss, _ = trainer.step(_batch())
    assert float(loss) == pytest.approx(jlosses[1]["loss"], rel=1e-5)
    ref, got = _jax_state(states[2], 2), _port_state(trainer)
    for what in ref:
        _assert_leaves(got[what], ref[what], f"{stem} {what}")


def test_ema_moves_only_on_optimizer_updates(runs):
    """Accumulate 2: the EMA equals the initial parameters after micro-step 1,
    moves at micro-step 2 (the update) and holds at micro-step 3."""
    _, _, trainer, _, emas = runs[4]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))  # noqa: E731
    assert same(emas[0], emas[1])
    assert not same(emas[1], emas[2])
    assert same(emas[2], emas[3])
    assert trainer.opt.count == 1 and trainer.opt.mini_step == 1 and trainer.steps == 3


# ---------------------------------------------------------------- mechanics


def _tiny_params(seed: int):
    """A params tree with one leaf of each group and two weights (JAX nesting, port names)."""
    rng = np.random.default_rng(seed)
    tree = {"model_0": {"conv": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
                        "bn": {"gamma": rng.normal(size=(4, 2)).astype(np.float32),
                               "beta": rng.normal(size=(4, 2)).astype(np.float32)}},
            "model_1": {"proj": {"kernel": rng.normal(size=(5,)).astype(np.float32),
                                 "bias": rng.normal(size=(3,)).astype(np.float32)}}}
    names = {("model_0", "conv", "w"): "model.0.conv.w", ("model_0", "bn", "gamma"): "model.0.bn.gamma",
             ("model_0", "bn", "beta"): "model.0.bn.beta", ("model_1", "proj", "kernel"): "model.1.proj.kernel",
             ("model_1", "proj", "bias"): "model.1.proj.bias"}
    return tree, names


@pytest.mark.parametrize("nbs", [16, 32])
def test_optimizer_clips_each_group_by_its_own_norm(nbs):
    """Gradients whose group norms (weight ~60, norm ~25, bias ~15) all pass
    max_grad_norm 10 by different factors: the port's optimizer follows
    optax (clip per group, decay, Nesterov SGD, schedules, accumulation)
    through 6 micro-steps, and one clip over all parameters would not."""
    tree, names = _tiny_params(0)
    cfg = dict(epochs=5, batch=16, nbs=nbs, warmup_epochs=0.05, lr0=0.05)
    tx = jt.build_optimizer(jt.TrainConfig(**cfg), tree, steps_per_epoch=20)
    opt_state = tx.init(tree)
    params = {names[p]: torch.from_numpy(v.copy()) for p, v in _flatten(tree).items()}
    opt = tt.Optimizer(tt.TrainConfig(**cfg), params, steps_per_epoch=20)
    assert opt.groups == {"weight": [0, 3], "norm": [1], "bias": [2, 4]}
    paths = list(_flatten(tree))
    rng = np.random.default_rng(1)
    jparams = tree
    for _ in range(6):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        for key, s in (("model_0", 40.0), ("model_1", 25.0)):
            grads[key] = jax.tree_util.tree_map(lambda g: g * s, grads[key])
        grads["model_0"]["bn"]["gamma"] *= 0.6
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        flat = _flatten(grads)
        opt.step(list(params.values()), [torch.from_numpy(flat[p]) for p in paths])
    assert opt.count == 6 // (nbs // 16)
    for p, v in _flatten(jparams).items():
        assert_close(params[names[p]], v, rtol=1e-5, atol=1e-6, err_msg=names[p])
    # the groups' norms differ, so one clip over all leaves would scale them alike
    norms = {g: float(tt._foreach_norm([torch.from_numpy(flat[p]) for p in paths
                                        if tt._param_label(names[p]) == g])) for g in tt.GROUPS}
    assert min(norms.values()) > 10 and len({round(n) for n in norms.values()}) == 3, norms


def test_schedules_match_jax():
    """lr and momentum at update n, counted from 0: with warmup the first
    update has weight and norm lr 0, bias lr warmup_bias_lr, momentum
    warmup_momentum."""
    for cfg_kw in (dict(), dict(cos_lr=True), dict(warmup_epochs=0.0)):
        jcfg, tcfg = jt.TrainConfig(epochs=10, **cfg_kw), tt.TrainConfig(epochs=10, **cfg_kw)
        for spe, acc in ((50, 1), (50, 4), (300, 2)):
            jf, tf = jt.lr_schedule(jcfg, spe, acc), tt.lr_schedule(tcfg, spe, acc)
            for n in (0, 1, 7, 40, 200, 900):
                assert tf(n) == pytest.approx(float(jf(n)), rel=1e-6, abs=1e-12)
    cfg = tt.TrainConfig(batch=16)
    opt = tt.Optimizer(cfg, {"w": torch.zeros(1)}, steps_per_epoch=10)
    assert opt.accumulate == 4 and opt.wd == pytest.approx(5e-4)
    assert opt.lr("weight", 0) == opt.lr("norm", 0) == 0.0
    assert opt.lr("bias", 0) == pytest.approx(0.1) and opt.momentum(0) == pytest.approx(0.8)
    assert opt.momentum(10 ** 6) == pytest.approx(0.937)


def _port_trainer(nbs: int = 4):
    model = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", seed=3)
    cfg = tt.TrainConfig(epochs=10, batch=B, nbs=nbs, dtype="float32")
    return tt.Trainer(model, cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu")


def _snapshot(trainer):
    return ([t.detach().clone() for t in trainer.params + trainer.stats + trainer.ema
             + trainer.opt.trace + trainer.opt.acc],
            (trainer.steps, trainer.opt.count, trainer.opt.mini_step))


def test_nan_guard_keeps_the_whole_state():
    """A poisoned batch (one NaN pixel) leaves parameters, momentum, the
    accumulator, the counters, EMA and the batch statistics unchanged."""
    trainer = _port_trainer()
    trainer.step(_batch())  # mid-accumulation: the accumulator holds a gradient
    before, counters = _snapshot(trainer)
    bad = _batch()
    img = bad["img"].astype(np.float32) / 255.0
    img[0, 0, 0, 0] = np.nan
    bad["img"] = img
    loss, aux = trainer.step(bad)
    assert float(aux["nan_skipped"]) == 1.0 and not math.isfinite(float(loss))
    after, counters_after = _snapshot(trainer)
    assert counters_after == counters
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    loss, aux = trainer.step(_batch())  # and the next clean step updates
    assert float(aux["nan_skipped"]) == 0.0 and trainer.opt.count == 1


def test_checkpoint_roundtrip(tmp_path):
    trainer = _port_trainer()
    for _ in range(3):
        trainer.step(_batch())
    trainer.save_checkpoint(tmp_path / "last.pt", epoch=0)
    restored = _port_trainer()
    assert restored.restore_checkpoint(tmp_path / "last.pt") == 1
    assert _snapshot(restored)[1] == _snapshot(trainer)[1]
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(restored)[0], _snapshot(trainer)[0]))
    la, _ = trainer.step(_batch(1))
    lb, _ = restored.step(_batch(1))
    assert float(la) == float(lb)
