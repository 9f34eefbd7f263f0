"""The classification slice of the PyTorch port against the JAX package on the
CPU: the op core it needs (`qdense` with its gradient, the average pools,
`QDense`, `QuaternionDropout`), the five Q-WRN / Q-ResNet families in eval
and the nine factory names at full size, three SGD updates across a
milestone, the data functions, checkpoints both ways, the QUAN-YOLO11n-cls
graph with its `Classify` head, and both CLIs.

Weights are JAX trees drawn with numpy (shapes from ``jax.eval_shape``) and
carried into the port by ``load_jax_variables``; inputs are numpy draws from
a seed. Each test states its tolerance.
"""

import dataclasses
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io
import torch

import quan_ultralytics_tpu.classification.data as jdata
import quan_ultralytics_tpu.classification.models as jmodels
import quan_ultralytics_tpu.classification.train as jtrain
import quan_ultralytics_tpu_torch.classification.cli as tccli
import quan_ultralytics_tpu_torch.classification.data as tdata
import quan_ultralytics_tpu_torch.classification.models as tmodels
import quan_ultralytics_tpu_torch.classification.train as ttrain
import quan_ultralytics_tpu_torch.cli as tcli
from quan_ultralytics_tpu.models.block import QuaternionDropout as JaxQuaternionDropout
from quan_ultralytics_tpu.models.conv import QDense as JaxQDense
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.ops import pooling as jpool
from quan_ultralytics_tpu.ops.qconv import qdense as jax_qdense
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.models.block import QuaternionDropout
from quan_ultralytics_tpu_torch.models.conv import SCALE_FACTORS, QDense
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites
from quan_ultralytics_tpu_torch.ops import pooling as tpool
from quan_ultralytics_tpu_torch.ops.mappings import MAPPING_TYPES
from quan_ultralytics_tpu_torch.ops.qconv import qdense
from quan_ultralytics_tpu_torch.utils.weights import (export_jax_variables, from_jax_tree, load_jax_variables,
                                                       read_checkpoint)
from torch_port_helpers import assert_close, fill_variables, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _max_rel_err(got, ref) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ------------------------------------------------------------------ op core


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_qdense_matches_jax(dtype, bias):
    """x [3, 5, 4, 24] @ w [4, 24, 12] (+ b [4, 12]): f32 max abs error within
    1e-5 of max|ref| (both in full f32); bf16 within 1e-2 of max|ref| (bf16
    products, accumulation order differs)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24, 12)).astype(np.float32) / 5
    b = rng.normal(size=(4, 12)).astype(np.float32) if bias else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qdense(jnp.asarray(x, jdt), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = qdense(to_torch(x).to(tdt), to_torch(w), None if b is None else to_torch(b))
    assert got.dtype == tdt and got.shape == (3, 5, 4, 12)
    assert _max_rel_err(got, ref) <= (1e-5 if dtype == "float32" else 1e-2)
    if bias:  # the bias passes through the Hamilton signs: zero input gives b_r - b_i - b_j - b_k
        zero = qdense(torch.zeros(1, 4, 24), to_torch(w), to_torch(b))[0]
        sign = torch.tensor([[1.0, -1, -1, -1], [1, 1, -1, 1], [1, 1, 1, -1], [1, -1, 1, 1]])
        assert_close(zero, (sign @ to_torch(b)).numpy(), rtol=1e-6, atol=1e-6)


def test_qdense_gradient_matches_jax():
    """d/dx, d/dw, d/db of sum(qdense(x, w, b) * c) in f32 against jax.grad:
    max abs error within 1e-5 of each gradient's max|ref|."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16, 8)).astype(np.float32) / 4
    b = rng.normal(size=(4, 8)).astype(np.float32)
    c = rng.normal(size=(6, 4, 8)).astype(np.float32)
    ref = jax.grad(lambda x, w, b: (jax_qdense(x, w, b) * c).sum(), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (to_torch(a).requires_grad_() for a in (x, w, b))
    (qdense(tx, tw, tb) * to_torch(c)).sum().backward()
    for got, r in zip((tx.grad, tw.grad, tb.grad), ref):
        assert _max_rel_err(got, r) <= 1e-5


@pytest.mark.parametrize("kernel,stride,padding", [(2, None, 0), (3, 2, 1), (3, 1, 1), ((3, 2), (2, 1), (1, 0))])
def test_qavg_pool_matches_jax(kernel, stride, padding):
    """Average pool with the padding counted (every window over kh * kw):
    within 1e-6 of max|ref|."""
    x = np.random.default_rng(2).normal(size=(2, 9, 8, 4, 3)).astype(np.float32)
    ref = jpool.qavg_pool(jnp.asarray(x), kernel, stride, padding)
    got = tpool.qavg_pool(to_torch(x), kernel, stride, padding)
    assert got.shape == ref.shape
    assert _max_rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("keepdims", [True, False])
def test_qavg_pool_global_matches_jax(keepdims):
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 4, 6)).astype(np.float32)
    ref = jpool.qavg_pool_global(jnp.asarray(x), keepdims)
    got = tpool.qavg_pool_global(to_torch(x), keepdims)
    assert got.shape == ref.shape
    assert _max_rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("mapping", MAPPING_TYPES)
def test_qdense_draw_bounds_match_jax(mapping):
    """Per component d with scale s_d: w within sqrt(3) sqrt(2 / (1 + 5 s^2)) /
    sqrt(fi), b within s / sqrt(fi), in both packages, and each draw reaches
    past 0.95 of its bound (w: 64 x 48 values a component) or 0.8 (b: 48)."""
    f_in, f_out = 256, 192
    fi = f_in // 4
    jv = JaxQDense(f_in, f_out, mapping_type=mapping).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, fi)))
    tm = QDense(f_in, f_out, mapping_type=mapping)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    scales = SCALE_FACTORS[mapping]
    for w, b in ((np.asarray(jv["params"]["w"]), np.asarray(jv["params"]["b"])),
                 (tm.w.detach().numpy(), tm.b.detach().numpy())):
        assert w.shape == (4, fi, f_out // 4) and b.shape == (4, f_out // 4)
        for d, s in enumerate(scales):
            wb = math.sqrt(3.0) * math.sqrt(2.0 / (1.0 + 5.0 * s * s)) / math.sqrt(fi)
            bb = s / math.sqrt(fi)
            assert 0.95 * wb < np.abs(w[d]).max() <= wb
            assert 0.8 * bb < np.abs(b[d]).max() <= bb


def test_quaternion_dropout_is_the_identity_in_eval_and_at_zero():
    x = torch.randn(2, 3, 3, 4, 5)
    drop = QuaternionDropout(0.5).eval()
    assert drop(x) is x
    assert QuaternionDropout(0.0).train()(x) is x
    jx = jnp.asarray(x.numpy())
    assert (np.asarray(JaxQuaternionDropout(0.5).apply({}, jx, train=False)) == x.numpy()).all()


def test_quaternion_dropout_drops_whole_quaternions_without_rescale():
    """In train: each (b, h, w, c) keeps or zeroes all four components, kept
    values are unscaled (no 1 / (1 - p)), as the JAX module's."""
    x = torch.rand(4, 6, 6, 4, 8) + 0.5  # no zeros of its own
    got = QuaternionDropout(0.3, torch.Generator().manual_seed(0)).train()(x)
    kept = got != 0
    assert (kept == kept[:, :, :, :1]).all(), "the mask differs across the components"
    assert torch.equal(got[kept], x[kept])
    jgot = np.asarray(JaxQuaternionDropout(0.3).apply({}, jnp.asarray(x.numpy()), train=True,
                                                      rngs={"dropout": jax.random.PRNGKey(0)}))
    jkept = jgot != 0
    assert (jkept == jkept[:, :, :, :1]).all() and (jgot[jkept] == x.numpy()[jkept]).all()


def test_quaternion_dropout_keeps_one_minus_p():
    """The kept share of 200,000 quaternions within 5 binomial sigmas of 1 - p."""
    p, n = 0.2, 200_000
    x = torch.ones(1, 100, 100, 4, 20)
    kept = float((QuaternionDropout(p, torch.Generator().manual_seed(1)).train()(x)[..., 0, :] != 0)
                 .float().mean())
    assert abs(kept - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n), kept


# ------------------------------------------------------------------ the families


# (name, JAX module, port module, input size): reduced depth and width
FAMILIES = {
    "QWideResNet": (lambda mt: jmodels.QWideResNet(10, 1, 10, 0.0, mt),
                    lambda mt: tmodels.QWideResNet(10, 1, 10, 0.0, mt), 32),
    "QResNetCIFAR": (lambda mt: jmodels.QResNetCIFAR((1, 1, 1), 10, 0.0, 8, mt),
                     lambda mt: tmodels.QResNetCIFAR((1, 1, 1), 10, 0.0, 8, mt), 32),
    "QResNetImageNet": (lambda mt: jmodels.QResNetImageNet((1, 1, 1, 1), 20, 0.1, 16, mt),
                        lambda mt: tmodels.QResNetImageNet((1, 1, 1, 1), 20, 0.1, 16, mt), 64),
    "QWideResNetImageNet": (lambda mt: jmodels.QWideResNetImageNet(1, 20, 0.2, mt),
                            lambda mt: tmodels.QWideResNetImageNet(1, 20, 0.2, mt), 64),
    "QWRN16ImageNet": (lambda mt: jmodels.QWRN16ImageNet(1, 20, 0.2, mt),
                       lambda mt: tmodels.QWRN16ImageNet(1, 20, 0.2, mt), 64),
}
FAMILY_CASES = ([(f, "poincare") for f in FAMILIES if f != "QResNetImageNet"]
                + [("QResNetImageNet", mt) for mt in MAPPING_TYPES])


@pytest.mark.parametrize("family,mapping", FAMILY_CASES)
def test_family_eval_logits_match_jax(family, mapping):
    """Eval logits of each family (every mapping on QResNetImageNet), f32,
    batch 2: max abs error within 1e-4 of max|ref|."""
    make_jax, make_port, size = FAMILIES[family]
    jm, tm = make_jax(mapping), make_port(mapping)
    x = np.random.default_rng(4).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    v = jax_variables(jm, jnp.asarray(x[:1]), train=False, seed=5)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    load_jax_variables(tm, v).eval()
    with torch.no_grad():
        got = tm(to_torch(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _max_rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("name", sorted(jmodels.MODEL_FACTORIES))
def test_factory_names_match_jax_at_full_size(name):
    """The nine factory names at full width and depth: the same parameter
    count and the same state names (flax paths), parameters and IQBN
    statistics apart; shapes from ``jax.eval_shape``, the port built on the
    meta device."""
    nc = 1000 if name in ("qrn34_imagenet", "qrn18_i", "qwrn50_2", "qwrn16_4i") else 10
    size = 64 if nc == 1000 else 32
    jm = jmodels.create_model(name, nc, 0.1, "poincare")
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, size, size, 3)), train=False))
    with torch.device("meta"):
        tm = tmodels.create_model(name, nc, 0.1, "poincare")
    params = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    buffers = {n: tuple(b.shape) for n, b in tm.state_dict().items() if n not in params}
    for collection, port in (("params", params), ("batch_stats", buffers)):
        carried = {n: a.shape for n, a in from_jax_tree(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes[collection])).items()}
        assert carried == port, collection
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(math.prod(s) for s in params.values()) == n_jax


# ------------------------------------------------------------------ the train step


@pytest.fixture
def wrn10(monkeypatch):
    """A reduced factory name in both packages: QWideResNet(10, 1)."""
    monkeypatch.setitem(jmodels.MODEL_FACTORIES, "qwrn10_1",
                        lambda nc, drop, mt, dtype=None: jmodels.QWideResNet(10, 1, nc, drop, mt, dtype))
    monkeypatch.setitem(tmodels.MODEL_FACTORIES, "qwrn10_1",
                        lambda nc, drop, mt, dtype=None: tmodels.QWideResNet(10, 1, nc, drop, mt, dtype))
    return "qwrn10_1"


def _batch(seed, n=8, size=32, nc=10):
    rng = np.random.default_rng(seed)
    return {"img": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, nc, n).astype(np.int32)}


def _zero_trace(params):
    return {"trace": jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)), params), "count": 0}


def test_train_step_matches_jax_across_a_milestone(wrn10):
    """QWideResNet(10, 1), f32, drop 0: three SGD updates (Nesterov 0.9, wd
    1e-4) with the milestone at update 2, so the third takes lr 0.1 x 0.1.
    After each: loss within 1e-5 relative, the same accuracy, the lr the JAX
    schedule gives at that count, every parameter and IQBN statistic within
    1e-4 of its max|ref| (+ 1e-4 relative)."""
    cfg = jtrain.ClsConfig(model=wrn10, num_classes=10, dtype="float32", batch_size=8,
                           milestones=(2,), lr=0.1)
    jt = jtrain.ClsTrainer(cfg, steps_per_epoch=1)
    x0 = _batch(0)
    v = jax_variables(jt.model, jnp.asarray(x0["img"][:1]), train=False, seed=6)
    state = jtrain.ClsState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=jt.tx.init(v["params"]))
    step = jt.make_train_step()
    sched = jtrain.multistep_lr(cfg, 1)

    tt = ttrain.ClsTrainer(ttrain.ClsConfig(**dataclasses.asdict(cfg)), steps_per_epoch=1, device="cpu")
    tt.load_state_dict({**v, "opt_state": _zero_trace(v["params"]), "step": 0})
    lrs = []
    for i in range(3):
        batch = _batch(i)
        state, jloss, jacc = step(state, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(i))
        loss, acc = tt.train_step(batch)
        lrs.append(tt.optimizer.param_groups[0]["lr"])
        assert lrs[-1] == pytest.approx(float(sched(i)), rel=1e-7)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert float(acc) == float(jacc)
        assert tt.step == int(state.step) == i + 1
        got = export_jax_variables(tt.model)
        for collection in ("params", "batch_stats"):
            ref = from_jax_tree(jax.device_get(getattr(state, collection)))
            for name, arr in from_jax_tree(got[collection]).items():
                assert_close(arr, ref[name], rtol=1e-4, atol=1e-4, err_msg=f"update {i}: {name}")
    assert lrs == pytest.approx([0.1, 0.1, 0.01], rel=1e-6)


def test_sgd_equals_the_optax_chain():
    """torch SGD(momentum 0.9, nesterov, weight_decay) against optax
    add_decayed_weights + sgd(nesterov) over 5 steps with a milestone at 3, on
    random parameters and gradients: within 1e-6 of max|ref|."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(5)]
    cfg = ttrain.ClsConfig(milestones=(3,), lr=0.1, weight_decay=1e-2)
    tx = optax.chain(optax.add_decayed_weights(cfg.weight_decay),
                     optax.sgd(jtrain.multistep_lr(jtrain.ClsConfig(milestones=(3,), lr=0.1), 1),
                               momentum=0.9, nesterov=True))
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(to_torch(p0))
    opt = torch.optim.SGD([tp], lr=cfg.lr, momentum=0.9, nesterov=True, weight_decay=cfg.weight_decay)
    sched = ttrain.multistep_lr(cfg, 1)
    for i, g in enumerate(grads):
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = to_torch(g)
        opt.param_groups[0]["lr"] = sched(i)
        opt.step()
        assert_close(tp, np.asarray(jp), rtol=1e-6, atol=1e-6, err_msg=f"step {i}")


def test_train_step_with_dropout_runs_and_masks_only_in_train(wrn10):
    """drop_rate 0.3 (the wide blocks' element-wise dropout): the step runs
    with a finite loss; in train two mask draws give two outputs, in eval
    none is drawn (the JAX and torch generators cannot agree, so only the
    port is run)."""
    cfg = ttrain.ClsConfig(model=wrn10, num_classes=10, dtype="float32", drop_rate=0.3)
    tt = ttrain.ClsTrainer(cfg, steps_per_epoch=1, device="cpu")
    drops = [m for m in tt.model.modules() if isinstance(m, tmodels.Dropout)]
    assert len(drops) == 3 and all(d.generator is not None for d in drops)  # one a wide block
    loss, _ = tt.train_step(_batch(0))
    assert np.isfinite(float(loss))
    x = to_torch(_batch(1)["img"])
    with torch.no_grad():
        tt.model.train()
        a, b = tt.model(x), tt.model(x)
        assert not torch.equal(a, b)
        tt.model.eval()
        assert torch.equal(tt.model(x), tt.model(x))


def test_schedule_matches_optax():
    cfg = ttrain.ClsConfig(milestones=(30, 60, 90))
    ref = jtrain.multistep_lr(jtrain.ClsConfig(milestones=(30, 60, 90)), 7)
    got = ttrain.multistep_lr(cfg, 7)
    for count in (0, 1, 209, 210, 211, 419, 420, 629, 630, 5000):
        assert got(count) == float(ref(count)), count


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("train", [True, False])
def test_batches_equal_jax_bit_for_bit(train):
    """Train: cutout 8 and num_augments 2 (reflect pad, crop, flip draws);
    eval: 50 images at batch 16, the last batch padded by np.resize."""
    tx, ty, _, _ = jdata.make_synthetic(5, n_train=50, n_test=10, seed=3)
    kw = dict(train=True, cutout_len=8, num_augments=2, seed=11) if train else dict(train=False)
    ref = list(jdata.batches(tx, ty, 16, **kw))
    got = list(tdata.batches(tx, ty, 16, **kw))
    assert len(got) == len(ref) == (6 if train else 4)
    for g, r in zip(got, ref):
        for k in ("img", "label"):
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), k


def test_synthetic_cutout_and_mixup_equal_jax():
    for g, r in zip(tdata.make_synthetic(7, 64, 16, 24, seed=2), jdata.make_synthetic(7, 64, 16, 24, seed=2)):
        assert np.array_equal(g, r)
    im = np.arange(32 * 32 * 3, dtype=np.float32).reshape(32, 32, 3)
    assert np.array_equal(tdata.cutout(im, 12, np.random.default_rng(1)), jdata.cutout(im, 12, np.random.default_rng(1)))
    batch = next(tdata.batches(*tdata.make_synthetic(3, 32, 8)[:2], 16, train=False))
    g, r = (mod.mixup_batch(batch, 0.4, np.random.default_rng(5)) for mod in (tdata, jdata))
    assert np.array_equal(g[0]["img"], r[0]["img"]) and np.array_equal(g[1], r[1]) and g[2] == r[2]
    assert tdata.CIFAR10_POLICY == jdata.CIFAR10_POLICY


def _write_cifar(root, dataset, n=20, seed=0):
    """A folder in the CIFAR python-pickle format: uint8 rows [n, 3072], bytes keys."""
    rng = np.random.default_rng(seed)
    if dataset == "cifar10":
        base, files, key = root / "cifar-10-batches-py", [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], b"labels"
    else:
        base, files, key = root / "cifar-100-python", ["train", "test"], b"fine_labels"
    base.mkdir(parents=True)
    for f in files:
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             key: [int(v) for v in rng.integers(0, 10 if dataset == "cifar10" else 100, n)]}
        with open(base / f, "wb") as fh:
            pickle.dump(d, fh)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_load_cifar_equals_jax(tmp_path, dataset):
    _write_cifar(tmp_path, dataset)
    got, ref = tdata.load_cifar(str(tmp_path), dataset), jdata.load_cifar(str(tmp_path), dataset)
    n_train = 100 if dataset == "cifar10" else 20
    assert got[0].shape == (n_train, 32, 32, 3) and got[0].dtype == np.uint8
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def test_load_svhn_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    for split, n in (("train", 12), ("test", 5)):
        scipy.io.savemat(tmp_path / f"{split}_32x32.mat",
                         {"X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
                          "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})
    got, ref = tdata.load_svhn(str(tmp_path)), jdata.load_svhn(str(tmp_path))
    assert got[0].shape == (12, 32, 32, 3) and set(got[1]) <= set(range(10))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


IMAGENET_SIZES = [(375, 500), (500, 375), (480, 640), (240, 320), (300, 301)]  # (h, w)


@pytest.fixture(scope="module")
def imagenet_folder(tmp_path_factory):
    """train/ and val/ of 3 classes, 5 PNG images a class at mixed frame
    sizes: a smooth gradient with a class colour and noise."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(3):
            (root / split / f"n0{c}").mkdir(parents=True)
            for i, (h, w) in enumerate(IMAGENET_SIZES):
                yy, xx = np.mgrid[0:h, 0:w]
                im = np.stack([xx * 255 // w, yy * 255 // h, np.full_like(xx, 60 * c)], -1)
                im = np.clip(im + rng.integers(-20, 21, im.shape), 0, 255).astype(np.uint8)
                imwrite_png(root / split / f"n0{c}" / f"im{i}.png", im)
    return root


@pytest.mark.parametrize("train", [True, False])
def test_imagenet_batches_within_one_gray_level_of_jax(imagenet_folder, train):
    """The folder loader against the JAX one (cv2) on 15 PNG images at batch
    4: the same files, labels and crop draws; pixels (un-normalized, in /255
    units) within one gray level. OpenCV rounds its bilinear weights to 11
    bits (about 0.12 of a level on a 255 value), so a value whose exact sum
    lies that near a half rounds the other way: 11.4% (eval) and 12.1%
    (train) of the values here, held under 15%."""
    split = "train" if train else "val"
    files, labels, classes = tdata.imagenet_folder_samples(str(imagenet_folder), split)
    assert (files, list(labels), classes) == tuple(
        (a if i != 1 else list(a)) for i, a in enumerate(jdata.imagenet_folder_samples(str(imagenet_folder), split)))
    got = list(tdata.imagenet_batches(files, labels, 4, train=train, size=64, seed=3, workers=2))
    ref = list(jdata.imagenet_batches(files, labels, 4, train=train, size=64, seed=3, workers=2))
    assert len(got) == len(ref) == (3 if train else 4)
    unequal = total = 0
    for g, r in zip(got, ref):
        assert np.array_equal(g["label"], r["label"])
        assert g["img"].shape == r["img"].shape == (4, 64, 64, 3)
        gl, rl = ((b["img"] * tdata.IMAGENET_STD + tdata.IMAGENET_MEAN) * 255 for b in (g, r))
        diff = np.abs(gl - rl)
        assert diff.max() <= 1 + 1e-3, diff.max()
        unequal += int((diff > 1e-3).sum())
        total += diff.size
    assert unequal <= 0.15 * total, unequal / total


def test_autoaugment_raises_naming_its_item():
    """AutoAugment is ported: it no longer raises. The function returns a
    uint8 image of the input's shape, and the CLI's flag parses and is routed
    (tests/test_torch_autoaugment.py holds both to the JAX package)."""
    out = tdata.autoaugment(np.zeros((32, 32, 3), np.uint8), np.random.default_rng(0))
    assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
    assert tccli.build_parser().parse_args(["--autoaugment"]).autoaugment


# ------------------------------------------------------------------ checkpoints


def test_jax_checkpoint_resumes_in_the_port(wrn10, tmp_path):
    """A checkpoint that the JAX ExperimentManager writes (optax state
    pickled) restores params, batch_stats, momentum trace and step exactly."""
    cfg = jtrain.ClsConfig(model=wrn10, exp_dir=str(tmp_path), dtype="float32")
    jt = jtrain.ClsTrainer(cfg, steps_per_epoch=1)
    v = jax_variables(jt.model, jnp.zeros((1, 32, 32, 3)), train=False, seed=8)
    opt = jt.tx.init(v["params"])
    trace = fill_variables(v["params"], seed=9)
    opt = (opt[0], (opt[1][0]._replace(trace=trace), opt[1][1]._replace(count=jnp.asarray(7, jnp.int32))))
    state = jtrain.ClsState(step=jnp.asarray(7, jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=opt)
    exp = jtrain.ExperimentManager(cfg, name="jax")
    exp.save_checkpoint(state, 3, 0.25)
    payload = read_checkpoint(exp.dir / "last.pkl")
    assert payload["epoch"] == 3 and payload["step"] == 7
    assert ttrain.read_opt_state(payload["opt_state"])[1] == 7
    tt = ttrain.ClsTrainer(ttrain.ClsConfig(**dataclasses.asdict(cfg)), steps_per_epoch=1, device="cpu")
    tt.load_state_dict(payload)
    assert tt.step == 7
    got = export_jax_variables(tt.model)
    for collection in ("params", "batch_stats"):
        ref = from_jax_tree(v[collection])
        for name, arr in from_jax_tree(got[collection]).items():
            assert np.array_equal(arr, ref[name]), name
    ref = from_jax_tree(trace)
    for name, p in tt.model.named_parameters():
        buf = tt.optimizer.state[p]["momentum_buffer"]
        assert np.array_equal(buf.numpy(), ref[name]), name


def test_port_checkpoint_applies_in_jax(wrn10, tmp_path):
    """A port checkpoint's params and batch_stats, read with pickle, run in the
    JAX model with equal eval logits (within 1e-4 of max|ref|); its opt_state
    resumes the port's momentum and step."""
    cfg = ttrain.ClsConfig(model=wrn10, exp_dir=str(tmp_path), dtype="float32")
    tt = ttrain.ClsTrainer(cfg, steps_per_epoch=4, device="cpu")
    tt.train_step(_batch(0))
    tt.train_step(_batch(1))
    exp = ttrain.ExperimentManager(cfg, name="port")
    exp.save_checkpoint(tt, 0, 0.5)
    assert {p.name for p in exp.dir.iterdir()} == {"config.json", "checkpoint_epoch0.pkl", "last.pkl",
                                                    "best_model.pkl"}
    with open(exp.dir / "best_model.pkl", "rb") as fh:
        payload = pickle.load(fh)
    assert set(payload) == {"epoch", "params", "batch_stats", "opt_state", "step", "val_acc"}
    x = _batch(2)["img"]
    jm = jmodels.create_model(wrn10, 10)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]}, jnp.asarray(x))
    tt.model.eval()
    with torch.no_grad():
        got = tt.model(to_torch(x))
    assert _max_rel_err(got, ref) <= 1e-4
    back = ttrain.ClsTrainer(cfg, steps_per_epoch=4, device="cpu")
    back.load_state_dict(read_checkpoint(exp.dir / "last.pkl"))
    assert back.step == 2
    for (n, p), q in zip(tt.model.named_parameters(), back.model.parameters()):
        assert torch.equal(tt.optimizer.state[p]["momentum_buffer"], back.optimizer.state[q]["momentum_buffer"]), n


def test_experiment_manager_keeps_the_last_five(wrn10, tmp_path):
    cfg = ttrain.ClsConfig(model=wrn10, exp_dir=str(tmp_path), dtype="float32")
    tt = ttrain.ClsTrainer(cfg, steps_per_epoch=1, device="cpu")
    exp = ttrain.ExperimentManager(cfg, name="keep")
    for epoch, acc in enumerate((0.1, 0.3, 0.2, 0.3, 0.4, 0.1, 0.2)):
        exp.save_checkpoint(tt, epoch, acc)
    assert sorted(p.name for p in exp.dir.glob("checkpoint_epoch*.pkl")) == [
        f"checkpoint_epoch{e}.pkl" for e in range(2, 7)]
    assert read_checkpoint(exp.dir / "best_model.pkl")["epoch"] == 4
    assert read_checkpoint(exp.dir / "last.pkl")["epoch"] == 6


# ------------------------------------------------------------------ QUAN-YOLO11n-cls


@pytest.fixture(scope="module")
def cls_pair():
    """(JAX model, its seeded variables, the port model carrying them, input, JAX logits)."""
    jm = JaxDetectionModel.from_yaml("yolo11n-cls-quan.yaml", nc=10)
    x = np.random.default_rng(10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    v = jax_variables(jm.module, jnp.asarray(x[:1]), train=False, seed=11)
    ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(DetectionModel.from_yaml("yolo11n-cls-quan.yaml", nc=10, device="cpu"), v)
    return jm, v, tm, x, np.asarray(ref)


def test_yolo_cls_logits_match_jax(cls_pair):
    """yolo11n-cls-quan, nc 10, imgsz 64, f32, plain paths: logits within 1e-4
    of max|ref|; decode hands them back as they are."""
    jm, _, tm, x, ref = cls_pair
    assert jm.task == tm.task == "classify" and tm.strides == () and tm.nc == 10
    with torch.no_grad():
        got = tm(to_torch(x))
    assert got.shape == ref.shape == (2, 10)
    assert _max_rel_err(got, ref) <= 1e-4
    assert tm.decode(got) is got


def test_yolo_cls_fused_1x1_plain_path_gives_the_same_logits(cls_pair):
    """With fused_1x1=True every 1x1 Conv (the Classify conv, Ci 64 -> Co 320
    a component, among them) takes K3's plain version on the CPU: within
    1e-4 of max|ref|."""
    _, v, _, x, ref = cls_pair
    tm = load_jax_variables(DetectionModel.from_yaml("yolo11n-cls-quan.yaml", nc=10, device="cpu",
                                                     fused_1x1=True), v)
    sites = fused_1x1_sites(tm, 2, 64)
    assert len(sites) == 19 and sites[-1] == (64, 320, 2 * 2 * 2)
    with torch.no_grad():
        got = tm(to_torch(x))
    assert _max_rel_err(got, ref) <= 1e-4


def test_yolo_cls_weights_carry_both_ways(cls_pair):
    """Every leaf, the 2-D Dense kernel of ``linear`` included ([in, out] in
    flax, [out, in] in the port), carries there and back unchanged."""
    _, v, tm, _, _ = cls_pair
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(v["params"]))
    k = np.asarray(v["params"]["model_10"]["linear"]["kernel"])
    assert k.shape == (1280, 10)
    assert np.array_equal(tm.model[10].linear.weight.detach().numpy(), k.T)
    back = export_jax_variables(tm)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        assert np.array_equal(flat_b[path], np.asarray(a)), path


def test_yolo_cls_full_size_draws_the_linear_from_the_seed():
    """At nc 1000: 1,671,272 parameters; ``from_yaml``'s seed draws the
    Classify linear (lecun normal: std sqrt(1 / 1280)) as it draws the convs."""
    a = DetectionModel.from_yaml("yolo11n-cls-quan.yaml", device="cpu", seed=0)
    b = DetectionModel.from_yaml("yolo11n-cls-quan.yaml", device="cpu", seed=0)
    c = DetectionModel.from_yaml("yolo11n-cls-quan.yaml", device="cpu", seed=1)
    assert sum(p.numel() for p in a.parameters()) == 1_671_272 and a.nc == 1000
    wa, wb, wc = (m.model[10].linear.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert abs(float(wa.detach().std()) - math.sqrt(1 / 1280)) < 0.02 * math.sqrt(1 / 1280)


# ------------------------------------------------------------------ the CLIs


def test_classify_flag_translation_matches_jax(monkeypatch, tmp_path):
    """yolo-style keys -> the classification CLI's flags, as the JAX CLI maps them."""
    import quan_ultralytics_tpu.classification.cli as jccli
    from quan_ultralytics_tpu import cli as jcli

    seen = {}
    for mod, cli in ((tccli, tcli), (jccli, jcli)):
        monkeypatch.setattr(mod, "main", lambda flags, mod=mod: seen.__setitem__(mod, flags) or 0)
        for argv in (["data=synthetic", "epochs=1", "batch=32", "lr0=0.05"],
                     [f"data={tmp_path}", "model=qrn34_imagenet", "mapping=hamilton"]):
            assert cli.main(["classify", "train", *argv]) == 0
            assert seen.pop(mod) == (tcli.classify_flags(tcli.parse_kv(argv)))
    assert tcli.classify_flags({"data": "cifar10", "batch": 64, "lr0": 0.05}) == [
        "--dataset", "cifar10", "--batch_size", "64", "--lr", "0.05"]
    assert tcli.classify_flags({"data": str(tmp_path)})[:2] == ["--dataset", "imagenet"]
    with pytest.raises(SystemExit, match="known dataset or folder"):
        tcli.main(["classify", "train", "data=nowhere"])
    with pytest.raises(SystemExit, match="mode=train"):
        tcli.main(["classify", "val", "data=synthetic"])


def test_yolo_torch_classify_train_synthetic_on_cpu(tmp_path):
    """`yolo-torch classify train data=synthetic ... device=cpu` trains one
    epoch of Q-WRN-16-2 and writes metrics.json and the checkpoints; a
    ``--resume`` of its last.pkl with ``--epochs 2`` runs epoch 1 alone."""
    rc = tcli.main(["classify", "train", "data=synthetic", "epochs=1", "batch=64", "model=qwrn16_2",
                    f"exp_dir={tmp_path / 'a'}", "device=cpu"])
    assert rc == 0
    (run,) = (tmp_path / "a").iterdir()
    rows = __import__("json").loads((run / "metrics.json").read_text())
    assert [r["epoch"] for r in rows] == [0] and set(rows[0]) == {"epoch", "train_loss", "train_acc", "lr",
                                                                 "top1", "top5"}
    assert (run / "last.pkl").exists() and (run / "best_model.pkl").exists()
    assert tccli.main(["--dataset", "synthetic", "--epochs", "2", "--batch_size", "64", "--device", "cpu",
                       "--resume", str(run / "last.pkl"), "--exp_dir", str(tmp_path / "b")]) == 0
    (run,) = (tmp_path / "b").iterdir()
    rows = __import__("json").loads((run / "metrics.json").read_text())
    assert [r["epoch"] for r in rows] == [1]
    assert read_checkpoint(run / "last.pkl")["step"] == 16  # 8 updates an epoch, resumed at 8


def test_classify_needs_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: tcli.main(["classify", "train", "data=synthetic", f"exp_dir={tmp_path}"]),
                lambda: tccli.main(["--dataset", "synthetic", "--exp_dir", str(tmp_path)])):
        with pytest.raises(SystemExit) as e:
            run()
        assert "no CUDA device" in str(e.value.code)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.ClsTrainer(ttrain.ClsConfig(), steps_per_epoch=1)
    assert not list(tmp_path.iterdir())
