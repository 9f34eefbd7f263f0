"""User model YAMLs and the last YAML modules of the PyTorch port against the
JAX package on the CPU: the port's model-YAML reader against ``yaml.safe_load``;
``resolve_model_cfg`` on a path; the activations, ``IQLN``, ``C2f``, ``QPSA``,
``QERPreserve`` and ``HybridDetect`` forward and backward (f32 and bf16); the
``yolo11n-hybrid-quan`` model (yolo11-quan with QPSA, C2f and HybridDetect)
reached by its YAML's path, end to end; ``Ensemble``; and the conv form that
each ``QConv2D`` picks under ``impl="auto"`` in a detection train step, a
classification train step and eval.

Weights are JAX trees drawn with numpy (shapes from ``jax.eval_shape``) and
carried into the port by ``load_jax_variables``; inputs are numpy draws from a
seed. Each test states its tolerance. QPSA's attention runs its plain version
on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import quan_ultralytics_tpu.classification.models as jcm
import quan_ultralytics_tpu.ops.qconv as jqconv
from quan_ultralytics_tpu.engine import trainer as jt
from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO
from quan_ultralytics_tpu.losses import detect as jd
from quan_ultralytics_tpu.models import block as jb
from quan_ultralytics_tpu.models import conv as jc
from quan_ultralytics_tpu.models import head as jh
from quan_ultralytics_tpu.models.ensemble import Ensemble as JaxEnsemble
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.models.tasks import resolve_model_cfg as jax_resolve_model_cfg
from quan_ultralytics_tpu.ops import activations as ja
from quan_ultralytics_tpu_torch import cli as tcli
from quan_ultralytics_tpu_torch.cfg.model_yaml import load_model_yaml, parse_model_yaml
from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.engine import trainer as tt
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.losses import detect as td
from quan_ultralytics_tpu_torch.models import block as tb
from quan_ultralytics_tpu_torch.models import conv as tc
from quan_ultralytics_tpu_torch.models import head as th
from quan_ultralytics_tpu_torch.models.ensemble import Ensemble
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites, resolve_model_cfg
from quan_ultralytics_tpu_torch.ops import activations as ta
from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables, from_jax_tree, load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

JAX_MODELS = Path(jc.__file__).resolve().parent.parent / "cfg" / "models"
HYBRID = "yolo11n-hybrid-quan.yaml"
# the JAX package's cfg/models/yolo11-quan.yaml with QPSA at layer 10, C2f at layers 13, 16, 19
# and 22 (their C3k2 args) and the HybridDetect head
HYBRID_YAML = """\
# yolo11n-hybrid-quan: QUAN-YOLO11 with QPSA, C2f and HybridDetect
nc: 80
scales: # [depth, width, max_channels]
  n: [0.50, 0.25, 1024]
  s: [0.50, 0.50, 1024]
  m: [0.50, 1.00, 512]
  l: [1.00, 1.00, 512]
  x: [1.00, 1.50, 512]

backbone:
  # [from, repeats, module, args]
  - [-1, 1, Conv, [64, 3, 2]]           # 0  P1/2
  - [-1, 1, Conv, [128, 3, 2]]          # 1  P2/4
  - [-1, 2, C3k2, [256, False, 0.25]]   # 2
  - [-1, 1, Conv, [256, 3, 2]]          # 3  P3/8
  - [-1, 2, C3k2, [512, False, 0.25]]   # 4
  - [-1, 1, Conv, [512, 3, 2]]          # 5  P4/16
  - [-1, 2, C3k2, [512, True]]          # 6
  - [-1, 1, Conv, [1024, 3, 2]]         # 7  P5/32
  - [-1, 2, C3k2, [1024, True]]         # 8
  - [-1, 1, QSPPF, [1024, 5]]           # 9
  - [-1, 1, QPSA, [1024]]               # 10

head:
  - [-1, 1, QUpsample, [2, nearest]]    # 11
  - [[-1, 6], 1, Concat, [1]]           # 12 cat P4
  - [-1, 2, C2f, [512, False]]          # 13

  - [-1, 1, QUpsample, [2, nearest]]    # 14
  - [[-1, 4], 1, Concat, [1]]           # 15 cat P3
  - [-1, 2, C2f, [256, False]]          # 16 (P3/8-small)

  - [-1, 1, Conv, [256, 3, 2]]          # 17
  - [[-1, 13], 1, Concat, [1]]          # 18 cat P4
  - [-1, 2, C2f, [512, False]]          # 19 (P4/16-medium)

  - [-1, 1, Conv, [512, 3, 2]]          # 20
  - [[-1, 10], 1, Concat, [1]]          # 21 cat P5
  - [-1, 2, C2f, [1024, True]]          # 22 (P5/32-large)

  - [[16, 19, 22], 1, HybridDetect, [nc]]  # 23
"""
RTOL, ATOL = 2e-4, 2e-5  # f32 forwards: summation order only (tests/test_torch_modules.py)
GRAD_F32 = 1e-4  # f32 gradients: max abs error within this of the leaf's max |ref|
# bf16 forwards and gradients: within this of max |ref|. Both packages round every op's
# output to bf16 (XLA's CPU convs and torch's accumulate in f32), at different points of the
# conv + mixing chain: a few bf16 ulps (2^-8 relative each) through a block
BF16 = 5e-2


@pytest.fixture(scope="module")
def hybrid_path(tmp_path_factory) -> Path:
    path = tmp_path_factory.mktemp("user_models") / HYBRID
    path.write_text(HYBRID_YAML)
    return path


def _rel(got, ref) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------ the model-YAML reader


@pytest.mark.parametrize("name", sorted(p.name for p in JAX_MODELS.glob("*.yaml")) + [HYBRID])
def test_model_yaml_reader_equals_safe_load(name):
    text = HYBRID_YAML if name == HYBRID else (JAX_MODELS / name).read_text()
    assert parse_model_yaml(text, name) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: [1, , 2]\n", "a: [1, [2]\n", "a: {b: 1}\n", "a: [1] 2\n",
                                  "a:\n  b:\n    c: 1\n", "  - [1]\n", "a:\n  - [1]\n  b: 2\n",
                                  "a: 1\na: 2\n"])
def test_model_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_model_yaml(text)


@pytest.mark.parametrize("name", [HYBRID, "yolo11s-hybrid-quan.yaml", "hybrid.yaml"])
def test_resolve_model_cfg_takes_a_path_as_jax_does(tmp_path, name):
    """The scale letter follows the file name's architecture number, else the
    config's first scale; the file is read, not the catalog."""
    path = tmp_path / name
    path.write_text(HYBRID_YAML)
    assert resolve_model_cfg(path) == jax_resolve_model_cfg(str(path))
    assert load_model_yaml(path) == yaml.safe_load(HYBRID_YAML)
    with pytest.raises(FileNotFoundError):
        resolve_model_cfg(tmp_path / "missing" / "yolo11n-nothing.yaml")


# ------------------------------------------------------------------ activations and IQLN


def _activation_case(name):
    """(JAX function, port function) of ``ACTIVATIONS[name]``, PReLU with a seeded slope."""
    if name == "prelu":
        alpha = np.random.default_rng(3).uniform(0.05, 0.3, (6,)).astype(np.float32)
        return (lambda x: ja.qprelu(x, jnp.asarray(alpha, x.dtype)),
                lambda x: ta.qprelu(x, to_torch(alpha).to(x.dtype)))
    return ja.ACTIVATIONS[name], ta.ACTIVATIONS[name]


def test_activation_table_matches_jax():
    assert list(ta.ACTIVATIONS) == list(ja.ACTIVATIONS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ja.ACTIVATIONS) + ["prelu"])
def test_activation_and_gradient_match_jax(name, dtype):
    """x [2, 3, 3, 4, 6] N(0, 1.5): values and d/dx of sum(f(x) c) against JAX;
    f32 within 1e-6 of max|ref| (values) and 1e-5 (gradients), bf16 within 2e-2
    (one or two bf16 ulps of the largest)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 3, 3, 4, 6)) * 1.5).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)
    jf, tf = _activation_case(name)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref, rgrad = jax.value_and_grad(lambda a: (jf(a).astype(jnp.float32) * c).sum())(jnp.asarray(x, jdt))
    ref_y = jf(jnp.asarray(x, jdt))
    tx = to_torch(x).to(tdt).requires_grad_()
    y = tf(tx)
    (y.float() * to_torch(c)).sum().backward()
    assert y.dtype == tdt and y.shape == x.shape
    tol = (1e-6, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    assert _rel(y, ref_y) <= tol[0]
    assert _rel(tx.grad, rgrad) <= tol[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iqln_and_gradient_match_jax(dtype):
    """IQLN(24) on x [2, 5, 4, 4, 6]: values within 2e-5 of max|ref| in f32 (2e-2
    in bf16: the output is cast to bf16); d/dx, d/dweight, d/dbias of sum(y c)
    within 1e-4 (f32) and BF16 (bf16) of each gradient's max|ref|."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 5, 4, 4, 6)) * 2 + 0.5).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)
    params = {"weight": rng.uniform(0.5, 1.5, (4, 6)).astype(np.float32),
              "bias": (rng.normal(size=(4, 6)) * 0.1).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm, tm = jc.IQLN(24), tc.IQLN(24)

    def loss(p, a):
        return (jm.apply({"params": p}, a).astype(jnp.float32) * c).sum()

    ref = jm.apply({"params": params}, jnp.asarray(x, jdt))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x, jdt))
    load_jax_variables(tm, {"params": params})
    tx = to_torch(x).to(tdt).requires_grad_()
    y = tm(tx)
    (y.float() * to_torch(c)).sum().backward()
    assert y.dtype == tdt
    assert _rel(y, ref) <= (2e-5 if dtype == "float32" else 2e-2)
    gtol = GRAD_F32 if dtype == "float32" else BF16
    assert _rel(tx.grad, gx) <= gtol
    assert _rel(tm.weight.grad, gp["weight"]) <= gtol and _rel(tm.bias.grad, gp["bias"]) <= gtol


# ------------------------------------------------------------------ C2f, QPSA, QERPreserve, HybridDetect


def _module_case(name, dtype):
    """(JAX module, port module, inputs, whether the module takes ``train``)."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)
    rng = np.random.default_rng(6)

    def bhwqc(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name.startswith("C2f"):
        shortcut = name.endswith("shortcut")
        return (jb.C2f(32, 32, 2, shortcut, dtype=jdt), tb.C2f(32, 32, 2, shortcut, dtype=tdt, impl="auto"),
                [bhwqc(2, 6, 6, 4, 8)], True)
    if name == "QPSA":
        return jb.QPSA(64, 64, dtype=jdt), tb.QPSA(64, 64, dtype=tdt, impl="auto"), [bhwqc(2, 5, 4, 4, 16)], True
    if name == "QERPreserve":
        return jh.QERPreserve(24, 10, dtype=jdt), th.QERPreserve(24, 10, dtype=tdt), [bhwqc(2, 5, 4, 4, 6)], False
    ch, strides = (16, 32, 64), (8, 16, 32)
    xs = [bhwqc(2, 8 // 2 ** i, 8 // 2 ** i, 4, c // 4) for i, c in enumerate(ch)]
    return (jh.HybridDetect(5, ch, strides, dtype=jdt), th.HybridDetect(5, ch, strides, dtype=tdt, impl="auto"),
            xs, True)


MODULES = ["C2f", "C2f shortcut", "QPSA", "QERPreserve", "HybridDetect"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODULES)
def test_module_and_gradients_match_jax(name, dtype):
    """Eval forward, and the gradients of sum(out c) with respect to every
    parameter and the input(s), against ``jax.grad``: in f32 the outputs within
    RTOL/ATOL and each gradient within GRAD_F32 of its max|ref|; in bf16 (the
    module's compute dtype, f32 parameters) the outputs and each gradient within
    BF16 of max|ref|."""
    jm, tm, xs, takes_train = _module_case(name, dtype)
    jx = [jnp.asarray(x) for x in xs]
    arg = jx if name == "HybridDetect" else jx[0]
    v = jax_variables(jm, arg, **({"train": False} if takes_train else {}), seed=7)
    stats = v.get("batch_stats", {})
    out_shapes = jax.eval_shape(lambda v, a: jm.apply(v, a, **({"train": False} if takes_train else {})), v, arg)
    outs = out_shapes if isinstance(out_shapes, list) else [out_shapes]
    rng = np.random.default_rng(8)
    cts = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def loss(p, a):
        out = jm.apply({"params": p, "batch_stats": stats}, a, **({"train": False} if takes_train else {}))
        out = out if isinstance(out, list) else [out]
        return sum((o.astype(jnp.float32) * c).sum() for o, c in zip(out, cts)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(v["params"], arg)
    load_jax_variables(tm, v).eval()
    tx = [to_torch(x).requires_grad_() for x in xs]
    got = tm(tx if name == "HybridDetect" else tx[0])
    got = got if isinstance(got, list) else [got]
    total = sum((o.float() * to_torch(c)).sum() for o, c in zip(got, cts))
    total.backward()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if dtype == "float32":
            assert_close(g, r, rtol=RTOL, atol=ATOL)
        else:
            assert g.dtype == torch.bfloat16 and _rel(g, r) <= BF16
    tol = GRAD_F32 if dtype == "float32" else BF16
    gx = gx if isinstance(gx, list) else [gx]
    for t, r in zip(tx, gx):
        assert _rel(t.grad, r) <= tol, "input"
    ref_params = from_jax_tree(gp)
    for n, p in tm.named_parameters():
        assert _rel(p.grad, ref_params[n]) <= tol, n


def test_qerpreserve_draws_xavier_normal():
    """QERPreserve's mix kernel: std within 3% of flax's xavier_normal (sqrt(2 / (fan_in
    + fan_out)), the truncation's correction included), bounded at 2 sigma; bias 0."""
    m = th.QERPreserve(256, 64, k=3)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.mix.weight.detach()
    std = (2.0 / (256 * 9 + 64 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.03
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(m.mix.bias.detach().abs().max()) == 0.0
    jv = jh.QERPreserve(256, 64, k=3).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4, 64)))
    assert abs(float(np.std(np.asarray(jv["params"]["mix"]["kernel"]))) / std - 1) < 0.03


# ------------------------------------------------------------------ the hybrid model, end to end


@pytest.fixture(scope="module")
def hybrid_pair(hybrid_path):
    """(JAX model, its seeded variables, the port model carrying them, input, JAX head outputs)."""
    jm = JaxDetectionModel.from_yaml(str(hybrid_path))
    x = np.random.default_rng(10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    v = jax_variables(jm.module, jnp.asarray(x[:1]), train=False, seed=11)
    ref = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    tm = load_jax_variables(DetectionModel.from_yaml(hybrid_path, device="cpu"), v)
    return jm, v, tm, x, [np.asarray(r) for r in ref]


def test_hybrid_graph_matches_jax(hybrid_pair):
    jm, _, tm, _, _ = hybrid_pair
    assert [s.module for s in tm.specs] == [s.module for s in jm.specs]
    assert [(s.f, s.args, s.c2, s.stride) for s in tm.specs] == [(s.f, s.args, s.c2, s.stride) for s in jm.specs]
    assert tm.task == jm.task == "detect" and tm.nc == jm.nc == 80 and tm.strides == tuple(jm.strides)


def test_hybrid_head_outputs_decode_and_loss_match_jax(hybrid_pair):
    """Scale n, imgsz 64, batch 2, f32: the head's three maps within RTOL/ATOL,
    the decoded predictions within 1e-5 of max|ref| of each column group, and
    the detection loss (f32 assigner) of a seeded batch within 1e-4 relative."""
    jm, v, tm, x, ref = hybrid_pair
    with torch.no_grad():
        got = tm(to_torch(x))
    for g, r in zip(got, ref):
        assert_close(g, r, rtol=RTOL, atol=ATOL)
    dec_ref = np.asarray(jm.decode([jnp.asarray(r) for r in ref]))
    dec = tm.decode(got)
    for sl in (slice(0, 4), slice(4, None)):
        assert _rel(dec[..., sl], dec_ref[..., sl]) <= 1e-5
    rng = np.random.default_rng(12)
    B, M = 2, 6
    batch = {"cls": rng.integers(0, 80, (B, M)).astype(np.int32),
             "bboxes": np.concatenate([rng.uniform(0.3, 0.7, (B, M, 2)), rng.uniform(0.1, 0.4, (B, M, 2))],
                                      -1).astype(np.float32),
             "mask": np.arange(M)[None] < np.array([[4], [2]])}
    jl, _ = jd.detection_loss([jnp.asarray(r) for r in ref], {k: jnp.asarray(a) for k, a in batch.items()},
                              jm.strides, jm.nc, assigner_bf16=False)
    tl, _ = td.detection_loss(got, {k: to_torch(a) for k, a in batch.items()}, tm.strides, tm.nc,
                              assigner_bf16=False)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))


def test_hybrid_fused_1x1_sites(hybrid_path):
    """``fused_1x1`` routes the 28 1x1 Convs of C3k2, QSPPF, QPSA (cv1, ffn0, ffn1,
    cv2) and C2f (cv1, cv2) to K3; the plain path gives the same decoded
    predictions on the CPU (within 1e-5 of max|ref|)."""
    model = DetectionModel.from_yaml(hybrid_path, device="cpu", fused_1x1=True)
    sites = fused_1x1_sites(model, 2, 64)
    assert len(sites) == 28
    plain = DetectionModel.from_yaml(hybrid_path, device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert _rel(model.decode(model(x)), plain.decode(plain(x))) <= 1e-5


def test_hybrid_reaches_the_facade_the_pkl_and_the_cli(hybrid_path, tmp_path, capsys):
    """``YOLO(<path>)`` builds the hybrid model; a facade ``.pkl`` naming the YAML's
    path builds it in both packages with the same weights; ``yolo-torch detect
    predict model=<path>`` runs on the CPU."""
    y = YOLO(str(hybrid_path), device="cpu")
    assert y.task == "detect" and y.model_yaml == str(hybrid_path)
    tree = export_jax_variables(y.model)
    pkl = tmp_path / "hybrid.pkl"
    import pickle

    pkl.write_bytes(pickle.dumps({"model_yaml": str(hybrid_path), "nc": 80, "names": None, **tree,
                                  "raw_params": tree["params"], "step": 0}))
    back, jy = YOLO(str(pkl), device="cpu"), JaxYOLO(str(pkl))
    assert back.model_yaml == jy.model_yaml == str(hybrid_path)
    assert [s.module for s in jy.model.specs] == [s.module for s in back.model.specs]
    for (n, a), b in zip(y.model.state_dict().items(), back.model.state_dict().values()):
        assert torch.equal(a, b), n
    img = tmp_path / "im.png"
    imwrite_png(img, np.random.default_rng(13).integers(0, 256, (48, 64, 3), dtype=np.uint8))
    assert tcli.main(["detect", "predict", f"model={hybrid_path}", f"source={img}", "imgsz=64",
                      "device=cpu"]) == 0
    assert "image 1/1 64x48" in capsys.readouterr().out


# ------------------------------------------------------------------ Ensemble


def test_ensemble_decode_matches_jax(hybrid_pair, hybrid_path):
    """Two hybrid members (seeds 11 and 14), imgsz 64, f32: the concatenated
    decoded predictions within 1e-5 of max|ref| of each column group."""
    jm, v, tm, x, _ = hybrid_pair
    v2 = jax_variables(jm.module, jnp.asarray(x[:1]), train=False, seed=14)
    tm2 = load_jax_variables(DetectionModel.from_yaml(hybrid_path, device="cpu"), v2)
    ref = np.asarray(jax.jit(lambda a, b, x: JaxEnsemble([jm, jm], [a, b]).decode(x))(v, v2, jnp.asarray(x)))
    got = Ensemble([tm, tm2]).decode(to_torch(x))
    assert got.shape == ref.shape == (2, 2 * 84, 84)
    for sl in (slice(0, 4), slice(4, None)):
        assert _rel(got[..., sl], ref[..., sl]) <= 1e-5


def test_ensemble_refuses_mixed_members(hybrid_path):
    """Members of another task or class count raise ValueError (the JAX class asserts)."""
    with pytest.raises(ValueError, match="share task and nc"):
        Ensemble([DetectionModel.from_yaml(hybrid_path, device="cpu"),
                  DetectionModel.from_yaml(hybrid_path, nc=3, device="cpu")])
    with pytest.raises(ValueError, match="share task and nc"):
        Ensemble([DetectionModel.from_yaml(hybrid_path, nc=15, device="cpu"),
                  DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu")])
    with pytest.raises(ValueError):
        Ensemble([])


# ------------------------------------------------------------------ the conv form of each QConv2D


def _port_forms(model, run):
    """The form (``grouped`` or ``folded``), C_out a component and groups of each
    QConv2D call while ``run()`` runs, in call order."""
    forms = []
    hooks = [m.register_forward_hook(lambda m, i, o: forms.append((m._impl(), m.cout, m.g)))
             for m in model.modules() if isinstance(m, tc.QConv2D)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return forms


def _jax_forms(monkeypatch, fold_max, trace):
    """The form each JAX QConv2D call takes while ``trace()`` traces, under
    ``QUAN_QCONV_IMPL=auto``, at fold threshold ``fold_max`` (None: the JAX
    package's own, 128 inside ``train_graph()`` and 32 elsewhere)."""
    forms = []
    grouped, folded = jc.qconv2d, jqconv.qconv2d_folded
    monkeypatch.setenv("QUAN_QCONV_IMPL", "auto")
    if fold_max is None:
        monkeypatch.delenv("QUAN_QCONV_FOLD_MAX", raising=False)
    else:
        monkeypatch.setenv("QUAN_QCONV_FOLD_MAX", str(fold_max))
    monkeypatch.setattr(jc, "qconv2d", lambda x, w, *a, **k: forms.append(("grouped", w.shape[-1])) or
                        grouped(x, w, *a, **k))
    monkeypatch.setattr(jqconv, "qconv2d_folded", lambda x, dk, *a, **k: forms.append(("folded", dk.shape[-1] // 4))
                        or folded(x, dk, *a, **k))
    trace()
    return forms


# (the port's thresholds, the JAX threshold of each mode): the JAX package's TPU values set in
# the port's module constants, against JAX's own rule; and the port's H100 defaults, set in JAX
THRESHOLDS = {"jax_tpu_values": ((32, 128), (None, None)),
              "port_defaults": ((tc.FOLD_MAX_EVAL, tc.FOLD_MAX_TRAIN), (tc.FOLD_MAX_EVAL, tc.FOLD_MAX_TRAIN))}


def _thresholds(monkeypatch, case):
    """Set the port's thresholds of ``case``; the JAX thresholds (eval, train) to set."""
    (ev, tr), jax_thresholds = THRESHOLDS[case]
    monkeypatch.setattr(tc, "FOLD_MAX_EVAL", ev)
    monkeypatch.setattr(tc, "FOLD_MAX_TRAIN", tr)
    return jax_thresholds


def _assert_same_forms(port, ref):
    assert len(port) == len(ref) > 10
    assert [(f, c) for f, c, _ in port] == ref


@pytest.mark.parametrize("case", sorted(THRESHOLDS))
def test_conv_forms_match_jax_in_the_detection_train_step(monkeypatch, hybrid_path, hybrid_pair, case):
    """Under ``impl="auto"`` a port ``Trainer.step`` (inside ``train_graph``) folds
    what the JAX trainer's loss trace folds, layer by layer."""
    _, jax_train = _thresholds(monkeypatch, case)
    monkeypatch.setenv("QUAN_STEM_S2D", "0")  # the JAX package's TPU stem rewrite is not ported
    jm = JaxDetectionModel.from_yaml(str(hybrid_path))
    _, v, _, x, _ = hybrid_pair
    rng = np.random.default_rng(15)
    batch = {"img": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             "cls": rng.integers(0, 80, (2, 4)).astype(np.int32),
             "bboxes": rng.uniform(0.2, 0.6, (2, 4, 4)).astype(np.float32), "mask": np.ones((2, 4), bool)}
    jtr = jt.Trainer(jm, jt.TrainConfig(batch=2, imgsz=64, dtype="float32"), steps_per_epoch=1)
    ref = _jax_forms(monkeypatch, jax_train, lambda: jax.eval_shape(
        jtr.loss_fn, v["params"], v["batch_stats"], {k: jnp.asarray(a) for k, a in batch.items()}))
    model = load_jax_variables(DetectionModel.from_yaml(hybrid_path, device="cpu"), v)
    trainer = tt.Trainer(model, tt.TrainConfig(batch=2, dtype="float32"), steps_per_epoch=1, device="cpu")
    port = _port_forms(model, lambda: trainer.step(batch))
    _assert_same_forms(port, ref)
    assert all(f == "folded" for f, c, g in port if g == 1 and c < tc.FOLD_MAX_TRAIN)


@pytest.mark.parametrize("case", sorted(THRESHOLDS))
def test_conv_forms_match_jax_in_eval(monkeypatch, hybrid_path, hybrid_pair, case):
    jax_eval, _ = _thresholds(monkeypatch, case)
    monkeypatch.setenv("QUAN_STEM_S2D", "0")
    jm = JaxDetectionModel.from_yaml(str(hybrid_path))
    _, v, _, x, _ = hybrid_pair
    ref = _jax_forms(monkeypatch, jax_eval, lambda: jax.eval_shape(lambda v, a: jm.apply(v, a), v, x))
    # without the fused 1x1 kernel, as the JAX package runs by default
    tm = load_jax_variables(DetectionModel.from_yaml(hybrid_path, device="cpu", fused_1x1=False), v)
    with torch.no_grad():
        port = _port_forms(tm, lambda: tm(to_torch(x)))
    _assert_same_forms(port, ref)


@pytest.mark.parametrize("case", sorted(THRESHOLDS))
def test_conv_forms_match_jax_in_the_classification_train_step(monkeypatch, case):
    """Q-WRN-16-2's train step (no ``train_graph``, as in the JAX package) keeps the
    eval threshold: at the JAX package's TPU values its layers with C_out from 32
    up to 128 a component stay grouped, as JAX keeps them."""
    jax_eval, _ = _thresholds(monkeypatch, case)
    jmodel = jcm.create_model("qwrn16_2", 10, 0.0, "poincare")
    x = np.random.default_rng(16).normal(size=(2, 32, 32, 3)).astype(np.float32)
    v = jax_variables(jmodel, jnp.asarray(x), train=False, seed=17)
    ref = _jax_forms(monkeypatch, jax_eval, lambda: jax.eval_shape(
        lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)}),
        v, jnp.asarray(x)))
    trainer = ClsTrainer(ClsConfig(model="qwrn16_2", dtype="float32", batch_size=2), steps_per_epoch=1, device="cpu")
    batch = {"img": x, "label": np.array([1, 2], np.int32)}
    port = _port_forms(trainer.model, lambda: trainer.train_step(batch))
    _assert_same_forms(port, ref)
    middle = [c for f, c, g in port if g == 1 and tc.FOLD_MAX_EVAL <= c < tc.FOLD_MAX_TRAIN]
    assert all(f == "grouped" for f, c, g in port if c in middle)
    assert middle or case == "port_defaults"
