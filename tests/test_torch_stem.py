"""The phase-composite and deep-packed stem (``ops/stem.py``, the packed qconvs,
packed IQBN and C3k2, ``QUANYOLO``'s ``stem_s2d`` / ``stem_deep``) against the
JAX package (the counterpart of tests/test_stem.py and tests/test_models.py's
features test), on seeded numpy inputs, f32 on the CPU at imgsz 64.

Tolerances: the packed convs within 1e-4 of JAX's (the same products summed
in another order; int8 forms: the same int32 accumulators, scaled in f32);
the full model's head outputs within 2e-4 relative plus 2e-5 of max|ref|
(`torch_port_helpers.assert_close`), as tests/test_torch_model.py holds the
plain stem; packed IQBN's statistics within 1e-5; gradients of the packed
subgraph within 2e-3 relative (tests/test_stem.py's); the stem forms of the
port against its own plain stem: forward within 1e-5 of max|ref|, the
global gradient within 1e-3 relative L2 in train mode at batch 2 (there the
plain stem's own f32 gradient is 2.5e-4 from its f64 one; at batch 1 the
batch statistics over the 2x2 P5 grid make that 0.39). The remat and the
eval kernel cache are identities: exact.

JAX compiles are few: one eval forward at the JAX default stem (stem_s2d) and
one at stem_deep=1, at a low XLA optimization level; stem_deep 2 and 3 are
held to those (identical math: tests/test_stem.py holds JAX's levels to each
other) and to the port's plain stem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.models import block as jblock
from quan_ultralytics_tpu.models import conv as jconv
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.models.tasks import QUANYOLO as JaxQUANYOLO
from quan_ultralytics_tpu.ops import qconv as jq
from quan_ultralytics_tpu.ops import stem as jstem
from quan_ultralytics_tpu_torch.models.block import C3k2
from quan_ultralytics_tpu_torch.models.conv import IQBN, Conv
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites
from quan_ultralytics_tpu_torch.ops import qconv as tq
from quan_ultralytics_tpu_torch.ops import stem as tstem
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ = "yolo11n-obb-quan.yaml", 3, 64
LOW_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
STEMS = {"plain": {}, "s2d": {"stem_s2d": True}, "deep1": {"stem_deep": 1}, "deep2": {"stem_deep": 2},
         "deep3": {"stem_deep": 3}, "deep1_fine": {"stem_deep": 1, "stem_l0": "fine"},
         "deep1_grouped": {"stem_deep": 1, "packed_impl": "grouped"}}


def _w(jw) -> torch.Tensor:
    """A JAX qconv weight [4, kh, kw, cin, cout] in the port's layout [4, cout, cin, kh, kw]."""
    return torch.from_numpy(np.asarray(jw).transpose(0, 4, 3, 1, 2).copy())


def _draw(seed, *shapes, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _pack_cmajor(y: np.ndarray, r: int = 2) -> np.ndarray:
    B, H, W, Q, C = y.shape
    return y.reshape(B, H // r, r, W // r, r, Q, C).transpose(0, 1, 3, 5, 6, 2, 4).reshape(
        B, H // r, W // r, Q, C * r * r)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("cin", [1, 2])
@pytest.mark.parametrize("impl", ["grouped", "folded"])
def test_phase0_and_phase1_match_jax(cin, impl):
    """Layer 0 (k=5, s=4) and layer 1 (k=2 padded top-left) of the
    phase-composite stem; cin = 1 is the RGB layer's per-component width."""
    x, w0, b0, w1, b1 = _draw(cin, (2, 16, 16, 4, cin), (4, 3, 3, cin, 4), (4,), (4, 3, 3, 4, 6), (6,))
    z_ref = jq.qconv2d_phase0(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(b0))
    z = tq.qconv2d_phase0(to_torch(x), _w(w0), to_torch(b0), impl=impl)
    assert z.shape == z_ref.shape == (2, 4, 4, 4, 16)
    assert_close(z, z_ref, rtol=1e-4, atol=1e-5)
    y_ref = jq.qconv2d_phase1(z_ref, jnp.asarray(w1), jnp.asarray(b1))
    y = tq.qconv2d_phase1(z, _w(w1), to_torch(b1), impl=impl)
    assert y.shape == y_ref.shape == (2, 4, 4, 4, 6)
    assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
    # and the composite equals the plain pair of stride-2 convs
    plain = tq.qconv2d(tq.qconv2d(to_torch(x), _w(w0), to_torch(b0), stride=2, padding=1),
                       _w(w1), to_torch(b1), stride=2, padding=1)
    assert_close(y, plain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["grouped", "folded"])
def test_phase0_packed_matches_jax(impl):
    """The RGB layer on the r=4 packed mapped input (`s2d4_rgb_mapped`)."""
    (w,), (b,) = _draw(3, (4, 3, 3, 1, 4)), _draw(4, (4,))
    rgb = np.random.default_rng(5).random((2, 16, 16, 3)).astype(np.float32)
    xp_ref = jstem.s2d4_rgb_mapped(jnp.asarray(rgb), "poincare")
    xp = tstem.s2d4_rgb_mapped(to_torch(rgb), "poincare")
    assert_close(xp, xp_ref, rtol=1e-6, atol=1e-7)
    ref = jq.qconv2d_phase0_packed(xp_ref, jnp.asarray(w), jnp.asarray(b))
    got = tq.qconv2d_phase0_packed(xp, _w(w), to_torch(b), impl=impl)
    assert got.shape == ref.shape == (2, 4, 4, 4, 16)
    assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["folded", "grouped", "int8"])
@pytest.mark.parametrize("k,s,p,ri,ro", [(3, 2, 1, 2, 2), (3, 1, 1, 2, 2), (1, 1, 0, 2, 2),
                                         (3, 2, 1, 2, 1), (3, 2, 1, 1, 2), (3, 2, 1, 4, 2)])
def test_packed_conv_matches_jax(k, s, p, ri, ro, impl):
    """`qconv2d_packed` for every deep-stem case (layer 1 through, the C3k2's
    3x3 and 1x1, the unpacking conv, layer 0 on the fine grid and on the r=4
    packing) in each form, against JAX's; and the folded form against
    pack . qconv2d . unpack of the port's plain conv."""
    cin = 1 if ri == 4 else 3
    x, w, b = _draw(k * 7 + ri, (2, 16, 16, 4, cin), (4, k, k, cin, 5), (5,))
    xin = _pack_cmajor(x, ri) if ri > 1 else x
    ref = jq.qconv2d_packed(jnp.asarray(xin), jnp.asarray(w), jnp.asarray(b), stride=s, padding=p,
                            ri=ri, ro=ro, impl=impl)
    got = tq.qconv2d_packed(to_torch(xin), _w(w), to_torch(b), stride=s, padding=p, ri=ri, ro=ro, impl=impl)
    assert got.shape == ref.shape
    assert_close(got, ref, rtol=1e-4, atol=1e-5)
    if impl == "folded":
        plain = tq.qconv2d(to_torch(x), _w(w), to_torch(b), stride=s, padding=p)
        unpacked = tstem.depth_to_space_cmajor(got, ro) if ro > 1 else got
        assert_close(unpacked, plain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["l0", "l1", "l0_s2d4", "packed"])
def test_weight_expansions_match_jax(fn):
    """Each expansion (one gather through its index map) equals JAX's loops of
    ``.at[].set``, in the port's layout; its gradient reaches the weights."""
    (w,) = _draw(9, (4, 3, 3, 2, 3))
    wt = _w(w).requires_grad_(True)
    if fn == "packed":
        ref, pl_ref, s_ref = jstem.expand_w_packed(jnp.asarray(w[0]), 2, 1, 2, 2)
        got, pl, s = tstem.expand_w_packed(wt, 2, 1, 2, 2)
        assert (pl, s) == (pl_ref, s_ref)
        refs = [ref] + [jstem.expand_w_packed(jnp.asarray(w[d]), 2, 1, 2, 2)[0] for d in (1, 2, 3)]
    else:
        jfn, tfn = getattr(jstem, f"expand_w_{fn}"), getattr(tstem, f"expand_w_{fn}")
        refs = [jfn(jnp.asarray(w[d])) for d in range(4)]
        got = tfn(wt)
    for d in range(4):  # JAX's HWIO per component -> OIHW
        np.testing.assert_array_equal(got[d].detach().numpy(), np.asarray(refs[d]).transpose(3, 2, 0, 1))
    got.sum().backward()
    assert wt.grad is not None and bool((wt.grad > 0).all())  # every tap lands somewhere


@pytest.mark.parametrize("r", [2, 4])
def test_depth_to_space_round_trips(r):
    y = np.random.default_rng(r).random((2, 8, 8, 4, 6)).astype(np.float32)
    z = _pack_cmajor(y, r)
    np.testing.assert_array_equal(tstem.depth_to_space_cmajor(to_torch(z), r).numpy(), y)
    np.testing.assert_array_equal(tstem.depth_to_space_cmajor(to_torch(z), r).numpy(),
                                  np.asarray(jstem.depth_to_space_cmajor(jnp.asarray(z), r)))
    zp = tstem.space_to_depth(to_torch(y).movedim(3, 1), r).movedim(1, 3)  # phase-major, per component
    np.testing.assert_array_equal(zp.numpy(), np.asarray(jnp.moveaxis(
        jstem.space_to_depth(jnp.moveaxis(jnp.asarray(y), 3, 1), r), 1, 3)))
    np.testing.assert_array_equal(tstem.depth_to_space_phasemajor(zp, r).numpy(), y)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("packing", ["phase_packed", "packed_cmajor"])
def test_packed_iqbn_matches_jax(packing, train):
    """Packed IQBN == JAX's packed IQBN == the unpacked IQBN on the unpacked
    input, in train (output and running statistics) and eval."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 8, 4, 3)).astype(np.float32) + 0.5
    if packing == "packed_cmajor":
        xp = _pack_cmajor(x)
        unpack = tstem.depth_to_space_cmajor
    else:
        xp = np.asarray(jnp.moveaxis(jstem.space_to_depth(jnp.moveaxis(jnp.asarray(x), 3, 1), 2), 1, 3))
        unpack = tstem.depth_to_space_phasemajor
    jmod = jconv.IQBN(12, **{packing: True})
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xp), train=False)
    v = {"params": {"gamma": jnp.asarray(rng.uniform(0.5, 1.5, (4, 3)), jnp.float32),
                    "beta": jnp.asarray(rng.normal(size=(4, 3)) * 0.1, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.normal(size=(4, 3)) * 0.1, jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 1.5, (4, 3)), jnp.float32)}}
    ref, st = jmod.apply(v, jnp.asarray(xp), train=train, mutable=["batch_stats"])
    bn, plain = IQBN(12, **{packing: True}), IQBN(12)
    for m in (bn, plain):
        load_jax_variables(m, v)
        m.train(train)
    with torch.no_grad():
        got, want = bn(to_torch(xp)), plain(to_torch(x))
    assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert_close(unpack(got), want, rtol=1e-5, atol=1e-6)
    for name in ("mean", "var"):
        assert_close(getattr(bn, name), st["batch_stats"][name], rtol=1e-5, atol=1e-6)
        assert_close(getattr(bn, name), getattr(plain, name), rtol=1e-5, atol=1e-6)


def _sub(packed: bool):
    """The deep-packed region's shape (tests/test_stem.py's subgraph): Conv out ->
    Conv both -> packed C3k2 -> Conv in; names as the JAX module's."""
    pk = (lambda v: v if packed else None)
    return torch.nn.ModuleDict({
        "l0": Conv(3, 16, 3, 2, packed=pk("out"), impl="folded"),
        "l1": Conv(16, 32, 3, 2, packed=pk("both"), impl="folded"),
        "l2": C3k2(32, 64, 1, False, 0.25, packed=packed, impl="folded"),
        "l3": Conv(64, 64, 3, 2, packed=pk("in"), impl="folded")})


def test_packed_subgraph_gradients_match_jax():
    """tests/test_stem.py's packed subgraph in train mode: loss, gradients and
    the batch statistics after the step, the port's packed region against JAX's
    packed region and against the port's plain region."""
    import flax.linen as fnn

    class Sub(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=True):
            x = jconv.Conv(3, 16, 3, 2, packed="out", name="l0")(x, train)
            x = jconv.Conv(16, 32, 3, 2, packed="both", name="l1")(x, train)
            x = jblock.C3k2(32, 64, 1, False, 0.25, packed=True, name="l2")(x, train)
            return jconv.Conv(64, 64, 3, 2, packed="in", name="l3")(x, train)

    x = np.random.default_rng(10).random((2, 32, 32, 3)).astype(np.float32)
    jsub = Sub()
    v = jax_variables(jsub, jnp.asarray(x), train=True)

    def jloss(params):
        y, st = jsub.apply({**v, "params": params}, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) ** 2) * 1e-3, st

    (l_ref, st_ref), g_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
        v["params"]).compile(LOW_OPT)(v["params"])
    results = {}
    for packed in (True, False):
        sub = _sub(packed).train()
        load_jax_variables(sub, v)
        loss = (sub["l3"](sub["l2"](sub["l1"](sub["l0"](to_torch(x))))).float() ** 2).sum() * 1e-3
        loss.backward()
        results[packed] = (float(loss), {n: p.grad for n, p in sub.named_parameters()},
                           {n: b for n, b in sub.named_buffers() if n.endswith(("mean", "var"))})
    flat_g = {".".join(str(k.key) for k in path): a
              for path, a in jax.tree_util.tree_leaves_with_path(g_ref)}
    flat_s = {".".join(str(k.key) for k in path): a
              for path, a in jax.tree_util.tree_leaves_with_path(st_ref["batch_stats"])}
    for packed, (loss, grads, stats) in results.items():
        assert loss == pytest.approx(float(l_ref), rel=1e-5), packed
        for name, g in grads.items():
            ref = np.asarray(flat_g[name])
            if name.endswith(".w"):
                ref = ref.transpose(0, 4, 3, 1, 2)
            np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=1e-5, err_msg=f"{packed} {name}")
        for name, b in stats.items():
            assert_close(b, flat_s[name], rtol=1e-5, atol=1e-6, err_msg=f"{packed} {name}")


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def models():
    """JAX variables, the input, JAX's eval head outputs at its default stem
    (stem_s2d) and at stem_deep=1, and the port's model of every stem form
    carrying those variables."""
    jm = JaxDetectionModel.from_yaml(CFG, nc=NC)
    x = np.random.default_rng(9).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    v = jax_variables(jm.module, jnp.asarray(x[:1]), train=False)
    ref = {}
    for name, kw in (("s2d", {"stem_s2d": True}), ("deep1", {"stem_deep": 1})):
        mod = JaxQUANYOLO(jm.module.specs, jm.module.save, **kw)
        fn = jax.jit(lambda v_, x_, mod=mod: mod.apply(v_, x_, train=False))
        feats, angles = fn.lower(v, jnp.asarray(x)).compile(LOW_OPT)(v, jnp.asarray(x))
        ref[name] = [np.asarray(t) for t in list(feats) + list(angles)]
    port = {}
    for name, kw in STEMS.items():
        m = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", fused_1x1=False, **kw)
        load_jax_variables(m, v)
        port[name] = m
    return v, x, ref, port


def _outs(m, x):
    with torch.no_grad():
        feats, angles = m(to_torch(x))
    return list(feats) + list(angles)


@pytest.mark.parametrize("stem", list(STEMS))
def test_model_stem_forms_match_jax(models, stem):
    """Each stem form's head outputs against JAX's with the same setting
    (stem_s2d and stem_deep=1; the other forms against both of those) and
    against the port's plain stem; the layout chosen is JAX's."""
    v, x, ref, port = models
    m = port[stem]
    got = _outs(m, x)
    against = [ref["s2d"] if stem in ("plain", "s2d") else ref["deep1"]]
    if stem not in ("s2d", "deep1"):
        against.append(ref["s2d"])
    for r in against:
        for g, rr in zip(got, r):
            assert g.shape == rr.shape
            assert_close(g, rr, rtol=2e-4, atol=2e-5)
    plain = _outs(port["plain"], x)
    for g, p in zip(got, plain):
        assert_close(g, p, rtol=1e-5, atol=1e-5)
    want_k = {"deep1": 1, "deep2": 2, "deep3": 3, "deep1_fine": 1, "deep1_grouped": 1}.get(stem, 0)
    assert m.deep_k == want_k
    layout = [lay for lay in m.packed_out if lay]
    assert layout == (["phase"] if stem == "s2d" else ["cmajor"] * (2 * want_k + 1) if want_k else [])


def test_stem_forms_keep_parameters_and_summary(models):
    """Every stem form has the plain model's state names and shapes (the
    checkpoints are shared), its layer table and FLOPs (`DetectionModel.info`,
    as JAX's summary counts them), and `fused_1x1_sites` leaves out the 1x1
    convs of the packed region."""
    _, _, _, port = models
    plain = port["plain"]
    shapes = {k: tuple(t.shape) for k, t in plain.state_dict().items()}
    info = plain.info(imgsz=IMGSZ, log=lambda *a: None)
    sites = {}
    for name, m in port.items():
        assert {k: tuple(t.shape) for k, t in m.state_dict().items()} == shapes, name
        assert m.info(imgsz=IMGSZ, log=lambda *a: None) == info, name
        fused = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", fused_1x1=True, **STEMS[name])
        sites[name] = len(fused_1x1_sites(fused, 1, IMGSZ))
    # the packed C3k2s' cv1 and cv2 (layers 2, 4, 6; layer 6's C3k also its cv1, cv2, cv3)
    assert sites["plain"] == sites["s2d"] == 37
    assert sites["deep1"] == sites["deep1_fine"] == 35 and sites["deep2"] == 33 and sites["deep3"] == 28


def test_stem_l0_fine_matches_prepack(models):
    """stem_l0="fine" (layer 0 as the k=5, s=4 conv on the mapped fine grid)
    equals the default r=4 prepacked layer 0."""
    _, x, _, port = models
    for a, b in zip(_outs(port["deep1_fine"], x), _outs(port["deep1"], x)):
        assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stem", ["s2d", "deep1", "deep2", "deep3"])
def test_features_unpacked_across_stem_modes(models, stem):
    """`features()` and ``upto`` give the public [B, H, W, 4, C] tensors whatever
    the packing (tests/test_models.py's features test): the plain stem's."""
    _, x, _, port = models
    with torch.no_grad():
        _, ref = port["plain"].features(to_torch(x))
        _, got = port[stem].features(to_torch(x))
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=str(k))
        for i in (0, 1, 2, 3, 4):
            assert_close(port[stem](to_torch(x), upto=i), ref[i], rtol=1e-5, atol=1e-5)


def _grads(m, x, **kw):
    m.zero_grad()
    feats, angles = m(to_torch(x).requires_grad_(True) if kw.get("wrt_x") else to_torch(x))
    loss = sum((t.float() ** 2).sum() for t in list(feats) + list(angles)) * 1e-6
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("stem", ["s2d", "deep1", "deep2"])
def test_stem_forms_train_like_the_plain_stem(models, stem):
    """A train-mode forward and backward from the same state: the loss, the
    updated batch statistics and the gradients of a stem form against the
    plain stem's (the train step against JAX's: tests/test_torch_train.py)."""
    v, x, _, _ = models
    out = {}
    for name in ("plain", stem):
        m = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", fused_1x1=False, **STEMS[name]).train()
        load_jax_variables(m, v)
        loss, g = _grads(m, x)
        out[name] = loss, g, {n: b.clone() for n, b in m.named_buffers() if n.endswith(("mean", "var"))}
    (l0, g0, s0), (l1, g1, s1) = out["plain"], out[stem]
    assert l1 == pytest.approx(l0, rel=1e-5)
    assert set(g0) == set(g1)
    a = torch.cat([g0[n].reshape(-1) for n in g0])
    b = torch.cat([g1[n].reshape(-1) for n in g0])
    assert float((a - b).norm() / a.norm()) < 1e-3
    for n in s0:
        assert_close(s1[n], s0[n], rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("stem", ["plain", "deep1", "deep1_fine", "s2d"])
def test_stem_remat_is_the_identity(models, stem):
    """stem_remat (the mapping and layer 0 in one checkpoint): the same loss
    and the same parameter gradients, bit for bit."""
    v, x, _, _ = models
    res = []
    for remat in (False, True):
        m = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", fused_1x1=False, stem_remat=remat,
                                     **STEMS[stem]).train()
        load_jax_variables(m, v)
        res.append(_grads(m, x[:1]))
    assert res[0][0] == res[1][0]
    for n in res[0][1]:
        assert torch.equal(res[0][1][n], res[1][1][n]), n


def test_eval_kernel_cache_follows_the_weights(models):
    """In eval without grad the expanded kernels are kept; a weight update (a
    new version) and a grad-enabled call rebuild them."""
    _, x, _, port = models
    m = port["deep1"]
    a = _outs(m, x)
    conv = m.model[0].conv
    assert conv._kernel_cache is not None
    assert all(torch.equal(p, q) for p, q in zip(a, _outs(m, x)))
    with torch.no_grad():
        conv.w.mul_(0.5)
    b = _outs(m, x)
    assert not torch.equal(a[0], b[0])
    with torch.no_grad():
        conv.w.mul_(2.0)
    c = _outs(m, x)
    assert all(torch.equal(p, q) for p, q in zip(a, c))
    feats, _ = m(to_torch(x))  # grad enabled: the kernel is built under autograd, not kept
    assert feats[0].requires_grad and conv._kernel_cache is None


def test_facade_takes_the_stem_form():
    """``YOLO(..., stem_s2d=, stem_deep=)`` (the JAX facade's ``QUAN_STEM_*``)
    builds that form with the same seeded weights: the same boxes as the plain
    facade's."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    frames = [np.random.default_rng(i).integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8) for i in range(2)]
    ref = YOLO(CFG, nc=NC, device="cpu").predict(frames, imgsz=IMGSZ, conf=0.001)
    for kw, k in (({"stem_s2d": True}, 0), ({"stem_deep": 2}, 2)):
        y = YOLO(CFG, nc=NC, device="cpu", **kw)
        assert y.model.deep_k == k and (k or y.model.packed_out[0] == "phase")
        got = y.predict(frames, imgsz=IMGSZ, conf=0.001)
        for g, r in zip(got, ref):
            assert len(g) == len(r) > 0
            np.testing.assert_array_equal(g.cls, r.cls)
            np.testing.assert_allclose(g.boxes, r.boxes, rtol=1e-5, atol=1e-3)
