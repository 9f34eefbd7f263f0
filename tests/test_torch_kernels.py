"""The port's kernels: K1 (fused attention forward), K2 (its backward) and
K3 (fused 1x1 Conv+IQBN+SiLU).

On the CPU the wrappers take their plain versions, which are held against
the JAX package's Pallas kernels in interpret mode (as its own
tests/test_pallas.py runs them). The CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py; the tolerances there are
checked here to see each of the TPU kernels' rounding points, and plain
models of the bf16 kernels' summation orders to meet them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.models import block as jb
from quan_ultralytics_tpu.models import conv as jc
from quan_ultralytics_tpu.ops.pallas import qattn as jqattn
from quan_ultralytics_tpu.ops.pallas import qconv_fused as jqf
from quan_ultralytics_tpu_torch.models import block as tb
from quan_ultralytics_tpu_torch.models import conv as tc
from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


# ---------------------------------------------------------------- K1, CPU


def test_qattention_module_matches_pallas_kernel(monkeypatch):
    """Port QAttention (plain version on the CPU) == JAX QAttention through
    the Pallas kernel, N = 8 x 16 = 128, dim 128, 8 heads."""
    monkeypatch.setenv("QUAN_FUSED_ATTN", "1")
    x = np.random.default_rng(0).normal(size=(1, 8, 16, 4, 32)).astype(np.float32)
    jmod = jb.QAttention(dim=128, num_heads=8, attn_ratio=0.5)
    v = jax_variables(jmod, jnp.asarray(x))
    ref = jax.jit(lambda v, x: jmod.apply(v, x))(v, jnp.asarray(x))
    tmod = load_jax_variables(tb.QAttention(128, 8, 0.5, fused_attn=True), v).eval()
    with torch.no_grad():
        got = tmod(to_torch(x))
    assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [128, 200])
def test_qattention_fused_plain_matches_pallas(n):
    """N = 200 is the case the JAX kernel pads to 256 and masks."""
    rng = np.random.default_rng(n)
    B, Q, H, dk, dv = 2, 4, 3, 4, 8
    q, k = (rng.normal(size=(B, Q, H, n, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, Q, H, n, dv)).astype(np.float32)
    scale = dk ** -0.5
    ref = jqattn.qattention_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = qattn.qattention_fused(to_torch(q), to_torch(k), to_torch(v), scale)
    assert_close(got, ref, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------- K2, CPU


@pytest.mark.parametrize("dk,dv", [(2, 4), (4, 8)])
@pytest.mark.parametrize("n", [128, 200])
def test_qattention_backward_matches_pallas_vjp(n, dk, dv):
    """The plain backward (K2's yardstick) and autograd of the plain forward
    against ``jax.grad`` through the JAX kernel's custom VJP (the flash
    backward, in the Pallas interpreter; N = 200 is padded to 256 there), f32,
    at tests/test_pallas.py's tolerance."""
    rng = np.random.default_rng(10 * n + dk)
    B, Q, H = 1, 2, 2
    q, k = (rng.normal(size=(B, Q, H, n, dk)).astype(np.float32) for _ in range(2))
    v, do = (rng.normal(size=(B, Q, H, n, dv)).astype(np.float32) for _ in range(2))
    scale = dk ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jqattn.qattention_fused(q, k, v, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = qattn.qattention_bwd_plain(*(to_torch(a) for a in (q, k, v, do)), scale)
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    auto = torch.autograd.grad(qattn.qattention_fused(tq, tk, tv, scale), (tq, tk, tv), to_torch(do))
    for name, a, b, r in zip(("dq", "dk", "dv"), got, auto, ref):
        assert_close(a, r, rtol=5e-4, atol=5e-5, err_msg=f"plain {name}")
        assert_close(b, r, rtol=5e-4, atol=5e-5, err_msg=f"autograd {name}")


def _bwd_variant(q, k, v, do, scale, skip=(), acc=torch.float32):
    """`qattention_bwd_plain` written out again, with the rounding points named in
    ``skip`` left out and the products accumulated in ``acc``."""
    T, f = q.dtype, acc

    def rnd(x, name, dt=T):
        return x if name in skip else x.to(dt).to(f)

    q2 = rnd(q.to(f) * qattn._round(scale * qattn._LOG2E, T), "q2")
    ks = rnd(k.to(f) * qattn._round(scale, T), "ks")
    s2 = q2 @ k.to(f).transpose(-1, -2)
    e = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True)
    dor = rnd(do.to(f) * r, "dor", do.dtype)
    dv = rnd(e, "E", v.dtype).transpose(-1, -2) @ dor
    dp = do.to(f) @ v.to(f).transpose(-1, -2)
    u = rnd(e * (dp - r * (dp * e).sum(-1, keepdim=True)), "U")
    dq = (u @ ks) * r
    dk = u.transpose(-1, -2) @ rnd(q2 * (r * qattn._LN2), "q2r")
    return dq.to(T), dk.to(T), dv.to(T)


def _bf16_inputs(n=256, dk=2, dv=4):
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(1, 4, 2, n, dk)).astype(np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(1, 4, 2, n, dv)).astype(np.float32)) for _ in range(2))
    return [t.bfloat16() for t in (q, k, v, do)]


def test_qattention_backward_keeps_bf16_rounding_points():
    """In bf16 the plain backward rounds where the TPU kernel rounds: the f32
    gradients of the same bf16 inputs miss K2's bf16 tolerance, while the same
    rounding points with the products accumulated in f64 (another summation
    order, as a kernel has) meet it."""
    bf = _bf16_inputs()
    got = qattn.qattention_bwd_plain(*bf, 2 ** -0.5)
    assert all(a.dtype == torch.bfloat16 for a in got)
    f32 = qattn.qattention_bwd_plain(*(t.float() for t in bf), 2 ** -0.5)
    f64 = _bwd_variant(*bf, 2 ** -0.5, acc=torch.float64)
    for name, a, r, other in zip(("dq", "dk", "dv"), got, f32, f64):
        assert not qattn.kernel_error(r, a, torch.bfloat16, qattn.BWD_TOL)[2], f"the f32 {name} passes"
        assert qattn.kernel_error(other, a, torch.bfloat16, qattn.BWD_TOL)[2], \
            f"the f64-accumulated {name} fails"
        assert not torch.equal(a.float(), r)


@pytest.mark.parametrize("point", ["q2", "ks", "E", "dor", "U", "q2r"])
def test_bf16_tolerance_sees_each_rounding_point(point):
    """K2's bf16 tolerance fails a backward that leaves out any one of the TPU
    kernel's rounding points (q2, ks, E cast to V's dtype, dO r, U, q2 r ln2)."""
    bf = _bf16_inputs()
    ref = qattn.qattention_bwd_plain(*bf, 2 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(_bwd_variant(*bf, 2 ** -0.5), ref))
    mutant = _bwd_variant(*bf, 2 ** -0.5, skip=(point,))
    assert not all(qattn.kernel_error(a, r, torch.bfloat16, qattn.BWD_TOL)[2]
                   for a, r in zip(mutant, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stats_feed_the_plain_backward(dtype):
    """The row statistics K1 saves for K2: m and r from `qattention_stats_plain`
    are the forward's (they rebuild the f32 softmax output), and the plain
    backward given them is bitwise the one that recomputes them."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 4, 2, 96, d)).astype(np.float32)).to(dtype)
                   for d in (2, 2, 4, 4))
    scale = 2 ** -0.5
    stats = qattn.qattention_stats_plain(q, k, scale)
    assert stats.shape == (2, 1, 4, 2, 96) and stats.dtype == torch.float32
    # the same statistics in f64 from the same rounded q2
    q2 = (q.double() * qattn._round(scale * qattn._LOG2E, dtype)).to(dtype).double()
    s2 = q2 @ k.double().transpose(-1, -2)
    m = s2.amax(-1)
    torch.testing.assert_close(stats[0].double(), m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[1].double(), 1 / torch.exp2(s2 - m[..., None]).sum(-1),
                               rtol=1e-5, atol=0)
    if dtype == torch.float32:  # they rebuild the forward's output
        e = torch.exp2(s2 - stats[0].double()[..., None])
        out = (e @ v.double()) * stats[1].double()[..., None]
        torch.testing.assert_close(out.float(), qattn.qattention_plain(q, k, v, scale),
                                   rtol=1e-5, atol=1e-6)
    given = qattn.qattention_bwd_plain(q, k, v, do, scale, stats=stats)
    again = qattn.qattention_bwd_plain(q, k, v, do, scale)
    for a, b in zip(given, again):
        assert torch.equal(a, b)


def _quad_row_sum(x):
    """Row sums ``[..., N, 1]`` of ``x`` in f32 in the order of an mma fragment's
    quad: lane t sums columns 8 j + 2 t, 8 j + 2 t + 1 in order, then the four
    lanes add up pairwise."""
    pe = torch.nn.functional.pad(x, (0, -x.shape[-1] % 8)).unflatten(-1, (-1, 4, 2))
    lanes = torch.zeros(pe.shape[:-3] + (4,), dtype=torch.float32)
    for j in range(pe.shape[-3]):
        for h in range(2):
            lanes = lanes + pe[..., j, :, h]
    return ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]


def _k2_order_model(q, k, v, do, scale, key_block=128, warp_keys=16, chunk=16):
    """K2's bf16 order written out in plain PyTorch: the statistics from the
    forward, rse from a pre-pass (each lane's keys summed, then the quad), dV
    and dK summed over query chunks of 16 (one mma each) in f32, dQ summed over
    each warp's 16 keys, over the eight warps of a key block, then over the key
    blocks as f32 partials, and multiplied by r at the end."""
    T, f = q.dtype, torch.float32
    n = q.shape[-2]
    pad = -n % key_block

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    stats = qattn.qattention_stats_plain(q, k, scale)
    q2, s2 = qattn._scores(q, k, scale)
    m, r = stats[0][..., None], stats[1][..., None]
    ks = (k.to(f) * qattn._round(scale, T)).to(T).to(f)
    e = torch.exp2(s2 - m)
    dp = do.to(f) @ v.to(f).transpose(-1, -2)
    rse = _quad_row_sum(dp * e)  # the pre-pass
    u = (e * (dp - r * rse)).to(T).to(f)
    eb = e.to(T).to(f)
    dor = (do.to(f) * r).to(T).to(f)
    qr = (q2 * (r * qattn._LN2)).to(T).to(f)
    dv = torch.zeros(v.shape, dtype=f)
    dk = torch.zeros(k.shape, dtype=f)
    for i0 in range(0, n, chunk):
        rows = slice(i0, i0 + chunk)
        dv = dv + eb[..., rows, :].transpose(-1, -2) @ dor[..., rows, :]
        dk = dk + u[..., rows, :].transpose(-1, -2) @ qr[..., rows, :]
    up, ksp = torch.nn.functional.pad(u, (0, pad)), padded(ks)
    dq = torch.zeros(q.shape, dtype=f)
    for b0 in range(0, n + pad, key_block):
        part = torch.zeros(q.shape, dtype=f)
        for w0 in range(b0, b0 + key_block, warp_keys):
            keys = slice(w0, w0 + warp_keys)
            part = part + up[..., keys] @ ksp[..., keys, :]
        dq = dq + part
    return (dq * r).to(T), dk.to(T), dv.to(T)


@pytest.mark.parametrize("n,dk,dv", [(200, 2, 4), (256, 2, 4), (200, 4, 8), (200, 8, 16),
                                     (200, 16, 32), (200, 32, 32)])
def test_k2_tensor_core_order_meets_bwd_tol(n, dk, dv):
    """A plain model of the bf16 K2's summation order meets BWD_TOL[bf16]
    against `qattention_bwd_plain`: only the order of the f32 sums changes. At
    the main path's head widths and at the wider ones of the larger models."""
    bf = _bf16_inputs(n, dk, dv)
    scale = dk ** -0.5
    ref = qattn.qattention_bwd_plain(*bf, scale)
    got = _k2_order_model(*bf, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, rel, ok = qattn.kernel_error(a, b, torch.bfloat16, qattn.BWD_TOL)
        assert ok, f"{name}: max abs error {err:.3e}, mean rel {rel:.3e}"


@pytest.mark.parametrize("dk,dv", [(2, 4), (4, 8)])
@pytest.mark.parametrize("n", [128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qattention_fwd_plain_matches_pallas(dtype, n, dk, dv):
    """K1's yardstick, the forward at the TPU kernel's rounding points, against
    the JAX kernel in interpret mode (N = 200 is padded to 256 there) in bf16
    and f32, within FWD_TOL.

    The JAX side is compiled with ``xla_allow_excess_precision`` off. By
    default XLA on the CPU may keep a bf16 value in f32 where that is
    cheaper: at dk = 2 it turns the 2-deep q2 k^T into elementwise
    multiply-adds and drops the rounding of q2 = q scale log2e to bf16 that
    the kernel's program states (its output then differs from the program's
    by 2.8e-3 mean relative, as a kernel that skips that rounding point)."""
    rng = np.random.default_rng(100 * n + dk)
    shape = (1, 4, 3, n)
    q, k = (rng.normal(size=(*shape, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(*shape, dv)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    fused = jax.jit(lambda q, k, v: jqattn.qattention_fused(q, k, v, dk ** -0.5))
    ref = fused.lower(*args).compile({"xla_allow_excess_precision": False})(*args)
    assert ref.dtype == jdt
    got = qattn.qattention_fwd_plain(*(to_torch(a).to(dtype) for a in (q, k, v)), dk ** -0.5)
    assert got.dtype == dtype
    err, rel, ok = qattn.kernel_error(got, to_torch(np.asarray(ref, np.float32)), dtype, qattn.FWD_TOL)
    assert ok, f"max abs error {err:.3e}, mean rel {rel:.3e}"


def _fwd_variant(q, k, v, scale, skip=()):
    """`qattention_fwd_plain` written out again, with the rounding points named in
    ``skip`` left out (``norm``: the probabilities normalized on [N, N] before
    they are rounded, instead of the output on [N, dv])."""
    T, f = q.dtype, torch.float32

    def rnd(x, name):
        return x if name in skip else x.to(T).to(f)

    q2 = rnd(q.to(f) * qattn._round(scale * qattn._LOG2E, T), "q2")
    s2 = q2 @ k.to(f).transpose(-1, -2)
    e = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True)
    if "norm" in skip:
        return (rnd(e * r, "E") @ v.to(f)).to(T)
    return ((rnd(e, "E") @ v.to(f)) * r).to(T)


@pytest.mark.parametrize("point", ["q2", "E", "norm", "f32"])
def test_fwd_tolerance_sees_each_rounding_point(point):
    """K1's bf16 tolerance fails a forward that leaves out any one of the TPU
    kernel's rounding points (q2, E cast to V's dtype before E V, the reciprocal
    applied on [N, dv]), and the f32 forward of the same bf16 inputs."""
    q, k, v, _ = _bf16_inputs()
    ref = qattn.qattention_fwd_plain(q, k, v, 2 ** -0.5)
    assert torch.equal(_fwd_variant(q, k, v, 2 ** -0.5), ref)
    if point == "f32":
        mutant = qattn.qattention_fwd_plain(q.float(), k.float(), v.float(), 2 ** -0.5)
    else:
        mutant = _fwd_variant(q, k, v, 2 ** -0.5, skip=(point,))
    assert not qattn.kernel_error(mutant, ref, torch.bfloat16, qattn.FWD_TOL)[2]


def _k1_order_model(q, k, v, scale, block=16):
    """The bf16 K1's order written out in plain PyTorch: f32 scores over dk
    zero-padded to the mma depth (zeros add nothing), the row sums of E in a
    quad's order, and E V summed in f32 over blocks of 16 keys (one m16n8k16
    each) in key order."""
    T, f = q.dtype, torch.float32
    n = q.shape[-2]
    s2 = qattn._scores(q, k, scale)[1]
    e = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    l = _quad_row_sum(e)
    eb, vf = e.to(T).to(f), v.to(f)
    o = torch.zeros(*q.shape[:-1], v.shape[-1], dtype=f)
    for j0 in range(0, n, block):
        o = o + eb[..., j0:j0 + block] @ vf[..., j0:j0 + block, :]
    return (o * (1.0 / l)).to(T)


@pytest.mark.parametrize("dk,dv", [(2, 4), (4, 8), (8, 16), (16, 32), (32, 32)])
def test_k1_tensor_core_order_meets_fwd_tol(dk, dv):
    """A plain model of the bf16 K1's summation order meets FWD_TOL[bf16]
    against `qattention_fwd_plain` at a ragged N: only the order of the f32
    sums changes. At the main path's head widths and at the wider ones of the
    larger models."""
    q, k, v, _ = _bf16_inputs(200, dk, dv)
    scale = dk ** -0.5
    err, rel, ok = qattn.kernel_error(_k1_order_model(q, k, v, scale),
                                      qattn.qattention_fwd_plain(q, k, v, scale),
                                      torch.bfloat16, qattn.FWD_TOL)
    assert ok, f"max abs error {err:.3e}, mean rel {rel:.3e}"


# ---------------------------------------------------------------- K3, CPU

# (Ci, Co) of the 37 fused sites of yolo11n-obb-quan (21 shapes)
K3_SITES = [(8, 8), (12, 16), (16, 8), (16, 16), (24, 16), (24, 32), (32, 16), (32, 32),
            (32, 64), (48, 32), (64, 16), (64, 32), (64, 64), (96, 32), (96, 64), (128, 64)]


def test_k3_site_list_is_the_models():
    """K3_SITES are the (Ci, Co) pairs `fused_1x1_sites` finds in the n model."""
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu", fused_1x1=True)
    assert sorted({(ci, co) for ci, co, _ in fused_1x1_sites(model, 8, 1024)}) == K3_SITES


def _k3_chunked_model(x, w, scale, shift, silu):
    """The bf16 K3's arithmetic in plain PyTorch: per component, Ci zero-padded to
    a multiple of 16, f32 sums of 16-wide chunks (one mma each; the kernel's
    last 8-wide step where Ci is an odd multiple of 8 adds the same products)
    added in order, then the mixing, the affine, SiLU and one cast."""
    p, ci = x.shape[0], x.shape[-1]
    cip = -(-ci // 16) * 16
    xs = torch.nn.functional.pad(x.reshape(p, 4, ci).float(), (0, cip - ci))
    ws = torch.nn.functional.pad(w.to(x.dtype).float(), (0, cip - ci))  # [4, Co, Cip]
    s = torch.zeros(4, p, w.shape[1])
    for k0 in range(0, cip, 16):
        s = s + torch.einsum("pdk,dok->dpo", xs[..., k0:k0 + 16], ws[..., k0:k0 + 16])
    sr, si, sj, sk = s
    y = torch.stack([sr + si + sj + sk, sr - si - sj + sk, sr + si - sj - sk, sr - si + sj - sk], 1)
    y = y * scale[None] + shift[None]
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype).reshape(p, 1, 1, 4, -1)


# wider (Ci, Co) of the s to x models' fused sites, which the bf16 K3 splits into channel
# tiles, and odd widths, which no model has
K3_WIDE = [(192, 192), (256, 128), (384, 192), (24, 12), (7, 3), (13, 10)]


@pytest.mark.parametrize("ci,co", K3_SITES + K3_WIDE)
def test_k3_chunked_order_meets_k3_tol(ci, co):
    """At every site shape of the n model and at wider and odd ones (P = 64),
    with and without SiLU, a plain model of the bf16 K3's order meets
    K3_TOL[bf16] against `qconv1x1_fused_plain`."""
    rng = np.random.default_rng(ci * 100 + co)
    x = torch.from_numpy(rng.normal(size=(64, 1, 1, 4, ci)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(4, co, ci)) / np.sqrt(4 * ci)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (4, co)).astype(np.float32))
    shift = torch.from_numpy((rng.normal(size=(4, co)) * 0.1).astype(np.float32))
    for silu in (True, False):
        ref = qconv_fused.qconv1x1_fused_plain(x, w, scale, shift, apply_silu=silu)
        got = _k3_chunked_model(x, w, scale, shift, silu)
        assert got.dtype == torch.bfloat16
        assert_close(got, ref.float().numpy(), *qconv_fused.K3_TOL[torch.bfloat16],
                     err_msg=f"Ci={ci} Co={co} silu={silu}")



def test_conv_fused_1x1_matches_pallas_kernel(monkeypatch):
    monkeypatch.setenv("QUAN_FUSED_1X1", "1")
    x = np.random.default_rng(1).normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
    jmod = jc.Conv(32, 48, 1)
    v = jax_variables(jmod, jnp.asarray(x))
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(v, jnp.asarray(x))
    tmod = load_jax_variables(tc.Conv(32, 48, 1, fused_1x1=True), v).eval()
    assert tmod.fused
    with torch.no_grad():
        got = tmod(to_torch(x))
    assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("silu", [True, False])
def test_qconv1x1_fused_plain_matches_pallas(silu):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
    w = (rng.normal(size=(4, 1, 1, 8, 12)) * 0.3).astype(np.float32)
    gamma, var = (rng.uniform(0.5, 1.5, (4, 12)).astype(np.float32) for _ in range(2))
    beta, mean = ((rng.normal(size=(4, 12)) * 0.1).astype(np.float32) for _ in range(2))
    jscale, jshift = jqf.fold_iqbn(*(jnp.asarray(a) for a in (gamma, beta, mean, var)))
    ref = jqf.qconv1x1_fused(jnp.asarray(x), jnp.asarray(w), jscale, jshift, block_p=64,
                             apply_silu=silu)
    scale, shift = qconv_fused.fold_iqbn(*(to_torch(a) for a in (gamma, beta, mean, var)))
    assert_close(scale, jscale, rtol=1e-6, atol=1e-7)
    w_port = to_torch(np.transpose(w, (0, 4, 3, 1, 2)))  # [4, Co, Ci, 1, 1]
    got = qconv_fused.qconv1x1_fused(to_torch(x), w_port, scale, shift, apply_silu=silu)
    assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("ci", [8, 12])
def test_qconv1x1_fused_plain_matches_pallas_bf16(ci, silu):
    """bf16 inputs: the plain version against the JAX kernel in interpret mode
    (bf16 products, f32 sums), at Ci = 8 and 12, within K3_TOL[bf16]."""
    rng = np.random.default_rng(ci)
    x = rng.normal(size=(2, 4, 8, 4, ci)).astype(np.float32)
    w = (rng.normal(size=(4, 1, 1, ci, 16)) / np.sqrt(4 * ci)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (4, 16)).astype(np.float32)
    shift = (rng.normal(size=(4, 16)) * 0.1).astype(np.float32)
    ref = jqf.qconv1x1_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
                             jnp.asarray(shift), block_p=64, apply_silu=silu)
    assert ref.dtype == jnp.bfloat16
    w_port = to_torch(np.transpose(w, (0, 4, 3, 1, 2)))  # [4, Co, Ci, 1, 1]
    got = qconv_fused.qconv1x1_fused(to_torch(x).bfloat16(), w_port, to_torch(scale),
                                     to_torch(shift), apply_silu=silu)
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(ref, dtype=np.float32), *qconv_fused.K3_TOL[torch.bfloat16])
