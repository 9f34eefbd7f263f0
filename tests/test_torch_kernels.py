"""The port's kernels: K1 (fused attention forward), K2 (its backward) and
K3 (fused 1x1 Conv+IQBN+SiLU).

On the CPU the wrappers take their plain versions, which are held against
the JAX package's Pallas kernels in interpret mode (as its own
tests/test_pallas.py runs them). The CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py.
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


def _bf16_inputs(n=256):
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(1, 4, 2, n, 2)).astype(np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(1, 4, 2, n, 4)).astype(np.float32)) for _ in range(2))
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
        assert not qattn.bwd_error(r, a, torch.bfloat16)[2], f"the f32 {name} passes"
        assert qattn.bwd_error(other, a, torch.bfloat16)[2], f"the f64-accumulated {name} fails"
        assert not torch.equal(a.float(), r)


@pytest.mark.parametrize("point", ["q2", "ks", "E", "dor", "U", "q2r"])
def test_bf16_tolerance_sees_each_rounding_point(point):
    """K2's bf16 tolerance fails a backward that leaves out any one of the TPU
    kernel's rounding points (q2, ks, E cast to V's dtype, dO r, U, q2 r ln2)."""
    bf = _bf16_inputs()
    ref = qattn.qattention_bwd_plain(*bf, 2 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(_bwd_variant(*bf, 2 ** -0.5), ref))
    mutant = _bwd_variant(*bf, 2 ** -0.5, skip=(point,))
    assert not all(qattn.bwd_error(a, r, torch.bfloat16)[2] for a, r in zip(mutant, ref))


# ---------------------------------------------------------------- K3, CPU


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
