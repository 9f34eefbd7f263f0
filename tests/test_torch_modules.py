"""Port modules vs the JAX package's flax modules: same seeded inputs, JAX
variables carried over by ``load_jax_variables``, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.models import block as jb
from quan_ultralytics_tpu.models import conv as jc
from quan_ultralytics_tpu.models import head as jh
from quan_ultralytics_tpu_torch.models import block as tb
from quan_ultralytics_tpu_torch.models import conv as tc
from quan_ultralytics_tpu_torch.models import head as th
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

RTOL, ATOL = 2e-4, 2e-5


def _run_both(jmod, tmod, x, seed=0, rtol=RTOL, atol=ATOL):
    """Eval forward of both modules on ``x`` with the same (carried) variables."""
    v = jax_variables(jmod, jnp.asarray(x), seed=seed)
    ref = jax.jit(lambda v, x: jmod.apply(v, x))(v, jnp.asarray(x))
    load_jax_variables(tmod, v).eval()
    with torch.no_grad():
        got = tmod(to_torch(x))
    assert got.shape == ref.shape
    assert_close(got, ref, rtol=rtol, atol=atol)
    return v


def _bhwqc(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_qconv2d_rgb_first_layer():
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    _run_both(jc.QConv2D(3, 16, 3, 2), tc.QConv2D(3, 16, 3, 2), x)


@pytest.mark.parametrize("impl", ["grouped", "folded", "auto"])
def test_qconv2d_with_bias(impl):
    _run_both(jc.QConv2D(16, 24, 3, 1), tc.QConv2D(16, 24, 3, 1, impl=impl), _bhwqc((2, 6, 5, 4, 4)))


def test_iqbn_eval_and_train():
    x = _bhwqc((2, 5, 4, 4, 6)) * 2 + 0.5
    jmod, tmod = jc.IQBN(24), tc.IQBN(24)
    v = _run_both(jmod, tmod, x)
    ref, upd = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    tmod.train()
    got = tmod(to_torch(x))
    assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert_close(tmod.mean, upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-6)
    assert_close(tmod.var, upd["batch_stats"]["var"], rtol=1e-5, atol=1e-6)


def test_conv_and_dwconv():
    x = _bhwqc((2, 8, 8, 4, 4))
    _run_both(jc.Conv(16, 32, 3, 2), tc.Conv(16, 32, 3, 2), x)
    x = _bhwqc((2, 6, 6, 4, 8))
    _run_both(jc.DWConv(32, 32, 3), tc.DWConv(32, 32, 3), x)


@pytest.mark.parametrize("c3k", [False, True])
def test_c3k2(c3k):
    _run_both(jb.C3k2(32, 32, 1, c3k), tb.C3k2(32, 32, 1, c3k), _bhwqc((2, 6, 6, 4, 8)))


def test_qsppf():
    _run_both(jb.QSPPF(32, 32), tb.QSPPF(32, 32), _bhwqc((2, 6, 6, 4, 8)))


def test_qc2psa():
    # c = 32 total: 2 heads of dk 2, dv 4 over N = 16 tokens
    _run_both(jb.QC2PSA(64, 64, 1), tb.QC2PSA(64, 64, 1), _bhwqc((2, 4, 4, 4, 16)))


def test_qer_q_major_flatten():
    x = _bhwqc((2, 5, 3, 4, 8))
    _run_both(jh.QER(32, 7, bias_init_value=1.0), th.QER(32, 7, bias_init_value=1.0), x)


def test_obb_head_and_decode():
    ch, strides, nc = (16, 32, 64), (8, 16, 32), 3
    xs = [_bhwqc((2, s, s, 4, c // 4), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jmod = jh.OBB(nc, ch, 1, strides)
    tmod = th.OBB(nc, ch, 1, strides)
    v = jax_variables(jmod, [jnp.asarray(x) for x in xs])

    def fwd(v, xs):
        feats, angles = jmod.apply(v, xs)
        return feats, angles, jh.decode_obb(feats, angles, strides, nc)

    rf, ra, rdec = jax.jit(fwd)(v, [jnp.asarray(x) for x in xs])
    load_jax_variables(tmod, v).eval()
    with torch.no_grad():
        gf, ga = tmod([to_torch(x) for x in xs])
        gdec = th.decode_obb(gf, ga, strides, nc)
    for g, r in zip(gf + ga, list(rf) + list(ra)):
        assert_close(g, r, rtol=RTOL, atol=ATOL)
    assert gdec.shape == rdec.shape == (2, 84, 4 + nc + 1)
    assert_close(gdec, rdec, rtol=RTOL, atol=1e-4)
