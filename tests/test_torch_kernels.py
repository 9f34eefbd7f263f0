"""The port's two kernels: K1 (fused attention forward) and K3 (fused 1x1
Conv+IQBN+SiLU).

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
