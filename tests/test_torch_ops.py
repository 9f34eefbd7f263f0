"""Port op core vs the JAX package: mixing, mappings, qconv (grouped and
folded), pooling and upsampling, on the same seeded inputs, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.ops import mappings as jmap
from quan_ultralytics_tpu.ops import mixing as jmix
from quan_ultralytics_tpu.ops import pooling as jpool
from quan_ultralytics_tpu.ops import qconv as jq
from quan_ultralytics_tpu_torch.ops import mappings as tmap
from quan_ultralytics_tpu_torch.ops import mixing as tmix
from quan_ultralytics_tpu_torch.ops import pooling as tpool
from quan_ultralytics_tpu_torch.ops import qconv as tq
from torch_port_helpers import assert_close, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _w_port(w):
    """JAX qconv weights [4, kh, kw, cin_pg, cout] -> the port's [4, cout, cin_pg, kh, kw]."""
    return to_torch(np.transpose(w, (0, 4, 3, 1, 2)))


def test_mix_components_matches():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(2, 3, 5, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(tmix.MIX_MATRIX, jmix.MIX_MATRIX)
    assert_close(tmix.mix_components(to_torch(s)), jmix.mix_components(jnp.asarray(s)),
                 rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mapping", tmap.MAPPING_TYPES)
def test_rgb_to_quaternion_matches(mapping):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    got = tmap.rgb_to_quaternion(to_torch(x), mapping)
    assert got.shape == (2, 5, 7, 4, 1)
    assert_close(got, jmap.rgb_to_quaternion(jnp.asarray(x), mapping), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,stride,groups,bias", [
    (1, 1, 1, False),
    (3, 2, 1, True),
    (3, 1, 2, False),  # grouped within each component (gcd groups)
])
def test_qconv2d_matches(k, stride, groups, bias):
    rng = np.random.default_rng(2)
    cin, cout = 4, 6
    x = rng.normal(size=(2, 9, 8, 4, cin)).astype(np.float32)
    w = rng.normal(size=(4, k, k, cin // groups, cout)).astype(np.float32) * 0.3
    b = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    pad = tq.autopad(k)
    assert pad == jq.autopad(k)
    ref = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                     stride=stride, padding=pad, groups=groups)
    got = tq.qconv2d(to_torch(x), _w_port(w), None if b is None else to_torch(b),
                     stride=stride, padding=pad, groups=groups)
    assert got.shape == ref.shape
    assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_qconv2d_folded_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 6, 6, 4, 3)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3, 5)).astype(np.float32) * 0.3
    b = rng.normal(size=(5,)).astype(np.float32)
    dk_ref = jq.fold_dense_kernel(jnp.asarray(w), jnp.asarray(jmix.MIX_MATRIX))
    dk = tq.fold_dense_kernel(_w_port(w), to_torch(tmix.MIX_MATRIX))
    # port OIHW [(q, co), (d, ci)] == JAX HWIO [(d, ci), (q, co)] transposed
    assert_close(dk, np.transpose(np.asarray(dk_ref), (3, 2, 0, 1)), rtol=1e-6, atol=1e-6)
    ref = jq.qconv2d_folded(jnp.asarray(x), dk_ref, jnp.asarray(b), stride=2, padding=(1, 1))
    got = tq.qconv2d_folded(to_torch(x), dk, to_torch(b), stride=2, padding=(1, 1))
    assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # and the folded form equals the grouped one
    assert_close(got, tq.qconv2d(to_torch(x), _w_port(w), to_torch(b), stride=2, padding=1),
                 rtol=1e-5, atol=1e-5)


def test_qmax_pool_and_qupsample_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 6, 4, 3)).astype(np.float32)
    assert_close(tpool.qmax_pool(to_torch(x), 5, 1, 2), jpool.qmax_pool(jnp.asarray(x), 5, 1, 2),
                 rtol=0, atol=0)
    assert_close(tpool.qupsample(to_torch(x), 2), jpool.qupsample(jnp.asarray(x), 2), rtol=0, atol=0)
