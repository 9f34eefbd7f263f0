"""Shared pieces of the tests that hold the PyTorch port against the JAX package.

Inputs and weights are drawn with numpy from a seed and fed to both
packages. JAX variable trees come from ``jax.eval_shape(module.init)`` filled
with numpy draws (a real ``init`` of the full model costs about a minute on
the CPU), and the JAX side runs under ``jax.jit``.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch


def fill_variables(shapes, seed: int = 0):
    """A JAX variable tree with the shapes of ``shapes`` and seeded numpy values.

    Drawn away from the init defaults so that layouts and transposes show:
    quaternion conv weights U(-b, b) with b = sqrt(3 / fan_in) / 2 (the
    mixing sums four component convs, so this keeps the activations' scale
    from layer to layer), QDense weights ``[4, F_in, F_out]`` likewise with
    fan_in = F_in; QER kernels and dense kernels ``[in, out]`` with b =
    sqrt(3 / fan_in); IQBN gamma U(0.5, 1.5), beta and mean N(0, 0.1), var
    U(0.5, 1.5); biases N(0, 0.1).
    """
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape, dt = leaf.shape, np.float32
        if name == "w":  # QConv2D [4, kh, kw, cin_pg, cout], QDense [4, fin, fout]
            b = math.sqrt(3.0 / max(int(np.prod(shape[1:-1])), 1)) / 2
            return rng.uniform(-b, b, shape).astype(dt)
        if name == "kernel":  # QER [kh, kw, cin, cout], Dense [in, out]
            b = math.sqrt(3.0 / max(int(np.prod(shape[:-1])), 1))
            return rng.uniform(-b, b, shape).astype(dt)
        if name in ("gamma", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(dt)
        if name in ("beta", "mean", "bias", "b"):
            return (rng.normal(size=shape) * 0.1).astype(dt)
        raise KeyError(f"no draw rule for leaf {name!r}")

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Seeded variables of a flax module, shaped by ``eval_shape`` of its init."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return fill_variables(shapes, seed)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_close(got, ref, rtol=2e-4, atol=2e-5, err_msg=""):
    """``|got - ref| <= rtol |ref| + atol max(1, max|ref|)`` elementwise.

    The absolute term scales with the output's magnitude: a deep f32 graph
    whose outputs reach tens carries rounding of that order into every
    element, the near-zero ones included.
    """
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale, err_msg=err_msg)


@pytest.fixture
def torch_threads():
    """Two torch threads while the test runs (the suite runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
