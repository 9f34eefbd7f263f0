"""The port's int8 serving path (``ops/qconv.py`` `qconv2d_int8`,
``QConv2D(impl="int8")``, ``ops/quant.py`` `calibrate_int8`, the ``quant``
collection of ``utils/weights.py``) against the JAX package's
(``ops/qconv.py`` qconv2d_int8, ``QUAN_QCONV_IMPL=int8``, ``ops/quant.py``).

The int32 accumulators must be equal: both quantize with the same f32
divisions and round half to even, and both accumulate exactly (JAX's s8 x
s8 conv into int32; the port's `int8_matmul`, here its exact float64
product). The dequantized outputs are then within one unit in the last
place of the output dtype.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from quan_ultralytics_tpu.ops.mixing import MIX_MATRIX
from quan_ultralytics_tpu.ops.qconv import fold_dense_kernel as jfold
from quan_ultralytics_tpu.ops.qconv import qconv2d_int8 as jqconv2d_int8
from quan_ultralytics_tpu_torch.models.conv import Conv, QConv2D
from quan_ultralytics_tpu_torch.ops.qconv import int8_accumulator, int8_matmul, int8_matmul_plain, qconv2d_int8
from torch_port_helpers import torch_threads  # noqa: F401

CASES = [(k, s, static) for k in (1, 3) for s in (1, 2) for static in (False, True)]


def _operands(k: int, cin: int = 6, cout: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 9, 11, 4, cin)).astype(np.float32)
    w = (rng.normal(size=(4, k, k, cin, cout)) * 0.3).astype(np.float32)  # JAX layout
    b = rng.normal(size=(cout,)).astype(np.float32)
    dk = np.asarray(jfold(jnp.asarray(w), jnp.asarray(MIX_MATRIX)))  # HWIO [k, k, 4 cin, 4 cout]
    return x, dk, b


def _jax_accumulator(x, dk, k, s, amax=None, eps=1e-8):
    """JAX qconv2d_int8's quantized operands and int32 accumulator, step by step."""
    B, H, W, _, cin = x.shape
    xf = jnp.asarray(x).reshape(B, H, W, 4 * cin)
    amax = jnp.max(jnp.abs(xf.astype(jnp.float32))) if amax is None else jnp.float32(amax)
    sx = amax / 127.0 + eps
    xq = jnp.clip(jnp.round(xf.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    kf = jnp.asarray(dk, jnp.float32)
    swt = jnp.max(jnp.abs(kf), axis=(0, 1, 2)) / 127.0 + eps
    wq = jnp.clip(jnp.round(kf / swt), -127, 127).astype(jnp.int8)
    p = k // 2
    return np.asarray(lax.conv_general_dilated(xq, wq, (s, s), ((p, p), (p, p)),
                                               dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                               preferred_element_type=jnp.int32))


@pytest.mark.parametrize("k,s,static", CASES)
def test_int8_accumulator_equals_jax(k, s, static):
    x, dk, _ = _operands(k)
    amax = np.float32(np.abs(x).max() * 0.8) if static else None  # a calibrated scale clips
    ref = _jax_accumulator(x, dk, k, s, amax)
    acc, _, _ = int8_accumulator(torch.from_numpy(x), torch.from_numpy(dk.transpose(3, 2, 0, 1).copy()),
                                 stride=s, padding=k // 2,
                                 act_absmax=None if amax is None else torch.tensor(amax))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,static", CASES)
def test_qconv2d_int8_matches_jax(k, s, static, dtype):
    x, dk, b = _operands(k, seed=1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jd)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    amax = np.float32(2.5) if static else None
    ref = np.asarray(jqconv2d_int8(xj, jnp.asarray(dk), jnp.asarray(b), stride=s, padding=k // 2,
                                   act_absmax=None if amax is None else jnp.float32(amax)).astype(jnp.float32))
    got = qconv2d_int8(xt, torch.from_numpy(dk.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                       stride=s, padding=k // 2, act_absmax=None if amax is None else torch.tensor(amax))
    assert got.dtype == td and got.shape == ref.shape
    # within one unit in the last place of the dtype
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def test_int8_matmul_pads_and_is_exact():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, size=(5, 13), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(7, 13), dtype=np.int8))
    ref = a.long() @ w.long().t()
    np.testing.assert_array_equal(int8_matmul(a, w).numpy(), ref.numpy())
    np.testing.assert_array_equal(int8_matmul_plain(a, w).numpy(), ref.numpy())
    with pytest.raises(TypeError):
        int8_matmul(a.float(), w)


# ------------------------------------------------------------ calibration


class _JNet:
    """Three JAX ``Conv`` layers (3x3/2 from RGB, 3x3/2, 1x1) named as a
    YOLO graph's layers, so their quant paths are ``model_i/conv/act_absmax``."""

    def __init__(self):
        import flax.linen as fnn

        from quan_ultralytics_tpu.models.conv import Conv as JConv

        class Net(fnn.Module):
            @fnn.compact
            def __call__(self, x, train: bool = False):
                x = JConv(3, 16, 3, 2, name="model_0")(x, train=train)
                x = JConv(16, 32, 3, 2, name="model_1")(x, train=train)
                return JConv(32, 32, 1, 1, name="model_2")(x, train=train)

        self.module = Net()


class _TNet(torch.nn.Module):
    def __init__(self, impl: str = "int8", int8_min_c: int = 0):
        super().__init__()
        self.model = torch.nn.ModuleList([
            Conv(3, 16, 3, 2, impl=impl), Conv(16, 32, 3, 2, impl=impl), Conv(32, 32, 1, 1, impl=impl)])
        for m in self.modules():
            if isinstance(m, QConv2D):
                m.int8_min_c = int8_min_c

    def forward(self, x):
        for m in self.model:
            x = m(x)
        return x


@pytest.fixture(scope="module")
def calibrated():
    from quan_ultralytics_tpu.ops.quant import calibrate_int8 as jcalibrate

    net = _JNet()
    rng = np.random.default_rng(3)
    batches = [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2)]
    variables = net.module.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    variables = {k: v for k, v in variables.items()}
    calib = jcalibrate(net, variables, batches)
    saved = os.environ.get("QUAN_QCONV_IMPL")
    os.environ["QUAN_QCONV_IMPL"] = "int8"
    try:
        served = np.asarray(net.module.apply(calib, jnp.asarray(batches[1]), train=False))
    finally:
        if saved is None:
            os.environ.pop("QUAN_QCONV_IMPL", None)
        else:
            os.environ["QUAN_QCONV_IMPL"] = saved
    return {"variables": variables, "calib": calib, "batches": batches, "served": served}


def _port_net(variables):
    from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables

    net = _TNet().eval()
    load_jax_variables(net, variables)
    return net


def test_calibrate_int8_gives_the_jax_quant_values(calibrated, torch_threads):
    from quan_ultralytics_tpu_torch.ops.quant import calibrate_int8

    net = _port_net({k: v for k, v in calibrated["variables"].items()})
    calibrate_int8(net, [torch.from_numpy(b) for b in calibrated["batches"]])
    quant = calibrated["calib"]["quant"]
    for i in range(3):
        np.testing.assert_allclose(float(net.model[i].conv.act_absmax), float(quant[f"model_{i}"]["conv"]["act_absmax"]),
                                   rtol=1e-5, err_msg=f"layer {i}")
    with torch.no_grad():  # static scales: served within a quantization step of JAX
        got = net(torch.from_numpy(calibrated["batches"][1])).numpy()
    ref = calibrated["served"]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3 * np.abs(ref).max())


def test_quant_collection_crosses_both_ways(calibrated, torch_threads):
    from quan_ultralytics_tpu_torch.ops.quant import calibrate_int8
    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    plain = _port_net(calibrated["variables"])
    assert "quant" not in export_jax_variables(plain)  # uncalibrated: the state dict is unchanged
    assert not any(k.endswith("act_absmax") for k in plain.state_dict())
    loaded = _port_net(calibrated["calib"])  # JAX's calibrated scales serve in the port
    quant = calibrated["calib"]["quant"]
    for i in range(3):
        assert float(loaded.model[i].conv.act_absmax) == float(quant[f"model_{i}"]["conv"]["act_absmax"])
    back = export_jax_variables(loaded)["quant"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jax.device_get(quant))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax.device_get(quant))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    calibrate_int8(plain, [torch.from_numpy(b) for b in calibrated["batches"]])
    assert set(export_jax_variables(plain)["quant"]) == {"model_0", "model_1", "model_2"}


def test_calibrate_refuses_a_model_without_int8_convs(torch_threads):
    from quan_ultralytics_tpu_torch.ops.quant import calibrate_int8

    with pytest.raises(ValueError, match="no conv took the int8 path"):
        calibrate_int8(_TNet(impl="folded").eval(), [torch.rand(1, 32, 32, 3)])
    with pytest.raises(ValueError, match="no conv took the int8 path"):
        calibrate_int8(_TNet().eval(), [])


def test_int8_min_c_and_groups_fall_back(torch_threads):
    narrow = _TNet(int8_min_c=32).eval()  # layer 0 (c2 = 16) folds, layers 1-2 quantize
    assert [m.conv._impl() for m in narrow.model] == ["folded", "int8", "int8"]
    g = QConv2D(16, 16, 3, g=4, impl="int8")
    x = torch.randn(1, 6, 6, 4, 4)
    ref = QConv2D(16, 16, 3, g=4, impl="grouped")
    ref.load_state_dict(g.state_dict())
    torch.testing.assert_close(g(x), ref(x), rtol=0, atol=0)  # grouped convs stay grouped, as in JAX


def test_fused_1x1_keeps_precedence_over_int8(torch_threads):
    torch.manual_seed(0)
    fused = Conv(16, 32, 1, impl="int8", fused_1x1=True).eval()
    plain = Conv(16, 32, 1, impl="folded", fused_1x1=True).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 5, 5, 4, 4)
    torch.testing.assert_close(fused(x), plain(x), rtol=0, atol=0)


def test_trainer_refuses_int8(torch_threads):
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=3, device="cpu", impl="int8")
    with pytest.raises(RuntimeError, match="inference-only"):
        Trainer(model, TrainConfig(batch=2, nbs=2), 1, device="cpu")
