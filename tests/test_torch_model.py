"""The slice as a whole: yolo11n-obb-quan (nc=15) eval forward, decode_obb and
rotated NMS in the port vs the JAX package at imgsz 64, batch 2, f32 on the
CPU, with the JAX weights carried by ``load_jax_variables``; the port's
Predictor end to end; the weight carrying itself; and a reference-layout
state dict ported by each package, forward against forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.ops.boxes import non_max_suppression as jax_nms
from quan_ultralytics_tpu.utils import torch_port as jport
from quan_ultralytics_tpu_torch.engine.predictor import Predictor, Results
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression
from quan_ultralytics_tpu_torch.utils import torch_port as tport
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ = "yolo11n-obb-quan.yaml", 15, 64
CONF, IOU = 0.25, 0.45


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its seeded variables, the port model carrying them, input,
    JAX outputs, the jitted JAX forward + decode + NMS)."""
    jm = JaxDetectionModel.from_yaml(CFG, nc=NC)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    v = jax_variables(jm.module, jnp.asarray(x[:1]), train=False)

    @jax.jit
    def run(v, x):
        out = jm.apply(v, x)
        pred = jm.decode(out)
        return out, pred, jax_nms(pred, conf_thres=CONF, iou_thres=IOU, nc=NC, rotated=True)

    ref = run(v, jnp.asarray(x))
    tm = DetectionModel.from_yaml(CFG, nc=NC, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm, x, ref, run


def test_forward_decode_and_nms_match_jax(pair):
    _, _, tm, x, ((rfeats, rangles), rpred, (rdet, rok)), _ = pair
    with torch.no_grad():
        feats, angles = tm(to_torch(x))
        pred = tm.decode((feats, angles))
    for g, r in zip(feats + angles, list(rfeats) + list(rangles)):
        assert g.shape == r.shape
        assert_close(g, r, rtol=2e-4, atol=2e-5)
    # decode: max abs err <= 1e-4 max|ref| + 1e-5
    rpred = np.asarray(rpred)
    assert pred.shape == rpred.shape == (2, 84, 4 + NC + 1)
    err = float(np.abs(pred.numpy() - rpred).max())
    assert err <= 1e-4 * float(np.abs(rpred).max()) + 1e-5, err

    det, ok = non_max_suppression(pred, conf_thres=CONF, iou_thres=IOU, nc=NC, rotated=True)
    rdet, rok = np.asarray(rdet), np.asarray(rok)
    assert 0 < int(ok.sum()) < 2 * 84, "NMS must keep some candidates and drop others"
    np.testing.assert_array_equal(ok.numpy(), rok)  # identical keep sets, in score order
    np.testing.assert_array_equal(det[..., 6].numpy(), rdet[..., 6])  # classes
    assert_close(det[..., :6], rdet[..., :6], rtol=2e-4, atol=1e-4)


def test_load_jax_variables_covers_every_leaf(pair):
    _, v, tm, _, _, _ = pair
    assert sum(p.numel() for p in tm.parameters()) == 693_568
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert n_leaves == len(tm.state_dict())
    # QConv2D weights are transposed to per-component OIHW, QER kernels to OIHW
    w_jax = np.asarray(v["params"]["model_10"]["m0"]["attn"]["qkv"]["w"])
    assert_close(tm.model[10].m0.attn.qkv.w, np.transpose(w_jax, (0, 4, 3, 1, 2)), rtol=0, atol=0)
    k_jax = np.asarray(v["params"]["model_23"]["detect"]["cv3_0_2"]["proj"]["kernel"])
    assert_close(tm.model[23].detect.cv3_0_2.proj.weight, np.transpose(k_jax, (3, 2, 0, 1)),
                 rtol=0, atol=0)
    # a missing or an extra leaf raises
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    del params["model_0"]["bn"]["gamma"]
    with pytest.raises(KeyError):
        load_jax_variables(DetectionModel.from_yaml(CFG, nc=NC, device="cpu"),
                           {"params": params, "batch_stats": v["batch_stats"]})
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    params["model_0"]["bn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        load_jax_variables(DetectionModel.from_yaml(CFG, nc=NC, device="cpu"),
                           {"params": params, "batch_stats": v["batch_stats"]})


def test_predictor_end_to_end_on_cpu(pair):
    _, _, tm, _, _, _ = pair
    frame = np.random.default_rng(3).integers(0, 256, (100, 140, 3), dtype=np.uint8)
    results = Predictor(tm, imgsz=IMGSZ, conf=CONF, iou=IOU)(frame)
    assert len(results) == 1
    r = results[0]
    assert isinstance(r, Results) and r.orig_shape == (100, 140)
    assert r.boxes.shape == (len(r), 7) and len(r) > 0
    assert np.isfinite(r.boxes).all()
    assert (r.conf > CONF).all() and ((r.cls >= 0) & (r.cls < NC)).all()
    w, h, t = r.xywhr[:, 2], r.xywhr[:, 3], r.xywhr[:, 4]
    assert (w >= h).all() and (t >= 0).all() and (t < np.pi).all()
    assert len(r.summary()) == len(r) and set(r.summary()[0]["box"]) == {
        "x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"}


def test_reference_state_dict_forward_matches_jax(pair):
    """A state dict in the PyTorch reference's names and layouts (the seeded
    variables through ``to_reference_state_dict``), loaded by each package's
    ``port_state_dict``: the port model's eval forward and decode against the
    JAX model's on the same input, at the forward tolerance above."""
    _, v, _, x, _, run = pair
    sd = tport.to_reference_state_dict(v, jport.torch_prefix)
    (rfeats, rangles), rpred, _ = run(jport.port_state_dict(sd, v), jnp.asarray(x))
    tm = tport.port_state_dict({k: to_torch(a) for k, a in sd.items()},
                               DetectionModel.from_yaml(CFG, nc=NC, device="cpu")).eval()
    with torch.no_grad():
        feats, angles = tm(to_torch(x))
        pred = tm.decode((feats, angles))
    for g, r in zip(feats + angles, list(rfeats) + list(rangles)):
        assert g.shape == r.shape
        assert_close(g, r, rtol=2e-4, atol=2e-5)
    rpred = np.asarray(rpred)
    assert pred.shape == rpred.shape
    assert float(np.abs(pred.numpy() - rpred).max()) <= 1e-4 * float(np.abs(rpred).max()) + 1e-5
