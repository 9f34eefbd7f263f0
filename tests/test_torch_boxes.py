"""Port box math and preprocessing vs the JAX package: probiou, rotated
NMS, regularize_rboxes on fixtures, and the torch letterbox vs the JAX
package's OpenCV letterbox."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.data.augment import letterbox as jax_letterbox
from quan_ultralytics_tpu.models import head as jh
from quan_ultralytics_tpu.ops import boxes as jbx
from quan_ultralytics_tpu_torch.data.augment import letterbox
from quan_ultralytics_tpu_torch.models import head as th
from quan_ultralytics_tpu_torch.ops import boxes as tbx
from torch_port_helpers import assert_close, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _rboxes(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    t = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))
    return np.concatenate([xy, wh, t], axis=1).astype(np.float32)


def test_probiou_and_regularize_match():
    a, b = _rboxes(40, 0), _rboxes(40, 1)
    b[:10] = a[:10] + np.float32(0.5)  # overlapping pairs, not just disjoint ones
    assert_close(tbx.probiou(to_torch(a), to_torch(b)), jbx.probiou(jnp.asarray(a), jnp.asarray(b)),
                 rtol=1e-5, atol=1e-6)
    assert_close(tbx.regularize_rboxes(to_torch(a)), jbx.regularize_rboxes(jnp.asarray(a)),
                 rtol=1e-6, atol=1e-6)
    assert_close(tbx.xywhr2xyxyxyxy(to_torch(a)), jbx.xywhr2xyxyxyxy(jnp.asarray(a)),
                 rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("xywh", [True, False])
def test_anchors_dist2bbox_and_xywh2xyxy_match(xywh):
    shapes, strides = [(4, 6), (2, 3)], (8, 16)
    anchors, stride_t = tbx.make_anchors(shapes, strides)
    ja, js = jbx.make_anchors(shapes, strides)
    assert_close(anchors, ja, rtol=0, atol=0)
    assert_close(stride_t, js, rtol=0, atol=0)
    dist = np.random.default_rng(4).uniform(0, 5, (2, anchors.shape[0], 4)).astype(np.float32)
    got = tbx.dist2bbox(to_torch(dist), anchors[None], xywh=xywh)
    assert_close(got, jbx.dist2bbox(jnp.asarray(dist), ja[None], xywh=xywh), rtol=1e-6, atol=1e-6)
    x = _rboxes(16, 5)
    assert_close(tbx.xywh2xyxy(to_torch(x)), jbx.xywh2xyxy(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_decode_detect_matches():
    rng = np.random.default_rng(6)
    nc, strides = 3, (8, 16)
    feats = [rng.normal(size=(2, s, s, 64 + nc)).astype(np.float32) for s in (4, 2)]
    ref = jh.decode_detect([jnp.asarray(f) for f in feats], strides, nc)
    got = th.decode_detect([to_torch(f) for f in feats], strides, nc)
    assert got.shape == ref.shape == (2, 20, 4 + nc)
    assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_nms_rotated_matches():
    boxes = _rboxes(64, 2)
    boxes[32:] = boxes[:32] + np.float32(1.0)  # near-duplicates that must suppress
    scores = np.random.default_rng(3).uniform(0, 1, 64).astype(np.float32)
    ref = np.asarray(jbx.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), 0.45))
    got = tbx.nms_rotated(to_torch(boxes), to_torch(scores), 0.45).numpy()
    assert 0 < ref.sum() < 64
    np.testing.assert_array_equal(got, ref)
    # batched form == per image
    both = tbx.nms_rotated(to_torch(np.stack([boxes, boxes[::-1].copy()])),
                           to_torch(np.stack([scores, scores[::-1].copy()])), 0.45).numpy()
    np.testing.assert_array_equal(both[0], ref)
    np.testing.assert_array_equal(both[1], ref[::-1])


@pytest.mark.parametrize("shape", [(100, 140), (300, 200), (64, 64), (37, 90)])
def test_letterbox_matches_opencv(shape):
    im = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    ref, r_ref, pad_ref = jax_letterbox(im, 128)
    got, r, pad = letterbox(torch.from_numpy(im), 128)
    assert r == r_ref and pad == pad_ref
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    diff = np.abs(got.numpy().astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, f"max gray-level difference {diff.max()}"


def test_letterbox_without_scaleup_or_centering_matches_opencv():
    im = np.random.default_rng(7).integers(0, 256, (37, 90, 3), dtype=np.uint8)
    ref, r_ref, pad_ref = jax_letterbox(im, 128, scaleup=False, center=False)
    got, r, pad = letterbox(torch.from_numpy(im), 128, scaleup=False, center=False)
    assert r == r_ref == 1.0 and pad == pad_ref
    np.testing.assert_array_equal(got.numpy(), ref)
