"""The port's last tooling modules against the JAX package's: the Poincare-ball
ops (``ops/qgeo.py``), the chi(4) quaternion init (``ops/qinit.py``), the loss
prototypes (``losses/prototypes.py``), ``utils/instance.py``, and the dataset
tools ``data/converter.py`` and ``data/split_dota.py`` (which read and write
images without OpenCV: the crops must be ``cv2.imwrite``'s bytes).
"""

from __future__ import annotations

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads  # noqa: F401


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_qgeo_matches_jax():
    from quan_ultralytics_tpu.ops import qgeo as J
    from quan_ultralytics_tpu_torch.ops import qgeo as T

    x = (_rng(0).normal(size=(5, 3, 4)) * 0.2).astype(np.float32)
    y = (_rng(1).normal(size=(5, 3, 4)) * 0.2).astype(np.float32)
    for c in (1.0, 0.5):
        np.testing.assert_allclose(T.mobius_add(torch.from_numpy(x), torch.from_numpy(y), c).numpy(),
                                   np.asarray(J.mobius_add(jnp.asarray(x), jnp.asarray(y), c)), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(T.expmap0(torch.from_numpy(x * 4), c).numpy(),
                                   np.asarray(J.expmap0(jnp.asarray(x * 4), c)), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(T.logmap0(torch.from_numpy(x), c).numpy(),
                                   np.asarray(J.logmap0(jnp.asarray(x), c)), rtol=1e-5, atol=1e-7)


def test_poincare_qconv2d_matches_jax(torch_threads):
    from quan_ultralytics_tpu.ops import qgeo as J
    from quan_ultralytics_tpu_torch.ops import qgeo as T

    rng = _rng(2)
    v = (rng.normal(size=(1, 6, 6, 4, 4)) * 0.3).astype(np.float32)
    x = np.array(jnp.moveaxis(J.expmap0(jnp.moveaxis(jnp.asarray(v), -2, -1)), -1, -2))
    w = (rng.normal(size=(4, 3, 3, 4, 4)) * 0.2).astype(np.float32)  # JAX layout
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    for stride in (1, 2):
        ref = np.asarray(J.poincare_qconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=1))
        got = T.poincare_qconv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(0, 4, 3, 1, 2).copy()),
                                 torch.from_numpy(b), stride=stride, padding=1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
        assert float(got.norm(dim=-2).max()) < 1.0  # inside the ball


def test_prototype_losses_match_jax():
    from quan_ultralytics_tpu.losses import prototypes as J
    from quan_ultralytics_tpu_torch.losses import prototypes as T

    rng = _rng(3)
    a = rng.uniform(-np.pi / 4, 3 * np.pi / 4, size=(6, 7)).astype(np.float32)
    b = rng.uniform(-np.pi / 4, 3 * np.pi / 4, size=(6, 7)).astype(np.float32)
    w = rng.uniform(0, 1, size=(6, 7)).astype(np.float32)
    ta, tb, tw = (torch.from_numpy(v) for v in (a, b, w))
    ja, jb, jw = (jnp.asarray(v) for v in (a, b, w))
    np.testing.assert_allclose(float(T.quaternion_obb_loss(ta, tb)), float(J.quaternion_obb_loss(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(T.quaternion_obb_loss(ta, tb, tw)), float(J.quaternion_obb_loss(ja, jb, jw)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(T.temporal_smoothness_loss(ta, tb)),
                               float(J.temporal_smoothness_loss(ja, jb)), rtol=1e-5)


@pytest.mark.parametrize("criterion", ["he", "glorot"])
def test_quaternion_chi_init_statistics_match_jax(criterion):
    """The generators differ, so the draws are held by their statistics: the
    magnitude is chi(4) scaled by the criterion (E|w|^2 = 4 sigma^2), the
    real part carries half of it and each imaginary part a sixth (a uniform
    phase, a uniform unit axis), as in the JAX draw of the same shape."""
    import jax

    from quan_ultralytics_tpu.ops.qinit import quaternion_chi_init as jinit
    from quan_ultralytics_tpu_torch.ops.qinit import quaternion_chi_init

    cout, cin, k = 64, 32, 3
    w = quaternion_chi_init(criterion)((4, cout, cin, k, k), generator=torch.Generator().manual_seed(0)).numpy()
    wj = np.asarray(jinit(criterion)(jax.random.PRNGKey(0), (4, k, k, cin, cout)))
    assert w.shape == (4, cout, cin, k, k)
    fan_in, fan_out = k * k * cin, k * k * cout
    sigma2 = 1.0 / (2.0 * fan_in) if criterion == "he" else 1.0 / (fan_in + fan_out)
    for arr in (w, wj):
        comp_var = (arr.reshape(4, -1) ** 2).mean(axis=1) / sigma2
        np.testing.assert_allclose(comp_var, [2.0, 2 / 3, 2 / 3, 2 / 3], rtol=0.05)
        np.testing.assert_allclose((arr ** 2).sum(0).mean() / sigma2, 4.0, rtol=0.03)
    imag = w[1:].reshape(3, -1)
    phase_sin2 = (imag ** 2).sum(0) / (w ** 2).sum(0).reshape(-1)
    axis = imag / np.sqrt((imag ** 2).sum(0)).clip(1e-12)
    np.testing.assert_allclose(np.sqrt((axis ** 2).sum(0)), 1.0, rtol=1e-5)  # unit axes
    np.testing.assert_allclose(phase_sin2.mean(), 0.5, atol=0.02)  # E sin^2 of a uniform phase


def _instances_ops(mod):
    b = mod.Bboxes(np.array([[10, 10, 30, 40], [5, 6, 7, 9]], np.float32), "xyxy")
    out = [b.areas()]
    for fmt in ("xywh", "ltwh", "xyxy"):
        b.convert(fmt)
        out.append(b.bboxes.copy())
    b.mul(0.5)
    b.add((1, 2, 3, 4))
    out += [b.bboxes.copy(), b[1].bboxes.copy()]
    rng = _rng(4)
    inst = mod.Instances(np.array([[0.5, 0.5, 0.2, 0.4], [0.1, 0.9, 0.3, 0.3], [0.5, 0.5, 0.0, 0.2]], np.float32),
                         segments=rng.random((3, 5, 2)).astype(np.float32),
                         keypoints=rng.random((3, 17, 3)).astype(np.float32), bbox_format="xywh")
    inst.denormalize(100, 200)
    inst.add_padding(4, 6)
    inst.fliplr(108)
    inst.flipud(212)
    inst.convert_bbox("xyxy")
    inst.clip(90, 190)
    inst.scale(0.5, 2.0)
    keep = inst.remove_zero_area_boxes()
    inst.normalize(54, 424)
    return out + [inst.bboxes, inst.bbox_areas, inst.segments, inst.keypoints, keep, np.array(len(inst))]


def test_instances_match_jax():
    from quan_ultralytics_tpu.utils import instance as J
    from quan_ultralytics_tpu_torch.utils import instance as T

    for got, ref in zip(_instances_ops(T), _instances_ops(J)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        T.Bboxes(np.zeros((2, 4)), "cxcy")


def test_dota_converter_labels_equal_jax(tmp_path):
    from quan_ultralytics_tpu.data.converter import DOTA_CLASSES, convert_dota_to_yolo_obb as jconvert
    from quan_ultralytics_tpu_torch.data.converter import convert_dota_to_yolo_obb

    rng = _rng(5)
    for root in (tmp_path / "jax", tmp_path / "port"):
        for split, sizes in (("train", [(300, 400), (257, 199)]), ("val", [(128, 96)])):
            (root / "images" / split).mkdir(parents=True)
            (root / "labelTxt" / split).mkdir(parents=True)
    for split, sizes in (("train", [(300, 400), (257, 199)]), ("val", [(128, 96)])):
        for i, (h, w) in enumerate(sizes):
            im = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            rows = ["imagesource:GoogleEarth", "gsd:0.146"]
            for _ in range(int(rng.integers(0, 6))):
                pts = rng.uniform(0, min(h, w), size=8)
                name = DOTA_CLASSES[int(rng.integers(0, 15))] if rng.random() > 0.1 else "container-crane"
                rows.append(" ".join(f"{v:.1f}" for v in pts) + f" {name} {int(rng.integers(0, 2))}")
            ext = ".png" if i % 2 == 0 else ".jpg"
            for root in (tmp_path / "jax", tmp_path / "port"):
                cv2.imwrite(str(root / "images" / split / f"P{i:04d}{ext}"), im)
                (root / "labelTxt" / split / f"P{i:04d}.txt").write_text("\n".join(rows) + "\n")
    assert convert_dota_to_yolo_obb(str(tmp_path / "port")) == jconvert(str(tmp_path / "jax")) == 3
    ref = sorted((tmp_path / "jax" / "labels").rglob("*.txt"))
    got = sorted((tmp_path / "port" / "labels").rglob("*.txt"))
    assert [p.relative_to(tmp_path / "port") for p in got] == [p.relative_to(tmp_path / "jax") for p in ref]
    for g, r in zip(got, ref):
        assert g.read_bytes() == r.read_bytes()


def test_coco_converter_labels_equal_jax(tmp_path):
    from quan_ultralytics_tpu.data.converter import convert_coco_to_yolo as jconvert
    from quan_ultralytics_tpu_torch.data.converter import convert_coco_to_yolo

    rng = _rng(6)
    images = [{"id": i + 1, "file_name": f"im{i}.jpg", "width": 640, "height": 480} for i in range(3)]
    anns = [{"image_id": int(rng.integers(1, 4)), "category_id": int(rng.choice([1, 7, 90])),
             "bbox": [float(v) for v in rng.uniform(0, 300, size=4)], "iscrowd": int(rng.random() < 0.2)}
            for _ in range(12)]
    j = tmp_path / "ann.json"
    j.write_text(json.dumps({"images": images, "categories": [{"id": c} for c in (1, 7, 90)],
                             "annotations": anns}))
    assert convert_coco_to_yolo(str(j), str(tmp_path / "port")) == jconvert(str(j), str(tmp_path / "jax")) == 3
    for i in range(3):
        assert (tmp_path / "port" / f"im{i}.txt").read_bytes() == (tmp_path / "jax" / f"im{i}.txt").read_bytes()


def test_split_dota_equals_jax_and_writes_cv2_bytes(tmp_path):
    from quan_ultralytics_tpu.data import split_dota as J
    from quan_ultralytics_tpu_torch.data import split_dota as T

    rng = _rng(7)
    h, w = 700, 900
    im = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    src = tmp_path / "P0001.png"
    cv2.imwrite(str(src), im)
    rows = []
    for _ in range(40):
        cx, cy = rng.uniform(0, 1, size=2)
        dx, dy = rng.uniform(0.005, 0.08, size=2)
        pts = np.array([cx - dx, cy - dy, cx + dx, cy - dy, cx + dx, cy + dy, cx - dx, cy + dy])
        rows.append(f"{int(rng.integers(0, 15))} " + " ".join(f"{v:.6f}" for v in pts))
    lbl = tmp_path / "P0001.txt"
    lbl.write_text("\n".join(rows) + "\n")
    np.testing.assert_array_equal(T.get_windows((h, w), (256,), (64,)), J.get_windows((h, w), (256,), (64,)))
    n_port = T.split_image(str(src), str(lbl), tmp_path / "port" / "images", tmp_path / "port" / "labels",
                           crop_size=256, gap=64)
    n_jax = J.split_image(str(src), str(lbl), tmp_path / "jax" / "images", tmp_path / "jax" / "labels",
                          crop_size=256, gap=64)
    assert n_port == n_jax > 4
    for kind in ("images", "labels"):
        got = sorted((tmp_path / "port" / kind).iterdir())
        ref = sorted((tmp_path / "jax" / kind).iterdir())
        assert [p.name for p in got] == [p.name for p in ref]
        for g, r in zip(got, ref):  # the crops: cv2.imwrite's JPEG bytes
            assert g.read_bytes() == r.read_bytes(), g.name
    with pytest.raises(ValueError):
        T.get_windows((h, w), (64,), (64,))
