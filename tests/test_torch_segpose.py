"""The port's segment and pose tasks against the JAX package on the CPU.

yolo11n-seg-quan (nc=3) and yolo11n-pose-quan (nc=1, 17 x 3 keypoints) at
imgsz 64, as the JAX package's ``tests/test_segpose.py``, with seeded JAX
variables (``jax_variables``) carried by ``load_jax_variables``:

* the graphs, the model forward and `decode_segment` / `decode_pose` in f32,
  the heads in bf16, `decode_kpts` in f32 and on bf16 maps;
* the labels (`resample_polygon`, the row parser), the loader's masks and
  keypoints, `fill_polygons` against ``cv2.fillPoly``, `_pose_sample` with
  both flips, and an augmenting segment batch (mosaic, warp, copy-paste);
* `segmentation_loss` and `pose_loss` with their gradients against
  ``jax.grad`` in f32, more than 64 foreground anchors with tied weights
  included; one port `Trainer.step` of each model;
* the Predictor (masks against the JAX package's ``cv2.resize``, as a share
  of unequal pixels), the pose `Results` formats, `mask_iou_np` and
  `kpt_oks_np`, and both Validators (mask mAP at proto and at input
  resolution, OKS mAP);
* a ``.pkl`` of each task read by both facades.

No JAX train step is compiled.
"""

import json
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.data import build as jbuild
from quan_ultralytics_tpu.data import dataset as jds
from quan_ultralytics_tpu.data.augment import AugmentHyp as JaxHyp
from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO
from quan_ultralytics_tpu.engine.predictor import Predictor as JaxPredictor
from quan_ultralytics_tpu.engine.predictor import Results as JaxResults
from quan_ultralytics_tpu.engine.validator import Validator as JaxValidator
from quan_ultralytics_tpu.losses import segpose as jsp
from quan_ultralytics_tpu.models import head as jh
from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.models.tasks import parse_model as jax_parse_model
from quan_ultralytics_tpu.utils import metrics as jmetrics
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data import build as tbuild
from quan_ultralytics_tpu_torch.data import dataset as tds
from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
from quan_ultralytics_tpu_torch.data.native import pixels as px
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.engine.predictor import Predictor, Results
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.engine.validator import Validator
from quan_ultralytics_tpu_torch.losses import segpose as tsp
from quan_ultralytics_tpu_torch.models import head as th
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites, parse_model, resolve_model_cfg
from quan_ultralytics_tpu_torch.utils import metrics as tmetrics
from quan_ultralytics_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import assert_close, jax_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

SEG, POSE = "yolo11n-seg-quan.yaml", "yolo11n-pose-quan.yaml"
NC = {SEG: 3, POSE: 1}
IMGSZ, STRIDES = 64, (8, 16, 32)
KPT = (17, 3)


def _tol(ref):
    """The decode tolerance of the port's tests: 1e-4 max|ref| + 1e-5."""
    return 1e-4 * (float(np.abs(ref).max()) if ref.size else 0.0) + 1e-5


# ---------------------------------------------------------------- graphs and forward


@pytest.mark.parametrize("name", [SEG, POSE])
def test_config_resolves_to_the_jax_graph(name):
    """The literal's layer specs are the JAX package's: the Segment proto
    channels width-scaled (256 -> 64 at n), the Pose head with its keypoint
    shape; the task and the columns riding through NMS; the fused 1x1 sites
    are the detect model's 37 (Proto and cv4 hold only 3x3 convs)."""
    cfg, scale = resolve_model_cfg(name)
    specs, save, nc = parse_model(cfg, scale)
    jspecs, jsave, jnc = jax_parse_model(cfg, scale)
    assert [(s.i, s.f, s.module, s.args, s.n, s.c2, s.stride) for s in specs] == \
           [(s.i, s.f, s.module, s.args, s.n, s.c2, s.stride) for s in jspecs]
    assert (save, nc) == (jsave, jnc) == (save, 80 if name == SEG else 1)
    model = DetectionModel.from_yaml(name, device="cpu", fused_1x1=True)
    assert model.task == JaxDetectionModel.from_yaml(name).task == ("segment" if name == SEG else "pose")
    if name == SEG:
        assert specs[-1].args[:3] == (80, 32, 64) and model.extra_dim == 32
        assert model.model[23].proto.cv3.proj.weight.shape == (32, 64, 1, 1)  # 64 proto channels in
    else:
        assert specs[-1].args[:2] == (1, [17, 3]) and model.kpt_shape == KPT and model.extra_dim == 51
        assert model.model[23].cv4_0_2.proj.weight.shape == (51, 52, 1, 1)  # c4 = ceil4(51)
    assert len(fused_1x1_sites(model, 2, 640)) == 37


@pytest.fixture(scope="module", params=[SEG, POSE])
def pair(request):
    """(name, JAX model, seeded variables, port model carrying them). The box
    branches' biases favour the low DFL bins (boxes a few strides wide, mostly
    in the frame)."""
    name = request.param
    jm = JaxDetectionModel.from_yaml(name, nc=NC[name])
    v = jax_variables(jm.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=2)
    det = v["params"]["model_23"]["detect"]
    for i in range(3):
        det[f"cv2_{i}_2"]["proj"]["bias"] = np.tile(-0.6 * np.arange(16, dtype=np.float32), 4)
    tm = DetectionModel.from_yaml(name, nc=NC[name], device="cpu")
    load_jax_variables(tm, v)
    return name, jm, v, tm


def test_forward_and_decode_match_jax(pair):
    """f32 eval forward on two frames: every head output (segment: feats, mc,
    proto; pose: feats, kpts) within the port's module tolerance, the
    decoded predictions within 1e-4 max|ref| + 1e-5; every leaf carried."""
    name, jm, v, tm = pair
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    out, pred = jax.jit(lambda v, x: (lambda o: (o, jm.decode(o)))(jm.apply(v, x)))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(to_torch(x))
        gpred = tm.decode(got)
    assert len(jax.tree_util.tree_leaves(v)) == len(tm.state_dict())
    flat = [*got[0], *got[1]] + ([got[2]] if name == SEG else [])
    ref = [*out[0], *out[1]] + ([out[2]] if name == SEG else [])
    for g, r in zip(flat, ref):
        assert g.shape == r.shape
        assert_close(g, r, rtol=2e-4, atol=2e-5)
    if name == SEG:
        assert got[2].shape == (2, 16, 16, 32) and gpred.shape == (2, 84, 4 + 3 + 32)
    else:
        assert gpred.shape == (2, 84, 4 + 1 + 51)
    rpred = np.asarray(pred)
    assert gpred.dtype == torch.float32
    np.testing.assert_allclose(gpred.numpy(), rpred, rtol=0, atol=_tol(rpred))


def _level_inputs(seed, c=64, B=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, IMGSZ // s, IMGSZ // s, 4, c // 4 * (2 ** k))).astype(np.float32)
            for k, s in enumerate(STRIDES)]


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_heads_match_jax_in_bf16(task):
    """The Segment and Pose heads alone in bf16 on carried variables (P3-P5
    inputs of 64, 128 and 256 channels): every output within 2e-2 max|ref|
    (each Conv rounds to bf16 once in both packages; XLA may keep more
    precision between ops), the outputs bf16 in both."""
    xs = _level_inputs(4)
    ch = tuple(4 * x.shape[-1] for x in xs)
    if task == "segment":
        jmod, tmod = jh.Segment(3, ch, 32, 64, dtype=jnp.bfloat16), th.Segment(3, ch, 32, 64, dtype=torch.bfloat16)
    else:
        jmod, tmod = jh.Pose(1, ch, KPT, dtype=jnp.bfloat16), th.Pose(1, ch, KPT, dtype=torch.bfloat16)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    v = jax_variables(jmod, jx, seed=5)
    ref = jax.tree_util.tree_leaves(jax.jit(lambda v, x: jmod.apply(v, x))(v, jx))
    load_jax_variables(tmod, v).eval()
    with torch.no_grad():
        got = jax.tree_util.tree_leaves(tmod([to_torch(x).to(torch.bfloat16) for x in xs]))
    assert len(got) == len(ref) == (7 if task == "segment" else 6)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16 and g.shape == r.shape
        r = np.asarray(r.astype(jnp.float32))
        assert_close(g, r, rtol=0, atol=2e-2)


def _maps(seed, c, dtype, B=2):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(B, IMGSZ // s, IMGSZ // s, c)) * 2, dtype) for s in STRIDES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoders_match_jax(dtype):
    """`decode_segment`, `decode_kpts` (3 and 2 values a keypoint) and
    `decode_pose` on seeded per-level maps of either dtype: f32 outputs within
    1e-4 max|ref| + 1e-5 (both cast the maps to f32 first)."""
    feats, mc = _maps(0, 64 + 3, dtype), _maps(1, 32, dtype)
    kp3, kp2 = _maps(2, 51, dtype), _maps(3, 34, dtype)

    def port(ms):
        return [to_torch(np.asarray(m.astype(jnp.float32))).to(getattr(torch, dtype)) for m in ms]

    f1 = _maps(4, 64 + 1, dtype)
    cases = [
        (jh.decode_segment(feats, mc, STRIDES, 3), th.decode_segment(port(feats), port(mc), STRIDES, 3)),
        (jh.decode_kpts(kp3, STRIDES, (17, 3)), th.decode_kpts(port(kp3), STRIDES, (17, 3))),
        (jh.decode_kpts(kp2, STRIDES, (17, 2)), th.decode_kpts(port(kp2), STRIDES, (17, 2))),
        (jh.decode_pose(f1, kp3, STRIDES, 1, (17, 3)), th.decode_pose(port(f1), port(kp3), STRIDES, 1, (17, 3))),
    ]
    for ref, got in cases:
        ref = np.asarray(ref)
        assert got.dtype == torch.float32 and ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("name", [SEG, POSE])
def test_checkpoints_read_both_ways(name, tmp_path):
    """A ``.pkl`` the JAX facade writes from seeded variables loads into the
    port's facade (every leaf, the pose head's 52 x 51 QER kernels included,
    carried exactly), and one the port's facade writes loads into the JAX
    facade with the same leaves."""
    jy = JaxYOLO(name, nc=NC[name])
    v = jax_variables(jy.model.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=6)
    jy.names = ["a", "b", "c"][:NC[name]]
    jpkl = tmp_path / "jax.pkl"
    jy._save_ckpt(jpkl, SimpleNamespace(ema_params=v["params"], batch_stats=v["batch_stats"],
                                        params=v["params"], step=jnp.int32(3)))
    port = YOLO(str(jpkl), device="cpu")
    assert port.task == jy.task and port.names == jy.names
    if name == POSE:
        k = np.asarray(v["params"]["model_23"]["cv4_2_2"]["proj"]["kernel"])
        assert k.shape == (1, 1, 52, 51)  # 51 outputs: not a multiple of 4
        assert torch.equal(port.model.model[23].cv4_2_2.proj.weight, to_torch(k.transpose(3, 2, 0, 1)))
    ppkl = tmp_path / "port.pkl"
    port._save_ckpt(ppkl, Trainer(port.model, TrainConfig(batch=2), steps_per_epoch=1, device="cpu"))
    back = JaxYOLO(str(ppkl))
    assert back.task == jy.task and back.names == jy.names
    for col in ("params", "batch_stats"):
        ref = jax.tree_util.tree_leaves_with_path(v[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back.variables[col]))
        assert len(got) == len(ref)
        for path, leaf in ref:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


# ---------------------------------------------------------------- labels and the loader


def _star(rng, n, cx, cy, r0, r1):
    """A star-shaped (concave) polygon of ``n`` vertices around (cx, cy)."""
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1, n)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], 1)


def test_resample_polygon_matches_jax():
    """Exactly the JAX package's points: triangles, 32-gons, 100-gons,
    self-crossing point lists and a polygon collapsed to one point."""
    rng = np.random.default_rng(0)
    polys = [_star(rng, n, 0.5, 0.5, 0.1, 0.4) for n in (3, 5, 32, 100)]
    polys += [rng.uniform(0, 1, (n, 2)) for n in (4, 7, 40)]
    polys += [np.full((5, 2), 0.25)]
    for p in polys:
        p = p.astype(np.float32)
        got = tds.resample_polygon(p)
        assert got.shape == (tds.SEG_POINTS, 2) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jds.resample_polygon(p))
    assert tds.SEG_POINTS == jds.SEG_POINTS == 32


# (h, w): longer side 64, so the square letterbox only pads
SIZES = [(64, 64), (48, 64), (64, 40), (56, 64), (64, 48), (40, 64)]


def _write_set(root, task, seed=0, own=None):
    """Seeded PNGs with labels of the task: segment 1-5 polygons of 3-40
    vertices (concave stars and self-crossing point lists); pose 1-4 figures
    of 17 keypoints, 3 values a point (visibility 0, 1 or 2) on some images
    and 2 on others. The last image has no label file. ``own`` (per image,
    label lines) is appended. Returns the data config."""
    rng = np.random.default_rng(seed)
    for d in ("images", "labels"):
        (root / d / "val").mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(SIZES):
        imwrite_png(root / "images" / "val" / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i == len(SIZES) - 1:
            continue
        rows = []
        for _ in range(int(rng.integers(1, 6 if task == "segment" else 5))):
            c = int(rng.integers(0, NC[SEG if task == "segment" else POSE]))
            if task == "segment":
                n = int(rng.integers(3, 41))
                pts = (_star(rng, n, *rng.uniform(0.3, 0.7, 2), 0.05, 0.3) if rng.random() < 0.7
                       else rng.uniform(0.1, 0.9, (n, 2)))
                rows.append([c, *np.clip(pts, 0, 1).reshape(-1)])
            else:
                ctr, wh = rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.5, 2)
                k = ctr + (rng.uniform(-0.5, 0.5, (17, 2)) * wh)
                if i % 2:
                    k = np.concatenate([k, rng.integers(0, 3, (17, 1))], 1)
                rows.append([c, *ctr, *wh, *k.reshape(-1)])
        lines = [" ".join(f"{v:.6f}" if j else str(v) for j, v in enumerate(r)) for r in rows]
        lines += (own or {}).get(i, [])
        (root / "labels" / "val" / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "train": "images/val", "val": "images/val", "names": {0: "a", 1: "b", 2: "c"}}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return {task: _write_set(tmp_path_factory.mktemp(task), task) for task in ("segment", "pose")}


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_label_parser_matches_jax(sets, task):
    """The samples equal the JAX package's: classes, resampled polygons or
    boxes, keypoints (visibility 1 where a row has 2 values a point), and
    the empty shapes of an image without labels."""
    ours, ref = YOLODataset(sets[task], "val", task=task), jds.YOLODataset(sets[task], "val", task=task)
    assert len(ours) == len(ref) == len(SIZES)
    for a, b in zip(ours.samples, ref.samples):
        assert a.im_file == b.im_file
        for k in ("cls", "bboxes", "kpts"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)
    last = ours.samples[-1]
    assert last.bboxes.shape == ((0, 64) if task == "segment" else (0, 4))
    if task == "pose":
        assert last.kpts.shape == (0, 17, 3) and (ours.samples[0].kpts[..., 2] == 1).all()


@pytest.mark.parametrize("task", ["segment", "pose"])
@pytest.mark.parametrize("with_meta", [False, True])
def test_loader_masks_and_keypoints_match_jax(sets, task, with_meta):
    """The non-augmenting loader's batches equal the JAX loader's: images,
    boxes, classes and validity exact; segment ``masks`` (uint8 here, f32 in
    JAX: the same 0/1 values) exact, and with ``with_meta`` the ``polys``
    list; pose ``keypoints`` exact (visibility zeroed outside the frame)."""
    kw = dict(batch_size=4, imgsz=IMGSZ, hyp=None, max_labels=8, augment=False, shuffle=False,
              drop_last=False, with_meta=with_meta)
    ours = list(build_dataloader(YOLODataset(sets[task], "val", task=task), **kw))
    ref = list(jbuild.build_dataloader(jds.YOLODataset(sets[task], "val", task=task), **kw))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            if k == "polys":
                assert len(a[k]) == len(b[k])
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(x, y)
            elif k in ("im_files", "n_real"):
                assert a[k] == b[k]
            else:
                if k == "masks":
                    assert a[k].dtype == np.uint8 and b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    extra = "masks" if task == "segment" else "keypoints"
    assert ours[0][extra].shape == ((4, 8, 16, 16) if task == "segment" else (4, 8, 17, 3))
    assert ours[0][extra].any()


def test_fill_polygons_equals_cv2_fillpoly():
    """One polygon a mask, as the loader fills it, against ``cv2.fillPoly`` on
    a float32 mask (the JAX loader's call), exactly: resampled concave stars
    and self-crossing 32-gons, in frame, across the borders (as after a
    mosaic) and far out, their points scaled to proto pixels and truncated
    toward zero by ``astype(int32)`` (negative ones included)."""
    rng = np.random.default_rng(1)
    n = 0
    for shape in ((16, 16), (160, 160), (120, 160), (7, 30)):
        h, w = shape
        for _ in range(150):
            kind = rng.integers(0, 3)
            if kind == 0:
                pts = _star(rng, int(rng.integers(3, 60)), *rng.uniform(0, 1, 2) * [w, h], 1, max(h, w) * 0.6)
            elif kind == 1:
                pts = rng.uniform(-0.3, 1.3, (int(rng.integers(3, 40)), 2)) * [w, h]
            else:
                pts = rng.uniform(-3, 4, (int(rng.integers(3, 12)), 2)) * [w, h]
            poly = (tds.resample_polygon(pts.astype(np.float32)) * np.float32(rng.uniform(0.2, 1.0))).astype(np.int32)
            ref = np.zeros(shape, np.float32)
            cv2.fillPoly(ref, [poly], 1.0)
            got = px.fill_polygons(np.zeros(shape, np.uint8), [poly])
            np.testing.assert_array_equal(got, ref.astype(np.uint8), err_msg=str(poly.tolist()))
            n += int(ref.any())
    assert n > 300  # most cases fill something


def test_pose_sample_matches_jax(sets):
    """`_pose_sample` with the photometric list, HSV and both flips (flipud =
    fliplr = 1: the COCO-17 left/right swap of points and visibility) from the
    same generator: every array equal to the JAX package's, bit for bit; and
    without augmentation too."""
    ours, ref = YOLODataset(sets["pose"], "val", task="pose"), jds.YOLODataset(sets["pose"], "val", task="pose")
    hyp = dict(flipud=1.0, fliplr=1.0)
    for i in range(len(SIZES)):
        for augment in (True, False):
            a = tbuild._pose_sample(ours, i, IMGSZ, 8, AugmentHyp(**hyp), np.random.default_rng(i), augment)
            b = jbuild._pose_sample(ref, i, IMGSZ, JaxHyp(**hyp), 8, np.random.default_rng(i), augment)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {augment} {k}")
    a = tbuild._pose_sample(ours, 0, IMGSZ, 8, AugmentHyp(**hyp), np.random.default_rng(0), True)
    b = tbuild._pose_sample(ours, 0, IMGSZ, 8, None, None, False)
    n = int(a["mask"].sum())
    flipped = IMGSZ - b["keypoints"][:n, tbuild.COCO_FLIP_IDX, :2] * IMGSZ  # the swap, undone by hand
    vis = b["keypoints"][:n, tbuild.COCO_FLIP_IDX, 2] > 0
    np.testing.assert_allclose(a["keypoints"][:n, :, :2][vis] * IMGSZ, flipped[vis], atol=1e-4)


WARP_SHARE = 1e-3  # the warps' share of values one gray level off (tests/test_torch_augment.py)
MASK_SHARE = 1e-3  # the share of mask pixels an augmenting batch may differ by


@pytest.mark.parametrize("hyp_kw", [{}, {"copy_paste": 1.0, "degrees": 10.0}])
def test_augmenting_segment_loader_matches_jax(sets, hyp_kw):
    """Two batches of the augmenting segment loader (mosaic, warp, HSV, flips;
    with copy-paste and rotation) against the JAX loader from the same seed:
    classes and validity exact, boxes within 1e-4, images within the warps'
    tolerance (copy-paste's recorded one-column divergence aside), and the
    instance masks, filled from the warped 32-point polygons, unequal on at
    most 1e-3 of their pixels."""
    kw = dict(imgsz=IMGSZ, max_labels=24, augment=True, shuffle=True, seed=3, workers=2)
    ours = list(build_dataloader(YOLODataset(sets["segment"], "val", task="segment"), 2,
                                 hyp=AugmentHyp(**hyp_kw), **kw))
    ref = list(jbuild.build_dataloader(jds.YOLODataset(sets["segment"], "val", task="segment"), 2,
                                       hyp=JaxHyp(**hyp_kw), **kw))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_allclose(a["bboxes"], b["bboxes"], rtol=0, atol=1e-4)
        assert a["masks"].shape == (2, 24, 16, 16)
        assert (a["masks"] != b["masks"]).mean() <= MASK_SHARE
        if not hyp_kw:
            off = np.abs(a["img"].astype(int) - b["img"].astype(int))
            assert off.max() <= 1 and (off > 0).mean() <= WARP_SHARE
    assert sum(int(a["mask"].sum()) for a in ours) > 0 and any(a["masks"].any() for a in ours)


# ---------------------------------------------------------------- losses


def _loss_case(task, kind, seed=0, B=2, M=6, imgsz=64):
    """Head outputs and a batch for the loss tests.

    ``random``: normal head maps and a few valid targets an image. ``ties``
    (imgsz 128, M = 14): every anchor predicts the same box, exactly 2 bins a
    side (one DFL logit at 200), and the same class score, and 12 targets of
    20 x 28 px lie at steps of 32 px (the coarsest stride): their assignments
    are translated copies, computed from small exact numbers, so their
    weights tie bit for bit within each package. Image 0 then holds 120
    foreground anchors in groups of 12 equal weights, and the 64th and 65th
    places tie. ``empty``: no valid target."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        imgsz, M = 128, 14
    nc = NC[SEG if task == "segment" else POSE]
    feats = [(rng.normal(size=(B, imgsz // s, imgsz // s, 64 + nc)) * 2).astype(np.float32) for s in STRIDES]
    ctr = rng.uniform(0.25, 0.75, (B, M, 2))
    wh = rng.uniform(0.1, 0.5, (B, M, 2))
    if kind == "ties":
        for f in feats:
            f[..., :64] = np.tile(np.where(np.arange(16) == 2, 200.0, 0.0), 4)
            f[..., 64:] = 1.0
        grid = np.stack(np.meshgrid(np.arange(4), np.arange(3), indexing="ij"), -1).reshape(12, 2)
        ctr[:, :12] = (grid * 32 + [13, 21]) / imgsz
        wh[:, :12] = np.array([20, 28]) / imgsz
    boxes = np.concatenate([ctr, wh], -1).astype(np.float32)
    mask = np.zeros((B, M), bool)
    if kind == "ties":
        mask[0, :12] = True
        mask[1, :5] = True
    elif kind != "empty":
        mask[0, :M - 1] = True
        mask[1, :M // 2] = True
    batch = {"cls": rng.integers(0, nc, (B, M)).astype(np.int32), "bboxes": boxes, "mask": mask}
    if task == "segment":
        hp = imgsz // 4
        masks = np.zeros((B, M, hp, hp), np.uint8)
        for b in range(B):
            for j in range(M):
                poly = tds.resample_polygon(_star(rng, 12, *(ctr[b, j] * hp), 1, wh[b, j].min() * hp).astype(np.float32))
                px.fill_polygons(masks[b, j], [poly.astype(np.int32)])
        batch["masks"] = masks
        outs = [feats, [rng.normal(size=(B, imgsz // s, imgsz // s, 32)).astype(np.float32) for s in STRIDES],
                rng.normal(size=(B, imgsz // 4, imgsz // 4, 32)).astype(np.float32)]
    else:
        k = ctr[:, :, None] + rng.uniform(-0.5, 0.5, (B, M, 17, 2)) * wh[:, :, None]
        batch["keypoints"] = np.concatenate([k, rng.integers(0, 3, (B, M, 17, 1))], -1).astype(np.float32)
        outs = [feats, [(rng.normal(size=(B, imgsz // s, imgsz // s, 51)) * 0.5).astype(np.float32) for s in STRIDES]]
    return outs, batch


def _flat(outs):
    return [x for o in outs for x in (o if isinstance(o, list) else [o])]


def _unflat(flat, outs):
    res, i = [], 0
    for o in outs:
        n = len(o) if isinstance(o, list) else 1
        res.append(list(flat[i:i + n]) if isinstance(o, list) else flat[i])
        i += n
    return res


@pytest.mark.parametrize("task", ["segment", "pose"])
@pytest.mark.parametrize("kind", ["random", "ties", "empty"])
def test_losses_and_gradients_match_jax(task, kind):
    """`segmentation_loss` / `pose_loss` against the JAX package's in f32 (the
    f32 assigner): the total and every aux term at 1e-5 relative, the
    gradients with respect to every head output at 1e-4 relative and 1e-5 of
    max|grad|. With ``ties``, more than 64 anchors of an image are foreground
    and the 64th and 65th weights tie: the stable top-k keeps the anchors
    ``lax.top_k`` keeps."""
    outs, batch = _loss_case(task, kind)
    nc = NC[SEG if task == "segment" else POSE]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {"kpt_shape": KPT} if task == "pose" else {}
    jfn = jsp.segmentation_loss if task == "segment" else jsp.pose_loss
    tfn = tsp.segmentation_loss if task == "segment" else tsp.pose_loss

    def jloss(flat):
        return jfn(_unflat(flat, outs), jbatch, STRIDES, nc, assigner_bf16=False, **extra)

    (ref, raux), rgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(x) for x in _flat(outs)])
    leaves = [to_torch(x).requires_grad_() for x in _flat(outs)]
    tb = {k: to_torch(v) for k, v in batch.items()}
    got, aux = tfn(_unflat(leaves, outs), tb, STRIDES, nc, assigner_bf16=False, **extra)
    grads = torch.autograd.grad(got, leaves)
    assert set(aux) == set(raux)
    assert_close(got, ref, rtol=1e-5, atol=1e-7)
    for k in aux:
        assert_close(aux[k], raux[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for g, r in zip(grads, rgrads):
        assert_close(g, r, rtol=1e-4, atol=1e-5)
    if kind == "empty":
        assert int(aux["num_fg"]) == 0
    if kind == "ties":  # the case is what it claims
        from quan_ultralytics_tpu_torch.losses.detect import detect_terms

        *_, ctx = detect_terms(_unflat(leaves, outs)[0], tb, STRIDES, nc)
        w = torch.sort(ctx["weight"][0], descending=True).values
        assert int(ctx["fg"][0].sum()) == 120 and float(w[63]) == float(w[64]) > 0


@pytest.mark.parametrize("name", [SEG, POSE])
def test_trainer_step(name):
    """One port `Trainer.step` of each model (f32, nbs = batch: an update a
    micro-step) on a loader batch (uint8 masks): its loss is the task's loss
    of the same train-mode forward, and the weights move."""
    task = "segment" if name == SEG else "pose"
    outs, batch = _loss_case(task, "random", seed=4)
    batch["img"] = np.random.default_rng(5).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    model = DetectionModel.from_yaml(name, nc=NC[name], device="cpu")
    ref_model = DetectionModel.from_yaml(name, nc=NC[name], device="cpu")
    ref_model.load_state_dict(model.state_dict())
    ref_model.train()
    tb = {k: to_torch(v) for k, v in batch.items()}
    fn = tsp.segmentation_loss if task == "segment" else tsp.pose_loss
    extra = {"kpt_shape": KPT} if task == "pose" else {}
    ref, _ = fn(ref_model(tb["img"].float() / 255.0), tb, STRIDES, NC[name], assigner_bf16=True, **extra)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, dtype="float32"), steps_per_epoch=4, device="cpu")
    w0 = [p.detach().clone() for p in tr.params]
    loss, aux = tr.step(batch)
    assert {"seg" if task == "segment" else "pose", "nan_skipped"} <= set(aux)
    assert float(aux["nan_skipped"]) == 0 and float(aux["num_fg"]) > 0
    assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(a, b) for a, b in zip(w0, tr.params))


# ---------------------------------------------------------------- predictor and results

MASK_PIXEL_SHARE = 1e-3  # the share of mask pixels the port's bilinear resize may flip at 0.5


def test_predictor_matches_jax(pair):
    """Frames whose longer side is 64 (the letterbox only pads): per frame the
    same kept count and classes, boxes within 1e-4 max|ref| + 1e-5; pose
    keypoints (un-letterboxed, clipped) within 1e-4 px; segment masks, which
    the JAX Predictor resizes with ``cv2.resize`` and the port with
    ``F.interpolate`` (the same half-pixel mapping; a value at 0.5 may round
    either way), unequal on at most 1e-3 of their pixels, and of the shape
    of the frame."""
    name, jm, v, tm = pair
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((64, 64), (48, 64), (64, 40))]
    ref = JaxPredictor(jm, imgsz=IMGSZ, conf=0.25)(v, frames)
    got = Predictor(tm, imgsz=IMGSZ, conf=0.25)(frames)
    assert sum(len(r.boxes) for r in ref) > 3
    unequal = total = 0
    for g, r, f in zip(got, ref, frames):
        assert g.task == r.task and g.boxes.shape[1] == 6 and len(g) == len(r.boxes)
        np.testing.assert_array_equal(g.cls, r.boxes[:, 5])
        np.testing.assert_allclose(g.boxes, r.boxes, rtol=0, atol=_tol(r.boxes))
        if name == POSE:
            assert g.masks is None and g.keypoints.shape == (len(g), 17, 3) == r.keypoints.shape
            np.testing.assert_allclose(g.keypoints, r.keypoints, rtol=0, atol=1e-4)
            assert (g.keypoints[..., 0] <= f.shape[1]).all() and (g.keypoints[..., 1] <= f.shape[0]).all()
        else:
            assert g.keypoints is None and g.masks.shape == r.masks.shape == (len(g),) + f.shape[:2]
            assert g.masks.dtype == bool
            unequal += int((g.masks != r.masks).sum())
            total += g.masks.size
    if name == SEG:
        assert total and unequal / total <= MASK_PIXEL_SHARE, unequal / total
        assert any(r.masks.any() for r in got)


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 1), (2, 0)])
def test_results_pose_formats_match_jax(tmp_path, seed, n):
    """verbose, the pose label lines 'cls xc yc w h' + 'x y vis' a keypoint
    [+ conf] and the JSON summary with its keypoints equal the JAX package's
    (numbers within 1e-6)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2)), rng.uniform(0.2, 1, (n, 1)),
                            np.zeros((n, 1))], 1).astype(np.float32)
    kpts = np.concatenate([rng.uniform(0, 100, (n, 17, 2)), rng.uniform(0, 1, (n, 17, 1))], -1).astype(np.float32)
    got = Results((80, 100), boxes, names=["person"], task="pose", keypoints=kpts)
    ref = JaxResults((80, 100), boxes, names=["person"], task="pose", keypoints=kpts)
    assert got.verbose() == ref.verbose()
    assert json.loads(got.tojson()) == json.loads(ref.tojson())
    for save_conf in (False, True):
        got.save_txt(tmp_path / "port.txt", save_conf=save_conf)
        ref.save_txt(tmp_path / "jax.txt", save_conf=save_conf)
    gl, rl = ((tmp_path / f).read_text().splitlines() for f in ("port.txt", "jax.txt"))
    assert len(gl) == len(rl) == 2 * n
    for a, b in zip(gl, rl):
        a, b = a.split(), b.split()
        assert a[0] == b[0] and len(a) == len(b) in (5 + 51, 6 + 51)
        np.testing.assert_allclose([float(x) for x in a[1:]], [float(x) for x in b[1:]], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- metrics and the validator


def test_mask_iou_and_oks_equal_jax():
    """`mask_iou_np` (on numpy arrays and on torch tensors, as the Validator
    calls it) and `kpt_oks_np` (17 keypoints with the COCO sigmas, 5 with
    1/nk, explicit sigmas) equal the JAX package's, bit for bit."""
    rng = np.random.default_rng(0)
    gm, pm = rng.random((5, 16, 20)) > 0.6, rng.random((7, 16, 20)) > 0.5
    ref = jmetrics.mask_iou_np(gm, pm)
    np.testing.assert_array_equal(tmetrics.mask_iou_np(gm, pm), ref)
    np.testing.assert_array_equal(tmetrics.mask_iou_np(torch.from_numpy(gm), torch.from_numpy(pm)).numpy(), ref)
    np.testing.assert_array_equal(tmetrics.OKS_SIGMA, jmetrics.OKS_SIGMA)
    for nk, sig in ((17, None), (5, None), (5, np.full(5, 0.07, np.float32))):
        gk = np.concatenate([rng.uniform(0, 64, (4, nk, 2)), rng.integers(0, 3, (4, nk, 1))], -1).astype(np.float32)
        pk = np.concatenate([gk[[0, 1, 2, 3, 0, 2]][..., :2] + rng.normal(0, 3, (6, nk, 2)),
                             rng.uniform(0, 1, (6, nk, 1))], -1).astype(np.float32)
        area = rng.uniform(50, 900, 4).astype(np.float32)
        got, ref = tmetrics.kpt_oks_np(gk, area, pk, sig), jmetrics.kpt_oks_np(gk, area, pk, sig)
        assert got.shape == (4, 6) and (got > 0.01).any()
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def val_runs(pair, tmp_path_factory):
    """Both Validators on a set labelled also with the JAX model's own top 3
    predictions of each image (segment: their boxes as 4-point polygons;
    pose: boxes and keypoints, visible): segment with ``mask_native`` off and
    on, pose once."""
    name, jm, v, tm = pair
    task = "segment" if name == SEG else "pose"
    tmp = tmp_path_factory.mktemp(f"val_{task}")
    jval, tval = JaxValidator(jm, imgsz=IMGSZ), Validator(tm, imgsz=IMGSZ)
    cfg = _write_set(tmp, task, seed=1)
    own = {}
    for batch in build_dataloader(YOLODataset(cfg, "val", task=task), 4, IMGSZ, hyp=None, augment=False,
                                  shuffle=False, drop_last=False, with_meta=True):
        det, ok, _ = jval._infer(v, jnp.asarray(batch["img"]))
        for b in range(batch["n_real"]):
            i = len(own)
            d = np.asarray(det)[b][np.asarray(ok)[b]][:3].astype(np.float64)
            h, w = SIZES[i]
            r, dw, dh = batch["ratio_pad"][b]
            x1, x2 = (np.clip((d[:, [0, 2]] - dw) / r, 0, w) / w).T
            y1, y2 = (np.clip((d[:, [1, 3]] - dh) / r, 0, h) / h).T
            lines = []
            for j in range(len(d)):
                c = int(d[j, 5])
                if task == "segment":
                    vals = [x1[j], y1[j], x2[j], y1[j], x2[j], y2[j], x1[j], y2[j]]
                else:
                    k = d[j, 6:].reshape(17, 3)
                    kx, ky = np.clip((k[:, 0] - dw) / r, 0, w) / w, np.clip((k[:, 1] - dh) / r, 0, h) / h
                    pts = [kx, ky, np.full(17, 2.0)] if i % 2 else [kx, ky]  # as the image's other rows
                    vals = [(x1[j] + x2[j]) / 2, (y1[j] + y2[j]) / 2, x2[j] - x1[j], y2[j] - y1[j],
                            *np.stack(pts, 1).reshape(-1)]
                lines.append(" ".join([str(c)] + [f"{x:.6f}" for x in vals]))
            own[i] = lines
    cfg = _write_set(tmp, task, seed=1, own=own)
    out = {}
    for native in ((False, True) if task == "segment" else (False,)):
        for pkg, run in (("jax", lambda **kw: jval(v, jds.YOLODataset(cfg, "val", task=task), batch_size=4, **kw)),
                         ("port", lambda **kw: tval(YOLODataset(cfg, "val", task=task), batch_size=4, **kw))):
            js = tmp / f"{pkg}_{native}.json"
            metrics = run(save_json=str(js), mask_native=native)
            out[pkg, native] = {"metrics": metrics, "json": json.loads(js.read_text()),
                                "confusion": (jval if pkg == "jax" else tval).confusion.matrix.copy()}
    return task, out


def test_validator_matches_jax(val_runs):
    """Box metrics and the second head's (segment ``mAP50(M)``,
    ``mAP50-95(M)``; pose ``mAP50(P)``, ``mAP50-95(P)``) within 1e-3 of the
    JAX Validator's, both mAP50 above 0, the confusion matrix equal and the
    COCO JSON equal after parsing (numbers within 1.5e-3; detections of equal
    rounded score compared in box order: anchors in the letterbox's padding
    tie, and one ulp decides their order). Segment masks are scored at proto
    resolution and with ``mask_native`` at the input's, which moves the mask
    metrics."""
    task, runs = val_runs
    suffix = "(M)" if task == "segment" else "(P)"
    for native in sorted({n for _, n in runs}):
        got, ref = runs["port", native], runs["jax", native]
        assert set(got["metrics"]) == set(ref["metrics"]) == {
            "mAP50", "mAP50-95", "precision", "recall", f"mAP50{suffix}", f"mAP50-95{suffix}"}
        assert ref["metrics"]["mAP50"] > 0 and ref["metrics"][f"mAP50{suffix}"] > 0
        for k in ref["metrics"]:
            assert abs(got["metrics"][k] - ref["metrics"][k]) <= 1e-3, (native, k, got["metrics"][k],
                                                                        ref["metrics"][k])
        np.testing.assert_array_equal(got["confusion"], ref["confusion"])
        assert len(got["json"]) == len(ref["json"]) > 0

        def rows(dets):  # detections of equal score (padding anchors tie) in a fixed order
            return sorted(dets, key=lambda d: (d["image_id"], -d["score"], d["category_id"], d["bbox"]))

        for a, b in zip(rows(got["json"]), rows(ref["json"])):
            assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
            np.testing.assert_allclose(a["bbox"] + [a["score"]], b["bbox"] + [b["score"]], rtol=0, atol=1.5e-3)
    if task == "segment":
        moved = [runs["port", True]["metrics"][k] != runs["port", False]["metrics"][k]
                 for k in ("mAP50(M)", "mAP50-95(M)")]
        assert any(moved)
