"""The port's train augmentations against OpenCV 5.0 and the JAX package, on the CPU.

* Pixel primitives (`data/native/pixels`) against OpenCV: ``get_rotation_matrix_2d``
  exact; the affine and perspective warps within one gray level on at most
  0.1% of the values (they agree exactly with OpenCV 5.0's vectorised float32
  kernel here; another OpenCV build may round the few values whose bilinear
  sum falls on a half differently); RGB to HSV, HSV to RGB, RGB to gray and
  both Lab directions exact on every 8-bit input and at every row width (in
  HSV to RGB, OpenCV's vectorised loop truncates and the end of a row
  rounds); the box and median filters
  exact at k = 3, 5, 7 and odd sizes; CLAHE exact, sides that do not divide by
  8 included; filled polygons exact, overlapping contours (even-odd) and
  polygons that leave the mask included.
* Each augmentation against its JAX counterpart from the same seed: labels
  within 1e-4 px and the same kept boxes; pixels at the primitives' limits;
  copy-paste differs from the JAX package by its mask, one column to the left.
* ``build_dataloader(augment=True, hyp=...)`` against the JAX loader at imgsz
  128 on images already 128 x 128 (the letterbox does not resize): two
  batches each with mosaic on, off, and with mixup and copy-paste at 1.0;
  ``bboxes`` within 1e-4, ``cls`` and ``mask`` exact, pixels exact (with
  copy-paste, exact once the JAX loader's mask takes the same column and
  both masks are filled by OpenCV).
* The committed OpenCV fixtures of ``tests/fixtures/augment`` (which
  ``chip_smoke.py`` holds the library built on the card's machine to) still
  equal what OpenCV gives, and the port meets them.

Nothing here compiles a JAX step: the JAX side is its numpy/OpenCV loader.
"""

import importlib.util
import json
import math
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu.data import augment as jaug
from quan_ultralytics_tpu.data import build as jbuild
from quan_ultralytics_tpu.data.dataset import YOLODataset as JaxDataset
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data import augment as taug
from quan_ultralytics_tpu_torch.data.native import pixels as px

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "augment"
WARP_SHARE = 1e-3  # values a warp may miss OpenCV by one gray level, as a share
LABEL_TOL = 1e-4  # px


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _image(h, w, seed=0):
    """A gradient with noise and filled rectangles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        im[y0:y0 + rng.integers(2, 20), x0:x0 + rng.integers(2, 20)] = rng.integers(0, 256, 3)
    return np.clip(im + rng.integers(-30, 31, im.shape), 0, 255).astype(np.uint8)


def _off(got, ref):
    """(share of values that differ, max abs difference)."""
    d = np.abs(got.astype(int) - ref.astype(int))
    return float((d > 0).mean()), int(d.max())


def _every_triple():
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([a >> 16, (a >> 8) & 255, a & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


# ---------------------------------------------------------------- primitives


@pytest.mark.parametrize("center,angle,scale", [((0, 0), 0.0, 1.0), ((0, 0), -7.3, 0.61), ((64, 48), 33.0, 1.5),
                                                ((12.5, -3.25), 180.0, 0.5), ((1024, 1024), -90.0, 1.0)])
def test_rotation_matrix_matches_opencv(center, angle, scale):
    np.testing.assert_array_equal(taug.get_rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


WARPS = [((96, 96), (96, 96)), ((97, 131), (160, 96)), ((150, 121), (101, 77)), ((128, 128), (64, 64)),
         ((33, 17), (40, 31))]


@pytest.mark.parametrize("kind", ["affine", "perspective"])
@pytest.mark.parametrize("shape,dsize", WARPS)
def test_warp_matches_opencv(kind, shape, dsize):
    rng = np.random.default_rng(shape[0])
    im = _image(*shape, seed=shape[1])
    for _ in range(4):
        m = np.eye(3)
        m[:2] = cv2.getRotationMatrix2D((shape[1] / 2, shape[0] / 2), rng.uniform(-30, 30), rng.uniform(0.5, 1.5))
        m[:2, 2] += rng.uniform(-20, 20, 2)
        m[0, 1] += rng.uniform(-0.05, 0.05)  # a little shear
        if kind == "affine":
            got, ref = px.warp_affine(im, m[:2], dsize), cv2.warpAffine(im, m[:2], dsize, borderValue=(114,) * 3)
        else:
            m[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
            got, ref = px.warp_perspective(im, m, dsize), cv2.warpPerspective(im, m, dsize, borderValue=(114,) * 3)
        share, worst = _off(got, ref)
        assert worst <= 1 and share <= WARP_SHARE, (kind, m.tolist(), share, worst)


def test_warp_border_value():
    im = _image(20, 30)
    m = np.array([[1.0, 0.0, 100.0], [0.0, 1.0, 0.0]])  # the whole image shifted out of view
    assert (px.warp_affine(im, m, (30, 20)) == 114).all()
    np.testing.assert_array_equal(px.warp_affine(im, np.eye(3)[:2], (30, 20)), im)


COLOUR = [("rgb_to_hsv", cv2.COLOR_RGB2HSV), ("hsv_to_rgb", cv2.COLOR_HSV2RGB), ("rgb_to_gray", cv2.COLOR_RGB2GRAY),
          ("rgb_to_lab", cv2.COLOR_RGB2LAB), ("lab_to_rgb", cv2.COLOR_LAB2RGB)]


@pytest.mark.parametrize("name,code", COLOUR)
def test_colour_conversion_matches_opencv_on_every_value(name, code):
    im = _every_triple()
    if name == "hsv_to_rgb":  # hue runs over [0, 180)
        im = im[: 180 * 65536 // 4096]
    np.testing.assert_array_equal(getattr(px, name)(im), cv2.cvtColor(im, code))


@pytest.mark.parametrize("name,code", COLOUR)
def test_colour_conversion_matches_opencv_at_every_row_width(name, code):
    """OpenCV's vectorised loop and the scalar end of a row round HSV to RGB
    differently: every row width from 1 to 140, and a few wide ones."""
    rng = np.random.default_rng(0)
    for w in [*range(1, 141), 250, 1000, 1024]:
        im = rng.integers(0, 256, (3, w, 3)).astype(np.uint8)
        if name == "hsv_to_rgb":
            im[..., 0] %= 180
        np.testing.assert_array_equal(getattr(px, name)(im), cv2.cvtColor(im, code), err_msg=f"width {w}")


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shape", [(2, 3), (5, 9), (17, 33), (64, 64), (123, 250)])
def test_filters_match_opencv(k, shape):
    im = _image(*shape, seed=k)
    np.testing.assert_array_equal(px.blur(im, k), cv2.blur(im, (k, k)))
    np.testing.assert_array_equal(px.median_blur(im, k), cv2.medianBlur(im, k))


@pytest.mark.parametrize("shape", [(64, 64), (96, 128), (100, 75), (33, 47), (128, 131), (101, 96), (16, 24)])
def test_clahe_matches_opencv(shape):
    lum = np.ascontiguousarray(_image(*shape, seed=shape[0])[..., 1])
    for clip in (1.0, 2.5, 3.9):
        ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(lum)
        np.testing.assert_array_equal(px.clahe(lum, clip), ref, err_msg=f"clip {clip}")


def _rotated_rect(rng, lo, hi, size):
    cx, cy = rng.uniform(lo, hi, 2)
    bw, bh = rng.uniform(*size, 2)
    t = rng.uniform(0, math.pi)
    c, s = math.cos(t), math.sin(t)
    return np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                     for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2), (bw / 2, bh / 2), (-bw / 2, bh / 2))])


@pytest.mark.parametrize("shape", [(12, 12), (40, 30), (300, 500)])
def test_fill_polygons_matches_opencv(shape):
    """Polygons inside the mask: triangles, rotated rectangles, irregular and
    self-crossing polygons, several at once (overlaps fill even-odd)."""
    h, w = shape
    rng = np.random.default_rng(h)
    for _ in range(150):
        polys = []
        for _ in range(int(rng.integers(1, 5))):
            if rng.random() < 0.5:
                pts = _rotated_rect(rng, 0, min(h, w), (1, min(h, w)))
            else:
                pts = rng.uniform(0, 1, (int(rng.integers(3, 9)), 2)) * [w, h]
            polys.append(np.clip(pts, 0, [w - 1, h - 1]).astype(np.int32))
        ref = np.zeros(shape, np.uint8)
        cv2.drawContours(ref, polys, -1, 1, cv2.FILLED)
        np.testing.assert_array_equal(px.fill_polygons(np.zeros(shape, np.uint8), polys), ref,
                                      err_msg=str([p.tolist() for p in polys]))
    two = [np.array([[2, 2], [9, 2], [9, 9], [2, 9]], np.int32), np.array([[5, 5], [11, 5], [11, 11], [5, 11]],
                                                                          np.int32)]
    mask = px.fill_polygons(np.zeros((12, 12), np.uint8), two)
    assert mask[7, 7] == 0 and mask[3, 3] == mask[10, 10] == 1  # the overlap stays empty


def test_fill_polygons_across_the_border():
    """Polygons that leave the mask, as copy-paste's flipped labels on the
    mosaic canvas do: rotated rectangles across a 256 x 256 mask's borders,
    triangles in a 30 x 30 one, and polygons with points thousands of pixels
    out, several at once, in masks of 1 to 199 pixels a side."""
    rng = np.random.default_rng(0)
    cases = [((256, 256), [_rotated_rect(rng, -30, 286, (4, 80)) for _ in range(int(rng.integers(1, 6)))])
             for _ in range(200)]
    cases += [((30, 30), [rng.integers(-10, 40, (3, 2))]) for _ in range(600)]
    for _ in range(300):
        spread = 3000 if rng.random() < 0.3 else 250
        cases.append((tuple(int(v) for v in rng.integers(1, 200, 2)),
                      [rng.integers(-spread // 10 - 50, spread, (int(rng.integers(3, 12)), 2))
                       for _ in range(int(rng.integers(1, 5)))]))
    for shape, polys in cases:
        polys = [np.asarray(q).astype(np.int32) for q in polys]
        ref = np.zeros(shape, np.uint8)
        cv2.drawContours(ref, polys, -1, 1, cv2.FILLED)
        np.testing.assert_array_equal(px.fill_polygons(np.zeros(shape, np.uint8), polys), ref,
                                      err_msg=str([q.tolist() for q in polys]))


def test_pixel_functions_refuse_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        px.rgb_to_hsv(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="odd"):
        px.blur(np.zeros((4, 4, 3), np.uint8), 4)
    with pytest.raises(ValueError, match="int32"):
        px.fill_polygons(np.zeros((4, 4), np.uint8), [np.zeros((3, 2), np.float32)])


def test_pixel_functions_from_many_threads():
    """Loader threads call the library at once: 16 threads on 8 images give the
    results of one thread (the tables are built once, nothing else is shared)."""
    from concurrent.futures import ThreadPoolExecutor

    def work(seed):
        im = _image(70 + seed, 90 - seed, seed)
        m = cv2.getRotationMatrix2D((40, 30), 5.0 * seed, 1.1)
        lab = px.rgb_to_lab(im)
        return [px.warp_affine(im, m, (64, 48)), px.hsv_to_rgb(px.rgb_to_hsv(im)), px.lab_to_rgb(lab),
                px.clahe(np.ascontiguousarray(lab[..., 0]), 2.0), px.median_blur(im, 5),
                px.fill_polygons(np.zeros(im.shape[:2], np.uint8), [_rotated_rect(np.random.default_rng(seed),
                                                                                  0, 60, (5, 40)).astype(np.int32)])]

    want = [work(seed) for seed in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(work, [seed % 8 for seed in range(64)]))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 64
    for i, g in enumerate(got):
        for a, b in zip(g, want[i % 8]):
            np.testing.assert_array_equal(a, b)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(px, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(px, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        px.library()


# ---------------------------------------------------------------- augmentations vs JAX


def _labels(rng, n, size):
    return np.stack([_rotated_rect(rng, 0.1 * size, 0.9 * size, (4, size / 3)) for _ in range(n)]).astype(np.float32)


def _assert_labels(got, ref):
    (gc, gk), (rc, rk) = got, ref
    assert gc.shape == rc.shape
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gc, rc, rtol=0, atol=LABEL_TOL)


HYPS = {"recipe": {}, "turn and shear": {"degrees": 30.0, "shear": 5.0, "translate": 0.2, "scale": 0.9},
        "perspective": {"degrees": 10.0, "perspective": 5e-4}, "hsv off": {"hsv_h": 0, "hsv_s": 0, "hsv_v": 0},
        "flips": {"flipud": 0.5, "fliplr": 0.5}}


@pytest.mark.parametrize("hyp", list(HYPS))
def test_augmentations_match_jax(hyp):
    """random_perspective (both borders), random_hsv and flip_corners from the
    same seeds: labels within 1e-4 and the same kept boxes, pixels exact but
    for the warp's limit."""
    th, jh = taug.AugmentHyp(**HYPS[hyp]), jaug.AugmentHyp(**HYPS[hyp])
    for seed in range(6):
        size = 96 if seed % 2 else 128
        im = _image(size, size, seed)
        corners = _labels(np.random.default_rng(seed), 6, size)
        cls = np.arange(6, dtype=np.int32)
        border = (-size // 4, -size // 4) if seed % 3 == 0 else (0, 0)
        got = taug.random_perspective(im, corners, cls, th, np.random.default_rng(seed), border=border)
        ref = jaug.random_perspective(im, corners, cls, jh, np.random.default_rng(seed), border=border)
        _assert_labels(got[1:], ref[1:])
        share, worst = _off(got[0], ref[0])
        assert worst <= 1 and share <= WARP_SHARE
        np.testing.assert_array_equal(taug.random_hsv(im, th, np.random.default_rng(seed)),
                                      jaug.random_hsv(im, jh, np.random.default_rng(seed)))
        gi, gc = taug.flip_corners(im, corners, th, np.random.default_rng(seed))
        ri, rc = jaug.flip_corners(im, corners, jh, np.random.default_rng(seed))
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gc, rc)


def test_mixup_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _image(64, 64, 1), _image(64, 64, 2)
    ca, cb = _labels(rng, 3, 64), _labels(rng, 2, 64)
    ka, kb = np.array([0, 1, 2], np.int32), np.array([3, 4], np.int32)
    for seed in range(4):
        got = taug.mixup(a, ca, ka, b, cb, kb, np.random.default_rng(seed))
        ref = jaug.mixup(a, ca, ka, b, cb, kb, np.random.default_rng(seed))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(taug.bbox_ioa(ca.reshape(-1, 4)[:, :4], cb.reshape(-1, 4)[:, :4]),
                                  jaug.bbox_ioa(ca.reshape(-1, 4)[:, :4], cb.reshape(-1, 4)[:, :4]))


def _copy_paste_mask(shape, polys):
    mask = np.zeros(shape, np.uint8)
    cv2.drawContours(mask, [p.astype(np.int32) for p in polys], -1, 1, cv2.FILLED)
    return mask


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_copy_paste_matches_jax_but_the_mask_column(p):
    """The same candidates, selection and labels as the JAX package; the port
    copies the flipped pixels inside the polygons filled at w - 1 - x (where
    they land after the flip), the JAX package inside those at w - x: its mask
    is the port's one column to the right."""
    rng = np.random.default_rng(3)
    w = 160
    im = _image(120, w, 4)
    corners = np.concatenate([_labels(rng, 4, 60) + [5, 30], _labels(rng, 3, 40) + [110, 10]]).astype(np.float32)
    cls = np.arange(len(corners), dtype=np.int32)
    got = taug.copy_paste(im, corners, cls, np.random.default_rng(0), p)
    ref = jaug.copy_paste(im, corners, cls, np.random.default_rng(0), p)
    _assert_labels(got[1:], ref[1:])
    pasted = got[1][len(corners):]
    assert len(pasted) > 0
    ours, theirs = (_copy_paste_mask(im.shape[:2], pasted - shift) for shift in ([1, 0], [0, 0]))
    np.testing.assert_array_equal(ours[:, :-1], theirs[:, 1:])  # one column apart
    flipped = im[:, ::-1]
    np.testing.assert_array_equal(got[0], np.where(ours[..., None] > 0, flipped, im))
    np.testing.assert_array_equal(ref[0], np.where(theirs[..., None] > 0, flipped, im))


class _Gated:
    """A generator whose ``random()`` returns the given gate values first (the
    photometric list's coin flips), and is otherwise the seeded generator."""

    def __init__(self, seed, gates):
        self._rng, self._gates = np.random.default_rng(seed), list(gates)

    def random(self):
        return self._gates.pop(0) if self._gates else self._rng.random()

    def __getattr__(self, name):
        return getattr(self._rng, name)


# the list's coin flips: the list itself, then blur, median, gray, CLAHE (each fires under 0.01)
GATES = {"none fire": [0.5, 0.5, 0.5, 0.5, 0.5], "list skipped": [1.0], "blur": [0.0, 0.0, 1, 1, 1],
         "median": [0.0, 1, 0.0, 1, 1], "gray": [0.0, 1, 1, 0.0, 1], "clahe": [0.0, 1, 1, 1, 0.0],
         "all": [0.0, 0.0, 0.0, 0.0, 0.0]}


@pytest.mark.parametrize("gates", list(GATES))
def test_photometric_augment_matches_jax(gates):
    for seed, shape in enumerate([(64, 64), (45, 77), (128, 96)]):
        im = _image(*shape, seed)
        got = taug.photometric_augment(im, _Gated(seed, GATES[gates]), p=0.9)
        ref = jaug.photometric_augment(im, _Gated(seed, GATES[gates]), p=0.9)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- the loader vs JAX

IMGSZ = 128


@pytest.fixture(scope="module")
def square_set(tmp_path_factory):
    """8 images of IMGSZ x IMGSZ (the letterbox does not resize) with 0-6
    filled rotated rectangles, their 8-corner labels over 3 classes."""
    root = tmp_path_factory.mktemp("square")
    rng = np.random.default_rng(0)
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    for i in range(8):
        im = _image(IMGSZ, IMGSZ, 10 + i)
        lines = []
        for _ in range(int(rng.integers(0, 7))):
            pts = _rotated_rect(rng, 0.15 * IMGSZ, 0.85 * IMGSZ, (6, 0.4 * IMGSZ))
            cv2.fillPoly(im, [np.round(pts).astype(np.int32)], tuple(int(v) for v in rng.integers(0, 256, 3)))
            lines.append(" ".join([str(rng.integers(0, 3))] + [f"{v / IMGSZ:.6f}" for v in pts.reshape(-1)]))
        cv2.imwrite(str(root / "images" / "train" / f"im{i}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
        (root / "labels" / "train" / f"im{i}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    return {"path": str(root), "train": "images/train", "val": "images/train", "names": {0: "a", 1: "b", 2: "c"}}


def _batches(cfg, hyp_kw, seed, jax_copy_paste=None, monkeypatch=None):
    kw = dict(imgsz=IMGSZ, max_labels=48, augment=True, shuffle=True, seed=seed, workers=2)
    ours = list(build_dataloader(YOLODataset(cfg, "train", task="obb"), 4, hyp=taug.AugmentHyp(**hyp_kw), **kw))
    if jax_copy_paste is not None:
        monkeypatch.setattr(jbuild, "copy_paste", jax_copy_paste)
    ref = list(jbuild.build_dataloader(JaxDataset(cfg, "train", task="obb"), 4, hyp=jaug.AugmentHyp(**hyp_kw),
                                       **kw))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_allclose(a["bboxes"], b["bboxes"], rtol=0, atol=LABEL_TOL)
    assert sum(int(a["mask"].sum()) for a in ours) > 0
    return ours, ref


@pytest.mark.parametrize("hyp_kw", [{}, {"mosaic": 0.0}, {"mosaic": 0.5, "degrees": 10.0, "flipud": 0.5}])
def test_augmenting_loader_matches_jax(square_set, hyp_kw):
    for seed in (0, 1):
        ours, ref = _batches(square_set, hyp_kw, seed)
        for a, b in zip(ours, ref):
            assert a["img"].shape == (4, IMGSZ, IMGSZ, 3)
            share, worst = _off(a["img"], b["img"])
            assert worst <= 1 and share <= WARP_SHARE, (share, worst)


def _copy_paste_at_w_minus_1(im, corners, cls, rng, p=0.5):
    """The JAX package's copy_paste (OpenCV) with the mask filled from the
    polygons at w - 1 - x, where the flipped pixels land."""
    n = corners.shape[0]
    if n == 0 or p == 0:
        return im, corners, cls
    h, w = im.shape[:2]
    flipped = corners.copy()
    flipped[..., 0] = w - flipped[..., 0]
    ioa = jaug.bbox_ioa(jaug._hulls(flipped), jaug._hulls(corners))
    cand = np.nonzero((ioa < 0.30).all(axis=1))[0]
    if cand.size == 0:
        return im, corners, cls
    sel = cand[np.argsort(ioa.max(axis=1)[cand])][: round(p * cand.size)]
    if sel.size == 0:
        return im, corners, cls
    mask = np.zeros((h, w), np.uint8)
    cv2.drawContours(mask, [(flipped[j] - [1, 0]).astype(np.int32) for j in sel], -1, 1, cv2.FILLED)
    out = im.copy()
    cv2.copyTo(cv2.flip(im, 1), mask, out)
    return out, np.concatenate([corners, flipped[sel]]), np.concatenate([cls, cls[sel]])


def _cv2_fill(mask, polygons):
    cv2.drawContours(mask, list(polygons), -1, 1, cv2.FILLED)
    return mask


def test_copy_paste_and_mixup_loader_matches_jax(square_set, monkeypatch):
    """mixup = copy_paste = 1.0: labels as the JAX loader's; the pixels differ
    where the JAX loader's copy-paste mask is a column off. With the JAX
    loader's mask filled where the port fills it, and both filled by OpenCV
    (the port's fill is held to OpenCV on its own above, so that this test
    holds the rest of the pipeline), the pixels are exact."""
    hyp_kw = {"mixup": 1.0, "copy_paste": 1.0}
    ours, ref = _batches(square_set, hyp_kw, 0)
    assert any(_off(a["img"], b["img"])[0] > 0 for a, b in zip(ours, ref))  # the recorded divergence
    monkeypatch.setattr(px, "fill_polygons", _cv2_fill)
    for seed in (0, 1, 2):
        ours, ref = _batches(square_set, hyp_kw, seed, jax_copy_paste=_copy_paste_at_w_minus_1,
                             monkeypatch=monkeypatch)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a["img"], b["img"])


def test_plain_and_closed_loaders_match(square_set):
    """hyp=None (the closed-mosaic epochs) gives the non-augmenting batches."""
    ds = YOLODataset(square_set, "train", task="obb")
    for a, b in zip(build_dataloader(ds, 4, IMGSZ, hyp=None, augment=True, seed=2),
                    build_dataloader(ds, 4, IMGSZ, hyp=None, augment=False, seed=2)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- committed fixtures


def test_augment_fixtures_equal_opencv():
    make = _load(REPO / "tests" / "fixtures" / "make_augment_fixtures.py", "make_augment_fixtures")
    src = np.load(FIXTURES / "src.npy")
    np.testing.assert_array_equal(src, make.source())
    assert json.loads((FIXTURES / "cases.json").read_text()) == make.CASES
    for name, arr in make.compute(src).items():
        np.testing.assert_array_equal(np.load(FIXTURES / f"{name}.npy"), arr, err_msg=name)


def test_port_meets_the_augment_fixtures():
    """The check ``chip_smoke.py``'s phase_augment makes on the card's machine."""
    smoke = _load(REPO / "chip_smoke.py", "chip_smoke")
    errors = smoke.augment_fixture_errors(FIXTURES)
    assert len(errors) == 13 and smoke.augment_fixtures_agree(errors), errors
    assert all(off == 0 for off, _, _ in errors.values()), errors  # exact where the fixtures were made
