"""The port's trackers (``trackers/``) against the JAX package's, and its
OpenCV-free motion compensation (``trackers/gmc.py``) against OpenCV.

* ByteTrack and BoT-SORT (without motion compensation, and with it given the
  JAX package's cv2 GMC, so that only the trackers differ) run on the same
  scripted detections in both packages: the cases of ``tests/test_trackers.py``
  and a seeded scene of six objects with score drops, misses and clutter.
  Track IDs are equal and boxes, scores and classes within 1e-9 (both are
  float64 numpy on the same inputs).
* ``linear_assignment`` gives the JAX package's matches and the optimum of
  ``scipy.optimize.linear_sum_assignment``.
* GMC's steps against OpenCV 5.0 on a seeded textured frame: the gray
  conversion and the 2x downscale pixel for pixel, the Shi-Tomasi corners
  equal, Lucas-Kanade's (``data/native/augment.cpp``) status equal and points
  within 0.01 px, on the frame at full and at half size (odd sides, so that
  the pyramid's levels have odd sides too); and the whole GMC on frame
  pairs of known shift and rotation:
  its affine moves the frame's points within 0.01 px of where OpenCV's GMC
  moves them (3e-5 px measured: RANSAC draws differ, the least-squares refit
  on the same inliers does not), and within 1 px of the truth (the method's
  own error: OpenCV's GMC is up to 0.62 px off at the frame's corners, where
  the shifted frame's reflected border and the half-resolution fit show).
"""

import cv2
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from quan_ultralytics_tpu.trackers import BOTSORT as JaxBOTSORT
from quan_ultralytics_tpu.trackers import BYTETracker as JaxBYTETracker
from quan_ultralytics_tpu.trackers import bot_sort as jbot
from quan_ultralytics_tpu.trackers import byte_tracker as jbyte
from quan_ultralytics_tpu.trackers.matching import linear_assignment as jax_linear_assignment
from quan_ultralytics_tpu_torch.data.native import pixels
from quan_ultralytics_tpu_torch.trackers import BOTSORT, BYTETracker, gmc
from quan_ultralytics_tpu_torch.trackers import byte_tracker as tbyte
from quan_ultralytics_tpu_torch.trackers.matching import linear_assignment

EMPTY = (np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0))


def _moving():
    frames = []
    for t in range(10):
        boxes = np.array([[10 + 3 * t, 10, 40 + 3 * t, 40], [100, 50 + 2 * t, 140, 90 + 2 * t]], np.float32)
        frames.append((boxes, np.array([0.9, 0.9]), np.array([0, 1])))
    return frames


def _rescue():
    boxes = np.array([[10, 10, 40, 40]], np.float32)
    frames = [(boxes + 2 * t, np.array([0.9]), np.array([0])) for t in range(3)]
    return frames + [(boxes + 6, np.array([0.3]), np.array([0]))]


def _lost():
    boxes = np.array([[10, 10, 40, 40]], np.float32)
    return [(boxes, np.array([0.9]), np.array([0]))] * 3 + [EMPTY] * 5


def _unconfirmed():
    a = np.array([[10, 10, 30, 30]], np.float32)
    spur = np.array([[10, 10, 30, 30], [200, 200, 230, 230]], np.float32)
    one, two = (a, np.array([0.9]), np.array([0])), (spur, np.array([0.9, 0.9]), np.array([0, 0]))
    return [one, two, one, two, two]


def _crossing():
    frames = []
    for t in range(12):
        a = np.array([10 + 9 * t, 20, 40 + 9 * t, 50], np.float32)
        b = np.array([110 - 9 * t, 24, 140 - 9 * t, 54], np.float32)
        frames.append((np.stack([a, b]), np.array([0.9, 0.9]), np.array([0, 0])))
    return frames


def _scene(seed=0, n_frames=30):
    """Six objects at constant velocities with score drops below the high and the
    low thresholds, missed frames and clutter detections."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(20, 300, (6, 2))
    size = rng.uniform(15, 60, (6, 2))
    vel = rng.uniform(-6, 6, (6, 2))
    frames = []
    for t in range(n_frames):
        c = pos + vel * t + rng.normal(0, 0.7, (6, 2))
        boxes = np.concatenate([c - size / 2, c + size / 2], 1)
        scores = rng.choice([0.95, 0.8, 0.55, 0.3, 0.05], 6, p=[0.4, 0.25, 0.15, 0.15, 0.05])
        keep = rng.random(6) > 0.1
        clutter = rng.uniform(0, 320, (2, 2))
        boxes = np.concatenate([boxes[keep], np.concatenate([clutter, clutter + 20], 1)])
        scores = np.concatenate([scores[keep], rng.uniform(0.1, 0.7, 2)])
        cls = np.concatenate([np.arange(6)[keep] % 3, [0, 1]])
        frames.append((boxes.astype(np.float32), scores, cls))
    return frames


CASES = {
    "identity": (_moving, dict(track_high_thresh=0.5, new_track_thresh=0.5)),
    "low_score_rescue": (_rescue, {}),
    "lost_track_removed": (_lost, dict(track_buffer=2)),
    "unconfirmed_removed": (_unconfirmed, {}),
    "crossing": (_crossing, dict(track_high_thresh=0.5, new_track_thresh=0.5, match_thresh=0.9)),
    "scene": (_scene, {}),
}


def _run(tracker, frames, with_frames=False):
    out = []
    for i, (boxes, scores, cls) in enumerate(frames):
        kw = {"frame": _frame(i)} if with_frames else {}
        out.append(tracker.update(boxes, scores, cls, **kw))
    return out


def _assert_same_tracks(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g[:, 4], r[:, 4])  # track IDs
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["bytetrack", "botsort"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trackers_match_jax(case, kind):
    make, kw = CASES[case]
    frames = make()
    runs = []
    for mod, cls in ((tbyte, BYTETracker if kind == "bytetrack" else BOTSORT),
                     (jbyte, JaxBYTETracker if kind == "bytetrack" else JaxBOTSORT)):
        mod.STrack._count = 0
        tracker = cls(**kw) if kind == "bytetrack" else cls(gmc=False, **kw)
        runs.append(_run(tracker, frames))
    _assert_same_tracks(*runs)
    assert sum(len(r) for r in runs[1]) > 0


_TEXTURE = None


def _texture():
    """A seeded textured RGB frame (240 x 320): blurred noise under filled rectangles."""
    global _TEXTURE
    if _TEXTURE is None:
        rng = np.random.default_rng(0)
        im = cv2.GaussianBlur(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8), (0, 0), 3)
        for _ in range(30):
            x, y = (int(v) for v in rng.integers(0, 300, 2))
            w, h = (int(v) for v in rng.integers(5, 40, 2))
            cv2.rectangle(im, (x, y), (x + w, y + h), tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
        _TEXTURE = im
    return _TEXTURE


def _frame(i):
    """Frame i of a camera panning 2 px right and 1 px down a frame."""
    M = np.float32([[1, 0, 2 * i], [0, 1, i]])
    return cv2.warpAffine(_texture(), M, (320, 240), borderMode=cv2.BORDER_REFLECT)


@pytest.mark.parametrize("case", ["identity", "scene"])
def test_botsort_with_motion_compensation_matches_jax(case):
    """Both trackers given frames and the same (OpenCV) motion estimate: the
    port's warp of the tracks by it is the JAX package's."""
    make, kw = CASES[case]
    frames = make()
    runs = []
    for mod, cls in ((tbyte, BOTSORT), (jbyte, JaxBOTSORT)):
        mod.STrack._count = 0
        tracker = cls(**kw)
        tracker.gmc = jbot.GMC()
        runs.append(_run(tracker, frames, with_frames=True))
    _assert_same_tracks(*runs)


def test_botsort_with_its_own_motion_compensation_keeps_ids():
    """The port's BoT-SORT with its own GMC on the panning frames gives the JAX
    package's track IDs, boxes within 0.5 px."""
    frames = _moving()
    runs = []
    for mod, cls in ((tbyte, BOTSORT), (jbyte, JaxBOTSORT)):
        mod.STrack._count = 0
        runs.append(_run(cls(track_high_thresh=0.5, new_track_thresh=0.5), frames, with_frames=True))
    for g, r in zip(*runs):
        np.testing.assert_array_equal(g[:, 4], r[:, 4])
        np.testing.assert_allclose(g, r, rtol=0, atol=0.5)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (5, 3), (8, 8), (20, 13), (40, 60)])
def test_linear_assignment_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    cost = rng.random(shape)
    for thresh in (np.inf, 0.5):
        got, ref = linear_assignment(cost, thresh), jax_linear_assignment(cost, thresh)
        assert got == ref
    rows, cols = linear_sum_assignment(cost)
    matches, ua, ub = linear_assignment(cost, np.inf)
    assert abs(sum(cost[i, j] for i, j in matches) - cost[rows, cols].sum()) < 1e-9
    assert len(matches) == min(shape) and len(ua) == shape[0] - len(matches) and len(ub) == shape[1] - len(matches)
    m, ua, ub = linear_assignment(np.zeros((0, 3)), 0.5)
    assert m == [] and ua == [] and ub == [0, 1, 2]


def test_gray_and_downscale_equal_opencv():
    v = np.arange(0, 256, 3, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(len(v), -1, 3)
    np.testing.assert_array_equal(pixels.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    gray = cv2.cvtColor(_texture(), cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(gmc.downscale(gray, 2), cv2.resize(gray, (160, 120)))
    odd = gray[:239, :317]
    # a factor that does not divide the sides: bilinear, within one gray level of OpenCV's
    diff = gmc.downscale(odd, 2).astype(int) - cv2.resize(odd, (158, 119))
    assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("size", [(240, 320), (119, 157)])
def test_corners_and_optical_flow_match_opencv(size):
    h, w = size
    M = cv2.getRotationMatrix2D((160, 120), 1.5, 1.0)
    M[:, 2] += (3.5, -2.25)
    moved = cv2.warpAffine(_texture(), M, (320, 240), borderMode=cv2.BORDER_REFLECT)
    prev, nxt = (cv2.resize(cv2.cvtColor(im, cv2.COLOR_RGB2GRAY), (w, h), interpolation=cv2.INTER_AREA)
                 for im in (_texture(), moved))
    pts = gmc.good_features_to_track(prev)
    ref = cv2.goodFeaturesToTrack(prev, maxCorners=200, qualityLevel=0.01, minDistance=8, blockSize=3)
    np.testing.assert_array_equal(pts, ref)
    got, st = pixels.optical_flow_pyr_lk(prev, nxt, ref)
    want, st_ref, _ = cv2.calcOpticalFlowPyrLK(prev, nxt, ref, None)
    np.testing.assert_array_equal(st, st_ref)
    ok = st_ref[:, 0] == 1
    assert ok.sum() > 30
    assert np.abs(got[ok] - want[ok]).max() <= 0.01


@pytest.mark.parametrize("dx,dy,deg", [(3.5, -2.25, 0.0), (0.0, 0.0, 2.0), (5.0, 3.0, -1.5), (-8.0, 6.0, 0.5)])
def test_gmc_affine_matches_opencv_and_the_truth(dx, dy, deg):
    base = _texture()
    truth = cv2.getRotationMatrix2D((160, 120), deg, 1.0)
    truth[:, 2] += (dx, dy)
    moved = cv2.warpAffine(base, truth, (320, 240), borderMode=cv2.BORDER_REFLECT)
    Hs = []
    for g in (gmc.GMC(), jbot.GMC()):
        g.apply(base)
        Hs.append(g.apply(moved).astype(np.float64))
    ys, xs = np.mgrid[20:240:40, 20:320:40]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], 0)
    got, cv, want = (H @ pts for H in (*Hs, truth))
    assert np.abs(got - cv).max() <= 0.01, np.abs(got - cv).max()
    assert np.abs(got - want).max() <= 1.0, np.abs(got - want).max()


def test_gmc_identity_first_and_on_a_size_change():
    g = gmc.GMC()
    np.testing.assert_array_equal(g.apply(_texture()), np.eye(2, 3, dtype=np.float32))
    np.testing.assert_array_equal(g.apply(_texture()[:200]), np.eye(2, 3, dtype=np.float32))
    H = g.apply(_texture()[:200])
    assert np.abs(H - np.eye(2, 3)).max() < 0.05


def test_ransac_ignores_outliers():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (60, 1, 2))
    t = np.deg2rad(10)
    A = np.array([[np.cos(t), -np.sin(t), 4.0], [np.sin(t), np.cos(t), -2.0]]) * [[1.1], [1.1]]
    A[:, 2] = (4.0, -2.0)
    dst = src @ A[:, :2].T + A[:, 2]
    dst[:15] += rng.uniform(20, 40, (15, 1, 2))  # a quarter outliers
    M = gmc.estimate_affine_partial_2d(src, dst, np.random.default_rng(1))
    np.testing.assert_allclose(M, A, atol=1e-9)
    ref, _ = cv2.estimateAffinePartial2D(src.astype(np.float32), dst.astype(np.float32), method=cv2.RANSAC)
    np.testing.assert_allclose(M, ref, atol=1e-4)
    assert gmc.estimate_affine_partial_2d(src[:1], dst[:1], np.random.default_rng(0)) is None
