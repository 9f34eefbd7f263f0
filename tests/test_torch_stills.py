"""The stills ``cv2.imread`` takes outside the dataset formats (PxM, PAM, PFM,
Sun raster, Radiance HDR, GIF), read by the port against OpenCV 5.0 and the
JAX package, exactly (tolerance 0):

* every committed ``tests/fixtures/image/still_*`` file (written by
  ``make_still_fixtures.py``): `imread` equals ``cv2.imread`` then BGR->RGB,
  or raises `ValueError` where OpenCV reads nothing, and the port's
  ``load_source`` equals the JAX package's (both raise `FileNotFoundError`
  on a file OpenCV reads nothing of);
* seeded random files built here by the fixture maker's writers: every PxM
  kind over maxvals and comments, PAM's kinds and bit mode, PFM's byte
  orders and scales, Sun raster's depths and colour maps, Radiance's
  scanline kinds, GIF over LZW code sizes, interlacing, offsets, local tables
  and transparency;
* the kinds OpenCV 5.0 reads nothing of (Sun raster's byte-encoded and RGB
  types, gray PFM) raise `ValueError`; the dataset readers (`read_shape`)
  refuse every one of these kinds by name.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu_torch.data.native.native import imread, read_shape

FIXTURES = Path(__file__).resolve().parent / "fixtures"
STILLS = sorted(k for k, v in json.loads((FIXTURES / "image_fixtures.json").read_text()).items() if v.get("still"))


def _maker():
    spec = importlib.util.spec_from_file_location("make_still_fixtures", FIXTURES / "make_still_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()


def _cv2_rgb(path):
    im = cv2.imread(str(path))
    return None if im is None else cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def _as_opencv(path: Path, data: bytes = None) -> np.ndarray:
    if data is not None:
        path.write_bytes(data)
    ref = _cv2_rgb(path)
    if ref is None:
        with pytest.raises(ValueError):
            imread(path)
        return None
    got = imread(path)
    assert got.shape == ref.shape and got.dtype == np.uint8, path.name
    np.testing.assert_array_equal(got, ref, err_msg=path.name)
    return got


# ---------------------------------------------------------------- committed fixtures


def test_still_fixtures_cover_every_kind():
    kinds = {Path(n).suffix for n in STILLS}
    assert kinds == {".ppm", ".pgm", ".pbm", ".pam", ".pfm", ".ras", ".hdr", ".gif"}
    assert sum(n.startswith("still_broken_") for n in STILLS) == 7


@pytest.mark.parametrize("name", STILLS)
def test_still_fixture_as_opencv_and_jax(name):
    from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
    from quan_ultralytics_tpu_torch.data.loaders import load_source

    path = FIXTURES / "image" / name
    got = _as_opencv(path)
    if got is None:
        for fn in (load_source, jax_load_source):
            with pytest.raises(FileNotFoundError):
                list(fn(str(path)))
        return
    ours, ref = list(load_source(path)), list(jax_load_source(str(path)))
    assert len(ours) == len(ref) == 1
    np.testing.assert_array_equal(ours[0], ref[0])


@pytest.mark.parametrize("name", ["still_cv2.gif", "still_cv2_p6.ppm", "still_cv2.pfm", "still_cv2.ras",
                                  "still_cv2.hdr", "still_cv2.pam"])
def test_dataset_readers_refuse_the_stills_by_name(name):
    with pytest.raises(NotImplementedError, match="read by imread only"):
        read_shape(FIXTURES / "image" / name)


# ---------------------------------------------------------------- PxM, PAM, PFM


PNM_KINDS = [(1, 1), (4, 1)] + [(k, m) for k in (2, 3, 5, 6) for m in (1, 7, 100, 255, 1000, 65535)]


@pytest.mark.parametrize("kind,maxval", PNM_KINDS)
def test_pnm_kinds_and_maxvals_as_opencv(tmp_path, kind, maxval):
    rng = np.random.default_rng(kind * 100 + maxval)
    h, w = 5, 11
    if kind in (1, 4):  # PBM: no maxval
        px = rng.integers(0, 2, (h, w))
    else:
        shape = (h, w, 3) if kind in (3, 6) else (h, w)
        px = rng.integers(0, maxval + 1, shape)
    comment = b"# seeded\n" if maxval % 2 else b""
    _as_opencv(tmp_path / "a.pnm", MAKER.pnm(px, kind, maxval, comment))


def test_pnm_samples_above_maxval_and_layouts_as_opencv(tmp_path):
    _as_opencv(tmp_path / "a.pgm", b"P2 3 2 100\n0 10 20 30 100 101\n")  # clipped to maxval
    _as_opencv(tmp_path / "b.ppm", b"P6\r\n2 1\r\n255\r" + bytes(range(6)))
    _as_opencv(tmp_path / "c.ppm", b"P6 # x\n2 #y\n 1\n#z\n255\n" + bytes(range(6)))
    _as_opencv(tmp_path / "d.pbm", b"P1\n3 2\n1 0 1\n0 1 1\n")
    for bad in (b"P3\n2 1\n255\n1 2 x 4 5 6\n", b"P3\n2 1\n255\n1 2 3 4 5", b"P6\n2 2\n255\n" + bytes(5),
                b"P5\n0 2\n255\n", b"P5\n2 2\n70000\n" + bytes(8)):
        assert _as_opencv(tmp_path / "bad.pnm", bad) is None


@pytest.mark.parametrize("depth,tupltype,maxval", [(1, b"GRAYSCALE", 255), (3, b"RGB", 255), (1, b"", 200),
                                                   (3, b"", 4000), (3, b"", 100), (1, b"BLACKANDWHITE", 1), (3, b"RGB", 1),
                                                   (1, b"GRAYSCALE", 65535)])
def test_pam_kinds_as_opencv(tmp_path, depth, tupltype, maxval):
    rng = np.random.default_rng(depth + maxval)
    px = rng.integers(0, 256 if maxval == 1 else maxval + 1, (6, 13, depth))
    _as_opencv(tmp_path / "a.pam", MAKER.pam(px, maxval, tupltype))


def test_pam_alpha_kinds_drop_alpha(tmp_path):
    """OpenCV 5.0 fills only the first pixels of each row of a GRAYSCALE_ALPHA
    or RGB_ALPHA file (the rest is whatever its buffer held): the first
    column agrees with it, and the port drops the alpha sample."""
    rng = np.random.default_rng(7)
    for depth, tupltype in ((2, b"GRAYSCALE_ALPHA"), (4, b"RGB_ALPHA")):
        px = rng.integers(0, 256, (4, 9, depth)).astype(np.uint8)
        path = tmp_path / f"a{depth}.pam"
        path.write_bytes(MAKER.pam(px, 255, tupltype))
        got, ref = imread(path), _cv2_rgb(path)
        want = np.repeat(px[..., :1], 3, -1) if depth == 2 else px[..., :3]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    for bad in (MAKER.pam(px, 255, b"RGB"), MAKER.pam(px[..., :2], 255), MAKER.pam(px[..., :3], 255, b"FOO"),
                MAKER.pam(px[..., :3], 255, b"GRAYSCALE"), b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nENDHDR\n\1\2\3"):
        assert _as_opencv(tmp_path / "bad.pam", bad) is None


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, 3.0])
def test_pfm_byte_orders_and_scales_as_opencv(tmp_path, scale):
    rng = np.random.default_rng(int(scale * 10) + 50)
    px = (rng.random((7, 9, 3)) * 300 - 20).astype(np.float32)
    px[0, 0] = (0.5, 1.5, 2.5)  # halves round to even
    px[1, 1] = (np.inf, -np.inf, np.nan)
    px[2, 2] = (1e20, -1e20, 254.5)
    _as_opencv(tmp_path / "a.pfm", MAKER.pfm(px, scale))
    assert _as_opencv(tmp_path / "g.pfm", b"Pf\n2 1\n-1.0\n" + np.ones(2, "<f4").tobytes()) is None


# ---------------------------------------------------------------- Sun raster


@pytest.mark.parametrize("bpp,colour_map,w", [(1, False, 13), (1, True, 16), (8, False, 7), (8, True, 10),
                                              (24, False, 7), (32, False, 6)])
def test_sun_raster_depths_and_maps_as_opencv(tmp_path, bpp, colour_map, w):
    rng = np.random.default_rng(bpp * 10 + w)
    h = 5
    if bpp == 24:
        px = rng.integers(0, 256, (h, w, 3))
    elif bpp == 32:
        px = rng.integers(0, 256, (h, w, 4))
    else:
        px = rng.integers(0, 1 << bpp, (h, w))
    cmap = rng.integers(0, 256, (3, 2 if bpp == 1 else 50)) if colour_map else None
    if colour_map and bpp == 8:
        px = px % 60  # indices past the map: black
    for kind in (0, 1):  # RT_OLD and RT_STANDARD
        _as_opencv(tmp_path / "a.ras", MAKER.sun(px, bpp, cmap, kind))


def test_sun_raster_kinds_opencv_reads_nothing_of(tmp_path):
    px = np.random.default_rng(3).integers(0, 256, (4, 6, 3))
    for data in (MAKER.sun(px, 24, kind=3), MAKER.sun(px[..., 0], 8, kind=2), MAKER.sun(px, 24)[:60],
                 MAKER.sun(px[..., 0], 8, np.zeros((3, 300)))):
        assert _as_opencv(tmp_path / "a.ras", data) is None


# ---------------------------------------------------------------- Radiance HDR


@pytest.mark.parametrize("w,rle", [(5, True), (9, True), (40, True), (9, False), (200, True)])
def test_radiance_scanlines_as_opencv(tmp_path, w, rle):
    rng = np.random.default_rng(w)
    rgb = (rng.random((4, w, 3)) ** 2 * 1.4).astype(np.float32)
    rgb[:, w // 3:w // 2] = 0.25  # runs
    rgbe = MAKER.to_rgbe(rgb)
    rgbe[0, 0] = (1, 1, 1, 3)  # an old-style run pixel: rgbe.cpp reads it as a pixel
    rgbe[1, 1, 3] = 230  # past what 8 bits hold: OpenCV's conversion gives 0
    _as_opencv(tmp_path / "a.hdr", MAKER.hdr(rgbe, rle))
    for header in (b"#?RGBE\nEXPOSURE=1\nFORMAT=32-bit_rle_rgbe\n\n", b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n",
                   b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n"):
        _as_opencv(tmp_path / "b.hdr", MAKER.hdr(rgbe, rle, header))
    assert _as_opencv(tmp_path / "c.hdr", MAKER.hdr(rgbe, False)[:-9]) is None


# ---------------------------------------------------------------- GIF


@pytest.mark.parametrize("min_size", [2, 3, 5, 8])
@pytest.mark.parametrize("interlace", [False, True])
def test_gif_code_sizes_and_interlace_as_opencv(tmp_path, min_size, interlace):
    rng = np.random.default_rng(min_size * 2 + interlace)
    colours = 1 << min_size
    gct = bytes(rng.integers(0, 256, 3 * colours, dtype=np.uint8))
    smooth = (np.add.outer(np.arange(37), np.arange(29)) // 3 % colours).astype(np.uint8)
    noisy = rng.integers(0, colours, (37, 29)).astype(np.uint8)
    idx = np.where(rng.random((37, 29)) < 0.3, noisy, smooth)
    _as_opencv(tmp_path / "a.gif", MAKER.gif((29, 37), gct, 1, [dict(idx=idx, at=(0, 0), interlace=interlace,
                                                                     min_size=min_size)]))


@pytest.mark.parametrize("case", ["offset", "transparent", "local", "no_global", "second_frame"])
def test_gif_canvas_as_opencv(tmp_path, case):
    rng = np.random.default_rng(len(case))
    gct = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    lct = bytes(rng.integers(0, 256, 24, dtype=np.uint8))
    idx = rng.integers(0, 8, (6, 9)).astype(np.uint8)
    frame = dict(idx=idx, at=(4, 2))
    if case == "transparent":
        frame["transparent"] = 3
    if case in ("local", "no_global"):
        frame["lct"] = lct
    frames = [frame] + ([dict(idx=idx[::-1], at=(0, 0))] if case == "second_frame" else [])
    _as_opencv(tmp_path / "a.gif", MAKER.gif((16, 11), b"" if case == "no_global" else gct, 5, frames))


def test_gif_files_opencv_reads_nothing_of(tmp_path):
    gct = bytes(range(12))
    idx = np.array([[0, 1], [2, 3]], np.uint8)
    for data in (MAKER.gif((2, 2), gct, 0, [dict(idx=idx, at=(1, 1))]),  # outside the screen
                 MAKER.gif((2, 2), gct, 9, [dict(idx=idx, at=(0, 0))]),  # background past the table
                 MAKER.gif((2, 2), gct, 0, [dict(idx=idx + 2, at=(0, 0), min_size=3)]),  # index past the table
                 MAKER.gif((2, 2), gct, 0, [dict(idx=idx, at=(0, 0))])[:-6]):  # LZW data cut
        assert _as_opencv(tmp_path / "a.gif", data) is None
