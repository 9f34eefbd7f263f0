"""Windows Media Video 7 and 8 (WMV1, WMV2) and H.263+'s deblocking filter
(Annex J) in the port's video reader (``video.cpp``'s `H263`), against OpenCV
5.0's FFmpeg capture and the JAX package, exactly (tolerance 0):

* every WMV and Annex J fixture (``make_video_fixtures.py --wmv``) through
  ``load_source`` equals the JAX package's frames (``test_torch_video.py``
  holds each frame and packet to cv2), and the fixtures reach the tools they
  are there for: WMV1's inter-intra DC prediction, run-level tables per
  macroblock and slices, WMV2's loop filter and top-left vector predictor,
  mspel motion with hshift, its
  three skip maps and a picture FFmpeg decodes to no frame, per-macroblock
  run-level tables, CBP tables other than the encoder's and ABT (8x4 and 4x8
  sub-blocks, by picture, macroblock and block), Annex J with four vectors;
* seeded random streams of libavcodec's wmv1, wmv2 (with and without the loop
  filter, then rewritten by `wmv2_crafted` or `wmv2_top_left`) and h263p
  ``+loop`` encoders over
  quantisers, bit rates and sizes equal ``cv2.VideoCapture``;
* ``wmv_tables.h`` is a run of bytes of the libavcodec the wheel bundles;
* what stays unported raises a `NotImplementedError` that names it (WMV2's
  IntraX8 J-frames and a stream without its ext header), and an ASF
  ``.wmv`` file is refused where the JAX package refuses
  it (cv2.imread reads none: FileNotFoundError there, the port's refusal of a
  kind it does not read here).
"""

import re
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.data.native import video

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
VIDEOS = FIXTURES / "video"
sys.path.insert(0, str(FIXTURES))
import make_video_fixtures as maker  # noqa: E402
from make_video_fixtures import _bits, _edit, cv2_frames, encode, tools_frames, write_avi  # noqa: E402

WMV_FIXTURES = sorted(list(maker.WMV_CV2) + list(maker.WMV_TOOLS) + ["track_640x480_wmv2.avi"])


def _as_opencv(path: Path) -> list:
    ref = cv2_frames(path)
    got = list(video.frames(path))
    assert len(got) == len(ref) > 0, path.name
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    return got


def _tool_counts(path: Path) -> dict:
    stream = video.demux(path)
    dec = video.Decoder(stream.codec, stream.private, stream.tag, stream.size)
    for p in stream.packets:
        dec.send(p)
    return dec._tool_counts()


@pytest.mark.parametrize("name", WMV_FIXTURES)
def test_load_source_of_a_wmv_fixture_matches_jax(name):
    got = list(load_source(VIDEOS / name))
    ref = list(jax_load_source(str(VIDEOS / name)))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name,tools", [
    ("wmv1_ii_88x40.avi", ("inter_intra_pictures", "inter_intra_mbs", "intra_mbs_in_p", "wmv_escape3_lengths",
                           "escape1", "escape2", "skipped_mbs")),
    ("wmv1_mbrl_88x40.avi", ("per_mb_rl_pictures", "video_packets")),
    ("wmv2_loop_88x40.avi", ("loop_filtered_mbs", "intra_mbs_in_p", "top_left_mvs")),
    ("wmv2_crafted_88x40.avi", ("mspel_pictures", "hshift_mbs", "skip_maps", "skipped_mbs", "skipped_pictures",
                                "per_mb_rl_pictures", "abt_blocks")),
    ("u263_loop_88x40.avi", ("loop_filtered_mbs", "four_mv_mbs", "skipped_mbs", "intra_mbs_in_p")),
])
def test_wmv_fixtures_reach_their_tools(name, tools):
    stats = _tool_counts(VIDEOS / name)
    for tool in tools:
        assert stats[tool] > 0, tool


def test_the_crafted_wmv2_fixture_uses_every_skip_map_cbp_table_and_abt_kind():
    """`wmv2_crafted`'s pictures: the three skip maps, CBP table indices
    other than 0 and ABT by macroblock and by picture, both 8x4 and 4x8, are
    in the stream as written (type, quantiser, skip type; with no skip map
    the CBP index, mspel, then per_mb_abt ^ 1 and the picture's ABT type)."""
    stream = video.demux(VIDEOS / "wmv2_crafted_88x40.avi")
    kinds, indices, abt = set(), set(), set()
    for p in stream.packets[1:]:
        bits = _bits(p)
        kinds.add(int(bits[6:8], 2))
        if bits[6:8] == "00":
            index, n = maker._read012(bits, 8)
            indices.add(index)
            at = 8 + n + 1
            abt.add("mb" if bits[at] == "0" else maker._read012(bits, at + 1)[0])
    assert kinds == {0, 1, 2, 3} and indices - {0} and abt == {0, 1, 2, "mb"}
    assert len(stream.packets) == 22 and len(cv2_frames(VIDEOS / "wmv2_crafted_88x40.avi")) == 21


# ---------------------------------------------------------------- seeded random streams


@pytest.mark.parametrize("seed", range(3))
def test_seeded_random_wmv1_streams_equal_opencv(tmp_path, seed):
    """Bit rates on both sides of MBAC_BITRATE and II_BITRATE, fixed and
    rate-controlled quantisers, GOPs, RD decisions, one to three slices and,
    above 50 kbit/s, run-level tables per macroblock."""
    rng = np.random.default_rng(seed + 70)
    hw = [(40, 88), (48, 64), (64, 96)][seed]
    options = {"b": str(int(rng.choice([30, 100, 400]))) + "k", "g": str(int(rng.integers(3, 9))),
               "mbd": str(rng.choice(["simple", "rd"]))}
    if seed != 1:
        options.update(flags="+qscale", global_quality=str(int(rng.choice([2, 6, 13, 24, 31])) * 118))
    packets = encode(maker.wmv_frames(8, hw, seed), options, maker.WMV1)
    if int(options["b"][:-1]) > 50:
        packets = maker.per_mb_rl(packets, (hw[1], hw[0]), "wmv1")
    write_avi(tmp_path / "a.avi", maker.msmpeg4_slices(packets, 1 + seed), hw[1], hw[0], b"WMV1")
    _as_opencv(tmp_path / "a.avi")


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_wmv2_streams_equal_opencv(tmp_path, seed):
    """libavcodec's wmv2 over quantisers and GOPs, with the loop filter on
    odd seeds, rewritten by `wmv2_crafted` (mspel and hshift, skip maps,
    per-macroblock run-level tables, other CBP tables, ABT) and `per_mb_rl`,
    and on seed 2 in two slices (the ext header's slice code)."""
    rng = np.random.default_rng(seed + 80)
    hw = [(40, 88), (48, 64), (64, 96), (32, 48)][seed]
    q = int(rng.choice([2, 5, 11, 17, 26, 31]))
    options = {"flags": "+qscale" + ("+loop" if seed % 2 else ""), "global_quality": str(q * 118),
               "g": str(int(rng.integers(6, 22)))}
    extra = []
    packets = encode(maker.wmv_frames(21, hw, seed), options, maker.WMV2, extradata=extra)
    extra, size = extra[0], (hw[1], hw[0])
    packets = maker.wmv2_crafted(maker.per_mb_rl(packets, size, "wmv2", extra), size, extra, seed=seed)
    if seed == 2:
        extra = maker.ext_header(extra, slice_code=2)
    write_avi(tmp_path / "a.avi", packets, size[0], size[1], b"WMV2", extra=extra)
    _as_opencv(tmp_path / "a.avi")


@pytest.mark.parametrize("seed", range(2))
def test_seeded_random_wmv2_top_left_streams_equal_opencv(tmp_path, seed):
    """libavcodec's wmv2 rewritten by `wmv2_top_left`: top_left_mv_flag set,
    a bit picking the left or the top vector where they differ by 8 or more."""
    rng = np.random.default_rng(seed + 85)
    hw = [(48, 112), (64, 80)][seed]
    options = {"flags": "+qscale" + ("+loop" if seed else ""), "global_quality": str(int(rng.integers(2, 25)) * 118)}
    extra = []
    packets = encode(maker.wmv_frames(10, hw, seed + 4), options, maker.WMV2, extradata=extra)
    packets, extra = maker.wmv2_top_left(packets, (hw[1], hw[0]), extra[0], seed=seed)
    write_avi(tmp_path / "a.avi", packets, hw[1], hw[0], b"WMV2", extra=extra)
    _as_opencv(tmp_path / "a.avi")
    assert _tool_counts(tmp_path / "a.avi")["top_left_mvs"] > 0


@pytest.mark.parametrize("seed", range(2))
def test_seeded_random_h263_plus_deblocking_streams_equal_opencv(tmp_path, seed):
    """H.263+ with Annex J (``flags=+loop``, which FFmpeg's h263p encoder
    pairs with unrestricted vectors), four vectors on seed 1, over quantisers."""
    rng = np.random.default_rng(seed + 90)
    q = int(rng.choice([3, 8, 15, 24, 31]))
    options = {"flags": "+loop+qscale" + ("+mv4" if seed else ""), "global_quality": str(q * 118),
               "g": str(int(rng.integers(3, 9)))}
    write_avi(tmp_path / "a.avi", encode(tools_frames(8, seed=seed), options, maker.H263P), 88, 40, b"U263")
    _as_opencv(tmp_path / "a.avi")
    assert _tool_counts(tmp_path / "a.avi")["loop_filtered_mbs"] == 8 * 6 * 3


def test_wmv_tables_equal_libavcodec_bytes():
    """Each array of wmv_tables.h is a run of bytes of the libavcodec that
    OpenCV's wheel bundles (msmpeg4data.c's and h263data.c's tables), each of
    the three WMV2 macroblock tables on its own."""
    lib = sorted((Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs").glob("libavcodec-*.so*"))[0]
    blob = lib.read_bytes()
    text = (REPO / "quan_ultralytics_tpu_torch" / "data" / "native" / "wmv_tables.h").read_text()
    arrays = re.findall(r"const (u?int\d+)_t (\w+)((?:\[\d+\])+) = \{([^}]*)\};", text)
    assert [a[1] for a in arrays] == ["kWmv1Scantable", "kWmv1YDcScale", "kTableInterIntra", "kWmv2InterTable",
                                      "kWmv2ScantableA", "kWmv2ScantableB", "kLoopFilterStrength"]
    dtypes = {"uint8": np.uint8, "uint32": "<u4"}
    for ctype, name, dims, body in arrays:
        shape = [int(d) for d in re.findall(r"\d+", dims)]
        values = np.array([int(v) for v in body.replace("\n", " ").split(",") if v.strip()])
        assert values.size == np.prod(shape), name
        for part in values.reshape(3, -1) if name == "kWmv2InterTable" else [values]:
            assert part.astype(dtypes[ctype]).tobytes() in blob, name


# ---------------------------------------------------------------- what stays unported


def _wmv2_stream():
    stream = video.demux(VIDEOS / "wmv2_64x48.avi")
    return stream.packets, stream.private


@pytest.mark.parametrize("what,match", [
    ("j_type", "IntraX8 J-frames"),
    ("no_ext", "a stream without the 4 bytes of extradata"),
])
def test_unported_wmv2_tools_are_refused_by_name(tmp_path, what, match):
    """cv2's WMV2 stream rewritten to signal what libavcodec's encoder never
    writes and no rewrite here makes a stream of: a J-frame (j_type in the
    I-frame); and the stream without its ext header, which FFmpeg decodes
    with its pictures concealed."""
    packets, extra = _wmv2_stream()
    if what == "j_type":  # I-frame: type, 7 bits, quantiser, then j_type
        packets[0] = _edit(packets[0], [(13, 1, "1")])
    else:
        extra = b""
    write_avi(tmp_path / "a.avi", packets, 64, 48, b"WMV2", extra=extra)
    assert len(cv2_frames(tmp_path / "a.avi")) > 0
    with pytest.raises(NotImplementedError, match="WMV2: " + match):
        list(load_source(tmp_path / "a.avi"))


def test_an_asf_wmv_file_is_refused_where_the_jax_package_refuses_it(tmp_path):
    """``.wmv`` (ASF) is not among VID_EXTS, so both packages read it as a
    still: cv2.imread returns None and the JAX package raises
    FileNotFoundError; the port refuses it as a kind of file it does not read."""
    path = tmp_path / "a.wmv"
    maker.write_cv2(path, "WMV2", maker.small_frames(2))
    assert path.read_bytes()[:4] == bytes.fromhex("3026b275")  # the ASF header GUID
    assert cv2.imread(str(path)) is None
    with pytest.raises(FileNotFoundError):
        list(jax_load_source(str(path)))
    with pytest.raises(NotImplementedError, match="this kind of file is not read"):
        list(load_source(str(path)))


def test_wmv_in_matroska_is_the_avi_stream(tmp_path):
    """V_MS/VFW/FOURCC carries WMV2's ext header after the BITMAPINFOHEADER,
    as AVI does: the same codec, configuration and packets."""
    avi, mkv = video.demux(VIDEOS / "wmv2_64x48.avi"), video.demux(VIDEOS / "wmv2_64x48.mkv")
    assert (mkv.codec, mkv.private, mkv.size) == (avi.codec, avi.private, avi.size)
    assert (avi.codec, avi.size, len(avi.private)) == ("wmv2", (64, 48), 4)
    assert struct.unpack(">I", avi.private)[0] >> 27 == 25  # the ext header's frame rate
    assert mkv.packets == avi.packets
