"""The H.263 family in the port's video reader (``video.cpp``'s `H263`:
H.263 and H.263+ without the optional annexes, Sorenson H.263, MS-MPEG4 v2
and v3) and MPEG-4 data partitioning, against OpenCV 5.0's FFmpeg capture and
the JAX package, exactly (tolerance 0):

* every H.263-family fixture (``make_video_fixtures.py --h263``) through
  ``load_source`` equals the JAX package's frames, and the fixtures reach the
  tools they are there for (GOB-less H.263 and CIF, PLUSPTYPE's custom
  format, four vectors, Sorenson's 11-bit escapes and disposable frames,
  MS-MPEG4's slices, three escapes, vector escapes and intra blocks in
  P-frames, data-partitioned video packets; libavcodec's MS-MPEG4 encoders
  write no AC prediction, whose code MS-MPEG4 shares with MPEG-4's);
* seeded random streams from libavcodec's h263, h263p, flv, msmpeg4v2,
  msmpeg4 and MPEG-4 (data partitioning) encoders, over quantisers,
  macroblock decisions, GOPs and GOB headers, equal ``cv2.VideoCapture``;
* a DIV3 stream in Matroska (``V_MS/VFW/FOURCC``) equals OpenCV's frames;
* ``msmpeg4_tables.h`` is a run of bytes of the libavcodec the wheel bundles;
* what stays unported raises a `NotImplementedError` that names it:
  MS-MPEG4 v1 and each H.263+ annex libavcodec's h263p encoder writes on
  request but the deblocking filter (Annex J, now read as WMV2 shares it:
  ``test_torch_wmv.py``); cv2's WMV1 and WMV2 are read (ibid.), a WMV2
  stream without its ext header refused by name.
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
from make_video_fixtures import cv2_frames, encode, small_frames, tools_frames, write_avi  # noqa: E402

H263_FIXTURES = sorted(list(maker.H263_CV2) + list(maker.H263_TOOLS) + ["flv1_droppable_88x40.avi",
                                                                         "track_640x480_div3.avi"])


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


@pytest.mark.parametrize("name", H263_FIXTURES)
def test_load_source_of_an_h263_family_fixture_matches_jax(name):
    got = list(load_source(VIDEOS / name))
    ref = list(jax_load_source(str(VIDEOS / name)))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name,tools", [
    ("u263_88x40.avi", ("four_mv_mbs", "skipped_mbs", "escape3")),
    ("flv1_tools_88x40.avi", ("four_mv_mbs", "flv_escapes", "skipped_mbs", "intra_mbs_in_p")),
    ("flv1_droppable_88x40.avi", ("droppable_frames",)),
    ("mp42_tools_88x40.avi", ("escape1", "escape2", "escape3", "skipped_mbs", "intra_mbs_in_p", "video_packets")),
    ("div3_tools_88x40.avi", ("escape1", "escape2", "escape3", "skipped_mbs", "intra_mbs_in_p", "video_packets")),
    ("div3_64x48.avi", ("mv_escapes", "intra_mbs_in_p")),
    ("mpeg4_dp_88x40.avi", ("partitioned_packets", "four_mv_mbs", "dquant", "ac_pred_mbs", "skipped_mbs",
                            "intra_mbs_in_p")),
])
def test_fixtures_reach_their_tools(name, tools):
    stats = _tool_counts(VIDEOS / name)
    for tool in tools:
        assert stats[tool] > 0, tool


# ---------------------------------------------------------------- seeded random streams


RANDOM = [(maker.H263, b"H263", (144, 176)), (maker.H263P, b"U263", (40, 88)), (maker.FLV1, b"FLV1", (40, 88)),
          (maker.MSMPEG4V2, b"MP42", (40, 88)), (maker.MSMPEG4V3, b"DIV3", (40, 88))]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("codec,fourcc,hw", RANDOM, ids=["h263", "h263p", "flv", "msmpeg4v2", "msmpeg4v3"])
def test_seeded_random_h263_family_streams_equal_opencv(tmp_path, codec, fourcc, hw, seed):
    rng = np.random.default_rng(seed * 7 + codec)
    q = int(rng.choice([2, 4, 9, 17, 31]))
    options = {"g": str(int(rng.integers(2, 9))), "flags": "+qscale", "global_quality": str(q * 118),
               "mbd": str(rng.choice(["simple", "bits", "rd"]))}
    if codec in (maker.H263, maker.H263P, maker.FLV1) and seed == 1:
        options["flags"] += "+mv4"
    if codec == maker.H263 and seed == 2:
        options["ps"] = "120"  # GOB headers
    write_avi(tmp_path / "a.avi", encode(tools_frames(8, hw, seed=seed), options, codec), hw[1], hw[0], fourcc)
    _as_opencv(tmp_path / "a.avi")


def test_h263_source_formats_with_gob_headers_equal_opencv(tmp_path):
    """4CIF (two macroblock rows a GOB) and sub-QCIF with GOB headers."""
    for hw in ((576, 704), (96, 128)):
        write_avi(tmp_path / "a.avi", encode(small_frames(3, hw, seed=4), {"g": "2", "ps": "400"}, maker.H263),
                  hw[1], hw[0], b"H263")
        _as_opencv(tmp_path / "a.avi")
        assert _tool_counts(tmp_path / "a.avi")["gob_headers"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_data_partitioned_mpeg4_streams_equal_opencv(tmp_path, seed):
    rng = np.random.default_rng(seed + 40)
    options = {"g": str(int(rng.integers(3, 12))), "data_partitioning": "1", "ps": str(int(rng.integers(30, 200))),
               "flags": "+qscale" + ("+mv4" if seed % 2 else "") + ("+aic" if seed > 1 else ""),
               "global_quality": str(int(rng.choice([2, 6, 14, 31])) * 118)}
    if seed == 3:
        options.update(lumi_mask="0.8", dark_mask="0.9", bf="1")
    write_avi(tmp_path / "a.avi", encode(tools_frames(10, seed=seed), options, maker.MPEG4), 88, 40, b"FMP4")
    _as_opencv(tmp_path / "a.avi")
    assert _tool_counts(tmp_path / "a.avi")["partitioned_packets"] > 0


def test_msmpeg4_in_matroska_equals_opencv(tmp_path):
    """A DIV3 stream as V_MS/VFW/FOURCC (its BITMAPINFOHEADER in CodecPrivate):
    the frame size comes from that header."""
    packets = video.demux(VIDEOS / "div3_64x48.avi").packets
    bih = struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"DIV3", 64 * 48 * 3, 0, 0, 0, 0)
    path = tmp_path / "div3.mkv"
    maker.write_mkv(path, packets, 64, 48, codec="V_MS/VFW/FOURCC", doctype="matroska", private=bih)
    stream = video.demux(path)
    assert (stream.codec, stream.tag, stream.size) == ("msmpeg4v3", b"DIV3", (64, 48))
    assert len(_as_opencv(path)) == len(packets)


def test_msmpeg4_tables_equal_libavcodec_bytes():
    """Each array of msmpeg4_tables.h is a run of bytes of the libavcodec that
    OpenCV's wheel bundles (msmpeg4data.c's tables)."""
    lib = sorted((Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs").glob("libavcodec-*.so*"))[0]
    blob = lib.read_bytes()
    text = (REPO / "quan_ultralytics_tpu_torch" / "data" / "native" / "msmpeg4_tables.h").read_text()
    arrays = re.findall(r"const (u?int\d+)_t (\w+)((?:\[\d+\])+) = \{([^}]*)\};", text)
    assert len(arrays) == 23
    dtypes = {"uint8": np.uint8, "int8": np.int8, "uint16": "<u2", "uint32": "<u4"}
    for ctype, name, dims, body in arrays:
        values = [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]
        assert len(values) == int(np.prod([int(d) for d in re.findall(r"\d+", dims)])), name
        assert np.array(values).astype(dtypes[ctype]).tobytes() in blob, name


# ---------------------------------------------------------------- what stays unported


@pytest.mark.parametrize("fourcc,match", [("WMV1", None),
                                          ("WMV2", r"WMV2: a stream without the 4 bytes of extradata")])
def test_windows_media_video_is_refused_by_name(tmp_path, fourcc, match):
    """cv2's WMV1 and WMV2 AVIs are read as cv2 reads them; what stays refused
    by name is a WMV2 stream without the ext header its BITMAPINFOHEADER
    carries (FFmpeg conceals its pictures)."""
    path = tmp_path / "a.avi"
    maker.write_cv2(path, fourcc, small_frames(2))
    _as_opencv(path)
    if match:
        stream = video.demux(path)
        write_avi(tmp_path / "b.avi", stream.packets, 64, 48, stream.tag)
        assert len(cv2_frames(tmp_path / "b.avi")) == 2
        with pytest.raises(NotImplementedError, match=match):
            list(load_source(tmp_path / "b.avi"))


def test_msmpeg4_v1_is_refused_by_name(tmp_path):
    """MS-MPEG4 v1 (MP41, MPG4): no encoder writes it; a file that names it."""
    for tag in (b"MP41", b"MPG4"):
        write_avi(tmp_path / "a.avi", [bytes(64)], 64, 48, tag)
        with pytest.raises(NotImplementedError, match=r"MS-MPEG4 v1 codec"):
            list(video.frames(tmp_path / "a.avi"))


@pytest.mark.parametrize("options,match", [
    ({"umv": "1"}, "unlimited unrestricted motion vector mode .H.263 Annex D."),
    ({"obmc": "1"}, "advanced prediction mode .H.263 Annex F."),
    ({"flags": "+aic"}, "advanced intra coding .H.263 Annex I."),
    ({"flags": "+loop"}, "deblocking filter .H.263 Annex J."),
    ({"structured_slices": "1"}, "slice structured mode .H.263 Annex K."),
    ({"aiv": "1"}, "alternative inter VLC .H.263 Annex S."),
])
def test_h263_plus_annexes_are_refused_by_name(tmp_path, options, match):
    """Each annex refused by name from the picture header, but the deblocking
    filter (Annex J), which is read (``tests/test_torch_wmv.py`` holds it on
    more streams)."""
    write_avi(tmp_path / "a.avi", encode(tools_frames(2), options, maker.H263P), 88, 40, b"U263")
    assert len(cv2_frames(tmp_path / "a.avi")) == 2
    if "Annex J" in match:
        _as_opencv(tmp_path / "a.avi")
        return
    with pytest.raises(NotImplementedError, match="H.263: the " + match if "advanced intra" not in match
                       else "H.263: " + match):
        list(video.frames(tmp_path / "a.avi"))
