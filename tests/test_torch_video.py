"""The port's video reader (``data/native/video.py`` and ``video.cpp``) on the
CPU against OpenCV 5.0's FFmpeg capture, and the JAX package's
``load_source`` and ``yolo track`` of a video against the port's.

* Demuxers: every committed fixture's packets (``tests/fixtures/video/``,
  written by ``make_video_fixtures.py``) and those of clips written here by
  ``cv2.VideoWriter`` are byte-equal to the packets ``cv2.VideoCapture`` gives
  with ``CAP_PROP_FORMAT = -1``.
* Decoders: every frame equals ``cv2.VideoCapture`` + ``cvtColor(BGR2RGB)``
  exactly (tolerance 0: FFmpeg's IDCT, reconstruction, x86 half-pel averages
  and swscale arithmetic are reproduced), and its SHA-256 is the one
  ``video_fixtures.json`` records for the port and for OpenCV.
* Edge cases as ``cv2.VideoCapture``: a missing or unreadable file yields no
  frames, a truncated one the frames of its whole packets; a codec or coding
  tool the port does not decode raises a `NotImplementedError` naming it;
  damaged packets end the stream or raise, never crash the process.
* VP8 (key and inter frames, profiles 0-3, invisible frames) and MPEG-4
  Advanced Simple Profile (B-VOPs in display order, quarter-pel, MPEG
  quantisation with default and carried matrices, the Xvid IDCT and FFmpeg's
  workarounds for Xvid, DivX and old libavcodec builds, DivX's packed
  B-VOPs), on the committed fixtures and on seeded random streams from the
  libvpx and libavcodec encoders the wheel bundles.
"""

import json
import random
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu import cli as jcli
from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
from quan_ultralytics_tpu_torch import cli as tcli
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.data.native import video
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
VIDEOS = FIXTURES / "video"
DIGESTS = json.loads((FIXTURES / "video_fixtures.json").read_text())
# the decoded fixtures whose frames this file holds to OpenCV's (VP9's: tests/test_torch_vp9.py)
DECODED = sorted(k for k, v in DIGESTS.items() if "per_frame" in v and v["codec"] != "vp9")
sys.path.insert(0, str(FIXTURES))
from make_video_fixtures import (NOT_CODED_VOP, cv2_frames, encode_mpeg4, encode_vp8, pack_b_frames,  # noqa: E402
                                 set_user_data, sha, small_frames, tools_frames, write_avi)


def cv2_packets(path) -> list:
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        out.append(p.reshape(-1).tobytes())
    cap.release()
    return out


def test_fixtures_cover_every_container_and_codec():
    """Every container of the demuxers and the codecs are among the
    fixtures, cv2's FFV1 AVI the one refused; the small clips are a few KB
    each, the three 640 x 480 clips of the later slices about 1.4 MB
    together, the DIV3 one (the H.263 family's slice) under 500 KB, the WMV2
    one (libavcodec at quantiser 22) under 50 KB."""
    kinds = {(v.get("container"), v.get("codec")) for v in DIGESTS.values()}
    for kind in [("ISO-BMFF", "mpeg4"), ("AVI", "mpeg4"), ("Matroska", "mpeg4"), ("AVI", "mjpeg"),
                 ("Matroska", "mjpeg"), ("Matroska", "vp8"), ("AVI", "vp8"), ("Matroska", "vp9"), ("AVI", "vp9"),
                 ("ISO-BMFF", "vp9"), ("AVI", "h263"), ("AVI", "h263p"), ("AVI", "flv1"), ("AVI", "msmpeg4v2"),
                 ("AVI", "msmpeg4v3"), ("AVI", "wmv1"), ("Matroska", "wmv1"), ("AVI", "wmv2"), ("Matroska", "wmv2")]:
        assert kind in kinds
    assert {p.suffix for p in VIDEOS.iterdir()} == {".mp4", ".mov", ".m4v", ".avi", ".mkv", ".webm"}
    assert [k for k, v in DIGESTS.items() if "refused" in v] == ["ffv1_64x48.avi"]
    small = [p for p in VIDEOS.iterdir() if not p.name.startswith("track_")]
    assert max(p.stat().st_size for p in small) < 30_000
    assert sum((VIDEOS / n).stat().st_size
               for n in ("track_640x480.webm", "track_640x480_xvid.avi", "track_640x480_vp9.webm")) < 1_500_000
    assert (VIDEOS / "track_640x480_div3.avi").stat().st_size < 500_000
    assert (VIDEOS / "track_640x480_wmv2.avi").stat().st_size < 50_000
    assert sum(p.stat().st_size for p in VIDEOS.iterdir()) < 3_500_000


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_packets_equal_ffmpeg_demuxers(name):
    path = VIDEOS / name
    ref = cv2_packets(path)
    assert len(ref) >= DIGESTS[name]["frames"] > 0
    if "refused" in DIGESTS[name]:
        with pytest.raises(NotImplementedError, match=re.escape(DIGESTS[name]["refused"].split(": ", 1)[1])):
            video.demux(path)
        return
    stream = video.demux(path)
    assert stream.codec == DIGESTS[name]["codec"] and stream.container == DIGESTS[name]["container"]
    assert len(stream.packets) == len(ref)
    assert all(g == r for g, r in zip(stream.packets, ref))


@pytest.mark.parametrize("name", DECODED)
def test_frames_equal_opencv(name):
    path = VIDEOS / name
    ref = cv2_frames(path)
    got = list(video.frames(path))
    per_frame = DIGESTS[name]["per_frame"]
    assert len(got) == len(ref) == len(per_frame) == DIGESTS[name]["frames"]
    for g, r, d in zip(got, ref, per_frame):
        assert g.dtype == np.uint8 and g.shape == r.shape == tuple(DIGESTS[name]["shape"])
        np.testing.assert_array_equal(g, r)
        assert sha(g) == d["port"] == d["cv2"] and d["max_diff"] == 0 and d["share_differ"] == 0.0


def test_tools_fixture_exercises_the_mpeg4_tools():
    """The libavcodec-encoded fixture reaches the tools that cv2.VideoWriter's
    streams do not: four vectors, AC prediction and its rescaling, DQUANT,
    video packets, a VOP that is not coded, skipped and intra macroblocks in
    P-VOPs, all three escapes and both rounding types."""
    stream = video.demux(VIDEOS / "mpeg4_tools_88x40.avi")
    dec = video.Decoder(stream.codec, stream.private, stream.tag)
    frames = sum(dec.send(p) for p in stream.packets)
    stats = dec._tool_counts()
    assert frames == 14 and len(stream.packets) == 15
    assert stats["not_coded_vops"] == 1 and stats["i_vops"] == 2 and stats["p_vops"] == 12
    for tool in ("skipped_mbs", "intra_mbs_in_p", "four_mv_mbs", "dquant", "video_packets", "escape1",
                 "escape2", "escape3", "ac_pred_mbs", "no_rounding_mbs", "ac_rescaled"):
        assert stats[tool] > 0, tool


def tool_counts(name: str) -> dict:
    """`Decoder._tool_counts` after every packet of a fixture and the flush."""
    stream = video.demux(VIDEOS / name)
    dec = video.Decoder(stream.codec, stream.private, stream.tag)
    frames = sum(dec.send(p) for p in stream.packets) + dec.flush()
    return dict(dec._tool_counts(), frames=frames, packets=len(stream.packets))


def test_asp_fixtures_exercise_the_asp_tools():
    """The libavcodec-encoded ASP fixtures reach what they were written for:
    B-VOPs in all four macroblock modes (direct, forward, backward,
    interpolated), B macroblocks skipped with their co-located one, DBQUANT,
    quarter-pel, MPEG quantisation, the Xvid IDCT under Xvid's user data and
    the packed B-VOPs of the DivX AVI, each with as many frames as VOPs."""
    asp = tool_counts("mpeg4_asp_88x40.avi")
    for tool in ("b_vops", "b_direct_mbs", "b_forward_mbs", "b_backward_mbs", "b_interpolated_mbs", "dbquant",
                 "qpel_mbs", "mpeg_quant_blocks", "four_mv_mbs", "ac_pred_mbs", "video_packets", "dquant"):
        assert asp[tool] > 0, tool
    assert asp["frames"] == asp["packets"] == asp["i_vops"] + asp["p_vops"] + asp["b_vops"] == 14
    assert asp["xvid_idct_blocks"] == 0 and tool_counts("xvid_asp_88x40.avi")["xvid_idct_blocks"] > 0
    bvop = tool_counts("mpeg4_bvop_88x40.avi")
    assert bvop["b_vops"] > 0 and bvop["b_colocated_skips"] > 0 and tool_counts("mpeg4_qpel_88x40.avi")["qpel_mbs"] > 0
    assert tool_counts("mpeg4_mq_88x40.avi")["mpeg_quant_blocks"] > 0
    packed = tool_counts("divx_packed_88x40.avi")
    assert packed["packed_b_vops"] == asp["b_vops"] and packed["frames"] == 14 and packed["not_coded_vops"] == 0
    clip = tool_counts("track_640x480_xvid.avi")
    assert clip["b_vops"] > 0 and clip["qpel_mbs"] > 0 and clip["xvid_idct_blocks"] > 0 and clip["frames"] == 16


def test_encoder_workarounds_change_the_frames():
    """The same ASP stream under Xvid's and DivX's user data decodes to other
    frames than under libavcodec's (the Xvid IDCT and FFmpeg's workarounds
    for those builds), and each to OpenCV's (test_frames_equal_opencv)."""
    lavc = [f["cv2"] for f in DIGESTS["mpeg4_asp_88x40.avi"]["per_frame"]]
    for name in ("xvid_asp_88x40.avi", "divx_asp_88x40.avi"):
        other = [f["cv2"] for f in DIGESTS[name]["per_frame"]]
        assert len(other) == len(lavc) and other != lavc, name
    assert DIGESTS["divx_packed_88x40.avi"]["per_frame"] == DIGESTS["divx_asp_88x40.avi"]["per_frame"]


CLIPS = [("mp4v", ".mp4", (48, 64)), ("mp4v", ".avi", (50, 90)), ("mp4v", ".mkv", (40, 72)),
         ("mp4v", ".mov", (64, 64)), ("MJPG", ".avi", (50, 90)), ("MJPG", ".mkv", (40, 72))]


@pytest.mark.parametrize("fourcc,suffix,hw", CLIPS)
def test_clips_written_here_equal_opencv(tmp_path, fourcc, suffix, hw):
    """Clips written by cv2.VideoWriter at test time, some of a size that is
    not whole macroblocks: packets and frames equal OpenCV's."""
    path = tmp_path / f"clip{suffix}"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10, hw[::-1])
    for f in small_frames(13, hw, seed=len(suffix) + hw[1]):
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    assert video.demux(path).packets == cv2_packets(path)
    ref = cv2_frames(path)
    got = list(video.frames(path))
    assert len(got) == len(ref) == 13
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_mjpeg_without_huffman_tables_takes_annex_k(tmp_path):
    """An AVI whose Motion-JPEG frames carry no DHT segment (as cameras write
    them) decodes with Annex K's tables, as FFmpeg's decoder does: frames
    encoded with those tables by the port's JPEG writer, their DHT segments
    cut out."""
    from quan_ultralytics_tpu_torch.data.native.native import encode_jpeg

    def strip_dht(p: bytes) -> bytes:
        out, pos = bytearray(p[:2]), 2
        while p[pos] == 0xFF and p[pos + 1] != 0xDA:
            size = int.from_bytes(p[pos + 2:pos + 4], "big")
            if p[pos + 1] != 0xC4:
                out += p[pos:pos + 2 + size]
            pos += 2 + size
        return bytes(out + p[pos:])

    packets = [strip_dht(encode_jpeg(f)) for f in small_frames(6)]
    assert all(b"\xff\xc4" not in p[:p.index(b"\xff\xda")] for p in packets)
    path = tmp_path / "nodht.avi"
    write_avi(path, packets, 64, 48, b"MJPG")
    ref = cv2_frames(path)
    got = list(video.frames(path))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", ["mp4v_64x48.mp4", "xvid_64x48.avi", "mjpg_64x48.mkv", "mpeg4_tools_88x40.avi",
                                  "vp8_64x48.webm", "vp8_p1_64x48.avi", "vp8_p3_er_64x48.avi",
                                  "vp8_p0_golden_64x48.avi", "mpeg4_bvop_88x40.avi", "mpeg4_qpel_88x40.avi",
                                  "mpeg4_mq_88x40.avi", "mpeg4_asp_88x40.avi", "xvid_asp_88x40.avi",
                                  "divx_asp_88x40.avi", "divx_packed_88x40.avi", "track_640x480.webm",
                                  "track_640x480_xvid.avi"])
def test_load_source_of_a_video_matches_jax(name):
    got = list(load_source(VIDEOS / name))
    ref = list(jax_load_source(str(VIDEOS / name)))
    assert len(got) == len(ref) == DIGESTS[name]["frames"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_load_source_streams_a_video():
    """load_source decodes a frame when asked for it, so that track never
    holds the clip."""
    gen = load_source(VIDEOS / "track_640x480.mp4")
    first = next(gen)
    assert first.shape == (480, 640, 3)
    gen.close()


def test_missing_unreadable_and_truncated_videos_as_opencv(tmp_path):
    """A missing file, an empty one, one of noise and an MP4 cut before its
    moov (cv2 opens none of them) yield no frames in both packages; an AVI cut
    inside a packet yields the frames of its whole packets, the frames OpenCV
    decodes from them."""
    noise = tmp_path / "noise.mp4"
    noise.write_bytes(np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8).tobytes())
    empty = tmp_path / "empty.avi"
    empty.write_bytes(b"")
    cut_mp4 = tmp_path / "cut.mp4"
    cut_mp4.write_bytes((VIDEOS / "mp4v_64x48.mp4").read_bytes()[:3000])
    for path in (tmp_path / "missing.mp4", tmp_path / "missing.mkv", empty, noise, cut_mp4):
        assert list(load_source(path)) == [] == list(jax_load_source(str(path)))
    data = (VIDEOS / "mp4v_64x48.avi").read_bytes()
    stream = video.demux(VIDEOS / "mp4v_64x48.avi")
    at = data.index(stream.packets[8]) + len(stream.packets[8]) // 2
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:at])
    got, ref = list(load_source(cut)), cv2_frames(cut)
    assert len(got) == 8 and len(ref) >= 8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def riff(kind: bytes, body: bytes, tag: bytes = b"LIST") -> bytes:
    return tag + len(body + kind).to_bytes(4, "little") + kind + body


def avi_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + len(body).to_bytes(4, "little") + body + b"\0" * (len(body) & 1)


def opendml(src: Path, first: int) -> bytes:
    """``src`` (an AVI 1.0 file of one video stream) as an OpenDML file: an
    ``odml`` header list, the first ``first`` packets in the first RIFF's
    ``movi`` with their ``idx1``, the rest in a ``RIFF AVIX`` extension."""
    data = src.read_bytes()
    packets = video.demux(src).packets
    movi_at = data.index(b"movi") - 8
    assert data[movi_at:movi_at + 4] == b"LIST"
    hdrl = data[12:movi_at]  # hdrl and any list before movi
    hdrl += riff(b"odml", avi_chunk(b"dmlh", len(packets).to_bytes(4, "little") + bytes(244)))
    index, at = b"", 4
    for p in packets[:first]:
        index += b"00dc" + bytes.fromhex("10000000") + at.to_bytes(4, "little") + len(p).to_bytes(4, "little")
        at += len(avi_chunk(b"00dc", p))
    movi = riff(b"movi", b"".join(avi_chunk(b"00dc", p) for p in packets[:first]))
    rest = riff(b"movi", b"".join(avi_chunk(b"00dc", p) for p in packets[first:]))
    return (riff(b"AVI ", hdrl + movi + avi_chunk(b"idx1", index), tag=b"RIFF")
            + riff(b"AVIX", rest, tag=b"RIFF"))


@pytest.mark.parametrize("name", ["mjpg_64x48.avi", "mp4v_64x48.avi"])
def test_opendml_avix_extensions_equal_opencv(tmp_path, name):
    """An OpenDML AVI (as recordings over 1 GB are written), its packets
    split between the first RIFF and a RIFF AVIX extension: each packet read
    once, in order, as OpenCV reads them."""
    path = tmp_path / name
    path.write_bytes(opendml(VIDEOS / name, 5))
    packets = video.demux(VIDEOS / name).packets
    assert video.demux(path).packets == cv2_packets(path) == packets
    got, ref = list(video.frames(path)), cv2_frames(path)
    assert len(got) == len(ref) == DIGESTS[name]["frames"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def unknown_sizes(data: bytes) -> bytes:
    """A Matroska file with its Segment's and every Cluster's size rewritten
    to the reserved all-ones value (unknown size, as a streaming muxer
    writes them), each in the size field's own length."""
    out = bytearray(data)

    def length(b: int) -> int:
        return 9 - b.bit_length()

    def walk(pos: int, end: int, top: bool) -> None:
        while pos < end:
            il = length(data[pos])
            ident = int.from_bytes(data[pos:pos + il], "big")
            sl = length(data[pos + il])
            size = int.from_bytes(data[pos + il:pos + il + sl], "big") & ((1 << (7 * sl)) - 1)
            body = pos + il + sl
            if ident == 0x18538067 or (ident == 0x1F43B675 and not top):
                out[pos + il:body] = bytes([(0x100 >> sl) - 1 | (0x100 >> sl)]) + b"\xff" * (sl - 1)
            if ident == 0x18538067:
                walk(body, body + size, False)
            pos = body + size

    walk(0, len(data), True)
    return bytes(out)


@pytest.mark.parametrize("name", ["mp4v_64x48.mkv", "mjpg_64x48.mkv"])
def test_matroska_clusters_of_unknown_size_equal_opencv(tmp_path, name):
    """A Matroska file whose Segment and Clusters have unknown sizes (live or
    piped muxing): each cluster ends where the next top-level element
    starts, so each block is read once, as OpenCV reads them."""
    path = tmp_path / name
    path.write_bytes(unknown_sizes((VIDEOS / name).read_bytes()))
    assert path.read_bytes() != (VIDEOS / name).read_bytes()
    packets = video.demux(VIDEOS / name).packets
    assert video.demux(path).packets == cv2_packets(path) == packets
    got, ref = list(video.frames(path)), cv2_frames(path)
    assert len(got) == len(ref) == DIGESTS[name]["frames"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_damaged_containers_are_unreadable_or_refused(tmp_path):
    """Each container fixture cut short, bit-flipped or overwritten, 60 ways
    each: the demuxer returns packets, or raises `video.Unreadable` (a file
    OpenCV would not open: `frames` yields nothing) or a named
    NotImplementedError, and no other exception."""
    rng = random.Random(1)
    outcomes = {"packets": 0, "Unreadable": 0, "NotImplementedError": 0}
    for name in ("mp4v_64x48.mp4", "mp4v_64x48.mov", "mp4v_64x48.m4v", "mp4v_64x48.avi", "mjpg_64x48.avi",
                 "mp4v_64x48.mkv", "mjpg_64x48.mkv", "vp8_64x48.webm"):
        data = (VIDEOS / name).read_bytes()
        for _ in range(60):
            d = bytearray(data)
            r = rng.random()
            if r < 0.3:
                del d[rng.randrange(len(d)):]
            elif r < 0.7:
                for _ in range(rng.randint(1, 8)):
                    d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
            else:
                for _ in range(rng.randint(1, 3)):
                    at = rng.randrange(len(d) - 4)
                    d[at:at + 4] = rng.randbytes(4)
            path = tmp_path / f"damaged{Path(name).suffix}"
            path.write_bytes(bytes(d))
            try:
                video.demux(path)
                outcomes["packets"] += 1
            except (video.Unreadable, NotImplementedError) as e:
                outcomes[type(e).__name__] += 1
    assert outcomes["packets"] and outcomes["Unreadable"], outcomes


def test_demuxer_faults_reach_the_caller(monkeypatch):
    """Only a file the demuxers call unreadable (or one that cannot be read)
    yields no frames: any other exception in a demuxer reaches the caller of
    `frames` and `load_source`, so that a fault is not taken for an empty
    video."""
    def broken(data, path):
        raise TypeError("a fault in the demuxer")

    monkeypatch.setattr(video, "_demux_mp4", broken)
    with pytest.raises(TypeError, match="a fault in the demuxer"):
        list(video.frames(VIDEOS / "mp4v_64x48.mp4"))
    with pytest.raises(TypeError, match="a fault in the demuxer"):
        list(load_source(VIDEOS / "mp4v_64x48.mp4"))


def test_unsupported_codecs_raise_named_errors(tmp_path):
    """FFV1 (cv2 decodes it), VP9 profile 1, an AVI of a codec the port has
    no decoder for and interlaced MPEG-4 raise NotImplementedError naming the
    codec or tool; the VP8 WebM and a VP9 WebM that cv2 writes, refused
    before those codecs were ported, now give the JAX package's frames."""
    got, ref = list(load_source(VIDEOS / "vp8_64x48.webm")), list(jax_load_source(str(VIDEOS / "vp8_64x48.webm")))
    assert len(got) == len(ref) == 14
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    vp9 = tmp_path / "vp9.webm"
    vw = cv2.VideoWriter(str(vp9), cv2.VideoWriter_fourcc(*"VP90"), 10, (64, 48))
    for f in small_frames(3):
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    got, ref = list(load_source(vp9)), list(jax_load_source(str(vp9)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(NotImplementedError, match=r"the FFV1 codec \(FFV1\) in AVI"):
        list(load_source(VIDEOS / "ffv1_64x48.avi"))
    profile1 = tmp_path / "profile1.avi"
    first = video.demux(vp9).packets[0]
    write_avi(profile1, [bytes([first[0] | 0x20]) + first[1:]], 64, 48, b"VP90")
    with pytest.raises(NotImplementedError, match=r"VP9: profile 1 \(4:2:2, 4:4:0 and 4:4:4 at 8 bits\)"):
        list(load_source(profile1))
    h264 = tmp_path / "h264.avi"
    write_avi(h264, [b"\0\0\0\1\x67"], 64, 48, b"H264")
    with pytest.raises(NotImplementedError, match=r"H\.264 codec \(H264\) in AVI"):
        list(load_source(h264))
    interlaced = tmp_path / "interlaced.avi"  # cv2's swscale refuses to convert these frames: it gives none
    write_avi(interlaced, encode_mpeg4(tools_frames(3), {"g": "12", "flags": "+ildct+ilme"}), 88, 40, b"FMP4")
    with pytest.raises(NotImplementedError, match="MPEG-4 Part 2: interlaced video is not supported"):
        list(load_source(interlaced))


# ---------------------------------------------------------------- hand-made MPEG-4 headers


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "BitWriter":
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def start(self, code: int) -> "BitWriter":
        self.stuff()
        return self.put(0x100 | code, 32)

    def stuff(self) -> "BitWriter":  # 0 then ones to the next byte
        if len(self.bits) % 8 or self.bits:
            self.put(0, 1)
            while len(self.bits) % 8:
                self.put(1, 1)
        return self

    def bytes(self) -> bytes:
        self.stuff()
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2) for i in range(0, len(self.bits), 8))


def vol(ver_id=1, shape=0, interlaced=0, sprite=0, not_8_bit=0, quant_type=0, quarter_sample=0,
        complexity_disable=1, data_partitioned=0, rvlc=0, newpred=0, reduced=0, scalability=0,
        vo_type=1) -> bytes:
    """VOS, VO and a VOL header of a 64 x 48 stream, 1/25 s a tick, the
    fields in ISO/IEC 14496-2's order (6.2.3)."""
    w = BitWriter().put(0x1B0, 32).put(3, 8)  # VOS, simple profile level 3
    w.start(0xB5).put(0, 1).put(1, 4).put(0, 1)  # VO: visual object type video, no signal type
    w.start(0x00)  # video_object_start_code
    w.start(0x20).put(0, 1).put(vo_type, 8)
    if ver_id != 1:
        w.put(1, 1).put(ver_id, 4).put(1, 3)
    else:
        w.put(0, 1)
    w.put(1, 4).put(0, 1).put(shape, 2).put(1, 1).put(25, 16).put(1, 1).put(0, 1)
    w.put(1, 1).put(64, 13).put(1, 1).put(48, 13).put(1, 1)
    w.put(interlaced, 1).put(1, 1).put(sprite, 1 if ver_id == 1 else 2).put(not_8_bit, 1)
    if not_8_bit:
        w.put(5, 4).put(10, 4)
    w.put(quant_type, 1)
    if quant_type:
        w.put(0, 2)  # load_intra_quant_mat, load_nonintra_quant_mat: the default matrices
    if ver_id != 1:
        w.put(quarter_sample, 1)
    w.put(complexity_disable, 1).put(1, 1).put(data_partitioned, 1)
    if data_partitioned:
        w.put(rvlc, 1)
    if ver_id != 1:
        w.put(newpred, 1).put(reduced, 1)
    w.put(scalability, 1)
    return w.bytes()


def vop(kind: int, q: int = 4) -> bytes:
    """A VOP header of type ``kind`` (0 I, 1 P, 2 B, 3 S), coded, with no
    macroblocks after it."""
    w = BitWriter().put(0x1B6, 32).put(kind, 2).put(0, 1).put(1, 1).put(0, 5).put(1, 1).put(1, 1)
    if kind == 1:
        w.put(0, 1)
    w.put(0, 3).put(q, 5)
    if kind != 0:
        w.put(1, 3)
    return w.bytes()


REFUSED = [
    (dict(interlaced=1), "interlaced"),
    (dict(sprite=1), "sprites and global motion compensation"),
    (dict(ver_id=2, sprite=2), "sprites and global motion compensation"),
    (dict(not_8_bit=1), "other than 8-bit"),
    (dict(data_partitioned=1, rvlc=1), "data partitioning with RVLC"),
    (dict(shape=1), "shape other than rectangular"),
    (dict(complexity_disable=0), "complexity estimation"),
    (dict(ver_id=2, newpred=1), "newpred"),
    (dict(ver_id=2, reduced=1), "reduced-resolution"),
    (dict(scalability=1), "scalability"),
    (dict(vo_type=14), "Studio profile"),
]


@pytest.mark.parametrize("fields,match", REFUSED, ids=[m.split()[0].strip("r\\()") for _, m in REFUSED])
def test_refused_mpeg4_vol_tools_raise_named_errors(fields, match):
    """Each tool outside the Simple Profile, set in a hand-made VOL header,
    read from the decoder configuration or in band."""
    header = vol(**fields)
    for dec, packet in ((video.Decoder("mpeg4", header), vop(0)), (video.Decoder("mpeg4"), header + vop(0))):
        with pytest.raises(NotImplementedError, match=f"MPEG-4 Part 2: .*{match}"):
            dec.send(packet)


@pytest.mark.parametrize("kind,match", [(3, "S-VOPs")])
def test_refused_vop_types_raise_named_errors(kind, match):
    dec = video.Decoder("mpeg4", vol())
    with pytest.raises(NotImplementedError, match=match):
        dec.send(vop(kind))


def test_short_video_header_and_encoder_workarounds_are_refused(tmp_path):
    """An H.263 picture (short_video_header) in an MPEG-4 stream is read as
    FFmpeg's MPEG-4 decoder reads it: damaged data, so that an AVI of them
    under an MPEG-4 fourcc gives no frame, as cv2.VideoCapture gives none
    (the same packets under the H263 fourcc give every frame). The streams
    that were refused with it before FFmpeg's encoder workarounds were
    ported (a stream an XVID fourcc marks as Xvid's, DivX and Xvid user
    data, an old libavcodec's) now reach their macroblocks: a VOP with none
    is damaged data, not a refusal."""
    with pytest.raises(ValueError, match="short_video_header"):
        video.Decoder("mpeg4").send(bytes.fromhex("00008202") + bytes(20))
    h263 = video.demux(VIDEOS / "h263_176x144.avi").packets
    write_avi(tmp_path / "short.avi", h263, 176, 144, b"FMP4")
    assert cv2_frames(tmp_path / "short.avi") == [] and list(video.frames(tmp_path / "short.avi")) == []
    assert len(list(video.frames(VIDEOS / "h263_176x144.avi"))) == len(h263)
    with pytest.raises(ValueError, match="MPEG-4 Part 2"):
        video.Decoder("mpeg4", vol(), b"XVID").send(vop(0))
    for user in (b"DivX503b1393p", b"XviD0050", b"Lavc56.1.100", b"FFmpeg0.4.6b4652"):
        with pytest.raises(ValueError, match="MPEG-4 Part 2"):
            video.Decoder("mpeg4", vol() + b"\0\0\1\xb2" + user).send(vop(0))
    # the fixture's stream under the XVID fourcc names libavcodec in its user data: decoded as it
    assert DIGESTS["xvid_64x48.avi"]["per_frame"] == DIGESTS["mp4v_64x48.avi"]["per_frame"]


@pytest.mark.parametrize("fields", [dict(ver_id=2, quarter_sample=1), dict(quant_type=1), dict(data_partitioned=1)],
                         ids=["quarter-pel", "MPEG-quantisation", "data-partitioning"])
def test_asp_vol_tools_are_read(fields):
    """Quarter-pel, MPEG quantisation and data partitioning (without RVLC) in
    a hand-made VOL header are read,
    from the decoder configuration or in band: its VOP reaches the
    macroblocks (none here: damaged data, not a refusal)."""
    header = vol(**fields)
    assert video.Decoder("mpeg4").send(header) is False
    for dec, packet in ((video.Decoder("mpeg4", header), vop(0)), (video.Decoder("mpeg4"), header + vop(0))):
        with pytest.raises(ValueError, match="MPEG-4 Part 2"):
            dec.send(packet)


def with_matrices(packets: list, intra, inter) -> list:
    """``packets`` (libavcodec's, MPEG quantisation, no matrices carried)
    with the VOL rewritten to carry ``intra`` and ``inter`` (lists of up to
    64 values in zigzag order, a 0 ending a short one; None: no matrix)."""
    first = packets[0]
    start = first.index(b"\x00\x00\x01\x20") + 4
    end = first.index(b"\x00\x00\x01", start)
    bits = "".join(f"{b:08b}" for b in first[start:end])
    bits = bits[:bits.rindex("0")]  # the VOL's own fields, without the stuffing to the byte
    pos = 1 + 8
    ver_id = 1
    if bits[pos] == "1":
        ver_id = int(bits[pos + 1:pos + 5], 2)
        pos += 8
    else:
        pos += 1
    pos += 4 + (16 if bits[pos:pos + 4] == "1111" else 0)
    if bits[pos] == "1":  # vol_control_parameters
        pos += 1 + 3
        pos += 1 + (79 if bits[pos] == "1" else 0)
    else:
        pos += 1
    pos += 2 + 1 + 16 + 1
    tib = max(1, (int(bits[pos - 17:pos - 1], 2) - 1).bit_length())
    pos += 1 + (tib if bits[pos] == "1" else 0)
    pos += 1 + 13 + 1 + 13 + 1 + 1 + 1 + (1 if ver_id == 1 else 2)
    assert bits[pos] == "0" and bits[pos + 1] == "1", "not 8-bit video with MPEG quantisation"
    pos += 2
    assert bits[pos:pos + 2] == "00", "the stream already carries matrices"

    def matrix(m):
        return "0" if m is None else "1" + "".join(f"{v:08b}" for v in m)

    bits = bits[:pos] + matrix(intra) + matrix(inter) + bits[pos + 2:]
    bits += "0" + "1" * (7 - len(bits) % 8)
    vol_bytes = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return [first[:start] + vol_bytes + first[end:]] + packets[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantisation_matrices_carried_in_the_vol_equal_opencv(tmp_path, seed):
    """MPEG quantisation with matrices carried in the VOL (seeded random
    values, whole or ended early by a 0 and their last value repeated, or
    left to the defaults): the frames equal OpenCV's. The encoder quantised
    with the default matrices, so these frames drift; both decoders drift
    alike."""
    rng = np.random.default_rng(seed)

    def random_matrix():
        if rng.random() < 0.25:
            return None
        m = rng.integers(8, 64, 64).tolist()
        return m if rng.random() < 0.5 else m[:rng.integers(1, 63)] + [0]

    frames = small_frames(8, (48, 64), seed=seed)
    options = {"g": "12", "mpeg_quant": "1", "bf": str(seed % 3), "flags": "+qpel" if seed % 2 else "+mv4"}
    path = tmp_path / "matrices.avi"
    write_avi(path, with_matrices(encode_mpeg4(frames, options), random_matrix(), random_matrix()), 64, 48, b"FMP4")
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def random_clip(rng, n: int, hw=(48, 64)) -> list:
    """``n`` RGB frames of noise under shapes moving at random speeds."""
    h, w = hw
    base = rng.integers(0, 256, (h + 40, w + 40, 3)).astype(np.uint8)
    dx, dy = rng.integers(-3, 4, 2)
    out = []
    for t in range(n):
        x0, y0 = 20 + int(dx * t) % 20, 20 + int(dy * t) % 20
        im = base[y0:y0 + h, x0:x0 + w].copy()
        for k in range(3):
            vx, vy, size = rng.integers(-4, 5), rng.integers(-4, 5), rng.integers(4, 16)
            x, y = (10 + k * 17 + vx * t) % (w - size), (5 + k * 9 + vy * t) % (h - size)
            im[y:y + size, x:x + size] = rng.integers(0, 256, 3)
        out.append(im)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_seeded_random_vp8_streams_equal_opencv(tmp_path, seed):
    """Random frames through libvpx's VP8 encoder with random options
    (profile, GOP, bitrate, sharpness, error resilience, golden-frame
    boosts): every frame equals OpenCV's."""
    rng = np.random.default_rng(100 + seed)
    options = {"profile": str(rng.integers(0, 4)), "g": str(rng.integers(3, 20)),
               "b": f"{rng.integers(20, 800)}k", "sharpness": str(rng.integers(0, 8))}
    if rng.random() < 0.5:
        options["error-resilient"] = "default"
    if rng.random() < 0.5:
        options.update({"auto-alt-ref": "1", "lag-in-frames": "6"})
    n = int(rng.integers(6, 16))
    path = tmp_path / "vp8.avi"
    write_avi(path, encode_vp8(random_clip(rng, n), options), 64, 48, b"VP80")
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == n, options
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r, err_msg=str(options))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_random_mpeg4_streams_equal_opencv(tmp_path, seed):
    """Random frames through libavcodec's MPEG-4 encoder with random
    Advanced Simple Profile options (B-VOPs, quarter-pel, four vectors, AC
    prediction, MPEG quantisation, resync markers, adaptive quantisation)
    and random encoder user data and fourcc (libavcodec's, Xvid builds,
    DivX builds, DivX's packed B-VOPs): as many frames as OpenCV gives, each
    equal to OpenCV's."""
    rng = np.random.default_rng(200 + seed)
    flags = "".join(f for f in ("+qpel", "+mv4", "+aic") if rng.random() < 0.5)
    options = {"g": str(rng.integers(4, 16)), "bf": str(rng.integers(0, 3)), "b": f"{rng.integers(50, 900)}k"}
    if flags:
        options["flags"] = flags
    if rng.random() < 0.5:
        options["mpeg_quant"] = "1"
    if rng.random() < 0.3:
        options["ps"] = str(rng.integers(40, 200))
    if rng.random() < 0.3:
        options.update({"lumi_mask": "0.5", "dark_mask": "0.5"})
    n = int(rng.integers(6, 14))
    packets = encode_mpeg4(random_clip(rng, n), options)
    user, fourcc = [(None, b"FMP4"), (b"XviD0001", b"XVID"), (b"XviD0012", b"XVID"), (b"XviD0064", b"XVID"),
                    (b"DivX503b1393", b"DX50"), (b"DivX501b413", b"DIVX"), (b"DivX503b1393p", b"DX50"),
                    (b"FFmpeg0.4.6b4652", b"FMP4")][seed]
    if user:
        packets = set_user_data(packets, user)
    if user == b"DivX503b1393p":
        packets = pack_b_frames(packets)
    path = tmp_path / "asp.avi"
    write_avi(path, packets, 64, 48, fourcc)
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) > 0, (options, user)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r, err_msg=str((options, user)))


def test_vop_that_is_not_coded_at_the_end_repeats_the_last_frame(tmp_path):
    """A stream that ends with a VOP that is not coded gives its last frame
    once more (FFmpeg's flush), one in the middle of a stream with B-VOPs
    makes FFmpeg skip the B-VOPs whose times then fall out of order: the
    same frames as OpenCV in both."""
    frames = tools_frames(10)
    sp, bf = encode_mpeg4(frames, {"g": "12"}), encode_mpeg4(frames, {"g": "12", "bf": "2"})
    for name, packets, count in (("end", sp + [NOT_CODED_VOP], 11), ("middle", bf[:4] + [NOT_CODED_VOP] + bf[4:], 0)):
        path = tmp_path / f"{name}.avi"
        write_avi(path, packets, 88, 40, b"FMP4")
        ref, got = cv2_frames(path), list(video.frames(path))
        assert len(got) == len(ref) and (count == 0 or len(ref) == count), name
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_invisible_vp8_frames_and_size_changes(tmp_path):
    """A VP8 frame with show_frame 0 updates the references and gives no
    frame, as FFmpeg's vp8.c; a key frame that changes the size is decoded,
    and its frame refused by name (OpenCV scales it to the first size with
    libswscale's scaled path)."""
    packets = encode_vp8(small_frames(12, (48, 64), seed=9), {"g": "12"})
    hidden = list(packets)
    hidden[5] = bytes([hidden[5][0] & ~0x10]) + hidden[5][1:]
    path = tmp_path / "hidden.avi"
    write_avi(path, hidden, 64, 48, b"VP80")
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == 11
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    bigger = encode_vp8(small_frames(3, (80, 96), seed=9), {"g": "12"})
    path = tmp_path / "resized.avi"
    write_avi(path, packets[:4] + bigger, 64, 48, b"VP80")
    assert {f.shape for f in cv2_frames(path)} == {(48, 64, 3)}
    gen = video.frames(path)
    assert [next(gen).shape for _ in range(4)] == [(48, 64, 3)] * 4
    with pytest.raises(NotImplementedError, match="a 96x80 frame after 64x48 ones"):
        next(gen)


FUZZ = """
import random, sys
from quan_ultralytics_tpu_torch.data.native import video
rng = random.Random(int(sys.argv[1]))
names = sys.argv[2:]
done = 0
for name in names:
    stream = video.demux(name)
    for trial in range(40):
        packets = [bytearray(p) for p in stream.packets]
        for _ in range(rng.randint(1, 6)):
            p = packets[rng.randrange(len(packets))]
            if not p:
                continue
            if rng.random() < 0.3:
                del p[rng.randrange(len(p)):]
            else:
                for _ in range(rng.randint(1, 8)):
                    p[rng.randrange(len(p))] ^= 1 << rng.randrange(8)
        dec = video.Decoder(stream.codec, stream.private, stream.tag, stream.size)
        for p in packets:
            try:
                if dec.send(bytes(p)):
                    assert dec.rgb().shape[2] == 3
                    while dec.next():  # the other frames a VP9 packet shows
                        assert dec.rgb().shape[2] == 3
            except (ValueError, NotImplementedError):
                break
        else:
            try:
                if dec.flush():
                    assert dec.rgb().shape[2] == 3
            except NotImplementedError:
                pass
        done += 1
print(done)
"""


def test_damaged_packets_end_or_raise_never_crash():
    """Truncated and bit-flipped packets of every codec and container, 40
    damaged streams a fixture, decoded in a child process: each packet
    decodes or raises ValueError/NotImplementedError, and the process exits
    normally."""
    names = [str(VIDEOS / n) for n in ("mp4v_64x48.mp4", "mjpg_64x48.avi", "mpeg4_tools_88x40.avi",
                                         "mp4v_64x48.mkv", "vp8_64x48.webm", "vp8_p3_er_64x48.avi",
                                         "mpeg4_asp_88x40.avi", "divx_packed_88x40.avi", "vp9_tiles_512x64.mkv",
                                         "vp9_crafted_64x48.mkv", "vp9_aq_96x64.mp4", "h263_176x144.avi",
                                         "u263_88x40.avi", "flv1_tools_88x40.avi", "mp42_tools_88x40.avi",
                                         "div3_tools_88x40.avi", "mpeg4_dp_88x40.avi", "wmv1_mbrl_88x40.avi",
                                         "wmv2_crafted_88x40.avi", "u263_loop_88x40.avi")]
    proc = subprocess.run([sys.executable, "-c", FUZZ, str(random.Random(0).randrange(1 << 30)), *names],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(40 * len(names))]


# ---------------------------------------------------------------- yolo track of a video


@pytest.fixture(scope="module")
def detect_ckpt(tmp_path_factory):
    """A yolo11n-quan (nc=3) checkpoint written by the JAX facade's own
    ``_save_ckpt`` from seeded variables."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO

    jy = JaxYOLO("yolo11n-quan.yaml", nc=3)
    v = jax_variables(jy.model.module, jnp.zeros((1, 64, 64, 3)), train=False, seed=5)
    jy.names = ["a", "b", "c"]
    pkl = tmp_path_factory.mktemp("detect_ckpt") / "detect.pkl"
    jy._save_ckpt(pkl, SimpleNamespace(ema_params=v["params"], batch_stats=v["batch_stats"],
                                       params=v["params"], step=jnp.int32(1)))
    return pkl


def test_track_of_a_video_prints_what_the_jax_cli_prints(detect_ckpt, capsys):
    """``detect track source=<fixture>.mp4 imgsz=64``: the port's CLI (on the
    CPU) and the JAX CLI print the same line for each of the clip's frames."""
    argv = ["detect", "track", f"model={detect_ckpt}", f"source={VIDEOS / 'mp4v_64x48.mp4'}", "imgsz=64"]
    assert tcli.main(argv + ["device=cpu"]) == 0
    got = [line for line in capsys.readouterr().out.splitlines() if line.startswith("frame ")]
    assert jcli.main(list(argv)) == 0
    ref = [line for line in capsys.readouterr().out.splitlines() if line.startswith("frame ")]
    assert got == ref and len(got) == 14


def test_odd_frame_sizes_are_refused_by_name():
    """A frame of odd width or height leaves libswscale's unscaled YUV->RGB
    path (the one reproduced): a Motion-JPEG frame of 63 x 47, written by the
    port's JPEG encoder, decodes but is refused when converted."""
    from quan_ultralytics_tpu_torch.data.native.native import encode_jpeg

    dec = video.Decoder("mjpeg")
    assert dec.send(encode_jpeg(small_frames(1)[0][:47, :63]))
    assert dec.size() == (47, 63)
    with pytest.raises(NotImplementedError, match="63x47 frame: odd frame sizes"):
        dec.rgb()


@pytest.mark.parametrize("subsampling,quality", [(1, 50), (1, 90), (2, 75), (0, 90)])
def test_mjpeg_sampling_from_pil(tmp_path, subsampling, quality):
    """Motion-JPEG frames written by PIL: 4:2:2 (libswscale's 422P path) and
    4:2:0 equal OpenCV's frames; 4:4:4 (swscale's scaled path) raises a
    NotImplementedError naming its sampling."""
    import io

    from PIL import Image

    packets = []
    for f in small_frames(4):
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, "JPEG", quality=quality, subsampling=subsampling)
        packets.append(buf.getvalue())
    path = tmp_path / "pil.avi"
    write_avi(path, packets, 64, 48, b"MJPG")
    ref = cv2_frames(path)
    assert len(ref) == 4
    if subsampling == 0:
        with pytest.raises(NotImplementedError, match="sampled 1x1,1x1,1x1"):
            list(video.frames(path))
        return
    got = list(video.frames(path))
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
