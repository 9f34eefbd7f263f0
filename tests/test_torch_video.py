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
"""

import json
import random
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
DECODED = sorted(k for k, v in DIGESTS.items() if "per_frame" in v)
sys.path.insert(0, str(FIXTURES))
from make_video_fixtures import cv2_frames, sha, small_frames, write_avi  # noqa: E402


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
    """Every container of the demuxers and both codecs are among the
    fixtures, the VP8 WebM the one refused, all under 1.5 MB together."""
    kinds = {(v.get("container"), v.get("codec")) for v in DIGESTS.values()}
    for kind in [("ISO-BMFF", "mpeg4"), ("AVI", "mpeg4"), ("Matroska", "mpeg4"), ("AVI", "mjpeg"),
                 ("Matroska", "mjpeg")]:
        assert kind in kinds
    assert {p.suffix for p in VIDEOS.iterdir()} == {".mp4", ".mov", ".m4v", ".avi", ".mkv", ".webm"}
    assert [k for k, v in DIGESTS.items() if "refused" in v] == ["vp8_64x48.webm"]
    assert sum(p.stat().st_size for p in VIDEOS.iterdir()) < 1_500_000


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_packets_equal_ffmpeg_demuxers(name):
    path = VIDEOS / name
    ref = cv2_packets(path)
    assert len(ref) >= DIGESTS[name]["frames"] > 0
    if "refused" in DIGESTS[name]:
        with pytest.raises(NotImplementedError, match=r"VP8 codec \(V_VP8\) in Matroska"):
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


@pytest.mark.parametrize("name", ["mp4v_64x48.mp4", "xvid_64x48.avi", "mjpg_64x48.mkv", "mpeg4_tools_88x40.avi"])
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
    """VP8 and VP9 WebM (cv2 decodes both) and an AVI of a codec the port
    has no decoder for raise NotImplementedError naming the codec; the JAX
    package reads the VP8 file."""
    with pytest.raises(NotImplementedError, match="VP8"):
        list(load_source(VIDEOS / "vp8_64x48.webm"))
    assert len(list(jax_load_source(str(VIDEOS / "vp8_64x48.webm")))) == 14
    vp9 = tmp_path / "vp9.webm"
    vw = cv2.VideoWriter(str(vp9), cv2.VideoWriter_fourcc(*"VP90"), 10, (64, 48))
    for f in small_frames(3):
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    if cv2_packets(vp9):
        with pytest.raises(NotImplementedError, match="VP9"):
            list(load_source(vp9))
    h264 = tmp_path / "h264.avi"
    write_avi(h264, [b"\0\0\0\1\x67"], 64, 48, b"H264")
    with pytest.raises(NotImplementedError, match=r"H\.264 codec \(H264\) in AVI"):
        list(load_source(h264))


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
    (dict(ver_id=2, quarter_sample=1), "quarter-pel"),
    (dict(sprite=1), "sprites and global motion compensation"),
    (dict(ver_id=2, sprite=2), "sprites and global motion compensation"),
    (dict(not_8_bit=1), "other than 8-bit"),
    (dict(quant_type=1), r"MPEG quantisation matrices \(quant_type 1\)"),
    (dict(data_partitioned=1), "data partitioning"),
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


@pytest.mark.parametrize("kind,match", [(2, r"B-VOPs \(Advanced Simple Profile\)"), (3, "S-VOPs")])
def test_refused_vop_types_raise_named_errors(kind, match):
    dec = video.Decoder("mpeg4", vol())
    with pytest.raises(NotImplementedError, match=match):
        dec.send(vop(kind))


def test_short_video_header_and_encoder_workarounds_are_refused():
    """An H.263 picture (short_video_header) in an MPEG-4 stream, a stream
    an XVID fourcc marks as Xvid's (FFmpeg decodes it with the Xvid IDCT),
    DivX and Xvid user data, and an old libavcodec's."""
    with pytest.raises(NotImplementedError, match="short_video_header"):
        video.Decoder("mpeg4").send(bytes.fromhex("00008202") + bytes(20))
    with pytest.raises(NotImplementedError, match="Xvid"):
        video.Decoder("mpeg4", vol(), b"XVID").send(vop(0))
    for user, match in ((b"DivX503b1393p", "DivX"), (b"XviD0050", "Xvid"), (b"Lavc56.1.100", "old libavcodec")):
        with pytest.raises(NotImplementedError, match=match):
            video.Decoder("mpeg4", vol() + b"\0\0\1\xb2" + user).send(vop(0))
    # the fixture's stream under the XVID fourcc names libavcodec in its user data: decoded
    assert DIGESTS["xvid_64x48.avi"]["per_frame"] == DIGESTS["mp4v_64x48.avi"]["per_frame"]


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
        dec = video.Decoder(stream.codec, stream.private, stream.tag)
        for p in packets:
            try:
                if dec.send(bytes(p)):
                    assert dec.rgb().shape[2] == 3
            except (ValueError, NotImplementedError):
                break
        done += 1
print(done)
"""


def test_damaged_packets_end_or_raise_never_crash():
    """Truncated and bit-flipped packets of every codec and container, 40
    damaged streams a fixture, decoded in a child process: each packet
    decodes or raises ValueError/NotImplementedError, and the process exits
    normally."""
    names = [str(VIDEOS / n) for n in ("mp4v_64x48.mp4", "mjpg_64x48.avi", "mpeg4_tools_88x40.avi",
                                         "mp4v_64x48.mkv")]
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
