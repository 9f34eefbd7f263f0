"""VP9 profile 0 in the port's video reader (``data/native/vp9.h`` through
``video.cpp`` and ``video.py``) on the CPU against OpenCV 5.0's FFmpeg
capture and the JAX package's ``load_source``.

* Every committed VP9 fixture (cv2's ``VP90``/``vp09`` clips in WebM,
  Matroska, AVI and MP4, and libvpx-vp9 streams with two tile columns and
  rows and backward adaptation, lossless frames, segmentation at full range,
  and superframes, hidden, intra-only and show_existing frames repacked from
  an error-resilient stream, and the encoder's two passes with alternate
  references and compound prediction) equals ``cv2.VideoCapture`` +
  ``cvtColor(BGR2RGB)`` frame for frame, tolerance 0, and its digests in
  ``video_fixtures.json``.
* Seeded random streams from libvpx's VP9 encoder (the one libavcodec wraps,
  through ctypes) with random options and sizes, muxed into AVI, Matroska
  and MP4 in turn, and in its two passes (alternate references: hidden
  frames in superframes, compound prediction); superframes,
  show_existing_frame, hidden and intra-only frames built from the
  encoder's frames; references of another size, profiles 1-3 and
  damaged packets refused or ended by name.
* The decoder's tool counts: the fixtures reach every one (each transform
  size and type, each intra mode and interpolation filter, the bilinear one
  by frames rewritten to name it, compound prediction, tiles, segmentation,
  lossless, adaptation, intra-only frames, superframes,
  show_existing_frame).
* ``vp9_tables.h`` holds the bytes of the libavcodec that OpenCV's wheel
  bundles.
"""

import json
import re
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from quan_ultralytics_tpu.data.loaders import load_source as jax_load_source
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.data.native import video
from torch_port_helpers import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
VIDEOS = FIXTURES / "video"
DIGESTS = json.loads((FIXTURES / "video_fixtures.json").read_text())
VP9_FIXTURES = sorted(k for k, v in DIGESTS.items() if v.get("codec") == "vp9")
sys.path.insert(0, str(FIXTURES))
from make_video_fixtures import (cv2_frames, encode_vp9, encode_vp9_two_pass, hide_frame,  # noqa: E402
                                 bilinear_frame, intra_only_frame, resized_inter_frame,
                                 sha, show_existing, small_frames, superframe, vp9_crafted, vp9_header, write_avi,
                                 write_mkv, write_mp4)


def test_vp9_fixtures_cover_the_containers():
    kinds = {DIGESTS[k]["container"] for k in VP9_FIXTURES}
    assert kinds == {"Matroska", "AVI", "ISO-BMFF"}
    assert {"vp9_64x48.webm", "vp9_64x48.mkv", "vp9_64x48.avi", "vp9_64x48.mp4", "vp9_tiles_512x64.mkv",
            "vp9_lossless_64x48.avi", "vp9_aq_96x64.mp4", "vp9_crafted_64x48.mkv", "vp9_arf_96x64.webm",
            "vp9_bilinear_96x64.mkv", "track_640x480_vp9.webm"} == set(VP9_FIXTURES)


@pytest.mark.parametrize("name", VP9_FIXTURES)
def test_vp9_fixtures_equal_opencv(name):
    ref, got = cv2_frames(VIDEOS / name), list(video.frames(VIDEOS / name))
    per_frame = DIGESTS[name]["per_frame"]
    assert len(got) == len(ref) == len(per_frame) == DIGESTS[name]["frames"]
    for g, r, d in zip(got, ref, per_frame):
        np.testing.assert_array_equal(g, r)
        assert sha(g) == d["port"] == d["cv2"]


def tool_counts(packets) -> dict:
    dec = video.Decoder(video.VP9)
    for p in packets:
        if dec.send(p):
            while dec.next():
                pass
    return dec._tool_counts()


def test_fixtures_reach_the_vp9_tools():
    """What the committed fixtures make the decoder do: every tool it
    counts (each transform size and type, intra mode and interpolation
    filter, compound prediction, sub-8x8 blocks, tiles, segmentation,
    lossless, adaptation, hidden, intra-only and show_existing frames,
    superframes, the previous frame's MVs, error resilience, full range)."""
    total = {}
    for name in VP9_FIXTURES:
        for k, v in tool_counts(video.demux(VIDEOS / name).packets).items():
            total[k] = total.get(k, 0) + v
    assert set(total) == set(video._VP9_TOOL_COUNTS)
    assert all(total.values()), {k: v for k, v in total.items() if not v}


def random_frames(rng, n: int, hw) -> list:
    """``n`` RGB frames: smooth noise panned a few pixels a frame under
    rectangles moving at random speeds."""
    h, w = hw
    coarse = rng.integers(0, 256, (h // 8 + 10, w // 8 + 10, 3)).astype(np.uint8)
    bg = cv2.resize(coarse, (coarse.shape[1] * 8, coarse.shape[0] * 8), interpolation=cv2.INTER_LINEAR)
    bg = np.clip(bg.astype(int) + rng.integers(-6, 7, bg.shape), 0, 255).astype(np.uint8)
    dx, dy = rng.integers(-2, 3, 2)
    out = []
    for t in range(n):
        x0, y0 = 32 + dx * t, 32 + dy * t
        im = bg[y0:y0 + h, x0:x0 + w].copy()
        for k in range(3):
            vx, vy, size = rng.integers(-5, 6), rng.integers(-5, 6), rng.integers(6, 20)
            x, y = (11 + k * 23 + vx * t) % (w - size), (5 + k * 9 + vy * t) % (h - size)
            im[y:y + size, x:x + size] = rng.integers(0, 256, 3)
        out.append(im)
    return out


# sizes (h, w): widths and heights that are not whole 8x8 blocks, two that hold two tile columns
SIZES = [(48, 70), (64, 96), (56, 130), (72, 516), (40, 258), (66, 90), (64, 520), (50, 142)]


@pytest.mark.parametrize("seed", range(8))
def test_seeded_random_vp9_streams_equal_opencv(tmp_path, seed):
    """Random frames through libvpx's VP9 encoder with random options (GOP,
    bitrate or constant quality, lossless, error resilience, frame-parallel
    mode, tiles, adaptive quantisation, sharpness, the realtime deadline,
    colour range), muxed into AVI, Matroska or MP4 in turn: every frame
    equals OpenCV's."""
    rng = np.random.default_rng(900 + seed)
    hw = SIZES[seed]
    options = {"g": str(rng.integers(4, 13))}
    if rng.random() < 0.15:
        options["lossless"] = "1"
    elif rng.random() < 0.5:
        options["b"] = f"{rng.integers(40, 400)}k"
    else:
        options.update(crf=str(rng.integers(4, 60)), b="0")
    for key, p in (("error-resilient", 0.25), ("frame-parallel", 0.5)):
        if rng.random() < p:
            options[key] = str(int(key == "error-resilient" or rng.random() < 0.5))
    if hw[1] >= 512:
        options.update({"tile-columns": "1", "tile-rows": str(rng.integers(0, 3))})
    options["aq-mode"] = str(rng.integers(0, 4))
    options["sharpness"] = str(rng.integers(0, 8))
    if rng.random() < 0.3:
        options.update(deadline="realtime", **{"cpu-used": str(rng.integers(5, 9))})
    options["color_range"] = ["tv", "pc"][int(rng.integers(0, 2))]
    n = int(rng.integers(8, 14))
    packets = encode_vp9(random_frames(rng, n, hw), options)
    path = tmp_path / ("vp9" + [".avi", ".mkv", ".mp4"][seed % 3])
    if seed % 3 == 0:
        write_avi(path, packets, hw[1], hw[0], b"VP90")
    elif seed % 3 == 1:
        write_mkv(path, packets, hw[1], hw[0])
    else:
        write_mp4(path, packets, hw[1], hw[0])
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == n, options
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r, err_msg=str(options))


@pytest.mark.parametrize("seed", range(3))
def test_two_pass_vp9_streams_equal_opencv(tmp_path, seed):
    """libvpx's two passes with alternate references (hidden frames packed
    into superframes, compound prediction from them) at random quality, GOP,
    lag and speed, as WebM: every frame and the count equal OpenCV's."""
    rng = np.random.default_rng(950 + seed)
    hw = [(64, 96), (72, 130), (48, 64)][seed]
    options = {"crf": str(rng.integers(10, 40)), "b": "0", "auto-alt-ref": "1", "g": str(rng.integers(16, 40)),
               "lag-in-frames": str(rng.integers(8, 26)), "cpu-used": str(rng.integers(0, 3))}
    n = int(rng.integers(14, 22))
    packets = encode_vp9_two_pass(small_frames(n, hw, seed=20 + seed), options)
    path = tmp_path / "arf.webm"
    write_mkv(path, packets, hw[1], hw[0])
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == n, options
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r, err_msg=str(options))


@pytest.mark.parametrize("options", [{"b": "200k", "cpu-used": "4"},
                                     {"deadline": "realtime", "cpu-used": "8", "b": "100k"}])
def test_bilinear_frames_equal_opencv(tmp_path, options):
    """Frames coded with one interpolation filter for the frame, rewritten
    to name the bilinear filter (`bilinear_frame`; libvpx's encoder never
    picks it), and the frames that predict from them: every frame equals
    OpenCV's."""
    size = (130, 72)
    packets = encode_vp9(small_frames(16, (size[1], size[0]), seed=6), {"g": "12", **options})
    fixed = [i for i, p in enumerate(packets) if "filter_at" in vp9_header(p, size)]
    assert fixed
    path = tmp_path / "bilinear.mkv"
    write_mkv(path, [bilinear_frame(p, size) if i in fixed else p for i, p in enumerate(packets)], *size)
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == 16
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_superframes_hidden_and_show_existing_frames_equal_opencv(tmp_path):
    """An error-resilient stream repacked as `vp9_crafted` does it (two shown
    frames in one superframe, a hidden frame shown again by
    show_existing_frame in the same packet, a key frame made a hidden
    intra-only frame that a one-byte packet then shows): cv2's frame count
    and frames, which are the stream's own frames in their order."""
    size = (90, 64)
    packets = encode_vp9(small_frames(16, (size[1], size[0]), seed=4),
                         {"g": "12", "crf": "28", "b": "0", "error-resilient": "1"})
    plain, crafted = tmp_path / "plain.mkv", tmp_path / "crafted.mkv"
    write_mkv(plain, packets, *size)
    repacked = vp9_crafted(packets, size)
    assert len(repacked) == len(packets)
    write_mkv(crafted, repacked, *size)
    ref, got = cv2_frames(crafted), list(video.frames(crafted))
    assert len(got) == len(ref) == 16
    for g, r, p in zip(got, ref, video.frames(plain)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, p)
    counts = tool_counts(repacked)
    assert (counts["superframes"], counts["hidden_frames"], counts["intra_only_frames"],
            counts["show_existing"]) == (2, 2, 1, 2)


def test_repeated_frames_and_hidden_frames_of_an_adaptive_stream_equal_opencv(tmp_path):
    """show_existing_frame after a frame shows it twice; a hidden frame and an
    intra-only frame in a stream that adapts its probabilities and predicts
    from the previous frame's motion vectors change what the next frames
    decode to, as in FFmpeg: every frame and the count equal OpenCV's."""
    size = (64, 48)
    packets = encode_vp9(small_frames(16, (size[1], size[0]), seed=8),
                         {"g": "12", "crf": "30", "b": "0", "frame-parallel": "0"})
    refresh = vp9_header(packets[3], size)["refresh"]
    slot = (refresh & -refresh).bit_length() - 1
    stream = (packets[:3] + [packets[3], show_existing(slot), superframe([hide_frame(packets[4], size), packets[5]])]
              + packets[6:12] + [superframe([intra_only_frame(packets[12], 0x01), show_existing(0)])] + packets[13:])
    path = tmp_path / "adaptive.avi"
    write_avi(path, stream, *size, b"VP90")
    ref, got = cv2_frames(path), list(video.frames(path))
    assert len(got) == len(ref) == 16
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", ["vp9_64x48.mp4", "vp9_aq_96x64.mp4", "vp9_crafted_64x48.mkv"])
def test_load_source_of_vp9_matches_jax(name):
    got = list(load_source(VIDEOS / name))
    ref = list(jax_load_source(str(VIDEOS / name)))
    assert len(got) == len(ref) == DIGESTS[name]["frames"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_scaled_references_profiles_and_size_changes_are_refused(tmp_path):
    """An inter frame whose size differs from its references' (scaled motion
    compensation), a frame of profile 1 and an MP4 whose vpcC names profile 1
    raise NotImplementedError naming them; a key frame of another size mid
    stream decodes and is refused when converted, as OpenCV scales it."""
    size = (128, 96)
    packets = encode_vp9(small_frames(4, (size[1], size[0]), seed=2), {"g": "12", "crf": "30", "b": "0"})
    scaled = tmp_path / "scaled.mkv"
    write_mkv(scaled, [packets[0], resized_inter_frame(packets[1], size, (96, 80))] + packets[2:], *size)
    with pytest.raises(NotImplementedError, match="96x80 frame: scaled motion compensation"):
        list(video.frames(scaled))
    profile1 = tmp_path / "profile1.mkv"
    write_mkv(profile1, [bytes([packets[0][0] | 0x20]) + packets[0][1:]] + packets[1:], *size)
    with pytest.raises(NotImplementedError, match=r"VP9: profile 1 \(4:2:2, 4:4:0 and 4:4:4 at 8 bits\)"):
        list(video.frames(profile1))
    vpcc = tmp_path / "profile1.mp4"
    write_mp4(vpcc, packets, *size, profile=1)
    with pytest.raises(NotImplementedError, match=r"VP9 profile 1 at 8 bits \(vpcC\) in ISO-BMFF"):
        list(video.frames(vpcc))
    other = encode_vp9(small_frames(2, (48, 64), seed=2), {"g": "12", "crf": "30", "b": "0"})
    resized = tmp_path / "resized.mkv"
    write_mkv(resized, packets + other, *size)
    with pytest.raises(NotImplementedError, match="a 64x48 frame after 128x96 ones"):
        list(video.frames(resized))


def test_damaged_vp9_packets_raise_or_end():
    """A superframe index whose sizes overrun the packet, a frame marker
    other than 2, a tile size past the frame and a packet cut short raise
    ValueError naming the fault; `frames` ends the stream there."""
    packets = video.demux(VIDEOS / "vp9_tiles_512x64.mkv").packets
    hd = vp9_header(packets[1], (512, 64))
    tiles = (hd["end"] + 7) // 8 + hd["compressed"]  # the first tile's size prefix
    cases = {"superframe index": packets[1] + bytes([0xC9, 0xFF, 0xFF, 0xFF, 0xFF, 0xC9]),
             "frame marker": bytes([packets[1][0] & 0x3F]) + packets[1][1:],
             "tile size": packets[1][:tiles] + b"\xff\xff\xff\xff" + packets[1][tiles + 4:],
             "frame header cut short": packets[0][:8]}
    for what, bad in cases.items():
        dec = video.Decoder(video.VP9)
        if what != "frame header cut short":
            assert dec.send(packets[0])
        with pytest.raises(ValueError, match=what):
            dec.send(bad)


def test_vp9_tables_equal_libavcodec_bytes():
    """Each array of vp9_tables.h is a run of bytes of the libavcodec that
    OpenCV's wheel bundles (vp9data.c's tables, the scans with their
    neighbour tables, the quantiser and filter tables)."""
    lib = sorted((Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs").glob("libavcodec-*.so*"))[0]
    blob = lib.read_bytes()
    text = (REPO / "quan_ultralytics_tpu_torch" / "data" / "native" / "vp9_tables.h").read_text()
    arrays = re.findall(r"const (u?int\d+)_t (\w+)((?:\[\d+\])+) = \{([^}]*)\};", text)
    assert len(arrays) == 29
    for ctype, name, dims, body in arrays:
        values = [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]
        assert len(values) == int(np.prod([int(d) for d in re.findall(r"\d+", dims)])), name
        assert np.array(values, {"uint8": np.uint8, "int16": np.int16}[ctype]).tobytes() in blob, name
