"""Write the video fixtures and the digests of the frames OpenCV decodes from them.

    python tests/fixtures/make_video_fixtures.py

Needs OpenCV 5.0 built with FFmpeg (avcodec 62), as the ``opencv-python``
wheel ships it; writes ``tests/fixtures/video/`` and
``tests/fixtures/video_fixtures.json``.

* ``{mp4v,xvid,mjpg,vp8}_64x48.*``: 14 frames of 64 x 48 (a panned
  gradient under moving rectangles, black and white among them), written by
  ``cv2.VideoWriter``, so that each MPEG-4 stream crosses the encoder's GOP of
  12 into a second I-VOP: ``mp4v`` into ``.mp4``, ``.mov``, ``.m4v``, ``.avi``
  and ``.mkv``, the same encoder under the ``XVID`` fourcc into ``.avi``,
  ``MJPG`` into ``.avi`` and ``.mkv``, VP8 into ``.webm``; ``vp9_64x48.*``
  the first 4 frames as VP9 (cv2's ``VP90`` into ``.webm``, ``.mkv`` and
  ``.avi``, ``vp09`` into ``.mp4``), and ``ffv1_64x48.avi`` as FFV1 (a
  codec the port refuses by name).
* ``vp9_{tiles_512x64.mkv,lossless_64x48.avi,aq_96x64.mp4}``: libvpx's VP9
  encoder as libavcodec wraps it (``libvpx-vp9``, through ctypes as below):
  two tile columns and two tile rows with backward adaptation
  (``frame-parallel=0``), lossless (the WHT), and cyclic-refresh segmentation
  (``aq-mode=3`` at the realtime deadline) at full range, put into Matroska,
  AVI and MP4 by the writers below; ``vp9_arf_96x64.webm`` the encoder's
  two passes (`encode_vp9_two_pass`: hidden alternate references in
  superframes, compound prediction); ``vp9_bilinear_96x64.mkv`` a stream
  whose frames coded with one filter name the bilinear one instead
  (`bilinear_frame`: libvpx's encoder never picks it); ``vp9_crafted_64x48.mkv`` an
  error-resilient stream repacked as no encoder writes it: two shown frames
  in one superframe, a frame made hidden and then shown again by a
  one-byte ``show_existing_frame``, and a key frame rewritten as a hidden
  intra-only frame that the next packet shows (`vp9_crafted`).
* ``vp8_{p1,p3_er,p0_golden}_64x48.avi``: 30 frames of 64 x 48 encoded by the
  libvpx VP8 encoder that libavcodec wraps (``libvpx``), through ctypes as
  below, at a GOP of 12: profile 1 (bilinear prediction), profile 3 with the
  error-resilient mode (bilinear, full-pixel chroma), and profile 0 at a low
  bitrate with golden-frame boosts (``auto-alt-ref``, ``arnr-maxframes``).
* ``mpeg4_{bvop,qpel,mq,asp}_88x40.avi``: the tools frames through
  libavcodec's MPEG-4 encoder with Advanced Simple Profile tools: B-VOPs
  (``bf=2``), quarter-pel with four vectors (``+qpel+mv4``), MPEG
  quantisation (``mpeg_quant=1``) and all of them with AC prediction,
  resync markers and adaptive quantisation (DQUANT and DBQUANT).
* ``{xvid,divx}_asp_88x40.avi`` and ``divx_packed_88x40.avi``: the ASP
  stream with libavcodec's user data replaced by Xvid's (``XviD0001``: the
  Xvid IDCT and FFmpeg's workarounds for that build) or DivX's
  (``DivX503b1393``: its chroma workaround for quarter-pel), and the DivX
  stream packed as DivX 5 writes B-VOPs into AVI (a P-VOP and the B-VOP after
  it in one chunk, an N-VOP placeholder after the last B-VOP;
  ``DivX503b1393p``).
* ``track_640x480.{mp4,avi,webm}``: the 16-frame 640 x 480 clip of
  ``chip_smoke.make_clip`` as ``mp4v`` MP4, ``MJPG`` AVI and ``VP80`` WebM,
  ``track_640x480_vp9.webm`` as cv2's ``VP90`` WebM (chip_smoke.py puts its
  packets into MP4 with `write_mp4`: this module imports OpenCV only where it
  calls it);
  ``track_640x480_xvid.avi``: the same frames through libavcodec's MPEG-4
  encoder with B-VOPs and quarter-pel under Xvid's user data (``XviD0064``)
  and fourcc.
* ``mpeg4_tools_88x40.avi``: 14 frames of 88 x 40 (a width and height that
  are not whole macroblocks) encoded by libavcodec's MPEG-4 encoder itself,
  reached through ctypes in the libraries the wheel bundles, with the coding
  tools ``cv2.VideoWriter`` does not ask for: four motion vectors a macroblock
  (``flags=+mv4``), AC prediction (``+aic``), resync markers every 50 bytes
  (``ps=50``, video packets) and adaptive quantisation (``lumi_mask``,
  ``dark_mask``, ``scplx_mask``: DQUANT, and AC prediction rescaled across
  quantisers); a VOP that is not coded (`NOT_CODED_VOP`, which FFmpeg
  decodes to no frame) is put after the fifth packet, and the 15 packets
  into an AVI by `write_avi` below.

* the H.263 family (`h263_fixtures`; ``python
  tests/fixtures/make_video_fixtures.py --h263`` rewrites only these and the
  digests): ``h263_{176x144,352x288}.avi``, ``{flv1,mp42,div3}_64x48.avi``
  from cv2's H263, FLV1, MP42 and DIV3 writers; ``u263_88x40.avi``,
  ``{flv1,mp42,div3}_tools_88x40.avi`` from libavcodec's h263p (PLUSPTYPE's
  custom picture format), flv, msmpeg4v2 and msmpeg4 encoders at fixed
  quantisers with four vectors and RD decisions, the MS-MPEG4 ones rewritten
  to three slices (`msmpeg4_slices`); ``flv1_droppable_88x40.avi``
  with every third frame made a disposable P-frame (`droppable`);
  ``mpeg4_dp_88x40.avi``, the MPEG-4 tools stream with data partitioning and
  video packets; and ``track_640x480_div3.avi``, the 640 x 480 clip as cv2's DIV3, the source of
  chip_smoke.py's DIV3 phases.
* WMV1, WMV2 and H.263+'s deblocking filter (`wmv_fixtures`; ``--wmv``
  rewrites only these and the digests): ``wmv{1,2}_64x48.{avi,mkv}`` from
  cv2's writers; libavcodec's wmv1 at 48 kbit/s (inter-intra prediction) and
  at 300 kbit/s rewritten to per-macroblock run-level tables in three
  slices (``wmv1_{ii,mbrl}_88x40.avi``), its wmv2 with the loop filter and
  the top-left vector predictor (`wmv2_top_left`), and rewritten by
  `wmv2_crafted` to the tools its encoder never writes (mspel, skip maps,
  CBP tables, per-macroblock run-level tables, ABT, a skipped picture)
  (``wmv2_{loop,crafted}_88x40.avi``), its h263p with
  ``flags=+loop`` (``u263_loop_88x40.avi``); ``track_640x480_wmv2.avi``,
  the 640 x 480 clip through libavcodec's wmv2 at quantiser 22 (the card's
  machine has no cv2: the clip is committed), the source of chip_smoke.py's
  WMV2 phases.

``video_fixtures.json`` holds, for each file, its codec, container and frame
count, and for each frame the SHA-256 of ``cv2.VideoCapture``'s frame after
``cvtColor(BGR2RGB)`` and of the port's (``data.native.video.frames``), with
the largest difference between the two and the share of values that differ.
The card's machine has no OpenCV: it checks the port's decoder against the
port's digests, and these files record how far those agree with OpenCV's.
"""

import ctypes
import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
OUT = HERE / "video"
DIGESTS = HERE / "video_fixtures.json"
SMALL = (48, 64)  # (h, w)
SMALL_FRAMES = 14  # crosses the MPEG-4 encoder's GOP of 12
TOOLS = (40, 88)
TOOLS_OPTIONS = {"flags": "+mv4+aic", "ps": "50", "lumi_mask": "0.8", "dark_mask": "0.9", "scplx_mask": "0.5"}
# Advanced Simple Profile streams of the tools frames: libavcodec MPEG-4 options
ASP_OPTIONS = {
    "mpeg4_bvop_88x40.avi": {"bf": "2"},
    "mpeg4_qpel_88x40.avi": {"flags": "+qpel+mv4"},
    "mpeg4_mq_88x40.avi": {"mpeg_quant": "1"},
    "mpeg4_asp_88x40.avi": {**TOOLS_OPTIONS, "bf": "2", "flags": "+qpel+mv4+aic", "mpeg_quant": "1"},
}
# the ASP stream under other encoders' user data: (file, user data, fourcc, DivX-packed)
TAGGED = [("xvid_asp_88x40.avi", b"XviD0001", b"XVID", False), ("divx_asp_88x40.avi", b"DivX503b1393", b"DX50", False),
          ("divx_packed_88x40.avi", b"DivX503b1393p", b"DX50", True)]
VP8_CLIPS = 30  # frames of the libvpx-encoded VP8 clips: 3 key frames at a GOP of 12
VP8_OPTIONS = {
    "vp8_p1_64x48.avi": {"profile": "1"},
    "vp8_p3_er_64x48.avi": {"profile": "3", "error-resilient": "default"},
    "vp8_p0_golden_64x48.avi": {"b": "60k", "auto-alt-ref": "1", "lag-in-frames": "8", "arnr-maxframes": "5"},
}
CLIP_ASP = {"bf": "2", "flags": "+qpel", "b": "800k"}  # track_640x480_xvid.avi
MPEG4, LIBVPX, LIBVPX_VP9 = 12, 139, 167  # AVCodecIDs: libavcodec's MPEG-4 encoder, its libvpx VP8 and VP9 wrappers
# AVCodecIDs of the H.263 family's encoders: h263, msmpeg4v2, msmpeg4 (v3), wmv1, wmv2, h263p, flv
H263, MSMPEG4V2, MSMPEG4V3, WMV1, WMV2, H263P, FLV1 = 4, 15, 16, 17, 18, 19, 21
# the H.263 family (`h263_fixtures`): cv2.VideoWriter's streams, (fourcc, (h, w), frames)
H263_CV2 = {"h263_176x144.avi": ("H263", (144, 176), 6), "h263_352x288.avi": ("H263", (288, 352), 3),
            "flv1_64x48.avi": ("FLV1", (48, 64), SMALL_FRAMES), "mp42_64x48.avi": ("MP42", (48, 64), SMALL_FRAMES),
            "div3_64x48.avi": ("DIV3", (48, 64), SMALL_FRAMES)}
# libavcodec's own encoders with the tools cv2.VideoWriter does not ask for: (encoder, fourcc, options)
H263_TOOLS = {
    "u263_88x40.avi": (H263P, b"U263", {"flags": "+mv4"}),  # PLUSPTYPE's custom format, four vectors
    "flv1_tools_88x40.avi": (FLV1, b"FLV1", {"flags": "+mv4+qscale", "global_quality": "236", "mbd": "rd"}),
    "mp42_tools_88x40.avi": (MSMPEG4V2, b"MP42", {"flags": "+qscale", "global_quality": "354", "g": "5"}),
    "div3_tools_88x40.avi": (MSMPEG4V3, b"DIV3", {"flags": "+qscale", "global_quality": "236", "mbd": "rd",
                                                  "g": "7"}),
    "mpeg4_dp_88x40.avi": (MPEG4, b"FMP4", {**TOOLS_OPTIONS, "data_partitioning": "1", "ps": "60"}),
}
VP9_FRAMES = 16  # frames of the libvpx-vp9 fixtures: a second key frame at the GOP of 12
# the libvpx-vp9 fixtures: the frames' (h, w) and the encoder's options; the suffix picks the writer
VP9_OPTIONS = {
    "vp9_tiles_512x64.mkv": ((64, 512), {"crf": "40", "b": "0", "tile-columns": "1", "tile-rows": "1",
                                         "frame-parallel": "0"}),
    "vp9_lossless_64x48.avi": ((48, 64), {"lossless": "1"}),
    "vp9_aq_96x64.mp4": ((64, 96), {"aq-mode": "3", "deadline": "realtime", "cpu-used": "8", "b": "80k",
                                    "color_range": "pc"}),
}
# libvpx-vp9 frames coded with one filter for the frame, rewritten to the bilinear filter (`bilinear_frame`)
VP9_BILINEAR = ("vp9_bilinear_96x64.mkv", (64, 96), {"b": "200k", "cpu-used": "4"})
# the two-pass fixture: alternate references (hidden, in superframes) and compound prediction
VP9_TWO_PASS = ("vp9_arf_96x64.webm", (64, 96), {"crf": "20", "b": "0", "auto-alt-ref": "1",
                                                 "lag-in-frames": "25", "cpu-used": "1", "g": "30"})
# a P-VOP header with vop_coded 0 (time increment 3 of 5 bits, as a 1/25 s VOL has), stuffed to a byte
NOT_CODED_VOP = bytes.fromhex("000001b651cf")


def small_frames(n: int = SMALL_FRAMES, hw=SMALL, seed: int = 3) -> list:
    """``n`` RGB frames: a smooth gradient panned 3 px right and 2 px down a
    frame with a little noise, under a black, a white and a coloured
    rectangle moving at their own speeds."""
    h, w = hw
    rng = np.random.default_rng(seed)
    H, W = h + 2 * n + 8, w + 3 * n + 8
    yy, xx = np.mgrid[0:H, 0:W]
    bg = np.stack([xx * 255 // W, yy * 255 // H, 128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0)], -1)
    bg = np.clip(bg + rng.integers(-4, 5, bg.shape), 0, 255).astype(np.uint8)
    out = []
    for t in range(n):
        im = bg[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        im[5 + t:15 + t, 4 + 2 * t:16 + 2 * t] = (0, 0, 0)
        im[max(0, 30 - t):40 - t, w - 24:w - 12] = (255, 255, 255)
        x = (t * 5) % (w - 8)
        im[h // 2 - 4:h // 2 + 4, x:x + 8] = (200, 30, 90)
        out.append(im)
    return out


def tools_frames(n: int = SMALL_FRAMES, hw=TOOLS, seed: int = 5) -> list:
    """Frames for the tools stream: a still left half (skipped macroblocks),
    a right half panned a pixel a frame, dark and bright bands (lumi_mask
    changes the quantiser between them) and two rectangles moving at odd
    speeds (half-pel and four-vector motion)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w + n + 4]
    tex = np.stack([(xx * 13 + yy * 7) % 256, 30 + (yy * 200 // h), 128 + 90 * np.sin(xx / 3.0)], -1)
    tex = np.clip(tex + rng.integers(-10, 11, tex.shape), 0, 255).astype(np.uint8)
    tex[:, :, :] = np.where((yy // 10 % 2 == 0)[..., None], tex // 4, tex)  # dark bands
    out = []
    for t in range(n):
        im = tex[:, :w].copy()
        im[:, w // 2:] = tex[:, w // 2 + t:w + t]
        x, y = int(10 + 2.5 * t), int(5 + 1.5 * t) % (h - 10)
        im[y:y + 10, x:x + 12] = (250, 250, 40)
        im[h - 12:h - 2, (w - 20 - 3 * t) % (w - 12):(w - 20 - 3 * t) % (w - 12) + 9] = (20, 20, 220)
        out.append(im)
    return out


def write_cv2(path: Path, fourcc: str, frames: list) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {path.name} with {fourcc}")
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


# ---------------------------------------------------------------- libavcodec's own encoder


def _libs() -> dict:
    import cv2

    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    found = {}
    for name in ("avutil", "avcodec"):
        path = sorted(libs.glob(f"lib{name}-*.so*"))[0]
        found[name] = ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
    return found


def encode_mpeg4(frames: list, options: dict) -> list:
    """Packets of libavcodec's MPEG-4 encoder (VOS and VOL in the first) for
    RGB ``frames`` with AVCodecContext ``options`` (``av_opt_set`` names),
    a GOP of 12 at 25 frames a second, in decode order."""
    return encode(frames, options, MPEG4)


def encode_vp8(frames: list, options: dict) -> list:
    """Packets of libvpx's VP8 encoder as libavcodec wraps it, as `encode_mpeg4`."""
    return encode(frames, options, LIBVPX)


def encode_vp9(frames: list, options: dict) -> list:
    """Packets of libvpx's VP9 encoder as libavcodec wraps it, as `encode_mpeg4`."""
    return encode(frames, options, LIBVPX_VP9)


def encode_vp9_two_pass(frames: list, options: dict) -> list:
    """Packets of libvpx's VP9 encoder in two passes (``flags=+pass1``, then
    ``+pass2`` with the first pass's statistics), as a two-pass ``vpxenc``
    writes them: alternate reference frames, hidden and packed with the next
    shown frame into superframes, and compound prediction from them."""
    stats, slot = encode(frames, {**options, "flags": "+pass1"}, LIBVPX_VP9, first_pass=True)
    return encode(frames, {**options, "flags": "+pass2"}, LIBVPX_VP9, stats_in=(stats, slot))


def encode(frames: list, options: dict, codec_id: int, first_pass: bool = False, stats_in: tuple = None,
           extradata: list = None):
    """Packets of the libavcodec encoder ``codec_id`` for RGB ``frames`` (an
    even width and height), as `encode_mpeg4` describes. With ``first_pass``
    (``flags=+pass1``), the statistics the encoder leaves in the context's
    ``stats_out`` and the pointer slot that holds it (found as the slot that
    the final flush fills); ``stats_in`` gives them back to a second pass
    (``stats_in`` is the slot after ``stats_out``). A list given as
    ``extradata`` receives the encoder's extradata (WMV2's ext header)."""
    import cv2

    libs = _libs()
    avu, avc = libs["avutil"], libs["avcodec"]
    vp = ctypes.c_void_p
    for f, res, args in [(avc.avcodec_find_encoder, vp, [ctypes.c_int]), (avc.avcodec_alloc_context3, vp, [vp]),
                         (avc.avcodec_open2, ctypes.c_int, [vp, vp, vp]), (avc.av_packet_alloc, vp, []),
                         (avc.avcodec_send_frame, ctypes.c_int, [vp, vp]),
                         (avc.avcodec_receive_packet, ctypes.c_int, [vp, vp]), (avc.av_packet_unref, None, [vp]),
                         (avu.av_frame_alloc, vp, []), (avu.av_frame_get_buffer, ctypes.c_int, [vp, ctypes.c_int]),
                         (avu.av_frame_make_writable, ctypes.c_int, [vp]),
                         (avu.av_opt_set, ctypes.c_int, [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int])]:
        f.restype, f.argtypes = res, args
    h, w = frames[0].shape[:2]
    codec = avc.avcodec_find_encoder(codec_id)
    ctx = avc.avcodec_alloc_context3(codec)
    # time_base has no option name: find it as the field before pkt_timebase
    assert avu.av_opt_set(ctx, b"pkt_timebase", b"12345/54321", 0) == 0
    ints = (ctypes.c_int * 512).from_address(ctx)
    at = next(i for i in range(511) if ints[i] == 12345 and ints[i + 1] == 54321)
    ints[at - 2], ints[at - 1] = 1, 25
    for k, v in {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "g": "12", **options}.items():
        if avu.av_opt_set(ctx, k.encode(), v.encode(), 1):
            raise RuntimeError(f"libavcodec refuses the option {k}={v}")
    slots = (ctypes.c_void_p * 256).from_address(ctx)
    if stats_in is not None:
        avu.av_strdup.restype, avu.av_strdup.argtypes = vp, [ctypes.c_char_p]
        slots[stats_in[1] + 1] = avu.av_strdup(stats_in[0])
    if avc.avcodec_open2(ctx, codec, None):
        raise RuntimeError("avcodec_open2 failed")
    if extradata is not None:  # AVCodecContext.extradata and extradata_size follow bit_rate (56) and flags
        extradata.append(ctypes.string_at(ctypes.c_void_p.from_address(ctx + 72).value or 0,
                                          ctypes.c_int.from_address(ctx + 80).value))
    frame, pkt, out = avu.av_frame_alloc(), avc.av_packet_alloc(), []
    (ctypes.c_int * 4).from_address(frame + 104)[:] = [w, h, 0, 0]  # AVFrame width, height, nb_samples, format
    assert avu.av_frame_get_buffer(frame, 0) == 0

    def drain():
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            data, size = ctypes.c_void_p.from_address(pkt + 24).value, ctypes.c_int.from_address(pkt + 32).value
            out.append(ctypes.string_at(data, size))
            avc.av_packet_unref(pkt)

    for i, im in enumerate(frames):
        yuv = cv2.cvtColor(np.ascontiguousarray(im), cv2.COLOR_RGB2YUV_I420).reshape(-1)
        c = (h // 2) * (w // 2)
        planes = [yuv[:h * w].reshape(h, w), yuv[h * w:h * w + c].reshape(h // 2, w // 2),
                  yuv[h * w + c:h * w + 2 * c].reshape(h // 2, w // 2)]
        assert avu.av_frame_make_writable(frame) == 0
        data, lines = (ctypes.c_void_p * 8).from_address(frame), (ctypes.c_int * 8).from_address(frame + 64)
        for p, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane)
            for r in range(plane.shape[0]):
                ctypes.memmove(data[p] + r * lines[p], plane[r].ctypes.data, plane.shape[1])
        ctypes.c_int64.from_address(frame + 136).value = i  # AVFrame.pts
        # AVFrame.quality: with flags=+qscale the encoder takes each frame's quantiser from it (as the
        # ffmpeg tool sets it from global_quality), not from the context
        ctypes.c_int.from_address(frame + 160).value = int(options.get("global_quality", 0))
        assert avc.avcodec_send_frame(ctx, frame) == 0
        drain()
    before = list(slots)
    avc.avcodec_send_frame(ctx, None)
    drain()
    if first_pass:
        slot = next(i for i in range(256) if slots[i] and not before[i])
        return ctypes.string_at(slots[slot]), slot
    return out


# ---------------------------------------------------------------- VP9 packets and containers


class _Bits:
    """An MSB-first bit reader that records what it read."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int = 1) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def vp9_header(packet: bytes, size: tuple = None) -> dict:
    """The fields of a profile 0 VP9 frame's uncompressed header that the
    repackers below need (``size``, the stream's (w, h), for an inter frame
    that takes its size from a reference), with the bit positions they
    rewrite: ``key``,
    ``show`` (and its bit), ``error_res`` (and the bit after it), ``refresh``
    (the slots the frame refreshes), ``size_at`` (where the frame size
    starts), ``end`` (the bit after header_size_in_bytes) and
    ``compressed`` (that size)."""
    b = _Bits(packet)
    assert b.read(2) == 2 and b.read(2) == 0, "a profile 0 frame"
    if b.read():
        return {"existing": b.read(3)}
    out = {"key": not b.read(), "show_at": b.pos}
    out["show"] = b.read()
    out["error_res"] = b.read()
    out["after_error_res"] = b.pos
    if out["key"]:
        b.read(24)
        if b.read(3) != 7:
            b.read(1)
        out["refresh"], out["size_at"] = 0xFF, b.pos
        w, h = b.read(16) + 1, b.read(16) + 1
        if b.read():
            b.read(32)
    else:
        intra_only = b.read() if not out["show"] else 0
        out["intra_only"] = intra_only
        if not out["error_res"]:
            b.read(2)
        if intra_only:
            b.read(24)
            out["refresh"], out["size_at"] = b.read(8), b.pos
            w, h = b.read(16) + 1, b.read(16) + 1
            if b.read():
                b.read(32)
        else:
            out["refresh"] = b.read(8)
            b.read(12)
            out["ref_size_at"] = b.pos
            found = any(b.read() for _ in range(3))
            w, h = size if found else (b.read(16) + 1, b.read(16) + 1)
            out["ref_size_end"] = b.pos
            if b.read():
                b.read(32)
            b.read(1)
            if not b.read():
                out["filter_at"] = b.pos
                b.read(2)
    out["size"] = (w, h)
    if not out["error_res"]:
        b.read(2)
    b.read(2)
    b.read(6 + 3)
    if b.read() and b.read():
        for _ in range(6):
            if b.read():
                b.read(7)
    b.read(8)
    for _ in range(3):
        if b.read():
            b.read(5)
    if b.read():
        if b.read():
            for _ in range(7):
                if b.read():
                    b.read(8)
            if b.read():
                for _ in range(3):
                    if b.read():
                        b.read(8)
        if b.read():
            b.read(1)
            for _ in range(8):
                for n in (9, 7, 2):
                    if b.read():
                        b.read(n)
                b.read(1)
    sb_cols = (out["size"][0] + 63) // 64
    min_log2 = 0
    while (64 << min_log2) < sb_cols:
        min_log2 += 1
    max_log2 = 1
    while (sb_cols >> max_log2) >= 4:
        max_log2 += 1
    for _ in range(max_log2 - 1 - min_log2):
        if not b.read():
            break
    if b.read():
        b.read(1)
    out["compressed"] = b.read(16)
    out["end"] = b.pos
    return out


def _bits_of(packet: bytes, start: int, end: int) -> str:
    return "".join(str((packet[i >> 3] >> (7 - (i & 7))) & 1) for i in range(start, end))


def _repack(bits: str, packet: bytes, end: int) -> bytes:
    """``bits`` (a new uncompressed header) padded to a byte, then ``packet``
    from the byte after its old header (``end`` its bit length)."""
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") + packet[(end + 7) // 8:]


def hide_frame(packet: bytes, size: tuple) -> bytes:
    """An inter frame made hidden: show_frame 0 and the intra_only bit (0)
    that the header then carries. ``size`` is the stream's (w, h)."""
    hd = vp9_header(packet, size)
    assert not hd["key"] and hd["show"]
    bits = _bits_of(packet, 0, hd["end"])
    at = hd["show_at"]
    bits = bits[:at] + "0" + bits[at + 1:hd["after_error_res"]] + "0" + bits[hd["after_error_res"]:]
    return _repack(bits, packet, hd["end"])


def intra_only_frame(packet: bytes, refresh: int) -> bytes:
    """A key frame rewritten as a hidden intra-only frame that refreshes the
    slots of ``refresh`` and resets every frame context (reset_frame_context
    3), as the key frame did: the same pixels, but no frame shown."""
    hd = vp9_header(packet)
    assert hd["key"]
    bits = "10" + "00" + "0" + "1" + "0" + str(hd["error_res"]) + "1"
    if not hd["error_res"]:
        bits += "11"
    bits += "01001001" "10000011" "01000010"  # the sync code
    bits += format(refresh, "08b") + _bits_of(packet, hd["size_at"], hd["end"])
    return _repack(bits, packet, hd["end"])


def resized_inter_frame(packet: bytes, size: tuple, new: tuple) -> bytes:
    """An inter frame of a stream of ``size`` that names the frame size
    ``new`` instead of taking its references' (a frame whose references
    must be scaled); ``new`` needs as many 64-pixel columns as ``size``."""
    hd = vp9_header(packet, size)
    assert not hd["key"] and not hd.get("intra_only") and (new[0] + 63) // 64 == (size[0] + 63) // 64
    bits = _bits_of(packet, 0, hd["end"])
    bits = (bits[:hd["ref_size_at"]] + "000" + format(new[0] - 1, "016b") + format(new[1] - 1, "016b")
            + bits[hd["ref_size_end"]:])
    return _repack(bits, packet, hd["end"])


def bilinear_frame(packet: bytes, size: tuple) -> bytes:
    """An inter frame coded with one interpolation filter for the frame,
    rewritten to name the bilinear one (the filter that libvpx's encoder
    never picks; the frame parses the same, its prediction changes)."""
    at = vp9_header(packet, size)["filter_at"]
    out = bytearray(packet)
    for i in (at, at + 1):
        out[i >> 3] |= 0x80 >> (i & 7)
    return bytes(out)


def show_existing(slot: int) -> bytes:
    """A one-byte frame that shows the frame in reference ``slot`` again."""
    return bytes([0x88 | slot])


def superframe(frames: list) -> bytes:
    """``frames`` in one packet with a superframe index after them."""
    mag = max(1, (max(map(len, frames)).bit_length() + 7) // 8)
    marker = 0xC0 | (mag - 1) << 3 | (len(frames) - 1)
    index = bytes([marker]) + b"".join(len(f).to_bytes(mag, "little") for f in frames) + bytes([marker])
    return b"".join(frames) + index


def vp9_crafted(packets: list, size: tuple) -> list:
    """An error-resilient stream's ``packets`` (no frame predicts from the
    previous frame's motion vectors, none adapts its probabilities), repacked
    with what the encoder does not write: packets 1 and 2 in one superframe;
    packet 4 made hidden and shown again by show_existing_frame of a slot it
    refreshes, in one packet; the second key frame (packet 12) as a hidden
    intra-only frame refreshing every slot, followed in its own packet by
    show_existing_frame of slot 0."""
    out = [packets[0], superframe(packets[1:3]), packets[3]]
    refresh = vp9_header(packets[4], size)["refresh"]
    slot = (refresh & -refresh).bit_length() - 1
    out.append(superframe([hide_frame(packets[4], size), show_existing(slot)]))
    out += packets[5:12]
    out += [intra_only_frame(packets[12], 0xFF), show_existing(0)]
    out += packets[13:]
    return out


def _ebml(ident: bytes, payload: bytes) -> bytes:
    return ident + (0x01 << 56 | len(payload)).to_bytes(8, "big") + payload


def _uint(v: int) -> bytes:
    return v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")


def write_mkv(path: Path, packets: list, w: int, h: int, codec: str = "V_VP9", doctype: str = "webm",
              private: bytes = b"") -> None:
    """A minimal Matroska file: one video track of ``packets`` as SimpleBlocks
    of one cluster, 40 ms apart; ``private`` its CodecPrivate."""
    header = _ebml(b"\x1a\x45\xdf\xa3", _ebml(b"\x42\x86", b"\x01") + _ebml(b"\x42\xf7", b"\x01")
                   + _ebml(b"\x42\xf2", b"\x04") + _ebml(b"\x42\xf3", b"\x08")
                   + _ebml(b"\x42\x82", doctype.encode()) + _ebml(b"\x42\x87", b"\x04")
                   + _ebml(b"\x42\x85", b"\x02"))
    info = _ebml(b"\x15\x49\xa9\x66", _ebml(b"\x2a\xd7\xb1", _uint(1_000_000)) + _ebml(b"\x4d\x80", b"fixtures")
                 + _ebml(b"\x57\x41", b"fixtures"))
    video_el = _ebml(b"\xe0", _ebml(b"\xb0", _uint(w)) + _ebml(b"\xba", _uint(h)))
    track = _ebml(b"\xae", _ebml(b"\xd7", b"\x01") + _ebml(b"\x73\xc5", b"\x01") + _ebml(b"\x83", b"\x01")
                  + _ebml(b"\x86", codec.encode()) + (_ebml(b"\x63\xa2", private) if private else b"") + video_el)
    blocks = b"".join(_ebml(b"\xa3", b"\x81" + struct.pack(">h", 40 * i) + (b"\x80" if i == 0 else b"\x00") + p)
                      for i, p in enumerate(packets))
    cluster = _ebml(b"\x1f\x43\xb6\x75", _ebml(b"\xe7", b"\x00") + blocks)
    path.write_bytes(header + _ebml(b"\x18\x53\x80\x67", info + _ebml(b"\x16\x54\xae\x6b", track) + cluster))


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def write_mp4(path: Path, packets: list, w: int, h: int, profile: int = 0, depth: int = 8) -> None:
    """A minimal MP4 file: one ``vp09`` track (its ``vpcC`` naming ``profile``
    and bit ``depth``) of ``packets``, 40 ms apart, in one chunk of an
    ``mdat`` before the ``moov``."""
    n = len(packets)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2vp09mp41")
    mdat = _box(b"mdat", b"".join(packets))
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mvhd = _box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, 1000, 40 * n) + struct.pack(">IH", 0x10000, 0x100)
                + bytes(10) + matrix + bytes(24) + struct.pack(">I", 2))
    tkhd = _box(b"tkhd", struct.pack(">IIIII", 3, 0, 0, 1, 0) + struct.pack(">I", 40 * n) + bytes(8)
                + struct.pack(">hhhH", 0, 0, 0, 0) + matrix + struct.pack(">II", w << 16, h << 16))
    mdhd = _box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, 1000, 40 * n, 0x55C4, 0))
    hdlr = _box(b"hdlr", struct.pack(">II", 0, 0) + b"vide" + bytes(12) + b"VideoHandler\0")
    vpcc = _box(b"vpcC", struct.pack(">IBBBBBBH", 1 << 24, profile, 10, depth << 4 | 1 << 1, 2, 2, 2, 0))
    entry = _box(b"vp09", bytes(6) + struct.pack(">HHH12sHHIIIH32sHh", 1, 0, 0, bytes(12), w, h, 0x480000, 0x480000,
                                                   0, 1, bytes(32), 0x18, -1) + vpcc)
    at = len(ftyp) + 8
    stbl = _box(b"stbl", _box(b"stsd", struct.pack(">II", 0, 1) + entry)
                + _box(b"stts", struct.pack(">IIII", 0, 1, n, 40))
                + _box(b"stsc", struct.pack(">IIIII", 0, 1, 1, n, 1))
                + _box(b"stsz", struct.pack(">III", 0, 0, n) + b"".join(struct.pack(">I", len(p)) for p in packets))
                + _box(b"stco", struct.pack(">III", 0, 1, at)))
    minf = _box(b"minf", _box(b"vmhd", struct.pack(">IHHHH", 1, 0, 0, 0, 0))
                + _box(b"dinf", _box(b"dref", struct.pack(">II", 0, 1) + _box(b"url ", struct.pack(">I", 1)))) + stbl)
    moov = _box(b"moov", mvhd + _box(b"trak", tkhd + _box(b"mdia", mdhd + hdlr + minf)))
    path.write_bytes(ftyp + mdat + moov)


def droppable(packet: bytes, size: tuple) -> bytes:
    """A Sorenson H.263 P-frame rewritten as a disposable one (picture type
    2), which no later frame predicts from; ``size`` is the header's (w, h)
    as the encoder codes it in 8 or 16 bits."""
    w, h = size
    size_bits = 3 + (16 if max(w, h) > 255 else 8) * 2 if (w, h) not in (
        (352, 288), (176, 144), (128, 96), (320, 240), (160, 120)) else 3
    at = 17 + 5 + 8 + size_bits
    bits = "".join(f"{b:08b}" for b in packet)
    assert bits[at:at + 2] == "01", "not a P-frame"
    bits = bits[:at] + "10" + bits[at + 2:]
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def msmpeg4_slices(packets: list, slices: int) -> list:
    """MS-MPEG4 packets whose I-frames declare ``slices`` slices (slice code
    0x16 + slices) where the encoder wrote one: each slice then starts its
    predictions afresh, as a decoder reads the code (libavcodec's encoder
    writes a single slice)."""
    out = []
    for p in packets:
        bits = "".join(f"{b:08b}" for b in p)
        if bits[:2] == "00":  # an I-frame: picture type, quantiser, then the slice code
            bits = bits[:7] + f"{0x16 + slices:05b}" + bits[12:]
        out.append(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))
    return out


def h263_fixtures(track: list) -> None:
    """The H.263 family's fixtures: cv2's H263 (QCIF, CIF), FLV1, MP42 and DIV3
    writers; libavcodec's h263p (PLUSPTYPE custom format), flv, msmpeg4v2
    and msmpeg4 encoders at fixed quantisers with four vectors and RD
    macroblock decisions; a Sorenson stream with disposable P-frames; the
    MPEG-4 encoder with data partitioning and video packets; H.263 pictures
    under an MPEG-4 fourcc (short_video_header: FFmpeg's MPEG-4 decoder
    gives no frame); the 640 x 480 clip as cv2's DIV3."""
    for name, (fourcc, hw, n) in H263_CV2.items():
        write_cv2(OUT / name, fourcc, small_frames(n, hw, seed=11))
    for name, (codec, fourcc, options) in H263_TOOLS.items():
        packets = encode(tools_frames(), {"g": "12", **options}, codec)
        if codec in (MSMPEG4V2, MSMPEG4V3):
            packets = msmpeg4_slices(packets, 3)
        write_avi(OUT / name, packets, TOOLS[1], TOOLS[0], fourcc)
    flv = encode(tools_frames(), {"g": "12"}, FLV1)
    flv = [droppable(p, (TOOLS[1], TOOLS[0])) if i % 3 == 2 else p for i, p in enumerate(flv)]
    write_avi(OUT / "flv1_droppable_88x40.avi", flv, TOOLS[1], TOOLS[0], b"FLV1")
    write_cv2(OUT / "track_640x480_div3.avi", "DIV3", track)


# ---------------------------------------------------------------- WMV1, WMV2 and H.263+ Annex J

# the WMV fixtures (`wmv_fixtures`): cv2.VideoWriter's WMV1 and WMV2 in AVI and Matroska, (fourcc, suffix)
WMV_CV2 = {"wmv1_64x48.avi": "WMV1", "wmv1_64x48.mkv": "WMV1", "wmv2_64x48.avi": "WMV2", "wmv2_64x48.mkv": "WMV2"}
WMV_FRAMES = 8
# libavcodec's wmv1 and wmv2 encoders and h263p's deblocking filter: (encoder, fourcc, options)
WMV_TOOLS = {
    # at or under 128 kbit/s and below 320 x 240: inter-intra DC prediction in P-frames
    "wmv1_ii_88x40.avi": (WMV1, b"WMV1", {"b": "48k", "mbd": "rd"}),
    # above 50 kbit/s: the per-macroblock run-level bit, set by `per_mb_rl`; three slices
    "wmv1_mbrl_88x40.avi": (WMV1, b"WMV1", {"b": "300k", "flags": "+qscale", "global_quality": str(8 * 118)}),
    # the loop filter, and top_left_mv_flag set by `wmv2_top_left`
    "wmv2_loop_88x40.avi": (WMV2, b"WMV2", {"flags": "+loop+qscale", "global_quality": str(9 * 118)}),
    # rewritten by `wmv2_crafted`: mspel with hshift, skip maps, per-macroblock run-level tables, CBP tables, ABT
    "wmv2_crafted_88x40.avi": (WMV2, b"WMV2", {"flags": "+qscale", "global_quality": str(12 * 118), "g": "21"}),
    "u263_loop_88x40.avi": (H263P, b"U263", {"flags": "+loop+mv4+qscale", "global_quality": str(10 * 118)}),
}
CLIP_WMV2 = {"flags": "+qscale", "global_quality": str(22 * 118)}  # track_640x480_wmv2.avi


SKIP_MPEG, SKIP_ROW, SKIP_COL = 1, 2, 3  # WMV2's skip map types
CRAFT_TOOLS = ("cbp", "mspel", "rl", "skip", "abt")  # `wmv2_crafted`'s rewrites, a P-frame each in turn
ABT_MODES = ("block", 1, 2, "mb")  # ABT per block, the picture's 8x4 or 4x8, per macroblock


def wmv_frames(n: int = 21, hw=TOOLS, seed: int = 5) -> list:
    """The tools frames with a patch of noise pasted on three of them (intra
    macroblocks in P-frames) and the fourth frame repeated (a P-frame every
    macroblock of which can be skipped)."""
    frames = tools_frames(n, hw, seed)
    rng = np.random.default_rng(seed)
    for t in (3, 6, 8):
        y, x = int(rng.integers(0, hw[0] - 16)), int(rng.integers(0, hw[1] - 28))
        if t < n:
            frames[t] = frames[t].copy()
            frames[t][y:y + 16, x:x + 28] = rng.integers(0, 256, (16, 28, 3))
    if n > 4:
        frames[4] = frames[3]
    return frames


def _bits(packet: bytes) -> str:
    return "".join(f"{b:08b}" for b in packet)


def _packed(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _edit(packet: bytes, edits: list) -> bytes:
    """``packet`` with each (bit position, bits removed, bits put there) of
    ``edits`` applied, the positions those of the original; what is put at
    one position comes in the order of ``edits``."""
    bits = _bits(packet)
    for _, (at, cut, put) in sorted(enumerate(edits), key=lambda e: (e[1][0], e[0]), reverse=True):
        bits = bits[:at] + put + bits[at + cut:]
    return _packed(bits)


def ext_header(extra: bytes, **fields) -> bytes:
    """WMV2's 4-byte ext header with ``fields`` (mspel_bit, loop_filter,
    abt_flag, j_type_bit, top_left_mv_flag, per_mb_rl_bit: 0 or 1; slice_code:
    1-7) replaced, in decode_ext_header's order after the 5-bit frame rate
    and the 11-bit bit rate."""
    bits = list(_bits(extra))
    names = ("mspel_bit", "loop_filter", "abt_flag", "j_type_bit", "top_left_mv_flag", "per_mb_rl_bit")
    for name, value in fields.items():
        if name == "slice_code":
            bits[22:25] = f"{value:03b}"
        else:
            bits[16 + names.index(name)] = str(value)
    return _packed("".join(bits))


def _code012(v: int) -> str:
    return ("0", "10", "11")[v]


def _read012(bits: str, at: int):
    """(value, length) of decode012 at ``at``."""
    return (0, 1) if bits[at] == "0" else (1 + int(bits[at + 1]), 2)


def wmv_trace(codec: str, packets: list, size: tuple, private: bytes = b"") -> list:
    """Each packet's (picture row, macroblock rows) of the port's decoder trace
    (``video.Decoder._trace``), None for a packet that decoded to no picture."""
    from quan_ultralytics_tpu_torch.data.native import video

    dec = video.Decoder(codec, private, b"", size)
    dec._start_trace()
    out = []
    for p in packets:
        before = len(dec._trace())
        dec.send(p)
        rows = dec._trace()[before:]
        out.append((rows[0], rows[1:]) if len(rows) else None)
    return out


def _vlc_codes(header: str, name: str) -> list:
    """{code, length} pairs of the array ``name`` in a table header of the port."""
    import re

    text = (REPO / "quan_ultralytics_tpu_torch" / "data" / "native" / header).read_text()
    body = re.search(name + r"((?:\[\d+\])+) = \{([^}]*)\}", text).group(2)
    v = [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]
    return [(v[i], v[i + 1]) for i in range(0, len(v), 2)]


def wmv2_crafted(packets: list, size: tuple, extra: bytes, seed: int = 0) -> list:
    """WMV2 packets rewritten to use what libavcodec's wmv2 encoder never
    writes (its picture header fixes them), each P-frame one rewrite in turn
    (CRAFT_TOOLS; 21 frames, one I-frame): another CBP table (each
    macroblock type recoded); mspel motion (the picture's mspel bit set and a
    random hshift bit after each odd vector); run-level tables chosen per
    macroblock (the picture's index moved to each coded macroblock); a skip
    map (the coded macroblocks that equal a skipped one, inter with no
    coefficients and a zero vector, become skipped), ROW, MPEG, COL, ROW in
    turn, and after the first a picture whose ROW map skips every row (FFmpeg
    decodes it to no frame); ABT (per block, the picture's 8x4, the
    picture's 4x8, per macroblock in turn: each coded inter block then codes
    its sub-blocks' pattern, its coefficients read as one sub-block, the
    first or the second, or as both where a copy of them follows).
    ``extra`` is the stream's ext header (mspel_bit, abt_flag and
    per_mb_rl_bit set, as the encoder writes it)."""
    rng = np.random.default_rng(seed)
    tables = [_vlc_codes("wmv_tables.h", "kWmv2InterTable")[i * 128:(i + 1) * 128] for i in range(3)]
    tables.append(_vlc_codes("msmpeg4_tables.h", "kMbNonIntraTable"))
    mb_w, mb_h = (size[0] + 15) // 16, (size[1] + 15) // 16
    out = []
    for k, (p, tr) in enumerate(zip(packets, wmv_trace("wmv2", packets, size, extra))):
        pic, mbs = tr
        bits = _bits(p)
        h = int(pic[3])
        if pic[2] == 0:  # I-frames stay as coded
            out.append(p)
            continue
        assert bits[h:h + 2] == "00", "not SKIP_TYPE_NONE"
        cbp_index, n012 = _read012(bits, h + 2)
        mspel_at = h + 2 + n012
        rl_flag_at = mspel_at + 1 + 2  # mspel, per_mb_abt ^ 1 = 1, abt_type 0
        assert bits[mspel_at + 1:mspel_at + 3] == "10" and bits[rl_flag_at] == "0"
        rl, n_rl = _read012(bits, rl_flag_at + 1)
        edits, tool, nth = [], CRAFT_TOOLS[(k - 1) % len(CRAFT_TOOLS)], (k - 1) // len(CRAFT_TOOLS)
        if tool == "mspel":
            edits.append((mspel_at, 1, "1"))
            for row in mbs:
                if not row[1] and not row[2] and (row[9] | row[10]) & 1:
                    edits.append((int(row[8]), 0, str(int(rng.integers(0, 2)))))
        elif tool == "skip":
            kind = (SKIP_ROW, SKIP_MPEG, SKIP_COL)[nth % 3]
            skip = np.zeros(mb_w * mb_h, bool)
            for row in mbs:
                if not row[1] and not row[3] and row[9] == 0 and row[10] == 0:
                    skip[row[0]] = True
                    edits.append((int(row[5]), int(row[8] - row[5]), ""))
            grid = skip.reshape(mb_h, mb_w)
            lines = grid if kind == SKIP_ROW else grid.T
            if kind == SKIP_MPEG:
                m = "".join("1" if v else "0" for v in skip)
            else:
                m = "".join("1" if ln.all() else "0" + "".join("1" if v else "0" for v in ln) for ln in lines)
            edits.append((h, 2, f"{kind:02b}" + m))
        elif tool == "rl":  # run-level tables per macroblock
            edits.append((rl_flag_at, 1 + n_rl, "1"))
            for row in mbs:
                if not row[2] and row[3]:
                    edits.append((int(row[7]), 0, _code012(rl)))
        elif tool == "abt":
            mode = ABT_MODES[nth % len(ABT_MODES)]
            edits.append((mspel_at + 2, 1, _code012(mode)) if mode in (1, 2) else (mspel_at + 1, 2, "0"))
            for row in mbs:
                if row[1] or row[2] or not row[3]:
                    continue
                t = mode if mode in (1, 2) else int(rng.integers(0, 3))
                if mode in ("block", "mb"):
                    edits.append((int(row[7]), 0, "1" if mode == "block" else "0" + _code012(t)))
                for n in range(6):
                    if not (row[3] >> (5 - n)) & 1:
                        continue
                    start, end = int(row[11 + 2 * n]), int(row[12 + 2 * n])
                    if mode == "block":
                        t = int(rng.integers(0, 3))
                    put = _code012(t) if mode == "block" else ""
                    if t:
                        sub = int(rng.integers(0, 2 if row[23] == n else 3))  # both halves: the bits again
                        put += ("11", "0", "10")[sub]
                        if sub == 2:
                            edits.append((end, 0, bits[start:end]))
                    if put:
                        edits.append((start, 0, put))
        elif tool == "cbp":  # the CBP table of another index
            q = int(np.unpackbits(np.frombuffer(p[:1], np.uint8))[1:6] @ (1 << np.arange(4, -1, -1)))
            new = (cbp_index + 1 + int(rng.integers(0, 2))) % 3
            old_t, new_t = [[(0, 2, 1), (1, 0, 2), (2, 1, 0)][(q > 10) + (q > 20)][c] for c in (cbp_index, new)]
            edits.append((h + 2, n012, _code012(new)))
            for row in mbs:
                if not row[2]:
                    code, n = tables[new_t][int(row[4])]
                    edits.append((int(row[5]), tables[old_t][int(row[4])][1], f"{code:0{n}b}"))
        out.append(_edit(p, edits))
        if tool == "skip" and nth == 0:
            out.append(_packed("1" + bits[1:6] + f"{SKIP_ROW:02b}" + "1" * mb_h))
    return out


def _wrap64(v: int) -> int:
    """ff_msmpeg4_decode_motion's fold of a vector component into -63..63."""
    return v + 64 if v <= -64 else v - 64 if v >= 64 else v


def _mv_codes(table: int) -> dict:
    """MS-MPEG4's vector VLC ``table`` (0 or 1) as {symbol: bits}: the codes
    given in order of msmpeg4_tables.h's lengths, as ff_vlc_init_from_lengths
    gives them."""
    import re

    text = (REPO / "quan_ultralytics_tpu_torch" / "data" / "native" / "msmpeg4_tables.h").read_text()
    arrays = [[int(v) for v in re.search(name + r"\[1100\] = \{([^}]*)\}", text).group(1).replace("\n", " ").split(",")
               if v.strip()] for name in (f"kMvLens{table}", f"kMvSyms{table}")]
    codes, acc = {}, 0
    for n, sym in zip(*arrays):
        codes[sym] = f"{acc >> (32 - n):0{n}b}"
        acc += 1 << (32 - n)
    return codes


def wmv2_top_left(packets: list, size: tuple, extra: bytes, seed: int = 0):
    """(packets, ext header) of a one-slice WMV2 stream with no mspel picture
    rewritten to top_left_mv_flag, which libavcodec's encoder never sets:
    where the left and top vectors of an inter macroblock off the first row
    and column differ by 8 or more, a random bit picks one of them as the
    predictor and the vector is coded again from it (by the VLC or its
    escape), so that every vector stays as it was."""
    rng = np.random.default_rng(seed)
    mb_w = (size[0] + 15) // 16
    out = []
    for p, tr in zip(packets, wmv_trace("wmv2", packets, size, extra)):
        pic, mbs = tr
        if pic[2] == 0:
            out.append(p)
            continue
        bits, h = _bits(p), int(pic[3])
        assert bits[h:h + 2] == "00", "not SKIP_TYPE_NONE"
        at = h + 2 + _read012(bits, h + 2)[1]  # mspel, then per_mb_abt ^ 1, abt_type, per_mb_rl, rl, dc, mv table
        assert bits[at:at + 4] == "0100", "mspel, ABT or per-macroblock run-level tables"
        at += 4 + _read012(bits, at + 4)[1] + 1
        codes = _mv_codes(int(bits[at]))
        motion = {int(r[0]): (0, 0) if r[1] or r[2] else (int(r[9]), int(r[10])) for r in mbs}
        edits = []
        for r in mbs:
            i = int(r[0])
            if r[1] or r[2] or i % mb_w == 0 or i < mb_w:
                continue
            a, b, mv = motion[i - 1], motion[i - mb_w], motion[i]
            if max(abs(a[0] - b[0]), abs(a[1] - b[1])) < 8:
                continue
            t = int(rng.integers(0, 2))
            pred = (a, b)[t]
            sym = []
            for c in range(2):  # the code x (0..63) that ff_msmpeg4_decode_motion turns into mv[c]
                x = [x for x in range(64) if _wrap64(x + pred[c] - 32) == mv[c]]
                assert x, "a vector out of the predictor's reach"
                sym.append(x[0])
            code = codes.get((sym[0] << 8) | sym[1]) if sym != [0, 0] else None
            code = code if code is not None else codes[0] + f"{sym[0]:06b}{sym[1]:06b}"
            edits.append((int(r[6]), int(r[8] - r[6]), str(t) + code))
        out.append(_edit(p, edits))
    return out, ext_header(extra, top_left_mv_flag=1)


def per_mb_rl(packets: list, size: tuple, codec: str, extra: bytes = b"") -> list:
    """MS-MPEG4 packets (WMV1 above 50 kbit/s, WMV2) whose P-frames, and
    I-frames coded with one run-level table for luma and chroma, set the
    per-macroblock run-level bit (which libavcodec's encoders write as 0): the
    picture's table index is moved to each coded macroblock."""
    out = []
    for p, tr in zip(packets, wmv_trace(codec, packets, size, extra)):
        pic, mbs = tr
        bits, h = _bits(p), int(pic[3])
        if codec == "wmv1":
            flag_at = h + 5 + 17 if pic[2] == 0 else h + 1
        else:
            flag_at = h + 1 if pic[2] == 0 else None
        if flag_at is None:
            out.append(p)
            continue
        assert bits[flag_at] == "0"
        first, n1 = _read012(bits, flag_at + 1)
        n = n1
        if pic[2] == 0:
            second, n2 = _read012(bits, flag_at + 1 + n1)
            if second != first:
                out.append(p)
                continue
            n += n2
        edits = [(flag_at, 1 + n, "1")]
        edits += [(int(row[7]), 0, _code012(first)) for row in mbs if not row[2] and row[3]]
        out.append(_edit(p, edits))
    return out


def wmv_fixtures(track: list) -> None:
    """The WMV1, WMV2 and Annex J fixtures: cv2's WMV1 and WMV2 writers into
    AVI and Matroska; libavcodec's wmv1 encoder at 100 kbit/s (inter-intra
    prediction) and at 300 kbit/s with run-level tables per macroblock
    (`per_mb_rl`) in three slices; its wmv2 encoder with the loop filter and
    the top-left vector predictor (`wmv2_top_left`), and rewritten by
    `wmv2_crafted`; h263p with the deblocking filter; the
    640 x 480 clip through libavcodec's wmv2 encoder at quantiser 20 (small
    enough to commit), the source of chip_smoke.py's WMV2 phases."""
    small = small_frames(WMV_FRAMES, SMALL, seed=13)
    for name, fourcc in WMV_CV2.items():
        write_cv2(OUT / name, fourcc, small)
    frames = wmv_frames()
    size = (TOOLS[1], TOOLS[0])
    for name, (codec, fourcc, options) in WMV_TOOLS.items():
        extra = []
        packets = encode(frames if "crafted" in name else frames[:WMV_FRAMES], options, codec, extradata=extra)
        extra = extra[0] if codec == WMV2 else b""
        if name == "wmv1_mbrl_88x40.avi":
            packets = msmpeg4_slices(per_mb_rl(packets, size, "wmv1"), 3)
        elif name == "wmv2_crafted_88x40.avi":
            packets = wmv2_crafted(per_mb_rl(packets, size, "wmv2", extra), size, extra)
        elif name == "wmv2_loop_88x40.avi":
            packets, extra = wmv2_top_left(packets, size, extra)
        write_avi(OUT / name, packets, size[0], size[1], fourcc, extra=extra)
    extra = []
    clip = encode(track, CLIP_WMV2, WMV2, extradata=extra)
    write_avi(OUT / "track_640x480_wmv2.avi", clip, track[0].shape[1], track[0].shape[0], b"WMV2", extra=extra[0])


def set_user_data(packets: list, text: bytes) -> list:
    """``packets`` with the user data libavcodec writes after the VOL (its
    ``Lavc...`` build) replaced by ``text``, as another encoder writes it."""
    first = packets[0]
    at = first.index(b"\x00\x00\x01\xb2Lavc")
    end = first.index(b"\x00\x00\x01", at + 4)
    return [first[:at + 4] + text + first[end:]] + packets[1:]


def vop_types(packet: bytes) -> list:
    """The coding type of each VOP in ``packet`` (0 I, 1 P, 2 B, 3 S)."""
    out, at = [], packet.find(b"\x00\x00\x01\xb6")
    while at >= 0:
        out.append(packet[at + 4] >> 6)
        at = packet.find(b"\x00\x00\x01\xb6", at + 4)
    return out


def pack_b_frames(packets: list) -> list:
    """DivX 5's packed B-VOPs: a reference VOP followed by B-VOPs (in decode
    order) becomes a chunk of the reference and the first B-VOP, the other
    B-VOPs alone, then an N-VOP placeholder, so that the AVI holds one chunk
    a displayed frame."""
    out, i = [], 0
    while i < len(packets):
        j = i + 1
        while j < len(packets) and vop_types(packets[j])[:1] == [2]:
            j += 1
        if j > i + 1:
            out += [packets[i] + packets[i + 1], *packets[i + 2:j], NOT_CODED_VOP]
        else:
            out.append(packets[i])
        i = j
    return out


def write_avi(path: Path, packets: list, w: int, h: int, fourcc: bytes, fps: int = 25, extra: bytes = b"") -> None:
    """A minimal AVI 1.0 file: one video stream of ``packets`` as ``00dc``
    chunks, with an ``idx1`` index; ``extra`` follows the BITMAPINFOHEADER
    (biSize 40 + its length), as WMV2's ext header does."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")

    def lst(kind: bytes, body: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body

    n, biggest = len(packets), max(map(len, packets))
    avih = struct.pack("<IIIIIIIIII4I", 1000000 // fps, 0, 0, 0x10, n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n, biggest,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0) + extra
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index, at = b"", b"", 4
    for p in packets:
        index += struct.pack("<4sIII", b"00dc", 0x10 if p[3:4] == b"\xb0" else 0, at, len(p))
        c = chunk(b"00dc", p)
        movi += c
        at += len(c)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", index)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


# ---------------------------------------------------------------- digests


def cv2_frames(path: Path) -> list:
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return out


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from quan_ultralytics_tpu_torch.data.native import video

    OUT.mkdir(exist_ok=True)
    small = small_frames()
    files = {}
    for suffix in ("mp4", "mov", "m4v", "avi", "mkv"):
        files[f"mp4v_64x48.{suffix}"] = ("mp4v", small)
    files["xvid_64x48.avi"] = ("XVID", small)
    files["mjpg_64x48.avi"] = ("MJPG", small)
    files["mjpg_64x48.mkv"] = ("MJPG", small)
    files["vp8_64x48.webm"] = ("VP80", small)
    for suffix in ("webm", "mkv", "avi"):
        files[f"vp9_64x48.{suffix}"] = ("VP90", small[:4])
    files["vp9_64x48.mp4"] = ("vp09", small[:4])
    files["ffv1_64x48.avi"] = ("FFV1", small[:4])
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        track = chip_smoke.make_clip(Path(tmp))
    files["track_640x480.mp4"] = ("mp4v", track)
    files["track_640x480.avi"] = ("MJPG", track)
    files["track_640x480.webm"] = ("VP80", track)
    files["track_640x480_vp9.webm"] = ("VP90", track)
    for name, (fourcc, frames) in files.items():
        write_cv2(OUT / name, fourcc, frames)
    tools = tools_frames()
    packets = encode_mpeg4(tools, TOOLS_OPTIONS)
    packets.insert(5, NOT_CODED_VOP)
    write_avi(OUT / "mpeg4_tools_88x40.avi", packets, TOOLS[1], TOOLS[0], b"FMP4")
    for name, options in ASP_OPTIONS.items():
        write_avi(OUT / name, encode_mpeg4(tools, {"g": "12", **options}), TOOLS[1], TOOLS[0], b"FMP4")
    asp = encode_mpeg4(tools, {"g": "12", **ASP_OPTIONS["mpeg4_asp_88x40.avi"]})
    for name, user, fourcc, packed in TAGGED:
        tagged = set_user_data(asp, user)
        write_avi(OUT / name, pack_b_frames(tagged) if packed else tagged, TOOLS[1], TOOLS[0], fourcc)
    vp8_frames = small_frames(VP8_CLIPS, SMALL, seed=7)
    for name, options in VP8_OPTIONS.items():
        write_avi(OUT / name, encode_vp8(vp8_frames, {"g": "12", **options}), SMALL[1], SMALL[0], b"VP80")
    for name, (hw, options) in VP9_OPTIONS.items():
        packets = encode_vp9(small_frames(VP9_FRAMES, hw, seed=9), {"g": "12", **options})
        writer = {".mkv": write_mkv, ".mp4": write_mp4}.get(Path(name).suffix)
        if writer:
            writer(OUT / name, packets, hw[1], hw[0])
        else:
            write_avi(OUT / name, packets, hw[1], hw[0], b"VP90")
    name, hw, options = VP9_TWO_PASS
    write_mkv(OUT / name, encode_vp9_two_pass(small_frames(24, hw, seed=2), options), hw[1], hw[0])
    name, hw, options = VP9_BILINEAR
    size = (hw[1], hw[0])
    packets = encode_vp9(small_frames(VP9_FRAMES, hw, seed=5), {"g": "12", **options})
    write_mkv(OUT / name, [bilinear_frame(p, size) if "filter_at" in vp9_header(p, size) else p for p in packets],
              *size)
    resilient = encode_vp9(small_frames(VP9_FRAMES, SMALL, seed=9), {"g": "12", "crf": "30", "b": "0",
                                                                     "error-resilient": "1"})
    write_mkv(OUT / "vp9_crafted_64x48.mkv", vp9_crafted(resilient, (SMALL[1], SMALL[0])), SMALL[1], SMALL[0])
    clip = set_user_data(encode_mpeg4(track, {"g": "12", **CLIP_ASP}), b"XviD0064")
    write_avi(OUT / "track_640x480_xvid.avi", clip, track[0].shape[1], track[0].shape[0], b"XVID")
    h263_fixtures(track)
    wmv_fixtures(track)

    write_digests()


def main_h263() -> None:
    """``--h263``: only the H.263 family's fixtures, then every digest."""
    sys.path.insert(0, str(REPO))
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        track = chip_smoke.make_clip(Path(tmp))
    h263_fixtures(track)
    write_digests()


def main_wmv() -> None:
    """``--wmv``: only the WMV and Annex J fixtures, then every digest."""
    sys.path.insert(0, str(REPO))
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        track = chip_smoke.make_clip(Path(tmp))
    wmv_fixtures(track)
    write_digests()


def write_digests() -> None:
    """``video_fixtures.json`` from the files in ``OUT``."""
    sys.path.insert(0, str(REPO))
    from quan_ultralytics_tpu_torch.data.native import video

    out = {}
    for path in sorted(OUT.iterdir()):
        ref = cv2_frames(path)
        entry = {"frames": len(ref), "shape": list(ref[0].shape) if ref else None}
        try:
            stream = video.demux(path)
            entry.update(codec=stream.codec, container=stream.container)
            mine = list(video.frames(path))
        except NotImplementedError as e:
            entry.update(refused=str(e).replace(str(path), path.name))
            out[path.name] = entry
            continue
        assert len(mine) == len(ref), (path.name, len(mine), len(ref))
        entry["per_frame"] = [{"cv2": sha(r), "port": sha(m),
                               "max_diff": int(np.abs(m.astype(int) - r).max()),
                               "share_differ": float((m != r).mean())} for m, r in zip(mine, ref)]
        out[path.name] = entry
    DIGESTS.write_text(json.dumps(out, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(out)} fixtures, {total} bytes")


if __name__ == "__main__":
    main_h263() if "--h263" in sys.argv else main_wmv() if "--wmv" in sys.argv else main()
