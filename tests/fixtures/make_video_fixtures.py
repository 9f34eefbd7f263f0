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
  ``MJPG`` into ``.avi`` and ``.mkv``, VP8 into ``.webm`` and VP9 into
  ``vp9_64x48.webm`` (a codec the port refuses by name).
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
  ``chip_smoke.make_clip`` as ``mp4v`` MP4, ``MJPG`` AVI and ``VP80`` WebM;
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

import cv2
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
MPEG4, LIBVPX = 12, 139  # AVCodecID of libavcodec's MPEG-4 encoder and of its libvpx VP8 wrapper
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
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {path.name} with {fourcc}")
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


# ---------------------------------------------------------------- libavcodec's own encoder


def _libs() -> dict:
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


def encode(frames: list, options: dict, codec_id: int) -> list:
    """Packets of the libavcodec encoder ``codec_id`` for RGB ``frames`` (a
    height that is a multiple of 4), as `encode_mpeg4` describes."""
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
    if avc.avcodec_open2(ctx, codec, None):
        raise RuntimeError("avcodec_open2 failed")
    frame, pkt, out = avu.av_frame_alloc(), avc.av_packet_alloc(), []
    (ctypes.c_int * 4).from_address(frame + 104)[:] = [w, h, 0, 0]  # AVFrame width, height, nb_samples, format
    assert avu.av_frame_get_buffer(frame, 0) == 0

    def drain():
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            data, size = ctypes.c_void_p.from_address(pkt + 24).value, ctypes.c_int.from_address(pkt + 32).value
            out.append(ctypes.string_at(data, size))
            avc.av_packet_unref(pkt)

    for i, im in enumerate(frames):
        yuv = cv2.cvtColor(np.ascontiguousarray(im), cv2.COLOR_RGB2YUV_I420)
        planes = [yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2), yuv[h + h // 4:].reshape(h // 2, w // 2)]
        assert avu.av_frame_make_writable(frame) == 0
        data, lines = (ctypes.c_void_p * 8).from_address(frame), (ctypes.c_int * 8).from_address(frame + 64)
        for p, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane)
            for r in range(plane.shape[0]):
                ctypes.memmove(data[p] + r * lines[p], plane[r].ctypes.data, plane.shape[1])
        ctypes.c_int64.from_address(frame + 136).value = i  # AVFrame.pts
        assert avc.avcodec_send_frame(ctx, frame) == 0
        drain()
    avc.avcodec_send_frame(ctx, None)
    drain()
    return out


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


def write_avi(path: Path, packets: list, w: int, h: int, fourcc: bytes, fps: int = 25) -> None:
    """A minimal AVI 1.0 file: one video stream of ``packets`` as ``00dc``
    chunks, with an ``idx1`` index."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")

    def lst(kind: bytes, body: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body

    n, biggest = len(packets), max(map(len, packets))
    avih = struct.pack("<IIIIIIIIII4I", 1000000 // fps, 0, 0, 0x10, n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n, biggest,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
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
    files["vp9_64x48.webm"] = ("VP90", small[:4])
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        track = chip_smoke.make_clip(Path(tmp))
    files["track_640x480.mp4"] = ("mp4v", track)
    files["track_640x480.avi"] = ("MJPG", track)
    files["track_640x480.webm"] = ("VP80", track)
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
    clip = set_user_data(encode_mpeg4(track, {"g": "12", **CLIP_ASP}), b"XviD0064")
    write_avi(OUT / "track_640x480_xvid.avi", clip, track[0].shape[1], track[0].shape[0], b"XVID")

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
    main()
