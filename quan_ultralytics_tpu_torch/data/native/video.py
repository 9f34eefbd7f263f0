"""Video files on the host, without OpenCV or FFmpeg: demuxers in Python and
decoders in C++ (``video.cpp``).

The port's counterpart of ``cv2.VideoCapture(path)`` read frame by frame and
each frame ``cvtColor(BGR2RGB)``: `frames` yields RGB ``uint8 [h, w, 3]``
arrays with the pixels OpenCV 5.0's FFmpeg capture gives.

Demuxers (`demux`), each giving the first video track's codec, its decoder
configuration and its packets in decode order, each packet the bytes FFmpeg's
demuxer returns for it (``cv2.VideoCapture`` with ``CAP_PROP_FORMAT = -1``):

* ISO-BMFF (``.mp4``, ``.mov``, ``.m4v``): ``moov`` before or after ``mdat``,
  the sample tables (``stsd``, ``stsz``, ``stsc``, ``stco``/``co64``), an MPEG-4
  Part 2 track's decoder configuration from its ``esds``, a ``vp09`` track's
  profile and bit depth from its ``vpcC``. A fragmented file
  (``moof``) or an edit list other than the identity raises
  `NotImplementedError`.
* RIFF AVI (``.avi``): the ``movi`` list's ``##dc``/``##db`` chunks in file
  order, inside ``LIST rec `` and across OpenDML ``RIFF AVIX`` extensions; the
  BITMAPINFOHEADER's compression fourcc mapped to a codec as FFmpeg's
  ``riff.c`` maps it (``VP80`` to VP8, ``VP90`` to VP9, ``H263``/``U263``/
  ``FLV1``/``MP42``/``DIV3``/``WMV1``/``WMV2`` and their aliases to the
  H.263 family), its frame size (MS-MPEG4 carries none in its bitstream)
  and the bytes after it (WMV2's ext header).
* Matroska/WebM (``.mkv``, ``.webm``): EBML ``Segment`` -> ``Tracks``
  (``CodecID``, ``CodecPrivate``; ``V_VP8`` is VP8, ``V_VP9`` VP9, whose
  ``CodecPrivate`` features change no decoding) and ``Cluster`` ->
  ``SimpleBlock`` / ``BlockGroup`` blocks; ``V_MS/VFW/FOURCC`` tracks by
  their BITMAPINFOHEADER as in AVI; laced blocks and content encodings
  raise `NotImplementedError`.

Codecs, decoded in C++ with FFmpeg's reconstruction (see ``video.cpp``):
Motion-JPEG; MPEG-4 Part 2 Simple and Advanced Simple Profile (B-VOPs, given
in display order, quarter-pel, MPEG quantisation; the streams of the Xvid and
DivX encoders with the Xvid IDCT and FFmpeg's workarounds, DivX's packed
B-VOPs); VP8 (``vp8.h``, key and inter frames, profiles 0-3); VP9 profile 0
(``vp9.h``: superframes, hidden frames and show_existing_frame, so that a
packet may give more than one frame or none); MPEG-4 data partitioning; the
H.263 family (H.263 and H.263+ with the deblocking filter and no other
optional annex, Sorenson H.263, MS-MPEG4 v2 and v3 with the tables of
``msmpeg4_tables.h``, WMV1 and WMV2 with those of ``wmv_tables.h``). Any
other codec (H.264, HEVC, AV1, FFV1, MS-MPEG4 v1, ...), VP9's profiles 1-3
and scaled references, the H.263+ annexes but J, WMV2's IntraX8 J-frames
and a WMV2 stream without its ext header, and the MPEG-4 tools still refused (interlace, GMC/sprites, RVLC,
...) raise a
`NotImplementedError` that names them, as does a frame whose size changed
mid-stream (OpenCV scales it). A missing file, or one no demuxer takes,
yields no frames, as ``cv2.VideoCapture`` reads none; a stream damaged part
way yields the frames decoded before the damage.

``video.cpp`` (with ``msmpeg4_tables.h``, ``wmv_tables.h``, ``vp8.h`` and ``vp9.h``) is compiled with ``g++`` at first use into
``build/`` beside the image reader's library, keyed by a hash of its sources
and flags, under the same file lock (`utils.native_build`). A failed build
raises.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from quan_ultralytics_tpu_torch.utils.native_build import BUILD_DIR, build_cxx

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "video.cpp"
# video.cpp includes the JPEG reader's entropy decoding, the Annex K tables, the MS-MPEG4 and WMV tables and
# the VP8 and VP9 cores
DEPENDS = (HERE / "imread.cpp", HERE / "jpeg_tables.h", HERE / "msmpeg4_tables.h", HERE / "wmv_tables.h",
           HERE / "vp8.h", HERE / "webp_tables.h", HERE / "vp9.h", HERE / "vp9_tables.h")
LIB_NAME = "libquan_torch_video.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

MPEG4, MJPEG, VP8, VP9 = "mpeg4", "mjpeg", "vp8", "vp9"
H263, H263P, FLV1, MSMPEG4V2, MSMPEG4V3 = "h263", "h263p", "flv1", "msmpeg4v2", "msmpeg4v3"
WMV1, WMV2 = "wmv1", "wmv2"
_CODEC_IDS = {MJPEG: 1, MPEG4: 2, VP8: 3, VP9: 4, H263: 5, H263P: 5, FLV1: 6, MSMPEG4V2: 7, MSMPEG4V3: 8, WMV1: 9,
              WMV2: 10}

# FFmpeg riff.c ff_codec_bmp_tags: the BITMAPINFOHEADER fourccs of the two codecs
_RIFF_MPEG4 = {b"FMP4", b"DIVX", b"DX50", b"XVID", b"MP4S", b"M4S2", b"MP4V", b"DIV1", b"BLZ0", b"UMP4",
               b"WV1F", b"SEDG", b"RMP4", b"3IV2", b"WAWV", b"FFDS", b"FVFW", b"DCOD", b"MVXM", b"PM4V",
               b"SMP4", b"DXGM", b"VIDM", b"M4T3", b"GEOX", b"HDX4", b"DMK2", b"DIGI", b"INMC", b"EPHV",
               b"EM4A", b"M4CC", b"SN40", b"VSPX", b"ULDX", b"GEOV", b"SIPP", b"SM4V", b"XVIX", b"DREX",
               b"QMP4", b"PLV1", b"GLV4", b"GMP4", b"MNM4", b"GTM4"}
_RIFF_MJPEG = {b"MJPG", b"LJPG", b"DMB1", b"MJPA", b"JR24", b"AVRN", b"ACDV", b"QIVG", b"SLMJ", b"CJPG",
               b"IJLV", b"MVJP", b"AVI1", b"AVI2", b"MTSJ", b"ZJPG", b"MMJP"}
# ff_codec_bmp_tags' fourccs of the H.263 family
_RIFF_H263 = {b"H263": H263, b"X263": H263, b"T263": H263, b"L263": H263, b"VX1K": H263, b"ZYGO": H263,
              b"M263": H263, b"U263": H263P, b"FLV1": FLV1, b"MP42": MSMPEG4V2, b"DIV2": MSMPEG4V2,
              b"DIV3": MSMPEG4V3, b"MPG3": MSMPEG4V3, b"DIV4": MSMPEG4V3, b"DIV5": MSMPEG4V3, b"DIV6": MSMPEG4V3,
              b"DVX3": MSMPEG4V3, b"AP41": MSMPEG4V3, b"COL0": MSMPEG4V3, b"COL1": MSMPEG4V3, b"WMV1": WMV1,
              b"WMV2": WMV2}
# names of codecs met in these containers that the port does not decode
_OTHER = {b"MP41": "MS-MPEG4 v1", b"MPG4": "MS-MPEG4 v1", b"I263": "Intel H.263", b"H264": "H.264",
          b"X264": "H.264", b"AVC1": "H.264", b"HEVC": "HEVC", b"HVC1": "HEVC", b"HEV1": "HEVC", b"AV01": "AV1", b"MPG2": "MPEG-2", b"MPG1": "MPEG-1", b"WMV3": "WMV3",
          b"WVC1": "VC-1", b"THEO": "Theora", b"FFV1": "FFV1", b"HFYU": "HuffYUV", b"FFVH": "HuffYUV",
          b"ULRG": "Ut Video", b"ULY0": "Ut Video", b"ULY2": "Ut Video", b"ULH0": "Ut Video"}
_MKV_OTHER = {"V_AV1": "AV1", "V_MPEG4/ISO/AVC": "H.264", "V_FFV1": "FFV1",
              "V_MPEGH/ISO/HEVC": "HEVC", "V_MPEG2": "MPEG-2", "V_MPEG1": "MPEG-1", "V_THEORA": "Theora"}

PathLike = Union[str, Path]


class Unreadable(Exception):
    """A file that no demuxer takes: ``cv2.VideoCapture`` would not open it."""


@dataclass
class Demuxed:
    """The first video track of a file."""

    codec: str  # MPEG4, MJPEG, VP8, VP9 or one of the H.263 family
    private: bytes  # decoder configuration (MPEG-4's VOS/VOL headers, WMV2's ext header), may be empty
    packets: List[bytes] = field(default_factory=list)  # in decode order
    tag: bytes = b""  # the container's fourcc for the codec, upper case
    container: str = ""
    size: Tuple[int, int] = (0, 0)  # (width, height) from a BITMAPINFOHEADER, (0, 0) where there is none


def _refuse(path: PathLike, container: str, what: str) -> NotImplementedError:
    return NotImplementedError(f"{path}: {what} in {container} is not supported by the port's video reader")


# ---------------------------------------------------------------- ISO-BMFF


def _boxes(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, box end) of each box in ``data[start:end]``; a box
    running past ``end`` ends the walk."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            yield kind, pos + head, -1  # truncated: the caller decides
            return
        yield kind, pos + head, pos + size
        pos += size


def _child(data: bytes, start: int, end: int, kind: bytes) -> Optional[Tuple[int, int]]:
    for k, s, e in _boxes(data, start, end):
        if k == kind and e >= 0:
            return s, e
    return None


def _read(fmt: str, data: bytes, pos: int, end: int) -> tuple:
    """``struct.unpack_from(fmt, data, pos)``; `Unreadable` where the field
    runs past ``end``, the end of the box or chunk that holds it."""
    if pos < 0 or pos + struct.calcsize(fmt) > min(end, len(data)):
        raise Unreadable(f"a field at byte {pos} runs past the end of its box at {end}")
    return struct.unpack_from(fmt, data, pos)


def _descriptor(data: bytes, pos: int, end: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 systems descriptor in ``data[pos:end]``."""
    tag = _read("B", data, pos, end)[0]
    pos += 1
    size = 0
    for _ in range(4):
        b = _read("B", data, pos, end)[0]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, min(pos + size, end)


def _esds_config(data: bytes, s: int, e: int) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` box."""
    tag, p, end = _descriptor(data, s + 4, e)  # after the full box's version and flags
    if tag != 3:
        return 0, b""
    flags = _read("B", data, p + 2, end)[0]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + _read("B", data, p, end)[0]
    if flags & 0x20:
        p += 2
    tag, p, end = _descriptor(data, p, end)
    if tag != 4:
        return 0, b""
    object_type = _read("B", data, p, end)[0]
    p += 13
    while p < end:
        tag, q, qe = _descriptor(data, p, end)
        if tag == 5:
            return object_type, bytes(data[q:qe])
        p = qe
    return object_type, b""


def _demux_mp4(data: bytes, path: PathLike) -> Demuxed:
    moov = None
    for kind, s, e in _boxes(data, 0, len(data)):
        if kind == b"moof":
            raise _refuse(path, "ISO-BMFF", "a fragmented file (moof)")
        if kind == b"moov":
            if e < 0:
                raise Unreadable("the moov box is truncated")
            moov = (s, e)
    if moov is None:
        raise Unreadable("no moov box")
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak" or e < 0:
            continue
        mdia = _child(data, s, e, b"mdia")
        hdlr = mdia and _child(data, *mdia, b"hdlr")
        if not hdlr or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        edts = _child(data, s, e, b"edts")
        elst = edts and _child(data, *edts, b"elst")
        if elst:
            _check_edit_list(data, *elst, path)
        minf = _child(data, *mdia, b"minf")
        stbl = minf and _child(data, *minf, b"stbl")
        if not stbl:
            raise Unreadable("the video track has no minf/stbl box")
        return _mp4_track(data, stbl, path)
    raise Unreadable("no video track")


def _check_edit_list(data: bytes, s: int, e: int, path: PathLike) -> None:
    version, count = _read(">B3xI", data, s, e)
    entries = []
    p = s + 8
    for _ in range(count):
        media_time, rate = _read(">8xqi" if version == 1 else ">4xii", data, p, e)
        p += 20 if version == 1 else 12
        entries.append((media_time, rate))
    if entries and entries != [(0, 1 << 16)]:
        raise _refuse(path, "ISO-BMFF", f"an edit list other than the identity {entries}")


def _mp4_track(data: bytes, stbl: Tuple[int, int], path: PathLike) -> Demuxed:
    def box(kind: bytes) -> Optional[Tuple[int, int]]:
        return _child(data, *stbl, kind)

    stsd = box(b"stsd")
    if stsd is None:
        raise Unreadable("no sample description")
    entry = stsd[0] + 8
    entry_size, fmt = _read(">I4s", data, entry, stsd[1])
    private, codec = b"", None
    if fmt == b"mp4v":
        esds = _child(data, entry + 8 + 78, min(entry + entry_size, stsd[1]), b"esds")
        object_type, private = _esds_config(data, *esds) if esds else (0x20, b"")
        if object_type in (0x20, 0):
            codec = MPEG4
        elif object_type == 0x6C:
            codec = MJPEG
        else:
            raise _refuse(path, "ISO-BMFF", f"object type 0x{object_type:02x} in mp4v")
    elif fmt in (b"jpeg", b"mjpa"):
        codec = MJPEG
    elif fmt == b"vp09":
        codec = VP9
        vpcc = _child(data, entry + 8 + 78, min(entry + entry_size, stsd[1]), b"vpcC")
        if vpcc:
            profile, _, depth = _read(">BBB", data, vpcc[0] + 4, vpcc[1])
            if profile != 0 or depth >> 4 != 8:
                raise _refuse(path, "ISO-BMFF", f"VP9 profile {profile} at {depth >> 4} bits (vpcC)")
    else:
        name = _OTHER.get(fmt.upper(), fmt.decode("latin-1"))
        raise _refuse(path, "ISO-BMFF", f"the {name} codec ({fmt.decode('latin-1')})")
    stsz, stsc = box(b"stsz"), box(b"stsc")
    stco, co64 = box(b"stco"), box(b"co64")
    if stsz is None or stsc is None or (stco is None and co64 is None):
        raise Unreadable("incomplete sample table")
    uniform, count = _read(">4xII", data, stsz[0], stsz[1])
    sizes = None if uniform else _read(f">{count}I", data, stsz[0] + 12, stsz[1])
    if co64 is not None:
        n = _read(">4xI", data, co64[0], co64[1])[0]
        offsets = _read(f">{n}Q", data, co64[0] + 8, co64[1])
    else:
        n = _read(">4xI", data, stco[0], stco[1])[0]
        offsets = _read(f">{n}I", data, stco[0] + 8, stco[1])
    runs = _read(">4xI", data, stsc[0], stsc[1])[0]
    table = [_read(">III", data, stsc[0] + 8 + 12 * i, stsc[1]) for i in range(runs)]
    packets, sample = [], 0
    for i, (first, per_chunk, _) in enumerate(table):
        if first < 1:
            raise Unreadable(f"sample-to-chunk entry {i} starts at chunk {first}")
        # as FFmpeg's mov.c, only the chunks that stco/co64 lists
        last = min(table[i + 1][0] - 1 if i + 1 < len(table) else len(offsets), len(offsets))
        for chunk in range(first - 1, last):
            at = offsets[chunk]
            for _ in range(per_chunk):
                if sample >= count:
                    break
                size = uniform or sizes[sample]
                if at + size > len(data):  # truncated: keep the whole samples
                    return Demuxed(codec, private, packets, fmt.upper(), "ISO-BMFF")
                packets.append(data[at:at + size])
                at += size
                sample += 1
    return Demuxed(codec, private, packets, fmt.upper(), "ISO-BMFF")


# ---------------------------------------------------------------- AVI


def _demux_avi(data: bytes, path: PathLike) -> Demuxed:
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise Unreadable("not an AVI file")
    video, tag, private, packets = None, b"", b"", []
    stream, frame_size = -1, (0, 0)

    def walk(start: int, end: int, in_movi: bool) -> None:
        nonlocal video, tag, private, stream, frame_size
        pos = start
        while pos + 8 <= end:
            kind, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if body + size > end:  # a truncated chunk ends the file
                if kind in (b"LIST", b"RIFF") and body + 4 <= end:
                    walk(body + 4, end, in_movi or data[body:body + 4] == b"movi")
                return
            if kind in (b"LIST", b"RIFF"):
                sub = data[body:body + 4]
                walk(body + 4, body + size, in_movi or sub == b"movi")
            elif kind == b"strh":
                stream += 1
                if data[body:body + 4] == b"vids" and video is None:
                    video = stream
            elif kind == b"strf" and video == stream and not tag:
                tag = data[body + 16:body + 20]
                if size >= 12:
                    frame_size = struct.unpack("<ii", data[body + 4:body + 12])
                private = data[body + 40:body + size] if size > 40 else b""
            elif in_movi and video is not None and kind[:2] == b"%02d" % video and kind[2:] in (b"dc", b"db"):
                if size:
                    packets.append(data[body:body + size])
            pos = body + size + (size & 1)

    # the first RIFF list, then the RIFF AVIX extensions that follow it
    first_end = 8 + struct.unpack("<I", data[4:8])[0]
    walk(12, min(first_end, len(data)), False)
    pos = first_end + (first_end & 1)
    while pos + 12 <= len(data) and data[pos:pos + 4] == b"RIFF" and data[pos + 8:pos + 12] == b"AVIX":
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        walk(pos + 12, min(pos + 8 + size, len(data)), False)
        pos += 8 + size + (size & 1)
    if video is None:
        raise Unreadable("no video stream")
    upper = tag.upper()
    codec = _riff_codec(upper) or (MPEG4 if tag == b"mp4v" else None)
    if codec is None:
        name = _OTHER.get(upper, tag.decode("latin-1"))
        raise _refuse(path, "AVI", f"the {name} codec ({tag.decode('latin-1')})")
    return Demuxed(codec, private, packets, upper, "AVI", (frame_size[0], abs(frame_size[1])))


def _riff_codec(upper: bytes) -> Optional[str]:
    """The codec of a BITMAPINFOHEADER fourcc (upper case), as riff.c maps it, or None."""
    if upper in _RIFF_MPEG4:
        return MPEG4
    if upper in _RIFF_MJPEG:
        return MJPEG
    return {b"VP80": VP8, b"VP90": VP9}.get(upper) or _RIFF_H263.get(upper)


# ---------------------------------------------------------------- Matroska


_EBML, _SEGMENT, _TRACKS, _TRACK_ENTRY, _CLUSTER = 0x1A45DFA3, 0x18538067, 0x1654AE6B, 0xAE, 0x1F43B675
_TRACK_NUMBER, _TRACK_TYPE, _CODEC_ID, _CODEC_PRIVATE, _CONTENT_ENCODINGS = 0xD7, 0x83, 0x86, 0x63A2, 0x6D80
_SIMPLE_BLOCK, _BLOCK_GROUP, _BLOCK = 0xA3, 0xA0, 0xA1
_UNKNOWN = -1
# the Segment's children (Matroska's level 1: SeekHead, Info, Tracks, Cues, Chapters,
# Attachments, Tags, Cluster) and the file's top level (EBML, Segment)
_LEVEL1 = {0x114D9B74, 0x1549A966, _TRACKS, 0x1C53BB6B, 0x1043A770, 0x1941A469, 0x1254C367, _CLUSTER,
           _EBML, _SEGMENT}


def _vint(data: bytes, pos: int, strip: bool) -> Tuple[int, int]:
    """An EBML variable-size integer at ``pos``: (value, next position). With
    ``strip`` the length marker is removed (sizes); an all-ones size is _UNKNOWN."""
    if pos >= len(data) or not data[pos]:
        raise Unreadable(f"no EBML integer at byte {pos}")
    first = data[pos]
    length = 1
    while not first & (0x80 >> (length - 1)):
        length += 1
    if pos + length > len(data):
        raise Unreadable(f"the EBML integer at byte {pos} runs past the end of the file")
    value = first & ((0x80 >> (length - 1)) - 1) if strip else first
    for b in data[pos + 1:pos + length]:
        value = (value << 8) | b
    if strip and value == (1 << (7 * length)) - 1:
        value = _UNKNOWN
    return value, pos + length


def _header(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(id, size, payload start) of the EBML element at ``pos``."""
    ident, p = _vint(data, pos, False)
    size, p = _vint(data, p, True)
    return ident, size, p


def _cluster_end(data: bytes, start: int, end: int) -> int:
    """Where an unknown-size cluster whose payload starts at ``start`` ends:
    at its first child that is a top-level element, as FFmpeg's matroskadec
    ends it."""
    pos = start
    while pos < end:
        try:
            ident, size, p = _header(data, pos)
        except Unreadable:
            return end
        if ident in _LEVEL1 or size == _UNKNOWN:
            return pos
        pos = min(p + size, end)
    return end


def _elements(data: bytes, start: int, end: int) -> Iterator[Tuple[int, int, int]]:
    """(id, payload start, payload end) of each EBML element in ``data[start:end]``;
    an element of unknown size runs to ``end``, a cluster to `_cluster_end`."""
    pos = start
    while pos < end:
        try:
            ident, size, p = _header(data, pos)
        except Unreadable:  # damaged or cut: the elements before it
            return
        if size != _UNKNOWN:
            stop = min(p + size, end)
        else:
            stop = _cluster_end(data, p, end) if ident == _CLUSTER else end
        yield ident, p, stop
        pos = stop


def _demux_mkv(data: bytes, path: PathLike) -> Demuxed:
    if data[:4] != struct.pack(">I", _EBML):
        raise Unreadable("not a Matroska file")
    container = "Matroska"
    track, codec, private, tag, packets, size = None, None, b"", b"", [], (0, 0)
    for ident, s, e in _elements(data, 0, len(data)):
        if ident != _SEGMENT:
            continue
        for sid, ss, se in _elements(data, s, e):
            if sid == _TRACKS and track is None:
                for tid, ts, te in _elements(data, ss, se):
                    if tid != _TRACK_ENTRY:
                        continue
                    fields = {fid: data[fs:fe] for fid, fs, fe in _elements(data, ts, te)}
                    if int.from_bytes(fields.get(_TRACK_TYPE, b"\0"), "big") != 1:
                        continue
                    if _CONTENT_ENCODINGS in fields:
                        raise _refuse(path, container, "a track with content encodings")
                    track = int.from_bytes(fields.get(_TRACK_NUMBER, b"\1"), "big")
                    cid = fields.get(_CODEC_ID, b"").rstrip(b"\0").decode("latin-1")
                    private = fields.get(_CODEC_PRIVATE, b"")
                    if cid.startswith("V_MPEG4/ISO/") and cid not in ("V_MPEG4/ISO/AVC",):
                        codec, tag = MPEG4, b"MP4V"
                    elif cid == "V_MJPEG":
                        codec, tag = MJPEG, b"MJPG"
                    elif cid == "V_VP8":
                        codec, tag = VP8, b"VP80"
                    elif cid == "V_VP9":
                        codec, tag = VP9, b"VP90"
                    elif cid == "V_MS/VFW/FOURCC" and len(private) >= 40:
                        tag = private[16:20].upper()
                        codec = _riff_codec(tag)
                        if codec is None:
                            name = _OTHER.get(tag, tag.decode("latin-1"))
                            raise _refuse(path, container, f"the {name} codec ({tag.decode('latin-1')})")
                        size = struct.unpack("<ii", private[4:12])
                        size = (size[0], abs(size[1]))
                        private = private[40:]
                    else:
                        raise _refuse(path, container, f"the {_MKV_OTHER.get(cid, cid)} codec ({cid})")
                    break
            elif sid == _CLUSTER and track is not None:
                for cid_, cs, ce in _elements(data, ss, se):
                    if cid_ == _BLOCK_GROUP:
                        block = [(bs, be) for bid, bs, be in _elements(data, cs, ce) if bid == _BLOCK]
                        if not block:
                            continue
                        cs, ce = block[0]
                    elif cid_ != _SIMPLE_BLOCK:
                        continue
                    try:
                        number, p = _vint(data, cs, True)
                    except Unreadable:
                        continue
                    if number != track or p + 3 > ce:
                        continue
                    if data[p + 2] & 0x06:
                        raise _refuse(path, container, "a laced video block")
                    packets.append(data[p + 3:ce])
        break
    if track is None:
        raise Unreadable("no video track")
    return Demuxed(codec, private, packets, tag, container, size)


# ---------------------------------------------------------------- public


def demux(path: PathLike) -> Demuxed:
    """The first video track of ``path``, whose container is told by its
    first bytes. Raises `Unreadable` for a file no demuxer takes and
    `NotImplementedError` for a codec or container feature not supported."""
    data = Path(path).read_bytes()
    try:
        if data[:4] == b"RIFF":
            return _demux_avi(data, path)
        if data[:4] == struct.pack(">I", _EBML):
            return _demux_mkv(data, path)
        if data[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip", b"pnot"):
            return _demux_mp4(data, path)
        raise Unreadable("not an ISO-BMFF, AVI or Matroska file")
    except Unreadable as e:
        raise Unreadable(f"{path}: {e}") from None


_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``video.cpp`` if its sources or flags changed; return the library path."""
    return build_cxx(SOURCE, LIB_NAME, CXX_FLAGS, BUILD_DIR, depends=DEPENDS)


def library() -> ctypes.CDLL:
    """The loaded decoder library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, u8p, ip = ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
        lib.vdec_open.argtypes = [ctypes.c_int, u8p, ctypes.c_long, ctypes.c_uint32]
        lib.vdec_open.restype = vp
        lib.vdec_send.argtypes = [vp, u8p, ctypes.c_long]
        lib.vdec_flush.argtypes = [vp]
        lib.vdec_next.argtypes = [vp]
        lib.vdec_size.argtypes = [vp, ip, ip]
        lib.vdec_rgb.argtypes = [vp, vp]
        lib.vdec_stats.argtypes = [vp, vp]
        for fn in (lib.vdec_send, lib.vdec_flush, lib.vdec_next, lib.vdec_size, lib.vdec_rgb, lib.vdec_stats):
            fn.restype = ctypes.c_int
        lib.vdec_close.argtypes = [vp]
        lib.vdec_close.restype = None
        lib.vdec_set_size.argtypes = [vp, ctypes.c_int, ctypes.c_int]
        lib.vdec_set_size.restype = None
        lib.vdec_error.argtypes = [vp, ctypes.c_int]
        lib.vdec_error.restype = ctypes.c_char_p
        lib.vdec_trace.argtypes = [vp, vp, ctypes.c_long]
        lib.vdec_trace.restype = ctypes.c_long
        _lib = lib
    return _lib


FRAME, NO_FRAME = 0, 1  # vdec_send's statuses that are not errors
# video.cpp's counts of the MPEG-4 coding tools a stream used (its Stat enum), read by tests only
_TOOL_COUNTS = ("i_vops", "p_vops", "not_coded_vops", "skipped_mbs", "intra_mbs_in_p", "four_mv_mbs", "dquant",
                "video_packets", "escape1", "escape2", "escape3", "ac_pred_mbs", "dc_as_ac", "no_rounding_mbs",
                "ac_rescaled", "b_vops", "b_direct_mbs", "b_forward_mbs", "b_backward_mbs", "b_interpolated_mbs",
                "b_colocated_skips", "dbquant", "qpel_mbs", "mpeg_quant_blocks", "xvid_idct_blocks", "packed_b_vops",
                "skipped_b_vops", "partitioned_packets", "gob_headers", "flv_escapes", "mv_escapes",
                "droppable_frames", "inter_intra_pictures", "inter_intra_mbs", "per_mb_rl_pictures", "skip_maps",
                "mspel_pictures", "hshift_mbs", "loop_filtered_mbs", "wmv_escape3_lengths", "skipped_pictures",
                "abt_blocks", "top_left_mvs")
# vp9.h's counts (its Stat enum)
_VP9_TOOL_COUNTS = ("key_frames", "inter_frames", "intra_only_frames", "hidden_frames", "show_existing",
                    "superframes", "tx4x4", "tx8x8", "tx16x16", "tx32x32", "dct_dct", "dct_adst", "adst_dct",
                    "adst_adst", "wht", "mode_v", "mode_h", "mode_dc", "mode_d45", "mode_d135", "mode_d117",
                    "mode_d153", "mode_d63", "mode_d207", "mode_tm", "filter_regular", "filter_smooth",
                    "filter_sharp", "filter_bilinear", "compound", "sub8x8", "newmv", "multi_tile_frames",
                    "segmented_frames", "lossless_frames", "adapted_frames", "loop_filtered_frames",
                    "prev_frame_mvs", "error_resilient_frames", "full_range_frames")
_NOT_IMPLEMENTED = 2  # vdec_send: a tool the decoder refuses (the message names it)


class Decoder:
    """One stream's decoder: `send` a packet, then read the frame it completed;
    `flush` at the end of the stream."""

    def __init__(self, codec: str, private: bytes = b"", tag: bytes = b"", size: Tuple[int, int] = (0, 0)):
        self.lib = library()
        self.codec = codec
        tag32 = struct.unpack("<I", (tag + b"\0\0\0\0")[:4])[0]
        self.handle = self.lib.vdec_open(_CODEC_IDS[codec], private, len(private), tag32)
        if not self.handle:
            raise MemoryError("vdec_open failed")
        self.lib.vdec_set_size(self.handle, *size)  # (width, height): MS-MPEG4's frame size is the container's

    def send(self, packet: bytes) -> bool:
        """Decode ``packet``; True if it completed a frame. Raises
        `NotImplementedError` for a refused tool, `ValueError` for damaged data."""
        st = self.lib.vdec_send(self.handle, packet, len(packet))
        if st in (FRAME, NO_FRAME):
            return st == FRAME
        msg = self.lib.vdec_error(self.handle, st).decode()
        raise NotImplementedError(msg) if st == _NOT_IMPLEMENTED else ValueError(msg)

    def next(self) -> bool:
        """True if the last packet shows another frame (a VP9 superframe, or a
        frame followed by show_existing_frame), which `rgb` then gives."""
        return self.lib.vdec_next(self.handle) == FRAME

    def flush(self) -> bool:
        """The end of the stream: True if it completed a frame held back for
        display order (the last reference of a stream with B-VOPs)."""
        return self.lib.vdec_flush(self.handle) == FRAME

    def size(self) -> Tuple[int, int]:
        h, w = ctypes.c_int(), ctypes.c_int()
        self.lib.vdec_size(self.handle, ctypes.byref(h), ctypes.byref(w))
        return h.value, w.value

    def rgb(self) -> np.ndarray:
        """The last frame as RGB ``uint8 [h, w, 3]``, converted as FFmpeg's
        swscale converts it to BGR24 for OpenCV."""
        h, w = self.size()
        out = np.empty((h, w, 3), np.uint8)
        st = self.lib.vdec_rgb(self.handle, out.ctypes.data)
        if st:
            raise NotImplementedError(self.lib.vdec_error(self.handle, st).decode())
        return out

    def _tool_counts(self) -> dict:
        """How often each coding tool (`_TOOL_COUNTS` for MPEG-4,
        `_VP9_TOOL_COUNTS` for VP9) was met so far: for tests, to tell which
        tools a fixture reaches."""
        out = np.zeros(64, np.int64)
        n = self.lib.vdec_stats(self.handle, out.ctypes.data)
        return dict(zip(_VP9_TOOL_COUNTS if self.codec == VP9 else _TOOL_COUNTS, out[:n].tolist()))

    def _start_trace(self) -> None:
        """MS-MPEG4 and WMV, for tests: record where each picture and
        macroblock lies in its packet from the next packet on (`_trace`)."""
        self.lib.vdec_trace(self.handle, None, 0)

    def _trace(self) -> np.ndarray:
        """The record `_start_trace` began: ``int64 [n, 24]`` rows, as
        ``video.cpp``'s ``H263::trace`` describes them."""
        n = self.lib.vdec_trace(self.handle, np.zeros(1, np.int64).ctypes.data, 0)
        out = np.zeros(n, np.int64)
        self.lib.vdec_trace(self.handle, out.ctypes.data, n)
        return out.reshape(-1, 24)

    def close(self) -> None:
        if self.handle:
            self.lib.vdec_close(self.handle)
            self.handle = None

    def __del__(self) -> None:
        self.close()


def frames(path: PathLike) -> Iterator[np.ndarray]:
    """RGB ``uint8 [h, w, 3]`` frames of a video file in display order (the
    reference a stream with B-VOPs holds back comes out at the end, from
    `Decoder.flush`), as ``cv2.VideoCapture`` + ``cvtColor(BGR2RGB)`` gives
    them. A missing or
    unreadable file yields nothing; a stream damaged part way yields the
    frames before the damage; an unsupported codec or tool raises
    `NotImplementedError`."""
    try:
        stream = demux(path)
    except (OSError, Unreadable):
        return
    where = f"{path} ({stream.container}, {stream.codec})"
    dec = Decoder(stream.codec, stream.private, stream.tag, stream.size)
    try:
        for packet in stream.packets:
            try:  # a VP9 packet may show more than one frame
                got = [dec.rgb()] if dec.send(packet) else []
                while got and dec.next():
                    got.append(dec.rgb())
            except NotImplementedError as e:
                raise NotImplementedError(f"{where}: {e}") from None
            except ValueError:  # damaged data: the frames so far, as FFmpeg's capture stops
                return
            yield from got
        try:
            frame = dec.rgb() if dec.flush() else None
        except NotImplementedError as e:
            raise NotImplementedError(f"{where}: {e}") from None
        if frame is not None:
            yield frame
    finally:
        dec.close()
