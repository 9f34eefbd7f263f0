"""Run chip_smoke.py's phase 1 and its video phases (58-60, 64-66, 70-72 and 74-77) alone, on one card.

    python3 scripts/video_phases.py

Phase 1 builds the kernels and the host libraries (``video.cpp`` with
``vp8.h`` and ``vp9.h`` among them); phase 58 decodes the Motion-JPEG and MPEG-4 Simple
Profile fixtures against their digests and times the 640 x 480 MPEG-4 and
Motion-JPEG clips; phase 59 runs ``detect track`` of the MPEG-4 clip through
the CLI and ``YOLO.track`` of it with BoT-SORT; phase 60 runs ``obb predict``
of it at 1024. Phase 64 decodes the VP8 and MPEG-4 Advanced Simple Profile
fixtures and times the clip as VP8 WebM and as an Xvid ASP AVI; phases 65
and 66 repeat 59 on the VP8 WebM and 60 on the Xvid AVI. Phase 70 decodes the
VP9 fixtures (and the FFV1 refusal) and times the clip as VP9 WebM; phases 71
and 72 repeat 59 on the VP9 WebM and 60 on its packets put into MP4. Phase
74 decodes the H.263 family's fixtures (H.263, H.263+, Sorenson, MS-MPEG4 v2
and v3, MPEG-4 data partitioning) and times the clip as DIV3 beside VP8 and
VP9; phase 75 repeats 59 and 60 on the DIV3 AVI. Phase 76 decodes the WMV1,
WMV2 and H.263+ Annex J fixtures and times the clip as WMV2 beside DIV3;
phase 77 repeats 59 and 60 on the WMV2 AVI.
Exits non-zero without a card, or when a phase fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("video_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card, _, _ = cs.phase_device()
    for name, fn in (("58", cs.phase_video_decode), ("64", cs.phase_video_asp_vp8_decode),
                     ("70", cs.phase_video_vp9_decode), ("74", cs.phase_video_h263_decode),
                     ("76", cs.phase_video_wmv_decode)):
        t0 = time.perf_counter()
        fn(card)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, fn, clip in (("59", cs.phase_video_track, cs.VIDEO_CLIP), ("60", cs.phase_video_predict, cs.VIDEO_CLIP),
                           ("65", cs.phase_video_track, cs.VIDEO_VP8_CLIP),
                           ("66", cs.phase_video_predict, cs.VIDEO_ASP_CLIP),
                           ("71", cs.phase_video_track, cs.VIDEO_VP9_CLIP),
                           ("72", cs.phase_video_predict, None),
                           ("75 track", cs.phase_video_track, cs.VIDEO_DIV3_CLIP),
                           ("75 predict", cs.phase_video_predict, cs.VIDEO_DIV3_CLIP),
                           ("77 track", cs.phase_video_track, cs.VIDEO_WMV2_CLIP),
                           ("77 predict", cs.phase_video_predict, cs.VIDEO_WMV2_CLIP)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            fn(Path(tmp), card, clip if clip is not None else cs.vp9_clip_mp4(Path(tmp) / "mp4"))
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # a failed check (PhaseError) or any other fault: non-zero, no result
        print(f"video_phases: FAILED: {e}", file=sys.stderr)
        raise
