"""Run chip_smoke.py's phase 1 and its video phases (58-60) alone, on one card.

    python3 scripts/video_phases.py

Phase 1 builds the kernels and the host libraries (``video.cpp`` among them);
phase 58 decodes the committed video fixtures against their digests and times
the 640 x 480 clips; phase 59 runs ``detect track`` of the MPEG-4 clip through
the CLI and ``YOLO.track`` of it with BoT-SORT; phase 60 runs ``obb predict`` of
it at 1024. Exits non-zero without a card, or when a phase fails.
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
    t0 = time.perf_counter()
    cs.phase_video_decode(card)
    print(f"phase 58: {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("59", cs.phase_video_track), ("60", cs.phase_video_predict)):
            t0 = time.perf_counter()
            fn(Path(tmp), card)
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # a failed check (PhaseError) or any other fault: non-zero, no result
        print(f"video_phases: FAILED: {e}", file=sys.stderr)
        raise
