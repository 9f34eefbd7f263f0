"""Run chip_smoke.py's phase 1 and its image-format phases (61-63, 67-69, 73) alone, on one card.

    python3 scripts/image_phases.py

Phase 1 builds the kernels and the host libraries (``codecs.cpp``,
``imread.cpp`` and ``webp.cpp`` among them); phase 61 validates the OBB set
at 1024 in PNG, BMP, TIFF and lossless WebP; phase 62 fits one epoch on the
BMP and on the PNG set; phase 63 checks the committed BMP, TIFF and WebP
fixtures, times the decoders, splits a tiled TIFF scene and runs ``obb
predict`` on a folder of every suffix; phase 67 checks the committed
fixtures of the newer TIFF and JPEG kinds (JPEG-in-TIFF, raw
YCbCr, CMYK, CIELab, CCITT, BigTIFF, CMYK JPEG) and times a 1024 x 1024
decode of each; phase 68 validates the set as GDAL's JPEG-YCbCr BigTIFF and
as CMYK LZW TIFF against PNG twins of their decoded pixels and fits one
epoch on the JPEG-TIFF set; phase 69 splits the 4000 x 4000 scene as a
JPEG-YCbCr BigTIFF and runs ``obb predict`` on a folder of every new kind;
phase 73 checks the committed stills that only ``imread`` takes (PxM, PAM,
PFM, Sun raster, Radiance HDR, GIF), times a 512 x 512 decode of each kind
and runs ``obb predict`` on a list of one file of each.
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
        print("image_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card, _, _ = cs.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfgs, _ = cs.phase_image_val(Path(tmp) / "sets", card)
        print(f"phase 61: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_image_fit(cfgs, card)
        print(f"phase 62: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_image_sources(Path(tmp) / "sources", cfgs["png"], card)
        print(f"phase 63: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_image_kinds_sources(Path(tmp) / "kinds", cfgs["png"], card)
        print(f"phase 67: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_image_kinds_val_fit(Path(tmp) / "kind_sets", cfgs["png"], card)
        print(f"phase 68: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_image_kinds_split_cli(Path(tmp) / "kind_split", card)
        print(f"phase 69: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.phase_still_kinds(Path(tmp) / "stills", card)
        print(f"phase 73: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # a failed check (PhaseError) or any other fault: non-zero, no result
        print(f"image_phases: FAILED: {e}", file=sys.stderr)
        raise
