"""Run chip_smoke.py's phase 1 and its stem, assigner and readers phases (53-57) alone, on one card.

    python3 scripts/stem_phases.py              # phase 1, then phases 53-57 once each
    python3 scripts/stem_phases.py --repeat 3   # phase 1, then phase 53 three times in this process

The second form shows the spread of phase 53's host clock between runs of the
phase on one card: each run prints its host-ms rounds and device-ms rounds for
every stem form. Exits non-zero without a card, or when a phase fails.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=0,
                    help="run phase 53 this many times instead of phases 53-57 once")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stem_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from quan_ultralytics_tpu_torch.data.augment import letterbox

    card, _, _ = cs.phase_device()
    x = torch.stack([letterbox(torch.from_numpy(f).to(cs.DEVICE), cs.IMGSZ)[0] for f in cs.make_frames(0)])
    if args.repeat:
        for rep in range(args.repeat):
            t0 = time.perf_counter()
            r = cs.phase_stem_predict(x, card)
            print(f"run {rep}: {time.perf_counter() - t0:.1f} s; default {r['default']}; host ms rounds",
                  {n: [round(v, 1) for v in m["host_ms_rounds"]] for n, m in r["modes"].items()},
                  "device ms rounds", {n: [round(v, 3) for v in m["device_ms_rounds"]] for n, m in r["modes"].items()},
                  flush=True)
        return 0
    batch = cs.make_train_batch(0)
    for name, fn in (("53", lambda: cs.phase_stem_predict(x, card)), ("54", lambda: cs.phase_stem_train(batch, card)),
                     ("55", lambda: cs.phase_stem_dp(batch, card)), ("56", lambda: cs.phase_assigner(batch, x, card))):
        t0 = time.perf_counter()
        fn()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_readers(Path(tmp) / "readers", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
