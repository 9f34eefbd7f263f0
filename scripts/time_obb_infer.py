#!/usr/bin/env python3
"""Host-clock ``Predictor.infer`` of QUAN-YOLO11n-OBB at 1024 on one card, for
comparing two checkouts of the port (for example before and after a change
in how the kernels are called).

QUAN-YOLO11n-OBB (nc 15, weights from ``from_yaml``'s seed 0, bf16, K1 and K3
at its 37 fused 1x1 sites), a batch of 8 uint8 frames made on the card from a
seeded generator; after 5 warm-up calls, ROUNDS rounds of CALLS synchronized
calls each, the median ms a call; the device operations a call and the
device busy ms from torch.profiler over 3 calls; the kernels' launches of one
call; and the host microseconds a call of each level through which a kernel
can be called (`dispatch_us`): the public wrapper, and where the checkout has
them, the registered operator and its CUDA implementation (the launcher), on
inputs small enough that the host, not the card, sets the pace (K1 at G 1,
N 64, dk 2, dv 4; K3 at [8, 32, 32, 4, 64] -> 64, QUAN-YOLO11n-OBB's smallest
site; bf16), DISPATCH_ROUNDS rounds of DISPATCH_CALLS calls, the levels in
turn, the median. One JSON line is printed and appended to ``--out``:

    python3 scripts/time_obb_infer.py --root runs/parent --tag parent --out chiprun_out/infer.jsonl
    python3 scripts/time_obb_infer.py --tag change --out chiprun_out/infer.jsonl

``--root`` is the checkout whose ``quan_ultralytics_tpu_torch`` is imported
(default: this one). Run the two checkouts in turns in one call on one card
(parent, change, change, parent): two calls may land on two cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROUNDS, CALLS = 7, 10
DISPATCH_ROUNDS, DISPATCH_CALLS = 7, 500


def dispatch_us(torch, qattn, qconv_fused) -> dict:
    """Host microseconds a call of K1 and K3 at each level the checkout has."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rand(1, 4, 1, 64, 2), rand(1, 4, 1, 64, 2), rand(1, 4, 1, 64, 4)
    x, w = rand(8, 32, 32, 4, 64), rand(4, 64, 64) * 0.1
    sc, sh = rand(4, 64, dtype=torch.float32) + 1, rand(4, 64, dtype=torch.float32)
    levels = {"K1 wrapper": lambda: qattn.qattention_fwd(q, k, v, 0.5),
              "K3 wrapper": lambda: qconv_fused.qconv1x1_fused(x, w, sc, sh)}
    if hasattr(qconv_fused, "_op"):
        levels.update({"K1 operator": lambda: qattn._fwd_op(q, k, v, 0.5, None),
                       "K1 launcher": lambda: qattn._fwd_launch(q, k, v, 0.5, None),
                       "K3 operator": lambda: qconv_fused._op(x, w, sc, sh, True),
                       "K3 launcher": lambda: qconv_fused._launch(x, w, sc, sh, True)})
    times = {name: [] for name in levels}
    with torch.inference_mode():
        for fn in levels.values():
            fn()
        for _ in range(DISPATCH_ROUNDS):
            for name, fn in levels.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    fn()
                torch.cuda.synchronize()
                times[name].append(1e6 * (time.perf_counter() - t0) / DISPATCH_CALLS)
    return {name: statistics.median(ts) for name, ts in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    if not torch.cuda.is_available():
        print("time_obb_infer: no CUDA device", file=sys.stderr)
        return 2
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16, device="cuda",
                                     fused_1x1=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (8, 1024, 1024, 3), generator=gen, device="cuda", dtype=torch.uint8)
    pred = Predictor(model, imgsz=1024, conf=0.25)
    for _ in range(5):
        pred.infer(x)
    torch.cuda.synchronize()
    k1, k3 = qattn.launches, qconv_fused.launches
    pred.infer(x)
    torch.cuda.synchronize()
    launches = {"qattn_fwd": qattn.launches - k1, "qconv1x1_fused": qconv_fused.launches - k3}
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            pred.infer(x)
        torch.cuda.synchronize()
        rounds.append(1e3 * (time.perf_counter() - t0) / CALLS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pred.infer(x)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dispatch = dispatch_us(torch, qattn, qconv_fused)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    row = {"tag": args.tag, "root": str(args.root), "card": card, "infer_ms": statistics.median(rounds),
           "infer_ms_rounds": rounds, "device_ops": len(ops) / 3,
           "device_ms": sum(e.time_range.elapsed_us() for e in ops) / 3e3, "launches": launches,
           "dispatch_us": dispatch}
    print(json.dumps(row))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
