"""Benchmark harness: a speed table over models, image sizes and dtypes
(counterpart of the JAX package's ``utils/benchmarks.py``; reference
utils/benchmarks.py ``benchmark`` :51).

Each row times forward + decode + NMS of a batch made on the device from a
seeded ``torch.Generator``: warm-up calls, then ``iters`` calls between two
CUDA events and one host synchronization at the end (the host clock on the
CPU). The rows keep the JAX package's keys.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, resolve_device
from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WARMUP = 2  # untimed calls before each row's clock starts


def benchmark(models: Sequence[str] = ("yolo11n-obb-quan.yaml",),
              imgsz: Sequence[int] = (640, 1024), batch: int = 16,
              dtypes: Sequence[str] = ("bfloat16",), iters: int = 10, nc: int = 15,
              include_nms: bool = True,
              device: Optional[Union[str, torch.device]] = None) -> List[Dict[str, Any]]:
    """One row a (model, imgsz, dtype): ``model, imgsz, dtype, batch,
    ms_per_batch, img_per_s``; runs on ``cuda`` unless ``device`` names another."""
    dev = resolve_device(device)
    rows = []
    for name in models:
        for size in imgsz:
            for dt in dtypes:
                model = DetectionModel.from_yaml(name, nc=nc, dtype=DTYPES[dt], device=dev)
                gen = torch.Generator(device=dev).manual_seed(0)
                x = torch.rand((batch, size, size, 3), generator=gen, device=dev)

                def fwd():
                    pred = model.decode(model(x))
                    if include_nms:
                        return non_max_suppression(pred, nc=model.nc, rotated=model.task == "obb",
                                                   extra_dim=model.extra_dim)[0]
                    return pred

                with torch.inference_mode():
                    for _ in range(WARMUP):
                        fwd()
                    if dev.type == "cuda":
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        torch.cuda.synchronize(dev)
                        start.record()
                        for _ in range(iters):
                            fwd()
                        end.record()
                        end.synchronize()
                        t = start.elapsed_time(end) / 1e3 / iters
                    else:
                        t0 = time.perf_counter()
                        for _ in range(iters):
                            fwd()
                        t = (time.perf_counter() - t0) / iters
                rows.append({"model": name, "imgsz": size, "dtype": dt, "batch": batch,
                             "ms_per_batch": round(t * 1e3, 2), "img_per_s": round(batch / t, 1)})
                del model, x
    return rows


def print_table(rows: List[Dict[str, Any]]) -> None:
    if not rows:
        return
    keys = list(rows[0])
    widths = {k: max(len(k), *(len(str(r[k])) for r in rows)) for k in keys}
    print("  ".join(k.ljust(widths[k]) for k in keys))
    for r in rows:
        print("  ".join(str(r[k]).ljust(widths[k]) for k in keys))
