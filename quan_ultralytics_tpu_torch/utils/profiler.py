"""Profiling: device traces and per-layer cost tables (counterpart of the JAX
package's ``utils/profiler.py``; reference BaseModel._profile_one_layer
nn/tasks.py:177-200, profiler.py / layer_profiler.py).

* `trace(logdir)`: ``torch.profiler`` over the block, CPU and, with a card,
  CUDA activity, written as a Chrome trace (``logdir/trace.json``).
* `time_fn(fn, ...)`: the median wall time of a call, each call ended by
  ``torch.cuda.synchronize`` when the card is present.
* `profile_layers(model, x)`: wall time per layer by running the graph prefix
  by prefix (``model(x, upto=i)``); deltas of fast layers can be slightly
  negative.
* `conv_flops`, `summary`: analytic conv FLOPs per layer from the specs (the
  thop analog, counting the separable quaternion conv as 4 component convs +
  mixing) and the parameter count; the same integers as the JAX package's.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace(logdir: str = "runs/torch-trace") -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``logdir/trace.json`` (open it in
    Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn(*args)`` in seconds, each call synchronized."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


@torch.inference_mode()
def profile_layers(model, x: torch.Tensor, iters: int = 5) -> List[Dict[str, Any]]:
    """Per-layer wall-time deltas of graph prefixes: one row a layer with
    ``i, module, c2, cum_ms, delta_ms``."""
    rows = []
    prev = 0.0
    for spec in model.specs:
        t = time_fn(lambda: model(x, upto=spec.i), iters=iters, warmup=1)
        rows.append({"i": spec.i, "module": spec.module, "c2": spec.c2,
                     "cum_ms": t * 1e3, "delta_ms": (t - prev) * 1e3})
        prev = t
    return rows


def conv_flops(c1: int, c2: int, k: int, h: int, w: int) -> int:
    """Separable quaternion conv FLOPs: 4 per-component convs + the 16-add mixing."""
    per_comp = (c1 // 4) * (c2 // 4) * k * k * 2
    return h * w * (4 * per_comp + 16 * (c2 // 4))


def summary(model, imgsz: int = 640) -> Dict[str, Any]:
    """``{params, approx_conv_gflops}`` (the model_info analog, reference
    torch_utils.py:299): the trainable parameters, and the conv FLOPs of the
    ``Conv`` / ``DWConv`` layers of the specs at ``imgsz``."""
    n_params = sum(p.numel() for p in model.parameters())
    flops = 0
    for s in model.specs:
        if s.module in ("Conv", "DWConv") and len(s.args) >= 3:
            h = w = imgsz // max(s.stride, 1)
            flops += conv_flops(s.args[0] if s.args[0] != 3 else 4, s.args[1], s.args[2], h, w)
    return {"params": n_params, "approx_conv_gflops": flops / 1e9}
