"""Host->device input prefetch: the loader runs ahead of the step
(counterpart of the JAX package's ``parallel/prefetch.py``).

A producer thread draws the next ``size`` batches from the loader while the
consumer's step runs, and moves their arrays to the device with a blocking
``.to(device)``: a batch is on the device before it is queued, so the
consumer needs no event. The upload (about 25 MB for 8 frames at 1024) is
not staged in page-locked buffers on a stream of its own: no measurement
has shown it costing the step time.

The JAX ``mesh`` argument (a sharded batch) has no counterpart here: under
data parallelism each rank's loader builds that rank's rows
(`data.build.build_dataloader`'s ``rows``) and its prefetcher moves them to
the rank's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Union

import torch

_END = object()
_POLL_S = 0.05  # how often a blocked producer looks for the consumer's stop


def _passes_through(v: Any) -> bool:
    """Values the JAX prefetcher leaves as they are (file lists, names)."""
    return isinstance(v, (list, tuple, str))


def prefetch_to_device(iterator: Iterable, device: Union[str, torch.device],
                       size: int = 2) -> Iterator[Any]:
    """Yield the batches of ``iterator`` with their array values on ``device``,
    loading up to ``size`` batches ahead on a producer thread.

    Dict batches have every value but lists, tuples and strings made a tensor
    on ``device``; other batches pass through untouched. The loader's
    exceptions reach the consumer. When the consumer stops early (``break``,
    an exception, ``close()``), the producer stops, closes the loader (in its
    own thread: a generator runs and closes in one thread) and is joined.
    """
    dev = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        it = iter(iterator)
        try:
            for batch in it:
                if stop.is_set():
                    return
                if isinstance(batch, dict):
                    batch = {k: v if _passes_through(v) else torch.as_tensor(v).to(dev)
                             for k, v in batch.items()}
                if not put(batch):
                    return
            put(_END)
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer, which raises it
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
