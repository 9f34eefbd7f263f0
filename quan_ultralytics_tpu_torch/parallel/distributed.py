"""Multi-process data parallelism: process-group set-up, a rank's rows of a
global batch, and ranks launched on one host (counterpart of the JAX
``parallel/distributed.py``).

The JAX package starts one process per host with ``jax.distributed`` and
lets GSPMD insert the collectives. The port follows the torch idiom: one
process per rank, a ``torch.distributed`` process group, and the reductions
written out (`parallel.mesh`). `initialize` reads what ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
where the JAX one reads ``JAX_*``; `launch` starts ranks on one host itself.

Nothing falls back: a backend that is not built in, a card that is missing,
or a group that does not form within its ``timeout`` raises, and a rank that
fails makes `launch` fail.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def env_world_size() -> int:
    """The world size ``torchrun`` gave this process (``WORLD_SIZE``), 1 without one."""
    return _env_int("WORLD_SIZE") or 1


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK`` under ``torchrun``, else ``cuda``: the card of this
    rank on a host with one card a rank."""
    lr = _env_int("LOCAL_RANK")
    return torch.device("cuda" if lr is None else f"cuda:{lr}")


def default_backend(device: Union[str, torch.device, None]) -> str:
    """``nccl`` for a card, ``gloo`` for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device: Union[str, torch.device, None] = None) -> bool:
    """Join this process to the default process group; returns whether it runs
    with more than one process (False for a plain single-process run, as the
    JAX ``initialize``). Idempotent.

    Arguments left out come from ``torchrun``'s environment (``init_method``
    is then ``env://``). ``backend`` defaults to `default_backend` of ``device``
    (``cuda`` unless the caller names another). Raises when the backend is not
    built into this torch, when ``nccl`` is asked for without a card, or when
    the group does not form within ``timeout``.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None:
        if world_size in (None, 1) and "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    backend = backend or default_backend(device)
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this torch build")
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("the nccl backend is not built into this torch")
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; none is available")
    elif backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend is not built into this torch")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size if world_size else -1,
                            rank=rank if rank is not None else -1, timeout=timeout)
    return dist.get_world_size() > 1


def process_batch_slice(n: int, batch_size: int) -> slice:
    """This rank's contiguous rows of a global batch: rank ``i`` of ``n`` feeds
    rows ``[i * per, (i + 1) * per)`` (the JAX ``process_batch_slice``; the
    reference's rank-sharded ``DistributedSampler``)."""
    if batch_size % n:
        raise ValueError(f"global batch {batch_size} must divide over {n} processes")
    per = batch_size // n
    i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)


def global_batch(mesh, host_batch: Mapping[str, Any]) -> Dict[str, Any]:
    """A rank's rows of a global batch (numpy arrays or tensors) on the mesh's
    device, where the JAX ``global_batch`` stitches the hosts' rows into one
    logical array: here each rank keeps its own, and the collectives of
    `parallel.mesh` make the step the global batch's. Lists and strings stay."""
    return {k: v if isinstance(v, (list, tuple, str)) else torch.as_tensor(v).to(mesh.device)
            for k, v in host_batch.items()}


def free_port() -> int:
    """A TCP port on ``localhost`` that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, init_method: str, backend: str,
               timeout_s: float, args: Sequence, results) -> None:
    ok, value = False, None
    try:
        initialize(backend=backend, init_method=init_method, world_size=world_size, rank=rank,
                   timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value, ok = fn(rank, *args), True
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the launcher, which fails the run
        value = traceback.format_exc()
    results.put((rank, ok, value))
    if not ok:
        raise SystemExit(1)


def launch(fn: Callable[..., Any], world_size: int, args: Sequence = (), backend: str = "gloo",
           timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes (the ``spawn``
    start method) that form one process group over ``tcp://localhost`` with
    ``backend``; returns each rank's return value, in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function). Every
    rank and the group get ``timeout_s``: when it runs out, or when a rank
    raises or dies, every rank still running is killed and this raises.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, init_method, backend, timeout_s,
                                                  tuple(args), results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: Dict[int, Any] = {}

    def stop(msg: str):
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
        raise RuntimeError(msg)

    while len(got) < world_size:
        left = deadline - time.monotonic()
        if left <= 0:
            stop(f"ranks {sorted(set(range(world_size)) - set(got))} did not finish in {timeout_s:.0f} s")
        try:
            rank, ok, value = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            for r, p in enumerate(procs):  # a rank that died without reporting
                if r not in got and p.exitcode not in (None, 0):
                    stop(f"rank {r} exited with code {p.exitcode} and reported nothing")
            continue
        if not ok:
            stop(f"rank {rank} failed:\n{value}")
        got[rank] = value
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
        if p.is_alive():
            p.kill()
    return [got[r] for r in range(world_size)]
