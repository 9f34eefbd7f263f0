"""The data mesh: the ranks of the process group and the collectives that make
a sharded step the single-process step on the global batch (counterpart of
the JAX ``parallel/mesh.py``).

In JAX the batch is sharded over a 1-D ``data`` mesh and GSPMD inserts the
reductions; its sharded step *is* the single-device step on the global
batch (no ``loss * world_size`` scaling). The port writes those reductions
out, and they are what this module holds:

* `shard_batch` takes a rank's rows; a batch whose leading dimension does
  not divide stays whole on every rank (JAX replicates it, ``:33-40``);
* inside `data_parallel`, IQBN takes its mean and biased variance over the
  global (B, H, W) (`Mesh.global_moments`, two autograd-carrying
  all-reduces: each rank's gradient through the statistics is the global
  one), and the losses divide by the global normalisers (`global_sum`,
  `global_rows`: sums that carry no gradient);
* `all_reduce_` sums the ranks' gradients, so each rank's update is the
  single-process update on the global batch;
* `gather_rows` concatenates the ranks' rows of a result (gloo gathers CPU
  tensors only, so a card's tensor goes through the host);
* `replicate` broadcasts a module's state from rank 0.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from quan_ultralytics_tpu_torch.parallel.distributed import local_device


@dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group (one rank when there is none)
    and this rank's device."""

    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None  # None: no process group

    @property
    def grouped(self) -> bool:
        """Whether the ranks form a process group (a group of one rank runs its
        collectives too: the same path as more ranks)."""
        return self.backend is not None

    def shards(self, n: int) -> bool:
        """Whether a batch of ``n`` rows is split over the ranks (else every rank holds it whole)."""
        return self.grouped and n % self.world_size == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` that `shards`."""
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def global_moments(self, x: torch.Tensor, dims: Tuple[int, ...] = (0, 1, 2)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and biased variance of ``x`` over ``dims`` of the global batch
        (every rank's ``x`` has the same shape), in two passes as the
        single-process ``var`` takes them; the all-reduces carry the gradient."""
        n = self.world_size
        for d in dims:
            n *= x.shape[d]
        mean = _AllReduceSum.apply(x.sum(dim=dims)) / n
        shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        var = _AllReduceSum.apply(((x - mean.reshape(shape)) ** 2).sum(dim=dims)) / n
        return mean, var


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the same sum: each rank's
    statistic feeds every rank's loss, so its gradient is the sum of theirs
    (as ``SyncBatchNorm``'s backward reduces)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def make_mesh(n: Optional[int] = None, device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh over the default process group, or over this process alone
    when there is none (`parallel.distributed.initialize` forms the group).

    ``n``: the world size the caller expects; a mismatch raises, and so does
    ``n > 1`` without a group (never a silent single-process run). ``device``:
    this rank's device; unless named, ``cuda:LOCAL_RANK`` under ``torchrun``,
    else ``cuda`` (`parallel.distributed.local_device`).
    """
    dev = local_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if n is not None and n != world:
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of {n} "
                           f"(parallel.distributed.initialize); this one has {world}")
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("an nccl group runs on a CUDA device, not on the CPU")
    return Mesh(world, rank, dev, backend)


def shard_batch(mesh: Mesh, tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """This rank's rows of every leaf whose leading dimension divides over the
    mesh; the others (and lists, strings, scalars) stay whole (the JAX
    ``shard_batch``'s replication of a batch that does not divide)."""
    def take(x):
        if isinstance(x, (list, tuple, str)) or getattr(x, "ndim", 0) == 0:
            return x
        return x[mesh.rows(x.shape[0])] if mesh.shards(x.shape[0]) else x

    return {k: take(v) for k, v in tree.items()}


def _tensors(obj: Union[nn.Module, Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return list(obj.state_dict().values())
    return list(obj)


@torch.no_grad()
def replicate(mesh: Mesh, params: Union[nn.Module, Sequence[torch.Tensor]]):
    """Every rank's copy of ``params`` (a module's parameters and buffers, or a
    list of tensors) made rank 0's, in place; returns ``params``."""
    if mesh.grouped:
        for t in _tensors(params):
            dist.broadcast(t, src=0)
    return params


@torch.no_grad()
def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Sum ``tensors`` over the ranks in place, in one flat buffer a dtype."""
    if not mesh.grouped or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in ts]), ts)])
    return tensors


def gather_rows(mesh: Mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Every rank's ``x`` (same shape on each) concatenated along dim 0, in rank
    order, on ``x``'s device. Over gloo a card's tensor is gathered on the host."""
    if x is None or not mesh.grouped:
        return x
    via_host = mesh.backend == "gloo" and x.device.type != "cpu"
    src = x.cpu() if via_host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.to(x.device) if via_host else out


# ----------------------------------------------------------- the sharded step

_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("quan_torch_mesh", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the forward and loss inside as one rank's part of the global
    batch: IQBN statistics and the loss normalisers over every rank. A mesh
    without a process group (or None) changes nothing."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.grouped else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `data_parallel`, or None."""
    return _ACTIVE.get()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks inside `data_parallel` (no gradient: the
    loss normalisers come from the assigner), else ``t``."""
    if _ACTIVE.get() is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_rows(b: int) -> int:
    """The global batch's rows of a rank's ``b`` inside `data_parallel`, else ``b``."""
    mesh = _ACTIVE.get()
    return b if mesh is None else b * mesh.world_size
