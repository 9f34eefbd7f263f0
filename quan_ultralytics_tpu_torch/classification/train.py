"""Classification training (counterpart of the JAX ``classification/train.py``;
reference classification/classification.py:43-291 and utils/training.py):
SGD with Nesterov momentum 0.9 and weight decay 1e-4, MultiStepLR [30, 60,
90] x 0.1, cross-entropy on the quaternion-norm logits, bf16 compute with
float32 parameters, top-1/top-5 evaluation, experiment directories with
``config.json``, ``metrics.json`` and checkpoints.

The optimizer is ``torch.optim.SGD(momentum, nesterov=True, weight_decay)``
over every parameter: the JAX chain ``add_decayed_weights(wd)`` then
``sgd(schedule, momentum, nesterov=True)`` step for step (its ``trace`` is
SGD's momentum buffer). Each update takes the schedule at the count of
updates made before it, as ``optax.scale_by_schedule`` does.

Checkpoints are the JAX package's pickles: ``{epoch, params, batch_stats,
opt_state, step, val_acc}`` with ``params`` and ``batch_stats`` in the flax
layout, so the JAX ``create_model(...).apply`` runs them, and ``opt_state``
the optax chain's state ``(EmptyState(), (TraceState(trace),
ScaleByScheduleState(count)))``, written by `utils.weights.write_checkpoint`
so that JAX's ``pickle.load`` reads optax's own classes: a port checkpoint
resumes under the JAX CLI's ``--resume``, and the JAX package's resumes here
(`read_opt_state`). Each epoch also redraws ``curves.png``, one panel a
logged metric (`utils.plotting.plot_curves`).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from quan_ultralytics_tpu_torch.classification.models import create_model, reset_parameters, set_generator
from quan_ultralytics_tpu_torch.models.tasks import resolve_device
from quan_ultralytics_tpu_torch.parallel.mesh import Mesh, all_reduce_, data_parallel, replicate
from quan_ultralytics_tpu_torch.parallel.prefetch import prefetch_to_device
from quan_ultralytics_tpu_torch.utils.plotting import plot_curves
from quan_ultralytics_tpu_torch.utils.weights import (OptaxState, export_jax_variables, from_jax_tree,
                                                       load_jax_variables, optax_state, read_checkpoint,
                                                       to_jax_tree, write_checkpoint)


@dataclasses.dataclass
class ClsConfig:
    model: str = "qwrn16_2"
    dataset: str = "cifar10"
    data_dir: str = "data"
    mapping: str = "poincare"
    epochs: int = 100
    batch_size: int = 128
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    milestones: Tuple[int, ...] = (30, 60, 90)
    gamma: float = 0.1
    drop_rate: float = 0.0
    num_classes: int = 10
    dtype: str = "bfloat16"
    seed: int = 0
    exp_dir: str = "runs/classify"
    augment: bool = True


def multistep_lr(cfg: ClsConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(count): ``cfg.lr`` times ``gamma`` for every milestone boundary
    ``int(m * steps_per_epoch)`` that ``count`` has reached, in float32 as
    ``optax.piecewise_constant_schedule`` computes it."""
    bounds = sorted({int(m * steps_per_epoch) for m in cfg.milestones})

    def fn(count: int) -> float:
        v = np.float32(cfg.lr)
        for b in bounds:
            if count >= b:
                v = np.float32(v * np.float32(cfg.gamma))
        return float(v)

    return fn


def read_opt_state(opt_state: Any) -> Tuple[Mapping, int]:
    """(momentum trace as a flax-layout tree, update count) of a checkpoint's
    ``opt_state``: the optax chain state, read as `OptaxState` stand-ins (its
    ``TraceState`` and ``ScaleByScheduleState``), or a ``{"trace", "count"}``
    mapping."""
    if isinstance(opt_state, Mapping):
        return opt_state["trace"], int(opt_state["count"])
    found: Dict[str, OptaxState] = {}

    def walk(node):
        if isinstance(node, OptaxState):
            found.setdefault(node.name, node)
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if "TraceState" not in found or "ScaleByScheduleState" not in found:
        raise ValueError(f"optimizer state holds no momentum trace and count: {sorted(found)}")
    return found["TraceState"][0], int(np.asarray(found["ScaleByScheduleState"][0]))


class ClsTrainer:
    """The model, its optimizer and the train and eval steps, on ``device``
    (``cuda`` unless the caller names another; raises without a card).

    Weights are drawn from ``torch.Generator().manual_seed(cfg.seed)``; the
    dropout masks from a generator on the device seeded with ``cfg.seed + 1``.

    With a ``mesh`` over a process group (the JAX ``make_mesh()``) `train_step`
    takes this rank's rows of the global batch: IQBN statistics are the
    global batch's, the ranks' gradients are summed, and every rank makes
    the single-process update on the global batch (each rank draws the same
    dropout masks for its rows, so the equality holds without dropout).
    """

    def __init__(self, cfg: ClsConfig, steps_per_epoch: int,
                 device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh is not None else device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        model = create_model(cfg.model, cfg.num_classes, cfg.drop_rate, cfg.mapping,
                             dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else None)
        reset_parameters(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(mesh, self.model)
        set_generator(self.model, torch.Generator(self.device).manual_seed(cfg.seed + 1))
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=cfg.lr, momentum=cfg.momentum,
                                         nesterov=True, weight_decay=cfg.weight_decay)
        self.schedule = multistep_lr(cfg, steps_per_epoch)
        self.step = 0  # optimizer updates made

    def _upload(self, batch: Mapping[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        img, label = (torch.as_tensor(batch[k]).to(self.device, non_blocking=True) for k in ("img", "label"))
        return img, label.long()

    def train_step(self, batch: Mapping[str, Any], sharded: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on ``batch`` (``img`` ``[B, H, W, 3]`` normalized, ``label``
        ``[B]``): the input cast to the compute dtype, cross-entropy in float32
        on the norm logits. Returns the (loss, accuracy) tensors, detached.
        Under a mesh ``batch`` is this rank's rows (``sharded``, the default)
        and the loss and accuracy returned are the global batch's;
        ``sharded=False`` marks a batch every rank holds whole."""
        dp = self.mesh is not None and self.mesh.grouped and sharded is not False
        img, label = self._upload(batch)
        self.model.train()
        with data_parallel(self.mesh if dp else None):
            logits = self.model(img.to(self.dtype))
        if dp:  # this rank's part of the global mean; the parts' sums are the global batch's
            n = label.shape[0] * self.mesh.world_size
            loss = F.cross_entropy(logits.float(), label, reduction="sum") / n
            acc = (logits.argmax(-1) == label).float().sum() / n
        else:
            loss = F.cross_entropy(logits.float(), label)
            acc = (logits.argmax(-1) == label).float().mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if dp:
            params = list(self.model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss, acc = loss.detach().clone(), acc.detach().clone()
            all_reduce_(self.mesh, [loss, acc, *(p.grad for p in params)])
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach(), acc.detach()

    @torch.no_grad()
    def eval_step(self, batch: Mapping[str, Any]) -> Tuple[int, int]:
        """(top-1, top-5) correct counts of ``batch`` in eval mode."""
        img, label = self._upload(batch)
        self.model.eval()
        logits = self.model(img).float()
        top1 = (logits.argmax(-1) == label).sum()
        topk = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        top5 = (topk == label[:, None]).any(-1).sum()
        return int(top1), int(top5)

    def evaluate(self, data_iter: Iterable) -> Dict[str, float]:
        """Top-1 and top-5 accuracy over ``data_iter``'s batches; a padded last
        batch counts its repeated images, as the JAX package's does."""
        c1 = c5 = n = 0
        for batch in data_iter:
            t1, t5 = self.eval_step(batch)
            c1, c5, n = c1 + t1, c5 + t5, n + len(batch["label"])
        return {"top1": c1 / max(n, 1), "top5": c5 / max(n, 1)}

    def state_dict(self) -> Dict[str, Any]:
        """``{params, batch_stats, opt_state, step}`` in the checkpoint's format;
        ``opt_state`` is the JAX ``build_cls_optimizer`` chain's state."""
        params = dict(self.model.named_parameters())
        trace = {name: self.optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                 for name, p in params.items()}
        opt_state = (optax_state("EmptyState"),  # add_decayed_weights
                     (optax_state("TraceState", to_jax_tree(trace)),  # sgd: trace, then the lr schedule
                      optax_state("ScaleByScheduleState", np.asarray(self.step, np.int32))))
        return {**export_jax_variables(self.model), "opt_state": opt_state, "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore weights, IQBN statistics, momentum and update count from a
        checkpoint's payload (the port's or the JAX package's)."""
        load_jax_variables(self.model, state)
        trace_tree, count = read_opt_state(state["opt_state"])
        trace = from_jax_tree(trace_tree)
        params = dict(self.model.named_parameters())
        if set(trace) != set(params):
            raise KeyError(f"momentum trace and parameters differ: {sorted(set(trace) ^ set(params))}")
        for name, p in params.items():
            self.optimizer.state[p]["momentum_buffer"] = torch.as_tensor(trace[name]).to(p)
        self.step = int(state.get("step", count))


class ExperimentManager:
    """Timestamped experiment directories with config, metrics and checkpoints
    (reference classification/utils/experiment_manager.py:8-240; keep-last-5
    policy :204)."""

    def __init__(self, cfg: ClsConfig, name: Optional[str] = None):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.dir = Path(cfg.exp_dir) / (name or f"{cfg.model}_{cfg.dataset}_{stamp}")
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
        self.metrics: list = []
        self.best_acc = 0.0

    def log_epoch(self, epoch: int, train_loss: float, train_acc: float, val: Dict[str, float],
                  lr: float) -> Dict[str, float]:
        row = {"epoch": epoch, "train_loss": train_loss, "train_acc": train_acc, "lr": lr, **val}
        self.metrics.append(row)
        (self.dir / "metrics.json").write_text(json.dumps(self.metrics, indent=2))
        plot_curves(self.metrics, str(self.dir / "curves.png"))  # reference experiment_manager.py:95-178
        return row

    def save_checkpoint(self, trainer: ClsTrainer, epoch: int, val_acc: float, keep_last: int = 5) -> None:
        payload = {"epoch": epoch, **trainer.state_dict(), "val_acc": val_acc}
        p = self.dir / f"checkpoint_epoch{epoch}.pkl"
        write_checkpoint(p, payload)
        (self.dir / "last.pkl").write_bytes(p.read_bytes())
        if val_acc > self.best_acc:
            self.best_acc = val_acc
            (self.dir / "best_model.pkl").write_bytes(p.read_bytes())
        ckpts = sorted(self.dir.glob("checkpoint_epoch*.pkl"), key=lambda q: int(q.stem.split("epoch")[1]))
        for old in ckpts[:-keep_last]:
            old.unlink()

    @staticmethod
    def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
        """A checkpoint of either package, read with numpy alone."""
        return read_checkpoint(path)


def fit(cfg: ClsConfig, train_loader_fn: Callable[[int], Iterable],
        val_loader_fn: Callable[[], Iterable], steps_per_epoch: int,
        start_state: Optional[Mapping[str, Any]] = None, start_epoch: int = 0, log=print,
        device: Optional[Union[str, torch.device]] = None) -> Tuple[ClsTrainer, ExperimentManager]:
    """Train ``cfg.epochs`` epochs from ``start_epoch`` (weights, momentum and
    count from the checkpoint payload ``start_state`` if given), validating and
    checkpointing after each. The loader runs two batches ahead of the step
    (`prefetch_to_device`). SIGINT ends the epoch early and saves a checkpoint."""
    trainer = ClsTrainer(cfg, steps_per_epoch, device)
    if start_state is not None:
        trainer.load_state_dict(start_state)
    exp = ExperimentManager(cfg)
    interrupted = {"flag": False}

    def _sigint(signum, frame):  # interrupt checkpoint (classification.py:26-40)
        interrupted["flag"] = True

    old_handler = signal.signal(signal.SIGINT, _sigint)
    try:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            losses, accs = [], []
            for batch in prefetch_to_device(train_loader_fn(epoch), trainer.device):
                loss, acc = trainer.train_step(batch)
                losses.append(float(loss))
                accs.append(float(acc))
                if interrupted["flag"]:
                    break
            val = trainer.evaluate(val_loader_fn())
            lr = trainer.schedule(trainer.step)
            row = exp.log_epoch(epoch, float(np.mean(losses)), float(np.mean(accs)), val, lr)
            exp.save_checkpoint(trainer, epoch, val["top1"])
            log(f"epoch {epoch}: loss {row['train_loss']:.4f} acc {row['train_acc']:.4f} "
                f"top1 {val['top1']:.4f} top5 {val['top5']:.4f} lr {lr:.5f} "
                f"({time.time() - t0:.1f}s)")
            if interrupted["flag"]:
                log("interrupted — checkpoint saved")
                break
    finally:
        signal.signal(signal.SIGINT, old_handler)
    return trainer, exp
