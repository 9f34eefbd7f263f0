"""Detection trainer: the train step, its optimizer, EMA and checkpoints
(counterpart of the JAX ``engine/trainer.py``).

The JAX package builds its optimizer from optax parts; here the same chain
is written out (`Optimizer`):

  * three parameter groups (`_param_label`): decayed conv weights,
    decay-free norm scales, decay-free biases;
  * per group, in this order: clipping by the group's own global norm
    (``optax.multi_transform`` hands each group's chain only its leaves),
    weight decay ``wd * batch * accumulate / nbs`` on the weight group, SGD
    with Nesterov momentum;
  * learning rate and momentum from schedules evaluated at the number of
    updates already made (``optax.inject_hyperparams`` counts from 0);
  * gradient accumulation over ``accumulate = round(nbs / batch)``
    micro-steps as a running mean (``optax.MultiSteps``).

EMA follows the optimizer's updates (reference trainer.py:586-594), and a
non-finite loss or gradient leaves the whole state unchanged. Parameters
are updated in place. Checkpoints are the JAX trainer's pickles, optax state
included (`Trainer.save_checkpoint`), so a run that either package started
resumes in the other.

Under a ``mesh`` (`parallel.mesh`, one process a rank) each rank steps on
its rows of the global batch: IQBN statistics and the loss normalisers are
the global batch's, the ranks' gradients and the NaN guard's decision are
reduced before the update, so every rank makes the single-process update
on the global batch and the ranks' parameters, EMA and statistics stay
equal. Rank 0 alone writes checkpoints, ``results.json`` and logs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from quan_ultralytics_tpu_torch.losses.detect import LossHyp, detection_loss, obb_loss
from quan_ultralytics_tpu_torch.losses.segpose import pose_loss, segmentation_loss
from quan_ultralytics_tpu_torch.models.conv import QConv2D, train_graph
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, resolve_device
from quan_ultralytics_tpu_torch.parallel.mesh import Mesh, all_reduce_, data_parallel, replicate
from quan_ultralytics_tpu_torch.parallel.prefetch import prefetch_to_device
from quan_ultralytics_tpu_torch.utils.weights import (export_jax_variables, from_jax_tree, load_jax_variables,
                                                      optax_state, read_checkpoint, to_jax_tree,
                                                      write_checkpoint)

GROUPS = ("weight", "norm", "bias")


@dataclasses.dataclass
class TrainConfig:
    """The reference cfg/default.yaml hyperparameters that shape the
    optimization and the epoch loop, with its defaults (the JAX
    ``TrainConfig``). Its fields that only the JAX ``init_state`` and CLI
    read (imgsz, seed, optimizer, save_dir, multi_scale) are not ported."""

    epochs: int = 100
    batch: int = 16
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    nbs: int = 64  # nominal batch size for accumulation and decay scaling
    cos_lr: bool = False
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    max_grad_norm: float = 10.0
    dtype: str = "bfloat16"
    guard_nan: bool = True  # skip the update on a non-finite loss or gradient
    patience: int = 100  # epochs without a better fitness before `Trainer.fit` stops
    # the assigner's metric chain in bf16 (the JAX trainer's default; the port
    # reads no environment variable for it). On an H100 80GB HBM3 at 700 W
    # (chip_smoke.py phase 6) obb_loss and its backward at 128 padded boxes an
    # image take 10.32 ms of device time with it and 11.31 in f32.
    assigner_bf16: bool = True
    # the assigner's form (losses/tal.py; the same targets either way): `dense`
    # or `sparse`, and its top-k (`iter`, `chunk`, None: by topk), JAX's
    # QUAN_ASSIGNER_IMPL and QUAN_TOPK_IMPL
    assigner_impl: str = "dense"
    topk_impl: Optional[str] = None


def _param_label(name: str) -> str:
    """Optimizer group of a parameter, by its flax-path name (``model.0.bn.gamma``):
    ``bias`` for biases and IQBN beta, ``norm`` for IQBN gamma (or a norm
    layer's weight), else ``weight`` (decayed)."""
    keys = name.split(".")
    last = keys[-1]
    if last in ("b", "bias", "beta"):
        return "bias"
    if last == "gamma" or ("bn" in keys and last == "weight"):
        return "norm"
    return "weight"


def _warmup_updates(cfg: TrainConfig, steps_per_epoch: int, accumulate: int) -> float:
    """Warmup length in optimizer updates: the reference's floor of 100
    iterations (trainer.py:366) and the epoch length, both over ``accumulate``."""
    if cfg.warmup_epochs == 0:
        return 0.0
    return max(cfg.warmup_epochs * steps_per_epoch, 100.0) / accumulate


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int,
                accumulate: int = 1) -> Callable[[int], float]:
    """lr(update): linear warmup, then linear (or cosine) decay to lr0 * lrf
    (reference trainer.py:810 and :366-376). ``update`` counts optimizer updates."""
    warmup = _warmup_updates(cfg, steps_per_epoch, accumulate)
    updates_per_epoch = max(steps_per_epoch / accumulate, 1e-9)

    def fn(step: int) -> float:
        frac_epoch = step / updates_per_epoch
        if cfg.cos_lr:
            decay = cfg.lrf + 0.5 * (1 - cfg.lrf) * (1 + math.cos(math.pi * frac_epoch / cfg.epochs))
        else:
            decay = (1 - frac_epoch / cfg.epochs) * (1.0 - cfg.lrf) + cfg.lrf
        lr = cfg.lr0 * decay
        if warmup:
            lr *= min(max(step / warmup, 0.0), 1.0)
        return lr

    return fn


def _foreach_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of a list of tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def _all_finite(ts: List[torch.Tensor]) -> bool:
    """Whether every element of every tensor is finite: ``0 * x`` is NaN exactly
    where ``x`` is not finite, and a NaN anywhere makes the norm NaN."""
    with torch.no_grad():
        return bool(torch.isfinite(_foreach_norm(torch._foreach_mul(ts, 0.0))))


class Optimizer:
    """The JAX ``build_optimizer`` chain written out: three groups, per-group
    clipping, decay on the weight group, Nesterov SGD with scheduled lr and
    momentum, accumulation over ``accumulate`` micro-steps.

    ``params`` maps names to the parameters it updates in place. `step` takes
    one micro-step's gradients and returns whether it made an update.
    """

    def __init__(self, cfg: TrainConfig, params: Mapping[str, torch.Tensor], steps_per_epoch: int):
        self.cfg = cfg
        self.accumulate = max(round(cfg.nbs / cfg.batch), 1)
        self.schedule = lr_schedule(cfg, steps_per_epoch, self.accumulate)
        self.wd = cfg.weight_decay * cfg.batch * self.accumulate / cfg.nbs
        self.warmup = _warmup_updates(cfg, steps_per_epoch, self.accumulate)
        self.names = list(params)
        self.groups: Dict[str, List[int]] = {g: [] for g in GROUPS}
        for i, name in enumerate(self.names):
            self.groups[_param_label(name)].append(i)
        with torch.no_grad():
            self.trace = [torch.zeros_like(p) for p in params.values()]
            self.acc = ([torch.zeros_like(p) for p in params.values()]
                        if self.accumulate > 1 else [])
        self.mini_step = 0  # micro-steps accumulated toward the next update
        self.count = 0  # updates made

    def momentum(self, n: int) -> float:
        if self.warmup == 0:
            return self.cfg.momentum
        w = min(max(n / self.warmup, 0.0), 1.0)
        return self.cfg.warmup_momentum + (self.cfg.momentum - self.cfg.warmup_momentum) * w

    def lr(self, group: str, n: int) -> float:
        """The group's learning rate at update ``n``: the bias group warms
        down from ``warmup_bias_lr`` to the schedule, the others follow it."""
        base = self.schedule(n)
        if group != "bias" or self.warmup == 0:
            return base
        w = min(max(n / self.warmup, 0.0), 1.0)
        full = base / max(w, 1e-9) if w > 0 else base  # the schedule before its warmup factor
        return self.cfg.warmup_bias_lr + (full - self.cfg.warmup_bias_lr) * w if w < 1.0 else base

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> bool:
        if self.accumulate > 1:  # running mean of the micro-steps' gradients
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if self.mini_step:
                return False
            grads = self.acc
        n, mom = self.count, self.momentum(self.count)
        for group, idx in self.groups.items():
            if not idx:
                continue
            p = [params[i] for i in idx]
            g = [grads[i] for i in idx]
            norm = _foreach_norm(g)
            # clip by the group's own norm: g * (max / norm) where norm >= max
            factor = torch.where(norm < self.cfg.max_grad_norm, torch.ones_like(norm),
                                 self.cfg.max_grad_norm / norm)
            g = torch._foreach_mul(g, factor)
            if group == "weight" and self.wd:
                torch._foreach_add_(g, p, alpha=self.wd)
            t = [self.trace[i] for i in idx]
            torch._foreach_mul_(t, mom)
            torch._foreach_add_(t, g)  # t = g + m t
            torch._foreach_add_(g, t, alpha=mom)  # nesterov: g + m t
            torch._foreach_add_(p, g, alpha=-self.lr(group, n))
        if self.accumulate > 1:
            torch._foreach_zero_(self.acc)
        self.count += 1
        return True

    def optax_state(self) -> Any:
        """The state as the JAX ``build_optimizer``'s optax state, of `OptaxState`
        stand-ins and numpy arrays in the flax layout: ``MultiStepsState(
        mini_step, gradient_step, PartitionState, acc_grads, ())`` when
        ``accumulate > 1``, around ``PartitionState({group: MaskedState((clip,
        decay, InjectStatefulHyperparamsState(count, hyperparams,
        {name: WrappedScheduleState(count)}, (TraceState(trace), scale))))})``
        with an ``EmptyState`` for each of clip, decay (or identity) and scale.
        A group's trace holds ``MaskedNode`` for the other groups' parameters;
        its hyperparams are the ones the last update used (the first update's
        before any)."""
        def i32(v):
            return np.asarray(v, np.int32)

        empty = optax_state("EmptyState")
        named = dict(zip(self.names, self.trace))
        last = max(self.count - 1, 0)
        groups = {}
        for group in sorted(GROUPS):
            members = {self.names[i] for i in self.groups[group]}
            trace = to_jax_tree(named, masked=set(self.names) - members)
            hyper = {"learning_rate": np.asarray(self.lr(group, last), np.float32),
                     "momentum": np.asarray(self.momentum(last), np.float32)}
            inject = optax_state(
                "InjectStatefulHyperparamsState", i32(self.count), hyper,
                {k: optax_state("WrappedScheduleState", i32(self.count)) for k in hyper},
                (optax_state("TraceState", trace), empty))
            groups[group] = optax_state("MaskedState", (empty, empty, inject))
        state = optax_state("PartitionState", groups)
        if self.accumulate > 1:
            state = optax_state("MultiStepsState", i32(self.mini_step), i32(self.count), state,
                                to_jax_tree(dict(zip(self.names, self.acc))), ())
        return state

    def load_optax_state(self, state: Any) -> None:
        """Take the state from `optax_state`'s structure (stand-ins, as
        `utils.weights.read_checkpoint` gives them), as either package writes it."""
        mini_step = 0
        if self.accumulate > 1:
            if getattr(state, "name", None) != "MultiStepsState":
                raise ValueError(f"accumulate {self.accumulate} needs a MultiStepsState, "
                                 f"got {getattr(state, 'name', type(state).__name__)}")
            mini_step, gradient_step, state, acc, _ = state
            acc = from_jax_tree(acc)
        (inner_states,) = state  # PartitionState
        trace, counts = {}, set()
        for group in GROUPS:
            (chain,) = inner_states[group]  # MaskedState
            inject = chain[2]
            counts.add(int(inject[0]))
            trace.update(from_jax_tree(inject[3][0][0]))  # the TraceState's trace
        if set(trace) != set(self.names):
            raise ValueError("optimizer state was saved for other parameters: "
                             f"{sorted(set(trace) ^ set(self.names))[:5]}")
        if len(counts) != 1 or (self.accumulate > 1 and int(gradient_step) not in counts):
            raise ValueError(f"optimizer groups disagree on the update count: {sorted(counts)}")
        with torch.no_grad():
            for t, n in zip(self.trace, self.names):
                t.copy_(torch.from_numpy(np.ascontiguousarray(trace[n])))
            for a, n in zip(self.acc, self.names):
                a.copy_(torch.from_numpy(np.ascontiguousarray(acc[n])))
        self.mini_step, self.count = int(mini_step), counts.pop()


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], updates: int,
               decay: float, tau: float) -> None:
    """ModelEMA's ramped decay (reference torch_utils.py:495), in place:
    ``e = e d + p (1 - d)`` with ``d = decay (1 - exp(-updates / tau))``."""
    d = decay * (1.0 - math.exp(-updates / tau))
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=1.0 - d)


class Trainer:
    """The train step of detection models, its loss chosen by ``model.task``:
    `detection_loss` (detect), `obb_loss` (OBB), `segmentation_loss` (segment)
    and `pose_loss` (pose).

    A batch is a dict of ``img`` ``[B, H, W, 3]`` uint8 (divided by 255 in
    f32, then cast to the compute dtype) or float in [0, 1]; ``cls`` ``[B, M]``
    int; ``bboxes`` ``[B, M, 4]`` normalized xywh (detect, segment, pose) or
    ``[B, M, 5]`` normalized xywhr (OBB); ``mask`` ``[B, M]`` bool; segment
    adds ``masks`` ``[B, M, H/4, W/4]`` (0/1, uint8 from the loader), pose
    ``keypoints`` ``[B, M, nk, 3]``.
    Tensors or numpy arrays; they are moved to the model's device (a tensor
    already there is used as it is). Lists and strings (file names) are left out.

    Runs on ``cuda`` unless ``device`` names another device (the ``mesh``'s
    device when one is given), and raises when no card is present and the CPU
    was not asked for. The model is moved there. With a ``mesh`` of several
    ranks its state is first made rank 0's (`parallel.mesh.replicate`), and
    `step` takes this rank's rows of each global batch. A model with int8
    convs is refused: that form rounds its operands and has no gradient.
    """

    def __init__(self, model: DetectionModel, cfg: TrainConfig, steps_per_epoch: int,
                 device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
        if any(isinstance(m, QConv2D) and m.impl == "int8" for m in model.modules()):
            raise RuntimeError("impl='int8' is inference-only (its rounding has no gradient); "
                               "build the model with another impl to train it")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh is not None else device)
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(mesh, self.model)
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.loss_hyp = LossHyp(box=cfg.box, cls=cfg.cls, dfl=cfg.dfl)
        named = dict(self.model.named_parameters())
        self.param_names = list(named)
        self.params = list(named.values())
        self.opt = Optimizer(cfg, named, steps_per_epoch)
        self.accumulate = self.opt.accumulate
        # the IQBN running statistics (the JAX ``batch_stats``); EMA covers parameters only
        persistent = set(self.model.state_dict())
        self.stats = [b for n, b in self.model.named_buffers() if n in persistent]
        with torch.no_grad():
            self.ema = [p.detach().clone() for p in self.params]
        self._stats_before = [torch.empty_like(b) for b in self.stats]
        self.steps = 0  # micro-steps taken (skipped ones not counted)

    def _batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        # ``to`` returns a tensor already on the device itself: no second copy
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                if not isinstance(v, (list, tuple, str))}

    def loss(self, batch: Mapping) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward in train mode (the IQBN running statistics move) and the loss."""
        b = self._batch(batch)
        img = b["img"]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        self.model.train()
        with train_graph():  # the train graph's conv forms, as the JAX trainer's loss trace
            out = self.model(img.to(self.dtype))
        return self.head_loss(out, b)

    def head_loss(self, out, batch: Mapping) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The task's loss of the head's output ``out`` on a batch already on the device."""
        m = self.model
        kw = dict(hyp=self.loss_hyp, assigner_bf16=self.cfg.assigner_bf16,
                  assigner_impl=self.cfg.assigner_impl, topk_impl=self.cfg.topk_impl)
        if m.task == "pose":
            return pose_loss(out, batch, m.strides, m.nc, m.kpt_shape, m.reg_max, **kw)
        loss_fn = {"obb": obb_loss, "segment": segmentation_loss}.get(m.task, detection_loss)
        return loss_fn(out, batch, m.strides, m.nc, m.reg_max, **kw)

    def step(self, batch: Mapping, sharded: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One micro-step: loss, gradients, and the optimizer and EMA update
        when it completes an accumulation. Returns ``(loss, aux)``; ``aux``
        holds the loss terms and ``nan_skipped`` (1.0 when a non-finite loss
        or gradient left the state unchanged).

        Under a mesh over a process group ``batch`` is this rank's rows of the
        global batch (``sharded``, the default), and the loss and terms
        returned are the global batch's; ``sharded=False`` marks a batch
        that every rank holds whole (`parallel.mesh.shard_batch` of rows that
        do not divide), which needs no reduction."""
        dp = self.mesh is not None and self.mesh.grouped and sharded is not False
        with torch.no_grad():
            torch._foreach_copy_(self._stats_before, self.stats)
        with data_parallel(self.mesh if dp else None):
            total, aux = self.loss(batch)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if dp:  # the ranks' parts of the global loss: their sums are the global batch's
            total = total.detach().clone()
            aux = {k: v.detach().clone() for k, v in aux.items()}
            all_reduce_(self.mesh, [total, *aux.values(), *grads])
        # one host sync a micro-step
        finite = not self.cfg.guard_nan or _all_finite([total.detach(), *grads])
        if finite:
            if self.opt.step(self.params, grads):
                ema_update(self.ema, self.params, self.opt.count, self.cfg.ema_decay,
                           self.cfg.ema_tau)
            self.steps += 1
        else:
            with torch.no_grad():
                torch._foreach_copy_(self.stats, self._stats_before)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["nan_skipped"] = torch.tensor(0.0 if finite else 1.0)
        return total.detach(), aux

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[DetectionModel]:
        """The model with the EMA parameters in place of the training ones and
        the IQBN running statistics as they are (the JAX
        ``TrainState.variables(ema=True)``); the training parameters are put
        back on exit."""
        with torch.no_grad():
            saved = [p.detach().clone() for p in self.params]
            torch._foreach_copy_(self.params, self.ema)
        try:
            yield self.model
        finally:
            with torch.no_grad():
                torch._foreach_copy_(self.params, saved)

    def fit(self, train_loader_fn: Callable[[int], Iterable[Mapping]],
            validate_fn: Optional[Callable[["Trainer"], Dict[str, float]]] = None,
            epochs: Optional[int] = None, start_epoch: int = 0,
            save_dir: Optional[Union[str, Path]] = None,
            close_mosaic_hook: Optional[Callable[[int], None]] = None, close_mosaic: int = 10,
            log: Callable[[str], Any] = print, callbacks=None) -> List[Dict[str, float]]:
        """The epoch loop (the JAX ``Trainer.fit``; reference BaseTrainer._do_train
        trainer.py:319-477): train on ``train_loader_fn(epoch)``, which
        `prefetch_to_device` runs two batches ahead of the step (the loader of
        an epoch is made after ``close_mosaic_hook``), validate with
        ``validate_fn(self)`` (which runs the EMA weights through `ema_weights`),
        keep ``last.ckpt`` and ``best.ckpt`` and ``results.json`` in
        ``save_dir``, stop after ``cfg.patience`` epochs without a better fitness.
        Under a mesh ``train_loader_fn`` gives this rank's rows of each batch
        (``build_dataloader(rows=process_batch_slice(...))``); every rank
        validates (a mesh `Validator` gathers the detections), rank 0 writes.

        Fitness is 0.9 mAP50-95 + 0.1 mAP50, or minus the mean loss without a
        validator; the first epoch is always the best so far. Each epoch's
        losses stay on the device and are fetched once. Returns the history,
        one row a epoch, also kept as ``self.history``.
        """
        epochs = epochs or self.cfg.epochs
        best_fitness: Optional[float] = None
        best_epoch = -1
        history: List[Dict[str, float]] = []
        if self.mesh is not None and self.mesh.rank > 0:  # rank 0 writes and logs for all
            save_dir, callbacks, log = None, None, (lambda msg: None)
        out = Path(save_dir) if save_dir else None
        if out:
            out.mkdir(parents=True, exist_ok=True)
        if callbacks is not None:
            callbacks.run("on_train_start")
        for epoch in range(start_epoch, epochs):
            if close_mosaic_hook and epoch == max(epochs - close_mosaic, 0):
                close_mosaic_hook(epoch)  # reference close_mosaic (trainer.py:354)
            if callbacks is not None:
                callbacks.run("on_train_epoch_start")
            t0 = time.time()
            batches = prefetch_to_device(train_loader_fn(epoch), self.device, size=2)
            with contextlib.closing(batches):  # stops the producer if a step raises
                losses = [self.step(batch)[0] for batch in batches]
            losses = torch.stack(losses).float().cpu().tolist() if losses else []
            row = {"epoch": epoch, "loss": float(sum(losses) / len(losses)) if losses else float("nan"),
                   "time_s": round(time.time() - t0, 2)}
            fitness = row["loss"] * -1.0  # without a validator
            if validate_fn is not None:
                metrics = validate_fn(self)
                row.update(metrics)
                fitness = metrics.get("mAP50-95", 0.0) * 0.9 + metrics.get("mAP50", 0.0) * 0.1
            row["fitness"] = fitness
            history.append(row)
            if callbacks is not None:
                callbacks.run("on_train_epoch_end")
                callbacks.run("on_fit_epoch_end", row)
            log(f"epoch {epoch}: " + " ".join(f"{k}={v:.4g}" for k, v in row.items() if k != "epoch"))
            if out:
                self.save_checkpoint(out / "last.ckpt", epoch)
                if best_fitness is None or fitness > best_fitness:
                    best_fitness, best_epoch = fitness, epoch
                    self.save_checkpoint(out / "best.ckpt", epoch)
                (out / "results.json").write_text(json.dumps(history, indent=2))
                if callbacks is not None:
                    callbacks.run("on_model_save", out / "last.ckpt")
            if epoch - best_epoch > self.cfg.patience:
                log(f"early stopping: no fitness improvement in {self.cfg.patience} epochs")
                break
        self.history = history
        if callbacks is not None:
            callbacks.run("on_train_end",
                          (out / "best.ckpt") if out and (out / "best.ckpt").exists() else None)
        return history

    def save_checkpoint(self, path: Union[str, Path], epoch: int) -> None:
        """The whole train state as the JAX ``Trainer.save_checkpoint`` pickles it,
        ``{epoch, step, params, batch_stats, ema_params, opt_state}``: flax-layout
        numpy trees and the optax state of `Optimizer.optax_state`, which JAX's
        ``pickle.load`` reads as optax's own classes."""
        variables = export_jax_variables(self.model)
        write_checkpoint(path, {
            "epoch": epoch, "step": self.steps, "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "ema_params": to_jax_tree(dict(zip(self.param_names, self.ema))),
            "opt_state": self.opt.optax_state()})

    def restore_checkpoint(self, path: Union[str, Path]) -> int:
        """Resume from a checkpoint of either package's trainer (read with numpy
        alone); returns the next epoch."""
        ck = read_checkpoint(path)
        load_jax_variables(self.model, {"params": ck["params"], "batch_stats": ck["batch_stats"]})
        ema = from_jax_tree(ck["ema_params"])
        with torch.no_grad():
            for e, n in zip(self.ema, self.param_names):
                e.copy_(torch.from_numpy(np.ascontiguousarray(ema[n])))
        self.opt.load_optax_state(ck["opt_state"])
        self.steps = int(ck["step"])
        return int(ck["epoch"]) + 1
