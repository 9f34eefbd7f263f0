"""Callback event bus (counterpart of the JAX package's ``utils/callbacks.py``;
reference utils/callbacks/base.py:144-184).

Same event vocabulary as the reference (~25 hooks), the CSV results log
(the reference's trainer.save_metrics) and TensorBoard where
``torch.utils.tensorboard`` imports. `utils/integrations.py` attaches them
and the other loggers.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List

EVENTS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    "on_export_start", "on_export_end",
]


class Callbacks:
    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown callback event {event!r}")
        self._hooks[event].append(fn)

    def run(self, event: str, *args, **kwargs) -> None:
        for fn in self._hooks.get(event, []):
            fn(*args, **kwargs)


class CSVLogger:
    """Per-epoch results.csv (reference trainer.save_metrics :658)."""

    def __init__(self, save_dir: str):
        self.path = Path(save_dir) / "results.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys = None

    def on_fit_epoch_end(self, metrics: Dict[str, Any]) -> None:
        write_header = self._keys is None
        if write_header:
            self._keys = list(metrics)
        with open(self.path, "a", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=self._keys)
            if write_header:
                w.writeheader()
            w.writerow({k: metrics.get(k) for k in self._keys})

    def attach(self, callbacks: Callbacks) -> None:
        callbacks.add("on_fit_epoch_end", self.on_fit_epoch_end)


def try_tensorboard(save_dir: str):
    """Per-epoch scalars to TensorBoard (reference callbacks/tensorboard.py),
    or None when ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None

    writer = SummaryWriter(str(save_dir))

    class TB:
        def on_fit_epoch_end(self, metrics: Dict[str, Any]) -> None:
            step = int(metrics.get("epoch", 0))
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    writer.add_scalar(k, v, step)

        def on_train_end(self, best_path) -> None:
            writer.close()

        def attach(self, callbacks: Callbacks) -> None:
            callbacks.add("on_fit_epoch_end", self.on_fit_epoch_end)
            callbacks.add("on_train_end", self.on_train_end)

    return TB()
