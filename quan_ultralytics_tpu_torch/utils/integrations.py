"""Experiment-logger integrations for the callback bus (counterpart of the
JAX package's ``utils/integrations.py``).

Mirrors the reference's import-gated logger callbacks
(ultralytics/utils/callbacks/{wb,mlflow,comet,clearml,dvc,neptune,raytune}.py):
each integration activates only if its client library imports and its
setting (`utils.settings.SETTINGS`) is on, subscribes to the same events, and
is left out otherwise. Payloads are the trainer's plain dicts (epoch metrics
row, run args) rather than the reference's trainer object; the logged content
is the same: run config at pretrain end, scalar metrics per fit epoch, the
best checkpoint as a model artifact at train end. Each client library is
imported only inside its ``_try_*``; the tests put recorder fakes into
``sys.modules`` (tests/test_torch_cli.py).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

from quan_ultralytics_tpu_torch.utils.callbacks import Callbacks, CSVLogger, try_tensorboard
from quan_ultralytics_tpu_torch.utils.logging import LOGGER


def _sanitize(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Numeric-only metrics with mlflow-safe keys (reference mlflow.py:42-44)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, (int, float)):
            out[k.replace("(", "").replace(")", "")] = float(v)
    return out


class _Integration:
    """Shared shape: subscribe to the reference's event vocabulary.

    Every handler is wrapped so a misconfigured or flaky logger client
    (not logged in, unreachable tracking server, transient network error)
    warns and is dropped instead of killing a multi-hour training run —
    the same contract as the reference's try/except-per-callback bodies."""

    def attach(self, callbacks: Callbacks) -> None:
        for event, fn in (("on_pretrain_routine_end", self.on_pretrain_routine_end),
                          ("on_fit_epoch_end", self.on_fit_epoch_end),
                          ("on_train_end", self.on_train_end)):
            callbacks.add(event, self._guard(event, fn))

    def _guard(self, event: str, fn):
        def run(*a, **kw):
            try:
                fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 — logger failure is non-fatal
                LOGGER.warning(f"{type(self).__name__}.{event} failed ({e!r}); "
                               "integration logging skipped")
        return run

    def on_pretrain_routine_end(self, args: Dict[str, Any]) -> None:  # pragma: no cover
        pass

    def on_fit_epoch_end(self, metrics: Dict[str, Any]) -> None:  # pragma: no cover
        pass

    def on_train_end(self, best_path: Optional[Path]) -> None:  # pragma: no cover
        pass


def _try_wandb(args: Dict[str, Any]):
    """reference wb.py:109-170: init run, log per-epoch metrics, artifact best."""
    try:
        import wandb as wb

        assert hasattr(wb, "__version__")
    except Exception:
        return None

    class WandB(_Integration):
        def on_pretrain_routine_end(self, a):
            if not getattr(wb, "run", None):
                wb.init(project=str(a.get("project") or "QUAN-TORCH").replace("/", "-"),
                        name=str(a.get("name") or "train").replace("/", "-"), config=a)

        def on_fit_epoch_end(self, metrics):
            wb.run.log(_sanitize(metrics), step=int(metrics.get("epoch", 0)) + 1)

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                art = wb.Artifact(type="model", name=f"run_{wb.run.id}_model")
                art.add_file(str(best_path))
                wb.run.log_artifact(art, aliases=["best"])
            wb.run.finish()

    return WandB()


def _try_mlflow(args: Dict[str, Any]):
    """reference mlflow.py:47-137: tracking URI + experiment from env, params
    once, sanitized metrics per epoch, artifact dir at end."""
    try:
        import mlflow

        assert hasattr(mlflow, "__version__")
    except Exception:
        return None

    class MLflow(_Integration):
        def on_pretrain_routine_end(self, a):
            uri = os.environ.get("MLFLOW_TRACKING_URI") or str(
                Path(a.get("save_dir", "runs")) / "mlflow")
            mlflow.set_tracking_uri(uri)
            mlflow.set_experiment(os.environ.get("MLFLOW_EXPERIMENT_NAME")
                                  or str(a.get("project") or "/QUAN-TORCH"))
            if not mlflow.active_run():
                mlflow.start_run(run_name=os.environ.get("MLFLOW_RUN")
                                 or str(a.get("name") or "train"))
            mlflow.log_params({k: str(v) for k, v in a.items()})

        def on_fit_epoch_end(self, metrics):
            mlflow.log_metrics(_sanitize(metrics), step=int(metrics.get("epoch", 0)))

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                mlflow.log_artifact(str(best_path))
            if os.environ.get("MLFLOW_KEEP_RUN_ACTIVE", "").lower() != "true":
                mlflow.end_run()

    return MLflow()


def _try_comet(args: Dict[str, Any]):
    """reference comet.py: one Experiment per run, parameters + metrics."""
    try:
        import comet_ml

        assert hasattr(comet_ml, "__version__")
    except Exception:
        return None

    class Comet(_Integration):
        def __init__(self):
            self.exp = comet_ml.Experiment(
                project_name=str(args.get("project") or "quan-torch"))
            self.exp.log_parameters(args)

        def on_fit_epoch_end(self, metrics):
            self.exp.log_metrics(_sanitize(metrics),
                                 step=int(metrics.get("epoch", 0)) + 1)

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                self.exp.log_model("best", str(best_path))
            self.exp.end()

    return Comet()


def _try_clearml(args: Dict[str, Any]):
    """reference clearml.py: Task.init + connect(args) + scalar reports."""
    try:
        from clearml import Task

        assert hasattr(Task, "init")
    except Exception:
        return None

    class ClearML(_Integration):
        def __init__(self):
            self.task = Task.current_task() or Task.init(
                project_name=str(args.get("project") or "QUAN-TORCH"),
                task_name=str(args.get("name") or "train"),
                auto_connect_frameworks={"pytorch": False, "matplotlib": False})
            self.task.connect(dict(args))

        def on_fit_epoch_end(self, metrics):
            step = int(metrics.get("epoch", 0))
            for k, v in _sanitize(metrics).items():
                self.task.get_logger().report_scalar("train", k, v, step)

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                self.task.update_output_model(model_path=str(best_path),
                                              model_name="best", auto_delete_file=False)

    return ClearML()


def _try_dvclive(args: Dict[str, Any]):
    """reference dvc.py: dvclive.Live metric stream + model artifact."""
    try:
        import dvclive

        assert hasattr(dvclive, "Live")
    except Exception:
        return None

    class DVC(_Integration):
        def __init__(self):
            self.live = dvclive.Live(save_dvc_exp=True, cache_images=False)

        def on_fit_epoch_end(self, metrics):
            for k, v in _sanitize(metrics).items():
                self.live.log_metric(k, v)
            self.live.next_step()

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                self.live.log_artifact(str(best_path), type="model", copy=True)
            self.live.end()

    return DVC()


def _try_neptune(args: Dict[str, Any]):
    """reference neptune.py: init_run + per-series append + best upload."""
    try:
        import neptune

        assert hasattr(neptune, "init_run")
    except Exception:
        return None

    class Neptune(_Integration):
        def __init__(self):
            self.run = neptune.init_run(
                project=os.environ.get("NEPTUNE_PROJECT"),
                name=str(args.get("name") or "train"))
            self.run["Configuration/Hyperparameters"] = {
                k: "" if v is None else str(v) for k, v in args.items()}

        def on_fit_epoch_end(self, metrics):
            step = int(metrics.get("epoch", 0)) + 1
            for k, v in _sanitize(metrics).items():
                self.run[k].append(v, step=step)

        def on_train_end(self, best_path):
            if best_path is not None and Path(best_path).exists():
                self.run["weights/best"].upload(str(best_path))
            self.run.stop()

    return Neptune()


def _try_raytune(args: Dict[str, Any]):
    """reference raytune.py:19-28: report metrics into an active Ray session."""
    try:
        from ray import train as ray_train
        from ray.train._internal.session import get_session

        if get_session() is None:
            return None
    except Exception:
        return None

    class RayTune(_Integration):
        def on_fit_epoch_end(self, metrics):
            ray_train.report({**_sanitize(metrics),
                              "epoch": int(metrics.get("epoch", 0)) + 1})

    return RayTune()


_FACTORIES = (("wandb", _try_wandb), ("mlflow", _try_mlflow),
              ("comet", _try_comet), ("clearml", _try_clearml),
              ("dvc", _try_dvclive), ("neptune", _try_neptune),
              ("raytune", _try_raytune))


def build_callbacks(save_dir: str, args: Optional[Dict[str, Any]] = None) -> Callbacks:
    """Callback bus with every available logger attached.

    Always attaches the CSV results logger; TensorBoard and the third-party
    integrations attach only when their libraries import (reference
    callbacks/base.py add_integration_callbacks :186-217).
    """
    from quan_ultralytics_tpu_torch.utils.settings import SETTINGS

    cb = Callbacks()
    CSVLogger(save_dir).attach(cb)
    if SETTINGS["tensorboard"]:
        tb = try_tensorboard(save_dir)
        if tb is not None:
            tb.attach(cb)
    a = dict(args or {})
    a.setdefault("save_dir", save_dir)
    for name, factory in _FACTORIES:
        # per-integration enable gate (reference mlflow.py:30
        # `assert SETTINGS["mlflow"] is True`, etc.)
        if SETTINGS[name] is not True:
            continue
        try:
            integ = factory(a)
        except Exception:
            integ = None
        if integ is not None:
            integ.attach(cb)
    cb.run("on_pretrain_routine_end", a)
    return cb
