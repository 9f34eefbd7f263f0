"""YOLO model facade: the user-facing entry point (counterpart of the JAX
package's ``engine/model.py``; reference engine/model.py Model :29).

``YOLO("yolo11n-quan.yaml")`` (detect), ``YOLO("yolo11n-obb-quan.yaml")``
(OBB), ``YOLO("yolo11n-seg-quan.yaml")`` (segment) or
``YOLO("yolo11n-pose-quan.yaml")`` (pose), or ``YOLO("<path>/my-model.yaml")``
for a model YAML of the user's own, then ``.train(...)`` / ``.val(...)`` /
``.predict(...)``, on ``cuda`` unless ``device`` names another device (with
no card and no ``device="cpu"`` it raises). Weights live in the port model;
checkpoints are the JAX facade's pickled payload
``{model_yaml, nc, names, params, batch_stats, raw_params, step}`` with the
weights in the flax layout (`utils.weights.export_jax_variables`), so each
package reads the other's ``.pkl`` files.

Where the JAX facade starts training from ``init(PRNGKey(seed))`` whatever
it loaded, this one trains the weights it holds (the model's seeded draw, or
a loaded checkpoint), as the reference's ``Model.train`` does.

``YOLO("m.pt2")`` takes an artifact of ``export(format="exported")``
(`engine.exporter.ExportedBackend`): it predicts at its fixed size, on the
device it was exported on, and does nothing else.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from quan_ultralytics_tpu_torch.data.augment import AugmentHyp, letterbox
from quan_ultralytics_tpu_torch.data.build import build_dataloader
from quan_ultralytics_tpu_torch.data.dataset import YOLODataset
from quan_ultralytics_tpu_torch.data.loaders import load_source
from quan_ultralytics_tpu_torch.engine.predictor import Predictor, Results
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.engine.validator import Validator
from quan_ultralytics_tpu_torch.models.tasks import (FUSED_1X1, STEM_DEEP, STEM_S2D, DetectionModel,
                                                     resolve_device)
from quan_ultralytics_tpu_torch.parallel.distributed import process_batch_slice
from quan_ultralytics_tpu_torch.parallel.mesh import Mesh, replicate
from quan_ultralytics_tpu_torch.utils import checkpoint
from quan_ultralytics_tpu_torch.utils.weights import (export_jax_variables, load_jax_variables,
                                                      read_checkpoint)

class YOLO:
    """``YOLO(model_yaml_or_ckpt)``; the task follows the head module.

    dtype: the activation dtype of predict and val (None: the input's, f32);
    training casts to `TrainConfig.dtype` (bf16 by default) as the JAX trainer does.
    fused_1x1: run the 1x1 Conv+IQBN+SiLU sites through the fused kernel in eval
    (on by default: `models.tasks.FUSED_1X1`).
    stem_s2d, stem_deep: the stem's form (`models.tasks.QUANYOLO`; defaults
    `models.tasks.STEM_S2D` and `STEM_DEEP`), where the JAX facade reads
    ``QUAN_STEM_S2D`` and ``QUAN_STEM_DEEP``; the weights are the same.
    """

    def __init__(self, model: str = "yolo11n-obb-quan.yaml", nc: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[Union[str, torch.device]] = None, fused_1x1: bool = FUSED_1X1,
                 stem_s2d: bool = STEM_S2D, stem_deep: int = STEM_DEEP):
        self.device = resolve_device(device)
        self.dtype, self.fused_1x1 = dtype, fused_1x1
        self.stem = {"stem_s2d": stem_s2d, "stem_deep": stem_deep}
        if str(model).endswith(".pt2"):
            from quan_ultralytics_tpu_torch.engine.exporter import ExportedBackend

            self.model = ExportedBackend(str(model))
            self.model_yaml, self.names = self.model.meta.get("model_yaml"), self.model.names
            self.task = self.model.task
            return
        if str(model).endswith((".pkl", ".ckpt")):
            payload = read_checkpoint(model)
            self.model_yaml, self.names = payload["model_yaml"], payload.get("names")
            self.model = self._build(payload["nc"])
            load_jax_variables(self.model, {"params": payload["params"],
                                            "batch_stats": payload["batch_stats"]})
        else:
            self.model_yaml, self.names = str(model), None
            self.model = self._build(nc)
        self.task = self.model.task

    def _build(self, nc: Optional[int]) -> DetectionModel:
        return DetectionModel.from_yaml(self.model_yaml, nc=nc, dtype=self.dtype, device=self.device,
                                        fused_1x1=self.fused_1x1, **self.stem)

    # ------------------------------------------------------------------
    def train(self, data: Union[str, Dict], epochs: int = 100, batch: int = 16,
              imgsz: int = 640, max_labels: int = 128, save_dir: str = "runs/train",
              close_mosaic: int = 10, resume: Union[None, bool, str] = None,
              cache: Optional[str] = None, log: Callable[[str], Any] = print,
              mesh: Optional[Mesh] = None, **overrides) -> Dict[str, float]:
        """Train on a YOLO-format dataset yaml (reference Model.train :742).

        mesh: data parallelism over the ranks of a process group
        (`parallel.mesh.make_mesh`; one process a rank, as ``torchrun``
        starts them): ``batch`` is the global batch, each rank loads and steps
        on its rows, validates with a mesh `Validator`, and rank 0 writes the
        checkpoints and logs.

        overrides: `TrainConfig` fields, `AugmentHyp` gains and ``multi_scale``;
        other keys are recorded in the loggers' run arguments only.
        resume: a checkpoint file, a run directory, or True for ``save_dir``;
        the run continues from its `utils.checkpoint.latest` checkpoint.
        Writes ``last.pkl`` and ``best.pkl`` (the facade format) beside the
        trainer's checkpoints and holds the best epoch's EMA weights after.
        """
        ds = YOLODataset(data, split="train", task=self.task, cache=cache)
        if self.model.nc != ds.nc:
            self.model = self._build(ds.nc)
        self.names = ds.names
        aug_overrides = {k: v for k, v in overrides.items()
                         if hasattr(AugmentHyp, k) and not hasattr(TrainConfig, k)}
        cfg = TrainConfig(epochs=epochs, batch=batch,
                          **{k: v for k, v in overrides.items() if hasattr(TrainConfig, k)})
        multi_scale = bool(overrides.get("multi_scale", False))
        rows = None if mesh is None or mesh.world_size == 1 else process_batch_slice(mesh.world_size, batch)
        trainer = Trainer(self.model, cfg, max(len(ds) // batch, 1), device=self.device, mesh=mesh)
        start_epoch = 0
        if resume:
            where = save_dir if resume is True else resume
            ck = checkpoint.latest(where) if Path(where).is_dir() else str(where)
            if ck is None or not Path(ck).exists():
                raise FileNotFoundError(f"resume={resume!r}: no checkpoint to resume from")
            start_epoch = trainer.restore_checkpoint(ck)
            log(f"resumed from {ck} at epoch {start_epoch}")
        val_ds = YOLODataset(data, split="val", task=self.task)
        if not len(val_ds):  # no val split: validate on the train images
            val_ds = ds
        validator = Validator(self.model, imgsz=imgsz, mesh=mesh)
        hyp = AugmentHyp(**aug_overrides)

        def train_loader(epoch):
            return build_dataloader(ds, batch, imgsz, hyp=hyp if hyp.mosaic else None,
                                    max_labels=max_labels, seed=epoch,
                                    augment=hyp.mosaic > 0 or epoch < epochs,
                                    multi_scale=multi_scale, rows=rows)

        def close_mosaic_hook(epoch):
            hyp.mosaic = 0.0  # reference close_mosaic (trainer.py:354)

        def validate(tr: Trainer) -> Dict[str, float]:
            with tr.ema_weights():
                return validator(val_ds, batch_size=batch)

        # callback bus: CSV results, TensorBoard and any importable logger
        # integration (reference Model.train wires add_integration_callbacks)
        from quan_ultralytics_tpu_torch.utils.integrations import build_callbacks

        main_rank = mesh is None or mesh.rank == 0
        callbacks = build_callbacks(save_dir, args={
            "data": data if isinstance(data, str) else "<dict>",
            "epochs": epochs, "batch": batch, "imgsz": imgsz,
            "task": self.task, "model": self.model_yaml, **overrides,
        }) if main_rank else None
        trainer.fit(train_loader, validate, epochs=epochs, start_epoch=start_epoch,
                    save_dir=save_dir, close_mosaic_hook=close_mosaic_hook,
                    close_mosaic=close_mosaic, log=log, callbacks=callbacks)
        # facade-format checkpoints too, and the best EMA weights held, as the
        # reference Model.train (:812-815)
        out_dir = Path(save_dir)
        if main_rank:
            self._save_ckpt(out_dir / "last.pkl", trainer)
            if (out_dir / "best.ckpt").exists():
                trainer.restore_checkpoint(out_dir / "best.ckpt")
                self._save_ckpt(out_dir / "best.pkl", trainer)
        if mesh is not None:  # every rank holds rank 0's (the best epoch's) weights
            replicate(mesh, trainer.params)
            replicate(mesh, trainer.ema)
            replicate(mesh, trainer.stats)
        with torch.no_grad():
            torch._foreach_copy_(trainer.params, trainer.ema)
        self.model.eval()
        return trainer.history[-1] if trainer.history else {}

    def _save_ckpt(self, path: Path, trainer: Trainer) -> None:
        with trainer.ema_weights() as m:
            ema = export_jax_variables(m)
        payload = {
            "model_yaml": self.model_yaml,
            "nc": self.model.nc,
            "names": self.names,
            "params": ema["params"],
            "batch_stats": ema["batch_stats"],
            "raw_params": export_jax_variables(trainer.model)["params"],
            "step": int(trainer.steps),
        }
        path.write_bytes(pickle.dumps(payload))

    def val(self, data: Union[str, Dict], split: str = "val", imgsz: int = 640,
            batch: int = 8, conf: float = 0.001, iou: float = 0.7,
            save_json: Optional[str] = None, save_submission: Optional[str] = None,
            cache: Optional[str] = None, rect: bool = False, mask_native: bool = False,
            save_dir: Optional[str] = None, mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """Validate on a split (reference Model.val); prints the per-class
        table and the confusion matrix as the reference's BaseValidator does.
        rect: rectangular batches (not OBB).
        mask_native: segment only: masks scored at the input's resolution.
        save_dir: the per-class table as ``per_class.txt``, the validation
        curves and the confusion matrices (`Validator`).
        mesh: each rank infers its rows of every batch (the JAX ``mesh=``);
        every rank returns the single-process metrics."""
        ds = YOLODataset(data, split=split, task=self.task, cache=cache)
        validator = Validator(self.model, imgsz=imgsz, conf=conf, iou=iou, mesh=mesh)
        out = validator(ds, batch_size=batch, save_json=save_json,
                        save_submission=save_submission, rect=rect, mask_native=mask_native,
                        save_dir=save_dir)
        names = dict(enumerate(ds.names))
        if mesh is None or mesh.rank == 0:
            print(validator.metrics.per_class_table(names))
            print(validator.confusion.summary(names=list(names.values())))
        self.confusion = validator.confusion
        self.metrics = validator.metrics
        return out

    def predict(self, source, imgsz: int = 640, conf: float = 0.25, iou: float = 0.45,
                max_det: int = 300, visualize=False, mesh: Optional[Mesh] = None) -> List[Results]:
        """Frames, a path or a directory -> one `Results` each (reference
        Model.predict). An exported artifact predicts at its own size.

        visualize: a directory (or True for ``runs/visualize``) to write the
          feature grid of every layer into, ``stage{i}_{Module}_features.png``
          (reference nn/tasks.py:140 and utils/plotting.py:1346), one ``im{b}``
          directory per image when there are several; one batched `features`
          pass over the letterboxed frames. An exported artifact has no
          `features` and writes none, as the JAX facade skips them.
        mesh: each rank infers its rows of the frames and every rank returns
          every frame's Results (`Predictor`)."""
        self.model.eval()
        imgsz = getattr(self.model, "imgsz", imgsz)
        predictor = Predictor(self.model, imgsz=imgsz, conf=conf, iou=iou,
                              max_det=max_det, names=self.names, mesh=mesh)
        results = predictor(source)
        if visualize and hasattr(self.model, "features") and results:
            self._visualize(results, imgsz, Path(visualize if isinstance(visualize, (str, Path))
                                                 else "runs/visualize"))
        return results

    @torch.inference_mode()
    def _visualize(self, results: List[Results], imgsz: int, out_dir: Path) -> None:
        from quan_ultralytics_tpu_torch.utils.plotting import feature_visualization

        x = torch.stack([letterbox(torch.as_tensor(r.orig_img).to(self.device), imgsz)[0]
                         for r in results])
        _, feats = self.model.features(x.float() / 255.0)
        for bi in range(len(results)):
            d = out_dir if len(results) == 1 else out_dir / f"im{bi}"
            d.mkdir(parents=True, exist_ok=True)
            for i, f in sorted(feats.items()):
                feature_visualization(f[bi:bi + 1], d / f"stage{i}_{self.model.specs[i].module}_features.png")

    __call__ = predict

    @torch.inference_mode()
    def embed(self, source, layers: Optional[Sequence[int]] = None, imgsz: int = 640) -> np.ndarray:
        """Feature embeddings (reference engine/model.py:465 Model.embed,
        nn/tasks.py:163-166; the JAX facade's ``embed``): each frame's
        letterboxed features at ``layers`` (default: the second-to-last layer,
        the reference's ``embed=[len(model) - 2]``), averaged over space to
        ``[4 C]`` and concatenated in layer order. Returns ``[B, D]`` float32."""
        if isinstance(source, (str, Path)):
            images = list(load_source(source))
        elif isinstance(source, np.ndarray) and source.ndim == 3:
            images = [source]
        else:
            images = list(source)
        x = torch.stack([letterbox(torch.as_tensor(im).to(self.device), imgsz)[0] for im in images])
        layers = sorted(layers or [len(self.model.specs) - 2])
        self.model.eval()
        _, feats = self.model.features(x.float() / 255.0, layers=layers)
        pooled = [feats[i].float().mean(dim=(1, 2)).reshape(len(images), -1) for i in layers]
        return torch.cat(pooled, dim=1).cpu().numpy()

    def export(self, format: str = "exported", imgsz: int = 640, batch: int = 1,
               path: Optional[str] = None) -> str:
        """mode=export (reference Model.export :851; engine/exporter.py):
        ``exported``, a ``torch.export`` artifact of forward + decode (``.pt2``,
        reloaded by ``YOLO("model.pt2")``), or ``params``, the weights in the
        JAX payload (``.pkl``, read by ``YOLO`` of either package). The JAX
        package's stablehlo, tflite, saved_model and onnx formats raise, and
        so do its tflite options ``half`` and ``int8`` (unknown arguments)."""
        from quan_ultralytics_tpu_torch.engine import exporter

        if format == "exported":
            return exporter.export_compiled(self.model, imgsz=imgsz, batch=batch,
                                            path=path or "model.pt2", names=self.names,
                                            model_yaml=self.model_yaml)
        if format == "params":
            return exporter.export_params(self.model, self.model_yaml, names=self.names,
                                          path=path or "model.pkl")
        exporter.refuse(format)

    def tune(self, data: Union[str, Dict], iterations: int = 10, epochs: int = 5,
             imgsz: int = 640, batch: int = 16, save_dir: str = "runs/tune",
             **overrides) -> Dict[str, float]:
        """mode=tune (reference Model.tune :871; engine/tuner.py): mutation
        evolution over the training hyperparameters; each iteration trains a
        fresh model of this YAML for ``epochs`` epochs and scores its fitness
        (0.9 mAP50-95 + 0.1 mAP50, or minus the loss without one)."""
        from quan_ultralytics_tpu_torch.engine.tuner import Tuner

        base = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 5e-4,
                "warmup_epochs": 3.0, "box": 7.5, "cls": 0.5, "dfl": 1.5}
        it_count = [0]

        def train_fn(hyp):
            m = YOLO(self.model_yaml, dtype=self.dtype, device=self.device, fused_1x1=self.fused_1x1,
                     **self.stem)
            it_dir = str(Path(save_dir) / f"iter{it_count[0]}")
            it_count[0] += 1
            row = m.train(data, epochs=epochs, batch=batch, imgsz=imgsz,
                          save_dir=it_dir, log=lambda *a: None, **hyp, **overrides)
            return row.get("fitness", -row.get("loss", float("inf")))

        return Tuner(train_fn, base, save_dir=save_dir)(iterations)

    def track(self, frames: Iterable, imgsz: int = 640, conf: float = 0.25, iou: float = 0.45,
              tracker: str = "bytetrack", persist: bool = False) -> List[np.ndarray]:
        """mode=track (reference Model.track): detect each frame, then associate.

        frames: an iterable of uint8 RGB frames (a directory's images through
        `data.loaders.load_source`). Returns one ``[n, 7]`` array a frame: xyxy,
        track_id, score, cls. Detect-task models only, as the reference.
        ``tracker``: ``bytetrack`` or ``botsort`` (which gets each frame for
        its motion compensation), with or without the reference's ``.yaml``
        (the config's ``tracker: botsort.yaml``); ``persist`` keeps the
        tracker of the last call.
        """
        from quan_ultralytics_tpu_torch.trackers import BOTSORT, BYTETracker

        if self.task != "detect":
            raise ValueError("track mode requires a detect-task model")
        kind = tracker[:-len(".yaml")] if tracker.endswith(".yaml") else tracker
        if kind not in ("bytetrack", "botsort"):
            raise ValueError(f"tracker must be bytetrack or botsort, got {tracker!r}")
        if not persist or not hasattr(self, "_tracker"):
            self._tracker = BOTSORT() if kind == "botsort" else BYTETracker()
        self.model.eval()
        predictor = Predictor(self.model, imgsz=imgsz, conf=conf, iou=iou, names=self.names)
        outputs = []
        for frame in frames:
            res = predictor(frame)[0]
            kwargs = {"frame": np.asarray(frame)} if isinstance(self._tracker, BOTSORT) else {}
            outputs.append(self._tracker.update(res.boxes[:, :4], res.conf, res.cls, **kwargs))
        return outputs
