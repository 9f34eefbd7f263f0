"""`yolo`-style CLI of the PyTorch port (counterpart of the JAX package's
``cli.py``; reference ultralytics/cfg/__init__.py entrypoint :825):

    python -m quan_ultralytics_tpu_torch.cli detect train data=coco.yaml epochs=10
    python -m quan_ultralytics_tpu_torch.cli obb train model=yolo11n-obb-quan.yaml data=dota.yaml epochs=10
    python -m quan_ultralytics_tpu_torch.cli obb val model=runs/train/best.pkl data=dota.yaml
    python -m quan_ultralytics_tpu_torch.cli obb predict model=runs/train/best.pkl source=img.png
    python -m quan_ultralytics_tpu_torch.cli segment val model=runs/train/best.pkl data=coco.yaml
    python -m quan_ultralytics_tpu_torch.cli pose train data=coco-pose.yaml epochs=10
    python -m quan_ultralytics_tpu_torch.cli classify train data=cifar10 data_dir=data model=qwrn16_2
    python -m quan_ultralytics_tpu_torch.cli settings [reset | k=v ...]

(installed as ``yolo-torch``). It runs on ``cuda`` unless ``device=`` names
another device (``device=cpu``); with no card and no ``device=cpu`` it exits
non-zero. The task may be omitted; without ``model=`` the task's default
model is built (``yolo11n-quan.yaml`` for detect, ``yolo11n-seg-quan.yaml``
for segment, ``yolo11n-pose-quan.yaml`` for pose). ``classify`` trains only
(it validates every epoch) through the classification CLI
(`classification.cli`), as the JAX CLI routes it: ``data=cifar10|cifar100|
svhn|imagenet|synthetic`` names the dataset and ``data=<folder>`` an
ImageNet-layout folder; ``batch`` is ``--batch_size``, ``lr0`` ``--lr``, and
every other key passes as its flag. ``export`` writes ``format=exported``
(a ``.pt2``) or ``format=params`` (a ``.pkl``); ``track`` reads a video file
or a directory of frames; ``tune`` evolves the training
hyperparameters; ``benchmark`` prints the speed table of
`utils.benchmarks.benchmark`.

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``train`` and ``val`` run data
parallel, one process a rank, each on ``cuda:LOCAL_RANK`` unless ``device=``
names one (nccl for cards, gloo for ``device=cpu``); ``batch`` is the global
batch and rank 0 writes and prints:

    torchrun --nproc_per_node=2 -m quan_ultralytics_tpu_torch.cli obb train data=dota.yaml batch=16
"""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path
from typing import Any, Dict

MODES = ("train", "val", "predict", "export", "track", "tune", "benchmark",
         "settings")
TASKS = ("detect", "obb", "classify", "segment", "pose")
DEFAULT_MODELS = {
    "detect": "yolo11n-quan.yaml",
    "obb": "yolo11n-obb-quan.yaml",
    "segment": "yolo11n-seg-quan.yaml",
    "pose": "yolo11n-pose-quan.yaml",
}


def parse_kv(argv) -> Dict[str, Any]:
    out = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"expected k=v argument, got {a!r}")
        k, v = a.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def classify_flags(kv: Dict[str, Any]) -> list:
    """yolo-style ``k=v`` keys -> the classification CLI's flags: ``data=NAME``
    -> ``--dataset NAME``, ``data=<folder>`` -> ``--dataset imagenet --data_dir
    <folder>``, ``batch`` -> ``--batch_size``, ``lr0`` -> ``--lr``, ``k=True`` ->
    ``--k``, any other ``k=v`` -> ``--k v``."""
    from quan_ultralytics_tpu_torch.classification.cli import DATASET_CLASSES

    rename = {"batch": "batch_size", "lr0": "lr"}
    flags = []
    for k, v in kv.items():
        if k == "data":
            if str(v) in DATASET_CLASSES:
                flags += ["--dataset", str(v)]
            elif Path(str(v)).is_dir():
                flags += ["--dataset", "imagenet", "--data_dir", str(v)]
            else:
                raise SystemExit(f"classify data must be a known dataset or folder, got {v!r}")
            continue
        k = rename.get(k, k)
        flags += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return flags


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    task = None
    if argv and argv[0] in TASKS:
        task = argv.pop(0)
    if not argv or argv[0] not in MODES:
        print(__doc__)
        raise SystemExit(f"usage: yolo [task] MODE k=v...  (modes: {MODES})")
    mode = argv.pop(0)
    if mode == "settings":
        # reference special mode 'settings' (cfg/__init__.py handle_yolo_settings
        # :583): no args prints, k=v updates, 'reset' restores defaults
        from quan_ultralytics_tpu_torch.utils.settings import SETTINGS

        if argv and argv[0] == "reset":
            SETTINGS.reset()
            print(f"settings reset to defaults ({SETTINGS.file})")
            return 0
        updates = parse_kv(argv)
        if updates:
            try:
                SETTINGS.update(updates)
            except (KeyError, TypeError) as e:
                raise SystemExit(f"settings error: {e.args[0]}")
        print(json.dumps(dict(SETTINGS), indent=2))
        return 0
    kv = parse_kv(argv)
    if mode == "benchmark":
        return benchmark_mode(kv)
    if task == "classify":
        if mode != "train":
            raise SystemExit("classify supports mode=train (val runs every epoch)")
        from quan_ultralytics_tpu_torch.classification.cli import main as cls_main

        return cls_main(classify_flags(kv))
    from quan_ultralytics_tpu_torch.cfg import validate_overrides

    try:
        validate_overrides(kv)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"config error: {e.args[0]}")
    if mode in ("train", "val") and "data" not in kv:
        raise SystemExit(f"yolo {mode} requires data=<dataset.yaml>")
    if mode == "predict" and "source" not in kv:
        raise SystemExit("yolo predict requires source=<image-or-dir>")
    if mode == "track" and "source" not in kv:
        raise SystemExit("yolo track requires source=<video-or-dir>")
    if mode == "tune" and "data" not in kv:
        raise SystemExit("yolo tune requires data=<dataset.yaml>")

    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.models.tasks import resolve_device

    from quan_ultralytics_tpu_torch.parallel import distributed

    mesh = None
    try:  # no silent CPU run: without a card, only device=cpu runs
        device = kv.pop("device", None)
        if mode in ("train", "val") and distributed.env_world_size() > 1:
            # under torchrun: one process a rank, data parallelism over the group
            from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh

            device = resolve_device(distributed.local_device() if device is None else device)
            distributed.initialize(device=device)
            mesh = make_mesh(device=device)
        device = resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"yolo {mode}: {e}")
    model = YOLO(kv.pop("model", DEFAULT_MODELS.get(task, "yolo11n-quan.yaml")), device=device)
    main_rank = mesh is None or mesh.rank == 0
    if mode == "train":
        data = kv.pop("data")
        out = model.train(data, mesh=mesh, **kv)
        if main_rank:
            print(out)
    elif mode == "val":
        data = kv.pop("data")
        out = model.val(data, mesh=mesh, **kv)
        if main_rank:
            print(out)
    elif mode == "predict":
        # reference predictor per-image verbose line + save/save_txt flags
        # (engine/predictor.py:222-306, results.py save_txt/plot); visualize=
        # passes to YOLO.predict (per-layer feature grids)
        source = kv.pop("source")
        save = kv.pop("save", False)
        save_txt = kv.pop("save_txt", False)
        save_conf = kv.pop("save_conf", False)
        save_dir = Path(kv.pop("save_dir", "runs/predict"))
        results = model.predict(source, **kv)
        for i, r in enumerate(results):
            print(f"image {i + 1}/{len(results)} {r.orig_shape[1]}x{r.orig_shape[0]} "
                  f"{r.verbose()}")
            if save:
                r.plot(filename=str(save_dir / f"im{i}.jpg"))
            if save_txt:
                (save_dir / "labels").mkdir(parents=True, exist_ok=True)
                r.save_txt(save_dir / "labels" / f"im{i}.txt", save_conf=save_conf)
    elif mode == "export":
        # reference cfg/__init__.py MODES 'export' -> Model.export (:851)
        try:  # an unknown option (the JAX package's tflite half=, int8=) is a TypeError
            path = model.export(**kv)
        except (TypeError, ValueError, RuntimeError) as e:
            raise SystemExit(f"yolo export: {e}")
        print(f"exported: {path}")
    elif mode == "track":
        # reference 'track' mode (Model.track): a video file or a directory of
        # frames -> per-frame associations through ByteTrack or BoT-SORT
        from quan_ultralytics_tpu_torch.data.loaders import load_source

        tracks = model.track(load_source(kv.pop("source")), **kv)
        for fi, t in enumerate(tracks):
            print(f"frame {fi}: {len(t)} tracks")
    elif mode == "tune":
        data = kv.pop("data")
        print(model.tune(data, **kv))
    return 0


def _seq(v, cast) -> tuple:
    """A ``k=v`` value as a tuple: parse_kv gives "640,1024" as a tuple already;
    a bare scalar or a comma string ("a.yaml,b.yaml") is split here."""
    if isinstance(v, (tuple, list)):
        return tuple(cast(s) for s in v)
    if isinstance(v, (int, float)):
        return (cast(v),)
    return tuple(cast(s.strip()) for s in str(v).split(","))


def benchmark_mode(kv: Dict[str, Any]) -> int:
    """``yolo benchmark [model=a.yaml,b.yaml] [imgsz=640,1024] [batch=] [iters=]
    [nc=] [dtype=bfloat16,float32] [device=]``: the speed table of
    `utils.benchmarks.benchmark` (reference MODES 'benchmark', utils/benchmarks.py :51)."""
    from quan_ultralytics_tpu_torch.models.tasks import resolve_device
    from quan_ultralytics_tpu_torch.utils.benchmarks import benchmark, print_table

    try:
        kw: Dict[str, Any] = {"device": resolve_device(kv.get("device"))}
    except RuntimeError as e:
        raise SystemExit(f"yolo benchmark: {e}")
    if "model" in kv:
        kw["models"] = _seq(kv["model"], str)
    if "imgsz" in kv:
        kw["imgsz"] = _seq(kv["imgsz"], int)
    for k in ("batch", "iters", "nc"):
        if k in kv:
            kw[k] = int(kv[k])
    if "dtype" in kv:
        kw["dtypes"] = _seq(kv["dtype"], str)
    print_table(benchmark(**kw))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
