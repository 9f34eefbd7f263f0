"""The ranks' side of tests/test_torch_parallel.py: each scenario runs in
two gloo processes on the CPU (started by
``quan_ultralytics_tpu_torch.parallel.distributed.launch``) and returns
numpy arrays for the test process to hold against the single-process port
and the JAX package. Imports the port only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

IMGSZ, BATCH, NC, M = 64, 8, 3, 4


def obb_batch(seed: int, batch: int = BATCH, imgsz: int = IMGSZ):
    """The JAX mesh tests' batch (tests/test_mesh.py ``_setup``): seeded
    images and one rotated box an image repeated ``M`` times."""
    rng = np.random.RandomState(seed)
    return {
        "img": rng.rand(batch, imgsz, imgsz, 3).astype(np.float32),
        "bboxes": np.tile(np.array([[0.5, 0.5, 0.3, 0.2, 0.1]], np.float32), (batch, M, 1)),
        "cls": np.zeros((batch, M), np.int64),
        "mask": np.ones((batch, M), bool),
    }


def make_trainer(nbs: int = BATCH, mesh=None, batch: int = BATCH, **model_kw):
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=NC, device="cpu", **model_kw)
    cfg = TrainConfig(epochs=2, batch=batch, nbs=nbs, warmup_epochs=0.0, dtype="float32")
    return Trainer(model, cfg, steps_per_epoch=4, device="cpu", mesh=mesh)


def trainer_state(tr):
    """Parameters, EMA, IQBN statistics and momentum, as numpy arrays by name."""
    out = {f"p:{n}": p.detach().numpy().copy() for n, p in zip(tr.param_names, tr.params)}
    out.update({f"e:{n}": e.numpy().copy() for n, e in zip(tr.param_names, tr.ema)})
    buffers = [n for n, _ in tr.model.named_buffers() if n in tr.model.state_dict()]
    out.update({f"s:{n}": b.numpy().copy() for n, b in zip(buffers, tr.stats)})
    out.update({f"t:{n}": t.numpy().copy() for n, t in zip(tr.param_names, tr.opt.trace)})
    return out


def iqbn_case(seed: int = 0):
    """tests/test_mesh.py's IQBN input: shard i's mean is about i, so the
    global statistics are far from any rank's own; and a cotangent."""
    x = np.random.RandomState(seed).randn(8, 4, 4, 4, 2).astype(np.float32)
    x += np.arange(8, dtype=np.float32)[:, None, None, None, None]
    cot = np.random.RandomState(seed + 1).randn(*x.shape).astype(np.float32)
    return x, cot


def iqbn_forward(x: np.ndarray, cot: np.ndarray, mesh=None):
    """IQBN(c=8, momentum=1) in train mode on ``x``: output, running
    statistics, and the gradients of ``sum(y * cot)`` (summed over the ranks
    for the parameters, this rank's rows for the input)."""
    from quan_ultralytics_tpu_torch.models.conv import IQBN
    from quan_ultralytics_tpu_torch.parallel.mesh import all_reduce_, data_parallel

    bn = IQBN(8, momentum=1.0).train()
    with torch.no_grad():
        bn.gamma.copy_(torch.linspace(0.5, 1.5, 8).reshape(4, 2))
        bn.beta.copy_(torch.linspace(-0.2, 0.2, 8).reshape(4, 2))
    xt = torch.from_numpy(x).requires_grad_(True)
    with data_parallel(mesh):
        y = bn(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    grads = [bn.gamma.grad, bn.beta.grad]
    if mesh is not None:
        all_reduce_(mesh, grads)
    return {"y": y.detach().numpy(), "mean": bn.mean.numpy().copy(), "var": bn.var.numpy().copy(),
            "dx": xt.grad.numpy(), "dgamma": grads[0].numpy(), "dbeta": grads[1].numpy()}


def cls_step(mesh=None, seed: int = 0, batch: int = 8):
    """One Q-WRN-16-2 update at 32 x 32 in f32 (no dropout) on a seeded batch
    (this rank's rows of it under a mesh): loss, accuracy, parameters."""
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer
    from quan_ultralytics_tpu_torch.parallel.mesh import shard_batch

    rng = np.random.RandomState(seed)
    b = {"img": rng.rand(batch, 32, 32, 3).astype(np.float32),
         "label": rng.randint(0, 10, size=batch).astype(np.int64)}
    tr = ClsTrainer(ClsConfig(model="qwrn16_2", dtype="float32", batch_size=batch), 10,
                    device="cpu", mesh=mesh)
    loss, acc = tr.train_step(shard_batch(mesh, b) if mesh is not None else b)
    out = {f"p:{n}": p.detach().numpy().copy() for n, p in tr.model.named_parameters()}
    out.update({f"s:{n}": v.numpy().copy() for n, v in tr.model.named_buffers()})
    return float(loss), float(acc), out


def run_all(rank: int, data_yaml: str):
    """Every two-rank scenario of tests/test_torch_parallel.py, in one process
    group: returns ``{scenario: result}``."""
    from quan_ultralytics_tpu_torch.data.dataset import YOLODataset
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.parallel.distributed import global_batch, process_batch_slice
    from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.set_num_threads(2)
    mesh = make_mesh(2, device="cpu")
    out = {"rank": mesh.rank}

    # one sharded step, then two more (the replicas must stay bitwise equal)
    tr = make_trainer(mesh=mesh)
    batch = obb_batch(0)
    loss, aux = tr.step(global_batch(mesh, shard_batch(mesh, batch)))
    out["step"] = {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()}, "state": trainer_state(tr)}
    for _ in range(2):
        loss, _ = tr.step(shard_batch(mesh, batch))
    out["k_steps"] = {"loss": float(loss), "state": trainer_state(tr)}

    # a batch that does not divide stays whole on every rank and steps unreduced
    odd = obb_batch(3, batch=3)
    kept = shard_batch(mesh, odd)
    tr = make_trainer(mesh=mesh)
    loss, _ = tr.step(kept, sharded=mesh.shards(3))
    out["odd"] = {"rows": int(kept["img"].shape[0]), "loss": float(loss), "state": trainer_state(tr)}

    # accumulation over two micro-steps (nbs = 2 batches)
    tr = make_trainer(nbs=2 * BATCH, mesh=mesh)
    for s in (1, 2):
        loss, _ = tr.step(shard_batch(mesh, obb_batch(s)))
    out["accum"] = {"loss": float(loss), "state": trainer_state(tr)}

    # a NaN in one rank's rows skips the update on both
    tr = make_trainer(mesh=mesh)
    before = trainer_state(tr)
    rows = shard_batch(mesh, obb_batch(4))
    if mesh.rank == 1:
        rows["img"] = rows["img"].copy()
        rows["img"][0, 0, 0, 0] = np.nan
    _, aux = tr.step(rows)
    after = trainer_state(tr)
    out["nan"] = {"skipped": float(aux["nan_skipped"]),
                  "unchanged": all(np.array_equal(before[k], after[k], equal_nan=True) for k in before)}

    # IQBN's global moments and gradients
    x, cot = iqbn_case()
    rows = process_batch_slice(2, 8)
    out["iqbn"] = iqbn_forward(x[rows], cot[rows], mesh)

    # one sharded step of the deep-packed stem (its packed IQBNs take the global moments)
    tr = make_trainer(mesh=mesh, stem_deep=1)
    loss, aux = tr.step(global_batch(mesh, shard_batch(mesh, batch)))
    out["deep_step"] = {"loss": float(loss), "state": trainer_state(tr)}

    # sharded validation and prediction
    ds = YOLODataset(data_yaml, split="val", task="obb")
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=NC, device="cpu", fused_1x1=False)
    out["val"] = Validator(model, imgsz=IMGSZ, mesh=mesh)(ds, batch_size=4)
    frames = [ds.load_image(i) for i in range(4)]
    res = Predictor(model, imgsz=IMGSZ, conf=0.001, iou=0.7, max_det=50, mesh=mesh)(frames)
    out["predict"] = [r.boxes for r in res]

    # classification: one Q-WRN-16-2 update on two ranks
    out["cls"] = cls_step(mesh)
    return out


def raises_on_rank_one(rank: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def hangs(rank: int) -> None:
    time.sleep(600)
