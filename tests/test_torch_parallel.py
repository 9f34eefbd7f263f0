"""The port's data parallelism (``parallel/distributed.py``, ``parallel/mesh.py``,
synced IQBN, the global loss normalisers and the ``mesh`` of the trainers, the
Validator and the Predictor) against the single-process port and the JAX
package, in two gloo processes on the CPU (the counterpart of
tests/test_mesh.py).

Every two-rank scenario runs in one process group (tests/torch_parallel_worker.py)
under one deadline, so a hang fails this module's tests and no other. The
single-process step is the global batch's; tests/test_torch_train.py holds
that step to the JAX trainer. Tolerances are tests/test_mesh.py's: the loss
within rtol 2e-5, parameters, EMA and IQBN statistics within rtol 1e-3 and
atol 2e-5 (f32 reduction order), IQBN's global moments within rtol 1e-5.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import torch_parallel_worker as W
from quan_ultralytics_tpu_torch.parallel import distributed
from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh, shard_batch
from torch_port_helpers import torch_threads  # noqa: F401

DEADLINE_S = 240.0  # the whole two-rank run: about 15 s on an idle 8-core machine


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from test_e2e import make_synthetic_obb_dataset

    root = tmp_path_factory.mktemp("dp") / "obb"
    yml = make_synthetic_obb_dataset(root, n_images=8, imgsz=W.IMGSZ, nc=W.NC)
    ranks = distributed.launch(W.run_all, 2, args=(str(yml),), timeout_s=DEADLINE_S)
    return {"ranks": ranks, "data": str(yml)}


def _close(got, ref, rtol=1e-3, atol=2e-5, what=""):
    assert set(got) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _single(nbs=W.BATCH, batches=(W.obb_batch(0),)):
    tr = W.make_trainer(nbs=nbs, batch=W.BATCH)
    for b in batches:
        loss, aux = tr.step(b)
    return tr, float(loss), aux


def test_two_rank_step_is_the_global_batch_step(dp, torch_threads):
    tr, loss, aux = _single()
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["step"]["loss"], loss, rtol=2e-5)
        for k in ("box", "cls", "dfl", "quat", "num_fg"):
            np.testing.assert_allclose(r["step"]["aux"][k], float(aux[k]), rtol=2e-5, err_msg=k)
        _close(r["step"]["state"], W.trainer_state(tr), what="after one step")


def test_two_rank_deep_stem_step_is_the_global_batch_step(dp, torch_threads):
    """stem_deep=1 on two ranks: the packed IQBNs' synced statistics, and the
    whole step, are the single process's deep-stem step on the global batch."""
    tr = W.make_trainer(stem_deep=1)
    loss, _ = tr.step(W.obb_batch(0))
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["deep_step"]["loss"], float(loss), rtol=2e-5)
        _close(r["deep_step"]["state"], W.trainer_state(tr), what="deep stem, after one step")


def test_ranks_stay_bitwise_equal_after_k_steps(dp):
    a, b = (r["k_steps"]["state"] for r in dp["ranks"])
    assert np.isfinite(dp["ranks"][0]["k_steps"]["loss"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"replica drift in {k}")


def test_iqbn_moments_are_the_global_batch_moments(dp):
    import jax
    import jax.numpy as jnp

    from quan_ultralytics_tpu.models.conv import IQBN as JIQBN

    x, cot = W.iqbn_case()
    mod = JIQBN(c=8, momentum=1.0)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params = {"gamma": jnp.linspace(0.5, 1.5, 8).reshape(4, 2), "beta": jnp.linspace(-0.2, 0.2, 8).reshape(4, 2)}
    variables = {**variables, "params": params}
    y, upd = mod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ranks = [r["iqbn"] for r in dp["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)
    # the global mean (about 3.5) is far from either rank's own (about 1.5 and 5.5)
    assert abs(float(ranks[0]["mean"].mean()) - float(x.mean())) < 1e-3
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), np.asarray(y), rtol=1e-4, atol=1e-5)


def test_iqbn_gradient_is_the_single_process_gradient(dp, torch_threads):
    x, cot = W.iqbn_case()
    ref = W.iqbn_forward(x, cot)
    ranks = [r["iqbn"] for r in dp["ranks"]]
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), ref["dx"], rtol=1e-4, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["dgamma"], ref["dgamma"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["dbeta"], ref["dbeta"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["mean"], ranks[0]["mean"])  # equal on every rank
        np.testing.assert_array_equal(r["var"], ranks[0]["var"])


def test_batch_that_does_not_divide_stays_whole(dp, torch_threads):
    mesh = make_mesh(device="cpu")  # one process: nothing divides over one rank
    assert shard_batch(mesh, {"img": np.zeros((3, 4, 4, 3))})["img"].shape[0] == 3
    tr = W.make_trainer()
    loss, _ = tr.step(W.obb_batch(3, batch=3))
    for r in dp["ranks"]:
        assert r["odd"]["rows"] == 3
        np.testing.assert_allclose(r["odd"]["loss"], float(loss), rtol=2e-5)
        _close(r["odd"]["state"], W.trainer_state(tr), what="replicated step")


def test_accumulated_micro_steps_match(dp, torch_threads):
    tr, loss, _ = _single(nbs=2 * W.BATCH, batches=(W.obb_batch(1), W.obb_batch(2)))
    assert tr.opt.count == 1
    for r in dp["ranks"]:
        np.testing.assert_allclose(r["accum"]["loss"], loss, rtol=2e-5)
        _close(r["accum"]["state"], W.trainer_state(tr), what="after accumulation")


def test_nan_on_one_rank_skips_the_update_on_both(dp):
    for r in dp["ranks"]:
        assert r["nan"]["skipped"] == 1.0
        assert r["nan"]["unchanged"]


def test_sharded_val_and_predict_equal_single_process(dp, torch_threads):
    from quan_ultralytics_tpu_torch.data.dataset import YOLODataset
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    ds = YOLODataset(dp["data"], split="val", task="obb")
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=W.NC, device="cpu", fused_1x1=False)
    metrics = Validator(model, imgsz=W.IMGSZ)(ds, batch_size=4)
    res = Predictor(model, imgsz=W.IMGSZ, conf=0.001, iou=0.7, max_det=50)([ds.load_image(i) for i in range(4)])
    for r in dp["ranks"]:
        for k, v in metrics.items():
            np.testing.assert_allclose(r["val"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
        assert len(r["predict"]) == len(res)
        for got, ref in zip(r["predict"], res):
            assert got.shape == ref.boxes.shape and len(ref.boxes)
            np.testing.assert_allclose(got, ref.boxes, rtol=1e-4, atol=1e-4)


def test_two_rank_classification_step(dp, torch_threads):
    loss, acc, state = W.cls_step()
    for r in dp["ranks"]:
        r_loss, r_acc, r_state = r["cls"]
        np.testing.assert_allclose(r_loss, loss, rtol=2e-5)
        np.testing.assert_allclose(r_acc, acc, rtol=1e-6)
        _close(r_state, state, what="Q-WRN-16-2 after one update")


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        distributed.launch(W.raises_on_rank_one, 2, timeout_s=60)


def test_a_hanging_rank_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish"):
        distributed.launch(W.hangs, 2, timeout_s=8)
    assert time.monotonic() - t0 < 30


def test_process_batch_slice_and_loader_rows(tmp_path):
    from test_e2e import make_synthetic_obb_dataset

    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.data.build import build_dataloader
    from quan_ultralytics_tpu_torch.data.dataset import YOLODataset

    assert distributed.process_batch_slice(1, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="divide"):
        distributed.process_batch_slice(3, 8)
    yml = make_synthetic_obb_dataset(tmp_path / "obb", n_images=8, imgsz=64, nc=3)
    ds = YOLODataset(str(yml), split="train", task="obb")
    kw = dict(hyp=AugmentHyp(), max_labels=16, seed=3, augment=True, workers=2)
    whole = next(build_dataloader(ds, 4, 64, **kw))
    parts = [next(build_dataloader(ds, 4, 64, rows=slice(r * 2, r * 2 + 2), **kw)) for r in range(2)]
    for k in ("img", "bboxes", "cls", "mask"):  # the ranks' rows together are the whole batch
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k], err_msg=k)
