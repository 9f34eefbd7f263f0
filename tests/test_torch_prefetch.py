"""The port's prefetcher (``parallel/prefetch.py``) on the CPU: the loader runs
ahead of the step on a producer thread.

* It yields what plain iteration yields, in order and equal bit for bit,
  lists and non-dict batches passed through, across a change of shape (the
  augmenting, multi-scale loader too).
* A loader's exception reaches the consumer; a consumer that stops early
  (``break``, ``close()``, an exception in ``Trainer.step``) leaves no live
  producer thread, and the loader generator is closed, on the producer's thread.
* ``Trainer.fit`` (which feeds its steps through it) gives the history and
  weights of a hand loop of ``Trainer.step`` over the same loader.
* The JAX ``prefetch_to_device`` and the port's yield equal values.

The card's half (batches on the device across changes of shape) is
``tests/test_torch_cuda.py::test_prefetch_on_card``.
"""

import contextlib
import math
import threading
import time

import jax
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.parallel.prefetch import prefetch_to_device as jax_prefetch
from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
from quan_ultralytics_tpu_torch.data.native.native import imwrite_png
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.parallel.prefetch import prefetch_to_device
from torch_port_helpers import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

JOIN_S = 10.0  # the longest a stopped producer may take to end


def _batches(n=6, seed=0, sizes=(32, 48, 64)):
    """Seeded dict batches whose image size changes from batch to batch (as
    multi-scale does), with a file list and a scalar."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        s = sizes[i % len(sizes)]
        yield {"img": rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8),
               "bboxes": rng.normal(size=(2, 5, 5)).astype(np.float32),
               "cls": rng.integers(0, 15, (2, 5)).astype(np.int64),
               "mask": rng.random((2, 5)) < 0.5,
               "im_files": [f"im{i}_{b}.png" for b in range(2)], "n_real": 2}


def _producers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device" and t.is_alive()]


def _no_producer_left():
    deadline = time.monotonic() + JOIN_S
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _producers()


def _assert_batch_equal(got, ref):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if isinstance(v, (list, tuple, str)):
            assert got[k] == v, k
        else:
            t = got[k]
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu", k
            a = np.asarray(v)
            assert t.numpy().dtype == a.dtype and t.numpy().tobytes() == a.tobytes(), k


@pytest.mark.parametrize("size", [1, 2, 5])
def test_yields_the_batches_of_plain_iteration(size):
    got = list(prefetch_to_device(_batches(), "cpu", size=size))
    ref = list(_batches())
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _assert_batch_equal(g, r)
    assert _no_producer_left()


def test_non_dict_batches_pass_through():
    items = [(np.arange(3), "a"), [1, 2], "s", np.ones(2)]
    got = list(prefetch_to_device(iter(items), "cpu"))
    assert len(got) == 4 and got[0] is items[0] and got[1] is items[1] and got[2] == "s"
    assert got[3] is items[3]


def _write_set(root, n=6, seed=0):
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = [(64, 64), (48, 64), (64, 40)][i % 3]
            imwrite_png(root / "images" / split / f"im{i}.png",
                        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            lines = []
            for _ in range(int(rng.integers(1, 5))):
                cx, cy = rng.uniform(0.3, 0.7, 2)
                bw, bh = rng.uniform(0.1, 0.3, 2)
                pts = [(cx - bw / 2, cy - bh / 2), (cx + bw / 2, cy - bh / 2),
                       (cx + bw / 2, cy + bh / 2), (cx - bw / 2, cy + bh / 2)]
                lines.append(" ".join([str(int(rng.integers(0, 3)))] + [f"{v:.6f}" for p in pts for v in p]))
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "train": "images/train", "val": "images/val", "names": {0: "a", 1: "b", 2: "c"}}


def test_augmenting_multiscale_loader_through_the_prefetcher(tmp_path):
    ds = YOLODataset(_write_set(tmp_path), "train", task="obb")

    def loader():
        return build_dataloader(ds, 2, 64, hyp=AugmentHyp(), augment=True, seed=3, multi_scale=True,
                                workers=2)

    ref = list(loader())
    got = list(prefetch_to_device(loader(), "cpu"))
    assert len(got) == len(ref) == 3
    assert len({r["img"].shape for r in ref}) > 1  # the sizes change
    for g, r in zip(got, ref):
        _assert_batch_equal(g, r)


def test_loader_exception_reaches_the_consumer():
    def loader():
        yield from _batches(2)
        raise ValueError("bad label file")

    got = []
    with pytest.raises(ValueError, match="bad label file"):
        for b in prefetch_to_device(loader(), "cpu"):
            got.append(b)
    assert len(got) == 2
    assert _no_producer_left()


def _closing_loader(closed, endless=True):
    """An endless loader that records the thread that closed it."""
    def gen():
        try:
            i = 0
            while endless or i < 3:
                yield {"x": np.full(4, i)}
                i += 1
        finally:
            closed.append(threading.current_thread().name)
    return gen()


def test_a_consumer_that_breaks_leaves_no_producer():
    closed = []
    for i, b in enumerate(prefetch_to_device(_closing_loader(closed), "cpu", size=2)):
        assert int(b["x"][0]) == i
        if i == 3:
            break
    assert _no_producer_left()
    # the loader generator was closed, by the producer (a generator runs and closes in one thread)
    assert closed == ["prefetch_to_device"]


def test_close_and_an_exception_in_the_consumer_stop_the_producer():
    closed = []
    batches = prefetch_to_device(_closing_loader(closed), "cpu", size=1)
    next(batches)
    batches.close()
    assert _no_producer_left() and closed == ["prefetch_to_device"]
    closed.clear()
    with pytest.raises(RuntimeError, match="step failed"):
        with contextlib.closing(prefetch_to_device(_closing_loader(closed), "cpu")) as it:
            for _ in it:
                raise RuntimeError("step failed")
    assert _no_producer_left() and closed == ["prefetch_to_device"]


def test_many_prefetchers_at_once_yield_their_own_batches():
    """More producers than cores with a short switch interval: each consumer
    gets its own loader's batches in order."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = {}

        def consume(k):
            out[k] = [int(b["x"][0]) for b in prefetch_to_device(
                ({"x": np.full(2, 1000 * k + i)} for i in range(50)), "cpu", size=2)]

        threads = [threading.Thread(target=consume, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert out == {k: [1000 * k + i for i in range(50)] for k in range(16)}
    assert _no_producer_left()


def test_jax_and_port_prefetchers_yield_equal_values():
    ref = list(jax_prefetch(_batches(), size=2))
    got = list(prefetch_to_device(_batches(), "cpu", size=2))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k, v in r.items():
            if isinstance(v, list):
                assert g[k] == v
            else:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(jax.device_get(v)))


# ---------------------------------------------------------------- Trainer.fit


def _trainer(steps):
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=3, device="cpu", seed=1)
    cfg = TrainConfig(batch=2, nbs=2, epochs=2, dtype="float32", warmup_epochs=0)
    return Trainer(model, cfg, steps_per_epoch=steps, device="cpu")


def test_fit_equals_a_hand_loop_of_steps(tmp_path):
    ds = YOLODataset(_write_set(tmp_path), "train", task="obb")
    loader = lambda e: build_dataloader(ds, 2, 64, hyp=None, augment=False, seed=e)  # noqa: E731
    steps = len(ds) // 2
    fitted = _trainer(steps)
    history = fitted.fit(loader, None, epochs=2, log=lambda s: None)
    hand = _trainer(steps)
    rows = []
    for epoch in range(2):
        losses = [float(hand.step(b)[0]) for b in loader(epoch)]
        rows.append(float(sum(losses) / len(losses)))
    assert [r["loss"] for r in history] == pytest.approx(rows, rel=1e-6, abs=0)
    assert all(math.isfinite(v) for v in rows) and fitted.opt.count == hand.opt.count == 2 * steps
    for a, b in zip(fitted.params, hand.params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(fitted.ema, hand.ema):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert _no_producer_left()


def test_fit_stops_the_producer_when_a_step_raises(tmp_path):
    ds = YOLODataset(_write_set(tmp_path), "train", task="obb")
    tr = _trainer(len(ds) // 2)
    closed = []

    def loader(epoch):
        try:
            yield from build_dataloader(ds, 2, 64, hyp=None, augment=False, seed=epoch)
        finally:
            closed.append(threading.current_thread().name)

    def failing_step(batch):
        raise FloatingPointError("step failed")

    tr.step = failing_step
    with pytest.raises(FloatingPointError):
        tr.fit(loader, None, epochs=1, log=lambda s: None)
    assert _no_producer_left() and closed == ["prefetch_to_device"]
