"""AutoAugment in the port (``classification/data.py``) against the JAX
package's, which runs PIL 12, on the CPU.

* Each of the 13 ops at every magnitude of the policy's scale (0..9), on
  uint8 32 x 32 images (random, low-contrast, flat) and on odd sizes:
  equal to the JAX ``_pil_ops`` function, pixel for pixel.
* ``autoaugment`` under one seeded generator: equal images, and the
  generator left in the same state.
* ``batches(..., auto_augment=True)``: every batch equal to the JAX
  loader's from the same seed.
* The classification CLI's ``--autoaugment`` reaches the train batches.

Four tests (the ops loop inside one): pytest-xdist's ``--dist loadfile``
queues files by their number of tests, and this file then comes after every
long JAX test file, so it runs beside them and does not delay them.
"""

import numpy as np
from PIL import Image

from quan_ultralytics_tpu.classification import data as jdata
from quan_ultralytics_tpu_torch.classification import cli as tccli
from quan_ultralytics_tpu_torch.classification import data as tdata

OPS = sorted(jdata._pil_ops())


def _images():
    rng = np.random.default_rng(0)
    ims = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    ims.append((rng.integers(0, 40, (32, 32, 3)) + 100).astype(np.uint8))  # low contrast
    ims.append(np.full((32, 32, 3), 77, np.uint8))  # flat: the histogram ops' no-op branches
    ims += [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((17, 29), (40, 8), (3, 3))]
    return ims


def test_op_table_and_ops_equal_pil():
    jops = jdata._pil_ops()
    assert sorted(tdata.AUTOAUGMENT_OPS) == OPS
    assert all(tdata.AUTOAUGMENT_OPS[k][1:] == jops[k][1:] for k in OPS)
    assert tdata.CIFAR10_POLICY == jdata.CIFAR10_POLICY
    for name in OPS:
        fn, lo, hi = jdata._pil_ops()[name]
        port = tdata.AUTOAUGMENT_OPS[name][0]
        for im in _images():
            for mag in range(10):
                v = lo + (hi - lo) * mag / 9.0
                ref = np.asarray(fn(Image.fromarray(im), v))
                got = port(im, v)
                assert got.dtype == np.uint8 and got.shape == ref.shape, (name, mag)
                np.testing.assert_array_equal(got, ref, err_msg=f"{name} magnitude {mag} on {im.shape}")


def test_autoaugment_equals_jax_under_one_generator():
    rng = np.random.default_rng(1)
    for seed in range(150):
        im = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(tdata.autoaugment(im, tr), jdata.autoaugment(im, jr))
        assert tr.random() == jr.random()


def test_autoaugment_batches_equal_jax():
    tx, ty, _, _ = tdata.make_synthetic(10, n_train=40, n_test=8)
    kw = dict(train=True, seed=3, cutout_len=8, auto_augment=True)
    got = list(tdata.batches(tx, ty, 16, **kw))
    ref = list(jdata.batches(tx, ty, 16, **kw))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["label"], r["label"])
        np.testing.assert_array_equal(g["img"], r["img"])
    plain = list(tdata.batches(tx, ty, 16, train=True, seed=3, cutout_len=8))
    assert not np.array_equal(plain[0]["img"], got[0]["img"])


def test_cli_autoaugment_reaches_the_train_batches(monkeypatch, tmp_path):
    seen = {}

    def fake_fit(cfg, train_loader, val_loader, steps_per_epoch, **kw):
        seen["batch"] = next(iter(train_loader(0)))

        class Exp:
            best_acc, dir = 0.0, tmp_path
        return None, Exp()

    monkeypatch.setattr(tccli, "fit", fake_fit)
    assert tccli.main(["--dataset", "synthetic", "--autoaugment", "--device", "cpu", "--batch_size", "8",
                       "--exp_dir", str(tmp_path)]) == 0
    tx, ty, _, _ = tdata.make_synthetic(10)
    ref = next(iter(jdata.batches(tx, ty, 8, train=True, seed=0, auto_augment=True)))
    np.testing.assert_array_equal(seen["batch"]["img"], ref["img"])
