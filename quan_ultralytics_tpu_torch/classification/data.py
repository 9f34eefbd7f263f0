"""Classification data: CIFAR-10/100, SVHN, an ImageNet folder and synthetic
sets (counterpart of the JAX ``classification/data.py``; reference
classification/utils/data_loading.py:37-267).

The numpy code is the JAX package's, so with one seed it gives the same
arrays bit for bit: CIFAR python pickles parsed directly, SVHN through
``scipy.io``, pad-4 reflect crop + flip (+ Cutout, reference
data_loading.py:8-34) and MultiAugment copies. The ImageNet loader reads
images with the port's own PNG/JPEG readers (``data/native``) and resizes
with torch's bilinear interpolation where the JAX loader calls
``cv2.resize``: the same half-pixel sampling, within one gray level of
OpenCV's fixed-point rounding. The crop and flip draws are the JAX loader's.
AutoAugment (PIL in the JAX package) is not ported yet.
"""

from __future__ import annotations

import pickle
import tarfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from quan_ultralytics_tpu_torch.data.augment import resize_linear
from quan_ultralytics_tpu_torch.data.native.native import imread

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

AUTOAUGMENT_TODO = ("AutoAugment is not ported to the PyTorch package yet (ROADMAP Queue 1 "
                    "item 7b: its PIL ops as numpy, held to PIL on the CPU tests)")


def load_cifar(data_dir: str, dataset: str = "cifar10") -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (train_x [N,32,32,3] uint8, train_y, test_x, test_y)."""
    root = Path(data_dir)
    if dataset == "cifar10":
        base = root / "cifar-10-batches-py"
        tgz = root / "cifar-10-python.tar.gz"
        train_files = [base / f"data_batch_{i}" for i in range(1, 6)]
        test_files = [base / "test_batch"]
        label_key = b"labels"
    else:
        base = root / "cifar-100-python"
        tgz = root / "cifar-100-python.tar.gz"
        train_files = [base / "train"]
        test_files = [base / "test"]
        label_key = b"fine_labels"
    if not base.exists() and tgz.exists():
        with tarfile.open(tgz) as t:
            t.extractall(root, filter="data")

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(np.array(d[label_key], np.int32))
        return np.concatenate(xs), np.concatenate(ys)

    tx, ty = read(train_files)
    vx, vy = read(test_files)
    return tx, ty, vx, vy


def load_svhn(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """SVHN cropped-digits .mat files (reference data_loading.py svhn path)."""
    import scipy.io as sio

    root = Path(data_dir)

    def conv(d):
        x = d["X"].transpose(3, 0, 1, 2)  # HWCN -> NHWC
        y = d["y"].reshape(-1).astype(np.int32) % 10  # label 10 -> 0
        return x, y

    tx, ty = conv(sio.loadmat(root / "train_32x32.mat"))
    vx, vy = conv(sio.loadmat(root / "test_32x32.mat"))
    return tx, ty, vx, vy


def imagenet_folder_samples(data_dir: str, split: str = "train"):
    """ImageNet folder layout: {root}/{split}/{wnid}/*. Returns
    (filepaths, labels, class_names)."""
    root = Path(data_dir) / split
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    files, labels = [], []
    for i, c in enumerate(classes):
        for f in sorted((root / c).iterdir()):
            files.append(str(f))
            labels.append(i)
    return files, np.array(labels, np.int32), classes


def imagenet_batches(files, labels, batch_size: int, *, train: bool,
                     size: int = 224, seed: int = 0,
                     workers: int = 8) -> Iterator[Dict[str, np.ndarray]]:
    """ImageNet loader: random-resized-crop + hflip (train) or
    resize-256/center-crop-224 (eval), ImageNet normalization. Train drops a
    partial last batch; eval pads it by repeating its indices (``np.resize``)."""
    def resize(im: np.ndarray, w: int, h: int) -> np.ndarray:
        return resize_linear(torch.from_numpy(np.ascontiguousarray(im)), (h, w)).numpy()

    rng = np.random.default_rng(seed)
    n = len(files)
    order = rng.permutation(n) if train else np.arange(n)
    nb = n // batch_size if train else -(-n // batch_size)

    def load_one(args):
        idx, s = args
        r = np.random.default_rng(s)
        im = imread(files[idx])
        h, w = im.shape[:2]
        if train:
            # random resized crop: area in [0.08, 1], aspect in [3/4, 4/3]
            for _ in range(10):
                area = h * w * r.uniform(0.08, 1.0)
                ar = np.exp(r.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ar)))
                ch = int(round(np.sqrt(area / ar)))
                if cw <= w and ch <= h:
                    x0 = r.integers(0, w - cw + 1)
                    y0 = r.integers(0, h - ch + 1)
                    im = im[y0 : y0 + ch, x0 : x0 + cw]
                    break
            im = resize(im, size, size)
            if r.random() < 0.5:
                im = im[:, ::-1]
        else:
            scale = 256 / min(h, w)
            im = resize(im, round(w * scale), round(h * scale))
            hh, ww = im.shape[:2]
            y0, x0 = (hh - size) // 2, (ww - size) // 2
            im = im[y0 : y0 + size, x0 : x0 + size]
        return (im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for b in range(nb):
            idx = order[b * batch_size : (b + 1) * batch_size]
            if len(idx) < batch_size:
                idx = np.resize(idx, batch_size)
            seeds = rng.integers(1 << 31, size=len(idx))
            ims = list(pool.map(load_one, zip(idx, seeds)))
            yield {"img": np.stack(ims).astype(np.float32),
                   "label": labels[idx].astype(np.int32)}


def make_synthetic(num_classes: int = 10, n_train: int = 512, n_test: int = 128,
                   size: int = 32, seed: int = 0):
    """Class-separable random data for smoke tests."""
    rng = np.random.default_rng(seed)

    def gen(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        x = rng.normal(0.5, 0.15, (n, size, size, 3))
        # class-dependent mean shift so the task is learnable
        x += (y[:, None, None, None] / num_classes - 0.5) * 0.5
        return (np.clip(x, 0, 1) * 255).astype(np.uint8), y

    tx, ty = gen(n_train)
    vx, vy = gen(n_test)
    return tx, ty, vx, vy


def cutout(im: np.ndarray, length: int, rng: np.random.Generator) -> np.ndarray:
    """Cutout augmentation (reference data_loading.py:8-34)."""
    h, w = im.shape[:2]
    y, x = rng.integers(h), rng.integers(w)
    y1, y2 = np.clip([y - length // 2, y + length // 2], 0, h)
    x1, x2 = np.clip([x - length // 2, x + length // 2], 0, w)
    im = im.copy()
    im[y1:y2, x1:x2] = 0
    return im


# (op, probability, magnitude 0-9) pairs from the CIFAR-10 AutoAugment policy
# (reference classification/utils/augmentations.py)
CIFAR10_POLICY = [
    [("Invert", 0.1, 7), ("Contrast", 0.2, 6)],
    [("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)],
    [("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)],
    [("ShearX", 0.5, 8), ("TranslateY", 0.7, 9)],
    [("AutoContrast", 0.5, 8), ("Equalize", 0.9, 2)],
    [("Color", 0.4, 3), ("Brightness", 0.6, 7)],
    [("Equalize", 0.6, 5), ("Equalize", 0.5, 1)],
    [("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)],
    [("Brightness", 0.9, 6), ("Color", 0.2, 8)],
    [("Solarize", 0.5, 2), ("Invert", 0.0, 3)],
]


def autoaugment(im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One randomly chosen CIFAR-10 AutoAugment sub-policy: not ported yet, raises."""
    raise NotImplementedError(AUTOAUGMENT_TODO)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *, train: bool,
            mean: np.ndarray = CIFAR10_MEAN, std: np.ndarray = CIFAR10_STD,
            cutout_len: int = 0, seed: int = 0, drop_last: Optional[bool] = None,
            num_augments: int = 1, auto_augment: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Normalized, optionally augmented fixed-shape batches.

    num_augments > 1 replicates each train image with independent augs
    (reference MultiAugmentDataset, data_loading.py:37-157)."""
    rng = np.random.default_rng(seed)
    if train and num_augments > 1:
        x = np.repeat(x, num_augments, axis=0)
        y = np.repeat(y, num_augments, axis=0)
    n = len(x)
    order = rng.permutation(n) if train else np.arange(n)
    drop_last = train if drop_last is None else drop_last
    nb = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(nb):
        idx = order[b * batch_size : (b + 1) * batch_size]
        if len(idx) < batch_size:
            idx = np.resize(idx, batch_size)
        ims = x[idx].astype(np.float32)
        if train:
            out = np.empty_like(ims)
            size = ims.shape[1]
            for i, im in enumerate(ims):
                if auto_augment:
                    im = autoaugment(im.astype(np.uint8), rng).astype(np.float32)
                # pad-4 random crop + hflip (reference transforms)
                p = np.pad(im, ((4, 4), (4, 4), (0, 0)), mode="reflect")
                dy, dx = rng.integers(0, 9, 2)
                im = p[dy : dy + size, dx : dx + size]
                if rng.random() < 0.5:
                    im = im[:, ::-1]
                if cutout_len:
                    im = cutout(im, cutout_len, rng)
                out[i] = im
            ims = out
        ims = (ims / 255.0 - mean) / std
        yield {"img": ims.astype(np.float32), "label": y[idx].astype(np.int32)}


def mixup_batch(batch: Dict[str, np.ndarray], alpha: float, rng: np.random.Generator):
    """Classification mixup (reference classification/utils/training.py:104-123):
    blend the batch with a shuffled copy; returns (batch', label_b, lam) for
    the loss ``lam*CE(y_a) + (1-lam)*CE(y_b)``."""
    lam = rng.beta(alpha, alpha) if alpha > 0 else 1.0
    perm = rng.permutation(len(batch["img"]))
    mixed = lam * batch["img"] + (1 - lam) * batch["img"][perm]
    return {"img": mixed.astype(np.float32), "label": batch["label"]}, batch["label"][perm], float(lam)
