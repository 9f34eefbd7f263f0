"""Classification data: CIFAR-10/100, SVHN, an ImageNet folder and synthetic
sets (counterpart of the JAX ``classification/data.py``; reference
classification/utils/data_loading.py:37-267).

The numpy code is the JAX package's, so with one seed it gives the same
arrays bit for bit: CIFAR python pickles parsed directly, SVHN through
``scipy.io``, pad-4 reflect crop + flip (+ Cutout, reference
data_loading.py:8-34) and MultiAugment copies. The ImageNet loader reads
images with the port's own image readers (``data/native``) and resizes
with torch's bilinear interpolation where the JAX loader calls
``cv2.resize``: the same half-pixel sampling, within one gray level of
OpenCV's fixed-point rounding. The crop and flip draws are the JAX loader's.
AutoAugment's 13 ops (PIL in the JAX package) are numpy on uint8 ``[h, w, 3]``
with PIL 12's arithmetic, so one seeded generator gives the same images.
"""

from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# AutoAugment (CIFAR-10 policy; reference classification/utils/augmentations.py).
# Each op gives the pixels of the PIL 12 call that the JAX package makes
# (`_pil_ops` there): NEAREST resampling with black fill for the warps,
# PIL's histogram steps, its ITU-R 601-2 integer luma, its SMOOTH kernel and
# `Image.blend`'s float32 arithmetic.
# ---------------------------------------------------------------------------

def _pil_floor(v: float) -> int:
    """Geometry.c's FLOOR: C's cast for v >= 0, floor below."""
    return int(math.floor(v)) if v < 0.0 else int(v)


def _affine_nearest(im: np.ndarray, a: Tuple[float, ...]) -> np.ndarray:
    """``Image.transform(size, AFFINE, a)`` with NEAREST and black fill.

    ``a`` maps an output pixel's centre to the input. PIL takes a separable
    "scale" path when the matrix has no shear (``a[1] == a[3] == 0``): double
    coordinates truncated per row and column; otherwise 16.16 fixed point."""
    h, w = im.shape[:2]
    out = np.zeros_like(im)
    if a[1] == 0 and a[3] == 0:
        def tab(start: float, step: float, n: int) -> np.ndarray:
            idx = np.empty(n, np.int64)
            for i in range(n):  # PIL accumulates the coordinate: rounding as it does
                idx[i] = -1 if start < 0.0 else int(start)
                start += step
            return idx

        xs = tab(a[2] + a[0] * 0.5, a[0], w)
        ys = tab(a[5] + a[4] * 0.5, a[4], h)
        vx, vy = (xs >= 0) & (xs < w), (ys >= 0) & (ys < h)
        out[np.ix_(vy, vx)] = im[np.ix_(ys[vy], xs[vx])]
        return out
    corners = [(0, 0), (w, h), (0, h), (w, 0)]
    if not all(abs(x * a[0] + y * a[1] + a[2]) < 32768.0 and abs(x * a[3] + y * a[4] + a[5]) < 32768.0
               for x, y in corners):
        raise NotImplementedError("PIL's floating-point affine path (an image this large) is not ported")

    def fix(v: float) -> int:
        return _pil_floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
    a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    xin = (a2 + y * a1 + x * a0) >> 16
    yin = (a5 + y * a4 + x * a3) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out[ok] = im[yin[ok], xin[ok]]
    return out


def _shear_x(im: np.ndarray, v: float) -> np.ndarray:
    return _affine_nearest(im, (1, v, 0, 0, 1, 0))


def _translate_x(im: np.ndarray, v: float) -> np.ndarray:
    return _affine_nearest(im, (1, 0, v * im.shape[1], 0, 1, 0))


def _translate_y(im: np.ndarray, v: float) -> np.ndarray:
    return _affine_nearest(im, (1, 0, 0, 0, 1, v * im.shape[0]))


def _rotate(im: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle)``: NEAREST about ``(w / 2, h / 2)``, no expand, black fill."""
    angle = angle % 360.0
    h, w = im.shape[:2]
    if angle == 0:
        return im.copy()
    if angle == 180:
        return im[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(im, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    t = -math.radians(angle)
    m = [round(math.cos(t), 15), round(math.sin(t), 15), 0.0,
         round(-math.sin(t), 15), round(math.cos(t), 15), 0.0]
    m[2], m[5] = m[0] * -cx + m[1] * -cy + m[2], m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return _affine_nearest(im, tuple(m))


def _per_channel_lut(im: np.ndarray, luts) -> np.ndarray:
    out = np.empty_like(im)
    for c, lut in enumerate(luts):
        out[..., c] = np.clip(np.asarray(lut), 0, 255).astype(np.uint8)[im[..., c]]
    return out


def _histograms(im: np.ndarray):
    return [np.bincount(im[..., c].ravel(), minlength=256) for c in range(im.shape[2])]


def _autocontrast(im: np.ndarray, v: float = 0) -> np.ndarray:
    luts = []
    for h in _histograms(im):
        nz = np.flatnonzero(h)
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (255, 0)
        if hi <= lo:
            luts.append(np.arange(256))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(i * scale + offset), 0), 255) for i in range(256)])
    return _per_channel_lut(im, luts)


def _invert(im: np.ndarray, v: float = 0) -> np.ndarray:
    return 255 - im


def _equalize(im: np.ndarray, v: float = 0) -> np.ndarray:
    luts = []
    for h in _histograms(im):
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
        luts.append(n // step)
    return _per_channel_lut(im, luts)


def _solarize(im: np.ndarray, v: float) -> np.ndarray:
    threshold = int(v)
    return np.where(im < threshold, im, 255 - im).astype(np.uint8)


def _posterize(im: np.ndarray, v: float) -> np.ndarray:
    bits = max(1, int(v))
    return im & np.uint8(~(2 ** (8 - bits) - 1) & 0xFF)


def _luma(im: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: ITU-R 601-2 in 16-bit fixed point, rounded."""
    x = im.astype(np.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, im: np.ndarray, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, im, factor)``: float32 arithmetic, truncated;
    clipped to [0, 255] when ``factor`` extrapolates."""
    alpha = np.float32(factor)
    a = degenerate.astype(np.float32)
    out = a + alpha * (im.astype(np.float32) - a)
    if 0 <= alpha <= 1.0:
        return out.astype(np.uint8)
    return np.where(out <= 0, 0, np.where(out >= 255, 255, out)).astype(np.uint8)


def _contrast(im: np.ndarray, v: float) -> np.ndarray:
    hist = np.bincount(_luma(im).ravel(), minlength=256)
    mean = int(float((hist * np.arange(256)).sum()) / hist.sum() + 0.5)
    return _blend(np.full_like(im, mean), im, v)


def _color(im: np.ndarray, v: float) -> np.ndarray:
    return _blend(np.repeat(_luma(im)[..., None], 3, axis=2), im, v)


def _brightness(im: np.ndarray, v: float) -> np.ndarray:
    return _blend(np.zeros_like(im), im, v)


_SMOOTH_EDGE = np.float32(1) / np.float32(13)
_SMOOTH_CENTRE = np.float32(5) / np.float32(13)


def _smooth(im: np.ndarray) -> np.ndarray:
    """``image.filter(ImageFilter.SMOOTH)``: the 3 x 3 kernel [1 1 1; 1 5 1; 1 1 1] / 13
    in float32, summed row by row as PIL does, +0.5 and truncated; the
    border rows and columns are kept."""
    out = im.copy()
    if im.shape[0] < 3 or im.shape[1] < 3:
        return out
    f = im.astype(np.float32)

    def row(r: np.ndarray, centre: np.float32) -> np.ndarray:
        return (r[:, :-2] * _SMOOTH_EDGE + r[:, 1:-1] * centre) + r[:, 2:] * _SMOOTH_EDGE

    ss = np.float32(0.5) + row(f[2:], _SMOOTH_EDGE)
    ss = ss + row(f[1:-1], _SMOOTH_CENTRE)
    ss = ss + row(f[:-2], _SMOOTH_EDGE)
    out[1:-1, 1:-1] = np.where(ss <= 0, 0, np.where(ss < 256, ss, 255)).astype(np.uint8)
    return out


def _sharpness(im: np.ndarray, v: float) -> np.ndarray:
    return _blend(_smooth(im), im, v)


# name -> (op(im, v), lo, hi): the JAX package's `_pil_ops` table
AUTOAUGMENT_OPS = {
    "ShearX": (_shear_x, -0.3, 0.3),
    "TranslateX": (_translate_x, -0.3, 0.3),
    "TranslateY": (_translate_y, -0.3, 0.3),
    "Rotate": (_rotate, -30, 30),
    "AutoContrast": (_autocontrast, 0, 1),
    "Invert": (_invert, 0, 1),
    "Equalize": (_equalize, 0, 1),
    "Solarize": (_solarize, 0, 256),
    "Posterize": (_posterize, 4, 8),
    "Contrast": (_contrast, 0.1, 1.9),
    "Color": (_color, 0.1, 1.9),
    "Brightness": (_brightness, 0.1, 1.9),
    "Sharpness": (_sharpness, 0.1, 1.9),
}

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
    """Apply one randomly chosen CIFAR-10 AutoAugment sub-policy to a uint8
    ``[h, w, 3]`` image; the draws are the JAX function's."""
    im = np.ascontiguousarray(im, np.uint8)
    for name, p, mag in CIFAR10_POLICY[rng.integers(len(CIFAR10_POLICY))]:
        if rng.random() < p:
            fn, lo, hi = AUTOAUGMENT_OPS[name]
            im = fn(im, lo + (hi - lo) * mag / 9.0)
    return im


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
