"""DOTA sliding-window tiling: split huge aerial images into training crops.

Reference: ultralytics/data/split_dota.py:17-288. Windows of ``crop_size``
with ``gap`` overlap (stride = crop - gap); windows keeping < ``im_rate``
of their area inside the image are dropped unless nothing else remains;
labels are assigned to windows by IOF (intersection over the box's own
area) >= 0.7 and re-normalized to window coordinates.

Labels in/out are the 8-coordinate normalized DOTA-YOLO format.

Counterpart of the JAX ``data/split_dota.py``: images are read with the
port's image readers (PNG, JPEG, BMP, TIFF, WebP) and the crops written with its JPEG writer
(`data.native.native`), the bytes OpenCV writes; `engine.dota_eval` merges
the windows' predictions back. Where JAX asserts, this raises ``ValueError``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple

import numpy as np

from quan_ultralytics_tpu_torch.data.native.native import imread, imwrite


def get_windows(im_size: Tuple[int, int], crop_sizes=(1024,), gaps=(200,),
                im_rate_thr: float = 0.6, eps: float = 0.01) -> np.ndarray:
    """Window xyxy coords for one image (reference split_dota.py:97-140)."""
    h, w = im_size
    windows = []
    for crop_size, gap in zip(crop_sizes, gaps):
        if crop_size <= gap:
            raise ValueError(f"crop_size {crop_size} must exceed gap {gap}")
        step = crop_size - gap
        xn = 1 if w <= crop_size else math.ceil((w - crop_size) / step + 1)
        xs = [step * i for i in range(xn)]
        if len(xs) > 1 and xs[-1] + crop_size > w:
            xs[-1] = w - crop_size
        yn = 1 if h <= crop_size else math.ceil((h - crop_size) / step + 1)
        ys = [step * i for i in range(yn)]
        if len(ys) > 1 and ys[-1] + crop_size > h:
            ys[-1] = h - crop_size
        for y0 in ys:
            for x0 in xs:
                windows.append([x0, y0, x0 + crop_size, y0 + crop_size])
    windows = np.array(windows, dtype=np.int64)
    # keep windows that mostly overlap the image
    x1, y1, x2, y2 = windows[:, 0], windows[:, 1], windows[:, 2], windows[:, 3]
    im_x2 = np.minimum(x2, w)
    im_y2 = np.minimum(y2, h)
    im_areas = np.clip(im_x2 - x1, 0, None) * np.clip(im_y2 - y1, 0, None)
    win_areas = (x2 - x1) * (y2 - y1)
    rates = im_areas / win_areas
    if not (rates > im_rate_thr).any():
        rates[abs(rates - rates.max()) < eps] = 1.0
    return windows[rates > im_rate_thr]


def window_label_iof(corners_px: np.ndarray, windows: np.ndarray) -> np.ndarray:
    """IOF of each polygon's bounding hull vs each window
    (reference split_dota.py:141-154 bbox_iof). Returns [n_labels, n_win]."""
    if corners_px.size == 0:
        return np.zeros((0, len(windows)), np.float32)
    pts = corners_px.reshape(-1, 4, 2)
    mn, mx = pts.min(axis=1), pts.max(axis=1)
    areas = np.prod(mx - mn, axis=1)
    lt = np.maximum(mn[:, None, :], windows[None, :, :2])
    rb = np.minimum(mx[:, None, :], windows[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(areas[:, None], 1e-9)


def split_image(im_file: str, label_file: str, out_img_dir: Path, out_lbl_dir: Path,
                crop_size: int = 1024, gap: int = 200, iof_thr: float = 0.7) -> int:
    """Split one image + its DOTA-YOLO labels; returns number of crops."""
    im = imread(im_file)
    h, w = im.shape[:2]
    rows = []
    if Path(label_file).exists():
        with open(label_file) as fh:
            rows = [[float(v) for v in line.split()] for line in fh if line.strip()]
    labels = np.array(rows, np.float32) if rows else np.zeros((0, 9), np.float32)
    corners_px = labels[:, 1:] * np.tile([w, h], 4) if len(labels) else labels[:, 1:]

    windows = get_windows((h, w), (crop_size,), (gap,))
    iof = window_label_iof(corners_px, windows)
    stem = Path(im_file).stem
    out_img_dir.mkdir(parents=True, exist_ok=True)
    out_lbl_dir.mkdir(parents=True, exist_ok=True)
    for wi, (x0, y0, x1, y1) in enumerate(windows):
        crop = im[y0:min(y1, h), x0:min(x1, w)]
        ph, pw = y1 - y0, x1 - x0
        if crop.shape[0] != ph or crop.shape[1] != pw:
            pad = np.zeros((ph, pw, 3), im.dtype)
            pad[: crop.shape[0], : crop.shape[1]] = crop
            crop = pad
        name = f"{stem}__{x0}_{y0}"
        imwrite(out_img_dir / f"{name}.jpg", crop)
        keep = iof[:, wi] >= iof_thr if len(labels) else np.zeros(0, bool)
        lines = []
        for li in np.nonzero(keep)[0]:
            c = corners_px[li].reshape(4, 2) - [x0, y0]
            c = c / [pw, ph]
            lines.append(" ".join([str(int(labels[li, 0]))] + [f"{v:.6f}" for v in c.reshape(-1)]))
        (out_lbl_dir / f"{name}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    return len(windows)


def split_test(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200):
    """Split the (label-less) test split into crops for submission inference
    (reference split_dota.py:230-288 split_test): windows are cropped and
    saved as ``{stem}__{x}_{y}.jpg`` with no label files; DOTASubmission
    parses those stems back to source-image coordinates at merge time."""
    root, out = Path(data_root), Path(save_dir)
    img_dir = root / "images" / "test"
    out_img = out / "images" / "test"
    out_img.mkdir(parents=True, exist_ok=True)
    total = 0
    if not img_dir.exists():
        return 0
    for f in sorted(img_dir.iterdir()):
        if f.suffix.lower() not in {".jpg", ".png", ".jpeg", ".tif", ".bmp"}:
            continue
        im = imread(f)
        h, w = im.shape[:2]
        for x0, y0, x1, y1 in get_windows((h, w), (crop_size,), (gap,)):
            crop = im[y0:min(y1, h), x0:min(x1, w)]
            ph, pw = y1 - y0, x1 - x0
            if crop.shape[0] != ph or crop.shape[1] != pw:
                pad = np.zeros((ph, pw, 3), im.dtype)
                pad[: crop.shape[0], : crop.shape[1]] = crop
                crop = pad
            imwrite(out_img / f"{f.stem}__{x0}_{y0}.jpg", crop)
            total += 1
    return total


def split_trainval(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200):
    """Split train+val splits (reference split_dota.py:230-288 layout)."""
    root, out = Path(data_root), Path(save_dir)
    total = 0
    for split in ("train", "val"):
        img_dir = root / "images" / split
        if not img_dir.exists():
            continue
        for f in sorted(img_dir.iterdir()):
            if f.suffix.lower() not in {".jpg", ".png", ".jpeg", ".tif", ".bmp"}:
                continue
            lbl = root / "labels" / split / f"{f.stem}.txt"
            total += split_image(f, lbl, out / "images" / split, out / "labels" / split,
                                 crop_size, gap)
    return total
