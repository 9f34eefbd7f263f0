"""YOLO-format dataset reader for the detect, OBB, segment and pose tasks
(counterpart of the JAX package's ``data/dataset.py``).

Reads the standard layout

    root/images/{split}/*.png|jpg|jpeg|bmp|tif|tiff|webp
    root/labels/{split}/*.txt

Detect labels: ``cls cx cy w h`` (normalized). OBB labels: ``cls x1 y1 x2 y2
x3 y3 x4 y4`` (normalized corners, the DOTA-YOLO format); they stay corners
here and become pixel-space xywhr in ``build._format``. Segment labels:
``cls x1 y1 x2 y2 ...`` (a polygon of any length, resampled to `SEG_POINTS`
points). Pose labels: ``cls cx cy w h`` and ``nk`` keypoints of 2 or 3
values (x, y[, visibility]; without it every labelled point is visible).
Data configs have the reference schema (``path``, ``train``, ``val``,
``names``), given as a dict or as a file read by `cfg.datasets.load_data_cfg`.

Images are decoded by the port's own PNG and JPEG readers
(`data.native.native.imread`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from quan_ultralytics_tpu_torch.cfg.datasets import load_data_cfg
from quan_ultralytics_tpu_torch.data.native.native import imread, read_stored_shape

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
TASKS = ("detect", "obb", "segment", "pose")
SEG_POINTS = 32  # polygons are resampled to this fixed vertex count


def resample_polygon(pts: np.ndarray, n: int = SEG_POINTS) -> np.ndarray:
    """A closed polygon ``[k, 2]`` resampled to exactly ``n`` vertices evenly
    spaced by arc length (reference ops.py:329 resample_segments), float32."""
    closed = np.concatenate([pts, pts[:1]], axis=0)
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0.0, max(cum[-1], 1e-9), n, endpoint=False)
    return np.stack([np.interp(t, cum, closed[:, 0]), np.interp(t, cum, closed[:, 1])],
                    axis=1).astype(np.float32)


@dataclass
class Sample:
    im_file: str
    cls: np.ndarray  # [n]
    # detect, pose: [n, 4] xywh normalized; obb: [n, 8] corners normalized;
    # segment: [n, 2 * SEG_POINTS] resampled polygon points normalized
    bboxes: np.ndarray
    shape: Optional[Tuple[int, int]] = None  # (h, w) of the source image
    kpts: Optional[np.ndarray] = None  # pose: [n, nk, 3] normalized x, y and visibility


def available_memory() -> int:
    """Bytes of memory available to new allocations: ``MemAvailable`` of
    ``/proc/meminfo``, else the free pages ``os.sysconf`` reports."""
    meminfo = Path("/proc/meminfo")
    if meminfo.exists():
        for line in meminfo.read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class YOLODataset:
    """cache: None | 'ram' | 'disk' (the reference's BaseDataset image cache,
    data/base.py:181-244). 'ram' keeps decoded RGB arrays when their estimated
    size fits half the available memory; 'disk' writes ``.npy`` sidecars into
    a ``.npy_cache`` directory next to the images and loads those later."""

    def __init__(self, data_cfg: Union[str, Path, Dict], split: str = "train",
                 task: str = "detect", cache: Optional[str] = None):
        if task not in TASKS:
            raise ValueError(f"task {task!r} is not one of {TASKS}")
        if isinstance(data_cfg, (str, Path)):
            cfg = load_data_cfg(data_cfg)
            cfg_dir = Path(data_cfg).resolve().parent
        else:
            cfg, cfg_dir = data_cfg, Path(".")
        self.task = task
        root = Path(cfg.get("path", "."))
        if not root.is_absolute():
            root = (cfg_dir / root).resolve()
        split_rel = cfg.get(split, f"images/{split}")
        self.img_dir = root / split_rel if not Path(split_rel).is_absolute() else Path(split_rel)
        names = cfg.get("names", {})
        if isinstance(names, dict):
            self.names = [names[k] for k in sorted(names, key=int)]
        else:
            self.names = list(names)
        self.nc = len(self.names)
        self.samples = self._load_labels()
        if cache not in (None, "ram", "disk"):
            raise ValueError(f"cache must be None|'ram'|'disk', got {cache}")
        self.cache = cache
        self._ram: List[Optional[np.ndarray]] = [None] * len(self.samples)
        if cache == "ram" and not self._check_cache_ram():
            self.cache = None

    def _check_cache_ram(self, safety_margin: float = 0.5) -> bool:
        """Whether the decoded images, estimated from up to 8 headers, fit in
        ``safety_margin`` of the available memory (reference data/base.py:214-235)."""
        if not self.samples:
            return True
        n_probe = min(8, len(self.samples))
        per = np.mean([np.prod(self._read_shape(i)) * 3 for i in range(n_probe)])
        return per * len(self.samples) < available_memory() * safety_margin

    def _read_shape(self, i: int) -> Tuple[int, int]:
        """(h, w) without a full decode: the stored size from the header, not
        turned by an EXIF orientation, as the JAX package's PIL header read
        gives it (a loaded image then records its turned shape)."""
        s = self.samples[i]
        if s.shape is None:
            s.shape = read_stored_shape(s.im_file)
        return s.shape

    def shapes(self) -> np.ndarray:
        """[N, 2] (h, w) of every image (rect batching)."""
        return np.array([self._read_shape(i) for i in range(len(self))], np.int64)

    def _label_path(self, im_file: Path) -> Path:
        parts = list(im_file.parts)
        parts[-3] = "labels" if parts[-3] == "images" else parts[-3]
        return Path(*parts).with_suffix(".txt")

    def _parse_rows(self, rows: List[List[float]]) -> tuple:
        """Label rows -> (cls, boxes, kpts): detect ``cls cx cy w h``; obb ``cls``
        and 8 corner coordinates; segment ``cls`` and a polygon; pose ``cls cx cy
        w h`` and the keypoints (reference data/utils.py verify_image_label)."""
        cls = np.array([r[0] for r in rows], np.int32)
        if self.task == "segment":
            polys = [resample_polygon(np.array(r[1:], np.float32).reshape(-1, 2)) for r in rows]
            return cls, np.stack(polys).reshape(len(rows), -1), None
        arr = np.array(rows, np.float32)
        if self.task == "obb":
            if arr.shape[1] != 9:
                raise ValueError(f"OBB labels need 8 coords, got {arr.shape[1] - 1}")
            return cls, arr[:, 1:9], None
        if self.task == "pose":
            k = arr[:, 5:]
            ndim = 3 if k.shape[1] % 3 == 0 else 2
            k = k.reshape(len(rows), -1, ndim)
            if ndim == 2:  # no visibility column: a labelled point is visible
                k = np.concatenate([k, np.ones((*k.shape[:2], 1), np.float32)], axis=-1)
            return cls, arr[:, 1:5], k
        return cls, arr[:, 1:5], None

    def _load_labels(self) -> List[Sample]:
        files = sorted(p for p in self.img_dir.rglob("*") if p.suffix.lower() in IMG_EXTS)
        samples = []
        empty_dim = {"obb": 8, "segment": 2 * SEG_POINTS}.get(self.task, 4)
        for f in files:
            lp = self._label_path(f)
            rows = []
            if lp.exists():
                with open(lp) as fh:
                    for line in fh:
                        v = line.split()
                        if v:
                            rows.append([float(x) for x in v])
            if rows:
                cls, boxes, kpts = self._parse_rows(rows)
            else:
                cls, boxes = np.zeros(0, np.int32), np.zeros((0, empty_dim), np.float32)
                kpts = np.zeros((0, 17, 3), np.float32) if self.task == "pose" else None
            samples.append(Sample(str(f), cls, boxes, kpts=kpts))
        return samples

    def __len__(self):
        return len(self.samples)

    def _npy_path(self, i: int) -> Path:
        f = Path(self.samples[i].im_file)
        return f.parent / ".npy_cache" / (f.stem + ".npy")

    def load_image(self, i: int) -> np.ndarray:
        """Decoded RGB uint8 image, through the RAM or disk cache when enabled.
        Callers must not change the returned array in place."""
        if self.cache == "ram" and self._ram[i] is not None:
            return self._ram[i]
        if self.cache == "disk":
            p = self._npy_path(i)
            if p.exists():
                return np.load(p)
        im = imread(self.samples[i].im_file)
        self.samples[i].shape = im.shape[:2]
        if self.cache == "ram":
            self._ram[i] = im
        elif self.cache == "disk":
            p = self._npy_path(i)
            p.parent.mkdir(exist_ok=True)
            np.save(p, im)
        return im
