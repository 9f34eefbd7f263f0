"""Batches: load -> letterbox -> augment -> format -> fixed-shape padded numpy
arrays (counterpart of the JAX package's ``data/build.py``).

Every batch has static shapes: images ``[B, H, W, 3]`` uint8 and labels padded
to ``max_labels`` with a validity mask. The consumer moves a batch to the card.
The random draws (epoch permutation, multi-scale sizes, one generator a
sample for its augmentations) are the JAX loader's, in its order, so that both
packages give the same batches from the same seed. A thread pool overlaps
decoding and augmenting (the native code releases the GIL).

With ``augment=True`` and a ``hyp``, a sample runs the reference's
``v8_transforms`` order: mosaic (at ``hyp.mosaic``) -> copy-paste -> random
affine warp (back to ``imgsz`` from the mosaic's 2x canvas) -> mixup ->
photometric list -> HSV -> flips; a sample without mosaic is warped alone.
Segment polygons (`SEG_POINTS` points) take the same path as box corners.
Pose samples take `_pose_sample`: photometric list, HSV and flips (with
the left/right keypoint swap), no mosaic or warp, as the JAX package does.

Segment batches carry ``masks`` ``[B, M, H/4, W/4]`` uint8 (0/1; the JAX
loader's are float32 of the same values: a quarter of the bytes to upload,
cast on the card), pose batches ``keypoints`` ``[B, M, nk, 3]``.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from quan_ultralytics_tpu_torch.data.augment import (AugmentHyp, copy_paste, corners_to_xywhr,
                                                     corners_to_xyxy, flip_corners, letterbox, mixup,
                                                     photometric_augment, random_hsv, random_perspective,
                                                     xywh_to_corners)
from quan_ultralytics_tpu_torch.data.dataset import SEG_POINTS, YOLODataset
from quan_ultralytics_tpu_torch.data.native import pixels

Size = Union[int, Tuple[int, int]]


def _load_sample_pixels(ds: YOLODataset, i: int, imgsz: Size, with_meta: bool = False):
    """The image letterboxed to ``imgsz`` (the port's torch letterbox on a CPU
    tensor) and its labels as pixel-space point sets: box corners ``[n, 4, 2]``
    (detect, OBB), polygons ``[n, SEG_POINTS, 2]`` (segment), or box corners
    and keypoints ``[n, 4 + nk, 2]`` (pose; the visibility stays in the sample)."""
    im = ds.load_image(i)
    h0, w0 = im.shape[:2]
    s = ds.samples[i]
    lb, r, (dw, dh) = letterbox(torch.from_numpy(im), imgsz)
    im = lb.numpy()
    if ds.task == "obb":
        corners = s.bboxes.reshape(-1, 4, 2) * [w0, h0]
    elif ds.task == "segment":
        corners = s.bboxes.reshape(-1, SEG_POINTS, 2) * [w0, h0]
    elif ds.task == "pose":
        kxy = (s.kpts[..., :2] if s.kpts is not None and len(s.kpts)
               else np.zeros((len(s.bboxes), 17, 2), np.float32)) * [w0, h0]
        corners = np.concatenate([xywh_to_corners(s.bboxes * [w0, h0, w0, h0]), kxy], axis=1)
    else:
        corners = xywh_to_corners(s.bboxes * [w0, h0, w0, h0])
    corners = corners * r + [dw, dh]
    if with_meta:
        meta = {"ori_shape": np.array([h0, w0], np.float32),
                "ratio_pad": np.array([r, dw, dh], np.float32)}
        return im, corners.astype(np.float32), s.cls.copy(), meta
    return im, corners.astype(np.float32), s.cls.copy()


def _mosaic4(ds: YOLODataset, indices: Sequence[int], imgsz: int, rng: np.random.Generator):
    """4-image mosaic on a 2x canvas around a random centre (reference
    augment.py:490 Mosaic); labels shifted with their tiles, none dropped."""
    s2 = imgsz * 2
    yc, xc = (int(rng.uniform(imgsz // 2, 3 * imgsz // 2)) for _ in range(2))
    canvas = np.full((s2, s2, 3), 114, np.uint8)
    all_c, all_cls = [], []
    for k, idx in enumerate(indices):
        im, corners, cls = _load_sample_pixels(ds, int(idx), imgsz)
        h, w = im.shape[:2]
        if k == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif k == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s2), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif k == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s2), min(s2, yc + h)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = im[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        if corners.size:
            all_c.append(corners + [x1a - x1b, y1a - y1b])
            all_cls.append(cls)
    # no labels: an empty set of the task's point count (segment polygons have SEG_POINTS)
    empty = np.zeros((0, SEG_POINTS if ds.task == "segment" else 4, 2), np.float32)
    corners = np.concatenate(all_c) if all_c else empty
    cls = np.concatenate(all_cls) if all_cls else np.zeros(0, np.int32)
    return canvas, corners.astype(np.float32), cls


def _hull_xywh(corners: np.ndarray, W: int, H: int) -> np.ndarray:
    """The clipped axis-aligned hull of point sets ``[n, P, 2]`` as normalized xywh ``[n, 4]``."""
    xyxy = corners_to_xyxy(corners, W, H)
    return np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
                     xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], axis=1) / [W, H, W, H]


def _format(im, corners, cls, task: str, imgsz: Size, max_labels: int,
            vis: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Pixel point sets -> normalized padded label arrays.

    imgsz: int (square) or (H, W); rect batches normalize x by W and y by H.
    OBB needs square batches: per-axis normalization would shear rotated boxes.
    segment: polygons ``[n, SEG_POINTS, 2]`` -> their hull boxes and ``masks``
    ``[M, H/4, W/4]`` uint8 at proto resolution (reference downsample_ratio 4),
    each filled from ``(polygon * scale).astype(int32)`` as ``cv2.fillPoly`` is
    in the JAX loader. pose: box corners and keypoints ``[n, 4 + nk, 2]`` with
    ``vis`` ``[n, nk]`` -> boxes and ``keypoints`` ``[M, nk, 3]`` normalized, a
    keypoint outside the frame made invisible.
    """
    H, W = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    out_boxes = np.zeros((max_labels, 5 if task == "obb" else 4), np.float32)
    out_cls = np.zeros(max_labels, np.int32)
    out_mask = np.zeros(max_labels, bool)
    extra = {}
    if task == "segment":
        extra["masks"] = np.zeros((max_labels, H // 4, W // 4), np.uint8)
    elif task == "pose":
        nk = corners.shape[1] - 4 if corners.size else 17
        extra["keypoints"] = np.zeros((max_labels, nk, 3), np.float32)
    n = min(corners.shape[0], max_labels)
    if n:
        if task == "obb":
            if H != W:
                raise ValueError("rect batching is not supported for the OBB task")
            xywhr = corners_to_xywhr(corners[:n])
            xywhr[:, :4] /= H
            out_boxes[:n] = xywhr
        elif task == "segment":
            out_boxes[:n] = _hull_xywh(corners[:n], W, H)
            masks = extra["masks"]
            scale = np.array([masks.shape[2] / W, masks.shape[1] / H], np.float32)
            for j in range(n):
                pixels.fill_polygons(masks[j], [(corners[j] * scale).astype(np.int32)])
        elif task == "pose":
            out_boxes[:n] = _hull_xywh(corners[:n, :4], W, H)
            kxy = corners[:n, 4:]
            v = (vis[:n] if vis is not None else np.ones(kxy.shape[:2], np.float32)).astype(np.float32)
            inside = (kxy[..., 0] >= 0) & (kxy[..., 0] < W) & (kxy[..., 1] >= 0) & (kxy[..., 1] < H)
            k = extra["keypoints"]
            k[:n, :, 0] = kxy[..., 0] / W
            k[:n, :, 1] = kxy[..., 1] / H
            k[:n, :, 2] = v * inside
        else:
            out_boxes[:n] = _hull_xywh(corners[:n], W, H)
        out_cls[:n] = cls[:n]
        out_mask[:n] = True
    # uint8 pixels: the consumer normalizes on the device
    return {"img": im, "bboxes": out_boxes, "cls": out_cls, "mask": out_mask, **extra}


# COCO-17 left/right keypoint swap under a horizontal flip (reference
# cfg/datasets/coco-pose.yaml flip_idx)
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def _pose_sample(ds: YOLODataset, idx: int, imgsz: Size, max_labels: int, hyp: Optional[AugmentHyp],
                 rng: Optional[np.random.Generator], augment: bool) -> Dict[str, np.ndarray]:
    """A pose sample: letterbox, then with ``augment`` the photometric list, HSV
    and the flips, a left-right flip swapping the COCO-17 keypoints' sides.
    Mosaic and the warp drop instances, which would part the keypoints from
    their visibility, so the pose path leaves them out (as the JAX package and
    the reference's simpler pose recipes do)."""
    im, corners, cls = _load_sample_pixels(ds, idx, imgsz)
    s = ds.samples[idx]
    vis = (s.kpts[..., 2].copy() if s.kpts is not None and len(s.kpts)
           else np.ones((len(cls), corners.shape[1] - 4), np.float32))
    if augment and hyp:
        im = photometric_augment(im, rng)  # pixels only: the keypoints stay
        im = random_hsv(im, hyp, rng)
        h, w = im.shape[:2]
        if rng.random() < hyp.flipud:
            im = np.ascontiguousarray(np.flipud(im))
            if corners.size:
                corners[..., 1] = h - corners[..., 1]
        if rng.random() < hyp.fliplr:
            im = np.ascontiguousarray(np.fliplr(im))
            if corners.size:
                corners[..., 0] = w - corners[..., 0]
                if corners.shape[1] - 4 == 17:
                    corners[:, 4:] = corners[:, 4:][:, COCO_FLIP_IDX]
                    vis = vis[:, COCO_FLIP_IDX]
    return _format(im, corners, cls, "pose", imgsz, max_labels, vis=vis)


def make_sample(ds: YOLODataset, idx: int, imgsz: Size, max_labels: int,
                hyp: Optional[AugmentHyp] = None, rng: Optional[np.random.Generator] = None,
                augment: bool = False, with_meta: bool = False) -> Dict[str, np.ndarray]:
    """One formatted sample, augmented with ``hyp`` and the sample's own
    generator ``rng`` when ``augment``; with ``with_meta`` (and no
    augmentation) also the letterbox geometry ``ori_shape`` and ``ratio_pad``
    for mapping predictions back, and for segment ``polys``, the polygons in
    letterbox pixels (the Validator's ``mask_native``)."""
    if with_meta and not augment:
        im, corners, cls, meta = _load_sample_pixels(ds, idx, imgsz, with_meta=True)
        s = ds.samples[idx]
        vis = s.kpts[..., 2] if ds.task == "pose" and s.kpts is not None and len(s.kpts) else None
        out = _format(im, corners, cls, ds.task, imgsz, max_labels, vis=vis)
        out.update(meta)
        if ds.task == "segment":  # a count of its own an image: collated as a list
            out["polys"] = corners[:min(corners.shape[0], max_labels)].astype(np.float32)
        return out
    if ds.task == "pose":
        return _pose_sample(ds, idx, imgsz, max_labels, hyp, rng, augment)
    if not (augment and hyp):
        im, corners, cls = _load_sample_pixels(ds, idx, imgsz)
        return _format(im, corners, cls, ds.task, imgsz, max_labels)
    if rng.random() < hyp.mosaic:
        im, corners, cls = _mosaic4(ds, [idx, *rng.integers(0, len(ds), 3)], imgsz, rng)
        if hyp.copy_paste > 0:
            im, corners, cls = copy_paste(im, corners, cls, rng, hyp.copy_paste)
        # the 2x canvas warped back to imgsz
        im, corners, cls = random_perspective(im, corners, cls, hyp, rng, border=(-imgsz // 2, -imgsz // 2))
        if hyp.mixup > 0 and rng.random() < hyp.mixup:  # a second mosaic (reference v8_transforms)
            im2, c2, k2 = _mosaic4(ds, list(rng.integers(0, len(ds), 4)), imgsz, rng)
            im2, c2, k2 = random_perspective(im2, c2, k2, hyp, rng, border=(-imgsz // 2, -imgsz // 2))
            im, corners, cls = mixup(im, corners, cls, im2, c2, k2, rng)
    else:
        im, corners, cls = _load_sample_pixels(ds, idx, imgsz)
        im, corners, cls = random_perspective(im, corners, cls, hyp, rng, border=(0, 0))
    im = photometric_augment(im, rng)
    im = random_hsv(im, hyp, rng)
    im, corners = flip_corners(im, corners, hyp, rng)
    return _format(im, corners, cls, ds.task, imgsz, max_labels)


def build_dataloader(
    ds: YOLODataset,
    batch_size: int,
    imgsz: int = 640,
    hyp: Optional[Any] = None,
    max_labels: int = 128,
    augment: bool = True,
    shuffle: bool = True,
    seed: int = 0,
    workers: int = 4,
    drop_last: bool = True,
    multi_scale: bool = False,
    with_meta: bool = False,
    rect: bool = False,
    rows: Optional[slice] = None,
) -> Iterator[Dict[str, Any]]:
    """One epoch of fixed-shape batches (the stacked `make_sample` outputs).

    augment, hyp: the train augmentations run when both are given (an
    `AugmentHyp`, or any object with its fields); each sample draws from its
    own generator, seeded from the loader's.
    multi_scale: a per-batch image size from the 0.5-1.5x ladder on the
    32-stride grid (reference detect/train.py:60-72).
    rect: rectangular batching (reference data/base.py set_rectangle): sorted
    by aspect ratio, each batch letterboxed to its own smallest stride-32
    shape; val/predict only (no augment, no multi_scale, no shuffle).
    A batch that is short of ``batch_size`` (the last one without
    ``drop_last``, or a data set smaller than one batch) is filled by repeating
    its indices; with ``with_meta`` it carries ``n_real``, the count of real
    samples, and ``im_files``.
    rows: the rows of every batch this process builds (a data-parallel rank's,
    `parallel.distributed.process_batch_slice`). Every sample's generator is
    drawn as for the whole batch, so the ranks' rows together are the
    single-process batch; ``n_real`` stays the whole batch's.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds)) if shuffle and not rect else np.arange(len(ds))
    batch_shapes = None
    if rect:
        if augment or multi_scale:
            raise ValueError("rect batching is a val/predict feature")
        shapes = ds.shapes().astype(np.float64)  # [N, 2] (h, w)
        ar = shapes[:, 0] / shapes[:, 1]
        order = order[np.argsort(ar[order], kind="stable")]
        gs = 32
        batch_shapes = []
        for b in range(math.ceil(len(order) / batch_size)):
            ari = ar[order[b * batch_size:(b + 1) * batch_size]]
            mini, maxi = ari.min(), ari.max()
            sh = [1.0, 1.0]
            if maxi < 1:
                sh = [maxi, 1.0]  # wide images: shrink H
            elif mini > 1:
                sh = [1.0, 1.0 / mini]  # tall images: shrink W
            batch_shapes.append(tuple(int(math.ceil(v * imgsz / gs + 0.5) * gs) for v in sh))
    n = len(order)
    nb = n // batch_size if drop_last else math.ceil(n / batch_size)
    tiny_real = None
    if nb == 0 and n > 0:  # a data set smaller than one batch: repeat it to fill one
        tiny_real = n
        order = np.resize(order, batch_size)
        nb = 1
    if multi_scale:
        gs = 32
        sizes = sorted({max(int(imgsz * f) // gs * gs, gs) for f in (0.5, 0.75, 1.0, 1.25, 1.5)})
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for b in range(nb):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            n_real = tiny_real if tiny_real is not None else len(idxs)
            if len(idxs) < batch_size:
                idxs = np.resize(idxs, batch_size)
            if batch_shapes is not None:
                size = batch_shapes[b]
            elif multi_scale:
                size = int(rng.choice(sizes))
            else:
                size = imgsz
            # one generator a sample, from the JAX loader's draws (one array
            # draw gives the stream of its one-at-a-time draws)
            child_rngs = [np.random.default_rng(s) for s in rng.integers(1 << 31, size=len(idxs))]
            if rows is not None:
                idxs, child_rngs = idxs[rows], child_rngs[rows]
            samples = list(pool.map(
                lambda t: make_sample(ds, int(t[0]), size, max_labels, hyp, t[1], augment,
                                      with_meta=with_meta and not augment),
                zip(idxs, child_rngs)))
            batch: Dict[str, Any] = {k: np.stack([s[k] for s in samples]) for k in samples[0]
                                     if k != "polys"}
            if "polys" in samples[0]:
                batch["polys"] = [s["polys"] for s in samples]
            if with_meta:
                batch["im_files"] = [ds.samples[int(i)].im_file for i in idxs]
                batch["n_real"] = n_real
            yield batch
