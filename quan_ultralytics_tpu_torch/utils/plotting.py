"""Plotting without OpenCV or matplotlib (counterpart of the JAX package's
``utils/plotting.py``; reference utils/plotting.py: Annotator, plot_images
with rotated targets, plot_results, feature_visualization).

The annotations are drawn by the port's raster (``data/native/pixels``), which
gives OpenCV 5.0's pixels for the lines, polygons, rectangles and circles the
JAX package draws with cv2; label boxes have ``cv2.getTextSize``'s size and
place (``utils/font``), and only their glyphs differ from OpenCV's. Images are
written by ``data.native.native.imwrite`` (OpenCV's JPEG and BMP bytes; PNG,
TIFF and lossless WebP that OpenCV reads back to the same pixels).

The charts that the JAX package draws with matplotlib (training curves,
validation curves, confusion matrices) are drawn here by the same raster, at
matplotlib's pixel sizes and with the same data, series, titles and labels;
their axes, ticks and legends are the port's own layout (`Chart`), and the
confusion matrix is coloured by a table of matplotlib's "Blues".
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from quan_ultralytics_tpu_torch.data.native import pixels as px
from quan_ultralytics_tpu_torch.data.native.native import imwrite
from quan_ultralytics_tpu_torch.utils.font import put_text, text_size

PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (26, 204, 56), (0, 212, 187),
    (44, 153, 168), (0, 194, 255), (52, 69, 147), (100, 115, 255),
    (0, 24, 236), (132, 56, 255), (82, 0, 133), (203, 56, 255),
]


def _color(i: int):
    return PALETTE[int(i) % len(PALETTE)]


def _host_array(im) -> np.ndarray:
    """A numpy array of ``im`` (a torch tensor is brought to the host)."""
    if hasattr(im, "detach"):
        im = im.detach().cpu().numpy()
    return np.asarray(im)


class Annotator:
    """Draw boxes, rotated boxes and labels on an RGB image in place (reference Annotator)."""

    def __init__(self, im: np.ndarray, names: Optional[Sequence[str]] = None, lw: Optional[int] = None):
        self.im = np.ascontiguousarray(im)
        self.names = names
        self.lw = lw or max(round(sum(im.shape[:2]) / 2 * 0.003), 2)

    def box_label(self, xyxy, label: str = "", cls: int = 0):
        c = _color(cls)
        p1, p2 = (int(xyxy[0]), int(xyxy[1])), (int(xyxy[2]), int(xyxy[3]))
        px.rectangle(self.im, p1, p2, c, self.lw, px.LINE_AA)
        if label:
            self._text(p1, label, c)

    def obb_label(self, xywhr, label: str = "", cls: int = 0):
        c = _color(cls)
        cx, cy, w, h, t = xywhr[:5]
        pts = px.box_points((float(cx), float(cy)), (float(w), float(h)), float(t) * 180 / math.pi)
        px.polylines(self.im, [pts.astype(np.int32)], True, c, self.lw, px.LINE_AA)
        if label:
            self._text((int(pts[0][0]), int(pts[0][1])), label, c)

    def label_box(self, org, label: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """The filled rectangle behind a label drawn at ``org``: its two corners."""
        wh = text_size(label, self.lw / 3, max(self.lw - 1, 1))
        x, y = org
        return (x, y - wh[1] - 3), (x + wh[0], y)

    def _text(self, org, label, color):
        tf = max(self.lw - 1, 1)
        p1, p2 = self.label_box(org, label)
        px.rectangle(self.im, p1, p2, color, -1, px.LINE_AA)
        put_text(self.im, label, (org[0], org[1] - 2), self.lw / 3, (255, 255, 255), tf)

    def result(self):
        return self.im


def plot_results(results, path: str = "results_annotated.jpg", source_im: Optional[np.ndarray] = None):
    """Annotate one `Results` (engine/predictor.py) onto its source image and write it."""
    im = _host_array(source_im).copy()
    ann = Annotator(im, results.names)
    for row in results.boxes:
        cls = int(row[-1])
        name = results.names[cls] if results.names else str(cls)
        label = f"{name} {row[-2]:.2f}"
        if results.task == "obb":
            ann.obb_label(row[:5], label, cls)
        else:
            ann.box_label(row[:4], label, cls)
    out = ann.result()
    imwrite(path, out)
    return out


def feature_grid(feat, n: int = 32) -> Optional[np.ndarray]:
    """The grid of per-channel feature maps that `feature_visualization`
    writes: ``feat`` ``[H, W, 4, C]`` or ``[B, H, W, 4, C]`` (first image);
    the quaternion axis is flattened into channels, each of the first ``n``
    maps is min-max normalised on its own and resized (nearest) to 96 x 96."""
    if hasattr(feat, "detach"):
        feat = feat.detach().float().cpu().numpy()
    feat = np.asarray(feat, np.float32)
    if feat.ndim == 5:
        feat = feat[0]
    feat = feat.reshape(feat.shape[0], feat.shape[1], -1)
    n = min(n, feat.shape[-1])
    if n == 0:
        return None
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    cell = 96
    canvas = np.zeros((rows * cell, cols * cell), np.uint8)
    for i in range(n):
        ch = feat[..., i]
        lo, hi = float(ch.min()), float(ch.max())
        img = ((ch - lo) / (hi - lo + 1e-9) * 255.0).astype(np.uint8)
        r, c = divmod(i, cols)
        canvas[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] = px.resize_nearest(img, (cell, cell))
    return canvas


def feature_visualization(feat, path="features.png", n: int = 32):
    """Save `feature_grid` as one gray PNG (reference utils/plotting.py:1346)."""
    canvas = feature_grid(feat, n)
    if canvas is None:
        return None
    imwrite(str(path), canvas)
    return str(path)


def plot_images(batch, path: str = "train_batch.jpg", max_ims: int = 16, names=None):
    """Mosaic of a train batch with its (rotated) targets (reference
    plot_images / output_to_rotated_target); the batch's arrays may be
    numpy or torch."""
    batch = {k: _host_array(v) for k, v in batch.items()}
    imgs = batch["img"][:max_ims]
    n = len(imgs)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    s = imgs.shape[1]
    canvas = np.full((rows * s, cols * s, 3), 255, np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        # loader batches are uint8 0..255; float inputs are [0, 1]
        tile = im.copy() if im.dtype == np.uint8 else (im * 255).astype(np.uint8)
        ann = Annotator(tile, names)
        mask = batch["mask"][i].astype(bool)
        for b, k in zip(batch["bboxes"][i][mask], batch["cls"][i][mask]):
            if b.shape[-1] == 5:
                ann.obb_label(np.array([b[0] * s, b[1] * s, b[2] * s, b[3] * s, b[4]]), cls=int(k))
            else:
                xy = np.array([(b[0] - b[2] / 2) * s, (b[1] - b[3] / 2) * s,
                               (b[0] + b[2] / 2) * s, (b[1] + b[3] / 2) * s])
                ann.box_label(xy, cls=int(k))
        canvas[r * s:(r + 1) * s, c * s:(c + 1) * s] = ann.result()
    imwrite(path, canvas)
    return canvas


# ------------------------------------------------------------------ charts

# matplotlib's default colour cycle (tab10) and its named "blue"
SERIES_COLORS = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
                 (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]
BLUE = (0, 0, 255)
# matplotlib's "Blues" (ColorBrewer's nine anchors, linearly interpolated)
_BLUES_ANCHORS = np.array([(247, 251, 255), (222, 235, 247), (198, 219, 239), (158, 202, 225), (107, 174, 214),
                           (66, 146, 198), (33, 113, 181), (8, 81, 156), (8, 48, 107)], np.float64) / 255.0


def blues_table(n: int = 256) -> np.ndarray:
    """``[n, 3]`` uint8 RGB of the "Blues" colormap sampled at n points, as
    matplotlib builds its lookup table (linear between anchors, then * 255 truncated)."""
    x = np.linspace(0.0, 1.0, n)
    anchors = np.linspace(0.0, 1.0, len(_BLUES_ANCHORS))
    lut = np.stack([np.interp(x, anchors, _BLUES_ANCHORS[:, c]) for c in range(3)], axis=1)
    return (lut * 255).astype(np.uint8)


def _fmt_tick(v: float) -> str:
    return f"{v:.2f}".rstrip("0").rstrip(".") if abs(v) < 1e4 else f"{v:.3g}"


def _nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo]
    step = 10 ** math.floor(math.log10((hi - lo) / n))
    for m in (1, 2, 2.5, 5, 10):
        if (hi - lo) / (step * m) <= n:
            step *= m
            break
    first = math.ceil(lo / step - 1e-9) * step
    return [first + i * step for i in range(int((hi - first) / step + 1e-9) + 1)]


class Chart:
    """A white RGB canvas of matplotlib's size for ``figsize`` inches at ``dpi``,
    with axes placed on it by `axes`."""

    def __init__(self, figsize: Tuple[float, float], dpi: int):
        self.width, self.height = int(round(figsize[0] * dpi)), int(round(figsize[1] * dpi))
        self.im = np.full((self.height, self.width, 3), 255, np.uint8)
        self.unit = dpi / 100.0  # pixels of one matplotlib point at 72 dpi, roughly

    def text(self, s: str, org, scale: float, color=(0, 0, 0), anchor: str = "left",
             vertical: bool = False) -> None:
        """Text at ``org`` (left end of the baseline, or its centre / right end
        by ``anchor``); ``vertical`` turns it to read bottom to top."""
        scale *= self.unit
        th = max(int(round(self.unit)), 1) if scale >= 1.5 else 1
        w, h = text_size(s, scale, th)
        x, y = int(org[0]), int(org[1])
        if not vertical:
            x -= {"left": 0, "center": w // 2, "right": w}[anchor]
            put_text(self.im, s, (x, y), scale, color, th)
            return
        # draw on the region turned a quarter clockwise, then turn it back
        y += {"left": 0, "center": w // 2, "right": w}[anchor]
        x0, x1 = max(x - h, 0), min(x + h // 2 + 2, self.width)
        y0, y1 = max(y - w - 2, 0), min(y + 2, self.height)
        if x1 <= x0 or y1 <= y0:
            return
        region = np.ascontiguousarray(np.rot90(self.im[y0:y1, x0:x1], -1))
        put_text(region, s, (y1 - 1 - y, x - x0), scale, color, th)
        self.im[y0:y1, x0:x1] = np.rot90(region, 1)

    def axes(self, rect: Tuple[float, float, float, float], xlim, ylim, title: str = "",
             xlabel: str = "", ylabel: str = "") -> "Axes":
        """Axes in the canvas fraction ``rect`` = (left, bottom, width, height)."""
        return Axes(self, rect, xlim, ylim, title, xlabel, ylabel)

    def save(self, path) -> str:
        return imwrite(str(path), self.im)


class Axes:
    """A framed plot area with ticks, a title and axis labels; `plot` draws a
    series as one anti-aliased polyline."""

    def __init__(self, chart: Chart, rect, xlim, ylim, title, xlabel, ylabel):
        self.chart = chart
        left, bottom, w, h = rect
        self.x0 = int(round(left * chart.width))
        self.x1 = int(round((left + w) * chart.width))
        self.y1 = int(round((1 - bottom) * chart.height))
        self.y0 = int(round((1 - bottom - h) * chart.height))
        self.xlim = (float(xlim[0]), float(xlim[1]) if xlim[1] > xlim[0] else float(xlim[0]) + 1)
        self.ylim = (float(ylim[0]), float(ylim[1]) if ylim[1] > ylim[0] else float(ylim[0]) + 1)
        u = chart.unit
        lw = max(int(round(u)), 1)
        px.rectangle(chart.im, (self.x0, self.y0), (self.x1, self.y1), (0, 0, 0), lw, px.LINE_8)
        for v in _nice_ticks(*self.xlim):
            x, _ = self.to_px(v, self.ylim[0])
            px.line(chart.im, (x, self.y1), (x, self.y1 + int(4 * u)), (0, 0, 0), lw)
            chart.text(_fmt_tick(v), (x, self.y1 + int(16 * u)), 0.4, anchor="center")
        for v in _nice_ticks(*self.ylim):
            _, y = self.to_px(self.xlim[0], v)
            px.line(chart.im, (self.x0 - int(4 * u), y), (self.x0, y), (0, 0, 0), lw)
            chart.text(_fmt_tick(v), (self.x0 - int(6 * u), y + int(4 * u)), 0.4, anchor="right")
        if title:
            chart.text(title, ((self.x0 + self.x1) // 2, self.y0 - int(8 * u)), 0.5, anchor="center")
        if xlabel:
            chart.text(xlabel, ((self.x0 + self.x1) // 2, self.y1 + int(32 * u)), 0.45, anchor="center")
        if ylabel:
            chart.text(ylabel, (self.x0 - int(34 * u), (self.y0 + self.y1) // 2), 0.45, anchor="center",
                       vertical=True)
        self.legend_entries: List[Tuple[str, tuple, int]] = []

    def to_px(self, x, y):
        fx = (np.asarray(x, np.float64) - self.xlim[0]) / (self.xlim[1] - self.xlim[0])
        fy = (np.asarray(y, np.float64) - self.ylim[0]) / (self.ylim[1] - self.ylim[0])
        return (np.rint(self.x0 + fx * (self.x1 - self.x0)).astype(np.int64),
                np.rint(self.y1 - fy * (self.y1 - self.y0)).astype(np.int64))

    def plot(self, x, y, color, linewidth: float = 1.0, label: Optional[str] = None) -> None:
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        ok = np.isfinite(x) & np.isfinite(y)
        xs, ys = self.to_px(x[ok], y[ok])
        th = max(int(round(linewidth * self.chart.unit)), 1)
        if len(xs) >= 2:  # points beyond the axes are held at the frame
            pts = np.stack([np.clip(xs, self.x0, self.x1), np.clip(ys, self.y0, self.y1)], axis=1)
            px.polylines(self.chart.im, [pts], False, color, th, px.LINE_AA)
        if label is not None:
            self.legend_entries.append((label, color, th))

    def legend(self, outside: bool = True) -> None:
        """Entries in a column beside the axes (matplotlib's ``bbox_to_anchor=(1.04, 1)``)."""
        u = self.chart.unit
        x = self.x1 + int(12 * u) if outside else self.x0 + int(10 * u)
        y = self.y0 + int(12 * u)
        for label, color, th in self.legend_entries:
            px.line(self.chart.im, (x, y - int(3 * u)), (x + int(20 * u), y - int(3 * u)), color, th, px.LINE_AA)
            self.chart.text(label, (x + int(26 * u), y), 0.32)
            y += int(12 * u)
            if y > self.chart.height - 4:
                break


def plot_curves(history: List[dict], path: str = "results.png"):
    """Loss and metric curves per epoch, one panel a key (reference
    plot_results / classification experiment_manager curves): 4 x 3 inches a
    panel at 100 dpi, at most four panels a row. Returns the path, or None
    for an empty history."""
    if not history:
        return None
    keys = [k for k in history[0] if k not in ("epoch",) and isinstance(history[0][k], (int, float))]
    if not keys:
        return None
    ncols = min(len(keys), 4)
    nrows = math.ceil(len(keys) / ncols)
    chart = Chart((4 * ncols, 3 * nrows), 100)
    xs = [h["epoch"] for h in history]
    for i, k in enumerate(keys):
        r, c = divmod(i, ncols)
        ys = np.array([h.get(k, np.nan) for h in history], np.float64)
        fin = ys[np.isfinite(ys)]
        lo, hi = (float(fin.min()), float(fin.max())) if len(fin) else (0.0, 1.0)
        pad = (hi - lo) * 0.05 or max(abs(hi) * 0.05, 0.05)
        ax = chart.axes((c / ncols + 0.17 / ncols, 1 - (r + 1) / nrows + 0.2 / nrows, 0.75 / ncols, 0.68 / nrows),
                        (min(xs), max(xs)), (lo - pad, hi + pad), title=k, xlabel="epoch")
        ax.plot(xs, ys, SERIES_COLORS[0], 1.5)
    chart.save(path)
    return path
