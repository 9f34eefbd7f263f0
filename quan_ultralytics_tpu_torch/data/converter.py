"""Dataset converters: DOTA raw labels -> YOLO-OBB, COCO json -> YOLO
(counterpart of the JAX ``data/converter.py``; reference
ultralytics/data/converter.py:421-516 convert_dota_to_yolo_obb and the COCO
converters). The DOTA class vocabulary is DOTA-v1.0's. An image's size comes
from its file header (`data.native.native.read_shape`: PNG, JPEG, BMP, TIFF or
WebP, turned by an EXIF orientation as OpenCV turns it), where JAX decodes
the whole image; the label files are the same bytes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

from quan_ultralytics_tpu_torch.data.native.native import read_shape

DOTA_CLASSES = [
    "plane", "ship", "storage-tank", "baseball-diamond", "tennis-court",
    "basketball-court", "ground-track-field", "harbor", "bridge",
    "large-vehicle", "small-vehicle", "helicopter", "roundabout",
    "soccer-ball-field", "swimming-pool",
]


def convert_dota_to_yolo_obb(dota_root: str) -> int:
    """DOTA raw annotations (labelTxt ``x1 y1 ... x4 y4 class difficult``) ->
    normalized YOLO-OBB labels (reference converter.py:421-516).

    Expects ``{root}/images/{split}`` + ``{root}/labelTxt/{split}``; writes
    ``{root}/labels/{split}``. Returns converted file count.
    """
    root = Path(dota_root)
    cls_map = {n: i for i, n in enumerate(DOTA_CLASSES)}
    count = 0
    for split in ("train", "val"):
        img_dir = root / "images" / split
        ann_dir = root / "labelTxt" / split
        out_dir = root / "labels" / split
        if not ann_dir.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        for ann in sorted(ann_dir.glob("*.txt")):
            img = None
            for ext in (".png", ".jpg", ".tif", ".bmp"):
                p = img_dir / (ann.stem + ext)
                if p.exists():
                    img = p
                    break
            if img is None:
                continue
            h, w = read_shape(img)
            lines = []
            for row in ann.read_text().splitlines():
                parts = row.split()
                if len(parts) < 9 or parts[0] in ("imagesource:", "gsd:"):
                    continue
                coords = [float(v) for v in parts[:8]]
                name = parts[8]
                if name not in cls_map:
                    continue
                norm = [coords[i] / (w if i % 2 == 0 else h) for i in range(8)]
                lines.append(" ".join([str(cls_map[name])] + [f"{v:.6g}" for v in norm]))
            (out_dir / ann.name).write_text("\n".join(lines) + ("\n" if lines else ""))
            count += 1
    return count


def convert_coco_to_yolo(ann_json: str, out_labels_dir: str,
                         cls91to80: bool = True) -> int:
    """COCO instances json -> per-image YOLO detect labels (normalized xywh).

    Reference converter.py convert_coco. Returns label-file count."""
    with open(ann_json) as fh:
        coco = json.load(fh)
    images = {im["id"]: im for im in coco["images"]}
    cats = sorted(c["id"] for c in coco["categories"])
    cat_to_idx = {c: i for i, c in enumerate(cats)}
    per_image: Dict[int, List[str]] = {}
    for a in coco["annotations"]:
        if a.get("iscrowd"):
            continue
        im = images[a["image_id"]]
        w, h = im["width"], im["height"]
        x, y, bw, bh = a["bbox"]
        cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
        line = f"{cat_to_idx[a['category_id']]} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}"
        per_image.setdefault(a["image_id"], []).append(line)
    out = Path(out_labels_dir)
    out.mkdir(parents=True, exist_ok=True)
    for img_id, im in images.items():
        stem = Path(im["file_name"]).stem
        lines = per_image.get(img_id, [])
        (out / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    return len(images)
