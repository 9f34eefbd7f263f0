"""Predict sources: images, directories, arrays and lists of them
(counterpart of the JAX package's ``data/loaders.py``; reference
ultralytics/data/loaders.py LoadImagesAndVideos).

Image files (PNG, JPEG, BMP, TIFF, WebP; and, by their path, the stills
``cv2.imread`` also takes: PxM, PAM, PFM, Sun raster, Radiance HDR, GIF)
are read by the port's readers (`data.native.native.imread`: RGB, the
pixels ``cv2.imread`` then ``cvtColor(BGR2RGB)`` gives). Video files are read by the port's demuxers and
decoders (`data.native.video.frames`: RGB frames in display order, the pixels
``cv2.VideoCapture`` then ``cvtColor(BGR2RGB)`` gives), streamed one frame at
a time. As with ``cv2.VideoCapture``, a missing or unreadable video yields no
frames and a damaged one the frames before the damage; a codec or coding tool
the port does not decode raises `NotImplementedError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Generator, Iterable, Union

import numpy as np

from quan_ultralytics_tpu_torch.data.dataset import IMG_EXTS
from quan_ultralytics_tpu_torch.data.native.native import imread
from quan_ultralytics_tpu_torch.data.native.video import frames

VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}


def load_source(source: Union[str, Path, np.ndarray, Iterable]) -> Generator[np.ndarray, None, None]:
    """Yield RGB ``uint8 [h, w, 3]`` images from any supported source; a
    directory's images in name order."""
    if isinstance(source, np.ndarray):
        yield source
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_source(s)
        return
    p = Path(str(source))
    if p.is_dir():
        for f in sorted(p.iterdir()):
            if f.suffix.lower() in IMG_EXTS:
                yield from load_source(f)
        return
    if p.suffix.lower() in VID_EXTS:
        yield from frames(p)
        return
    if p.suffix.lower() in IMG_EXTS or p.exists():
        try:
            yield imread(p)
        except (OSError, ValueError) as e:  # cv2.imread returns None: the JAX loader raises
            raise FileNotFoundError(f"could not read {p}") from e
        return
    raise FileNotFoundError(f"unsupported source {source!r}")
