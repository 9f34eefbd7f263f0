"""Letterbox preprocessing (counterpart of the JAX package's ``data/augment.py:letterbox``).

The resize runs in PyTorch on the frame's device (bilinear, half-pixel
centres, no antialiasing, as OpenCV's ``INTER_LINEAR``) and rounds back to
uint8; the padding is gray 114.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F


def letterbox(im: torch.Tensor, new_shape: Union[int, Tuple[int, int]], scaleup: bool = True,
              center: bool = True) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize and pad a uint8 ``[h, w, 3]`` frame to ``new_shape`` keeping aspect.

    Returns (uint8 image ``[H, W, 3]``, gain, (pad_w, pad_h)).
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    H, W = new_shape
    h, w = im.shape[:2]
    r = min(H / h, W / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h * r), round(w * r)
    if (nh, nw) != (h, w):
        t = im.permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
        im = t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    top, left = ((H - nh) // 2, (W - nw) // 2) if center else (0, 0)
    out = torch.full((H, W, 3), 114, dtype=torch.uint8, device=im.device)
    out[top:top + nh, left:left + nw] = im
    return out, r, (left, top)
