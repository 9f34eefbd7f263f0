"""Write the OpenCV outputs that the train augmentations' native code must give.

    python tests/fixtures/make_augment_fixtures.py

``augment/src.npy`` is a seeded 96 x 120 RGB image (a gradient with noise and
filled rectangles); ``augment/cases.json`` holds each case's parameters;
``augment/<case>.npy`` holds what OpenCV gives for it: warps (affine and
perspective, bilinear, border 114), the HSV round trip and the HSV jitter of
the train recipe, the box and median filters, RGB to gray, both Lab
directions, CLAHE on the Lab L channel and a mask of filled polygons that
overlap and leave the image. The CPU tests hold these files to OpenCV and the port to them; the
card's machine has no OpenCV, so ``chip_smoke.py`` holds the library built
there to them. The pixels here came from OpenCV 5.0.0.
"""

import json
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parent / "augment"
H, W = 96, 120
HSV_GAINS = (0.015, 0.7, 0.4)  # the recipe's hsv_h, hsv_s, hsv_v
HSV_SEED = 3
CASES = {
    "warp_affine_turn": {"m": [[1.2862, 0.1693, -12.25], [-0.1693, 1.2862, 3.5]], "dsize": [120, 96]},
    "warp_affine_mosaic": {"m": [[0.61, 0.0213, 21.4], [-0.0213, 0.61, 30.9]], "dsize": [104, 96]},
    "warp_perspective": {"m": [[1.05, 0.04, -4.0], [-0.03, 0.98, 2.5], [4e-4, -3e-4, 1.0]], "dsize": [112, 100]},
    "rgb_to_hsv": {},
    "hsv_to_rgb": {"input": "rgb_to_hsv"},
    "random_hsv": {"gains": list(HSV_GAINS), "seed": HSV_SEED},
    "blur": {"k": 5},
    "median_blur": {"k": 7},
    "rgb_to_gray": {},
    "rgb_to_lab": {},
    "lab_to_rgb": {"input": "src"},
    "clahe": {"input": "rgb_to_lab", "channel": 0, "clip": 2.7},
    "fill_polygons": {"polygons": [[[10, 8], [70, 14], [52, 60], [6, 44]], [[40, 30], [100, 26], [92, 80]],
                                   [[60, 50], [115, 88], [30, 90]], [[100, 60], [140, 70], [110, 110]],
                                   [[-9, 70], [20, 75], [-30, 100]]]},
}


def source() -> np.ndarray:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    im = np.stack([xx * 255 // W, yy * 255 // H, (xx + yy) * 255 // (H + W)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, H - 8), rng.integers(0, W - 8)
        im[y0:y0 + rng.integers(4, 30), x0:x0 + rng.integers(4, 30)] = rng.integers(0, 256, 3)
    return np.clip(im + rng.integers(-20, 21, im.shape), 0, 255).astype(np.uint8)


def random_hsv(im: np.ndarray, gains, seed: int) -> np.ndarray:
    """The JAX package's random_hsv (OpenCV) with a generator seeded ``seed``."""
    r = np.random.default_rng(seed).uniform(-1, 1, 3) * list(gains) + 1
    hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_RGB2HSV))
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(im.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(im.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s), cv2.LUT(val, lut_v)))
    return cv2.cvtColor(im_hsv, cv2.COLOR_HSV2RGB)


def compute(src: np.ndarray) -> dict:
    """Each case's OpenCV output for the source image ``src``."""
    out = {}
    for name, case in CASES.items():
        inp = out.get(case.get("input"), src)
        if name.startswith("warp_affine"):
            out[name] = cv2.warpAffine(src, np.array(case["m"]), tuple(case["dsize"]), borderValue=(114,) * 3)
        elif name == "warp_perspective":
            out[name] = cv2.warpPerspective(src, np.array(case["m"]), tuple(case["dsize"]),
                                            borderValue=(114,) * 3)
        elif name in ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_gray", "rgb_to_lab", "lab_to_rgb"):
            code = {"rgb_to_hsv": cv2.COLOR_RGB2HSV, "hsv_to_rgb": cv2.COLOR_HSV2RGB,
                    "rgb_to_gray": cv2.COLOR_RGB2GRAY, "rgb_to_lab": cv2.COLOR_RGB2LAB,
                    "lab_to_rgb": cv2.COLOR_LAB2RGB}[name]
            out[name] = cv2.cvtColor(inp, code)
        elif name == "random_hsv":
            out[name] = random_hsv(src, case["gains"], case["seed"])
        elif name == "blur":
            out[name] = cv2.blur(src, (case["k"], case["k"]))
        elif name == "median_blur":
            out[name] = cv2.medianBlur(src, case["k"])
        elif name == "clahe":
            clahe = cv2.createCLAHE(clipLimit=case["clip"], tileGridSize=(8, 8))
            out[name] = clahe.apply(np.ascontiguousarray(inp[..., case["channel"]]))
        elif name == "fill_polygons":
            mask = np.zeros((H, W), np.uint8)
            cv2.drawContours(mask, [np.array(p, np.int32) for p in case["polygons"]], -1, 1, cv2.FILLED)
            out[name] = mask
    return out


def main() -> None:
    OUT.mkdir(exist_ok=True)
    src = source()
    np.save(OUT / "src.npy", src)
    for name, arr in compute(src).items():
        np.save(OUT / f"{name}.npy", arr)
    (OUT / "cases.json").write_text(json.dumps(CASES, indent=1) + "\n")


if __name__ == "__main__":
    main()
