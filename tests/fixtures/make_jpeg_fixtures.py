"""Write the baseline-JPEG fixtures and the pixels OpenCV decodes from them.

    python tests/fixtures/make_jpeg_fixtures.py

Each ``<name>.jpg`` is written by ``cv2.imwrite`` from a seeded image (a
gradient with noise and filled rectangles); ``<name>.npy`` holds
``cv2.cvtColor(cv2.imread(<name>.jpg), COLOR_BGR2RGB)``, the RGB uint8
pixels that the port's JPEG reader must give. Needs OpenCV built with
libjpeg-turbo (the pixels here came from OpenCV 5.0.0, libjpeg-turbo 3.1.2);
the card's machine has no OpenCV, so the pixels are committed.
"""

from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
# name: (h, w, channels, quality, sampling factor, restart interval in MCUs)
FIXTURES = {
    "jpeg_420_q90_rst": (120, 160, 3, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 4),
    "jpeg_422_q75_odd": (75, 101, 3, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, 0),
    "jpeg_gray_q95": (45, 63, 1, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, 0),
}
# a 1024 x 1024 4:2:0 file for timing the decoder; its pixels are checked
# against OpenCV by the CPU tests, not committed
TIMING = ("jpeg_1024_q75", (1024, 1024, 3, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 0))


def image(h: int, w: int, c: int, seed: int, noise: int = 12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    for _ in range(5):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        im[y0:y0 + rng.integers(4, 24), x0:x0 + rng.integers(4, 24)] = rng.integers(0, 256, 3)
    im = np.clip(im + rng.integers(-noise, noise + 1, im.shape), 0, 255).astype(np.uint8)
    return im[..., :1] if c == 1 else im


def main() -> None:
    for seed, (name, (h, w, c, q, samp, rst)) in enumerate(FIXTURES.items()):
        path = HERE / f"{name}.jpg"
        cv2.imwrite(str(path), image(h, w, c, seed), [
            cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        np.save(HERE / f"{name}.npy", cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    name, (h, w, c, q, samp, rst) = TIMING
    cv2.imwrite(str(HERE / f"{name}.jpg"), image(h, w, c, len(FIXTURES), noise=2), [
        cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp])


if __name__ == "__main__":
    main()
