"""Detection train-time augmentation on the host: flip, scale and a
text-biased crop that move the GT polygons with the image.

A port of ``megreader_tpu/data/det_augment.py`` with the same draws from the
same numpy generator; ``cv2.resize`` becomes ``imageio.resize_linear`` (cv2's
bilinear geometry, within one grey level of cv2). It runs before the GT maps
are made, so the maps follow the moved polygons.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .imageio import resize_linear


def random_flip(rng: np.random.Generator, image: np.ndarray, polygons: List[np.ndarray],
                prob: float = 0.5) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Mirror left-right with probability ``prob``; each polygon's x becomes
    W - 1 - x and its vertex order reverses (it stays clockwise)."""
    if rng.random() < prob:
        W = image.shape[1]
        image = image[:, ::-1].copy()
        polygons = [np.stack([W - 1 - p[:, 0], p[:, 1]], axis=1)[::-1].copy() for p in polygons]
    return image, polygons


def random_scale(rng: np.random.Generator, image: np.ndarray, polygons: List[np.ndarray],
                 scales: Sequence[float] = (0.5, 0.75, 1.0, 1.5, 2.0),
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Resize by one of ``scales`` (bilinear), the polygons with it."""
    s = float(rng.choice(np.asarray(scales)))
    if s == 1.0:
        return image, polygons
    h, w = image.shape[:2]
    image = resize_linear(image, (max(1, int(w * s)), max(1, int(h * s))))
    return image, [p * s for p in polygons]


def random_crop_biased(rng: np.random.Generator, image: np.ndarray,
                       polygons: List[np.ndarray], ignore: List[bool],
                       crop_hw: Tuple[int, int], max_tries: int = 10,
                       min_text_fraction: float = 0.1,
                       ) -> Tuple[np.ndarray, List[np.ndarray], List[bool]]:
    """A ``crop_hw`` window that keeps at least one cared-for polygon whole
    (centred near a random one with probability 0.875, else anywhere), over
    at most ``max_tries`` tries, then anywhere; zero-padded where the image
    is smaller. Polygons that cross the window's border are dropped.
    ``min_text_fraction`` is accepted and unused, as in the JAX package."""
    H, W = crop_hw
    h, w = image.shape[:2]
    canvas = np.zeros((H, W) + image.shape[2:], image.dtype)
    care = [p for p, ig in zip(polygons, ignore) if not ig]

    def place(x0, y0):
        x1, y1 = min(x0 + W, w), min(y0 + H, h)
        canvas[: y1 - y0, : x1 - x0] = image[y0:y1, x0:x1]
        out_p, out_i = [], []
        for p, ig in zip(polygons, ignore):
            q = p - np.array([x0, y0], np.float32)
            if ((q[:, 0] >= 0).all() and (q[:, 1] >= 0).all() and (q[:, 0] < W).all()
                    and (q[:, 1] < H).all()):
                out_p.append(q)
                out_i.append(ig)
        return canvas, out_p, out_i

    if h <= H and w <= W:
        return place(0, 0)
    for _ in range(max_tries):
        if care and rng.random() < 0.875:  # biased toward text
            p = care[int(rng.integers(len(care)))]
            cx = (p[:, 0].min() + p[:, 0].max()) / 2
            cy = (p[:, 1].min() + p[:, 1].max()) / 2
            x0 = int(np.clip(cx - W / 2 + rng.integers(-W // 4, W // 4 + 1), 0, max(0, w - W)))
            y0 = int(np.clip(cy - H / 2 + rng.integers(-H // 4, H // 4 + 1), 0, max(0, h - H)))
        else:
            x0 = int(rng.integers(0, max(1, w - W)))
            y0 = int(rng.integers(0, max(1, h - H)))
        out = place(x0, y0)
        if out[1] or not care:
            return out
        canvas[:] = 0
    return place(int(rng.integers(0, max(1, w - W))), int(rng.integers(0, max(1, h - H))))


def augment_detection_sample(rng: np.random.Generator, image: np.ndarray,
                             polygons: List[np.ndarray], ignore: List[bool],
                             crop_hw: Tuple[int, int] = (640, 640)) -> Dict:
    """Flip, scale, then the biased crop: {image, polygons, ignore}."""
    image, polygons = random_flip(rng, image, polygons)
    image, polygons = random_scale(rng, image, polygons)
    image, polygons, ignore = random_crop_biased(rng, image, polygons, ignore, crop_hw)
    return {"image": image, "polygons": polygons, "ignore": ignore}
