"""Size buckets for pages of any size.

A port of ``megreader_tpu/data/bucketing.py``: each page is scaled (keeping
its aspect, never up) into the smallest of a few fixed canvases that keeps
it largest, padded at the bottom and right, and batched with the pages of
the same canvas. The resize is ``data/imageio.py::resize_linear`` (cv2's
INTER_LINEAR, bit for bit on float32 pages), since the card's machine has no
cv2. Default buckets: ICDAR-style pages at multiples of 32 (the FPN's
stride).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .imageio import resize_linear

DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (640, 640),
    (640, 1152),
    (1152, 640),
    (1152, 1152),
)


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS) -> Tuple[int, int]:
    """The bucket that keeps an (h, w) page largest (its scale, at most 1:
    never upscaled), the smallest such by area."""
    best, best_scale, best_area = None, -1.0, None
    for bh, bw in buckets:
        scale = min(bh / h, bw / w, 1.0)
        area = bh * bw
        if best is None or scale > best_scale + 1e-9 or (
            abs(scale - best_scale) <= 1e-9 and area < best_area
        ):
            best, best_scale, best_area = (bh, bw), scale, area
    return best


def fit_to_bucket(image: np.ndarray, bucket_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Scale (keeping the aspect, at most 1: a smaller page is padded at its
    own scale) and pad to the bucket. Returns {image, valid_hw (2,) int32,
    scale (2,) float32 = (sx, sy) from bucket to page pixels}."""
    H, W = bucket_hw
    h, w = image.shape[:2]
    s = min(H / h, W / w, 1.0)
    nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
    canvas = np.zeros((H, W) + image.shape[2:], image.dtype)
    canvas[:nh, :nw] = resize_linear(image, (nw, nh))
    return {
        "image": canvas,
        "valid_hw": np.array([nh, nw], np.int32),
        "scale": np.array([w / nw, h / nh], np.float32),
    }


class BucketBatcher:
    """Groups samples by bucket; a batch is ready when one fills, or on
    ``flush``."""

    def __init__(self, batch_size: int, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS):
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self._pending: Dict[Tuple[int, int], List[Dict]] = {b: [] for b in self.buckets}

    def add(self, sample: Dict) -> List[Dict]:
        """``sample`` carries 'image' (H, W, C); returns 0 or 1 ready batches."""
        h, w = sample["image"].shape[:2]
        b = pick_bucket(h, w, self.buckets)
        out = dict(sample)
        out.update(fit_to_bucket(sample["image"], b))
        self._pending[b].append(out)
        if len(self._pending[b]) >= self.batch_size:
            batch, self._pending[b] = self._pending[b], []
            return [self._stack(batch, b)]
        return []

    def flush(self) -> List[Dict]:
        ready = []
        for b, items in self._pending.items():
            if items:
                ready.append(self._stack(items, b))
                self._pending[b] = []
        return ready

    @staticmethod
    def _stack(items: List[Dict], bucket: Tuple[int, int]) -> Dict:
        batch = {
            "image": np.stack([i["image"] for i in items]),
            "valid_hw": np.stack([i["valid_hw"] for i in items]),
            "scale": np.stack([i["scale"] for i in items]),
            "bucket": bucket,
        }
        for k in ("polygons", "ignore", "texts", "filename"):
            if k in items[0]:
                batch[k] = [i[k] for i in items]
        return batch
