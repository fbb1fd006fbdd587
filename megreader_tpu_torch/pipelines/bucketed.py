"""Serving pages of any size through a few fixed canvases.

A port of ``megreader_tpu/pipelines/bucketed.py``: each page is scaled (never
up) into the smallest bucket that keeps it largest (``data/bucketing.py``),
grouped with the pages of its bucket, run through the ``E2EPipeline`` in
batches of at most ``batch``, and its detections mapped back to the page's
own pixels by its scale; a detection centred in the pad margin is dropped.

The JAX package pads a short group with blank pages so that each bucket
compiles one program; torch compiles nothing, so the port runs the pages it
has and no blank page. Each page's detections are its own either way: every
stage of the page program works page by page.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.bucketing import DEFAULT_BUCKETS, fit_to_bucket, pick_bucket


class BucketedE2E:
    """Mixed-size pages -> per-page detection dicts in the pages' pixels.

    Wraps an ``E2EPipeline``: a detection's ``polygon`` is scaled back to the
    page, its ``quad`` stays in the bucket's pixels, as in the JAX
    package."""

    def __init__(self, pipeline, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 batch: int = 4):
        self.pipeline = pipeline
        self.buckets = tuple(buckets)
        self.batch = batch

    def predict(self, det_module, rec_module, images: List[np.ndarray]) -> List[List[Dict]]:
        """``images``: (H, W, 3) float32 or uint8 arrays of any sizes; the
        modules as ``E2EPipeline.predict`` takes them (None: the wrappers')."""
        fitted = []
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            b = pick_bucket(h, w, self.buckets)
            fitted.append(fit_to_bucket(np.asarray(img, np.float32), b))
            groups.setdefault(b, []).append(i)

        results: List[Optional[List[Dict]]] = [None] * len(images)
        for idxs in groups.values():
            for s in range(0, len(idxs), self.batch):
                chunk = idxs[s:s + self.batch]
                pages = np.stack([fitted[i]["image"] for i in chunk])
                pred = self.pipeline.predict(det_module, rec_module, pages)
                for j, i in enumerate(chunk):
                    nh, nw = fitted[i]["valid_hw"]
                    sx, sy = fitted[i]["scale"]
                    page = []
                    for det in pred[j]:
                        poly = np.asarray(det["polygon"], np.float32)
                        if poly[:, 0].mean() >= nw or poly[:, 1].mean() >= nh:  # pad margin
                            continue
                        page.append({**det, "polygon": poly * np.array([[sx, sy]], np.float32)})
                    results[i] = page
        return results
