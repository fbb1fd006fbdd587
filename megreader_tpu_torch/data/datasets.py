"""Synthetic word crops for training and tests.

``SyntheticRecognitionDataset`` is a port of the JAX package's dataset of the
same name: the same words, the same per-index random stream, and cv2 text
rendering (cv2 is imported on first use, so the module imports without it).
Each item is a uint8 canvas with the word in its top-left ``size`` region.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.charset import Charset

_WORDS = (
    "the quick brown fox jumps over lazy dog reading tpu jax pallas text "
    "detection recognition scene 2020 42 100 icdar megreader flax optax"
).split()


class SyntheticRecognitionDataset:
    """Rendered word crops: white-ish text on dark noise, exact labels.

    Items: {"image": (H, W, 3) uint8 canvas, "size": (h, w) int32 of the
    rendered crop at its top left, "text": str}."""

    def __init__(
        self,
        n: int = 1024,
        canvas_hw: Tuple[int, int] = (64, 256),
        charset: Optional[Charset] = None,
        seed: int = 0,
        max_margin: int = 5,
    ):
        self.n = n
        self.canvas_hw = canvas_hw
        self.charset = charset or Charset()
        self.seed = seed
        self.max_margin = max_margin

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict:
        import cv2

        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        text = _WORDS[int(rng.integers(len(_WORDS)))]
        fs = float(rng.uniform(0.8, 2.0))
        (tw, th), _b = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, fs, 2)
        m = [int(rng.integers(0, self.max_margin + 1)) for _ in range(4)]  # l t r b
        h = th + 4 + m[1] + m[3]
        w = tw + m[0] + m[2]
        H, W = self.canvas_hw
        img = rng.integers(0, 50, (h, w, 3), dtype=np.uint8)
        cv2.putText(
            img, text, (m[0], m[1] + th), cv2.FONT_HERSHEY_SIMPLEX, fs,
            (235, 235, 235), 2, cv2.LINE_AA,
        )
        if h > H or w > W:
            s = min(H / h, W / w)
            img = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))))
            h, w = img.shape[:2]
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[:h, :w] = img
        return {"image": canvas, "size": np.array([h, w], np.int32), "text": text}
