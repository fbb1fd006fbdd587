"""Synthetic word crops and pages for training and tests.

``SyntheticRecognitionDataset`` and ``SyntheticDetectionDataset`` are ports of
the JAX package's datasets of the same names: the same words, the same
per-index random streams, and cv2 text rendering (cv2 is imported on first
use, so the module imports without it). A recognition item is a uint8 canvas
with the word in its top-left ``size`` region; a detection item is a page with
its words' exact quads and, unless ``gt_maps`` is off, its host GT maps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.charset import Charset
from .processes import make_border_maps, make_seg_maps

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


class SyntheticDetectionDataset:
    """Pages with rendered words at random positions and their exact quads.

    ``max_rotate`` (degrees) and ``max_persp`` (fraction) render each word
    into a patch warped onto the page by a random rotation and perspective;
    its polygon is the warped quad. ``gt_maps`` (off when the experiment
    rasterizes on the device) adds the host maps gt, mask, thresh_map,
    thresh_mask."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (640, 640), seed: int = 0,
                 shrink_ratio: float = 0.4, gt_maps: bool = True,
                 max_rotate: float = 0.0, max_persp: float = 0.0):
        self.n = n
        self.hw = hw
        self.seed = seed
        self.shrink_ratio = shrink_ratio
        self.gt_maps = gt_maps
        self.max_rotate = max_rotate
        self.max_persp = max_persp

    def __len__(self):
        return self.n

    def _paste_warped(self, rng, img, text, fs, existing):
        """Render a word patch, warp it, paste it by max; the warped quad, or
        None if it does not fit or overlaps an earlier word."""
        import cv2

        H, W = img.shape[:2]
        (tw, th), _b = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, fs, 2)
        ph, pw = th + 6, tw + 2
        patch = np.zeros((ph, pw, 3), np.uint8)
        cv2.putText(patch, text, (1, th + 1), cv2.FONT_HERSHEY_SIMPLEX, fs,
                    (235, 235, 235), 2, cv2.LINE_AA)
        src = np.array([[0, 0], [pw - 1, 0], [pw - 1, ph - 1], [0, ph - 1]], np.float32)

        rot = np.deg2rad(rng.uniform(-self.max_rotate, self.max_rotate))
        R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]], np.float32)
        c = np.array([(pw - 1) / 2, (ph - 1) / 2], np.float32)
        dst = (src - c) @ R.T
        if self.max_persp > 0:
            jitter = rng.uniform(-self.max_persp, self.max_persp, (4, 2)).astype(np.float32)
            dst = dst * (1.0 + jitter)
        dst = dst + c

        x0, y0 = dst.min(axis=0)
        dst -= [x0, y0]
        bw, bh = int(np.ceil(dst[:, 0].max())) + 1, int(np.ceil(dst[:, 1].max())) + 1
        if bw >= W - 10 or bh >= H - 10:
            return None
        px = int(rng.integers(5, W - bw - 5))
        py = int(rng.integers(5, H - bh - 5))
        quad = (dst + [px, py]).astype(np.float32)
        if any(_overlaps(quad, q) for q in existing):
            return None

        M = cv2.getPerspectiveTransform(src, dst.astype(np.float32))
        warped = cv2.warpPerspective(patch, M, (bw, bh), flags=cv2.INTER_LINEAR)
        roi = img[py:py + bh, px:px + bw]
        np.maximum(roi, warped, out=roi)
        return quad.astype(np.float32)

    def __getitem__(self, i: int) -> Dict:
        import cv2

        rng = np.random.default_rng(self.seed * 999_983 + i)
        H, W = self.hw
        img = rng.integers(0, 50, (H, W, 3), dtype=np.uint8)
        polys: List[np.ndarray] = []
        texts: List[str] = []
        for _ in range(int(rng.integers(3, 9))):
            text = _WORDS[int(rng.integers(len(_WORDS)))]
            fs = float(rng.uniform(0.8, 2.0))
            if self.max_rotate > 0 or self.max_persp > 0:
                quad = None
                for _try in range(4):  # retry placement on overlap
                    quad = self._paste_warped(rng, img, text, fs, polys)
                    if quad is not None:
                        break
                if quad is not None:
                    polys.append(quad)
                    texts.append(text)
                continue
            (tw, th), _b = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, fs, 2)
            x = int(rng.integers(5, max(6, W - tw - 5)))
            y = int(rng.integers(th + 5, max(th + 6, H - 5)))
            box = np.array([[x, y - th], [x + tw, y - th], [x + tw, y + 4], [x, y + 4]],
                           np.float32)
            if any(_overlaps(box, q) for q in polys):
                continue
            cv2.putText(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, fs, (235, 235, 235), 2,
                        cv2.LINE_AA)
            polys.append(box)
            texts.append(text)
        ignored = [False] * len(polys)
        out = {
            "image": img,
            "polygons": polys,
            "ignore": ignored,
            "texts": texts,
            "scale": np.array([1.0, 1.0], np.float32),
            "filename": f"synth_{i}",
        }
        if self.gt_maps:
            seg = make_seg_maps(polys, ignored, (H, W), self.shrink_ratio)
            border = make_border_maps(polys, ignored, (H, W), self.shrink_ratio)
            out.update(gt=seg["gt"], mask=seg["mask"], thresh_map=border["thresh_map"],
                       thresh_mask=border["thresh_mask"])
        return out


def _overlaps(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether the axis-aligned boxes of two polygons touch."""
    ax0, ay0, ax1, ay1 = a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max()
    bx0, by0, bx1, by1 = b[:, 0].min(), b[:, 1].min(), b[:, 0].max(), b[:, 1].max()
    return not (ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0)
