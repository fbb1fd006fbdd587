"""Datasets: disk data (list files, ICDAR dir pairs), their mixture, and
synthetic word crops and pages for training and tests.

Ports of the JAX package's datasets of the same names
(``megreader_tpu/data/datasets.py``). A recognition item is a uint8 canvas
with the word in its top-left ``size`` region; a detection item is a page with
its words' polygons and, unless ``gt_maps`` is off, its host GT maps.

* ``RecognitionListDataset`` and ``DetectionICDARDataset`` read their images
  with ``imageio.read_image`` (PNG, JPEG, JPEG 2000, BMP, PNM, PFM, Sun
  raster, Radiance HDR, GIF, TIFF or WebP, chosen by the file's signature,
  bit-equal to ``cv2.imread``: the card's machine has no cv2; a JPEG cut
  short reads as cv2 reads it) and resize with ``imageio.resize_linear``
  (cv2's bilinear resize, bit for bit); their items equal the JAX items.
* ``MixtureDataset`` interleaves its parts by fractional position.
* The synthetic datasets draw the same words from the same per-index
  streams, size and draw them with ``text_render`` (cv2's ``getTextSize``
  and ``putText`` replayed from a glyph table), warp them with ``raster``
  (cv2's ``getPerspectiveTransform`` and ``warpPerspective``) and shrink
  them with ``imageio.resize_linear``; their items equal the JAX items bit
  for bit, and no route imports cv2.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.charset import Charset
from .imageio import read_image, resize_linear
from .processes import make_border_maps, make_seg_maps, parse_icdar_gt
from .raster import get_perspective_transform, warp_perspective_linear
from .text_render import put_text, text_size


class RecognitionListDataset:
    """Word crops listed one a line as ``relative/path<TAB>transcript``,
    relative to ``image_root`` (default: the list file's directory). Crops
    larger than ``canvas_hw`` are shrunk to fit, aspect kept."""

    def __init__(self, list_path: str, image_root: Optional[str] = None,
                 canvas_hw: Tuple[int, int] = (64, 256)):
        self.image_root = image_root or os.path.dirname(os.path.abspath(list_path))
        with open(list_path) as f:
            self.items = [line.rstrip("\n").split("\t", 1) for line in f if line.strip()]
        self.canvas_hw = canvas_hw

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        path, text = self.items[i]
        img = read_image(os.path.join(self.image_root, path))
        H, W = self.canvas_hw
        h, w = img.shape[:2]
        if h > H or w > W:
            s = min(H / h, W / w)
            img = resize_linear(img, (max(1, int(w * s)), max(1, int(h * s))))
            h, w = img.shape[:2]
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[:h, :w] = img
        return {"image": canvas, "size": np.array([h, w], np.int32), "text": text}


_PAGE_EXTS = (".jpg", ".png", ".jpeg")


class DetectionICDARDataset:
    """An ICDAR dir pair: pages in ``image_dir``, and for page ``name`` the
    file ``gt_name.txt`` or ``name.txt`` in ``gt_dir`` (utf-8, a BOM
    allowed), one ``x1,y1,...,x4,y4,transcript`` line a word, ``###`` a
    region to ignore.

    Each page is resized to ``target_hw`` (its polygons with it, and
    ``scale`` maps them back) or, with ``augment``, flipped, scaled and
    cropped by ``det_augment.augment_detection_sample`` from the numpy
    stream of ``seed * 7_919 + i`` (texts then empty: the crop drops the
    pairing). ``gt_maps`` adds the host GT maps."""

    def __init__(self, image_dir: str, gt_dir: str, target_hw: Tuple[int, int] = (640, 640),
                 shrink_ratio: float = 0.4, augment: bool = False, seed: int = 0,
                 gt_maps: bool = True):
        self.image_dir = image_dir
        self.gt_dir = gt_dir
        self.target_hw = target_hw
        self.shrink_ratio = shrink_ratio
        self.augment = augment
        self.seed = seed
        self.gt_maps = gt_maps
        self.names = sorted(os.path.splitext(n)[0] for n in os.listdir(image_dir)
                            if n.lower().endswith(_PAGE_EXTS))

    def __len__(self):
        return len(self.names)

    def _gt_path(self, name: str) -> str:
        for pat in (f"gt_{name}.txt", f"{name}.txt"):
            p = os.path.join(self.gt_dir, pat)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no GT for {name}")

    def __getitem__(self, i: int) -> Dict:
        name = self.names[i]
        for ext in _PAGE_EXTS:
            p = os.path.join(self.image_dir, name + ext)
            if os.path.exists(p):
                break
        img = read_image(p)
        with open(self._gt_path(name), encoding="utf-8-sig") as f:
            polys, ignored, texts = parse_icdar_gt(f.readlines())

        H, W = self.target_hw
        if self.augment:
            from .det_augment import augment_detection_sample

            rng = np.random.default_rng(self.seed * 7_919 + i)
            out = augment_detection_sample(rng, img, polys, ignored, (H, W))
            img, polys, ignored = out["image"], out["polygons"], out["ignore"]
            texts = [""] * len(polys)
            sx = sy = 1.0
        else:
            h, w = img.shape[:2]
            sx, sy = W / w, H / h
            img = resize_linear(img, (W, H))
            polys = [p * np.array([sx, sy], np.float32) for p in polys]

        out = {"image": img, "polygons": polys, "ignore": ignored, "texts": texts,
               "scale": np.array([1.0 / sx, 1.0 / sy], np.float32), "filename": name}
        if self.gt_maps:
            seg = make_seg_maps(polys, ignored, (H, W), self.shrink_ratio)
            border = make_border_maps(polys, ignored, (H, W), self.shrink_ratio)
            out.update(gt=seg["gt"], mask=seg["mask"], thresh_map=border["thresh_map"],
                       thresh_mask=border["thresh_mask"])
        return out


class MixtureDataset:
    """Every sample of every part, interleaved by fractional position: part
    k's j-th sample sits at (j + 0.5) / len(part k), ties by part order, so
    each stretch of an epoch holds the parts in proportion."""

    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        pos = []
        for k, p in enumerate(self.parts):
            n = len(p)
            pos.extend(((j + 0.5) / n, k, j) for j in range(n))
        pos.sort()
        self._index = [(k, j) for _, k, j in pos]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i: int) -> Dict:
        k, j = self._index[i]
        return self.parts[k][j]

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
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        text = _WORDS[int(rng.integers(len(_WORDS)))]
        fs = float(rng.uniform(0.8, 2.0))
        (tw, th), _b = text_size(text, fs)
        m = [int(rng.integers(0, self.max_margin + 1)) for _ in range(4)]  # l t r b
        h = th + 4 + m[1] + m[3]
        w = tw + m[0] + m[2]
        H, W = self.canvas_hw
        img = rng.integers(0, 50, (h, w, 3), dtype=np.uint8)
        put_text(img, text, (m[0], m[1] + th), fs)
        if h > H or w > W:
            s = min(H / h, W / w)
            img = resize_linear(img, (max(1, int(w * s)), max(1, int(h * s))))
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
        H, W = img.shape[:2]
        (tw, th), _b = text_size(text, fs)
        ph, pw = th + 6, tw + 2
        patch = put_text(np.zeros((ph, pw, 3), np.uint8), text, (1, th + 1), fs)
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

        M = get_perspective_transform(src, dst.astype(np.float32))
        warped = warp_perspective_linear(patch, M, (bw, bh))
        roi = img[py:py + bh, px:px + bw]
        np.maximum(roi, warped, out=roi)
        return quad.astype(np.float32)

    def __getitem__(self, i: int) -> Dict:
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
            (tw, th), _b = text_size(text, fs)
            x = int(rng.integers(5, max(6, W - tw - 5)))
            y = int(rng.integers(th + 5, max(th + 6, H - 5)))
            box = np.array([[x, y - th], [x + tw, y - th], [x + tw, y + 4], [x, y + 4]],
                           np.float32)
            if any(_overlaps(box, q) for q in polys):
                continue
            put_text(img, text, (x, y), fs)
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
