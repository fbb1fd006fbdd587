"""LMDB-backed recognition dataset: the port of
``megreader_tpu/data/lmdb_dataset.py``.

The community layout of scene-text LMDBs (MJSynth, SynthText):

  num-samples        -> int, as ASCII
  image-%09d         -> encoded JPEG or PNG bytes (1-based)
  label-%09d         -> the utf-8 transcript

Records are read through the port's ``lmdb_lite.Reader`` only (the card's
machine has no ``lmdb`` C package), decoded by ``imageio.decode_image``
(cv2's ``imdecode`` + ``BGR2RGB``, bit for bit), shrunk to fit the canvas by
``imageio.resize_linear`` (cv2's INTER_LINEAR) and put top-left on a black
canvas, so items equal the JAX dataset's bit for bit.

As in the JAX package, the class registers itself by ``@register`` when this
module is imported; the port's ``all.py`` imports it, so a YAML's
``{class: LMDBRecognitionDataset, path: <dir>, canvas_hw: [32, 100]}`` builds
it through ``Experiment.from_yaml`` (the JAX ``all.py`` does not import the
module, so there a YAML reaches the class only once it has been imported).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.registry import register
from .imageio import decode_image, resize_linear
from .lmdb_lite import Reader


@register
class LMDBRecognitionDataset:
    def __init__(self, path: str, canvas_hw: Tuple[int, int] = (64, 256)):
        self.path = path
        self.db = Reader(path)
        n = self.db.get(b"num-samples")
        if n is None:
            raise ValueError(f"{path}: missing 'num-samples' key")
        self.n = int(n.decode())
        self.canvas_hw = canvas_hw

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict:
        key = f"{i + 1:09d}"
        img_bytes = self.db.get(f"image-{key}".encode())
        label = self.db.get(f"label-{key}".encode())
        if img_bytes is None or label is None:
            raise KeyError(f"{self.path}: no record {key}")
        img = decode_image(img_bytes, f"{self.path}:image-{key}")
        H, W = self.canvas_hw
        h, w = img.shape[:2]
        if h > H or w > W:
            s = min(H / h, W / w)
            img = resize_linear(img, (max(1, int(w * s)), max(1, int(h * s))))
            h, w = img.shape[:2]
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[:h, :w] = img
        return {"image": canvas, "size": np.array([h, w], np.int32), "text": label.decode()}

    def __getstate__(self):
        # the reader holds an mmap: a process worker reopens the file
        return {"path": self.path, "canvas_hw": self.canvas_hw}

    def __setstate__(self, state):
        self.__init__(state["path"], state["canvas_hw"])
