"""``data/text_render.py`` against cv2 5.0.0, bit for bit: ``text_size``
against ``cv2.getTextSize`` and ``put_text`` against ``cv2.putText(...,
FONT_HERSHEY_SIMPLEX, scale, (235, 235, 235), 2, LINE_AA)`` on seeded noise
canvases, at both floats of each of the 32 boundaries between pixel heights
(bisected here to the last float64 bit), at 0.8, just under 2.0 and 2.0,
every glyph alone at each of the 33 heights, every word of the synthetic
datasets, 200 seeded scales, words clipped at each edge and words drawn over
each other; and a ``ValueError`` for everything the table does not cover."""

import math
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import text_render
from megreader_tpu_torch.data.datasets import _WORDS

FONT, LINE = cv2.FONT_HERSHEY_SIMPLEX, cv2.LINE_AA
CHARS = "".join(chr(c) for c in range(32, 127))
HEIGHTS = list(range(22, 55))


def _cv2(img, text, org, scale):
    cv2.putText(img, text, org, FONT, scale, (235, 235, 235), 2, LINE)
    return img


def _check(rng, text, scale, shape, org, high=50):
    img = rng.integers(0, high, shape + (3,), dtype=np.uint8)
    want = _cv2(img.copy(), text, org, scale)
    got = text_render.put_text(img.copy(), text, org, scale)
    np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {scale!r}, org {org}")
    assert text_render.text_size(text, scale) == cv2.getTextSize(text, FONT, scale, 2), \
        (text, scale)


def _boundary(k):
    """The last float of pixel height k and the first of k + 1."""
    def height(s):
        return cv2.getTextSize("a", FONT, s, 2)[0][1]

    lo, hi = max((k - 0.3) * 0.037, 0.8), min((k + 1.3) * 0.037, 2.0)
    assert height(lo) == k and height(hi) == k + 1
    while math.nextafter(lo, hi) != hi:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if height(mid) == k else (lo, mid)
    return lo, hi


@pytest.mark.parametrize("k", HEIGHTS[:-1])
def test_both_floats_of_each_boundary(k):
    lo, hi = _boundary(k)
    assert (text_render.pixel_height(lo), text_render.pixel_height(hi)) == (k, k + 1)
    rng = np.random.default_rng(k)
    for scale in (lo, hi):
        for word in _WORDS:
            _check(rng, word, scale, (80, 340), (5, 60))


@pytest.mark.parametrize("h", HEIGHTS)
def test_every_glyph_alone(h):
    rng = np.random.default_rng(100 + h)
    scale = h * 0.037
    for c in CHARS:
        _check(rng, c, scale, (3 * h, 3 * h), (h, 2 * h), high=256)
    _check(rng, CHARS, scale, (3 * h, 40 * h), (2, 2 * h))


def test_range_ends_and_seeded_scales():
    rng = np.random.default_rng(7)
    scales = [0.8, math.nextafter(2.0, 0), 2.0] + [float(s) for s in rng.uniform(0.8, 2.0, 200)]
    for scale in scales:
        word = _WORDS[int(rng.integers(len(_WORDS)))]
        (tw, th), _ = text_render.text_size(word, scale)
        _check(rng, word, scale, (th + 30, tw + 30), (int(rng.integers(0, 20)), th + 10))


def test_words_clipped_at_each_edge_and_overlapping():
    rng = np.random.default_rng(8)
    for scale in [float(s) for s in rng.uniform(0.8, 2.0, 40)]:
        word = _WORDS[int(rng.integers(len(_WORDS)))]
        (tw, th), _ = text_render.text_size(word, scale)
        shape = (th + 12, tw // 2 + 20)
        for org in ((-tw // 2, th), (tw // 4, th), (3, th // 2), (3, th + 10),
                    (-tw - 3, th), (3, -5), (tw, th), (3, th * 4), (-5, th + 40)):
            _check(rng, word, scale, shape, org, high=256)
        # two words over each other, the second over the first's pixels
        img = rng.integers(0, 50, (th + 40, tw + 60, 3), dtype=np.uint8)
        other = _WORDS[int(rng.integers(len(_WORDS)))]
        want = _cv2(_cv2(img.copy(), word, (5, th + 5), scale), other, (9, th + 12), scale)
        got = text_render.put_text(img.copy(), word, (5, th + 5), scale)
        got = text_render.put_text(got, other, (9, th + 12), scale)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call, match", [
    (lambda img: text_render.put_text(img, "text", (2, 30), 0.79), "scale"),
    (lambda img: text_render.put_text(img, "text", (2, 30), 2.01), "scale"),
    (lambda img: text_render.text_size("text", 0.5), "scale"),
    (lambda img: text_render.put_text(img, "text", (2, 30), 1.0, font=cv2.FONT_HERSHEY_PLAIN),
     "font"),
    (lambda img: text_render.text_size("text", 1.0, font=cv2.FONT_HERSHEY_DUPLEX), "font"),
    (lambda img: text_render.put_text(img, "text", (2, 30), 1.0, thickness=1), "thickness"),
    (lambda img: text_render.text_size("text", 1.0, thickness=3), "thickness"),
    (lambda img: text_render.put_text(img, "text", (2, 30), 1.0, color=(255, 255, 255)),
     "colour"),
    (lambda img: text_render.put_text(img, "text", (2, 30), 1.0, line_type=cv2.LINE_8),
     "line type"),
    (lambda img: text_render.put_text(img, "café", (2, 30), 1.0), "character"),
    (lambda img: text_render.text_size("tab\there", 1.0), "character"),
    (lambda img: text_render.put_text(img.astype(np.float32), "text", (2, 30), 1.0), "uint8"),
    (lambda img: text_render.put_text(img[..., 0], "text", (2, 30), 1.0), "uint8"),
])
def test_refuses_what_the_table_does_not_hold(call, match):
    with pytest.raises(ValueError, match=match):
        call(np.zeros((40, 80, 3), np.uint8))


def test_table_loads_on_first_use_only():
    code = ("import sys; import megreader_tpu_torch.data.datasets as d; "
            "from megreader_tpu_torch.data import text_render as t; "
            "assert t._table.cache_info().currsize == 0; "
            "d.SyntheticRecognitionDataset()[0]; assert t._table.cache_info().currsize == 1; "
            "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
