#!/usr/bin/env python3
"""Write ``assets/glyphs/hard_tier.npz``, the glyph table that
``megreader_tpu_torch/data/hard_synth.py`` replays, and
``assets/synth/hard_manifest.json``, the digests of the JAX package's first
hard-tier items.

The hard tier draws each character as a mask from ``_char_mask(font,
height, ch)``, a pure function of its three arguments:

* the six DejaVu faces (``DejaVuSans.ttf``, ``DejaVuSans-Bold.ttf``,
  ``DejaVuSerif.ttf``, ``DejaVuSerif-Bold.ttf``, ``DejaVuSansMono.ttf``,
  ``DejaVuSansMono-Bold.ttf``, from the directory the JAX package reads;
  Bitstream Vera licence, which lets them and works made from them be
  redistributed) through PIL: ``ImageFont.truetype(path, height)``,
  ``getmetrics``, ``getlength``, ``getbbox`` and ``ImageDraw.text``;
* the five Hershey faces (SIMPLEX, DUPLEX, TRIPLEX, COMPLEX,
  SCRIPT_SIMPLEX) through cv2: ``getTextSize`` and ``putText(...,
  LINE_AA)`` at a scale and thickness taken from the height.

The card's machine has neither library nor the fonts, so this script (run
where all three are installed) records the function for the tier's whole
domain: the 11 fonts of ``available_fonts()``, the heights 12-48 (the union
of the datasets' defaults, 12-44 and 14-48, and every experiment file's
``min_height``/``max_height``) and the 36 characters of
``Charset().alphabet``, 14,652 masks. It draws them as ``_char_mask`` does,
checks each against the JAX package's ``_char_mask``, and fails if one
differs.

Arrays of the table: ``fonts`` (11,) str, each font's label
(``font_label``); ``heights`` (37,) int32; ``chars`` (36,) int32 codes;
``shape`` (11, 37, 36, 2) int32, each mask's rows and columns;
``baseline`` and ``advance`` (11, 37, 36) int32, the baseline row and the
pen advance; ``start`` (11, 37, 36) int64, each mask's offset into
``coverage``, the flat uint8 masks (row-major) one after another. The zip
is written with fixed timestamps, so a second run writes the same bytes.

The manifest holds, for the first 16 items of each entry of ``HARD``
(the datasets and keyword arguments of the eleven hard-tier experiment
files), the sha256 of each of the item's arrays, its polygons, texts and
``meta`` (``chip_smoke.item_digests``, which phase synth checks them with).

    python3 scripts/make_port_hard_assets.py [--out assets]

Recorded with cv2 5.0.0, PIL 12.1.0 (FreeType 2.14.1) and the DejaVu 2.37
files of the Debian ``fonts-dejavu-core`` package.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import zipfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import item_digests  # noqa: E402
from megreader_tpu_torch.core.charset import Charset  # noqa: E402
from megreader_tpu_torch.data import hard_synth  # noqa: E402

HEIGHTS = list(range(12, 49))
#: (manifest name, dataset class, keyword arguments): the defaults (ctc_hard,
#: ctc_hard48, ctc2d_hard, attention_hard and the mixtures), ctc_curved_ab and
#: ctc2d_curved_ab, ctc_hard_small's second part, seg_detector_hard and
#: shared_spotter_hard
HARD = [("recognition", "HardSyntheticRecognitionDataset", {"seed": 0}),
        ("recognition_curved", "HardSyntheticRecognitionDataset",
         {"seed": 10, "curve_prob": 1.0, "curve_range": [0.35, 0.9], "degrade": 0.5,
          "distractors": False}),
        ("recognition_small", "HardSyntheticRecognitionDataset",
         {"seed": 11, "min_height": 12, "max_height": 20}),
        ("detection", "HardSyntheticDetectionDataset", {"seed": 0}),
        ("detection_spotter", "HardSyntheticDetectionDataset",
         {"seed": 0, "curve_prob": 0.0, "max_rotate": 15.0})]
N_ITEMS = 16


def draw(font, height: int, ch: str, dejavu_dir: str):
    """``_char_mask(font, height, ch)``: (mask uint8, baseline row, advance)."""
    import cv2
    from PIL import Image, ImageDraw, ImageFont

    kind, ident = font
    if kind == "ttf":
        f = ImageFont.truetype(os.path.join(dejavu_dir, ident), height)
        ascent, descent = f.getmetrics()
        adv = max(1, int(round(f.getlength(ch))))
        _x0, _y0, x1, _y1 = f.getbbox(ch)
        w = max(adv, int(x1)) + 2
        img = Image.new("L", (w, ascent + descent + 2), 0)
        ImageDraw.Draw(img).text((0, 0), ch, font=f, fill=255)
        return np.asarray(img, np.uint8), ascent, adv
    face = getattr(cv2, f"FONT_HERSHEY_{ident}")
    (_w1, h1), _ = cv2.getTextSize("H", face, 1.0, 1)
    scale = max(0.35, 0.72 * height / max(h1, 1))
    th = max(1, int(round(scale * 1.8)))
    (cw, chh), base = cv2.getTextSize(ch, face, scale, th)
    pad = th + 2
    patch = np.zeros((chh + base + 2 * pad, max(cw, 1) + 2 * pad), np.uint8)
    cv2.putText(patch, ch, (pad, pad + chh), face, scale, 255, th, cv2.LINE_AA)
    return patch, pad + chh, max(cw, 1) + th


def write_npz(path: str, arrays: dict) -> None:
    """``np.savez_compressed`` with fixed zip timestamps."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            z.writestr(info, buf.getvalue(), compresslevel=9)


def main():
    import cv2
    import PIL
    from megreader_tpu.data import hard_synth as jax_hard

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "assets"))
    args = ap.parse_args()

    fonts = hard_synth.available_fonts()
    jax_fonts = jax_hard.available_fonts()
    assert [hard_synth.font_label(f) for f in fonts] == \
        [jax_hard.font_label(f) for f in jax_fonts], "the JAX package lacks a DejaVu file"
    chars = list(Charset().alphabet.replace(" ", ""))
    table = {}
    for fi, (font, jfont) in enumerate(zip(fonts, jax_fonts)):
        for h in HEIGHTS:
            for ch in chars:
                mask, base, adv = draw(font, h, ch, jax_hard._DEJAVU_DIR)
                ref = jax_hard._char_mask(jfont, h, ch)
                assert mask.dtype == ref[0].dtype and np.array_equal(mask, ref[0]) \
                    and (base, adv) == ref[1:], (font, h, ch)
                table[fi, h, ch] = (mask, int(base), int(adv))
    keys = [(fi, h, ch) for fi in range(len(fonts)) for h in HEIGHTS for ch in chars]
    dims = (len(fonts), len(HEIGHTS), len(chars))
    flat = [table[k][0].reshape(-1) for k in keys]
    start = np.cumsum([0] + [len(f) for f in flat[:-1]]).astype(np.int64).reshape(dims)
    os.makedirs(os.path.join(args.out, "glyphs"), exist_ok=True)
    path = os.path.join(args.out, "glyphs", "hard_tier.npz")
    write_npz(path, {
        "fonts": np.array([hard_synth.font_label(f) for f in fonts]),
        "heights": np.array(HEIGHTS, np.int32),
        "chars": np.array([ord(c) for c in chars], np.int32),
        "shape": np.array([table[k][0].shape for k in keys], np.int32).reshape(dims + (2,)),
        "baseline": np.array([table[k][1] for k in keys], np.int32).reshape(dims),
        "advance": np.array([table[k][2] for k in keys], np.int32).reshape(dims),
        "start": start,
        "coverage": np.concatenate(flat).astype(np.uint8),
    })
    hard_synth.GLYPHS = path
    hard_synth._glyph_table.cache_clear()
    hard_synth._CHAR_CACHE.clear()
    for fi, h, ch in keys:  # the replay
        mask, base, adv = hard_synth._char_mask(fonts[fi], h, ch)
        want = table[fi, h, ch]
        assert np.array_equal(mask, want[0]) and (base, adv) == want[1:], (fi, h, ch)
    print(f"{path}: {os.path.getsize(path)} bytes, {len(keys)} masks equal to the JAX "
          f"package's _char_mask (cv2 {cv2.__version__}, PIL {PIL.__version__})")

    manifest = {"digest": "sha256 of each array, polygon list, text and meta "
                          "(chip_smoke.py::item_digests)",
                "cv2": cv2.__version__, "PIL": PIL.__version__, "items": {}}
    for name, cls, kw in HARD:
        ds = getattr(jax_hard, cls)(**kw)
        manifest["items"][name] = {"class": cls, "kwargs": kw,
                                   "digests": [item_digests(ds[i]) for i in range(N_ITEMS)]}
    os.makedirs(os.path.join(args.out, "synth"), exist_ok=True)
    mpath = os.path.join(args.out, "synth", "hard_manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{mpath}: {sum(len(v['digests']) for v in manifest['items'].values())} items")


if __name__ == "__main__":
    main()
