"""Hard synthetic text tier: multi-font, degraded, curved-baseline rendering.

A copy of the JAX package's ``megreader_tpu/data/hard_synth.py`` (it imports
no JAX): the same fonts, backgrounds, degradations, curved baselines and
chain polygons, from the same numpy streams, so that an item equals the JAX
item bit for bit.

* **Fonts**: the DejaVu TTF family (Sans/Serif/Mono x regular/bold), which
  the JAX package draws with PIL, plus five Hershey faces, which it draws
  with cv2.
* **Polarity/contrast**: dark-on-light and light-on-dark, contrast sampled
  down to barely legible.
* **Backgrounds**: flat, Gaussian noise, low-frequency texture, gradients.
* **Degradations**: Gaussian blur, low-res resampling, sensor noise, JPEG
  artifacts, contrast/brightness jitter.
* **Distractors**: neighbour-character fragments at crop edges, underlines.
* **Curved baselines**: per-character placement along a sine arc with
  tangent rotation; curved words carry chain polygons (top/bottom point
  chains), and the GT shrink/dilate moves chain points along their rungs
  (``chain_seg_maps``).

Every sample carries a ``meta`` dict of condition tags (font, polarity,
curve amplitude, height, degradations); the collates drop it.

No cv2, PIL or font file is used. Each character's mask is replayed from
``assets/glyphs/hard_tier.npz`` (``scripts/make_port_hard_assets.py``
records the JAX ``_char_mask`` there for the 11 fonts, the heights 12-48
and the 36 characters of the default alphabet; a key outside it raises
``KeyError``, a missing table ``FileNotFoundError``; it loads on first
use). The cv2 calls are numpy copies held to cv2 bit for bit: the rotations
by ``raster.get_rotation_matrix_2d``/``warp_affine_linear``, the texture by
``imageio.resize_cubic``, the blur by ``raster.gaussian_blur``, the low-res
pass by ``imageio.resize_area`` and ``resize_linear``, the JPEG round trip
by ``jpeg.jpeg_round_trip``, the underline by ``raster.polylines`` and the
chain maps by ``raster.fill_poly``, ``polylines`` and
``distance_transforms_l2_3``. The font list is fixed (the six DejaVu faces,
then the Hershey faces), so every machine draws the same fonts.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.charset import Charset
from .imageio import resize_area, resize_cubic, resize_linear
from .jpeg import jpeg_round_trip
from .raster import (distance_transforms_l2_3, fill_poly, gaussian_blur, get_rotation_matrix_2d,
                     polylines, warp_affine_linear)

# ---------------------------------------------------------------------------
# Fonts
# ---------------------------------------------------------------------------

GLYPHS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "assets", "glyphs", "hard_tier.npz")
_TTF_FILES = (
    "DejaVuSans.ttf",
    "DejaVuSans-Bold.ttf",
    "DejaVuSerif.ttf",
    "DejaVuSerif-Bold.ttf",
    "DejaVuSansMono.ttf",
    "DejaVuSansMono-Bold.ttf",
)
# Hershey faces with genuinely distinct glyph shapes (cv2 vector fonts).
_HERSHEY_FACES = ("SIMPLEX", "DUPLEX", "TRIPLEX", "COMPLEX", "SCRIPT_SIMPLEX")


def available_fonts() -> List[Tuple[str, str]]:
    """-> [('ttf', file name) | ('hershey', face_name)]: the six DejaVu
    faces, then the Hershey faces, on every machine (the JAX package lists
    the DejaVu files that exist; the lists agree where all six do)."""
    fonts: List[Tuple[str, str]] = [("ttf", n) for n in _TTF_FILES]
    fonts.extend(("hershey", f) for f in _HERSHEY_FACES)
    return fonts


def font_label(font: Tuple[str, str]) -> str:
    kind, ident = font
    return os.path.basename(ident).replace(".ttf", "") if kind == "ttf" else f"hershey_{ident}"


_CHAR_CACHE: Dict = {}


@functools.lru_cache(maxsize=1)
def _glyph_table() -> Dict:
    if not os.path.exists(GLYPHS):
        raise FileNotFoundError(f"{GLYPHS}: the hard tier's glyph table is missing (written by "
                                "scripts/make_port_hard_assets.py)")
    with np.load(GLYPHS) as z:
        t = {k: z[k] for k in z.files}
    t["font"] = {str(f): i for i, f in enumerate(t["fonts"])}
    t["height"] = {int(h): i for i, h in enumerate(t["heights"])}
    t["char"] = {chr(int(c)): i for i, c in enumerate(t["chars"])}
    return t


def _char_mask(font: Tuple[str, str], height_px: int, ch: str):
    """-> (mask uint8 [h,w], baseline_row, advance_px), replayed from the
    glyph table. Cached.

    The mask patch has the glyph drawn with its baseline at ``baseline_row``
    and its origin (pen position) at x=0; ``advance`` is the pen advance.
    """
    key = (font, height_px, ch)
    if key in _CHAR_CACHE:
        return _CHAR_CACHE[key]
    t = _glyph_table()
    label = font_label(font)
    try:
        i = (t["font"][label], t["height"][int(height_px)], t["char"][ch])
    except KeyError:
        raise KeyError(f"the hard tier's glyph table holds no mask of font {label!r} at height "
                       f"{height_px} for character {ch!r} ({GLYPHS}: heights "
                       f"{int(t['heights'][0])}-{int(t['heights'][-1])}, characters "
                       f"{''.join(t['char'])!r})") from None
    rows, cols = (int(v) for v in t["shape"][i])
    start = int(t["start"][i])
    mask = t["coverage"][start:start + rows * cols].reshape(rows, cols).copy()
    out = (mask, int(t["baseline"][i]), int(t["advance"][i]))
    _CHAR_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Word rendering: per-character placement along a (possibly curved) baseline
# ---------------------------------------------------------------------------


def render_word(
    rng: np.random.Generator,
    text: str,
    font: Tuple[str, str],
    height_px: int,
    curve: float = 0.0,
    spacing_jitter: float = 0.0,
) -> Dict:
    """Render ``text`` -> {'mask' float32 [h,w] in [0,1], 'top', 'bot'}.

    ``curve`` is the sine-arc amplitude as a fraction of text height
    (signed: positive bulges up). Characters are placed at their arc
    position and ROTATED to the local tangent (CUTE80-style bends), not
    sheared. 'top'/'bot' are (n+1, 2) float32 point chains (one rung per
    character boundary) tracing the text band; for straight words they
    collapse to 2 points each (a quad).
    """
    chars = [c for c in text]
    masks, bases, advs = [], [], []
    for c in chars:
        if c == " ":
            m, b, a = _char_mask(font, height_px, "x")
            masks.append(np.zeros_like(m)); bases.append(b); advs.append(a)
        else:
            m, b, a = _char_mask(font, height_px, c)
            masks.append(m); bases.append(b); advs.append(a)
    if spacing_jitter > 0:
        advs = [
            max(1, int(round(a * (1.0 + rng.uniform(-spacing_jitter, spacing_jitter)))))
            for a in advs
        ]
    bounds = np.concatenate([[0], np.cumsum(advs)]).astype(np.float64)
    L = float(bounds[-1])
    A = curve * height_px

    def y_of(s):
        return -A * np.sin(np.pi * s / max(L, 1e-6))

    def slope_of(s):
        return -A * (np.pi / max(L, 1e-6)) * np.cos(np.pi * s / max(L, 1e-6))

    # canvas big enough for the arc + rotated glyph diagonals
    max_gh = max(m.shape[0] for m in masks)
    max_gw = max(max(m.shape[1] for m in masks), max(advs))
    diag = int(np.ceil(np.hypot(max_gh, max_gw)))
    pad = diag // 2 + 4
    H = int(2 * pad + abs(A) + max_gh)
    W = int(L) + 2 * pad
    canvas = np.zeros((H, W), np.float32)
    y_base = pad + max(0.0, A) + max(bases)  # baseline row at arc midpoint 0

    above = below = 1.0
    for i, (m, b, a) in enumerate(zip(masks, bases, advs)):
        s_c = (bounds[i] + bounds[i + 1]) / 2.0
        ang = np.degrees(np.arctan(slope_of(s_c)))
        gh, gw = m.shape
        # glyph pivot: pen-center on the baseline
        pivot = (a / 2.0, float(b))
        side = int(np.ceil(np.hypot(gh, gw))) + 4
        patch = np.zeros((side, side), np.uint8)
        ox, oy = (side - gw) // 2, (side - gh) // 2
        patch[oy : oy + gh, ox : ox + gw] = m
        pc = (ox + pivot[0], oy + pivot[1])
        if abs(ang) > 0.1:
            M = get_rotation_matrix_2d(pc, ang, 1.0)
            patch = warp_affine_linear(patch, M, (side, side))
        # paste so the pivot lands on the arc point
        px = pad + s_c  # pen center at s_c
        py = y_base + y_of(s_c)
        x0 = int(round(px - pc[0]))
        y0 = int(round(py - pc[1]))
        x1, y1 = x0 + side, y0 + side
        cx0, cy0 = max(0, -x0), max(0, -y0)
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(W, x1), min(H, y1)
        if x1 > x0 and y1 > y0:
            region = canvas[y0:y1, x0:x1]
            np.maximum(
                region, patch[cy0 : cy0 + y1 - y0, cx0 : cx0 + x1 - x0], out=region
            )
        ys, xs = np.nonzero(m)
        if len(ys):
            above = max(above, float(b - ys.min()))
            below = max(below, float(ys.max() - b))

    # chains: one rung per char boundary along the arc
    n_pts = len(bounds) if curve != 0.0 else 2
    ss = bounds if curve != 0.0 else np.array([0.0, L])
    top_pts, bot_pts = [], []
    # curvature slack: the rung normal (at the char boundary) and the glyph
    # rotation (at the char center) differ by the local curvature, so rotated
    # glyph corners poke past an ascent-tight band on strong arcs
    slack = 2.0 + 0.22 * abs(A)
    a_use, b_use = above + slack, below + slack
    for s in ss:
        g = slope_of(s)
        nrm = np.array([-g, 1.0]) / np.hypot(g, 1.0)  # points down (img y down)
        p = np.array([pad + s, y_base + y_of(s)])
        top_pts.append(p - nrm * a_use)
        bot_pts.append(p + nrm * b_use)
    top = np.array(top_pts, np.float32)
    bot = np.array(bot_pts, np.float32)
    # longitudinal end slack: the end glyphs rotate about their centers, so
    # their outer corners overhang the pen-extent rungs on sloped ends
    for idx, s_end in ((0, ss[0]), (-1, ss[-1])):
        g = slope_of(s_end)
        tan = np.array([1.0, g]) / np.hypot(g, 1.0)
        ext = (1.0 if idx == 0 else -1.0) * -(2.0 + abs(g) * (above + below) * 0.6)
        top[idx] += (tan * ext).astype(np.float32)
        bot[idx] += (tan * ext).astype(np.float32)

    # tight crop
    ys, xs = np.nonzero(canvas > 8)
    if len(ys) == 0:
        return {"mask": np.zeros((4, 4), np.float32), "top": top[:2] * 0, "bot": bot[:2] * 0}
    m_y0, m_y1 = int(ys.min()), int(ys.max()) + 1
    m_x0, m_x1 = int(xs.min()), int(xs.max()) + 1
    # include the chain band (chains may exceed ink extents slightly)
    all_pts = np.concatenate([top, bot])
    m_x0 = min(m_x0, int(np.floor(all_pts[:, 0].min())))
    m_x1 = max(m_x1, int(np.ceil(all_pts[:, 0].max())) + 1)
    m_y0 = min(m_y0, int(np.floor(all_pts[:, 1].min())))
    m_y1 = max(m_y1, int(np.ceil(all_pts[:, 1].max())) + 1)
    m_x0, m_y0 = max(0, m_x0), max(0, m_y0)
    m_x1, m_y1 = min(W, m_x1), min(H, m_y1)
    off = np.array([m_x0, m_y0], np.float32)
    return {
        "mask": canvas[m_y0:m_y1, m_x0:m_x1] / 255.0,
        "top": top - off,
        "bot": bot - off,
    }


def chains_to_polygon(top: np.ndarray, bot: np.ndarray) -> np.ndarray:
    """(n,2)+(n,2) chains -> closed polygon: top left->right, bottom right->left."""
    return np.concatenate([top, bot[::-1]], axis=0).astype(np.float32)


def shrink_chains(
    top: np.ndarray, bot: np.ndarray, d: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Inset each chain point toward its rung partner by ``d`` px, and pull
    the end rungs inward along the chain by ``d`` — the curved-polygon
    analog of the DB shrink (exact for the chain representation; the
    convex edge-offset would self-intersect on a banana polygon).
    Negative ``d`` dilates."""
    top = np.asarray(top, np.float64).copy()
    bot = np.asarray(bot, np.float64).copy()
    rung = bot - top
    rl = np.maximum(np.linalg.norm(rung, axis=1, keepdims=True), 1e-6)
    # cap so shrunk band keeps >=20% of its height (never inverts)
    dd = np.minimum(d, 0.4 * rl[:, 0])[:, None] if d > 0 else np.full_like(rl, d)
    u = rung / rl
    t2, b2 = top + u * dd, bot - u * dd
    if len(top) >= 2:
        for pts in (t2, b2):
            e0 = pts[1] - pts[0]
            e1 = pts[-2] - pts[-1]
            for p, e in ((0, e0), (-1, e1)):
                n = np.linalg.norm(e)
                if n > 1e-6:
                    delta = min(d, 0.4 * n) if d > 0 else d
                    pts[p] += e / n * delta
    return t2.astype(np.float32), b2.astype(np.float32)


def chain_seg_maps(
    words: Sequence[Dict],
    hw: Tuple[int, int],
    shrink_ratio: float = 0.4,
    min_text_size: int = 4,
    thresh_min: float = 0.3,
    thresh_max: float = 0.7,
) -> Dict[str, np.ndarray]:
    """Chain-polygon GT: {gt, mask, thresh_map, thresh_mask} in one pass.

    Same semantics as processes.make_seg_maps + make_border_maps (reference
    MakeSegDetectionData / MakeBorderMap), but shrink/dilate move chain
    points along their rungs — robust for curved polygons. ``words`` is a
    list of {'top', 'bot', 'ignore'} in page coordinates."""
    from .processes import polygon_area_signed, polygon_perimeter

    H, W = hw
    gt = np.zeros((H, W), np.float32)
    mask = np.ones((H, W), np.float32)
    canvas = np.zeros((H, W), np.float32)
    tmask = np.zeros((H, W), np.float32)
    windows = []  # the border maps' windows, their distance transforms run together
    for wd in words:
        top, bot = wd["top"], wd["bot"]
        poly = chains_to_polygon(top, bot)
        h = poly[:, 1].max() - poly[:, 1].min()
        w = poly[:, 0].max() - poly[:, 0].min()
        if wd.get("ignore") or min(h, w) < min_text_size:
            fill_poly(mask, poly.astype(np.int32), 0.0)
            continue
        A = abs(polygon_area_signed(np.asarray(poly, np.float64)))
        P = polygon_perimeter(np.asarray(poly, np.float64))
        d = A * (1.0 - shrink_ratio**2) / max(P, 1e-6)
        st, sb = shrink_chains(top, bot, d)
        fill_poly(gt, chains_to_polygon(st, sb).astype(np.int32), 1.0)

        dt, db = shrink_chains(top, bot, -d)
        dil = chains_to_polygon(dt, db)
        x0 = max(0, int(np.floor(dil[:, 0].min())) - 1)
        y0 = max(0, int(np.floor(dil[:, 1].min())) - 1)
        x1 = min(W, int(np.ceil(dil[:, 0].max())) + 2)
        y1 = min(H, int(np.ceil(dil[:, 1].max())) + 2)
        if x1 <= x0 or y1 <= y0:
            continue
        off = np.array([x0, y0], np.float32)
        band = np.zeros((y1 - y0, x1 - x0), np.uint8)
        fill_poly(band, (dil - off).astype(np.int32), 1)
        border = np.zeros_like(band)
        polylines(border, (poly - off).astype(np.int32), True, 1, thickness=1)
        windows.append((x0, y0, x1, y1, d, band, (1 - border).astype(np.uint8)))
    dists = distance_transforms_l2_3([w[-1] for w in windows])
    for (x0, y0, x1, y1, d, band, _), dist in zip(windows, dists):
        falloff = np.clip(1.0 - dist / max(d, 1e-6), 0.0, 1.0)
        canvas[y0:y1, x0:x1] = np.maximum(canvas[y0:y1, x0:x1], falloff * band)
        tmask[y0:y1, x0:x1] = np.maximum(tmask[y0:y1, x0:x1], band.astype(np.float32))
    return {
        "gt": gt,
        "mask": mask,
        "thresh_map": (canvas * (thresh_max - thresh_min) + thresh_min).astype(
            np.float32
        ),
        "thresh_mask": tmask,
    }


# ---------------------------------------------------------------------------
# Backgrounds, colors, degradations
# ---------------------------------------------------------------------------


def make_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """uint8 (h, w, 3): flat / noise / low-freq texture / gradient."""
    kind = rng.integers(4)
    base = np.array([rng.integers(0, 256)] * 3, np.float32) + rng.uniform(-18, 18, 3)
    if kind == 0:  # flat
        img = np.ones((h, w, 3), np.float32) * base
    elif kind == 1:  # per-pixel noise around base
        img = base + rng.normal(0, rng.uniform(4, 22), (h, w, 3))
    elif kind == 2:  # low-frequency texture (upsampled coarse noise)
        gh, gw = max(2, h // int(rng.integers(16, 64))), max(2, w // int(rng.integers(16, 64)))
        coarse = rng.uniform(-1, 1, (gh, gw, 3)).astype(np.float32)
        tex = resize_cubic(coarse, (w, h))
        img = base + tex * rng.uniform(10, 45)
    else:  # linear gradient
        ang = rng.uniform(0, 2 * np.pi)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        g = (np.cos(ang) * xx / max(w, 1) + np.sin(ang) * yy / max(h, 1))
        img = base + g[..., None] * rng.uniform(-70, 70)
    return np.clip(img, 0, 255).astype(np.uint8)


def pick_fg_color(
    rng: np.random.Generator, bg_mean: float, polarity: str = "both",
    min_contrast: float = 45.0, max_contrast: float = 170.0,
) -> Tuple[np.ndarray, str]:
    """Text color with sampled contrast against ``bg_mean`` luminance."""
    c = float(rng.uniform(min_contrast, max_contrast))
    if polarity == "both":
        # prefer the direction with headroom; random when both fit
        up_ok, dn_ok = bg_mean + c <= 255, bg_mean - c >= 0
        go_up = up_ok and (not dn_ok or rng.random() < 0.5)
    else:
        # forced polarity: cap the contrast to the available headroom but
        # never below min_contrast — otherwise a dark bg forces invisible
        # dark text and the polarity slice measures clipping, not polarity
        go_up = polarity == "light"
        headroom = (255.0 - bg_mean) if go_up else bg_mean
        c = max(min(c, headroom), min_contrast)
    lum = np.clip(bg_mean + (c if go_up else -c), 0, 255)
    col = np.clip(lum + rng.uniform(-20, 20, 3), 0, 255).astype(np.float32)
    return col, ("light" if go_up else "dark")


def composite_text(
    img: np.ndarray, mask: np.ndarray, color: np.ndarray, x: int, y: int
) -> None:
    """Alpha-composite a word mask onto img (uint8, in place) at (x, y)."""
    h, w = mask.shape
    H, W = img.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    m = mask[y0 - y : y1 - y, x0 - x : x1 - x, None]
    region = img[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] = np.clip(
        region * (1 - m) + color[None, None, :] * m, 0, 255
    ).astype(np.uint8)


def degrade_image(
    rng: np.random.Generator, img: np.ndarray, strength: float = 1.0
) -> Tuple[np.ndarray, Dict]:
    """blur -> low-res -> noise -> jpeg -> contrast/brightness. Returns
    (uint8 image, applied-condition tags). ``strength`` scales probability
    and magnitude; 0 disables everything."""
    meta: Dict = {"blur": 0.0, "lowres": 1.0, "noise": 0.0, "jpeg": 100}
    if strength <= 0:
        return img, meta
    h, w = img.shape[:2]
    if rng.random() < 0.65 * strength:
        sigma = float(rng.uniform(0.4, 1.4) * strength)
        k = max(3, int(sigma * 4) | 1)
        img = gaussian_blur(img, k, sigma)
        meta["blur"] = round(sigma, 2)
    if rng.random() < 0.45 * strength:
        f = float(rng.uniform(0.4, 0.85))
        small = resize_area(img, (max(4, int(w * f)), max(4, int(h * f))))
        img = resize_linear(small, (w, h))
        meta["lowres"] = round(f, 2)
    if rng.random() < 0.6 * strength:
        sigma = float(rng.uniform(3, 14) * strength)
        img = np.clip(
            img.astype(np.float32) + rng.normal(0, sigma, img.shape), 0, 255
        ).astype(np.uint8)
        meta["noise"] = round(sigma, 1)
    if rng.random() < 0.5 * strength:
        q = int(rng.integers(25, 80))
        img = jpeg_round_trip(img, q)
        meta["jpeg"] = q
    a = float(rng.uniform(0.82, 1.18))
    b = float(rng.uniform(-18, 18))
    img = np.clip(img.astype(np.float32) * a + b, 0, 255).astype(np.uint8)
    return img, meta


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

_WORDS_HARD = (
    "the and for are but not you all can had her was one our out day get has "
    "him his how man new now old see two way who boy did its let put say she "
    "too use that with have this will your from they know want been good much "
    "some time very when come here just like long make many more only over "
    "such take than them well were what work year back call came each even "
    "find give hand high keep last left life live look made most move must "
    "name need next open part play right said same seem show side tell turn "
    "water where which world would write about after again below could every "
    "first found great house large learn never other place plant point small "
    "sound spell still study their there these thing think three under until "
    "street coffee market system change public school number people little "
    "exit stop open sale free park shop food bank hotel pizza taxi metro "
    "airport station center museum library garden bridge tower square north "
    "south east west 2026 1999 404 42 747 360 100 50 25"
).split()


def sample_text(
    rng: np.random.Generator,
    alphabet: str = "abcdefghijklmnopqrstuvwxyz0123456789",
    max_len: int = 10,
) -> str:
    """50% dictionary word, 50% random string — defeats lexicon memorization."""
    if rng.random() < 0.5:
        return _WORDS_HARD[int(rng.integers(len(_WORDS_HARD)))][:max_len]
    n = int(rng.integers(2, max_len + 1))
    return "".join(alphabet[int(rng.integers(len(alphabet)))] for _ in range(n))


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _resolve_fonts(fonts) -> List[Tuple[str, str]]:
    all_fonts = available_fonts()
    if fonts == "all":
        return all_fonts
    if fonts == "ttf":
        return [f for f in all_fonts if f[0] == "ttf"] or all_fonts
    if fonts == "hershey":
        return [f for f in all_fonts if f[0] == "hershey"]
    if isinstance(fonts, (list, tuple)):
        return [all_fonts[i % len(all_fonts)] for i in fonts]
    raise ValueError(f"fonts={fonts!r}")


class HardSyntheticRecognitionDataset:
    """Word crops from the hard tier. Same item schema as
    SyntheticRecognitionDataset ({image, size, text}) plus ``meta``
    condition tags (dropped by the collate, read by per-condition evals).

    Difficulty knobs are independent so A/Bs can isolate conditions:
    ``curve_prob``/``curve_range`` (fraction of text height),
    ``degrade`` (strength, 0 disables), ``min_contrast``, ``distractors``.
    """

    def __init__(
        self,
        n: int = 1024,
        canvas_hw: Tuple[int, int] = (64, 256),
        charset: Optional[Charset] = None,
        seed: int = 0,
        fonts="all",
        curve_prob: float = 0.35,
        curve_range: Tuple[float, float] = (0.25, 0.8),
        min_height: int = 12,
        max_height: int = 44,
        degrade: float = 1.0,
        min_contrast: float = 45.0,
        polarity: str = "both",
        distractors: bool = True,
        max_len: int = 10,
    ):
        self.n = n
        self.canvas_hw = canvas_hw
        self.charset = charset or Charset()
        self.seed = seed
        self.fonts = _resolve_fonts(fonts)
        self.curve_prob = curve_prob
        self.curve_range = curve_range
        self.min_height = min_height
        self.max_height = max_height
        self.degrade = degrade
        self.min_contrast = min_contrast
        self.polarity = polarity
        self.distractors = distractors
        self.max_len = max_len

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.default_rng(self.seed * 2_000_003 + i)
        text = sample_text(rng, self.charset.alphabet.replace(" ", ""), self.max_len)
        font = self.fonts[int(rng.integers(len(self.fonts)))]
        height = int(rng.integers(self.min_height, self.max_height + 1))
        curve = 0.0
        if rng.random() < self.curve_prob:
            curve = float(rng.uniform(*self.curve_range)) * (
                1 if rng.random() < 0.5 else -1
            )
        w = render_word(rng, text, font, height, curve=curve,
                        spacing_jitter=0.08)
        mask = w["mask"]
        mh, mw = mask.shape

        ml, mt, mr, mb = (int(rng.integers(2, 9)) for _ in range(4))
        h, wd = mh + mt + mb, mw + ml + mr
        img = make_background(rng, h, wd)
        bg_mean = float(img.mean())
        color, pol = pick_fg_color(
            rng, bg_mean, self.polarity, self.min_contrast
        )
        composite_text(img, mask, color, ml, mt)

        if self.distractors and rng.random() < 0.5:
            # neighbor-word fragment hanging off an edge (what detector
            # crops contain), or an underline
            if rng.random() < 0.7:
                fch = sample_text(rng, self.charset.alphabet.replace(" ", ""), 2)
                fm, _, _ = _char_mask(font, height, fch[0])
                side_left = rng.random() < 0.5
                fx = -int(fm.shape[1] * rng.uniform(0.4, 0.8)) if side_left else (
                    wd - int(fm.shape[1] * rng.uniform(0.2, 0.6))
                )
                composite_text(img, fm.astype(np.float32) / 255.0, color, fx, mt)
            else:
                yline = mt + mh - max(1, mb // 2)
                # cv2.line: an open polyline of one segment
                polylines(img, np.array([[0, yline], [wd, yline]]), False,
                          tuple(int(v) for v in color), max(1, height // 12))

        img, dmeta = degrade_image(rng, img, self.degrade)

        H, W = self.canvas_hw
        h, wd = img.shape[:2]
        if h > H or wd > W:
            s = min(H / h, W / wd)
            img = resize_linear(img, (max(1, int(wd * s)), max(1, int(h * s))))
            h, wd = img.shape[:2]
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[:h, :wd] = img
        return {
            "image": canvas,
            "size": np.array([h, wd], np.int32),
            "text": text,
            "meta": {
                "font": font_label(font),
                "polarity": pol,
                "curve": round(abs(curve), 2),
                "height": height,
                **dmeta,
            },
        }


class HardSyntheticDetectionDataset:
    """Pages from the hard tier: multi-font, dual-polarity words (optionally
    rotated and/or curved) on textured backgrounds with page-level
    degradation. Polygons are 4-pt quads for straight words and 2(n+1)-pt
    chain polygons for curved words; GT maps come from chain_seg_maps.
    Item schema matches SyntheticDetectionDataset.
    """

    def __init__(
        self,
        n: int = 64,
        hw: Tuple[int, int] = (640, 640),
        seed: int = 0,
        shrink_ratio: float = 0.4,
        gt_maps: bool = True,
        fonts="all",
        curve_prob: float = 0.3,
        curve_range: Tuple[float, float] = (0.25, 0.7),
        max_rotate: float = 20.0,
        min_height: int = 14,
        max_height: int = 48,
        degrade: float = 0.6,
        min_contrast: float = 55.0,
        polarity: str = "both",
        words_range: Tuple[int, int] = (3, 9),
        max_len: int = 10,
        charset: Optional[Charset] = None,
    ):
        self.n = n
        self.hw = hw
        self.seed = seed
        self.shrink_ratio = shrink_ratio
        self.gt_maps = gt_maps
        self.fonts = _resolve_fonts(fonts)
        self.curve_prob = curve_prob
        self.curve_range = curve_range
        self.max_rotate = max_rotate
        self.min_height = min_height
        self.max_height = max_height
        self.degrade = degrade
        self.min_contrast = min_contrast
        self.polarity = polarity
        self.words_range = words_range
        self.max_len = max_len
        self.charset = charset or Charset()

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict:
        rng = np.random.default_rng(self.seed * 3_000_017 + i)
        H, W = self.hw
        img = make_background(rng, H, W)
        words: List[Dict] = []
        polys: List[np.ndarray] = []
        texts: List[str] = []
        metas: List[Dict] = []
        n_words = int(rng.integers(self.words_range[0], self.words_range[1] + 1))
        for _ in range(n_words):
            text = sample_text(rng, self.charset.alphabet.replace(" ", ""), self.max_len)
            font = self.fonts[int(rng.integers(len(self.fonts)))]
            height = int(rng.integers(self.min_height, self.max_height + 1))
            curve = 0.0
            if rng.random() < self.curve_prob:
                curve = float(rng.uniform(*self.curve_range)) * (
                    1 if rng.random() < 0.5 else -1
                )
            wrd = render_word(rng, text, font, height, curve=curve)
            mask, top, bot = wrd["mask"], wrd["top"], wrd["bot"]
            if self.max_rotate > 0:
                ang = float(rng.uniform(-self.max_rotate, self.max_rotate))
                mask, top, bot = _rotate_word(mask, top, bot, ang)
            mh, mw = mask.shape
            if mh >= H - 12 or mw >= W - 12:
                continue
            placed = False
            for _try in range(4):
                px = int(rng.integers(6, W - mw - 6))
                py = int(rng.integers(6, H - mh - 6))
                off = np.array([px, py], np.float32)
                poly = chains_to_polygon(top + off, bot + off)
                if not any(_bbox_overlap(poly, q) for q in polys):
                    placed = True
                    break
            if not placed:
                continue
            region = img[py : py + mh, px : px + mw]
            bg_mean = float(region.mean())
            color, pol = pick_fg_color(rng, bg_mean, self.polarity, self.min_contrast)
            composite_text(img, mask, color, px, py)
            words.append({"top": top + off, "bot": bot + off, "ignore": False})
            polys.append(poly)
            texts.append(text)
            metas.append({"font": font_label(font), "polarity": pol,
                          "curve": round(abs(curve), 2), "height": height})

        img, dmeta = degrade_image(rng, img, self.degrade)
        out = {
            "image": img,
            "polygons": polys,
            "ignore": [False] * len(polys),
            "texts": texts,
            "scale": np.array([1.0, 1.0], np.float32),
            "filename": f"hard_{i}",
            "meta": {"words": metas, **dmeta},
        }
        if self.gt_maps:
            out.update(chain_seg_maps(words, (H, W), self.shrink_ratio))
        return out


def _rotate_word(mask: np.ndarray, top: np.ndarray, bot: np.ndarray, deg: float):
    """Rigidly rotate a word mask + chains, re-tight-cropped."""
    h, w = mask.shape
    c = (w / 2.0, h / 2.0)
    M = get_rotation_matrix_2d(c, deg, 1.0)
    pts = np.concatenate([top, bot])
    ones = np.ones((len(pts), 1), np.float32)
    rp = np.concatenate([pts, ones], axis=1) @ M.T.astype(np.float32)
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    rc = np.concatenate([corners, np.ones((4, 1), np.float32)], axis=1) @ M.T.astype(
        np.float32
    )
    allp = np.concatenate([rp, rc])
    x0, y0 = allp.min(axis=0) - 1
    M[:, 2] -= [x0, y0]
    allp2 = np.concatenate([pts, ones], axis=1) @ M.T.astype(np.float32)
    bw = int(np.ceil(allp[:, 0].max() - x0)) + 2
    bh = int(np.ceil(allp[:, 1].max() - y0)) + 2
    rot = warp_affine_linear(mask, M, (bw, bh))
    n = len(top)
    return rot, allp2[:n], allp2[n:]


def _bbox_overlap(a: np.ndarray, b: np.ndarray) -> bool:
    ax0, ay0, ax1, ay1 = a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max()
    bx0, by0, bx1, by1 = b[:, 0].min(), b[:, 1].min(), b[:, 0].max(), b[:, 1].max()
    return not (ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0)
