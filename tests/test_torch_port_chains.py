"""Curved-text serving against the JAX package, on the CPU: ``ops/chains.py``,
the ruled-surface warp ``rectify_quads_mxu(warp='bilinear')``,
``detect_polygons_device`` and ``SegDetectorRepresenter(mode='poly')``,
``evaluate_detection`` and ``cli.eval`` with ``--representer poly``, and the
measurers' numpy ``fill_poly`` against ``cv2.fillPoly``.

Pages are sine bands (``tests/test_chains.py``'s shape: constant-thickness
bands along half a sine period), several a page, one page with a component
on pixel 0 (the component that the slots without a region share).

Tolerances, and why:

* Slots: ``valid``, the slot order (the roots) and ``band_alive`` equal.
* Chains from JAX's own statistics: points, half-heights, polygons and band
  quads within 1e-3 px, unit vectors within 1e-4 (float32 arithmetic in
  another order: measured 1.2e-4 px on points).
* Chains from each package's own statistics (``extract_regions`` rounds
  float64 sums once where JAX sums in float32, so centres, angles and
  extents differ by an ulp or so): such an ulp can move a pixel on a band's
  boundary into the next band, which moves that band's v range, its centre
  and half-height by a fraction of a pixel. Points and half-heights within
  0.1 px, polygons within 0.2 px (measured up to 0.017 and 0.031 on these
  pages).
* The warp on smooth pages: 1e-3 on 0-255 pixels, as
  ``test_torch_port_image.py`` (the sample coordinates may differ by an ulp).
* ``fill_poly`` (``data/raster.py``, which the measurers import): equal to
  ``cv2.fillPoly`` pixel for pixel; the measurers'
  areas and ratios on chain polygons equal to the JAX package's (rtol
  1e-12: the same float64 arithmetic on the same pixels).
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.data import SyntheticDetectionDataset as JaxSyntheticDetectionDataset
from megreader_tpu.evaluation import evaluate_detection as jax_evaluate_detection
from megreader_tpu.experiment import Experiment as JaxExperiment
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.ops import ccl as jax_ccl
from megreader_tpu.ops import chains as jax_chains
from megreader_tpu.ops import image as jax_image
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.postproc import detection as jax_detection
from megreader_tpu.postproc import measurers as jax_measurers
from megreader_tpu_torch.cli import eval as cli_eval
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.data import raster
from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
from megreader_tpu_torch.evaluation import evaluate, evaluate_detection
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.ops import chains, image
from megreader_tpu_torch.ops.ccl import (
    _candidate_roots,
    _candidates,
    _top_k_slots,
    connected_components,
    extract_regions,
)
from megreader_tpu_torch.ops.extract import pallas_k2
from megreader_tpu_torch.postproc import detection, measurers
from megreader_tpu_torch.train.checkpoint import CheckpointManager
from megreader_tpu_torch.train.train_step import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_SAME_STATS = 1e-3
ATOL_OWN_STATS = 0.1
ATOL_POLY_OWN_STATS = 0.2
ATOL_PX = 1e-3
CHAIN_KEYS = ("points", "tangent", "normal", "half_h")


def _sine_band(mask, x0, x1, amp, half_h, cy):
    """``tests/test_chains.py::sine_band_mask``'s band, drawn into ``mask``."""
    xs = np.arange(x0, x1)
    centres = cy + amp * np.sin((xs - x0) / (x1 - x0) * np.pi)
    for x, c in zip(xs, centres):
        mask[int(round(c - half_h)):int(round(c + half_h)) + 1, x] = True


def _band_pages(seed, B=3, H=96, W=192, bands=4):
    """Sine bands of random arcs, thicknesses and heights; page 1 also has a
    blob on pixel 0."""
    rng = np.random.default_rng(seed)
    m = np.zeros((B, H, W), bool)
    for b in range(B):
        for _ in range(bands):
            _sine_band(m[b], int(rng.integers(0, 60)), int(rng.integers(100, W)),
                       float(rng.uniform(-14, 14)), int(rng.integers(2, 8)),
                       int(rng.integers(20, H - 20)))
    m[1, 0:5, 0:30] = True
    return m


def _jax_chains(mask, K, S=8):
    jl = jax_ccl.connected_components(jnp.asarray(mask), max_iters=64)
    js = jax_ccl.extract_regions(jl, jnp.asarray(mask, jnp.float32), max_regions=K)
    return np.asarray(jl), jax.device_get(js), jax.device_get(
        jax_chains.extract_chains(jl, js, n_bands=S))


def _assert_chains_close(got, ref, atol, atol_unit):
    np.testing.assert_array_equal(got["band_alive"].numpy(), ref["band_alive"])
    for k in CHAIN_KEYS:
        tol = atol_unit if k in ("tangent", "normal") else atol
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("seed,K,S", [(0, 4, 8), (1, 8, 8), (2, 8, 4), (3, 6, 2), (4, 8, 1)])
def test_extract_chains_matches_jax(seed, K, S):
    """Every row, empty slots included (their chains run over the pixels
    labelled 0, with their own statistics): from JAX's statistics, and from
    the port's own."""
    mask = _band_pages(seed)
    jl, js, ref = _jax_chains(mask, K, S)
    labels = connected_components(torch.from_numpy(mask), max_iters=64)
    np.testing.assert_array_equal(labels.numpy(), jl)
    same = chains.extract_chains(labels, {k: torch.from_numpy(np.array(v))
                                          for k, v in js.items()}, n_bands=S)
    _assert_chains_close(same, ref, ATOL_SAME_STATS, 1e-4)
    stats = extract_regions(labels, torch.from_numpy(mask).float(), max_regions=K)
    np.testing.assert_array_equal(stats["valid"].numpy(), js["valid"])
    _, want_roots, _ = jax.vmap(lambda l: jax_ccl._candidate_roots_single(l, K))(
        jnp.asarray(jl))
    np.testing.assert_array_equal(chains.chain_roots(labels, K).numpy(), np.asarray(want_roots))
    own = chains.extract_chains(labels, stats, n_bands=S)
    _assert_chains_close(own, ref, ATOL_OWN_STATS, 0.05)
    assert ref["band_alive"][:, 0].any(-1).all()  # the pages have live chains
    assert ref["band_alive"][1].any()  # and the page with a pixel-0 component


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_full"])
def test_chain_rows_follow_every_extract_impl(impl):
    """Row k of the chains is row k of the statistics: the roots come from
    the candidate count of the statistics' own path (``'pallas_full'``: K2
    rounded up to 128, here 256 against 160 at K 20). Compared on the slots
    with a region: the paths centre the empty slots differently (ROADMAP
    Queue 3), so their chains differ too."""
    mask = _band_pages(5, bands=6)
    labels = connected_components(torch.from_numpy(mask), max_iters=64)
    K = 20
    stats = extract_regions(labels, torch.from_numpy(mask).float(), max_regions=K, impl=impl)
    ref = extract_regions(labels, torch.from_numpy(mask).float(), max_regions=K, impl="xla")
    np.testing.assert_array_equal(stats["valid"].numpy(), ref["valid"].numpy())
    got = chains.extract_chains(labels, stats, n_bands=8, extract_impl=impl)
    want = chains.extract_chains(labels, ref, n_bands=8)
    v = ref["valid"].numpy()
    assert v.sum() >= 6
    np.testing.assert_array_equal(got["band_alive"].numpy()[v], want["band_alive"].numpy()[v])
    for k in CHAIN_KEYS:
        np.testing.assert_allclose(got[k].numpy()[v], want[k].numpy()[v], rtol=0, atol=1e-3,
                                   err_msg=k)


def test_chain_roots_take_the_full_path_candidate_count():
    """More roots than max(8K, 128) in raster order: the 'pallas_full'
    candidates keep more of them (K2 256 against 160 at K 20), so their top-K
    can differ; the chains' roots follow each path."""
    mask = np.zeros((1, 64, 96), bool)
    mask[0, 1:16:3, 1::3] = True  # 5 x 32 = 160 single-pixel components
    mask[0, 20:23, 60:90] = True  # a large one, 161st in raster order
    labels = connected_components(torch.from_numpy(mask), max_iters=64)
    lbl = labels.reshape(1, -1).long()
    full = _top_k_slots(*_candidates(lbl, pallas_k2(20)), 20)[1]
    xla = _candidate_roots(lbl, 20)[1]
    assert not torch.equal(full, xla)
    assert torch.equal(chains.chain_roots(labels, 20, "pallas_full"), full)
    assert torch.equal(chains.chain_roots(labels, 20, "xla"), xla)
    assert torch.equal(chains.chain_roots(labels, 20, "pallas"), xla)


@pytest.mark.parametrize("unclip", [False, True])
def test_chain_geometry_matches_jax(unclip):
    """Band quads, polygons, the resampled spine and the arc length, on JAX's
    chains (with the unclip's end extensions and uniform-arc resampling)."""
    mask = _band_pages(6)
    _, _, ref = _jax_chains(mask, 8)
    got = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    d = np.random.default_rng(2).uniform(0.5, 6.0, (3, 8)).astype(np.float32)
    jd, td = (jnp.asarray(d), torch.from_numpy(d)) if unclip else (None, None)
    for fn in ("chains_to_band_quads", "chains_to_polygons", "chain_arc_length"):
        want = np.asarray(getattr(jax_chains, fn)(ref, jd))
        have = getattr(chains, fn)(got, td).numpy()
        assert have.shape == want.shape, fn
        np.testing.assert_allclose(have, want, rtol=0, atol=ATOL_SAME_STATS, err_msg=fn)
    pts, hh = np.array(ref["points"]), np.array(ref["half_h"])
    want = jax_chains._resample_polyline(jnp.asarray(pts), jnp.asarray(hh), 13)
    have = chains._resample_polyline(torch.from_numpy(pts), torch.from_numpy(hh), 13)
    for h, w in zip(have, want):
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=0, atol=ATOL_SAME_STATS)


def test_resample_width_matches_jax():
    """Targets below 2, inside and past the canvas."""
    rng = np.random.default_rng(4)
    crops = rng.uniform(0, 255, (2, 3, 16, 64, 3)).astype(np.float32)
    tw = np.array([[1.0, 17.0, 40.0], [64.0, 100.0, 33.5]], np.float32)
    want = np.asarray(jax_chains.resample_width(jnp.asarray(crops), jnp.asarray(tw), 48))
    have = chains.resample_width(torch.from_numpy(crops), torch.from_numpy(tw), 48).numpy()
    assert have.shape == (2, 3, 16, 48, 3)
    np.testing.assert_allclose(have, want, rtol=0, atol=1e-3)


def _smooth_pages(seed=0, shape=(2, 96, 192, 3)):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros(shape)
    for _ in range(4):
        f = rng.uniform(0.02, 0.1, (B, 1, 1, C, 2))
        ph = rng.uniform(0, 2 * np.pi, (B, 1, 1, C))
        out += np.sin(xx[None, ..., None] * f[..., 0] + yy[None, ..., None] * f[..., 1] + ph)
    return (127.5 + 127.5 * out / 4).astype(np.float32)


@pytest.mark.parametrize("chunk", [32, 5])
def test_rectify_bilinear_matches_jax(chunk):
    """Chain band quads (trapezoids on the arcs, some past the page) through
    the ruled-surface warp on smooth pages; at ``chunk`` 5 the JAX function
    pads its last chunk with unit quads, the port runs it shorter."""
    _, _, ref = _jax_chains(_band_pages(7, B=2), 4)
    d = np.full((2, 4), 3.0, np.float32)
    bq = np.array(jax_chains.chains_to_band_quads(ref, jnp.asarray(d))).reshape(2, 32, 4, 2)
    bq[0, 3] += [150.0, 0.0]  # past the right edge
    pages = _smooth_pages()
    want = np.asarray(jax_image.rectify_quads_mxu(jnp.asarray(pages), jnp.asarray(bq), (32, 12),
                                                  crop_hw=(48, 64), chunk=chunk,
                                                  warp="bilinear"))
    have = image.rectify_quads_mxu(torch.from_numpy(pages), torch.from_numpy(bq), (32, 12),
                                   crop_hw=(48, 64), chunk=chunk, warp="bilinear").numpy()
    assert have.shape == (2, 32, 32, 12, 3)
    np.testing.assert_allclose(have, want, rtol=0, atol=ATOL_PX)


def test_bilinear_two_pass_guards_degenerate_quads():
    """A quad whose top edge is one point (du/dX = 0 on the top row), a
    point quad, and a quad with u exactly linear: the JAX guards
    ``where(|denom| < 1e-6, sign * 1e-6 + 1e-12, denom)`` and
    ``max(Ho - 1, 1)`` ported as they are (Ho 1 included)."""
    crops = _smooth_pages(3, (4, 24, 32, 3))
    q = np.array([[[5, 2], [5, 2], [20, 20], [3, 20]],
                  [[7, 7], [7, 7], [7, 7], [7, 7]],
                  [[0, 0], [31, 0], [31, 23], [0, 23]],
                  [[30, 1], [2, 3], [4, 22], [28, 20]]], np.float32)
    for out_hw in ((16, 20), (1, 20), (16, 1)):
        want = np.asarray(jax_image._bilinear_two_pass(jnp.asarray(crops), jnp.asarray(q),
                                                       out_hw))
        have = image._bilinear_two_pass(torch.from_numpy(crops), torch.from_numpy(q),
                                        out_hw).numpy()
        assert np.isfinite(have).all()
        np.testing.assert_allclose(have, want, rtol=0, atol=ATOL_PX, err_msg=str(out_hw))


def _disjoint_bands(seed, B=2, H=128, W=160):
    """Three sine bands a page that do not touch."""
    rng = np.random.default_rng(seed + 100)
    mask = np.zeros((B, H, W), bool)
    for b in range(B):
        for cy in (25, 65, 105):
            _sine_band(mask[b], int(rng.integers(0, 50)), int(rng.integers(100, W)),
                       float(rng.uniform(-10, 10)), int(rng.integers(2, 6)), cy)
    return mask


def _prob_maps(seed=0, B=2, H=128, W=160):
    """Prob maps of ``_disjoint_bands``: 0.95 on the bands, 0.05 elsewhere,
    plus noise of 0.02."""
    mask = _disjoint_bands(seed, B, H, W)
    rng = np.random.default_rng(seed + 200)
    return np.where(mask, 0.95, 0.05).astype(np.float32) + \
        rng.uniform(-0.02, 0.02, mask.shape).astype(np.float32)


def test_detect_polygons_matches_jax():
    prob = _prob_maps()
    kw = dict(bin_thresh=0.3, box_thresh=0.6, unclip_ratio=1.5, max_regions=8, ccl_iters=64,
              n_bands=8)
    ref = jax.device_get(jax_detection.detect_polygons_device(jnp.asarray(prob), **kw))
    got = detection.detect_polygons_device(torch.from_numpy(prob), **kw)
    valid = ref["valid"]
    assert valid.sum() >= 5
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert got["polygons"].shape == ref["polygons"].shape == (2, 8, 18, 2)
    np.testing.assert_allclose(got["polygons"].numpy()[valid], ref["polygons"][valid], rtol=0,
                               atol=ATOL_POLY_OWN_STATS)
    np.testing.assert_allclose(got["scores"].numpy()[valid], ref["scores"][valid], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n_bands", [8, 3])
def test_poly_representer_matches_jax(n_bands):
    prob = _prob_maps(1)
    scales = np.array([[2.0, 1.5], [0.5, 1.0]], np.float32)
    kw = dict(box_thresh=0.6, max_regions=8, mode="poly", n_bands=n_bands)
    ref = jax_detection.SegDetectorRepresenter(**kw).represent(jnp.asarray(prob), scales=scales)
    got = detection.SegDetectorRepresenter(**kw).represent(torch.from_numpy(prob), scales=scales)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["polygons"].dtype == np.float32
        assert g["polygons"].shape == r["polygons"].shape
        assert g["polygons"].shape[1] == 2 * (n_bands + 1) and len(g["polygons"]) >= 2
        np.testing.assert_allclose(g["polygons"], r["polygons"], rtol=0,
                                   atol=2 * ATOL_POLY_OWN_STATS)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown representer mode"):
        detection.SegDetectorRepresenter(mode="contour")


def _chain_polygons():
    """Chain polygons (non-convex arcs) of the sine pages, in pixels."""
    _, js, ref = _jax_chains(_disjoint_bands(8, B=3), 4)
    polys = np.asarray(jax_chains.chains_to_polygons(ref, jnp.full((3, 4), 2.0)))
    return [p for p, v in zip(polys.reshape(-1, 18, 2), js["valid"].reshape(-1)) if v]


def _simple_polygons(n, seed=0):
    """Star-shaped simple polygons of 3-19 vertices and random point sets
    (self-intersecting), integer vertices on canvases of 5-120 pixels."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        k = int(rng.integers(3, 20))
        H, W = int(rng.integers(5, 120)), int(rng.integers(5, 120))
        if t % 2:
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(0.2, 1.0, k)
            pts = np.stack([W / 2 + r * np.cos(ang) * (W / 2 - 1),
                            H / 2 + r * np.sin(ang) * (H / 2 - 1)], 1)
        else:
            pts = rng.uniform(0, 1, (k, 2)) * [W - 1, H - 1]
        out.append((np.round(pts).astype(np.int32), H, W))
    return out


def test_fill_poly_equals_cv2():
    """Every pixel, on 400 seeded polygons and on the chain polygons at the
    measurers' 4x raster scale; the lines alone too."""
    cases = _simple_polygons(400)
    for p in _chain_polygons():
        lo = np.floor(p.min(0)) - 1
        q = np.round((p - lo) * 4).astype(np.int32)
        cases.append((q, int(q[:, 1].max()) + 5, int(q[:, 0].max()) + 5))
    for pts, H, W in cases:
        want = np.zeros((H, W), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        have = measurers.fill_poly(np.zeros((H, W), np.uint8), pts)
        np.testing.assert_array_equal(have, want)
    rng = np.random.default_rng(1)
    for _ in range(300):
        x0, y0, x1, y1 = (int(v) for v in rng.integers(0, 50, 4))
        want = np.zeros((50, 50), np.uint8)
        cv2.line(want, (x0, y0), (x1, y1), 1)
        have = np.zeros_like(want)
        raster._line(have, (x0, y0), (x1, y1), 1)
        np.testing.assert_array_equal(have, want)
    # the measurers take the one copy of the fill, which clips as cv2 does
    assert measurers.fill_poly is raster.fill_poly
    pts = np.array([[0, 0], [4, 0], [0, 3]], np.int32)
    want = np.zeros((4, 4), np.uint8)
    cv2.fillPoly(want, [pts], 1)
    np.testing.assert_array_equal(measurers.fill_poly(np.zeros((4, 4), np.uint8), pts), want)


def test_measurers_score_chain_polygons_as_jax():
    """Non-convex chain polygons go to the raster route: areas, IoUs and
    overlaps equal to the JAX package's (cv2) on every pair, and a whole
    DetectionMeasurer / DetEvalMeasurer page."""
    polys = _chain_polygons()
    assert len(polys) >= 6 and not all(measurers.is_convex(p) for p in polys)
    shifted = [p + np.array([2.5, -1.0], np.float32) for p in polys]
    for a in polys:
        for b in polys[:4] + shifted[:4]:
            for fn in ("polygon_iou", "polygon_intersection_area",
                       "polygon_intersection_over_self"):
                np.testing.assert_allclose(getattr(measurers, fn)(a, b),
                                           getattr(jax_measurers, fn)(a, b), rtol=1e-12,
                                           atol=1e-12, err_msg=fn)
    for name in ("DetectionMeasurer", "DetEvalMeasurer"):
        m, jm = getattr(measurers, name)(), getattr(jax_measurers, name)()
        ign = [False] * (len(polys) - 1) + [True]
        got = m.measure_one(shifted, polys, ign)
        assert got == jm.measure_one(shifted, polys, ign)


DET = dict(fpn_dim=32, head_dim=16, width=16)


@pytest.fixture(scope="module")
def eval_pair():
    """A narrow random detector in both packages on 2 synthetic pages, and a
    binarization threshold that cuts its prob maps into blobs."""
    H = W = 128
    jmodel = JaxSegDetector(**DET)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 11)
    jexp = JaxExperiment(jmodel, eval_dataset=JaxSyntheticDetectionDataset(n=2, hw=(H, W),
                                                                           seed=4),
                         batch_size=2, use_mesh=False, loader_workers=1)
    model = SegDetector(**DET, device="cpu")
    load_flax_variables(model.net, variables)
    exp = Experiment(model, eval_dataset=SyntheticDetectionDataset(n=2, hw=(H, W), seed=4),
                     batch_size=2, loader_workers=1)
    image = jax_normalize(jnp.asarray(np.stack([exp.eval_loader.dataset[i]["image"]
                                                for i in range(2)]), jnp.float32))
    prob = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, heads=("prob",)))(
        variables, image)["prob"])
    return dict(jexp=jexp, exp=exp, variables=variables,
                bin_thresh=float(np.quantile(prob, 0.8)))


@pytest.mark.parametrize("protocol", ["icdar2015", "deteval"])
def test_evaluate_detection_poly_matches_jax(eval_pair, protocol):
    kw = dict(bin_thresh=eval_pair["bin_thresh"], box_thresh=0.0, max_regions=8, mode="poly")
    ref = jax_evaluate_detection(eval_pair["jexp"], eval_pair["variables"],
                                 representer=jax_detection.SegDetectorRepresenter(**kw),
                                 protocol=protocol)
    got = evaluate_detection(eval_pair["exp"], representer=detection.SegDetectorRepresenter(**kw),
                             protocol=protocol)
    assert got == ref


def test_cli_eval_representer_poly(tmp_path, capsys):
    """``cli.eval --representer poly`` on a detector checkpoint prints what
    ``evaluate(..., representer_mode='poly')`` gives, and it is not the quad
    mode's line."""
    path = os.path.join(REPO, "experiments", "seg_detector_synth.yaml")
    over = {"experiment.model.device": "cpu", "experiment.workspace": str(tmp_path),
            "experiment.model.fpn_dim": 32, "experiment.model.head_dim": 16,
            "experiment.model.width": 16, "experiment.eval_dataset.n": 2,
            "experiment.eval_dataset.hw": [128, 128], "experiment.batch_size": 2,
            "experiment.loader_workers": 1}
    exp = Experiment.from_yaml(path, over)
    CheckpointManager(str(tmp_path)).save(create_train_state(exp.model, exp.optimizer), 3,
                                          force=True)
    argv = [path] + [a for k, v in over.items() for a in (f"--{k}", str(v))]
    got = cli_eval.main(argv + ["--representer", "poly"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and got["step"] == 3
    want = evaluate(Experiment.from_yaml(path, over), representer_mode="poly")
    assert {k: v for k, v in got.items() if k != "step"} == want
    assert set(want) >= {"precision", "recall", "hmean"}
