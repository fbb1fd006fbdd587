"""Port detection evaluation (config #4) against the JAX package, on the CPU:
``detect_quads_device`` (stride 1 and 2), the quad
representer, the polygon geometry and both measurers (convex and non-convex
polygons), and one small ``evaluate_detection``.

One page shape (B 2, 128x128); every JAX call is jitted (the JAX package's
own ``detect_quads_device`` and evaluation forward are). Tolerances: valid
slots equal, quads atol 1e-3 px, scores atol 1e-5; polygon areas and ratios
rtol 1e-12 against the JAX package's numpy clip and cv2 raster (the same
float64 arithmetic), 1e-6 against its C++ route; measurer counts and P/R/H
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.data import SyntheticDetectionDataset as JaxSyntheticDetectionDataset
from megreader_tpu.evaluation import evaluate_detection as jax_evaluate_detection
from megreader_tpu.experiment import Experiment as JaxExperiment
from megreader_tpu import native as jax_native
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.postproc import detection as jax_detection
from megreader_tpu.postproc import measurers as jax_measurers
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
from megreader_tpu_torch.evaluation import evaluate, evaluate_detection
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.postproc import detection, measurers

B, H, W = 2, 128, 128
DET = dict(fpn_dim=32, head_dim=16, width=16)


def _prob_maps():
    """Smooth word-like bumps, upright and rotated, some touching the edges."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = np.full((B, H, W), -3.0, np.float32)
    for b in range(B):
        for _ in range(6):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            hw, hh, th = rng.uniform(8, 30), rng.uniform(3, 7), rng.uniform(-0.7, 0.7)
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            z = np.maximum(z, 4.0 - 3.0 * np.maximum(np.abs(u) / hw, np.abs(v) / hh) ** 2)
    return 1.0 / (1.0 + np.exp(-z)) + rng.uniform(-0.01, 0.01, (B, H, W)).astype(np.float32)


PROB = _prob_maps().astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_detect_quads_matches_jax(stride):
    kw = dict(bin_thresh=0.3, box_thresh=0.6, unclip_ratio=1.5, max_regions=8, ccl_iters=64,
              stride=stride)
    ref = jax.device_get(jax_detection.detect_quads_device(jnp.asarray(PROB), **kw))
    got = detection.detect_quads_device(torch.from_numpy(PROB), **kw)
    valid = ref["valid"]
    assert valid.sum() >= 6
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["quads"].numpy()[valid], ref["quads"][valid], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy()[valid], ref["scores"][valid], rtol=0,
                               atol=1e-5)


def test_representer_matches_jax():
    scales = np.array([[1.0, 1.0], [2.0, 0.5]], np.float32)
    ref = jax_detection.SegDetectorRepresenter(box_thresh=0.6, max_regions=8).represent(
        jnp.asarray(PROB), scales=scales)
    got = detection.SegDetectorRepresenter(box_thresh=0.6, max_regions=8).represent(
        torch.from_numpy(PROB), scales=scales)
    assert len(got) == len(ref) == B
    for g, r in zip(got, ref):
        assert g["polygons"].dtype == np.float32 and g["polygons"].shape == r["polygons"].shape
        np.testing.assert_allclose(g["polygons"], r["polygons"], rtol=0, atol=2e-3)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
    # the poly mode is ported (held to JAX in test_torch_port_chains.py): one
    # outline of 2(n_bands + 1) points a detection, the quad mode's valid set
    poly = detection.SegDetectorRepresenter(box_thresh=0.6, max_regions=8, mode="poly",
                                            n_bands=4).represent(torch.from_numpy(PROB))
    for g, r in zip(poly, ref):
        assert g["polygons"].shape == (len(r["polygons"]), 10, 2)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)


def _quad(x0, y0, w, h, rot=0.0):
    c = np.array([x0 + w / 2, y0 + h / 2])
    pts = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
    return (pts @ R.T + c).astype(np.float32)


BANANA = np.array([[0, 10], [20, 0], [40, 10], [40, 20], [20, 10], [0, 20]], np.float32)
POLYS = [_quad(10, 10, 40, 12), _quad(14, 12, 40, 12, 0.1), _quad(30, 5, 30, 30, 0.7),
         _quad(100, 100, 5, 5), BANANA, BANANA + [5.0, 3.0], _quad(60, 60, 10, 10)[::-1]]


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_polygon_geometry_matches_jax(route, monkeypatch):
    """Against the JAX package's numpy clip (equal to rounding), and against
    its C++ route where built (rtol 1e-6: it rounds differently)."""
    if route == "numpy":
        for fn in ("polygon_iou", "polygon_intersection_area"):
            monkeypatch.setattr(jax_native, fn, lambda *a: None)
    rtol = 1e-12 if route == "numpy" else 1e-6
    for p in POLYS:
        assert measurers.is_convex(p) == jax_measurers.is_convex(p)
        assert measurers.polygon_area(p) == jax_measurers.polygon_area(p)
    for a in POLYS:
        for b in POLYS:
            for fn in ("polygon_iou", "polygon_intersection_area",
                       "polygon_intersection_over_self"):
                np.testing.assert_allclose(getattr(measurers, fn)(a, b),
                                           getattr(jax_measurers, fn)(a, b), rtol=rtol,
                                           atol=1e-12, err_msg=fn)
    clip = measurers.clip_polygon(POLYS[0].astype(np.float64), POLYS[1].astype(np.float64))
    ref = jax_measurers.clip_polygon(POLYS[0].astype(np.float64), POLYS[1].astype(np.float64))
    np.testing.assert_array_equal(clip, ref)


def _pred_sets():
    """Per page (predictions, gts, ignore flags): matches, a miss, a split,
    a merge, a non-convex pair, a prediction inside a don't-care region."""
    gt0 = [_quad(10, 10, 40, 12), _quad(10, 40, 40, 12), _quad(70, 10, 20, 50), BANANA + 60]
    pred0 = [_quad(11, 10, 39, 12), _quad(70, 10, 20, 24), _quad(70, 35, 20, 25),
             BANANA + [61, 60], _quad(100, 100, 8, 8)]
    gt1 = [_quad(5, 5, 30, 10), _quad(40, 5, 30, 10), _quad(60, 60, 30, 30)]
    pred1 = [_quad(5, 5, 65, 10), _quad(62, 62, 20, 20)]
    return [(pred0, gt0, [False, False, False, False]), (pred1, gt1, [False, False, True]),
            ([], [_quad(1, 1, 9, 9)], [False]), ([_quad(1, 1, 9, 9)], [], [])]


@pytest.mark.parametrize("name", ["DetectionMeasurer", "DetEvalMeasurer"])
def test_measurers_match_jax(name):
    m, jm = getattr(measurers, name)(), getattr(jax_measurers, name)()
    raws, jraws = [], []
    for pred, gt, ign in _pred_sets():
        raws.append(m.measure_one(pred, gt, ign))
        jraws.append(jm.measure_one(pred, gt, ign))
        assert raws[-1] == jraws[-1]
    got = m.gather(raws)
    assert got == jm.gather(jraws)
    assert 0.0 < got["hmean"] < 1.0


@pytest.fixture(scope="module")
def eval_pair():
    jmodel = JaxSegDetector(**DET)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 11)
    jexp = JaxExperiment(jmodel, eval_dataset=JaxSyntheticDetectionDataset(n=B, hw=(H, W),
                                                                           seed=4),
                         batch_size=B, use_mesh=False, loader_workers=1)
    model = SegDetector(**DET, device="cpu")
    load_flax_variables(model.net, variables)
    exp = Experiment(model, eval_dataset=SyntheticDetectionDataset(n=B, hw=(H, W), seed=4),
                     batch_size=B, loader_workers=1)
    # a binarization threshold that cuts the random net's prob maps into blobs
    image = jax_normalize(jnp.asarray(np.stack([exp.eval_loader.dataset[i]["image"]
                                                for i in range(B)]), jnp.float32))
    prob = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, heads=("prob",)))(
        variables, image)["prob"])
    return dict(jexp=jexp, exp=exp, variables=variables,
                bin_thresh=float(np.quantile(prob, 0.8)))


@pytest.mark.parametrize("protocol", ["icdar2015", "deteval"])
def test_evaluate_detection_matches_jax(eval_pair, protocol):
    kw = dict(bin_thresh=eval_pair["bin_thresh"], box_thresh=0.0, max_regions=8)
    ref = jax_evaluate_detection(eval_pair["jexp"], eval_pair["variables"],
                                 representer=jax_detection.SegDetectorRepresenter(**kw),
                                 protocol=protocol)
    got = evaluate_detection(eval_pair["exp"], representer=detection.SegDetectorRepresenter(**kw),
                             protocol=protocol)
    assert got == ref
    if protocol == "icdar2015":
        assert evaluate(eval_pair["exp"]) == jax_evaluate_detection(eval_pair["jexp"],
                                                                    eval_pair["variables"])


def test_evaluate_detection_left_outs(eval_pair):
    """``int8`` is ported: int8 serving's metrics equal JAX's; an unknown
    protocol raises."""
    kw = dict(bin_thresh=eval_pair["bin_thresh"], box_thresh=0.0, max_regions=8)
    ref = jax_evaluate_detection(eval_pair["jexp"], eval_pair["variables"],
                                 representer=jax_detection.SegDetectorRepresenter(**kw),
                                 int8=True)
    assert evaluate_detection(eval_pair["exp"], representer=detection.SegDetectorRepresenter(**kw),
                              int8=True) == ref
    with pytest.raises(ValueError, match="protocol"):
        evaluate_detection(eval_pair["exp"], protocol="icdar2013")
