"""The whole serving slice: the port's ``E2EPipeline.run`` against the JAX
pipeline's ``build()`` program on the same pages and carried weights.

Random weights give a prob map with no text structure, so the binarization
threshold is taken from the JAX prob map (its 80th percentile, moved into a
gap of the sorted values so that no prob lies within 1e-5 of it). The test
then asserts the other precondition of an exact comparison: on every valid
slot, the recognizer's top-2 logits differ by more than 1e-3 (the weight
seeds were picked for it)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.pipelines import E2EPipeline as JaxE2EPipeline
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.pipelines.e2e import E2EPipeline

B, H, W, K = 2, 64, 128, 8
THRESH_GAP = 1e-5
LOGIT_MARGIN = 1e-3


def _pages(seed):
    """Light pages with dark word-like bars and some noise."""
    rng = np.random.default_rng(seed)
    pages = 220.0 + 15.0 * rng.standard_normal((B, H, W, 3))
    for b in range(B):
        for _ in range(5):
            y, x = rng.integers(4, H - 12), rng.integers(4, W - 40)
            pages[b, y:y + rng.integers(5, 10), x:x + rng.integers(15, 36)] -= 150.0
    return np.clip(pages, 0, 255).astype(np.float32)


def _threshold(prob):
    """A threshold near the 80th percentile with no prob within THRESH_GAP."""
    v = np.sort(prob.reshape(-1))
    i = int(0.8 * len(v))
    lo, hi = max(i - 200, 0), min(i + 200, len(v) - 1)
    gaps = np.diff(v[lo:hi + 1])
    j = lo + int(np.argmax(gaps))
    assert v[j + 1] - v[j] > 2 * THRESH_GAP
    return float(0.5 * (v[j] + v[j + 1]))


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX models, their seeded weights (drawn on ``init``'s shapes) and
    the binarization threshold of their prob map on ``_pages(3)``: built once
    a module, for every pipeline option."""
    det = JaxSegDetector(fpn_dim=32, head_dim=16, width=16)
    rec = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
    key = jax.random.PRNGKey(0)
    det_vars = seeded_flax_variables(
        jax.eval_shape(det.init, key, jnp.zeros((1, H, W, 3))), 13)
    rec_vars = seeded_flax_variables(
        jax.eval_shape(rec.init, key, jnp.zeros((1, 32, 100, 3))), 113)
    # logits as sharp as a trained recognizer's (std ~3, not ~0.4)
    rec_vars["params"]["classifier"]["kernel"] *= 8.0
    prob = np.asarray(jax.jit(lambda v, p: det.apply(v, jax_normalize(p), heads=("prob",))[
        "prob"])(det_vars, jnp.asarray(_pages(3))))
    return det, rec, det_vars, rec_vars, _threshold(prob)


def _run_pair(rectify, unclip, extract_impl="auto", **extra):
    det, rec, det_vars, rec_vars, thresh = _jax_models()
    pages = _pages(3)
    opts = dict(max_regions=K, box_thresh=0.0, bin_thresh=thresh,
                rectify=rectify, unclip=unclip, extract_impl=extract_impl, **extra)
    jpipe = JaxE2EPipeline(det, rec, **opts)
    jpipe._jitted = jpipe.build()  # the program that ``predict`` runs too, compiled once
    ref = {k: np.asarray(v) for k, v in jpipe._jitted(det_vars, rec_vars, pages).items()}

    tdet = SegDetector("resnet18", 32, 16, width=16, device="cpu")
    trec = CTCRecognizer(37, hidden=32, num_encoder_layers=1, device="cpu")
    load_flax_variables(tdet.net, det_vars)
    load_flax_variables(trec.net, rec_vars)
    tpipe = E2EPipeline(tdet, trec, device="cpu", **opts)
    got = {k: v.numpy() for k, v in tpipe.run(None, None, pages).items()}

    # precondition: every valid slot's argmax is decided by > LOGIT_MARGIN
    with torch.no_grad():
        tp = torch.from_numpy(pages)
        tprob = tpipe.detect(tdet.net, tp)
        reg = tpipe.regions(tpipe.label(tprob), tprob)
        logits = trec.net(tpipe.crops(tp, reg)).reshape(B, K, 25, 37)
    top2 = torch.topk(logits[torch.from_numpy(ref["valid"].copy())], 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min()) if top2.numel() else np.inf
    return dict(jpipe=jpipe, tpipe=tpipe, ref=ref, got=got, pages=pages, margin=margin,
                det_vars=det_vars, rec_vars=rec_vars)


@pytest.fixture(scope="module", params=[("perspective", "inverse"), ("box", "ratio")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def slice_pair(request):
    return _run_pair(*request.param)


def _assert_run_matches(pair):
    ref, got = pair["ref"], pair["got"]
    assert pair["margin"] > LOGIT_MARGIN
    assert set(got) == set(ref)
    valid = ref["valid"]
    assert valid.sum() >= 4  # enough regions for the comparison to mean something
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["ids"][valid], ref["ids"][valid])
    np.testing.assert_array_equal(got["lengths"][valid], ref["lengths"][valid])
    np.testing.assert_allclose(got["quads"][valid], ref["quads"][valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["boxes"][valid], ref["boxes"][valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"][valid], ref["scores"][valid], rtol=0, atol=1e-5)
    if "polygons" in ref:  # chain mode
        np.testing.assert_allclose(got["polygons"][valid], ref["polygons"][valid], rtol=0,
                                   atol=1e-3)
    for k in ref:
        assert got[k].shape == ref[k].shape, k


def test_e2e_run_matches_jax(slice_pair):
    _assert_run_matches(slice_pair)


@pytest.mark.parametrize("impl", ["pallas", "pallas_full"])
def test_extract_impl_runs_and_matches(impl):
    """The Pallas-path extraction (the CUDA kernels' plain versions on the
    CPU) against the JAX pipeline with the same option (its kernels in
    interpret mode)."""
    pair = _run_pair("perspective", "inverse", extract_impl=impl)
    assert pair["tpipe"].resolved_impls == {"ccl": "plain", "extract": impl}
    assert pair["jpipe"].resolved_impls["extract"] == impl
    _assert_run_matches(pair)


def test_e2e_predict_strings_match_jax(slice_pair):
    p = slice_pair
    ref = p["jpipe"].predict(p["det_vars"], p["rec_vars"], p["pages"])
    got = p["tpipe"].predict(None, None, p["pages"])
    assert [[r["text"] for r in page] for page in got] == \
        [[r["text"] for r in page] for page in ref]
    for gp, rp in zip(got, ref):
        for g, r in zip(gp, rp):
            np.testing.assert_allclose(g["quad"], r["quad"], rtol=0, atol=1e-3)
            assert abs(g["score"] - r["score"]) <= 1e-5


@pytest.mark.parametrize("opt", [
    {"rectify": "chain"}, {"rectify": "deskew"}, {"deskew": True}, {"bf16": True},
    {"rec_mode": "beam"}, {"ccl_multigrid": True},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_unported_options_raise(opt):
    """Each option runs: ``rectify='chain'`` (curved text: ids, quads and the
    chain polygons against the JAX pipeline's, polygons within 1e-3 px) and
    ``rectify='deskew'``, the legacy ``deskew=True`` (which turns the default
    perspective mode into deskew) and ``ccl_multigrid=True`` run the whole
    slice against the JAX pipeline with the same option. ``rec_mode='beam'``
    decodes crops by the recognizer's beam of width ``beam_width`` (the beam
    is held to JAX by
    ``tests/test_torch_port_ctc_beam.py``), and an unknown mode raises;
    ``bf16=True`` serves a bf16 copy of the recognizer on bf16 crops (held to
    JAX by ``tests/test_torch_port_bf16.py``)."""
    if opt in ({"rectify": "deskew"}, {"deskew": True}, {"ccl_multigrid": True},
               {"rectify": "chain"}):
        pair = _run_pair(opt.get("rectify", "perspective"), "inverse",
                         **{k: v for k, v in opt.items() if k != "rectify"})
        want = {"ccl_multigrid": "perspective", "rectify": opt.get("rectify")}.get(
            next(iter(opt)), "deskew")
        assert pair["tpipe"].rectify == pair["jpipe"].rectify == want
        assert pair["tpipe"].ccl_multigrid == pair["jpipe"].ccl_multigrid
        _assert_run_matches(pair)
        return
    rec = CTCRecognizer(37, hidden=8, num_encoder_layers=1, device="cpu")
    if opt == {"bf16": True}:
        pipe = E2EPipeline(None, rec, device="cpu", **opt)
        crops = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 32, 100, 3))
                                 .astype(np.float32))
        got = pipe.recognize(None, crops.to(torch.bfloat16))
        assert pipe.serving(rec.net).classifier.weight.dtype == torch.bfloat16
        assert rec.net.classifier.weight.dtype == torch.float32
        assert got[0].shape == (3, 25) and got[0].dtype == torch.int32
        return
    if opt == {"rec_mode": "beam"}:
        pipe = E2EPipeline(None, rec, device="cpu", beam_width=4, **opt)
        crops = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 32, 100, 3))
                                 .astype(np.float32))
        got = pipe.recognize(None, crops)
        ref = rec.decode(crops, mode="beam", beam_width=4)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        with pytest.raises(ValueError, match="unknown rec_mode"):
            E2EPipeline(None, rec, device="cpu", rec_mode="sample")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        E2EPipeline(None, rec, device="cpu", **opt)


def test_unported_recognizer_family_and_mesh_raise():
    # a spotter (or anything else) is not a crop recognizer, as in JAX
    with pytest.raises(TypeError, match="not a crop recognizer"):
        E2EPipeline(None, object(), device="cpu")
    rec = CTCRecognizer(37, hidden=8, num_encoder_layers=1, device="cpu")
    # sharded serving is ported (tests/test_torch_port_parallel.py); a mesh
    # that is not a parallel.Mesh raises
    with pytest.raises(TypeError, match="parallel.Mesh"):
        E2EPipeline(None, rec, device="cpu").build(mesh=object())
