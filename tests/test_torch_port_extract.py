"""Port region extraction, quads and unclip against the JAX XLA formulation
on text-like masks (upright and rotated rectangles, equal-area ties, more
components than slots, a component rooted at pixel 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megreader_tpu.ops import ccl as jax_ccl
from megreader_tpu_torch.ops import ccl


def _rect(m, cx, cy, hw, hh, th=0.0):
    H, W = m.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    c, s = np.cos(th), np.sin(th)
    u = (xx - cx) * c + (yy - cy) * s
    v = -(xx - cx) * s + (yy - cy) * c
    m |= (np.abs(u) <= hw) & (np.abs(v) <= hh)


def _upright():
    m = np.zeros((96, 128), bool)
    m[10:18, 8:70] = True
    m[30:40, 20:110] = True
    m[60:66, 40:90] = True
    return m


def _rotated():
    m = np.zeros((96, 128), bool)
    _rect(m, 40, 30, 30, 4, 0.35)
    _rect(m, 80, 70, 35, 5, -0.5)
    _rect(m, 100, 20, 18, 3, 1.2)
    return m


def _ties_and_origin():
    m = np.zeros((96, 128), bool)
    m[0:6, 0:20] = True  # root at pixel 0
    for r in (20, 40, 60):  # three equal areas: lower raster rank first
        m[r:r + 4, 30:60] = True
    m[80:84, 70:100] = True
    return m


def _many():
    rng = np.random.default_rng(3)
    return rng.random((96, 128)) < 0.2  # many small components, > K2 roots


CASES = {"upright": _upright, "rotated": _rotated, "ties_and_origin": _ties_and_origin,
         "many": _many}


def _stats_pair(masks, K):
    rng = np.random.default_rng(1)
    labels = np.array(jax_ccl.connected_components(jnp.asarray(masks), max_iters=64,
                                                   impl="xla"))
    scores = rng.random(masks.shape).astype(np.float32)
    js = jax_ccl.extract_regions(jnp.asarray(labels), jnp.asarray(scores),
                                 max_regions=K, impl="xla")
    ts = ccl.extract_regions(torch.from_numpy(labels), torch.from_numpy(scores), K)
    return {k: np.asarray(v) for k, v in js.items()}, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_regions_matches_jax(case):
    masks = np.stack([CASES[case](), _upright()])
    js, ts = _stats_pair(masks, K=8)
    np.testing.assert_array_equal(ts["valid"].numpy(), js["valid"])
    np.testing.assert_array_equal(ts["area"].numpy(), js["area"])  # slot order
    np.testing.assert_allclose(ts["center"].numpy(), js["center"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts["score"].numpy(), js["score"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts["theta"].numpy(), js["theta"], rtol=0, atol=1e-4)
    for k in ("extent_u", "extent_v"):
        np.testing.assert_allclose(ts[k].numpy(), js[k], rtol=0, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("case", ["upright", "rotated", "ties_and_origin"])
@pytest.mark.parametrize("unclip", ["inverse", "ratio"])
def test_quads_and_unclip_match_jax(case, unclip):
    masks = np.stack([CASES[case](), _rotated()])
    js, ts = _stats_pair(masks, K=6)
    if unclip == "inverse":
        jd = jax_ccl.unclip_distance_inverse(js, shrink_ratio=0.4)
        td = ccl.unclip_distance_inverse(ts, shrink_ratio=0.4)
    else:
        jd = jax_ccl.unclip_distance_for(js, ratio=1.5)
        td = ccl.unclip_distance_for(ts, ratio=1.5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-3)
    jq = np.asarray(jax_ccl.regions_to_quads(js, jd))
    tq = ccl.regions_to_quads(ts, td).numpy()
    valid = js["valid"]
    np.testing.assert_allclose(tq[valid], jq[valid], rtol=0, atol=1e-3)
    # empty slots carry the 1e9 sentinels: same to float32 resolution
    np.testing.assert_allclose(tq[~valid], jq[~valid], rtol=1e-6, atol=1e-3)


def test_no_regions_page():
    masks = np.zeros((1, 32, 48), bool)
    js, ts = _stats_pair(masks, K=4)
    assert not ts["valid"].any()
    np.testing.assert_array_equal(ts["extent_u"].numpy(), js["extent_u"])
    np.testing.assert_array_equal(ts["center"].numpy(), js["center"])
