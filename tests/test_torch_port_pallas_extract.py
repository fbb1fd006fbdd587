"""The port's Pallas-path region extraction (``ops/extract.py``) against the
JAX package's Pallas kernels run in interpret mode, on the CPU.

Each plain kernel version is held against its TPU kernel (``pl.pallas_call``
of ``_candidates_kernel``, ``_moments_kernel``, ``_extents_kernel``, laid out
as ``extract_regions_pallas`` lays them out) on the same inputs, and
``extract_regions(impl='pallas'|'pallas_full')`` against
``extract_regions_pallas(candidates='xla'|'pallas')``. Masks: the random
blobs of ``tests/test_pallas_extract.py``, rotated bars, a component rooted
at pixel 0 with equal-area ties, 20% noise (more components than either K2
keeps), an empty page, a serpentine whose labels stay capped after 2 CCL
sweeps (labels that name no root count nowhere). One page shape, 70x130,
not a multiple of the Pallas strip (8) or lane (128) tiles. K 8 and K 20; at
K 20 the two candidate phases keep different roots (K2 160 by the XLA
formulation, 256 by the kernel).

Tolerances: integers (candidate roots and areas, valid, area, the selected
slots) equal; every slot's floats, the empty ones included, within 1e-5
(score) and 1e-4 (centre, angle, extents) absolute and 1e-5 relative,
tighter than ``tests/test_pallas_extract.py``'s 1e-5 / 1e-3 / 5e-3 against
the XLA path: both sides compute the Pallas formulation, the port's sums in
float64 and the TPU kernel's in float32."""

import ast
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from megreader_tpu.ops import pallas_extract as jpe
from megreader_tpu.ops.ccl import connected_components as jax_connected_components
from megreader_tpu_torch.ops import ccl, extract

B, H, W = 2, 70, 130
HP, WP = 72, 256  # the Pallas padding of (H, W)
TOL = {"score": 1e-5, "center": 1e-4, "theta": 1e-4, "extent_u": 1e-4, "extent_v": 1e-4}


def _blobs(rng, n):
    m = np.zeros((H, W), bool)
    for _ in range(n):
        h, w = rng.integers(3, 14), rng.integers(4, 30)
        y, x = rng.integers(0, H - h), rng.integers(0, W - w)
        m[y:y + h, x:x + w] = True
    return m


def _bars():
    yy, xx = np.mgrid[0:H, 0:W]
    m = np.zeros((H, W), bool)
    for cx, cy, hw, hh, th in ((40, 20, 30, 4, 0.35), (85, 50, 35, 5, -0.5), (110, 15, 15, 3, 1.2)):
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        m |= (np.abs(u) <= hw) & (np.abs(v) <= hh)
    return m


def _origin_and_ties():
    m = np.zeros((H, W), bool)
    m[0:6, 0:20] = True  # rooted at pixel 0
    for r in (15, 30, 45):  # three equal areas: the lower slot first
        m[r:r + 4, 30:60] = True
    m[60:66, 70:120] = True
    return m


def _cases():
    rng = np.random.default_rng(0)
    return {
        "blobs": np.stack([_blobs(rng, 6), _blobs(rng, 12)]),
        "bars_origin_ties": np.stack([_bars(), _origin_and_ties()]),
        "noise_empty": np.stack([rng.random((H, W)) < 0.2, np.zeros((H, W), bool)]),
    }


CASES = _cases()


def _serpentine():
    m = np.zeros((H, W), bool)
    for k, r in enumerate(range(4, H - 8, 8)):
        m[r:r + 4, 4:W - 4] = True
        m[r + 4:r + 8, slice(W - 8, W - 4) if k % 2 == 0 else slice(4, 8)] = True
    return m


#: the serpentine's labels stay capped after 2 sweeps: many name no root
ITERS = {"serpentine_capped_and_blobs": 2}
CASES["serpentine_capped_and_blobs"] = np.stack(
    [_serpentine(), _blobs(np.random.default_rng(5), 8)])


@functools.lru_cache(maxsize=None)
def _labels_and_scores(case):
    labels = np.array(jax_connected_components(jnp.asarray(CASES[case]),
                                               max_iters=ITERS.get(case, 64), impl="xla"))
    scores = np.random.default_rng(1).random((B, H, W)).astype(np.float32)
    return labels, scores


def _pad(a, value):
    return jnp.pad(a, ((0, 0), (0, HP - H), (0, WP - W)), constant_values=value)


@functools.partial(jax.jit, static_argnames="K2")
def _jax_candidates(labels, K2):
    out = pl.pallas_call(
        functools.partial(jpe._candidates_kernel, H=HP, W=WP, W_orig=W, K2=K2),
        grid=(B,),
        in_specs=[pl.BlockSpec((1, HP, WP), lambda b: (b, 0, 0))],
        out_specs=[pl.BlockSpec((1, K2, 1), lambda b: (b, 0, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((B, K2, 1), jnp.int32),
                   jax.ShapeDtypeStruct((B, K2, 1), jnp.float32)],
        scratch_shapes=[jpe.pltpu.VMEM((K2, 1), jnp.int32)] * 3
        + [jpe.pltpu.SMEM((1, 1), jnp.int32)],
        interpret=True,
    )(_pad(labels, -1))
    return out[0][..., 0], out[1][..., 0]


@jax.jit
def _jax_moments(labels, scores, roots):
    K = roots.shape[1]
    return pl.pallas_call(
        functools.partial(jpe._moments_kernel, H=HP, W=WP, K=K),
        grid=(B,),
        in_specs=[pl.BlockSpec((1, HP, WP), lambda b: (b, 0, 0))] * 2
        + [pl.BlockSpec((1, K, 1), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, K, 8), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, K, 8), jnp.float32),
        scratch_shapes=[jpe.pltpu.VMEM((K, 8), jnp.float32)],
        interpret=True,
    )(_pad(labels, -1), _pad(scores, 0.0), roots[:, :, None])


@jax.jit
def _jax_extents(labels, roots, params):
    K = roots.shape[1]
    return pl.pallas_call(
        functools.partial(jpe._extents_kernel, H=HP, W=WP, K=K),
        grid=(B,),
        in_specs=[pl.BlockSpec((1, HP, WP), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, K, 1), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, K, 4), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, K, 4), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, K, 4), jnp.float32),
        scratch_shapes=[jpe.pltpu.VMEM((K, 4), jnp.float32)],
        interpret=True,
    )(_pad(labels, -1), roots[:, :, None], params)


@pytest.mark.parametrize("K", [8, 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_pallas_kernels(case, K):
    labels, scores = _labels_and_scores(case)
    tl = torch.from_numpy(labels)
    K2 = extract.pallas_k2(K)
    assert K2 == jpe._round_up(max(8 * K, 128), 128)

    cand_idx, cand_area = extract.candidates_reference(tl, K2)
    ref_idx, ref_area = _jax_candidates(jnp.asarray(labels), K2)
    np.testing.assert_array_equal(cand_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(cand_area.numpy(), np.asarray(ref_area))

    top_area, roots, _ = ccl._top_k_slots(cand_idx, cand_area, K)
    roots = roots.to(torch.int32)
    M = extract.moments_reference(tl, torch.from_numpy(scores), roots)
    ref_M = np.asarray(_jax_moments(jnp.asarray(labels), jnp.asarray(scores),
                                    jnp.asarray(roots.numpy())))
    np.testing.assert_array_equal(M[..., 0].numpy(), ref_M[..., 0])  # counts
    np.testing.assert_allclose(M.numpy(), ref_M, rtol=1e-5, atol=1e-3)

    a = torch.clamp(top_area, min=1.0)
    theta = 0.5 * torch.atan2(2.0 * M[..., 6] / a, (M[..., 4] - M[..., 5]) / a)
    params = torch.stack([M[..., 2] / a, M[..., 3] / a, theta.cos(), theta.sin()], 2)
    ext = extract.extents_reference(tl, roots, params)
    ref_ext = np.asarray(_jax_extents(jnp.asarray(labels), jnp.asarray(roots.numpy()),
                                      jnp.asarray(params.numpy())))
    np.testing.assert_allclose(ext.numpy(), ref_ext, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("K", [8, 20])
@pytest.mark.parametrize("impl", ["pallas", "pallas_full"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_regions_matches_pallas_path(case, impl, K):
    labels, scores = _labels_and_scores(case)
    ref = jpe.extract_regions_pallas(jnp.asarray(labels), jnp.asarray(scores), max_regions=K,
                                     interpret=True,
                                     candidates="pallas" if impl == "pallas_full" else "xla")
    got = ccl.extract_regions(torch.from_numpy(labels), torch.from_numpy(scores), K, impl=impl)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["area"].numpy(), np.asarray(ref["area"]))
    for key, tol in TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=tol,
                                   err_msg=key)


def test_k2_rounding_keeps_each_paths_candidates():
    """Noise with more than 256 components at K 20: the kernel path's 256
    candidates hold roots that the XLA formulation's 160 do not."""
    labels, scores = _labels_and_scores("noise_empty")
    n_roots = int((labels[0].reshape(-1) == np.arange(H * W)).sum())
    assert n_roots > 256
    tl, ts = torch.from_numpy(labels), torch.from_numpy(scores)
    _, xla_roots, _ = ccl._candidate_roots(tl.reshape(B, -1).long(), 20)
    full = extract.candidates_reference(tl, extract.pallas_k2(20))[0]
    assert extract.pallas_k2(20) == 256 and int(full[0].count_nonzero()) == 256
    assert xla_roots[0].max() < full[0].max()
    a = ccl.extract_regions(tl, ts, 20, impl="pallas")
    b = ccl.extract_regions(tl, ts, 20, impl="pallas_full")
    assert not torch.equal(a["center"], b["center"])


def test_empty_slot_centres_on_its_own_count():
    """An empty slot (root 0, area 0) describes the component rooted at pixel
    0: sums divided by 1, second moments centred on its mean (the Pallas
    formulation); the XLA formulation centres them on the undivided sums."""
    labels, scores = _labels_and_scores("bars_origin_ties")
    tl, ts = torch.from_numpy(labels), torch.from_numpy(scores)
    got = ccl.extract_regions(tl, ts, 8, impl="pallas")
    xla = ccl.extract_regions(tl, ts, 8, impl="xla")
    empty = ~got["valid"][1]
    assert empty.any()
    xs = np.nonzero(labels[1] == 0)[1]  # the component rooted at pixel 0
    np.testing.assert_allclose(got["center"][1][empty][:, 0].numpy(), xs.sum(), rtol=1e-6)
    np.testing.assert_allclose(got["center"].numpy(), xla["center"].numpy(), rtol=1e-6)
    assert not np.allclose(got["extent_u"][1][empty].numpy(), xla["extent_u"][1][empty].numpy())


def test_cuda_wrappers_refuse_cpu_tensors():
    labels = torch.zeros((1, 8, 8), dtype=torch.int32)
    roots = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        extract.candidates_cuda(labels, 128)
    with pytest.raises(ValueError, match="CUDA"):
        extract.moments_cuda(labels, labels.float(), roots)
    with pytest.raises(ValueError, match="CUDA"):
        extract.extents_cuda(labels, roots, torch.zeros((1, 4, 4)))


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    for name in ("candidates_reference", "moments_reference", "extents_reference"):
        monkeypatch.setattr(extract, name,
                            lambda *a, **k: pytest.fail("plain version used for a non-CPU tensor"))
    meta = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    roots = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    for call in (lambda: extract.candidates(meta, 128),
                 lambda: extract.moments(meta, meta.float(), roots),
                 lambda: extract.extents(meta, roots, torch.zeros((1, 4, 4), device="meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for fn in (extract.candidates, extract.moments, extract.extents, extract.candidates_cuda,
               extract.moments_cuda, extract.extents_cuda, extract.extract_regions_kernels):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_extents_keep_the_sentinels_when_every_projection_lies_past_them():
    """All-foreground pages (no pixel outside the slot's component) and slots
    centred past 1e9 px, as a dead slot is on a page-sized component's
    undivided sums: the minima stay at or below 1e9 and the maxima at or
    above -1e9, as the Pallas kernel's accumulators start from them."""
    labels = np.zeros((B, H, W), np.int32)
    roots = np.zeros((B, 4), np.int32)
    params = np.array([[[W / 2, H / 2, 1.0, 0.0], [3e9, H / 2, 1.0, 0.0],
                        [W / 2, -2e9, 0.0, 1.0], [-2e9, 2e9, 0.6, 0.8]]] * B, np.float32)
    ext = extract.extents_reference(torch.from_numpy(labels), torch.from_numpy(roots),
                                    torch.from_numpy(params)).numpy()
    ref = np.asarray(_jax_extents(jnp.asarray(labels), jnp.asarray(roots), jnp.asarray(params)))
    np.testing.assert_allclose(ext, ref, rtol=1e-5, atol=1e-4)
    assert (ext[:, 1, 1] == -1e9).all() and (ext[:, 2, 0] == 1e9).all()


def _bars_of_three(n):
    """Labels of n components, each a 1x3 bar rooted at its left pixel, laid
    out in raster order 32 to a row (every third row), background -1."""
    labels = np.full((H, W), -1, np.int32)
    for c in range(n):
        y, x = 3 * (c // 32), 4 * (c % 32)
        labels[y, x:x + 3] = y * W + x
    return labels


@pytest.mark.parametrize("K2", [128, 256])
def test_candidates_at_exactly_k2_roots_and_one_more(K2):
    """A page with exactly K2 roots keeps them all; one with K2 + 1 drops
    the last in raster order, which counts nowhere."""
    labels = np.stack([_bars_of_three(K2), _bars_of_three(K2 + 1)])
    cand_idx, cand_area = extract.candidates_reference(torch.from_numpy(labels), K2)
    ref_idx, ref_area = _jax_candidates(jnp.asarray(labels), K2)
    np.testing.assert_array_equal(cand_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(cand_area.numpy(), np.asarray(ref_area))
    roots = np.flatnonzero(labels[1].reshape(-1) == np.arange(H * W))
    assert len(roots) == K2 + 1
    for page in range(B):
        np.testing.assert_array_equal(cand_idx[page].numpy(), roots[:K2])
        assert (cand_area[page] == 3.0).all()


def test_extents_of_slots_that_share_a_root_follow_their_own_parameters():
    """Slots that repeat a root (two live roots twice, root 0 three times) each
    project that root's pixels on their own axes: pixel 0 is foreground on
    the second page (its root-0 slots see the component there) and
    background on the first (they keep the sentinels)."""
    labels, _ = _labels_and_scores("bars_origin_ties")
    assert labels[0, 0, 0] == -1 and labels[1, 0, 0] == 0
    tl = torch.from_numpy(labels)
    live = extract.candidates_reference(tl, 128)[0][:, :3].numpy()
    roots = np.concatenate([live, live[:, 1:2], np.zeros((B, 3), np.int32), live[:, 2:3]], 1)
    K = roots.shape[1]
    rng = np.random.default_rng(3)
    theta = rng.uniform(-np.pi, np.pi, (B, K))
    params = np.stack([rng.uniform(0, W, (B, K)), rng.uniform(0, H, (B, K)), np.cos(theta),
                       np.sin(theta)], -1).astype(np.float32)
    tr, tp = torch.from_numpy(roots), torch.from_numpy(params)
    ext = extract.extents_reference(tl, tr, tp).numpy()
    ref = np.asarray(_jax_extents(jnp.asarray(labels), jnp.asarray(roots), jnp.asarray(params)))
    np.testing.assert_allclose(ext, ref, rtol=1e-5, atol=1e-4)
    for k in range(K):  # each slot as if it were alone
        alone = extract.extents_reference(tl, tr[:, k:k + 1].contiguous(),
                                          tp[:, k:k + 1].contiguous()).numpy()
        np.testing.assert_array_equal(ext[:, k:k + 1], alone)
    assert (ext[0, 4:7] == [1e9, -1e9, 1e9, -1e9]).all()  # root 0 names no pixel on page 0
    assert len({tuple(e) for e in ext[1, 4:7]}) == 3  # three parameter sets, three extents
    assert not np.array_equal(ext[:, 1], ext[:, 3]) and not np.array_equal(ext[:, 2], ext[:, 7])
