"""The plain moments of the port's region extraction
(``ops/extract.py::moments_reference``, the arithmetic of the moments kernel
in ``csrc/extract.cu``), on the CPU.

* Columns 0 and 2-6 (count, sum x, sum y and the centred second moments)
  equal the exact rational, computed with ``fractions.Fraction`` from the
  pixels, rounded once to float32: on large near-isotropic regions at far
  coordinates (sum x^2 above 1e10, where float32 sums cancel), one-column
  and one-row regions (a centred moment exactly 0), a single pixel, scattered
  pixels under one label and random overlapping blobs. Column 1 (a float64
  sum of the scores) within rtol 1e-6 of the float64 sum.
* Slots that repeat a root, the empty slots' root 0 among them, with pixel 0
  in the foreground and not, carry the lowest such slot's sums, bit for bit.
* Against the former two-pass float64 formulation (kept here as an oracle):
  rtol 1e-6, atol 1e-6 (where the exact value is 0 the two-pass one leaves
  about 1e-9).
* Against the JAX package's ``_moments_kernel`` in interpret mode, laid out
  as ``extract_regions_pallas`` lays it out: counts equal, the rest within
  rtol 1e-5, atol 1e-3 (the TPU kernel sums in float32), as in
  ``tests/test_torch_port_pallas_extract.py``.
* ``check_moment_range`` refuses pages whose int64 sums could overflow.
"""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from megreader_tpu.ops import pallas_extract as jpe
from megreader_tpu_torch.ops import extract
from megreader_tpu_torch.ops.ccl import _SPILL


def _labels(ids: np.ndarray) -> np.ndarray:
    """(B, H, W) region ids (-1 background) -> labels: each region's pixels
    hold the linear index of its raster-first pixel."""
    B, H, W = ids.shape
    out = np.full(ids.shape, -1, np.int32)
    for b in range(B):
        flat, lab = ids[b].reshape(-1), out[b].reshape(-1)
        for r in np.unique(flat[flat >= 0]):
            member = flat == r
            lab[member] = np.flatnonzero(member)[0]
    return out


def _far_page(rng, H=96, W=2048):
    """Regions at far coordinates: a 60x60 square and a disc near x 2000 and
    1500 (near-isotropic, sum x^2 ~ 1e10), a one-column and a one-row region,
    a rotated bar, scattered pixels under one id, a single pixel."""
    ids = np.full((H, W), -1, np.int64)
    yy, xx = np.mgrid[0:H, 0:W]
    ids[20:80, 1980:2040] = 0
    ids[(xx - 1500) ** 2 + (yy - 48) ** 2 <= 30 ** 2] = 1
    ids[5:90, 1000] = 2
    ids[93, 100:1900] = 3
    u = (xx - 600) * np.cos(0.4) + (yy - 45) * np.sin(0.4)
    v = -(xx - 600) * np.sin(0.4) + (yy - 45) * np.cos(0.4)
    ids[(np.abs(u) <= 80) & (np.abs(v) <= 6)] = 4
    scatter = (rng.random((H, W)) < 0.01) & (ids < 0) & (xx > 1100) & (xx < 1400)
    ids[scatter] = 5
    ids[50, 1700] = 6
    return ids


def _blob_page(rng, H=64, W=300, n=14):
    ids = np.full((H, W), -1, np.int64)
    for r in range(n):
        h, w = rng.integers(1, min(20, H)), rng.integers(1, min(120, W))
        y, x = rng.integers(0, H - h), rng.integers(0, W - w)
        ids[y:y + h, x:x + w] = r
    return ids


def _case(name):
    rng = np.random.default_rng({"far": 0, "blobs": 1}[name])
    if name == "far":
        ids = np.stack([_far_page(rng), _far_page(rng)[:, ::-1].copy()])
    else:
        ids = np.stack([_blob_page(rng), _blob_page(rng)])
    labels = _labels(ids)
    scores = rng.random(labels.shape, dtype=np.float32)
    roots = []
    for b in range(labels.shape[0]):
        lab = labels[b].reshape(-1)
        r = list(np.unique(lab[lab >= 0]))
        roots.append(r + [r[0], 0, 0])  # a repeat, then two empty slots
    K = max(map(len, roots))
    roots = np.array([r + [0] * (K - len(r)) for r in roots], np.int32)
    return labels, scores, roots


CASES = ("far", "blobs")


def _to_f32(q: Fraction) -> np.float32:
    """The float32 nearest to q (ties to even)."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q), int(c.view(np.uint32)) & 1))


def _exact(labels, roots):
    """(B, K, 6) float32: count, sum x, sum y, sum dx^2, sum dy^2, sum dx*dy,
    each the exact rational rounded once."""
    B, H, W = labels.shape
    out = np.zeros((B, roots.shape[1], 6), np.float32)
    for b in range(B):
        for k, r in enumerate(roots[b]):
            ys, xs = np.nonzero(labels[b] == r)
            xs, ys = [int(v) for v in xs], [int(v) for v in ys]
            n = len(xs)
            if n == 0:
                continue
            sx, sy = sum(xs), sum(ys)
            sxx = sum(x * x for x in xs)
            syy = sum(y * y for y in ys)
            sxy = sum(x * y for x, y in zip(xs, ys))
            vals = (Fraction(n), Fraction(sx), Fraction(sy), sxx - Fraction(sx * sx, n),
                    syy - Fraction(sy * sy, n), sxy - Fraction(sx * sy, n))
            out[b, k] = [_to_f32(q) for q in vals]
    return out


def _moments(labels, scores, roots):
    return extract.moments_reference(torch.from_numpy(labels), torch.from_numpy(scores),
                                     torch.from_numpy(roots)).numpy()


@functools.lru_cache(maxsize=None)
def _case_and_moments(name):
    labels, scores, roots = _case(name)
    return labels, scores, roots, _moments(labels, scores, roots)


@pytest.mark.parametrize("case", CASES)
def test_integer_columns_equal_the_exact_rational(case):
    labels, scores, roots, M = _case_and_moments(case)
    np.testing.assert_array_equal(M[..., [0, 2, 3, 4, 5, 6]], _exact(labels, roots))
    assert not M[..., 7].any()


def test_far_regions_need_the_exact_centring():
    """The far page's sums of x^2 pass 1e10, and its one-column, one-row and
    single-pixel regions have centred moments of exactly 0."""
    labels, _, roots, M = _case_and_moments("far")
    square = int(np.flatnonzero(labels[0].reshape(-1) == labels[0, 20, 1980])[0])
    k = int(np.flatnonzero(roots[0] == square)[0])
    xs = np.nonzero(labels[0] == square)[1].astype(np.int64)
    assert (xs * xs).sum() > 1e10
    assert abs(M[0, k, 4] / M[0, k, 5] - 1.0) < 1e-6  # near-isotropic
    column, row, single = labels[0, 5, 1000], labels[0, 93, 100], labels[0, 50, 1700]
    for root, zero in ((column, [4, 6]), (row, [5, 6]), (single, [4, 5, 6])):
        k = int(np.flatnonzero(roots[0] == root)[0])
        assert (M[0, k, zero] == 0.0).all() and M[0, k, [4, 5]].max() >= 0.0


@pytest.mark.parametrize("case", CASES)
def test_score_column_is_the_float64_sum(case):
    labels, scores, roots, M = _case_and_moments(case)
    ref = np.array([[scores[b][labels[b] == r].astype(np.float64).sum() for r in roots[b]]
                    for b in range(len(roots))])
    np.testing.assert_allclose(M[..., 1], ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("pixel0", ["foreground", "background"])
def test_repeated_roots_carry_the_lowest_slots_sums(pixel0):
    rng = np.random.default_rng(3)
    ids = _blob_page(rng, 40, 90, 8)[None]
    ids[0, 0, 0] = 99 if pixel0 == "foreground" else -1
    labels = _labels(ids)
    scores = rng.random(labels.shape, dtype=np.float32)
    lab = labels[0].reshape(-1)
    a, b = np.unique(lab[lab > 0])[:2]
    roots = np.array([[a, 0, b, a, 0, 0, b, 0]], np.int32)
    M = _moments(labels, scores, roots)[0]
    for k, r in enumerate(roots[0]):
        first = int(np.flatnonzero(roots[0] == r)[0])
        np.testing.assert_array_equal(M[k], M[first])
    empty = M[1]
    if pixel0 == "foreground":
        assert empty[0] == (lab == 0).sum() > 0
    else:
        assert not empty.any()


def _two_pass_float64(labels, scores, roots):
    """The former plain version: float64 sums, the second moments centred on
    the float64 centroid in a second pass over the pixels."""
    labels, scores, roots = (torch.from_numpy(a) for a in (labels, scores, roots))
    B, H, W = labels.shape
    N, K = H * W, roots.shape[1]
    lbl = labels.reshape(B, N).to(torch.int64)
    roots = roots.to(torch.int64)
    slot_of = torch.full((B, N + 1), K, dtype=torch.int64)
    slot_of.scatter_reduce_(1, roots, torch.arange(K).expand(B, K), "amin")
    first = slot_of.gather(1, roots)
    group = slot_of.gather(1, torch.where(lbl >= 0, lbl, N))
    group = torch.where(group < K, group, K + torch.arange(N) % _SPILL)

    def gsum(vals):
        out = torch.zeros((B, K + _SPILL), dtype=torch.float64)
        return out.scatter_add_(1, group, vals.expand(B, N))[:, :K]

    def per_pixel(t):
        return torch.cat([t, t.new_zeros(B, _SPILL)], 1).gather(1, group)

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    xs, ys = xx.reshape(1, N), yy.reshape(1, N)
    count = gsum(torch.ones_like(xs))
    sums = [count, gsum(scores.reshape(B, N).to(torch.float64)), gsum(xs), gsum(ys)]
    n = torch.clamp(count, min=1.0)
    dx = xs - per_pixel(sums[2] / n)
    dy = ys - per_pixel(sums[3] / n)
    sums += [gsum(dx * dx), gsum(dy * dy), gsum(dx * dy), torch.zeros_like(count)]
    M = torch.stack(sums, -1)
    return M.gather(1, first[..., None].expand(B, K, 8)).to(torch.float32).numpy()


@pytest.mark.parametrize("case", CASES)
def test_agrees_with_the_two_pass_float64_formulation(case):
    labels, scores, roots, M = _case_and_moments(case)
    np.testing.assert_allclose(M, _two_pass_float64(labels, scores, roots), rtol=1e-6,
                               atol=1e-6)


PB, PH, PW = 2, 40, 100
PHP, PWP = 40, 128  # the Pallas padding of (PH, PW)


@jax.jit
def _jax_moments(labels, scores, roots):
    K = roots.shape[1]

    def pad(a, value):
        return jnp.pad(a, ((0, 0), (0, PHP - PH), (0, PWP - PW)), constant_values=value)

    return pl.pallas_call(
        functools.partial(jpe._moments_kernel, H=PHP, W=PWP, K=K),
        grid=(PB,),
        in_specs=[pl.BlockSpec((1, PHP, PWP), lambda b: (b, 0, 0))] * 2
        + [pl.BlockSpec((1, K, 1), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, K, 8), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((PB, K, 8), jnp.float32),
        scratch_shapes=[jpe.pltpu.VMEM((K, 8), jnp.float32)],
        interpret=True,
    )(pad(labels, -1), pad(scores, 0.0), roots[:, :, None])


@pytest.mark.parametrize("seed", [0, 1])
def test_agrees_with_the_pallas_kernel(seed):
    rng = np.random.default_rng(10 + seed)
    ids = np.stack([_blob_page(rng, PH, PW, 10) for _ in range(PB)])
    ids[1, 0, :7] = 50  # a region rooted at pixel 0 on one page
    labels = _labels(ids)
    scores = rng.random(labels.shape, dtype=np.float32)
    roots = np.zeros((PB, 12), np.int32)
    for b in range(PB):
        u = np.unique(labels[b][labels[b] >= 0])[:10]
        roots[b, :len(u)] = u
    M = _moments(labels, scores, roots)
    ref = np.asarray(_jax_moments(jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(roots)))
    np.testing.assert_array_equal(M[..., 0], ref[..., 0])
    np.testing.assert_allclose(M, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape,ok", [
    ((640, 640), True), ((2048, 2048), True), ((1, 2**21), True), ((9000, 9000), True),
    ((2, 2**21), False), ((2**17, 2**14), False), ((60000, 60000), False),
])
def test_range_check(shape, ok):
    if ok:
        extract.check_moment_range(*shape)
    else:
        with pytest.raises(ValueError, match="overflow"):
            extract.check_moment_range(*shape)


def test_plain_version_refuses_an_overflowing_page():
    labels = torch.full((1, 1, 1), -1, dtype=torch.int32).expand(1, 2, 2**21)
    with pytest.raises(ValueError, match="overflow"):
        extract.moments_reference(labels, labels.float(), torch.zeros((1, 4), dtype=torch.int32))
