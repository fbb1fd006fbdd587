"""Port resamplers against the JAX package on the same numpy pages: normalize,
box crops, homographies and perspective rectification (atol 1e-3 on 0-255
pixels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.ops import image as jax_image
from megreader_tpu_torch.ops import image

ATOL_PX = 1e-3


def _pages(seed=0, shape=(2, 72, 120, 3)):
    """Smooth 0-255 pages (random low-frequency waves). Both packages compute
    sample coordinates in float32 in a different order, so they may differ by
    an ulp (~1e-5 px); on white noise, with steps of up to 255 between
    neighbours, that alone moves a pixel by 2.5e-3, so the pages are smooth,
    as scanned pages are at the scale of a pixel."""
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros(shape)
    for _ in range(4):
        f = rng.uniform(0.02, 0.1, (B, 1, 1, C, 2))
        ph = rng.uniform(0, 2 * np.pi, (B, 1, 1, C))
        out += np.sin(xx[None, ..., None] * f[..., 0] + yy[None, ..., None] * f[..., 1] + ph)
    return (127.5 + 127.5 * out / 4).astype(np.float32)


def _quads(seed=1, B=2, K=5, H=72, W=120):
    """Rotated, slightly perspective word quads TL TR BR BL, some past the
    page edge."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, W, (B, K))
    cy = rng.uniform(0, H, (B, K))
    hw = rng.uniform(8, 40, (B, K))
    hh = rng.uniform(3, 10, (B, K))
    th = rng.uniform(-0.6, 0.6, (B, K))
    u = np.array([-1, 1, 1, -1], np.float64)[None, None] * hw[..., None]
    v = np.array([-1, -1, 1, 1], np.float64)[None, None] * hh[..., None]
    u = u * (1 + 0.1 * rng.standard_normal((B, K, 4)))
    c, s = np.cos(th)[..., None], np.sin(th)[..., None]
    x = cx[..., None] + u * c - v * s
    y = cy[..., None] + u * s + v * c
    return np.stack([x, y], -1).astype(np.float32)


def test_normalize_matches_jax():
    p = _pages()
    np.testing.assert_allclose(
        image.normalize(torch.from_numpy(p)).numpy(),
        np.asarray(jax_image.normalize(jnp.asarray(p))), rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize("aspect", ["stretch", "preserve_h"])
def test_crop_resize_boxes_matches_jax(aspect):
    p = _pages(2)
    q = _quads(3)
    boxes = np.stack([q[..., 0].min(-1), q[..., 1].min(-1),
                      q[..., 0].max(-1), q[..., 1].max(-1)], -1)
    boxes = np.clip(boxes, 0, [119, 71, 120, 72]).astype(np.float32)
    ref = jax_image.crop_resize_boxes(jnp.asarray(p), jnp.asarray(boxes), (32, 100),
                                      aspect=aspect)
    got = image.crop_resize_boxes(torch.from_numpy(p), torch.from_numpy(boxes), (32, 100),
                                  aspect=aspect)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


def test_perspective_matrices_match_jax():
    q = _quads(4, B=1, K=6)[0]
    out_w = np.array([100, 37, 2, 64, 80, 11], np.float32)
    got = image.perspective_matrix_from_quad(torch.from_numpy(q), (32, 100)).numpy()
    got_w = image.perspective_matrix_from_quad_w(torch.from_numpy(q), 32,
                                                 torch.from_numpy(out_w)).numpy()
    for k in range(len(q)):
        ref = np.asarray(jax_image.perspective_matrix_from_quad(jnp.asarray(q[k]), (32, 100)))
        ref_w = np.asarray(jax_image.perspective_matrix_from_quad_w(
            jnp.asarray(q[k]), 32, jnp.float32(out_w[k])))
        np.testing.assert_allclose(got[k], ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_w[k], ref_w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("aspect,chunk", [("preserve_h", 32), ("preserve_h", 4),
                                          ("stretch", 32)])
def test_rectify_quads_mxu_matches_jax(aspect, chunk):
    p = _pages(5)
    q = _quads(6)
    ref = jax_image.rectify_quads_mxu(jnp.asarray(p), jnp.asarray(q), (32, 100),
                                      chunk=chunk, aspect=aspect)
    got = image.rectify_quads_mxu(torch.from_numpy(p), torch.from_numpy(q), (32, 100),
                                  chunk=chunk, aspect=aspect)
    assert got.shape == (2, 5, 32, 100, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


def test_rectify_bilinear_warp_is_not_ported():
    """The ruled-surface warp is ported (against JAX on the smooth pages here;
    on chain band quads in ``test_torch_port_chains.py``); what it still
    refuses, as the JAX function does, is ``aspect='preserve_h'``, and an
    unknown warp raises."""
    p = _pages(5)
    q = _quads(6)
    ref = jax_image.rectify_quads_mxu(jnp.asarray(p), jnp.asarray(q), (32, 100), chunk=4,
                                      warp="bilinear")
    got = image.rectify_quads_mxu(torch.from_numpy(p), torch.from_numpy(q), (32, 100),
                                  chunk=4, warp="bilinear")
    assert got.shape == (2, 5, 32, 100, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)
    with pytest.raises(ValueError, match="stretch"):
        image.rectify_quads_mxu(torch.zeros(1, 8, 8, 3), torch.zeros(1, 1, 4, 2), (4, 8),
                                warp="bilinear", aspect="preserve_h")
    with pytest.raises(ValueError, match="unknown warp"):
        image.rectify_quads_mxu(torch.zeros(1, 8, 8, 3), torch.zeros(1, 1, 4, 2), (4, 8),
                                warp="thin_plate")


THETAS = [0.0, 0.1, -0.1, 0.5, -0.5]


@pytest.mark.parametrize("theta", THETAS)
def test_rotate_crops_matches_jax(theta):
    """The three-shear deskew on smooth 32x100 crops: each crop turned by
    ``theta`` and by a mix of the angles, within ATOL_PX of JAX."""
    crops = _pages(7, shape=(5, 32, 100, 3))
    for th in (np.full(5, theta, np.float32), np.roll(np.array(THETAS, np.float32),
                                                      THETAS.index(theta))):
        ref = jax_image.rotate_crops(jnp.asarray(crops), jnp.asarray(th))
        got = image.rotate_crops(torch.from_numpy(crops), torch.from_numpy(th))
        assert got.shape == crops.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_shears_match_jax(axis):
    crops = _pages(8, shape=(3, 24, 40, 3))
    n = crops.shape[1] if axis == "x" else crops.shape[2]
    shift = np.random.default_rng(9).uniform(-6, 6, (3, n)).astype(np.float32)
    jfn = getattr(jax_image, f"_shear_{axis}")
    fn = getattr(image, f"_shear_{axis}")
    ref = jfn(jnp.asarray(crops), jnp.asarray(shift))
    got = fn(torch.from_numpy(crops), torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


def test_rotate_crops_deskews_with_plus_theta():
    """The sign: a bar drawn along +theta comes out level (all its mass in
    few rows), and -theta tilts it further."""
    H, W = 32, 100
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    th = 0.3
    v = -(xx - (W - 1) / 2) * np.sin(th) + (yy - (H - 1) / 2) * np.cos(th)
    bar = np.repeat((np.abs(v) <= 2.0).astype(np.float32)[None, ..., None] * 255, 3, -1)
    level = image.rotate_crops(torch.from_numpy(bar), torch.tensor([th]))[0, ..., 0]
    worse = image.rotate_crops(torch.from_numpy(bar), torch.tensor([-th]))[0, ..., 0]

    def rows(img):  # rows that hold the bar in the middle columns
        mass = img[:, 30:70].sum(1)
        return int((mass > 0.25 * mass.max()).sum())

    assert rows(level) <= 7 < rows(worse)
