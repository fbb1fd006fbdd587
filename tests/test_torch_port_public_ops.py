"""The port's public ops (``megreader_tpu_torch.ops``) against the JAX
package's: a counterpart of every name ``megreader_tpu.ops`` exports, and
the three it lacked until now, ``resize_matrix``, ``resize_bilinear`` and
``rectify_quads`` (the gather form), held to JAX on the same inputs (rtol
and atol 1e-5, float32) and to cv2 at the JAX tests' own bounds
(``tests/test_image_ops.py``: 1e-4 for the resizes, 1e-3 inside a 2-pixel
border for the warp)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megreader_tpu.ops as jax_ops
import megreader_tpu_torch.ops as ops
from megreader_tpu.ops import image as jax_image

#: the JAX package's Pallas losses -> the port's losses on its CUDA kernels
RENAMED = {"ctc_loss_pallas": "ctc_nll_cuda",
           "ctc2d_loss_markov_pallas": "ctc2d_nll_markov_cuda"}


def test_every_jax_op_has_a_counterpart():
    for name in jax_ops.__all__:
        port_name = RENAMED.get(name, name)
        assert port_name in ops.__all__ and callable(getattr(ops, port_name)), name
    assert not any(n.endswith("_pallas") for n in ops.__all__)
    for name in ("resize_matrix", "resize_bilinear", "rectify_quads"):
        assert callable(getattr(ops, name))


@pytest.mark.parametrize("src_hw,dst_hw", [((40, 60), (32, 100)), ((720, 1280), (640, 640)),
                                           ((16, 20), (32, 64))])
def test_resize_matrix_matches_jax(src_hw, dst_hw):
    np.testing.assert_allclose(ops.resize_matrix(src_hw, dst_hw).numpy(),
                               np.asarray(jax_image.resize_matrix(src_hw, dst_hw)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [((1, 40, 60, 3), (32, 100)), ((1, 16, 20, 1), (32, 64)),
                                          ((2, 37, 53, 3), (19, 80)), ((3, 8, 8, 2), (8, 8))])
def test_resize_bilinear_matches_jax_and_cv2(shape, out_hw):
    img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = ops.resize_bilinear(torch.from_numpy(img), out_hw).numpy()
    ref = np.asarray(jax_image.resize_bilinear(jnp.asarray(img), out_hw))
    assert got.shape == ref.shape == (shape[0],) + tuple(out_hw) + (shape[3],)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for b in range(shape[0]):
        want = cv2.resize(img[b], (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got[b], want.reshape(got[b].shape), rtol=1e-4, atol=1e-4)


def test_resize_bilinear_takes_uint8_as_float():
    img = np.random.default_rng(7).integers(0, 256, (1, 24, 30, 3), dtype=np.uint8)
    got = ops.resize_bilinear(torch.from_numpy(img), (12, 45))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[0], cv2.resize(img[0].astype(np.float32), (45, 12)),
                               rtol=1e-4, atol=1e-4)


def _dst(out_hw):
    return np.array([[0, 0], [out_hw[1] - 1, 0], [out_hw[1] - 1, out_hw[0] - 1],
                     [0, out_hw[0] - 1]], np.float32)


def test_rectify_quads_matches_cv2_warp():
    """``tests/test_image_ops.py::test_rectify_matches_cv2_warp``'s case."""
    rng = np.random.default_rng(3)
    img = rng.random((64, 96, 3)).astype(np.float32)
    quad = np.array([[10.0, 8.0], [70.0, 12.0], [68.0, 40.0], [8.0, 36.0]], np.float32)
    out_hw = (32, 100)
    got = ops.rectify_quads(torch.from_numpy(img[None]), torch.from_numpy(quad[None, None]),
                            out_hw).numpy()[0, 0]
    Mcv = cv2.getPerspectiveTransform(_dst(out_hw), quad)
    ref = cv2.warpPerspective(img, Mcv, (out_hw[1], out_hw[0]),
                              flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    np.testing.assert_allclose(got[2:-2, 2:-2], ref[2:-2, 2:-2], rtol=1e-3, atol=1e-3)


def test_rectify_quads_matches_jax():
    """A batch of pages with several quads each: rotated, skewed, partly off
    the page (zeros there), and a page-sized one."""
    rng = np.random.default_rng(11)
    B, H, W = 2, 48, 80
    img = rng.random((B, H, W, 3)).astype(np.float32)
    quads = np.array([
        [[[10, 8], [70, 12], [68, 40], [8, 36]], [[-6, -4], [30, 2], [28, 20], [-8, 14]],
         [[0, 0], [79, 0], [79, 47], [0, 47]]],
        [[[40, 5], [90, 25], [80, 50], [30, 30]], [[5, 30], [25, 28], [26, 38], [6, 40]],
         [[12.5, 3.25], [60.75, 9.5], [58.0, 21.0], [10.0, 15.5]]],
    ], np.float32)
    for out_hw in ((32, 100), (16, 48)):
        got = ops.rectify_quads(torch.from_numpy(img), torch.from_numpy(quads), out_hw).numpy()
        ref = np.asarray(jax_image.rectify_quads(jnp.asarray(img), jnp.asarray(quads), out_hw))
        assert got.shape == ref.shape == (B, 3) + out_hw + (3,)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
