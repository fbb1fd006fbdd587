"""The Bottleneck trunks (ResNet-50/101, DB's deformable ResNet-50) against
the JAX package, on the CPU.

Weights are drawn by ``seeded_flax_variables`` on the flax tree and carried
into the port. Forwards run in float32, eagerly where a deformable conv is
involved (ROADMAP Queue 3: JAX's DCN graphs on the CPU), at the tolerance
``tests/test_torch_port_deform.py`` uses for the same components (rtol 1e-4,
atol 1e-5; ``tests/test_deform.py``'s): a Bottleneck block plain, strided,
deformable and deformable-strided, in eval mode and in train mode with its
BatchNorm statistics; the ``resnet50``/``resnet101`` detection pyramids at
width 8; the DB detector
``SegDetector(backbone='resnet50', dcn_stages=(2, 3, 4))`` at width 8;
``CTCRecognizer(backbone='resnet50')`` (its trunk at the width both packages
build it, 64); and ``Ctc2dRecognizer(backbone='resnet50')`` at width 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models import deform as jd
from megreader_tpu.models import resnet as jr
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models import resnet
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer

RTOL, ATOL = 1e-4, 1e-5


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _carry(jax_module, port_module, x, seed=3, **kw):
    abstract = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), x, **kw)
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), seed)
    load_flax_variables(port_module, variables)
    return variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


BLOCKS = {"plain": ((1, 1), False), "strided": ((2, 2), False), "dcn": ((1, 1), True),
          "dcn-strided": ((2, 2), True)}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bottleneck_block_matches_jax(name):
    """One block, 8 channels in, features 4 (16 out: a projection in every
    case), on a 9x11 map (odd: the strided conv and the subsampled DCN must
    agree on the last row and column)."""
    stride, dcn = BLOCKS[name]
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 8)).astype(np.float32)
    jm = jr.Bottleneck(features=4, stride=stride, use_dcn=dcn)
    tm = resnet.Bottleneck(8, 4, stride, use_dcn=dcn)
    variables = _carry(jm, tm, jnp.asarray(x))
    assert ("offset_conv" in variables["params"]["conv2"]) == dcn
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 5 if stride[0] == 2 else 9, 6 if stride[0] == 2 else 11,
                                      16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # train mode: the batch's statistics, and the running ones moved as flax moves them
    ref, state = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got_stats = dict(_flat(export_flax_variables(tm)["batch_stats"]))
    for key, r in _flat(jax.device_get(state["batch_stats"])):
        np.testing.assert_allclose(got_stats[key], r, rtol=RTOL, atol=ATOL, err_msg="/".join(key))


@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_bottleneck_pyramids_match_jax(name):
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    jm = jr.resnet_variant(name, "det", width=8)
    tm = resnet.resnet_variant(name, "det", width=8).eval()
    assert tm.out_channels == [32, 64, 128, 256]
    variables = _carry(jm, tm, jnp.asarray(x))
    n_blocks = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}[name]
    for i, n in enumerate(n_blocks):
        assert f"layer{i + 1}_block{n - 1}" in variables["params"]
        assert f"layer{i + 1}_block{n}" not in variables["params"]
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert [tuple(g.shape) for g in got] == [(1, 32, 16, 16), (1, 64, 8, 8), (1, 128, 4, 4),
                                             (1, 256, 2, 2)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def test_full_width_resnet50_lateral_channels():
    net = SegDetector(backbone="resnet50", dcn_stages=(2, 3, 4), device="cpu").net
    assert net.backbone.out_channels == [256, 512, 1024, 2048]
    assert [m.in_channels for m in (net.fpn.lat2, net.fpn.lat3, net.fpn.lat4, net.fpn.lat5)] \
        == [256, 512, 1024, 2048]
    assert sum(isinstance(m, resnet.Bottleneck) for m in net.modules()) == 16


def test_deformable_resnet50_db_detector_matches_jax(monkeypatch):
    """DB's deformable ResNet-50 detector (``dcn_stages=(2, 3, 4)``) at width
    8: prob, thresh and binary maps. The flax net runs eagerly with JAX's
    ``deform_sample`` jitted once a shape (eagerly, its 13 deformable convs
    take a minute on the CPU)."""
    kw = dict(backbone="resnet50", dcn_stages=(2, 3, 4), fpn_dim=16, head_dim=8, width=8)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    sampler = jax.jit(jd.deform_sample, static_argnames=("kernel", "max_offset"))
    monkeypatch.setattr(jd, "deform_sample", lambda *a, **k: sampler(*a, **k))
    jm = JaxSegDetector(**kw).net
    tm = SegDetector(**kw, device="cpu").net
    variables = _carry(jm, tm, jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_resnet50_ctc_recognizer_matches_jax():
    kw = dict(num_classes=12, backbone="resnet50", hidden=16, num_encoder_layers=1)
    x = np.random.default_rng(5).standard_normal((2, 32, 100, 3)).astype(np.float32)
    jm = JaxCTCRecognizer(**kw).net
    tm = CTCRecognizer(**kw, device="cpu").net
    variables = _carry(jm, tm, jnp.asarray(x))
    assert variables["params"]["encoder"]["layer0"]["fwd"]["w_ih"].shape[1] == 2048
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_resnet50_rec2d_recognizer_matches_jax():
    """The 2D-CTC recognizer on a ResNet-50 rec2d trunk at width 8: every
    head's output (the 'rec2d' variant keeps 4 rows of a 32x100 crop)."""
    from megreader_tpu.models import Ctc2dRecognizer as JaxCtc2dRecognizer
    from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer

    kw = dict(num_classes=12, backbone="resnet50", width=8)
    x = np.random.default_rng(6).standard_normal((2, 32, 100, 3)).astype(np.float32)
    jm = JaxCtc2dRecognizer(**kw).net
    tm = Ctc2dRecognizer(**kw, device="cpu").net
    variables = _carry(jm, tm, jnp.asarray(x))
    ref = jax.tree_util.tree_leaves(
        jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    got = [got[k] for k in sorted(got)] if isinstance(got, dict) else (
        list(got) if isinstance(got, tuple) else [got])
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
