"""The port's deformable convs and deformable RoI pooling
(``megreader_tpu_torch/models/deform.py``) against the JAX package's
``models/deform.py``, on the CPU.

* ``deform_sample`` at offsets 0, at integers (+-1, +-2), at exactly +-R,
  beyond +-R and at random fractional values: the samples in float32 (rtol
  1e-4 / atol 1e-5, ``tests/test_deform.py``'s), the gradients with respect
  to x, the offsets and the modulation in float64 (rtol 1e-9). At integer
  positions JAX's derivative is ``0.5 x[n+1] - x[n] - 0.5 x[n-1]`` (its
  ``abs'(0) = 1`` and ``maximum``'s tie split), and its clip passes half the
  gradient at exactly +-R; plain autograd through a gather differs there,
  which the test shows too.
* ``DeformableConv`` at stride (1, 1) and (2, 2), the DCN ResNet, the DCN
  ``CTCRecognizer`` and ``SegDetector(dcn_stages=(3, 4))`` on weights
  carried from flax (``seeded_flax_variables``: the offset convs non-zero, so
  the offsets are fractional and some lie beyond +-2).
* One float64 train step of a DCN detector against JAX's (loss, every
  gradient leaf, batch_stats), one offset conv zeroed (the first step of
  every training run: all offsets on the kinks) and one seeded.
* ``roi_pool_bilinear`` on RoIs across each border and narrower than 0.1,
  with and without bin offsets (values and float64 gradients);
  ``DeformRoIPooling`` zero-initialised (0.5 x RoI align) and perturbed.
* ``dcn_offset_saturation``; the bf16 dtypes through a DCN block (mixed
  precision and the serving cast, each stage's dtype against flax's
  ``capture_intermediates``); int8 serving of the DCN detector, whose
  offset convs are quantized and whose deformable contraction stays float.
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import deform as jd
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.models.recognizer import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.resnet import BasicBlock as JaxBasicBlock
from megreader_tpu.models.resnet import ResNet as JaxResNet
from megreader_tpu.ops import quantize as jq
from megreader_tpu.ops.precision import cast_floats as jax_cast_floats
from megreader_tpu_torch.compat.weights import (
    _flax_module_path,
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models import deform
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.models.resnet import BasicBlock, ResNet
from megreader_tpu_torch.ops import quantize as q
from megreader_tpu_torch.ops.precision import cast_floats

RTOL, ATOL = 1e-4, 1e-5
DET = dict(fpn_dim=32, head_dim=16, width=16)
B, C, K = 2, 3, 9


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, ref, rtol, atol):
    got, ref = dict(_flat(got)), dict(_flat(jax.device_get(ref)))
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol,
                                   err_msg="/".join(key))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _offsets(kind, rng, shape):
    if kind == "zero":
        return np.zeros(shape)
    if kind == "integer":
        return rng.integers(-2, 3, shape).astype(np.float64)
    if kind == "at_R":
        return 2.0 * np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    if kind == "beyond_R":
        return rng.choice([-1.0, 1.0], shape) * rng.uniform(2.0, 5.0, shape)
    return rng.uniform(-2.5, 2.5, shape)


OFFSET_KINDS = ("zero", "integer", "at_R", "beyond_R", "fractional")


@pytest.fixture(scope="module")
def samples():
    """Both packages' samples (float32) and gradients (float64) on one batch
    of pages, page i with offsets of kind i. JAX runs eagerly: its shifted
    multiply-adds make a graph that takes XLA on the CPU minutes to compile."""
    rng = np.random.default_rng(0)
    n, H, W = len(OFFSET_KINDS), 6, 7
    x = rng.random((n, H, W, C))
    off = np.stack([_offsets(kind, rng, (H, W, 2 * K)) for kind in OFFSET_KINDS])
    mod = rng.random((n, H, W, K))
    w = rng.standard_normal((n, H, W, K, C))
    ref = jd.deform_sample(*(jnp.asarray(a, jnp.float32) for a in (x, off, mod)))
    got = deform.deform_sample(*(torch.tensor(a, dtype=torch.float32) for a in (x, off, mod)))
    with jax.enable_x64(True):
        ref_grads = jax.grad(lambda *a: jnp.sum(jd.deform_sample(*a) * w), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (x, off, mod)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, off, mod)]
    (deform.deform_sample(*args) * torch.from_numpy(w)).sum().backward()
    return (np.asarray(ref), got, [np.asarray(r) for r in ref_grads],
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize("kind", OFFSET_KINDS)
def test_deform_sample_matches_jax(samples, kind):
    i = OFFSET_KINDS.index(kind)
    ref, got, ref_grads, grads = samples
    assert got.dtype == torch.float32 and got.shape == (len(OFFSET_KINDS), 6, 7, K, C)
    np.testing.assert_allclose(got[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)
    for name, g, r in zip(("x", "offsets", "modulation"), grads, ref_grads):
        np.testing.assert_allclose(g[i], r[i], rtol=1e-9, atol=1e-12, err_msg=name)


def test_kink_gradient_is_not_the_bilinear_derivative():
    """At offset 0 the offsets' gradient is JAX's three-tap difference,
    written out here, and not the one-sided difference plain autograd
    through a gather takes."""
    rng = np.random.default_rng(11)
    x = rng.random((1, 5, 5, 1))
    off = torch.zeros((1, 5, 5, 2 * K), dtype=torch.float64, requires_grad=True)
    deform.deform_sample(torch.from_numpy(x), off, torch.ones((1, 5, 5, K),
                                                              dtype=torch.float64)
                         )[0, 2, 2, 4, 0].backward()  # the centre tap of the centre pixel
    col = np.pad(x[0, :, 2, 0], 1)  # rows 1..5 of column 2, zero outside
    want_dy = 0.5 * col[2 + 2] - col[2 + 1] - 0.5 * col[2]
    assert off.grad[0, 2, 2, 8].item() == pytest.approx(want_dy, abs=1e-15)
    one_sided = col[2 + 2] - col[2 + 1]
    assert abs(want_dy - one_sided) > 1e-3


def _carry(jax_module, port_module, example, seed=3, **init_kw):
    abstract = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), example, **init_kw)
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), seed)
    load_flax_variables(port_module, variables)
    return variables


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)], ids=str)
def test_deformable_conv_matches_jax(stride):
    """Outputs against JAX; gradients in float32 (JAX's float64 gradient of
    the flax module aborts XLA on the CPU in eager mode, and jitted it
    compiles for a minute) for stride 1, and for stride 2 as the stride-1
    gradient with the upstream gradient scattered onto the kept pixels."""
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((B, 9, 8, 4))).astype(np.float32)
    jm = jd.DeformableConv(features=6, stride=stride)
    tm = deform.DeformableConv(4, 6, stride=stride)
    variables = _carry(jm, tm, jnp.asarray(x))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    ref = jm.apply(variables, jnp.asarray(x))
    got = tm(nchw).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # offsets fractional, some beyond the clip: the comparison covers both
    off = tm.offsets_and_modulation(nchw)[0]
    assert 0 < float((off.abs() > 2).float().mean()) < 0.5

    w = rng.standard_normal(ref.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    grads = export_flax_variables(tm, {n: p.grad for n, p in tm.named_parameters()})
    if stride == (1, 1):
        gv, gx = jax.grad(lambda v, a: jnp.sum(jm.apply(v, a) * w), argnums=(0, 1))(
            variables, jnp.asarray(x))
        for key, r in _flat(gv["params"]):
            g = dict(_flat(grads["params"]))[key]
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4 * np.abs(r).max(),
                                       err_msg="/".join(key))
        np.testing.assert_allclose(nchw.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                                   rtol=1e-3, atol=1e-4 * np.abs(np.asarray(gx)).max())
        return
    full = deform.DeformableConv(4, 6)
    full.load_state_dict(tm.state_dict())
    x1 = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    w1 = np.zeros((B, 9, 8, 6), np.float32)
    w1[:, ::2, ::2] = w
    (full(x1).permute(0, 2, 3, 1) * torch.from_numpy(w1)).sum().backward()
    for n, p in full.named_parameters():
        torch.testing.assert_close(dict(tm.named_parameters())[n].grad, p.grad, rtol=0, atol=0)
    torch.testing.assert_close(nchw.grad, x1.grad, rtol=0, atol=0)


def _model_case(name):
    """(JAX module, port module, input, JAX apply, port apply)."""
    rng = np.random.default_rng(4)
    if name == "resnet":
        x = rng.random((B, 48, 48, 3)).astype(np.float32)
        jm = JaxResNet(block=JaxBasicBlock, stage_sizes=(1, 1, 1, 1), variant="det", width=8,
                       dcn_stages=(3, 4))
        tm = ResNet((1, 1, 1, 1), "det", width=8, dcn_stages=(3, 4)).eval()
        return jm, tm, x, (lambda v, a: jm.apply(v, a)), (lambda a: tuple(
            f.permute(0, 2, 3, 1) for f in tm(a.permute(0, 3, 1, 2))))
    if name == "ctc_recognizer":
        x = rng.standard_normal((B, 32, 100, 3)).astype(np.float32)
        kw = dict(num_classes=12, hidden=16, num_encoder_layers=1, dcn_stages=(4,))
        jm, tm = JaxCTCRecognizer(**kw).net, CTCRecognizer(**kw, device="cpu").net
        return jm, tm, x, (lambda v, a: jm.apply(v, a, train=False)), tm
    x = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    jm = JaxSegDetector(**DET, dcn_stages=(3, 4)).net
    tm = SegDetector(**DET, dcn_stages=(3, 4), device="cpu").net
    return (jm, tm, x, (lambda v, a: jm.apply(v, a, train=False)),
            (lambda a: tm(a)))


@pytest.mark.parametrize("name", ["resnet", "ctc_recognizer", "seg_detector"])
def test_dcn_models_match_jax(name):
    jm, tm, x, japply, tapply = _model_case(name)
    variables = _carry(jm, tm, jnp.asarray(x))
    for path in (("layer3_block0", "conv2"), ("layer4_block0", "conv2")):
        trunk = variables["params"].get("ResNet_0", variables["params"])
        if name == "ctc_recognizer" and path[0] == "layer3_block0":
            assert "offset_conv" not in trunk[path[0]][path[1]]
            continue
        assert {"offset_conv", "kernel"} == set(trunk[path[0]][path[1]])
    ref = jax.tree_util.tree_leaves(japply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tapply(torch.from_numpy(x))
    got = [got[k] for k in sorted(got)] if isinstance(got, dict) else (
        list(got) if isinstance(got, tuple) else [got])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    # the export inverts the load, the deformable kernels included
    _assert_trees_close(export_flax_variables(tm), variables, rtol=0, atol=0)


def _det_batch(H=64, W=64):
    rng = np.random.default_rng(6)
    gt = np.zeros((B, H, W))
    gt[:, 10:20, 8:40] = 1.0
    gt[1, 40:52, 20:60] = 1.0
    thresh_mask = np.zeros((B, H, W))
    thresh_mask[:, 6:24, 4:44] = 1.0
    return {"image": rng.standard_normal((B, H, W, 3)), "gt": gt, "mask": np.ones((B, H, W)),
            "thresh_map": rng.uniform(0.3, 0.7, (B, H, W)), "thresh_mask": thresh_mask}


@pytest.fixture(scope="module")
def dcn_step():
    """One float64 train step of a DCN detector on both sides: deformable
    stage 4, its first block's offset conv zeroed (every offset on the
    kinks, as at a run's first step) and its second block's seeded. (JAX's
    float64 step of the (3, 4) detector takes XLA on the CPU about three
    minutes to compile, the (4,) one one; the forwards above cover (3, 4).)"""
    jm = JaxSegDetector(**DET, dcn_stages=(4,))
    tm = SegDetector(**DET, dcn_stages=(4,), device="cpu")
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 9)
    for leaf in variables["params"]["ResNet_0"]["layer4_block0"]["conv2"]["offset_conv"].values():
        leaf[...] = 0.0
    load_flax_variables(tm.net, variables)
    batch = _det_batch()

    def loss_fn(params, batch_stats, batch):
        loss, (metrics, new_state) = jm.loss(
            {"params": params, "batch_stats": batch_stats}, batch, train=True)
        return loss, (metrics, new_state["batch_stats"])

    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        v64 = _f64(variables)
        (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"], batch)
        ref = jax.device_get({"loss": loss, "metrics": metrics, "stats": stats,
                              "grads": grads})
    tm.net.double()
    loss, port_metrics = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                 train=True)
    loss.backward()
    got = {"loss": float(loss.detach()), "metrics": port_metrics,
           "grads": export_flax_variables(tm.net, {n: p.grad for n, p in
                                                   tm.net.named_parameters()}),
           "variables": export_flax_variables(tm.net)}
    return ref, got


def test_dcn_detector_train_step_matches_jax(dcn_step):
    ref, got = dcn_step
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=0, atol=1e-5)
    for k in ("bce", "dice", "thresh_l1"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(ref["metrics"][k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    _assert_trees_close(got["grads"]["params"], ref["grads"], rtol=1e-3, atol=1e-6)
    _assert_trees_close(got["variables"]["batch_stats"], ref["stats"], rtol=0, atol=1e-6)
    # the zeroed offset convs got a gradient (through the kinks)
    oc = got["grads"]["params"]["ResNet_0"]["layer4_block0"]["conv2"]["offset_conv"]
    assert np.abs(oc["kernel"]).max() > 1e-6


#: RoIs (x0, y0, x1, y1) on a 16x16 map: inside, across each border, a
#: corner beyond the map, narrower than 0.1 both ways, and a reversed one
ROIS = np.array([[1.0, 1.0, 12.0, 13.0], [-4.0, 3.0, 6.0, 9.0], [9.0, -5.0, 14.0, 4.0],
                 [10.0, 6.0, 19.0, 12.0], [2.0, 11.0, 8.0, 21.0], [13.0, 13.0, 20.0, 22.0],
                 [7.0, 7.0, 7.05, 7.02], [5.0, 9.0, 3.0, 8.0]])


@pytest.mark.parametrize("with_offsets", [False, True], ids=["align", "offsets"])
def test_roi_pool_bilinear_matches_jax(with_offsets):
    rng = np.random.default_rng(7)
    feat = rng.random((B, 16, 16, 5))
    rois = np.stack([ROIS, ROIS[::-1] + 0.37])
    offs = 0.3 * rng.standard_normal((B, len(ROIS), 3, 4, 2)) if with_offsets else None
    w = rng.standard_normal((B, len(ROIS), 3, 4, 5))
    for b in range(B):  # the JAX function pools one page
        f32 = lambda a: None if a is None else jnp.asarray(a, jnp.float32)  # noqa: E731
        ref = jd.roi_pool_bilinear(f32(feat[b]), f32(rois[b]),
                                   f32(None if offs is None else offs[b]), (3, 4), 2, 0.9)
        got = deform.roi_pool_bilinear(
            torch.tensor(feat[b:b + 1], dtype=torch.float32),
            torch.tensor(rois[b:b + 1], dtype=torch.float32),
            None if offs is None else torch.tensor(offs[b:b + 1], dtype=torch.float32),
            (3, 4), 2, 0.9)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # the batched port against the JAX function per page, gradients in float64
    with jax.enable_x64(True):
        def jloss(f, o):
            return sum(jnp.sum(jd.roi_pool_bilinear(f[b], jnp.asarray(rois[b]),
                                                    None if o is None else o[b], (3, 4), 2,
                                                    0.9) * w[b]) for b in range(B))
        gf, go = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(feat), None if offs is None else jnp.asarray(offs))
    tf = torch.tensor(feat, requires_grad=True)
    to = None if offs is None else torch.tensor(offs, requires_grad=True)
    (deform.roi_pool_bilinear(tf, torch.from_numpy(rois), to, (3, 4), 2, 0.9)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=1e-9, atol=1e-12)
    if offs is not None:
        np.testing.assert_allclose(to.grad.numpy(), np.asarray(go), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("perturbed", [False, True], ids=["zero_init", "perturbed"])
def test_deform_roi_pooling_matches_jax(perturbed):
    rng = np.random.default_rng(8)
    feat = rng.random((B, 16, 16, 6)).astype(np.float32)
    rois = np.stack([ROIS, ROIS + 1.5]).astype(np.float32)
    jm = jd.DeformRoIPooling(out_size=(2, 4), sample_ratio=2, hidden=8)
    tm = deform.DeformRoIPooling(6, (2, 4), sample_ratio=2, hidden=8)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(feat[0]),
                                       jnp.asarray(rois[0])))
    if perturbed:
        variables = seeded_flax_variables(variables, 5)
    load_flax_variables(tm, variables)
    if not perturbed:
        base = deform.roi_pool_bilinear(torch.from_numpy(feat), torch.from_numpy(rois), None,
                                        (2, 4), 2)
        got = tm(torch.from_numpy(feat), torch.from_numpy(rois))
        np.testing.assert_allclose(got.detach().numpy(), 0.5 * base.numpy(), rtol=1e-6)
    apply = jax.vmap(lambda v, f, r: jm.apply(v, f, r), in_axes=(None, 0, 0))
    ref = apply(variables, jnp.asarray(feat), jnp.asarray(rois))
    got = tm(torch.from_numpy(feat), torch.from_numpy(rois))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    w = rng.standard_normal(ref.shape)
    with jax.enable_x64(True):
        r64 = jnp.asarray(rois, jnp.float64)
        gv, gf = jax.jit(jax.grad(lambda v, f: jnp.sum(apply(v, f, r64) * w),
                                  argnums=(0, 1)))(_f64(variables), jnp.asarray(feat, jnp.float64))
    tm = tm.double()
    f64 = torch.tensor(feat, dtype=torch.float64, requires_grad=True)
    (tm(f64, torch.from_numpy(rois)) * torch.from_numpy(w)).sum().backward()
    grads = export_flax_variables(tm, {n: p.grad for n, p in tm.named_parameters()})
    _assert_trees_close(grads["params"], gv["params"], rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(f64.grad.numpy(), np.asarray(gf), rtol=1e-8, atol=1e-11)


def test_dcn_offset_saturation_matches_jax():
    rng = np.random.default_rng(10)
    for off in (np.zeros((1, 4, 4, 18), np.float32),
                (1.5 * rng.standard_normal((2, 33, 29, 18))).astype(np.float32),
                np.full((1, 1, 1, 1), 3.0, np.float32)):
        ref = jd.dcn_offset_saturation(jnp.asarray(off), max_offset=2)
        got = deform.dcn_offset_saturation(torch.from_numpy(off).permute(0, 3, 1, 2), 2)
        for k in ("frac_clipped", "max_abs", "p99_abs"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["mixed", "serving_cast"])
def test_dcn_block_dtypes_follow_jax(mode):
    """Mixed precision: the deformable conv's output float32 (no dtype, it
    promotes), the block's output bf16 (``_bn(..., dt)``); under the serving
    cast every stage bf16. Values within 2e-2 of their largest magnitude."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 8, 8, 16)).astype(np.float32)
    mixed = mode == "mixed"
    jm = JaxBasicBlock(features=16, use_dcn=True, dtype=jnp.bfloat16 if mixed else None)
    tm = BasicBlock(16, 16, dtype=torch.bfloat16 if mixed else None, use_dcn=True)
    variables = _carry(jm, tm, jnp.asarray(x), seed=12)
    xin = jnp.asarray(x, jnp.bfloat16)
    if not mixed:
        variables = jax_cast_floats(variables, jnp.bfloat16)
        tm = cast_floats(tm, torch.bfloat16)
    ref, inter = jm.apply(variables, xin, capture_intermediates=True,
                          mutable=["intermediates"])
    seen = {}
    hook = tm.conv2.register_forward_hook(lambda m, a, o: seen.setdefault("conv2", o))
    got = tm.eval()(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    hook.remove()
    want_conv2 = inter["intermediates"]["conv2"]["__call__"][0].dtype
    assert str(seen["conv2"].dtype).split(".")[-1] == str(want_conv2)
    assert seen["conv2"].dtype == (torch.float32 if mixed else torch.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    r = np.asarray(ref, np.float32)
    g = got.float().permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max()


@pytest.mark.parametrize("stages", [(3, 4), (4,)], ids=str)
def test_dcn_detector_int8_quantizes_the_offset_convs_as_jax(stages):
    """The layers int8 serving swaps equal JAX's interceptor set (the
    offset convs among them, the raw deformable kernels not); with stage 4
    deformable, the int8 prob map in float64 lies well inside JAX's own
    int8-vs-float distance from JAX's int8 map (JAX's float64 DCN forwards
    take a minute on the CPU at (3, 4))."""
    jm = JaxSegDetector(**DET, dcn_stages=stages)
    tm = SegDetector(**DET, dcn_stages=stages, device="cpu")
    x = np.random.default_rng(13).standard_normal((B, 64, 64, 3)).astype(np.float32)
    variables = seeded_flax_variables(export_flax_variables(tm.net), 13)
    load_flax_variables(tm.net, variables)
    seen = set()

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and type(mod) in (flax.linen.Conv,
                                                               flax.linen.Dense):
            seen.add(tuple(mod.path))
        return next_fun(*args, **kwargs)

    with flax.linen.intercept_methods(record):
        jax.eval_shape(lambda v, a: jm.net.apply(v, a, train=False), variables, x)
    got = {_flax_module_path(name) for name, _ in q.int8_layers(tm.net)}
    assert got == seen
    assert ("ResNet_0", "layer4_block1", "conv2", "offset_conv") in got
    if stages != (4,):
        return
    japply = lambda v, a: jm.net.apply(v, a, train=False, heads=("prob",))["prob"]  # noqa
    with jax.enable_x64(True):
        v64, x64 = _f64(variables), x.astype(np.float64)
        ref = np.asarray(jax.jit(japply)(v64, x64))
        ref8 = np.asarray(jax.jit(jq.int8_methods(japply))(v64, x64))
    net = copy.deepcopy(tm.net).double()
    with torch.no_grad(), q.int8_context(net):
        got8 = net.eval()(torch.from_numpy(x64), heads=("prob",))["prob"].numpy()
    jax_gap = np.abs(ref8 - ref).max()
    assert 0 < jax_gap and np.abs(got8 - ref8).max() * 1000 <= jax_gap
