"""The detector head's formulations (``models/detector.py::MapHead`` and
``_UpConv``) against the JAX package's, on the CPU.

* Every ``_UpConv`` mode against JAX's same mode on the same kernel and
  bias, and ``'full'`` against ``'naive'``, at the shapes of
  ``tests/test_detector.py::test_upconv_naive_mode_matches_full``: atol 2e-6;
  ``'full'``'s written-out backward against autograd through ``'naive'``
  in float64 (atol 1e-12) and ``gradcheck``.
* Every eval formulation of ``MapHead`` (the plain chain under
  ``fused_upsample=False``, the default packed tail with analytic borders,
  and the fused tail that train mode runs, here with eval BatchNorm) at the
  shapes of ``tests/test_detector.py::test_packed_serving_head_matches_full_path``
  and one page-like shape with odd h and w, with that test's non-identity
  BN statistics: each against JAX's same formulation and against the
  port's plain head, atol 2e-6.
* The composed kernels (one matmul with a stencil table) against the
  three-operand ``einsum`` of the stencils, and the serving kernels'
  composition once per weight version.
* Train mode (the fused tail on the 2x tensor) in float64 on both sides, the
  flax BatchNorm monkeypatched to float64 as ``test_torch_port_detector_train``
  does: the new batch statistics atol 1e-12, the map atol 2e-7 (JAX casts
  its logits to float32 before the sigmoid).
* bf16 (mixed precision) on its own scale: the port's distance from the
  float32 head within twice JAX's own bf16-against-float32 distance plus
  1e-2 of the map (torch rounds each conv's output to bf16 before its
  BatchNorm, where XLA on the CPU keeps float32).
* ``SegDetector`` and ``SharedTrunkSpotter`` serving maps, the default flags
  against ``fused_upsample=False``, and against JAX's default; the trained
  asset's prob map under the default against the plain head; the flag
  through ``from_yaml`` in both packages.
* int8: ``up1``/``up2`` are quantized exactly when ``fused_upsample=False``,
  by flax path as JAX's interceptor sees them; the head under int8 in
  float64 against JAX's ``int8_methods``.
"""

import copy
import functools
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import detector as jdetector
from megreader_tpu.models.spotter import SharedTrunkSpotter as JaxSharedTrunkSpotter
from megreader_tpu.ops import quantize as jq
from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
from megreader_tpu_torch.compat.weights import (
    _flax_module_path,
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models import detector
from megreader_tpu_torch.models.spotter import SharedTrunkSpotter
from megreader_tpu_torch.ops import quantize as q
from megreader_tpu_torch.ops.precision import Conv2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "assets", "bench_det_fp16.msgpack")

UPCONV_SHAPES = [(9, 11, 8, 4), (6, 6, 3, 5)]
MODES = ["full", "naive", "packed_exact", "packed2_exact"]
HEAD_SHAPES = [(12, 10, 16), (7, 9, 8), (37, 45, 16)]
#: formulation name -> JAX's MapHead flags for it; the port's head takes
#: ``fused_upsample`` alone and runs "full" in train mode (``_port_map``)
FORMULATIONS = {
    "plain": dict(fused_upsample=False),
    "full": dict(fused_upsample=True, packed_serving=False),
    "packed_analytic": dict(fused_upsample=True, packed_serving=True, analytic_borders=True),
}
CIN = 32


def _zeros(abstract):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _packed_nchw(a) -> torch.Tensor:
    """JAX's packed (B, H, W, 2, 2, C) -> the port's (B, 4*C, H, W)."""
    a = np.asarray(a)
    B, H, W = a.shape[:3]
    return _nchw(a.reshape(B, H, W, -1))


# --- _UpConv -------------------------------------------------------------------


def _upconv_case(shape, mode):
    h, w, cin, cout = shape
    rng = np.random.default_rng(3)
    packed_in = mode.startswith("packed2")
    x = rng.normal(size=(2, h, w, 2, 2, cin) if packed_in else (2, h, w, cin)).astype(np.float32)
    jmod = jdetector._UpConv(cout)
    variables = seeded_flax_variables(_zeros(jax.eval_shape(
        lambda a: jmod.init(jax.random.PRNGKey(1), a, mode=mode), x)), 4)
    mod = detector._UpConv(cin, cout)
    load_flax_variables(mod, variables)
    return jmod, mod, variables, x, packed_in


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", UPCONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_upconv_mode_matches_jax(shape, mode):
    jmod, mod, variables, x, packed_in = _upconv_case(shape, mode)
    ref = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, mode=mode))(variables, x))
    tx = _packed_nchw(x) if packed_in else _nchw(x)
    with torch.no_grad():
        got = mod(tx, mode=mode)
    ref = _packed_nchw(ref) if mode == "packed_exact" else _nchw(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", UPCONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_upconv_full_matches_naive(shape):
    _, mod, _, x, _ = _upconv_case(shape, "full")
    with torch.no_grad():
        a, b = mod(_nchw(x), mode="full"), mod(_nchw(x), mode="naive")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    assert not torch.equal(a, b)  # two arithmetics, not one


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", UPCONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_tail_gradients_equal_the_naive_chain(shape, bias):
    """``'full'``'s written-out backward against autograd through the
    literal resize -> conv, in float64, on a non-uniform output gradient."""
    h, w, cin, cout = shape
    rng = np.random.default_rng(12)
    mod = detector._UpConv(cin, cout, bias=bias).double()
    with torch.no_grad():
        for prm in mod.parameters():
            prm.copy_(torch.from_numpy(rng.standard_normal(prm.shape)))
    x = torch.from_numpy(rng.standard_normal((2, cin, h, w)))
    go = torch.from_numpy(rng.standard_normal((2, cout, 2 * h, 2 * w)))
    grads = {}
    for mode in ("full", "naive"):
        xin = x.clone().requires_grad_(True)
        mod.zero_grad()
        (mod(xin, mode=mode) * go).sum().backward()
        grads[mode] = [xin.grad] + [prm.grad for prm in mod.parameters()]
    for a, b in zip(grads["full"], grads["naive"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_fused_tail_passes_gradcheck():
    rng = np.random.default_rng(13)
    args = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
            for s in ((1, 2, 3, 4), (3, 2, 3, 3), (3,))]
    assert torch.autograd.gradcheck(detector._FusedUpsampleConv.apply, args)


def test_upconv_refuses_an_unknown_mode():
    mod = detector._UpConv(4, 2)
    with pytest.raises(ValueError, match="mode"):
        mod(torch.zeros(1, 4, 3, 3), mode="packed3")


# --- MapHead -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _head_variables(shape):
    """(x, seeded flax variables, the BN statistics moved further from the
    identity as in test_detector.py)."""
    h, w, dim = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, h, w, CIN)).astype(np.float32)
    variables = seeded_flax_variables(_zeros(jax.eval_shape(
        lambda a: jdetector.MapHead(dim).init(jax.random.PRNGKey(0), a, train=False), x)), 5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * np.abs(rng.normal(size=a.shape)).astype(a.dtype),
        variables["batch_stats"])
    return x, variables


def _jax_head(dim, variables, x, **flags):
    """JAX's eval-mode MapHead map, jitted."""
    head = jdetector.MapHead(dim, **flags)
    return np.asarray(jax.jit(lambda v, a: head.apply(v, a, train=False))(variables, x))


def _port_head(dim, variables, fused_upsample=True, **_jax_only):
    head = detector.MapHead(CIN, dim, fused_upsample=fused_upsample)
    load_flax_variables(head, variables)
    return head.eval()


def _port_map(head, x, name):
    """The eval map of formulation ``name``: "full" is the fused tail that
    train mode runs, here under eval BatchNorm as JAX's ``packed_serving=False``."""
    if name != "full":
        return head(x)
    y = torch.relu(head.bn(head.conv(x)))
    return torch.sigmoid(detector.at_least_float32(head._tail_full(y)[:, 0]))


@pytest.mark.parametrize("name", list(FORMULATIONS))
@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_map_head_formulation_matches_jax_and_the_plain_head(shape, name):
    dim = shape[2]
    x, variables = _head_variables(shape)
    flags = FORMULATIONS[name]
    ref = _jax_head(dim, variables, x, **flags)
    head = _port_head(dim, variables, **flags)
    plain = _port_head(dim, variables, **FORMULATIONS["plain"])
    with torch.no_grad():
        got = _port_map(head, _nchw(x), name)
        want = plain(_nchw(x))
    assert got.shape == (2, 4 * shape[0], 4 * shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    # the statistics stay as loaded in every eval formulation
    for a, b in zip(head.state_dict().values(), _port_head(dim, variables).state_dict().values()):
        assert torch.equal(a, b)


def test_each_formulation_runs_its_own_arithmetic():
    """No two formulations give bit-equal maps (each runs its own
    arithmetic), and each calls ``up2`` once with the whole (B, 1, 4h, 4w)
    pre-sigmoid map."""
    shape = HEAD_SHAPES[0]
    x, variables = _head_variables(shape)
    outs, first = {}, {}
    for name, flags in FORMULATIONS.items():
        head = _port_head(shape[2], variables, **flags)
        seen = []
        hook = head.up2.register_forward_hook(lambda m, a, o: seen.append(o))
        with torch.no_grad():
            outs[name] = _port_map(head, _nchw(x), name)
        hook.remove()
        first[name] = seen[0]
        assert seen[0].shape == (2, 1, 4 * shape[0], 4 * shape[1])
        assert len(seen) == 1
    names = list(outs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not torch.equal(outs[a], outs[b]), (a, b)
    # the analytic map's first up2 output is the whole map's logit
    torch.testing.assert_close(torch.sigmoid(first["packed_analytic"][:, 0]),
                               outs["packed_analytic"], rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_train_mode_matches_flax_in_float64(fused):
    """Train mode (JAX's ``tail_full`` under ``fused_upsample``) in float64:
    the map and the moved batch statistics."""
    shape = HEAD_SHAPES[1]
    x, variables = _head_variables(shape)
    jhead = jdetector.MapHead(shape[2], fused_upsample=fused)
    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        step = jax.jit(lambda v, a: jhead.apply(v, a, train=True, mutable=["batch_stats"]))
        ref, state = step(f64(variables), x.astype(np.float64))
        ref, state = np.asarray(ref), jax.device_get(state)
    head = detector.MapHead(CIN, shape[2], fused_upsample=fused)
    load_flax_variables(head, variables)
    head.double().train()
    got = head(_nchw(x.astype(np.float64)))
    assert got.dtype == torch.float64
    # JAX casts the logits to float32 before the sigmoid
    assert ref.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=2e-7)
    stats = export_flax_variables(head)["batch_stats"]
    for mod in ("bn", "bn1"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[mod][k], np.asarray(state["batch_stats"][mod][k]),
                                       rtol=0, atol=1e-12, err_msg=f"{mod}/{k}")
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in head.parameters())


@pytest.mark.parametrize("name", list(FORMULATIONS))
def test_bf16_formulations_on_their_own_scale(name):
    shape = HEAD_SHAPES[2]
    dim = shape[2]
    x, variables = _head_variables(shape)
    flags = FORMULATIONS[name]
    j32 = _jax_head(dim, variables, x, **flags)
    j16 = _jax_head(dim, variables, x, dtype=jnp.bfloat16, **flags)
    head16 = detector.MapHead(CIN, dim, dtype=torch.bfloat16,
                              fused_upsample=flags["fused_upsample"])
    load_flax_variables(head16, variables)
    with torch.no_grad():
        got = _port_map(head16.eval(), _nchw(x), name)
    assert got.dtype == torch.float32
    jax_gap = np.abs(j16 - j32).max()
    port_gap = np.abs(got.numpy() - j32).max()
    assert 0 < jax_gap and port_gap <= 2 * jax_gap + 1e-2, (port_gap, jax_gap)


# --- the composed kernels ------------------------------------------------------------


def _einsum_kernel(stage, side, w):
    """The composed kernel as the three-operand ``einsum`` of the stencils
    (the JAX ``_UpConv``'s composition), in the port's packed layouts."""
    if stage == 1:
        taps, bt, bb = (torch.from_numpy(a).to(w.dtype) for a in (
            detector._PHASE_TAPS, detector._BT, detector._BB))
        rows = {"mid": taps, "top": bt, "bot": bb, "left": taps, "right": taps}
        cols = {"mid": taps, "top": taps, "bot": taps, "left": bt, "right": bb}
        if side == "corners":
            K = torch.einsum("npdh,nqew,oide->npqoihw", torch.stack([bt, bt, bb, bb]),
                             torch.stack([bt, bb, bt, bb]), w)
            return K.reshape(4, 4 * w.shape[0], w.shape[1], 2, 2)
        K = torch.einsum("pdh,qew,oide->pqoihw", rows[side], cols[side], w)
        return K.reshape(4 * w.shape[0], w.shape[1], *K.shape[-2:])
    u, vt, vb = (torch.from_numpy(a).to(w.dtype) for a in (
        detector._U2_INT, detector._V2_TOP, detector._V2_BOT))
    rows = {"mid": u, "top": vt, "bot": vb, "left": u, "right": u}
    cols = {"mid": u, "top": u, "bot": u, "left": vt, "right": vb}
    if side == "corners":
        K = torch.einsum("ndhfr,newgs,oide->nrsofgihw", torch.stack([vt, vt, vb, vb]),
                         torch.stack([vt, vb, vt, vb]), w)
        return K.reshape(4, 16 * w.shape[0], 4 * w.shape[1], 2, 2)
    K = torch.einsum("dhfr,ewgs,oide->rsofgihw", rows[side], cols[side], w)
    return K.reshape(16 * w.shape[0], 4 * w.shape[1], *K.shape[-2:])


@pytest.mark.parametrize("side", ["mid", "top", "bot", "left", "right", "corners"])
@pytest.mark.parametrize("stage", [1, 2])
def test_composed_kernels_equal_the_einsum_of_the_stencils(stage, side):
    w = torch.from_numpy(np.random.default_rng(11).standard_normal((3, 5, 3, 3)))
    if side == "corners":
        got = detector._corner_kernels(w, stage)
    else:
        got = (detector._phase_kernel if stage == 1 else detector._packed2_kernel)(w, side)
    want = _einsum_kernel(stage, side, w)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-14)


def test_serving_kernels_are_composed_once_per_weight_version():
    """Without a gradient the packed modes compose their kernels once and
    again after any change of the weights (an in-place update, a load, a
    cast); the map always equals a new head's on the same weights."""
    shape = HEAD_SHAPES[1]
    x, variables = _head_variables(shape)
    head = _port_head(shape[2], variables)
    calls = []
    real = detector._packed_kernels

    def counting(*args):
        calls.append(args[2])
        return real(*args)

    def fresh():
        other = detector.MapHead(CIN, shape[2])
        other.load_state_dict(head.state_dict())
        return other.eval().to(next(head.parameters()).dtype)(tx)

    tx = _nchw(x)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(detector, "_packed_kernels", counting)
        a = head(tx)
        assert calls == [1, 2]
        assert torch.equal(head(tx), a) and calls == [1, 2]
        head.up2.weight.mul_(0.5)
        b = head(tx)
        assert calls == [1, 2, 2] and not torch.equal(a, b)
        want = fresh()
        torch.testing.assert_close(b, want, rtol=0, atol=0)
        calls.clear()
        head.load_state_dict(_port_head(shape[2], variables).state_dict())
        assert torch.equal(head(tx), a) and calls == [1, 2]
        head.double()
        tx = tx.double()
        c = head(tx)
        assert c.dtype == torch.float64 and calls == [1, 2, 1, 2]
        torch.testing.assert_close(c, fresh(), rtol=0, atol=0)


def test_eval_head_gradients_reach_the_weights():
    """With a gradient wanted the packed modes compose their kernels each
    call: an eval head's map is differentiable in its weights, the
    gradients equal the plain head's."""
    shape = HEAD_SHAPES[1]
    x, variables = _head_variables(shape)
    heads = {f: _port_head(shape[2], variables, fused_upsample=f).double() for f in (True, False)}
    grads = {}
    for f, head in heads.items():
        head(_nchw(x).double()).square().sum().backward()
        grads[f] = {n: p.grad for n, p in head.named_parameters()}
    assert heads[True].up2._composed is None
    for n, g in grads[False].items():
        np.testing.assert_allclose(grads[True][n].numpy(), g.numpy(), rtol=1e-9, atol=1e-12,
                                   err_msg=n)


# --- the detectors ---------------------------------------------------------------


DET = dict(fpn_dim=32, head_dim=16, width=16)


def _assert_maps_close(got, ref, atol):
    """prob and thresh within ``atol``; binary = sigmoid(50 (prob - thresh))
    within k / 4 times both of theirs (the sigmoid's largest slope is 1/4)."""
    for k, tol in (("prob", atol), ("thresh", atol), ("binary", 50 / 4 * 2 * atol)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_seg_detector_default_flags_match_the_plain_head_and_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 76, 92, 3)).astype(np.float32)
    det = detector.SegDetector(**DET, device="cpu")
    plain = detector.SegDetector(**DET, fused_upsample=False, device="cpu")
    assert isinstance(det.net.prob_head.up1, detector._UpConv)
    assert type(plain.net.prob_head.up1) is Conv2d
    variables = seeded_flax_variables(export_flax_variables(det.net), 8)
    load_flax_variables(det.net, variables)
    load_flax_variables(plain.net, variables)
    jnet = jdetector.SegDetector(**DET).net
    ref = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, x)
    got = det.predict_maps(torch.from_numpy(x))
    want = plain.predict_maps(torch.from_numpy(x))
    _assert_maps_close(got, want, 2e-6)
    _assert_maps_close(got, ref, 1e-5)


def test_shared_trunk_spotter_maps_default_against_the_plain_head():
    """The spotter's heads take ``MapHead``'s defaults, as JAX's do: its
    serving maps equal JAX's and the plain heads' on the same weights."""
    kw = dict(num_classes=37, fpn_dim=32, head_dim=16, hidden=32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    sp = SharedTrunkSpotter(**kw, device="cpu")
    assert isinstance(sp.net.prob_head.up2, detector._UpConv)
    variables = seeded_flax_variables(export_flax_variables(sp.net), 10)
    load_flax_variables(sp.net, variables)
    plain = copy.deepcopy(sp.net)
    for name in ("prob_head", "thresh_head"):
        head = getattr(sp.net, name)
        p = detector.MapHead(32, 16, fused_upsample=False)
        p.load_state_dict(head.state_dict())
        setattr(plain, name, p)
    jsp = JaxSharedTrunkSpotter(**kw)
    ref = jax.jit(lambda v, a: jsp.net.apply(v, a, method=lambda m, b: m.detect_maps(
        m.fused_map(b, train=False), train=False, heads=("prob", "thresh"))))(variables, x)
    with torch.no_grad():
        got = sp.net.eval().detect_maps(sp.net.fused_map(torch.from_numpy(x)))
        want = plain.eval().detect_maps(plain.fused_map(torch.from_numpy(x)))
    _assert_maps_close(got, want, 2e-6)
    _assert_maps_close(got, ref, 1e-5)


def test_trained_asset_default_head_equals_the_plain_head():
    """``assets/bench_det_fp16.msgpack`` loads unchanged into both heads; on
    two TextPages the default map equals the plain head's within 2e-6 of its
    scale."""
    import chip_smoke

    from megreader_tpu_torch.ops.image import normalize

    variables, _ = load_flax_msgpack(ASSET)
    data = chip_smoke.TextPages(2, 5, hw=(256, 256))
    pages = np.stack([data[i]["image"] for i in range(2)]).astype(np.float32)
    x = normalize(torch.from_numpy(pages))
    maps = {}
    for fused in (True, False):
        det = detector.SegDetector(fused_upsample=fused, device="cpu")
        load_flax_variables(det.net, variables)
        maps[fused] = det.predict_maps(x, heads=("prob",))["prob"]
    scale = float(maps[False].abs().max())
    assert 0.5 < scale <= 1
    np.testing.assert_allclose(maps[True].numpy(), maps[False].numpy(), rtol=0,
                               atol=2e-6 * scale)


@pytest.mark.parametrize("fused", [True, False])
def test_from_yaml_takes_fused_upsample(fused):
    """``fused_upsample`` reaches ``SegDetector`` through ``from_yaml``'s
    dotted overrides, in both packages; without it the default holds."""
    from megreader_tpu.experiment import Experiment as JaxExperiment
    from megreader_tpu_torch.experiment import Experiment

    path = os.path.join(REPO, "experiments", "seg_detector_synth.yaml")
    over = {} if fused else {"experiment.model.fused_upsample": False}
    exp = Experiment.from_yaml(path, {"experiment.model.device": "cpu", **over})
    ref = JaxExperiment.from_yaml(path, over)
    assert ref.model.net.fused_upsample is fused
    for name in ("prob_head", "thresh_head"):
        head = getattr(exp.model.net, name)
        assert head.fused_upsample is fused
        assert isinstance(head.up1, detector._UpConv) is fused
        assert isinstance(head.up2, detector._UpConv) is fused


# --- int8 ------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_int8_quantizes_up_convs_exactly_when_not_fused(fused):
    """The layers int8 serving swaps equal the flax ``nn.Conv`` set JAX's
    interceptor sees, and include ``up1``/``up2`` exactly without
    ``fused_upsample``; the quantized detector in float64 lies within
    1/1000 of JAX's int8-versus-float distance of JAX's ``int8_methods``."""
    det = detector.SegDetector(**DET, fused_upsample=fused, device="cpu")
    jdet = jdetector.SegDetector(**DET, fused_upsample=fused)
    variables = seeded_flax_variables(export_flax_variables(det.net), 13)
    load_flax_variables(det.net, variables)
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    seen = set()

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and type(mod) in (flax.linen.Conv,
                                                                 flax.linen.Dense):
            seen.add(tuple(mod.path))
        return next_fun(*args, **kwargs)

    apply = lambda v, a: jdet.net.apply(v, a, train=False, heads=("prob",))["prob"]  # noqa: E731
    with flax.linen.intercept_methods(record):
        jax.eval_shape(lambda v, a: jdet.net.apply(v, a, train=False), variables, x)
    got = {_flax_module_path(name) for name, _ in q.int8_layers(det.net)}
    assert got == seen
    ups = {(h, u) for h in ("prob_head", "thresh_head") for u in ("up1", "up2")}
    assert ups & got == (set() if fused else ups)

    net = copy.deepcopy(det.net).double().eval()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        x64 = x.astype(np.float64)
        ref = np.asarray(jax.jit(apply)(v64, x64))
        ref8 = np.asarray(jax.jit(jq.int8_methods(apply))(v64, x64))
    with torch.no_grad():
        got8 = q.int8_methods(lambda a: net(a, heads=("prob",))["prob"], net)(
            torch.from_numpy(x64)).numpy()
    jax_gap = np.abs(ref8 - ref).max()
    port_gap = np.abs(got8 - ref8).max()
    assert 0 < jax_gap and port_gap * 1000 <= jax_gap, (port_gap, jax_gap)
