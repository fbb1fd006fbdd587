"""int8 serving of the port (``ops/quantize.py``) against the JAX package's
``ops/quantize.py``, on the CPU.

* Per layer, on the layer shapes the nets use (a 7x7 stride-2 stem, 3x3 at
  strides 1 and 2, a 1x1 stride-2 downsample, a Dense on a (B, T, C) input;
  with and without bias; compute dtypes None and bf16): the int8 operands,
  the scales and the int32 accumulators bit-equal to JAX's, and the outputs
  within 1 float32 ulp of the largest of ``acc * scale``, the bias and the
  sum (XLA on the CPU fuses the scale and the bias into one multiply-add;
  under bf16 the outputs are then equal or one bf16 step apart). JAX's
  operands are taken from a jitted function, as its forwards are jitted:
  XLA turns the division by 127 into a multiply by float32 ``1/127``.
* The set of layers int8 serving swaps equals the set JAX's interceptor
  swaps, by flax path, for the detector, the CTC net (BiLSTM and
  transformer encoders), the 2D-CTC net and the attention net. JAX's set is
  read with ``nn.intercept_methods`` on a trace (``jax.eval_shape``).
* ``skip_names`` keeps the layers of those local names float (and the
  detector with ``{"conv", "lat5"}`` matches JAX's with the same names
  below), and the float forwards come back after an exception.
* Whole nets on shared weights (``seeded_flax_variables`` of the port's
  export), in float64 on both sides (the int8 layers quantize from float32
  as JAX's do): port int8 against JAX int8 within ``1 / FACTOR`` (1/1000)
  of JAX's own int8-versus-float distance, on the largest output magnitude.
  Measured: 1.1e-7 against 0.026-0.055. In float32 the full-width CTC trunk
  does not hold: the packages' float activations differ by about 1e-7, a
  value that lies that close to a rounding boundary of its int8 grid lands
  one step apart, and the step cascades through the next layers' rounding
  until the port's int8 logits lie 0.018 from JAX's (JAX's own int8 noise
  is 0.043). float64 keeps the float32 inputs of every quantization equal.
  The port's side runs through ``int8_methods``, JAX's through its own.
* Nested contexts on one net: the inner one leaves the outer one's swaps.
* The surfaces: ``cli.eval --int8`` (and so ``evaluate_detection(int8=True)``;
  ``tests/test_torch_port_detection_eval.py`` holds that one to JAX on its
  own pair) against JAX's ``evaluate_detection(int8=True)``, and
  ``RecognizerPredictor(int8=True)`` greedy and beam against JAX's: for the
  CTC net in float32; for the 2D-CTC and attention nets in float64 with
  JAX's decodes jitted and both predictors' crops widened to float64. JAX's
  own int8 ids move with its dispatch (an eager encoder divides by 127,
  a jitted one multiplies by ``1/127``) and with the crops' dtype (XLA
  fuses the dequantization's multiply-add by output dtype), and the seeded
  attention net's top-2 logit margins go down to 1e-3, so the comparison
  is made where JAX's arithmetic is the port's. Every family's predictor
  also equals its own decode under ``int8_context``.

The nets are narrow (trunk width 16, ``fpn_dim`` 32, 64x64 pages, 2 to 4
crops); the CTC net has no width option, so its trunk is ResNet-18 at 64.
"""

import copy
import inspect
import json
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.evaluation import evaluate_detection as jax_evaluate_detection
from megreader_tpu.models.attention import AttentionRecognizer as JaxAttentionRecognizer
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.models.recognizer import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.recognizer2d import Ctc2dRecognizer as JaxCtc2dRecognizer
from megreader_tpu.ops import quantize as jq
from megreader_tpu.pipelines.predictors import RecognizerPredictor as JaxRecognizerPredictor
from megreader_tpu_torch.compat.weights import (
    _flax_module_path,
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models.attention import AttentionRecognizer
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
from megreader_tpu_torch.ops import quantize as q
from megreader_tpu_torch.ops.precision import Conv2d, Linear
from megreader_tpu_torch.pipelines.predictors import RecognizerPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "experiments", "seg_detector_synth.yaml")
ASSET = os.path.join(REPO, "assets", "bench_det_fp16.msgpack")
#: the port's int8 nets lie at least FACTOR times closer to JAX's int8 nets
#: than JAX's int8 nets lie to JAX's float nets (measured: 2e5 to 5e5)
FACTOR = 1000.0

# ---------------------------------------------------------------------------
# per layer

#: name -> (kind, in, out, kernel, stride, padding, bias)
LAYERS = {
    "stem7x7s2": ("conv", 3, 16, 7, 2, 3, False),
    "conv3x3s1": ("conv", 16, 24, 3, 1, 1, True),
    "conv3x3s2": ("conv", 16, 24, 3, 2, 1, False),
    "down1x1s2": ("conv", 16, 24, 1, 2, 0, False),
    "dense": ("dense", 40, 37, None, None, None, True),
    "dense_nobias": ("dense", 40, 37, None, None, None, False),
}


def _jax_layer(kind, cout, k, s, p, bias, dtype):
    if kind == "conv":
        return nn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)), use_bias=bias,
                       dtype=dtype)
    return nn.Dense(cout, use_bias=bias, dtype=dtype)


@jax.jit
def _jax_operands(x, kernel):
    """``_conv_int8`` / ``_dense_int8``'s operands, as the JAX module computes them."""
    wf = kernel.astype(jnp.float32)
    sk = jq._qscale_last(wf)
    wq = jnp.clip(jnp.round(wf / sk), -127.0, 127.0).astype(jnp.int8)
    xq, sx = jq._qtensor(x)
    return xq, sx, wq, sk


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_operands_scales_and_accumulators_match_jax(layer, dtype):
    kind, cin, cout, k, s, p, bias = LAYERS[layer]
    rng = np.random.default_rng(list(LAYERS).index(layer))
    tdt = None if dtype is None else torch.bfloat16
    if kind == "conv":
        x = rng.standard_normal((2, 21, 19, cin)).astype(np.float32)
        mod = Conv2d(cin, cout, k, s, p, bias=bias, compute_dtype=tdt)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    else:
        x = rng.standard_normal((3, 5, cin)).astype(np.float32)
        mod = Linear(cin, cout, bias=bias, compute_dtype=tdt)
        tx = torch.from_numpy(x)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(rng.standard_normal(mod.weight.shape) * 0.1))
        if bias:
            mod.bias.copy_(torch.from_numpy(rng.standard_normal(cout) * 0.05))
    variables = export_flax_variables(mod)
    kernel = jnp.asarray(variables["params"]["kernel"])

    xq, sx, wq, sk = _jax_operands(jnp.asarray(x), kernel)
    mod.requires_grad_(False)
    pxq, psx = q.qtensor(tx)
    pwq, psk = q.qweight(mod.weight)
    np.testing.assert_array_equal(psx.numpy(), np.asarray(sx))
    np.testing.assert_array_equal(psk.numpy(), np.asarray(sk))
    if kind == "conv":
        np.testing.assert_array_equal(pxq.permute(0, 2, 3, 1).numpy(), np.asarray(xq))
        np.testing.assert_array_equal(pwq.permute(2, 3, 1, 0).numpy(), np.asarray(wq))
        acc = jax.lax.conv_general_dilated(xq, wq, (s, s), ((p, p), (p, p)),
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        pacc = q.conv_int8_acc(pxq, pwq, (s, s), (p, p)).permute(0, 2, 3, 1)
    else:
        np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(pwq.numpy().T, np.asarray(wq))
        acc = jax.lax.dot_general(xq, wq, (((2,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        pacc = q.int_mm(pxq.reshape(-1, cin), pwq).reshape(3, 5, cout)
    assert pacc.dtype == torch.int32
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(acc))

    jmod = _jax_layer(kind, cout, k, s, p, bias, None if dtype is None else jnp.bfloat16)
    ref = jax.jit(jq.int8_methods(jmod.apply))(
        {"params": jax.tree_util.tree_map(jnp.asarray, variables["params"])}, jnp.asarray(x))
    with torch.no_grad(), q.int8_context(mod):
        got = mod(tx)
    if kind == "conv":
        got = got.permute(0, 2, 3, 1)
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    # one float32 ulp of the largest of acc * scale, the bias and the sum
    prod = np.asarray(acc, np.float32) * (np.asarray(sx) * np.asarray(sk))
    big = np.maximum(np.abs(prod), np.abs(ref))
    ulp = np.spacing(np.maximum(big, np.abs(variables["params"]["bias"])) if bias else big)
    if dtype is None:
        assert (np.abs(got - ref) <= ulp).all()
    else:  # then rounded to bf16: equal, or one bf16 step apart
        np.testing.assert_allclose(got, ref, rtol=2.0**-7, atol=0)
        assert (got != ref).mean() < 0.01


# ---------------------------------------------------------------------------
# which layers


def _tasks(family):
    """(JAX task, port task on the CPU) of ``family`` at narrow widths."""
    if family in ("ctc", "ctc_transformer"):
        enc = "transformer" if family == "ctc_transformer" else "bilstm"
        kw = dict(num_classes=37, hidden=32, num_encoder_layers=1, encoder=enc)
        return JaxCTCRecognizer(**kw), CTCRecognizer(**kw, device="cpu")
    if family == "ctc2d":
        kw = dict(num_classes=37, transition="markov", width=16)
        return JaxCtc2dRecognizer(**kw), Ctc2dRecognizer(**kw, device="cpu")
    if family == "attention":
        kw = dict(num_classes=39, dim=32, max_len=8, width=16)
        return JaxAttentionRecognizer(**kw), AttentionRecognizer(**kw, device="cpu")
    kw = dict(fpn_dim=32, head_dim=16, width=16)
    return JaxSegDetector(**kw), SegDetector(**kw, device="cpu")


def _inputs(family, B=2):
    rng = np.random.default_rng(5)
    if family == "detector":
        return rng.standard_normal((B, 64, 64, 3)).astype(np.float32), None
    x = rng.standard_normal((B, 32, 100, 3)).astype(np.float32)
    tgt = rng.integers(3, 39, (B, 8)).astype(np.int32) if family == "attention" else None
    return x, tgt


def _jax_apply(family, jm, variables, x, tgt, heads=("prob",)):
    if family == "detector":
        return jm.net.apply(variables, x, train=False, heads=heads)["prob"]
    if family == "attention":
        return jm.net.apply(variables, x, tgt, train=False)
    return jm.net.apply(variables, x, train=False)


def _port_apply(family, net, x, tgt):
    x = torch.from_numpy(x)
    with torch.no_grad():
        if family == "detector":
            return net.eval()(x, heads=("prob",))["prob"]
        if family == "attention":
            return net.eval()(x, torch.from_numpy(tgt).long())
        return net.eval()(x)


FAMILIES = ("detector", "ctc", "ctc_transformer", "ctc2d", "attention")


@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_layers_are_jax_interceptors_layers(family):
    jm, tm = _tasks(family)
    x, tgt = _inputs(family)
    seen = set()

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and type(mod) in (nn.Conv, nn.Dense):
            seen.add(tuple(mod.path))
        return next_fun(*args, **kwargs)

    variables = export_flax_variables(tm.net)
    with nn.intercept_methods(record):
        jax.eval_shape(lambda v: _jax_apply(family, jm, v, x, tgt, ("prob", "thresh")),
                       variables)
    got = {_flax_module_path(name) for name, _ in q.int8_layers(tm.net)}
    assert got == seen
    if family == "detector":  # the _UpConv twins stay float
        assert not {("prob_head", "up1"), ("prob_head", "up2")} & got


def test_skip_names_keep_every_layer_of_that_local_name_float():
    _, tm = _tasks("detector")
    names = {n for n, _ in q.int8_layers(tm.net)}
    kept = {n for n, _ in q.int8_layers(tm.net, frozenset({"conv", "lat5"}))}
    assert names - kept == {"prob_head.conv", "thresh_head.conv", "fpn.lat5"}
    x, _ = _inputs("detector", B=1)
    ref = _port_apply("detector", tm.net, x, None)
    with q.int8_context(tm.net, frozenset(n.rsplit(".", 1)[-1] for n in names)):
        torch.testing.assert_close(_port_apply("detector", tm.net, x, None), ref, rtol=0,
                                   atol=0)
    with q.int8_context(tm.net):
        assert not torch.equal(_port_apply("detector", tm.net, x, None), ref)
    with pytest.raises(RuntimeError, match="inside"):
        with q.int8_context(tm.net):
            raise RuntimeError("inside")
    assert all("forward" not in vars(m) for _, m in q.int8_layers(tm.net))
    torch.testing.assert_close(_port_apply("detector", tm.net, x, None), ref, rtol=0, atol=0)


def test_nested_int8_contexts_keep_the_enclosing_swap():
    """An inner context on the same net (a predictor's inside a caller's)
    leaves the outer one's layers int8 on exit; the outer exit restores
    them all."""
    _, tm = _tasks("detector")
    x, _ = _inputs("detector", B=1)
    ref = _port_apply("detector", tm.net, x, None)
    with q.int8_context(tm.net, frozenset({"conv"})):
        outer = _port_apply("detector", tm.net, x, None)
        with q.int8_context(tm.net):
            both = _port_apply("detector", tm.net, x, None)
        torch.testing.assert_close(_port_apply("detector", tm.net, x, None), outer, rtol=0,
                                   atol=0)
    with q.int8_context(tm.net):
        torch.testing.assert_close(both, _port_apply("detector", tm.net, x, None), rtol=0,
                                   atol=0)
    assert not torch.equal(outer, both) and not torch.equal(outer, ref)
    assert all("forward" not in vars(m) for _, m in q.int8_layers(tm.net))
    torch.testing.assert_close(_port_apply("detector", tm.net, x, None), ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# whole nets


@pytest.fixture(scope="module")
def carried():
    """{family: (JAX task, port task, shared variables)}, built once."""
    out = {}
    for family in ("detector", "ctc", "ctc2d", "attention"):
        jm, tm = _tasks(family)
        variables = seeded_flax_variables(export_flax_variables(tm.net), 13)
        load_flax_variables(tm.net, variables)
        out[family] = (jm, tm, variables)
    return out


def _flat(out):
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in leaves])


@pytest.mark.parametrize("family,skip", [
    ("detector", ()), ("detector", ("conv", "lat5")), ("ctc", ()), ("ctc2d", ()),
    ("attention", ())])
def test_int8_nets_match_jax_int8_well_inside_its_float_distance(carried, family, skip):
    """``skip`` as ``skip_names`` on both sides: the heads' ``conv`` and the
    FPN's ``lat5`` stay float."""
    jm, tm, variables = carried[family]
    x, tgt = _inputs(family)
    net = copy.deepcopy(tm.net).double()
    skip = frozenset(skip)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        x64 = x.astype(np.float64)
        ref = _flat(jax.jit(lambda v, a: _jax_apply(family, jm, v, a, tgt))(v64, x64))
        ref8 = _flat(jax.jit(jq.int8_methods(lambda v, a: _jax_apply(family, jm, v, a, tgt),
                                             skip_names=skip))(v64, x64))
    got8 = _flat(q.int8_methods(lambda a: _port_apply(family, net, a, tgt), net, skip)(x64))
    scale = np.abs(ref).max()
    jax_gap = np.abs(ref8 - ref).max() / scale
    port_gap = np.abs(got8 - ref8).max() / scale
    assert 0 < jax_gap and port_gap * FACTOR <= jax_gap, (port_gap, jax_gap)


# ---------------------------------------------------------------------------
# surfaces


def test_cli_eval_int8_matches_jax_evaluate_detection(tmp_path, capsys):
    """``cli.eval --int8`` on config #4 with the trained detector (the repo's
    asset, in a checkpoint) on two 160x160 ``chip_smoke.TextPages`` prints
    JAX's ``evaluate_detection(int8=True)`` on the same batches (and the
    float32 metrics without ``--int8``)."""
    from chip_smoke import TextPages
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.core.config import parse_cli_overrides
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import create_train_state

    if "TextPages" not in COMPONENTS:
        COMPONENTS.register(TextPages)
    over = {"experiment.model.device": "cpu", "experiment.workspace": str(tmp_path),
            "experiment.eval_dataset": "{class: TextPages, n: 2, seed: 5, hw: [160, 160]}",
            "experiment.batch_size": 2, "experiment.loader_workers": 1}
    argv = [a for k, v in over.items() for a in (f"--{k}", str(v))]
    exp = Experiment.from_yaml(DET, parse_cli_overrides(argv))
    variables = load_flax_msgpack(ASSET)[0]
    load_flax_variables(exp.model.net, variables)
    CheckpointManager(str(tmp_path)).save(create_train_state(exp.model, exp.optimizer), 5,
                                          force=True)
    jexp = types.SimpleNamespace(model=JaxSegDetector(), eval_loader=list(exp.eval_loader))
    for int8 in (False, True):
        got = cli_eval.main([DET, *(["--int8"] if int8 else []), *argv])
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
        assert got == {"step": 5, **jax_evaluate_detection(jexp, variables, int8=int8)}
        assert got["hmean"] > 0.5, got


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_recognizer_predictor_int8_matches_jax(carried, mode):
    jm, tm, variables = carried["ctc"]
    rng = np.random.default_rng(4)
    canvases = rng.uniform(0, 255, (3, 32, 128, 3)).astype(np.float32)
    sizes = np.array([[32, 128], [24, 90], [32, 60]], np.int32)
    ref = JaxRecognizerPredictor(jm, mode=mode, beam_width=4, int8=True).predict(
        variables, canvases, sizes)
    got = RecognizerPredictor(tm, mode=mode, beam_width=4, int8=True).predict(
        None, canvases, sizes)
    assert got == ref
    ref32 = JaxRecognizerPredictor(jm, mode=mode, beam_width=4).predict(
        variables, canvases, sizes)
    assert RecognizerPredictor(tm, mode=mode, beam_width=4).predict(
        None, canvases, sizes) == ref32


def _jitted_decodes(jm):
    """``jm`` with its decodes jitted: JAX's predictor calls the attention
    decodes eagerly, and an eager encoder divides by 127 where a jitted
    one (and the port) multiplies by float32 ``1/127``."""
    jm = copy.copy(jm)
    for name in ("decode", "decode_greedy", "decode_beam"):
        if hasattr(jm, name):
            fn = getattr(jm, name)
            static = [a for a in ("mode", "beam_width") if a in inspect.signature(fn).parameters]
            setattr(jm, name, jax.jit(fn, static_argnames=static))
    return jm


@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("family", ["ctc2d", "attention"])
def test_recognizer_predictor_int8_matches_jax_for_every_family(carried, family, mode):
    """The 2D-CTC and attention predictors at ``int8=True`` against JAX's
    on the carried weights in float64 (the crops widened from the
    predictor's float32, the same values): the attention decode runs its
    per-step Denses (``attn_state``, ``attn_v``, ``out``) at M of 4 to 12
    rows, through ``int_mm``'s padding."""
    jm, tm, variables = carried[family]
    net = copy.deepcopy(tm.net).double()
    canvases = np.random.default_rng(6).uniform(0, 255, (4, 32, 100, 3)).astype(np.float32)
    sizes = np.array([[32, 100], [30, 80], [20, 100], [32, 50]], np.int32)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        jpred = JaxRecognizerPredictor(_jitted_decodes(jm), charset=None if family == "ctc2d"
                                       else RecognizerPredictor(tm).charset, mode=mode,
                                       beam_width=3, int8=True)
        jpred._prep = lambda c, s, prep=jpred._prep: prep(c, s).astype(jnp.float64)
        ref = jpred.predict(v64, canvases, sizes)
    pred = RecognizerPredictor(tm, mode=mode, beam_width=3, int8=True)
    pred.prepare = lambda c, s, prepare=pred.prepare: prepare(c, s).double()
    assert pred.predict(net, canvases, sizes) == ref


@pytest.mark.parametrize("family", ["ctc2d", "attention"])
def test_recognizer_predictor_int8_runs_every_family_under_the_context(carried, family,
                                                                       monkeypatch):
    _, tm, _ = carried[family]
    canvases = np.random.default_rng(6).uniform(0, 255, (2, 32, 100, 3)).astype(np.float32)
    sizes = np.array([[32, 100], [30, 80]], np.int32)
    calls = []
    for name in ("conv_int8", "dense_int8"):
        real = getattr(q, name)
        monkeypatch.setattr(q, name, lambda mod, x, real=real: calls.append(mod) or real(mod, x))
    for mode in ("greedy", "beam"):
        pred = RecognizerPredictor(tm, mode=mode, beam_width=3, int8=True)
        got = pred.predict(None, canvases, sizes)
        with q.int8_context(tm.net):
            ids, lens = tm.decode(pred.prepare(canvases, sizes), mode=mode, beam_width=3)
        assert got == pred.charset.decode_batch(ids.numpy(), lens.numpy())
    swapped = {m for _, m in q.int8_layers(tm.net)}
    assert set(calls) == swapped
