"""Port 2D-CTC recognizer (config #2) against the JAX package, on the CPU.

Nets at ``width=8`` in both transitions share weights redrawn from a numpy
seed (``seeded_flax_variables``) on the flax tree that the port exports,
whose structure and shapes are held to the flax module's own (an abstract
``init``); both packages then see the same crops, made by the port's
synthetic dataset, collate and prepare. Compared: the rec2d trunk's shape,
the heads (atol 1e-4 and rtol 1e-5, float32: convolutions summed in another
order; the class head is scaled up as a trained net's, so log-probs reach
-50, and no argmax is a near-tie), the weight carry both ways, the batched
decode through ``RecognizerPredictor`` (equal strings), one Markov train step
(loss atol 1e-4, gradients rtol 1e-3 / atol 1e-5, BatchNorm statistics atol
1e-5) in float64 on both sides for the reason
``tests/test_torch_port_train.py`` gives, ``Experiment`` with validation, and
``E2EPipeline`` with the Markov recognizer (ids on valid slots equal to the
JAX decode of the same crops). Every JAX call is jitted: the two files of
the 2D-CTC slice run in well under a minute."""

import functools
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models.recognizer2d import Ctc2dRecognizer as JaxCtc2dRecognizer
from megreader_tpu.postproc.measurers import RecognitionMeasurer as JaxRecognitionMeasurer
from megreader_tpu.postproc.measurers import edit_distance as jax_edit_distance
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.core.charset import Charset
from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
from megreader_tpu_torch.data.loader import recognition_collate
from megreader_tpu_torch.evaluation import evaluate_recognition
from megreader_tpu_torch.experiment import Experiment, _recognition_prepare
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer, rec2d_feature_height
from megreader_tpu_torch.models.resnet import resnet_variant
from megreader_tpu_torch.ops.ctc import ctc_beam_decode
from megreader_tpu_torch.ops.ctc2d import fuse_heights
from megreader_tpu_torch.pipelines.e2e import E2EPipeline
from megreader_tpu_torch.pipelines.predictors import RecognizerPredictor
from megreader_tpu_torch.postproc.measurers import RecognitionMeasurer, edit_distance
from megreader_tpu_torch.train.train_step import OptimizerConfig

WIDTH = 8
TRANSITIONS = ("independent", "markov")


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


@pytest.fixture(scope="module")
def data():
    """One host batch of 8 synthetic crops and its prepared model batch."""
    ds = SyntheticRecognitionDataset(n=8)
    raw = recognition_collate([ds[i] for i in range(8)], Charset())
    batch = {k: v.numpy() for k, v in _recognition_prepare(raw, device="cpu").items()}
    return {"raw": raw, "batch": batch}


def _port_model(transition, seed, sharp=True):
    """A port model on the CPU and the flax variables it carries."""
    rec = Ctc2dRecognizer(37, transition=transition, width=WIDTH, device="cpu")
    variables = seeded_flax_variables(export_flax_variables(rec.net), seed)
    if sharp:
        variables["params"]["class_head"]["kernel"] *= 8.0
    load_flax_variables(rec.net, variables)
    return rec, variables


@pytest.fixture(scope="module", params=TRANSITIONS)
def pair(request, data):
    """The JAX model, the port model, the variables both carry, and the JAX
    heads and decode (jitted) of the batch's crops."""
    transition = request.param
    jm = JaxCtc2dRecognizer(num_classes=37, transition=transition, width=WIDTH)
    tm, variables = _port_model(transition, 5)

    @jax.jit
    def run(v, x):
        heads = jm.apply(v, x, train=False)
        return heads, jm.decode(v, x)

    heads, decoded = jax.device_get(run(variables, jnp.asarray(data["batch"]["image"])))
    return {"transition": transition, "jax": jm, "port": tm, "variables": variables,
            "heads": heads, "decoded": decoded}


def test_rec2d_trunk_shapes():
    """32x100 -> H 4, W 25 and 48x160 -> 6 x 40, as the JAX trunk gives."""
    trunk = resnet_variant("resnet18", "rec2d", width=WIDTH).eval()
    for hw, out in (((32, 100), (4, 25)), ((48, 160), (6, 40))):
        with torch.no_grad():
            y = trunk(torch.zeros((1, 3) + hw))
        assert tuple(y.shape) == (1, 8 * WIDTH) + out
        assert rec2d_feature_height(hw[0]) == out[0]


def test_heads_match_flax(pair, data):
    with torch.no_grad():
        got = pair["port"].net.eval()(torch.from_numpy(data["batch"]["image"]))
    shapes = {"independent": [(8, 25, 4, 37), (8, 25, 4)],
              "markov": [(8, 25, 4, 37), (8, 25, 4, 4), (8, 4)]}[pair["transition"]]
    assert [tuple(g.shape) for g in got] == shapes
    for g, r in zip(got, pair["heads"]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-4)


def test_weight_carry_matches_the_flax_tree(pair):
    """The exported tree has the flax module's keys and shapes, and
    exporting what was loaded gives it back exactly."""
    flax_tree = jax.eval_shape(pair["jax"].init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 100, 3)))
    for col in ("params", "batch_stats"):
        ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf
               in jax.tree_util.tree_flatten_with_path(flax_tree[col])[0]}
        got = {"/".join(k): v.shape for k, v in _flat(pair["variables"][col])}
        assert got == ref
        _assert_trees_close(export_flax_variables(pair["port"].net)[col],
                            pair["variables"][col], rtol=0, atol=0)


def test_predictor_strings_match_jax(pair, data):
    """The batched decode (greedy for independent heights, Viterbi for
    Markov heights) through ``RecognizerPredictor``, from the host canvases,
    against the JAX decode of the same crops."""
    raw = data["raw"]
    ids, lengths = pair["decoded"]
    ref = Charset().decode_batch(ids, lengths)
    got = RecognizerPredictor(pair["port"]).predict(None, raw["image"], raw["size"])
    assert got == ref
    assert any(got)


def test_net_checks_its_feature_height():
    rec = Ctc2dRecognizer(37, transition="markov", width=WIDTH, crop_hw=(48, 160),
                          device="cpu")
    assert rec.net.trans_head.out_features == 6
    with pytest.raises(ValueError, match="built for 6"):
        rec.net(torch.zeros((1, 32, 100, 3)))


@pytest.mark.parametrize("what", ["bf16", "beam", "transition"])
def test_left_out_options_raise(what):
    if what == "bf16":  # ported: a bf16 trunk, float32 heads (tests/test_torch_port_bf16.py)
        rec = Ctc2dRecognizer(37, width=WIDTH, compute_dtype="bfloat16", device="cpu")
        assert {p.dtype for p in rec.net.parameters()} == {torch.float32}
        assert rec.net.backbone.stem_conv.compute_dtype == torch.bfloat16
        assert rec.net.class_head.compute_dtype is None
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            Ctc2dRecognizer(37, width=WIDTH, compute_dtype="half", device="cpu")
    elif what == "beam":  # ported: the beam over the fused heights, Viterbi for Markov
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 100, 3))
                             .astype(np.float32))
        rec = Ctc2dRecognizer(37, width=WIDTH, device="cpu")
        with torch.no_grad():
            emit, height = rec.net.eval()(x)
        lengths = torch.full((2,), emit.shape[1], dtype=torch.int32)
        ref = ctc_beam_decode(fuse_heights(emit, height), lengths, beam_width=3)
        got = rec.decode(x, mode="beam", beam_width=3)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        markov = Ctc2dRecognizer(37, transition="markov", width=WIDTH, device="cpu")
        assert all(torch.equal(g, r) for g, r in
                   zip(markov.decode(x, mode="beam"), markov.decode(x, mode="greedy")))
    else:
        with pytest.raises(ValueError, match="unknown transition"):
            Ctc2dRecognizer(37, transition="hmm", device="cpu")


@pytest.fixture(scope="module")
def markov_step(data):
    """One train-mode Markov step in float64 on both sides (JAX's BatchNorm
    built with float64 statistics while it runs)."""
    jm = JaxCtc2dRecognizer(num_classes=37, transition="markov", width=WIDTH)
    rec, variables = _port_model("markov", 9, sharp=False)
    batch64 = {**data["batch"], "image": data["batch"]["image"].astype(np.float64)}

    def loss_fn(params, batch_stats):
        loss, (_, new_state) = jm.loss({"params": params, "batch_stats": batch_stats},
                                       batch64, train=True)
        return loss, new_state["batch_stats"]

    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"])
        ref = jax.device_get({"loss": loss, "grads": grads, "batch_stats": stats})

    rec.net.to(torch.float64)
    batch = {k: torch.from_numpy(batch64[k]) for k in ("image", "label", "label_length")}
    got_loss, metrics = rec.loss(batch, train=True)
    got_loss.backward()
    got = {"loss": float(got_loss.detach()), "metrics": metrics,
           "grads": export_flax_variables(rec.net, {n: p.grad for n, p in
                                                    rec.net.named_parameters()}),
           "variables": export_flax_variables(rec.net)}
    return ref, got


def test_markov_train_step_matches_jax(markov_step):
    ref, got = markov_step
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=0, atol=1e-4)
    assert float(got["metrics"]["loss"]) == got["loss"]
    _assert_trees_close(got["grads"]["params"], ref["grads"], rtol=1e-3, atol=1e-5)
    _assert_trees_close(got["variables"]["batch_stats"], ref["batch_stats"], rtol=0, atol=1e-5)


def test_measurer_matches_jax():
    pairs = [("hello", "hallo"), ("", "abc"), ("Text", "text"), ("kitten", "sitting"),
             ("abc", "")]
    for a, b in pairs:
        assert edit_distance(a, b) == jax_edit_distance(a, b)
    preds, gts = zip(*pairs)
    assert RecognitionMeasurer().measure(preds, gts) == JaxRecognitionMeasurer().measure(preds, gts)
    assert RecognitionMeasurer().measure([], []) == {"accuracy": 0.0, "ned": 0.0, "n": 0}


def test_experiment_validates_through_evaluate_recognition(tmp_path):
    """2 epochs of 2 Markov steps on the CPU, validation every 2 steps: the
    trainer logs ``evaluate_recognition``'s metrics, which equal a direct
    call on the trained net, and those equal the measurer on the
    predictor's strings."""
    torch.manual_seed(0)
    model = Ctc2dRecognizer(37, transition="markov", width=WIDTH, device="cpu")
    opt = OptimizerConfig(name="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=2,
                          total_steps=20)
    eval_ds = SyntheticRecognitionDataset(n=6, seed=1)
    exp = Experiment(model, SyntheticRecognitionDataset(n=16), eval_dataset=eval_ds,
                     batch_size=8, epochs=2, log_every=1, workspace=str(tmp_path),
                     optimizer=opt, validate_every_steps=2)
    state = exp.make_trainer().train()
    assert state.step == 4
    with open(os.path.join(tmp_path, "train_metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    evals = [r for r in lines if "eval/accuracy" in r]
    assert [r["step"] for r in evals] == [2, 4]
    direct = evaluate_recognition(exp)
    assert direct["n"] == 6
    assert evals[-1]["eval/ned"] == pytest.approx(direct["ned"])
    raw = exp.collate([eval_ds[i] for i in range(6)])
    preds = RecognizerPredictor(model).predict(None, raw["image"], raw["size"])
    assert RecognitionMeasurer().measure(preds, raw["text"]) == direct


def test_e2e_pipeline_with_the_markov_recognizer_matches_jax():
    """A 192x192 page through the port's pipeline with a Markov 2D-CTC
    recognizer: on every valid slot, the ids equal the JAX recognizer's
    decode of the same crops (the stages before it are held to the JAX
    pipeline by ``tests/test_torch_port_e2e.py``)."""
    rng = np.random.default_rng(4)
    pages = 220.0 + 15.0 * rng.standard_normal((1, 192, 192, 3))
    for _ in range(6):
        y, x = rng.integers(8, 170), rng.integers(8, 140)
        pages[0, y:y + rng.integers(8, 14), x:x + rng.integers(20, 45)] -= 150.0
    pages = torch.from_numpy(np.clip(pages, 0, 255).astype(np.float32))
    det = SegDetector("resnet18", 16, 8, width=8, device="cpu")
    load_flax_variables(det.net, seeded_flax_variables(export_flax_variables(det.net), 21))
    rec, rec_vars = _port_model("markov", 22)
    pipe = E2EPipeline(det, rec, max_regions=8, box_thresh=0.0, device="cpu")
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
    pipe.bin_thresh = float(torch.quantile(prob.reshape(-1), 0.8))
    out = pipe.run(None, None, pages)
    with torch.no_grad():
        crops = pipe.crops(pages, pipe.regions(pipe.label(prob), prob)).numpy()
    jm = JaxCtc2dRecognizer(num_classes=37, transition="markov", width=WIDTH)
    ids, lengths = jax.device_get(jax.jit(jm.decode)(rec_vars, jnp.asarray(crops)))
    valid = out["valid"].numpy().reshape(-1)
    assert valid.sum() >= 2
    assert tuple(out["ids"].shape) == (1, 8, 25)
    np.testing.assert_array_equal(out["ids"].reshape(8, 25).numpy()[valid], ids[valid])
    np.testing.assert_array_equal(out["lengths"].reshape(8).numpy()[valid], lengths[valid])
