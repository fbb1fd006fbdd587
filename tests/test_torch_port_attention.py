"""Port attention recognizer (judged config #3) against the JAX package, on
the CPU.

At the sizes of ``tests/test_attention.py`` (dim 64, max_len 12, 32x100
crops) with a trunk of width 8, both packages share weights redrawn from a
numpy seed (``seeded_flax_variables``) on the flax tree the port exports,
whose keys and shapes are held to the flax module's own (an abstract
``init``). The memory projection is centred and scaled on the batch's
features, so that the decodes depend on the crop (random weights alone read
every crop as the same string). Compared:

* the weight carry both ways, and the charset;
* ``encode``, ``decode_step`` and the teacher-forced logits in float32
  (rtol and atol 1e-5), on the seeded weights as drawn;
* one train-mode ``loss`` and its gradients in float64 on both sides (loss
  atol 1e-4, gradients rtol 1e-3 / atol 1e-5, BatchNorm statistics atol
  1e-5), JAX's BatchNorm built with float64 statistics while it runs, for the
  reason ``tests/test_torch_port_train.py`` gives;
* ``decode_greedy`` and ``decode_beam`` (W 1, W 5, W 5 with a length
  penalty) ids and lengths, equal, in float64 so that no near-tie can flip;
* ``RecognizerPredictor``'s strings, ``E2EPipeline`` on one page (greedy and
  beam) and an ``Experiment`` with the attention task (two trainer steps,
  then a beam validation)."""

import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.core.charset import AttentionCharset as JaxAttentionCharset
from megreader_tpu.models.attention import AttentionRecognizer as JaxAttentionRecognizer
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.core.charset import AttentionCharset
from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
from megreader_tpu_torch.data.loader import recognition_collate
from megreader_tpu_torch.evaluation import evaluate_recognition
from megreader_tpu_torch.experiment import Experiment, _recognition_prepare
from megreader_tpu_torch.models.attention import AttentionRecognizer, rec2d_feature_width
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.pipelines.e2e import E2EPipeline
from megreader_tpu_torch.pipelines.predictors import RecognizerPredictor
from megreader_tpu_torch.postproc.measurers import RecognitionMeasurer
from megreader_tpu_torch.train.train_step import OptimizerConfig

SIZE = dict(num_classes=39, dim=64, max_len=12, width=8)
_FLAX_BATCH_NORM = flax.linen.BatchNorm


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


def _batch_norm_f64(*args, dtype=None, **kwargs):
    return _FLAX_BATCH_NORM(*args, **kwargs)


def _x64(fn, *args):
    """``fn(*args)`` jitted in float64, JAX's BatchNorm too."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", _batch_norm_f64)
        args = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a, args)
        return jax.device_get(jax.jit(fn)(*args))


@pytest.fixture(scope="module")
def data():
    """One host batch of 8 synthetic crops and its prepared model batch."""
    ds = SyntheticRecognitionDataset(n=8)
    raw = recognition_collate([ds[i] for i in range(8)], AttentionCharset(), max_label_len=12)
    batch = {k: v.numpy() for k, v in _recognition_prepare(raw, device="cpu").items()}
    return {"raw": raw, "batch": batch}


def _port_model(seed, images=None):
    """A port model on the CPU and the flax variables it carries: seeded
    weights; with ``images``, the memory projection is centred and scaled
    to unit-ish spread on their features, and the position table and the
    output layer are made larger."""
    rec = AttentionRecognizer(**SIZE, device="cpu")
    variables = seeded_flax_variables(export_flax_variables(rec.net), seed)
    load_flax_variables(rec.net, variables)
    if images is None:
        return rec, variables
    with torch.no_grad():
        feat = rec.net.trunk(torch.from_numpy(images).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    feat = feat.reshape(-1, feat.shape[-1]).numpy().astype(np.float64)
    p = variables["params"]
    kernel = p["mem_proj"]["kernel"] * (3.0 / feat.std(0).mean())
    p["mem_proj"]["kernel"] = kernel.astype(np.float32)
    p["mem_proj"]["bias"] = (-(feat.mean(0) @ kernel)).astype(np.float32)
    p["pos2d"] *= 5.0
    p["out"]["kernel"] *= 2.0
    load_flax_variables(rec.net, variables)
    return rec, variables


@pytest.fixture(scope="module")
def pair(data):
    jm = JaxAttentionRecognizer(**SIZE)
    tm, variables = _port_model(5, data["batch"]["image"])
    return {"jax": jm, "port": tm, "variables": variables}


def test_charset_matches_jax():
    texts = ["ab3", "", "Hello World", "x" * 40, "q!"]
    ref, got = JaxAttentionCharset(), AttentionCharset()
    assert got.num_classes == ref.num_classes == 39
    assert (got.PAD, got.GO, got.EOS) == (0, 1, 2)
    for t in texts:
        r_ids, r_n = ref.encode(t, 12)
        g_ids, g_n = got.encode(t, 12)
        np.testing.assert_array_equal(g_ids, r_ids)
        assert g_n == r_n
        assert got.decode(g_ids) == ref.decode(r_ids)
    assert got.decode([5, 6, 2, 7]) == ref.decode([5, 6, 2, 7])


def test_weight_carry_matches_the_flax_tree(pair):
    """The exported tree has the flax module's keys and shapes (``trunk``,
    ``embed/embedding``, ``gru``, the bias-free ``attn_*`` and the root's
    ``pos2d``), and exporting what was loaded gives it back exactly."""
    flax_tree = jax.eval_shape(pair["jax"].init, jax.random.PRNGKey(0),
                               jnp.zeros((2, 32, 100, 3)))
    for col in ("params", "batch_stats"):
        ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf
               in jax.tree_util.tree_flatten_with_path(flax_tree[col])[0]}
        got = {"/".join(k): v.shape for k, v in _flat(pair["variables"][col])}
        assert got == ref
        _assert_trees_close(export_flax_variables(pair["port"].net)[col],
                            pair["variables"][col], rtol=0, atol=0)
    params = pair["variables"]["params"]
    assert params["pos2d"].shape == (1, 4, rec2d_feature_width(100), 64)
    assert set(params["attn_v"]) == {"kernel"} and "bias" in params["out"]
    assert set(params["gru"]) == {"w_ih", "w_hh", "b_ih", "b_hh"}


def test_weight_carry_refuses_a_stray_root_parameter(pair):
    net = AttentionRecognizer(**SIZE, device="cpu").net
    net.register_parameter("scale", torch.nn.Parameter(torch.ones(1)))
    with pytest.raises(TypeError, match="'scale'"):
        export_flax_variables(net)
    bad = {c: dict(v) for c, v in pair["variables"].items()}
    bad["params"]["pos2d_extra"] = bad["params"]["pos2d"]
    with pytest.raises(KeyError, match="pos2d_extra"):
        load_flax_variables(AttentionRecognizer(**SIZE, device="cpu").net, bad)


def test_encode_step_and_teacher_forced_logits_match_flax(pair, data):
    """On the seeded weights as drawn: the centred projection scales the
    trunk's float32 rounding (convolutions summed in another order) up with
    the memory."""
    jm = pair["jax"]
    port, v = _port_model(5)
    images = data["batch"]["image"]
    labels = data["batch"]["label"]
    go = np.full((8, 1), AttentionCharset.GO, np.int32)
    targets_in = np.concatenate([go, labels[:, :-1]], 1)
    y_prev = labels[:, 3]

    @jax.jit
    def run(v, x, tin, y):
        mem, keys = jm.net.apply(v, x, train=False, method=jm.net.encode)
        state = jnp.tanh(mem[:, 0] * 0.3)
        new_state, logits = jm.net.apply(v, keys, mem, state, y, method=jm.net.decode_step)
        return mem, keys, new_state, logits, jm.net.apply(v, x, tin, train=False)

    ref = run(v, jnp.asarray(images), jnp.asarray(targets_in), jnp.asarray(y_prev))
    net = port.net.eval()
    with torch.no_grad():
        mem, keys = net.encode(torch.from_numpy(images))
        new_state, logits = net.decode_step(keys, mem, torch.tanh(mem[:, 0] * 0.3),
                                            torch.from_numpy(y_prev).long())
        tf = net(torch.from_numpy(images), torch.from_numpy(targets_in).long())
    assert tuple(mem.shape) == (8, 100, 64) and tuple(tf.shape) == (8, 12, 39)
    for what, g, r in zip(("mem", "keys", "state", "logits", "teacher_forced"),
                          (mem, keys, new_state, logits, tf), ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=what)


def test_train_step_matches_jax_in_float64(pair, data):
    jm, v = pair["jax"], pair["variables"]
    batch = data["batch"]

    def loss_fn(params, batch_stats, b):
        loss, (_, new_state) = jm.loss({"params": params, "batch_stats": batch_stats}, b,
                                       train=True)
        return loss, new_state["batch_stats"]

    def step(params, batch_stats, b):
        return jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats, b)

    (loss, stats), grads = _x64(step, v["params"], v["batch_stats"], batch)
    rec, _ = _port_model(5, batch["image"])
    rec.net.to(torch.float64)
    tb = {"image": torch.from_numpy(batch["image"].astype(np.float64)),
          "label": torch.from_numpy(batch["label"]),
          "label_length": torch.from_numpy(batch["label_length"])}
    got_loss, metrics = rec.loss(tb, train=True)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=0, atol=1e-4)
    assert float(metrics["loss"]) == float(got_loss.detach())
    grads_t = export_flax_variables(rec.net, {n: p.grad for n, p in rec.net.named_parameters()})
    _assert_trees_close(grads_t["params"], grads, rtol=1e-3, atol=1e-5)
    _assert_trees_close(export_flax_variables(rec.net)["batch_stats"], stats, rtol=0, atol=1e-5)
    assert sum(float(np.abs(g).sum()) for _, g in _flat(grads_t["params"])) > 0


@pytest.fixture(scope="module")
def decodes(pair, data):
    """JAX's and the port's greedy and beam decodes of the batch in float64."""
    jm, v = pair["jax"], pair["variables"]
    settings = {"greedy": None, "beam1": (1, 0.0), "beam5": (5, 0.0), "beam5_lp": (5, 1.0)}
    images = data["batch"]["image"]
    ref, got = {}, {}
    rec, _ = _port_model(5, images)
    rec.net.to(torch.float64)
    x = torch.from_numpy(images.astype(np.float64))
    for name, s in settings.items():
        if s is None:
            ref[name] = _x64(lambda v, x: jm.decode_greedy(v, x), v, images)
            got[name] = rec.decode_greedy(x)
        else:
            ref[name] = _x64(lambda v, x, s=s: jm.decode_beam(v, x, beam_width=s[0],
                                                              length_penalty=s[1]), v, images)
            got[name] = rec.decode_beam(x, beam_width=s[0], length_penalty=s[1])
    return ref, {k: tuple(t.numpy() for t in g) for k, g in got.items()}


@pytest.mark.parametrize("name", ["greedy", "beam1", "beam5", "beam5_lp"])
def test_decode_matches_jax_in_float64(decodes, name):
    ref, got = decodes
    np.testing.assert_array_equal(got[name][1], ref[name][1], err_msg="lengths")
    np.testing.assert_array_equal(got[name][0], ref[name][0], err_msg="ids")
    ids, lengths = got[name]
    assert ids.shape == (8, 12) and ids.dtype == np.int32 and lengths.dtype == np.int32
    for row, n in zip(ids, lengths):  # PAD after the first EOS
        assert (row[n:] == AttentionCharset.PAD).all()


def test_decodes_are_not_degenerate(decodes):
    """The shared weights give crop-dependent strings, beams that differ
    from greedy, and lengths that differ between rows."""
    _, got = decodes
    strings = AttentionCharset().decode_batch(*got["greedy"])
    assert len(set(strings)) >= 4
    assert (got["beam5"][0] != got["greedy"][0]).any()
    assert len(set(got["greedy"][1].tolist())) >= 2
    np.testing.assert_array_equal(got["beam1"][0], got["greedy"][0])


def test_left_out_dtype_raises():
    """``compute_dtype='bfloat16'`` is ported (held to JAX by
    ``tests/test_torch_port_bf16.py``): float32 parameters, a bf16 trunk, a
    float32 decoder. An unknown dtype raises."""
    rec = AttentionRecognizer(**SIZE, compute_dtype="bfloat16", device="cpu")
    assert {p.dtype for p in rec.net.parameters()} == {torch.float32}
    assert rec.net.trunk.stem_conv.compute_dtype == torch.bfloat16
    assert rec.net.out.compute_dtype is None
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        AttentionRecognizer(**SIZE, compute_dtype="float16", device="cpu")


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_predictor_strings_match_jax(pair, data, mode):
    """``RecognizerPredictor`` from the host canvases (the charset defaults to
    ``AttentionCharset``; beam width 8) against the JAX decode of the same
    prepared crops."""
    jm, v = pair["jax"], pair["variables"]
    x = jnp.asarray(data["batch"]["image"])
    if mode == "beam":
        ids, lengths = jax.device_get(jax.jit(lambda v, x: jm.decode_beam(v, x, 8))(v, x))
    else:
        ids, lengths = jax.device_get(jax.jit(jm.decode_greedy)(v, x))
    predictor = RecognizerPredictor(pair["port"], mode=mode)
    assert isinstance(predictor.charset, AttentionCharset) and predictor.beam_width == 8
    raw = data["raw"]
    got = predictor.predict(None, raw["image"], raw["size"])
    assert got == JaxAttentionCharset().decode_batch(ids, lengths)
    assert any(got)


@pytest.mark.parametrize("rec_mode", ["greedy", "beam"])
def test_e2e_pipeline_with_the_attention_recognizer_matches_jax(pair, rec_mode):
    """A 192x192 page through the port's pipeline with the attention
    recognizer: on every valid slot, the ids and lengths equal the JAX
    recognizer's decode of the same crops (the stages before it are held to
    the JAX pipeline by ``tests/test_torch_port_e2e.py``)."""
    rng = np.random.default_rng(4)
    pages = 220.0 + 15.0 * rng.standard_normal((1, 192, 192, 3))
    for _ in range(6):
        y, x = rng.integers(8, 170), rng.integers(8, 140)
        pages[0, y:y + rng.integers(8, 14), x:x + rng.integers(20, 45)] -= 150.0
    pages = torch.from_numpy(np.clip(pages, 0, 255).astype(np.float32))
    det = SegDetector("resnet18", 16, 8, width=8, device="cpu")
    load_flax_variables(det.net, seeded_flax_variables(export_flax_variables(det.net), 21))
    pipe = E2EPipeline(det, pair["port"], max_regions=8, box_thresh=0.0, rec_mode=rec_mode,
                       beam_width=5, device="cpu")
    assert isinstance(pipe.charset, AttentionCharset)
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
    pipe.bin_thresh = float(torch.quantile(prob.reshape(-1), 0.8))
    out = pipe.run(None, None, pages)
    with torch.no_grad():
        crops = pipe.crops(pages, pipe.regions(pipe.label(prob), prob)).numpy()
    jm, v = pair["jax"], pair["variables"]
    if rec_mode == "beam":
        decode = jax.jit(lambda v, x: jm.decode_beam(v, x, beam_width=5))
    else:
        decode = jax.jit(jm.decode_greedy)
    ids, lengths = jax.device_get(decode(v, jnp.asarray(crops)))
    valid = out["valid"].numpy().reshape(-1)
    assert valid.sum() >= 2
    assert tuple(out["ids"].shape) == (1, 8, 12)
    np.testing.assert_array_equal(out["ids"].reshape(8, 12).numpy()[valid], ids[valid])
    np.testing.assert_array_equal(out["lengths"].reshape(8).numpy()[valid], lengths[valid])


def test_experiment_trains_and_validates_with_the_beam(tmp_path, data):
    """The attention task through ``Experiment``: its charset defaults to
    ``AttentionCharset``, two trainer steps with a validation at step 2, then
    ``evaluate_recognition(mode='beam')``, which equals the measurer on the
    beam predictor's strings."""
    model, _ = _port_model(7, data["batch"]["image"])
    opt = OptimizerConfig(name="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=2,
                          total_steps=20)
    eval_ds = SyntheticRecognitionDataset(n=6, seed=1)
    exp = Experiment(model, SyntheticRecognitionDataset(n=16), eval_dataset=eval_ds,
                     batch_size=8, epochs=1, log_every=1, workspace=str(tmp_path),
                     optimizer=opt, validate_every_steps=2, max_label_len=12)
    assert isinstance(exp.charset, AttentionCharset)
    state = exp.make_trainer().train()
    assert state.step == 2
    with open(os.path.join(tmp_path, "train_metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert all(np.isfinite(r["loss"]) for r in lines if "loss" in r)
    assert [r["step"] for r in lines if "eval/accuracy" in r] == [2]
    beam = evaluate_recognition(exp, mode="beam")
    assert beam["n"] == 6
    raw = exp.collate([eval_ds[i] for i in range(6)])
    preds = RecognizerPredictor(model, mode="beam").predict(None, raw["image"], raw["size"])
    assert RecognitionMeasurer().measure(preds, raw["text"]) == beam
