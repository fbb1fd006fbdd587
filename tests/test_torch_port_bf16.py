"""bf16 serving and mixed-precision training of the port against the JAX
package, on the CPU.

Two modes, each on both packages with the same numpy-seeded weights
(``seeded_flax_variables`` of the port's export, carried by
``load_flax_variables``) and the same inputs:

* serving cast: every float leaf rounded to bf16 (``cast_floats`` on both
  sides), bf16 inputs;
* mixed precision: ``compute_dtype='bfloat16'``, float32 parameters.

For each family (CTC, 2D-CTC with Markov heights, attention, detector) at
narrow widths (trunk width 16, hidden, dim and ``fpn_dim`` 32; the CTC net has
no width option, so its trunk is the full ResNet-18 at width 64):

* the outputs (logits, log-probs, maps) within atol ``2e-2 * max|ref|``
  (``3e-2`` for the CTC net: its full-width trunk rounds 17 convs' outputs
  to bf16, and on these weights the port's serving logits lie 0.0219 of
  their largest magnitude from JAX's, where JAX's own bf16 logits lie 0.0195
  from its float32 ones);
* every stage's output dtype equal to JAX's (the trunk's is bf16; the prob
  map, the 2D heads and the attention decoder are float32);
* the task's loss within rtol 1e-2 (train mode under mixed precision, eval
  mode under the serving cast). The CTC loss takes its log-softmax in
  float32 on both sides: the JAX net hands float32 logits to the loss;
* under mixed precision, one SGD step leaves finite float32 parameters;
* two mixed-precision steps of each family through ``Experiment``/``Trainer``
  (Adam): finite losses, float32 parameters, BatchNorm statistics and
  optimizer state; the CTC run's first loss against JAX's on the same batch.

The trained detector (``assets/bench_det_fp16.msgpack``, read by the port's
own decoder) at full width on 2 ``chip_smoke.TextPages`` (seed 5), in float32
and under the serving cast: prob maps within the atol above (``7.5e-2``
under the serving cast: on these pages the port's bf16 map lies 0.0505 from
JAX's, where JAX's own bf16 map lies 0.0325 from its float32 one; the port
rounds each conv's output to bf16 before its BatchNorm, and XLA on the CPU
drops that rounding, so the trunk's C5 already differs by 1.5% of its
largest magnitude and the FPN's output by 0.96%), masks that differ on at
most 0.05% of the pixels, equal valid-region counts and matched quads within
1 px (1.5 px under the serving cast: those extra roundings move one quad of
page 0 by 1.19 px from JAX's bf16 quad and 1.17 px from the port's own
float32 quad, where JAX's bf16 quads lie within 0.40 px of its float32
ones); then ``DetectorPredictor``, and ``E2EPipeline(bf16=True)`` alone and
against the JAX pipeline's ``predict``.

The gaps are bf16 rounding in another order: XLA keeps fused bf16
elementwise chains in float32 (``xla_allow_excess_precision``) where torch
rounds after each op, and the JAX detector head folds each 2x upsample into
the conv after it where the port rounds the upsampled tensor once more.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from megreader_tpu.models.attention import AttentionRecognizer as JaxAttentionRecognizer
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.models.recognizer import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.recognizer2d import Ctc2dRecognizer as JaxCtc2dRecognizer
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.ops.precision import cast_floats as jax_cast_floats
from megreader_tpu.pipelines import E2EPipeline as JaxE2EPipeline
from megreader_tpu.postproc.detection import SegDetectorRepresenter as JaxRepresenter
from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
from megreader_tpu_torch.core.charset import AttentionCharset, Charset
from megreader_tpu_torch.data.datasets import (
    SyntheticDetectionDataset,
    SyntheticRecognitionDataset,
)
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models.attention import AttentionRecognizer
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
from megreader_tpu_torch.ops.image import normalize
from megreader_tpu_torch.ops.precision import cast_floats
from megreader_tpu_torch.pipelines.e2e import E2EPipeline
from megreader_tpu_torch.pipelines.predictors import DetectorPredictor
from megreader_tpu_torch.train.train_step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "bench_det_fp16.msgpack")
FAMILIES = ("ctc", "ctc2d", "attention", "detector")
MODES = ("serving", "mixed")
REL_ATOL = 2e-2
#: the CTC net's full-width trunk (see the module docstring)
REL_ATOL_CTC = 3e-2
#: the trained detector's prob map under the serving cast (see the module docstring)
REL_ATOL_TRAINED_BF16 = 7.5e-2
LOSS_RTOL = 1e-2


def _models(family: str, mode: str):
    """(JAX task, port task on the CPU) of ``family`` for ``mode``."""
    dt = "bfloat16" if mode == "mixed" else "float32"
    if family == "ctc":
        kw = dict(num_classes=37, hidden=32, num_encoder_layers=1, compute_dtype=dt)
        return JaxCTCRecognizer(**kw), CTCRecognizer(**kw, device="cpu")
    if family == "ctc2d":
        kw = dict(num_classes=37, transition="markov", width=16, compute_dtype=dt)
        return JaxCtc2dRecognizer(**kw), Ctc2dRecognizer(**kw, device="cpu")
    if family == "attention":
        kw = dict(num_classes=39, dim=32, max_len=8, width=16, compute_dtype=dt)
        return JaxAttentionRecognizer(**kw), AttentionRecognizer(**kw, device="cpu")
    kw = dict(fpn_dim=32, head_dim=16, width=16, compute_dtype=dt)
    return JaxSegDetector(**kw), SegDetector(**kw, device="cpu")


def _batch(family: str):
    """Numpy inputs and labels of ``family``'s task."""
    rng = np.random.default_rng(7)
    if family == "detector":
        B, H, W = 2, 64, 96
        gt = np.zeros((B, H, W), np.float32)
        gt[:, 20:30, 10:50] = 1.0
        gt[1, 40:52, 30:80] = 1.0
        return {"image": rng.standard_normal((B, H, W, 3)).astype(np.float32), "gt": gt,
                "mask": np.ones((B, H, W), np.float32),
                "thresh_map": rng.uniform(0.3, 0.7, (B, H, W)).astype(np.float32),
                "thresh_mask": (rng.random((B, H, W)) < 0.3).astype(np.float32)}
    B = 4
    image = rng.standard_normal((B, 32, 100, 3)).astype(np.float32)
    if family == "attention":
        lengths = np.array([3, 5, 8, 1], np.int32)  # EOS counted
        label = rng.integers(3, 39, (B, 8)).astype(np.int32)
        for b, n in enumerate(lengths):
            label[b, n - 1] = 2  # EOS
            label[b, n:] = 0  # PAD
        return {"image": image, "label": label, "label_length": lengths}
    lengths = np.array([3, 6, 1, 9], np.int32)
    label = rng.integers(1, 37, (B, 10)).astype(np.int32)
    label[np.arange(10)[None] >= lengths[:, None]] = 0
    return {"image": image, "label": label, "label_length": lengths}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


#: stages whose output dtype both packages must agree on: flax path -> port module
STAGES = {
    "ctc": {("ResNet_0",): "backbone", ("encoder",): "encoder",
            ("classifier",): "classifier"},
    "ctc2d": {("ResNet_0",): "backbone", ("class_head",): "class_head",
              ("trans_head",): "trans_head", ("init_head",): "init_head"},
    "attention": {("trunk",): "trunk", ("mem_proj",): "mem_proj", ("attn_mem",): "attn_mem"},
    "detector": {("ResNet_0",): "backbone", ("fpn",): "fpn", ("prob_head",): "prob_head"},
}


def _one(names) -> str:
    names = set(names)
    assert len(names) == 1, names
    return names.pop()


def _leaf_dtype(out) -> str:
    return _one(str(a.dtype) for a in jax.tree_util.tree_leaves(out))


def _jax_forward(family, jm, variables, x, tgt):
    """(outputs, {flax path: output dtype}) of the JAX net in eval mode."""
    kw = dict(train=False, capture_intermediates=True, mutable=["intermediates"])
    if family == "attention":
        out, st = jax.jit(lambda v, a, t: jm.net.apply(v, a, t, **kw))(variables, x, tgt)
        _, st2 = jax.jit(lambda v, a: jm.net.apply(v, a, method=jm.net.encode, **kw))(
            variables, x)
        inter = {**st["intermediates"], **st2["intermediates"]}
        outs = {"logits": out}
    elif family == "detector":
        out, st = jax.jit(lambda v, a: jm.net.apply(v, a, heads=("prob",), **kw))(variables, x)
        inter, outs = st["intermediates"], {"prob": out["prob"]}
    else:
        out, st = jax.jit(lambda v, a: jm.net.apply(v, a, **kw))(variables, x)
        inter = st["intermediates"]
        outs = {"logits": out} if family == "ctc" else dict(zip(("emit", "trans", "init"), out))
    dtypes = {}
    for path in STAGES[family]:
        node = inter
        for p in path:
            node = node[p]
        dtypes[path] = _leaf_dtype(node["__call__"])
    return {k: np.asarray(v, np.float32) for k, v in outs.items()}, dtypes


@torch.no_grad()
def _port_forward(family, net, x, tgt):
    """(outputs, {flax path: output dtype}) of the port net in eval mode."""
    seen = {}
    hooks = []
    for path, name in STAGES[family].items():
        def hook(mod, inp, out, path=path):
            seen[path] = _one(_name(t.dtype) for t in
                              (out if isinstance(out, tuple) else (out,)))
        hooks.append(net.get_submodule(name).register_forward_hook(hook))
    try:
        net.eval()
        if family == "attention":
            outs = {"logits": net(x, tgt)}
        elif family == "detector":
            outs = {"prob": net(x, heads=("prob",))["prob"]}
        elif family == "ctc":
            outs = {"logits": net(x)}
        else:
            outs = dict(zip(("emit", "trans", "init"), net(x)))
    finally:
        for h in hooks:
            h.remove()
    return outs, seen


def _carried(family, mode):
    jm, tm = _models(family, mode)
    variables = seeded_flax_variables(export_flax_variables(tm.net), 11)
    load_flax_variables(tm.net, variables)
    return jm, tm, variables


def _close(got: torch.Tensor, ref: np.ndarray, what: str, rel=REL_ATOL) -> float:
    got = got.float().numpy()
    scale = float(np.abs(ref).max())
    gap = float(np.abs(got - ref).max())
    assert gap <= rel * scale, f"{what}: max |port - jax| {gap} > {rel} x {scale}"
    return gap / scale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_outputs_and_stage_dtypes_match_jax(family, mode):
    jm, tm, variables = _carried(family, mode)
    batch = _batch(family)
    x = batch["image"]
    tgt = None
    if family == "attention":
        tgt = np.concatenate([np.ones((len(x), 1), np.int32), batch["label"][:, :-1]], 1)
    jv, jx, net, tx = variables, jnp.asarray(x), tm.net, torch.from_numpy(x)
    if mode == "serving":
        jv, jx = jax_cast_floats(variables, jnp.bfloat16), jx.astype(jnp.bfloat16)
        net, tx = cast_floats(tm.net), tx.to(torch.bfloat16)
    ref, ref_dtypes = _jax_forward(family, jm, jv, jx, None if tgt is None else jnp.asarray(tgt))
    got, got_dtypes = _port_forward(family, net, tx,
                                    None if tgt is None else torch.from_numpy(tgt).long())
    assert got_dtypes == ref_dtypes
    assert ref_dtypes[next(iter(STAGES[family]))] == "bfloat16"  # the trunk
    for k in ref:
        assert got[k].dtype == torch.float32, k
        _close(got[k], ref[k], f"{family} {mode} {k}",
               REL_ATOL_CTC if family == "ctc" else REL_ATOL)


def _jax_loss(family, jm, variables, batch, train):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if train:
        fn = jax.jit(lambda v, bb: jm.loss(v, bb, train=True)[0])
    else:
        fn = jax.jit(lambda v, bb: jm.loss(v, bb, train=False)[0])
    return float(fn(variables, b))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_losses_match_jax(family, mode):
    """Mixed precision: the train-mode loss (batch statistics). Serving cast:
    the eval-mode loss of the cast weights on bf16 images."""
    jm, tm, variables = _carried(family, mode)
    batch = _batch(family)
    train = mode == "mixed"
    jv, jb = variables, dict(batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mode == "serving":
        jv = jax_cast_floats(variables, jnp.bfloat16)
        jb["image"] = jnp.asarray(batch["image"]).astype(jnp.bfloat16)
        tm.net = cast_floats(tm.net)
        tb["image"] = tb["image"].to(torch.bfloat16)
    ref = _jax_loss(family, jm, jv, jb, train)
    with torch.set_grad_enabled(train):
        got, _ = tm.loss(tb, train=train)
    assert got.dtype == torch.float32
    assert np.isfinite(ref)
    np.testing.assert_allclose(float(got.detach()), ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_precision_sgd_step_keeps_float32(family):
    """JAX's invariants: parameters (and BatchNorm statistics) stay float32
    after an SGD step, and they move; the gradients reach every float32
    leaf."""
    _, tm, _ = _carried(family, "mixed")
    before = {n: p.detach().clone() for n, p in tm.net.named_parameters()}
    state = create_train_state(tm, OptimizerConfig(name="sgd", lr=0.01, schedule="constant"))
    tb = {k: torch.from_numpy(v) for k, v in _batch(family).items()}
    state, metrics = make_train_step(tm)(state, tb)
    assert torch.isfinite(metrics["loss"])
    for n, t in [*tm.net.named_parameters(), *tm.net.named_buffers()]:
        if t.is_floating_point():
            assert t.dtype == torch.float32, n
            assert torch.isfinite(t).all(), n
    moved = [n for n, p in tm.net.named_parameters() if not torch.equal(p, before[n])]
    missing = [n for n, p in tm.net.named_parameters()
               if p.grad is None or p.grad.dtype != torch.float32]
    # the thresh head and the attention net's embedding of unused ids still move
    assert not missing, missing
    assert len(moved) == len(before)


def _experiment(family, model, workspace):
    if family == "detector":
        data = SyntheticDetectionDataset(n=2, hw=(128, 128), seed=5)
        return Experiment(model, data, workspace=workspace, batch_size=2, epochs=2,
                          log_every=1, max_polys=4, loader_workers=1)
    charset = AttentionCharset() if family == "attention" else Charset()
    data = SyntheticRecognitionDataset(n=8, charset=charset)
    return Experiment(model, data, workspace=workspace, batch_size=8, epochs=2, log_every=1,
                      max_label_len=8 if family == "attention" else 32, loader_workers=1)


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_precision_trains_through_experiment(family, tmp_path):
    """Two Adam steps on one batch (each epoch the whole dataset, so the
    first step's loss does not depend on the loader's order). The CTC loss of
    the first step equals JAX's train-mode loss on the same weights and batch
    (rtol 1e-2): the JAX net hands float32 logits to the loss, as the port's
    does, and both take the log-softmax in float32."""
    jm, tm, variables = _carried(family, "mixed")
    exp = _experiment(family, tm, str(tmp_path))
    batch = {k: v.numpy() for k, v in exp.prepare(exp.collate(
        [exp.train_loader.dataset[i] for i in range(len(exp.train_loader.dataset))])).items()}
    state = exp.make_trainer().train()
    assert state.step == 2
    with open(tmp_path / "train_metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for n, t in [*tm.net.named_parameters(), *tm.net.named_buffers()]:
        if t.is_floating_point():
            assert t.dtype == torch.float32 and torch.isfinite(t).all(), n
    opt_state = state.optimizer.inner.state
    assert opt_state and all(v.dtype == torch.float32 for st in opt_state.values()
                             for v in st.values() if torch.is_tensor(v) and v.dim())
    if family == "ctc":
        ref = _jax_loss(family, jm, variables, batch, train=True)
        np.testing.assert_allclose(losses[0], ref, rtol=LOSS_RTOL)


# --- the trained detector ------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    variables, step = load_flax_msgpack(ASSET)
    data = chip_smoke.TextPages(2, 5)
    items = [data[i] for i in range(2)]
    pages = np.stack([it["image"] for it in items]).astype(np.float32)
    det = SegDetector(device="cpu")
    load_flax_variables(det.net, variables)
    jdet = JaxSegDetector()
    out = {"step": step, "pages": pages, "items": items, "det": det, "prob": {}, "jprob": {},
           "variables": variables}
    for mode in ("float32", "serving"):
        jv, net, cast = variables, det.net, (lambda a: a)
        if mode == "serving":
            jv, net = jax_cast_floats(variables, jnp.bfloat16), cast_floats(det.net)
            cast = lambda a: a.astype(jnp.bfloat16)  # noqa: E731
        fn = jax.jit(lambda v, p: jdet.net.apply(v, cast(jax_normalize(p)), train=False,
                                                 heads=("prob",))["prob"])
        jprob = fn(jv, jnp.asarray(pages))
        assert jprob.dtype == jnp.float32
        out["jprob"][mode] = np.asarray(jprob)
        x = normalize(torch.from_numpy(pages))
        if mode == "serving":
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            out["prob"][mode] = net.eval()(x, heads=("prob",))["prob"]
    return out


def _quads(prob, representer):
    return [(page["polygons"], page["scores"]) for page in representer.represent(prob)]


@pytest.mark.parametrize("mode", ["float32", "serving"])
def test_trained_detector_matches_jax(trained, mode):
    """Prob maps, masks, valid regions and their quads against JAX on the
    trained weights."""
    assert trained["step"] == 640
    prob, jprob = trained["prob"][mode], trained["jprob"][mode]
    assert prob.dtype == torch.float32
    _close(prob, jprob, f"trained detector {mode} prob",
           REL_ATOL_TRAINED_BF16 if mode == "serving" else REL_ATOL)
    mask, jmask = prob.numpy() > 0.3, jprob > 0.3
    assert (mask != jmask).mean() <= 5e-4
    assert 0.005 < mask.mean() < 0.05  # the words, not the page
    from megreader_tpu_torch.postproc.detection import SegDetectorRepresenter

    got = _quads(prob, SegDetectorRepresenter())
    ref = _quads(jnp.asarray(jprob), JaxRepresenter())
    for (q, _), (jq, _), item in zip(got, ref, trained["items"]):
        assert len(q) == len(jq) >= len(item["polygons"])
        for corners in q:
            d = np.abs(np.asarray(jq) - corners[None]).max(axis=(1, 2)).min()
            assert d <= (1.5 if mode == "serving" else 1.0)


def test_detector_predictor_serves_the_trained_detector(trained):
    """``DetectorPredictor`` on the float32 trained detector: the
    representer's quads of the prob map above, one per drawn word or more."""
    got = DetectorPredictor(trained["det"]).predict(None, trained["pages"])
    from megreader_tpu_torch.postproc.detection import SegDetectorRepresenter

    ref = SegDetectorRepresenter().represent(trained["prob"]["float32"])
    assert len(got) == 2
    for g, r, item in zip(got, ref, trained["items"]):
        np.testing.assert_array_equal(g["polygons"], r["polygons"])
        assert len(g["polygons"]) >= len(item["polygons"])


def test_bf16_pipeline_serves_the_trained_detector(trained):
    """``E2EPipeline(bf16=True)``: the detector and the recognizer run as
    bf16 copies made once, the prob map is float32 and equals the serving
    cast's above, and every drawn word gets a valid region."""
    rec = CTCRecognizer(37, hidden=32, num_encoder_layers=1, device="cpu")
    det = trained["det"]
    pipe = E2EPipeline(det, rec, bf16=True, device="cpu", max_regions=16)
    pages = torch.from_numpy(trained["pages"])
    prob = pipe.detect(det.net, pages)
    assert prob.dtype == torch.float32
    torch.testing.assert_close(prob, trained["prob"]["serving"], rtol=0, atol=0)
    copy = pipe.serving(det.net)
    assert copy is pipe.serving(det.net) and copy is not det.net
    assert {p.dtype for p in copy.parameters()} == {torch.bfloat16}
    assert pipe.crops(pages, pipe.regions(pipe.label(prob), prob)).dtype == torch.bfloat16
    out = pipe.run(None, None, pages)
    for b, item in enumerate(trained["items"]):
        assert int(out["valid"][b].sum()) >= len(item["polygons"])
    assert out["ids"].dtype == torch.int32
    with torch.no_grad():
        rec.net.classifier.bias.add_(1.0)  # new weights: a new copy
    assert pipe.serving(rec.net).classifier.bias.dtype == torch.bfloat16
    torch.testing.assert_close(pipe.serving(rec.net).classifier.bias,
                               rec.net.classifier.bias.to(torch.bfloat16))


def test_bf16_pipeline_matches_jax(trained):
    """``E2EPipeline(bf16=True).predict`` against the JAX pipeline's on the
    trained detector and a seeded narrow CTC recognizer: the same regions
    on each page, quads within the serving cast's 1.5 px, scores (the mean
    prob of a region) within 0.02."""
    rec = CTCRecognizer(37, hidden=32, num_encoder_layers=1, device="cpu")
    rec_vars = seeded_flax_variables(export_flax_variables(rec.net), 113)
    load_flax_variables(rec.net, rec_vars)
    opts = dict(max_regions=16, bf16=True)
    ref = JaxE2EPipeline(JaxSegDetector(), JaxCTCRecognizer(37, hidden=32, num_encoder_layers=1),
                         **opts).predict(trained["variables"], rec_vars, trained["pages"])
    got = E2EPipeline(trained["det"], rec, device="cpu", **opts).predict(
        None, None, trained["pages"])
    for gp, rp, item in zip(got, ref, trained["items"]):
        assert len(gp) == len(rp) == len(item["polygons"])
        jq = np.stack([r["quad"] for r in rp])
        for g in gp:
            d = np.abs(jq - g["quad"][None]).max(axis=(1, 2))
            assert d.min() <= 1.5
            assert abs(g["score"] - rp[int(d.argmin())]["score"]) <= 0.02
