"""The port's text spotters (``megreader_tpu_torch/models/spotter.py``), their
page program (``pipelines/spotter_e2e.py``), the spotting collate, prepare
and evaluation against the JAX package's, on the CPU, at
``tests/test_spotter.py``'s sizes (ResNet-18 at width 64, ``fpn_dim`` 32,
bins (2, 16) or (2, 8), hidden 16; pages of 64x96).

* Weights: ``seeded_flax_variables`` of the JAX init, carried into the port
  (``trans_fc2`` non-zero, so the RoI pooling is deformed).
* Both spotters: logits (and the shared net's maps) in float32 within 1e-4
  of their largest magnitude, the train-mode loss and its metrics (rtol
  1e-4), greedy ids and lengths equal (on JAX's logits everywhere, on the
  port's own where JAX's frames have a margin over 1e-3); perturbing an invalid slot's label
  moves no loss; one float64 train step (loss atol 1e-5, gradients rtol
  1e-3 / atol 1e-5, batch_stats atol 1e-6; the CTC runs on float32 logits
  in both packages) with the JAX BatchNorm in float64 too (ROADMAP Queue 3).
* ``SpotterE2EPipeline`` ``run`` and ``predict`` against the JAX program at
  2x64x96 with K 4 on a prob head calibrated to 20% foreground: labels
  equal (CCL), valid, ids and lengths equal, quads and boxes within 1e-3 px,
  scores within 1e-5; ``bf16=True`` serves the bf16-cast copy.
* ``spotting_collate`` and ``_spotting_prepare`` (with host GT maps and
  without) equal to JAX's; ``evaluate_spotting`` and the experiment's
  ``evaluate`` dispatch give JAX's metrics; ``cli.train`` and ``cli.eval``
  of ``roi_spotter_synth.yaml``, narrowed by dotted overrides.
* Two gloo processes (this file run as a script) each take half of a
  global batch of 4 through ``use_mesh``'s step for both spotters (float64
  nets) and serve one page each through ``build(mesh)``: equal to one
  process on the global batch (loss rtol 1e-6: the CTC sums float32 per-row
  losses in another order; parameters and statistics atol 1e-9).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SGD = dict(name="sgd", lr=0.05, momentum=0.0, weight_decay=0.0, schedule="constant")
ROI_KW = dict(num_classes=12, fpn_dim=32, pool_hw=(2, 16), hidden=16)
SHARED_KW = dict(num_classes=11, fpn_dim=32, head_dim=8, pool_hw=(2, 8), hidden=16)
MAP_KEYS = ("gt", "mask", "thresh_map", "thresh_mask")


def _toy_batch(B=2, P=3, H=64, W=96, L=8, shared=False, seed=0):
    """``tests/test_spotter.py``'s batches: random pages and boxes, slots 2
    and 3 of the pages invalid; with ``shared`` the GT maps too."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, W - 40, (B, P))
    y0 = rng.uniform(0, H - 20, (B, P))
    batch = {
        "image": rng.standard_normal((B, H, W, 3)).astype(np.float32),
        "rois": np.stack([x0, y0, x0 + 36, y0 + 14], -1).astype(np.float32),
        "roi_valid": np.array([[True, True, False], [True, False, False]])[:B],
        "label": rng.integers(1, 10, (B, P, L)).astype(np.int32),
        "label_length": rng.integers(2, 6, (B, P)).astype(np.int32),
    }
    if shared:
        gt = np.zeros((B, H, W), np.float32)
        gt[:, 8:16, 8:40] = 1.0
        tm = np.zeros((B, H, W), np.float32)
        tm[:, 6:18, 6:42] = 1.0
        batch.update(gt=gt, mask=np.ones((B, H, W), np.float32),
                     thresh_map=np.full((B, H, W), 0.3, np.float32), thresh_mask=tm)
    return batch


def _port(kind, **kw):
    from megreader_tpu_torch.models.spotter import RoITextSpotter, SharedTrunkSpotter

    cls = RoITextSpotter if kind == "roi" else SharedTrunkSpotter
    return cls(**{**(ROI_KW if kind == "roi" else SHARED_KW), **kw}, device="cpu")


def _torch(batch, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() and k != "rois" else v
               for k, v in out.items()}
    return out


def _state_arrays(module):
    return {k: v.detach().double().numpy() for k, v in module.state_dict().items()
            if v.is_floating_point()}


# ---------------------------------------------------------------------------
# against JAX


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, ref, rtol, atol):
    import jax

    got, ref = dict(_flat(got)), dict(_flat(jax.device_get(ref)))
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol,
                                   err_msg="/".join(key))


def _jax_model(kind):
    from megreader_tpu.models.spotter import RoITextSpotter as JaxRoI
    from megreader_tpu.models.spotter import SharedTrunkSpotter as JaxShared

    return JaxRoI(**ROI_KW) if kind == "roi" else JaxShared(**SHARED_KW)


@pytest.fixture(scope="module", params=["roi", "shared"])
def carried(request):
    """(kind, JAX task, port task, variables, batch) on shared weights."""
    import jax
    import jax.numpy as jnp

    from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables

    kind = request.param
    jm, tm = _jax_model(kind), _port(kind)
    batch = _toy_batch(shared=kind == "shared")
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
                              jnp.asarray(batch["rois"]))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 21)
    assert np.abs(variables["params"]["roi_pool"]["trans_fc2"]["kernel"]).max() > 0
    load_flax_variables(tm.net, variables)
    return kind, jm, tm, variables, batch


def test_forward_matches_jax(carried):
    import jax

    kind, jm, tm, variables, batch = carried
    ref = jax.jit(lambda v, x, r: jm.apply(v, x, r))(variables, batch["image"], batch["rois"])
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(batch["image"]), torch.from_numpy(batch["rois"]))
    if kind == "roi":
        ref, got = {"logits": ref}, {"logits": got}
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=k)


def test_loss_and_decode_match_jax(carried):
    import jax

    kind, jm, tm, variables, batch = carried
    loss, (metrics, _) = jax.jit(lambda v, b: jm.loss(v, b, train=True))(variables, batch)
    # train mode moves the port's BatchNorm statistics: a copy takes the step
    got, got_metrics = copy.deepcopy(tm).loss(_torch(batch), train=True)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-4)
    assert sorted(got_metrics) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_metrics[k]), float(v), rtol=1e-4, err_msg=k)
    if kind == "roi":
        assert float(got_metrics["n_rois"]) == 3.0
    ids, lens = jax.jit(lambda v, x, r: jm.decode(v, x, r))(variables, batch["image"],
                                                            batch["rois"])
    got_ids, got_lens = tm.decode(torch.from_numpy(batch["image"]),
                                  torch.from_numpy(batch["rois"]))
    assert got_ids.dtype == got_lens.dtype == torch.int32
    # the port's greedy decode of JAX's logits is JAX's, on every slot; its
    # own logits give JAX's ids on every slot whose frames JAX decides by a
    # margin over 1e-3 (random weights leave near-ties: 1e-5 flips those)
    logits = jax.jit(lambda v, x, r: jm.apply(v, x, r))(variables, batch["image"],
                                                         batch["rois"])
    logits = np.asarray(logits if kind == "roi" else logits["logits"])
    from megreader_tpu_torch.models.spotter import _greedy

    same_ids, same_lens = _greedy(torch.from_numpy(logits.copy()), tm.blank)
    np.testing.assert_array_equal(same_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(same_lens.numpy(), np.asarray(lens))
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]).min(-1) > 1e-3  # (B, P)
    assert clear.sum() >= 3
    np.testing.assert_array_equal(got_ids.numpy()[clear], np.asarray(ids)[clear])
    np.testing.assert_array_equal(got_lens.numpy()[clear], np.asarray(lens)[clear])


def test_invalid_slots_move_no_loss(carried):
    """``tests/test_spotter.py``'s perturbation: an invalid slot's label and
    length changed (length 9, longer than any alignment) -> the same loss."""
    kind, _, tm, _, batch = carried
    torch.manual_seed(0)
    with torch.no_grad():
        ref, _ = tm.loss(_torch(batch), train=False)
        other = dict(batch, label=batch["label"].copy(), label_length=batch["label_length"].copy())
        other["label"][1, 2] = 7
        other["label_length"][1, 2] = 9
        got, _ = tm.loss(_torch(other), train=False)
    assert float(got) == float(ref)


def _bn_f64(mp):
    import flax.linen

    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)


def test_float64_train_step_matches_jax(carried):
    import jax

    kind, jm, tm, variables, batch = carried
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa

    def loss_fn(params, stats, b):
        loss, (_, new) = jm.loss({"params": params, "batch_stats": stats}, b, train=True)
        return loss, new["batch_stats"]

    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        _bn_f64(mp)
        v64 = f64(variables)
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"], b64)
        ref = jax.device_get({"loss": loss, "stats": stats, "grads": grads})
    from megreader_tpu_torch.compat.weights import export_flax_variables

    net = copy.deepcopy(tm.net).double()
    model = copy.copy(tm)
    model.net = net
    got, _ = model.loss(_torch(b64), train=True)
    got.backward()
    grads = export_flax_variables(net, {n: p.grad for n, p in net.named_parameters()})
    np.testing.assert_allclose(float(got.detach()), float(ref["loss"]), rtol=0, atol=1e-5)
    _assert_trees_close(grads["params"], ref["grads"], rtol=1e-3, atol=1e-5)
    _assert_trees_close(export_flax_variables(net)["batch_stats"], ref["stats"], rtol=0,
                        atol=1e-6)


def _calibrated_pipeline(bf16=False):
    """A seeded shared-trunk spotter whose prob head's last conv is rescaled
    so that its logits on ``_pages()`` have std 2 and 20% of the pixels lie
    above the binarization threshold (random weights saturate the map), its
    flax variables, and the port pipeline at K 4."""
    import jax
    import jax.numpy as jnp

    from megreader_tpu_torch.compat.weights import (
        export_flax_variables,
        load_flax_variables,
        seeded_flax_variables,
    )
    from megreader_tpu_torch.pipelines.spotter_e2e import SpotterE2EPipeline

    jm, tm = _jax_model("shared"), _port("shared")
    pages = _pages()
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(pages))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 23)
    load_flax_variables(tm.net, variables)
    pipe = SpotterE2EPipeline(tm, max_regions=4, box_thresh=0.0, device="cpu")
    up2 = tm.net.prob_head.up2
    seen = []
    hook = up2.register_forward_hook(lambda m, a, o: seen.append(o))
    with torch.no_grad():
        pipe.detect(tm.net, pipe.fused(tm.net, torch.from_numpy(pages)))
        hook.remove()
        z = seen[0][:, 0].reshape(-1)
        a = 2.0 / z.std()
        c = float(np.log(0.3 / 0.7)) - a * torch.quantile(z, 0.8)
        up2.weight.mul_(a)
        up2.bias.mul_(a).add_(c)
    return jm, tm, export_flax_variables(tm.net), pages, SpotterE2EPipeline(
        tm, max_regions=4, box_thresh=0.0, bf16=bf16, device="cpu")


def _pages():
    """Two light 64x96 pages with dark word-like bars and noise."""
    rng = np.random.default_rng(1)
    pages = 220.0 + 20.0 * rng.standard_normal((2, 64, 96, 3))
    for b in range(2):
        for _ in range(6):
            y, x = rng.integers(2, 52), rng.integers(2, 60)
            pages[b, y:y + rng.integers(6, 11), x:x + rng.integers(14, 34)] = 40.0
    return np.clip(pages, 0, 255).astype(np.float32)


def test_spotter_pipeline_matches_jax():
    from megreader_tpu.pipelines.spotter_e2e import SpotterE2EPipeline as JaxPipeline

    jm, tm, variables, pages, pipe = _calibrated_pipeline()
    jpipe = JaxPipeline(jm, max_regions=4, box_thresh=0.0)
    ref = {k: np.asarray(v) for k, v in jpipe.build()(variables, pages).items()}
    got = {k: v.numpy() for k, v in pipe.run(None, pages).items()}
    assert pipe.resolved_impls == {"ccl": "plain", "extract": "xla"}
    assert sorted(got) == sorted(ref)
    assert ref["valid"].sum() >= 4, "the comparison needs regions"
    for k in ("valid", "ids", "lengths"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, tol in (("quads", 1e-3), ("boxes", 1e-3), ("scores", 1e-5)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol, err_msg=k)
    want = jpipe.predict(variables, pages)
    res = pipe.predict(None, pages)
    assert [[d["text"] for d in p] for p in res] == [[d["text"] for d in p] for p in want]
    for p, q in zip(res, want):
        for d, e in zip(p, q):
            assert sorted(d) == sorted(e)
            np.testing.assert_allclose(d["polygon"], e["polygon"], atol=1e-3)
            assert d["score"] == pytest.approx(e["score"], abs=1e-5)


def test_spotter_pipeline_stages_and_bf16():
    """``run`` is the stages chained; the labels equal the plain CCL's;
    ``bf16=True`` serves a bf16 copy (parameters of the spotter stay
    float32) with the same valid regions on these pages and finite
    outputs."""
    from megreader_tpu_torch.ops.ccl import connected_components_reference

    _, tm, _, pages, pipe = _calibrated_pipeline()
    x = torch.from_numpy(pages)
    with torch.no_grad():
        fused = pipe.fused(tm.net, x)
        prob = pipe.detect(tm.net, fused)
        labels = pipe.label(prob)
        want, _ = connected_components_reference(prob > pipe.bin_thresh, pipe.ccl_iters,
                                                 return_sweeps=True)
        reg = pipe.regions(labels, prob)
        ids, lens = pipe.recognize(tm.net, fused, reg["boxes"])
    assert torch.equal(labels, want)
    out = pipe.run(None, pages)
    assert torch.equal(out["ids"], ids) and torch.equal(out["lengths"], lens)
    *_, pipe16 = _calibrated_pipeline(bf16=True)
    out16 = pipe16.run(None, pages)
    assert pipe16.serving(pipe16.spotter.net).classifier.weight.dtype == torch.bfloat16
    assert pipe16.spotter.net.classifier.weight.dtype == torch.float32
    assert torch.equal(out16["valid"], out["valid"])
    assert all(torch.isfinite(out16[k]).all() for k in ("quads", "boxes", "scores"))


def test_pipeline_refuses_a_spotter_without_maps():
    from megreader_tpu_torch.pipelines.spotter_e2e import SpotterE2EPipeline

    with pytest.raises(TypeError, match="not a shared-trunk spotter"):
        SpotterE2EPipeline(_port("roi"), device="cpu")
    with pytest.raises(ValueError, match="extract_impl"):
        SpotterE2EPipeline(_port("shared"), extract_impl="fast", device="cpu")


def _check_spotting_collate_and_prepare(gt_maps, block=None):
    import functools

    import jax

    from megreader_tpu.core.charset import Charset as JaxCharset
    from megreader_tpu.data import SyntheticDetectionDataset as JaxDataset
    from megreader_tpu.data.loader import spotting_collate as jax_collate
    from megreader_tpu.experiment import _spotting_prepare as jax_prepare
    from megreader_tpu_torch.core.charset import Charset
    from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
    from megreader_tpu_torch.data.loader import spotting_collate
    from megreader_tpu_torch.experiment import _spotting_prepare

    kw = dict(n=4, hw=(256, 256), seed=3, max_rotate=15.0, gt_maps=gt_maps)
    ds, jds = SyntheticDetectionDataset(**kw), JaxDataset(**kw)
    jsamples = [jds[i] for i in range(4)]
    if block is not None:
        block()
    samples = [ds[i] for i in range(4)]
    assert any(len(s["texts"]) > 2 for s in samples)
    for collate_kw in (dict(max_polys=2, max_label_len=6), dict(max_polys=16,
                                                                 max_label_len=16)):
        got = spotting_collate(samples, Charset(), **collate_kw)
        ref = jax_collate(jsamples, JaxCharset(), **collate_kw)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert len(got[k]) == len(v), k
        prepped = _spotting_prepare(got, device="cpu")
        jprepped = jax.device_get(jax.jit(functools.partial(jax_prepare))(
            {k: v for k, v in ref.items() if isinstance(v, np.ndarray)}))
        assert sorted(prepped) == sorted(jprepped)
        assert ("gt" in prepped) == gt_maps
        for k, v in jprepped.items():
            v = np.asarray(v)
            assert prepped[k].numpy().dtype == v.dtype, k
            np.testing.assert_allclose(prepped[k].numpy(), v, rtol=0,
                                       atol=1e-5 if k == "image" else 0, err_msg=k)


@pytest.mark.parametrize("gt_maps", [False, True], ids=["boxes", "with_gt_maps"])
def test_spotting_collate_and_prepare_match_jax(gt_maps):
    _check_spotting_collate_and_prepare(gt_maps)


@pytest.mark.parametrize("gt_maps", [False, True], ids=["boxes", "with_gt_maps"])
def test_spotting_collate_and_prepare_match_jax_without_cv2(gt_maps, monkeypatch):
    """The same with cv2 and PIL unimportable while the port draws its
    warped pages and host maps."""
    def block():
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "PIL", None)

    _check_spotting_collate_and_prepare(gt_maps, block)


def test_experiment_wiring_and_evaluate_spotting_match_jax(tmp_path):
    """Experiment's spotting collate and prepare, the RoI spotter's host GT
    maps turned off and the shared one's kept (as in JAX), and
    ``evaluate_spotting`` (also through ``evaluate``) on carried weights:
    JAX's accuracy, NED and count."""
    import jax
    import jax.numpy as jnp

    from megreader_tpu.data import SyntheticDetectionDataset as JaxDataset
    from megreader_tpu.evaluation import evaluate_spotting as jax_evaluate_spotting
    from megreader_tpu.experiment import Experiment as JaxExperiment
    from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
    from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
    from megreader_tpu_torch.evaluation import evaluate, evaluate_spotting
    from megreader_tpu_torch.experiment import Experiment

    kw = dict(n=4, hw=(128, 128), seed=3)
    common = dict(batch_size=2, epochs=1, max_label_len=16)
    jexp = JaxExperiment(model=_jax_model("roi"), eval_dataset=JaxDataset(**kw),
                         workspace=str(tmp_path / "jax"), use_mesh=False, **common)
    exp = Experiment(_port("roi"), eval_dataset=SyntheticDetectionDataset(**kw),
                     workspace=str(tmp_path / "port"), loader_workers=1, **common)
    assert exp.eval_loader.dataset.gt_maps is False
    batch = next(iter(exp.eval_loader))
    prepped = exp.prepare(batch)
    abstract = jax.eval_shape(jexp.model.init, jax.random.PRNGKey(0),
                              jnp.asarray(prepped["image"].numpy()),
                              jnp.asarray(prepped["rois"].numpy()))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 31)
    load_flax_variables(exp.model.net, variables)
    ref = jax_evaluate_spotting(jexp, variables)
    got = evaluate_spotting(exp)
    assert got["n"] == ref["n"] > 0
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    assert evaluate(exp) == got

    shared = Experiment(_port("shared", num_classes=37),
                        train_dataset=SyntheticDetectionDataset(**kw),
                        workspace=str(tmp_path / "shared"), loader_workers=1, **common)
    assert shared.train_loader.dataset.gt_maps is True
    prepped = shared.prepare(next(iter(shared.train_loader)))
    assert all(prepped[k].dtype == torch.float32 for k in MAP_KEYS)
    loss, metrics = shared.model.loss(prepped, train=True)
    assert torch.isfinite(loss) and float(metrics["ctc"]) > 0


def test_cli_train_and_eval_of_the_roi_spotter_yaml(tmp_path, capsys):
    """``cli.train`` of ``roi_spotter_synth.yaml`` (narrowed and put on the
    CPU by dotted overrides) trains two steps; ``cli.eval`` of its
    workspace prints one JSON line with the step, accuracy and NED."""
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.cli import train as cli_train

    path = os.path.join(ROOT, "experiments", "roi_spotter_synth.yaml")
    over = {"experiment.model.device": "cpu", "experiment.workspace": str(tmp_path),
            "experiment.model.fpn_dim": 32, "experiment.model.hidden": 16,
            "experiment.model.pool_hw": "[2, 16]", "experiment.batch_size": 2,
            "experiment.epochs": 1, "experiment.train_dataset.n": 4,
            "experiment.train_dataset.hw": "[128, 128]", "experiment.eval_dataset.n": 2,
            "experiment.eval_dataset.hw": "[128, 128]", "experiment.loader_workers": 1}
    argv = [a for k, v in over.items() for a in (f"--{k}", str(v))]
    state = cli_train.main([path, "--no-resume", *argv])
    assert state.step == 2
    capsys.readouterr()
    got = cli_eval.main([path, *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    assert got["step"] == 2 and got["n"] > 0 and 0.0 <= got["ned"] <= 1.0
    assert set(got) == {"step", "accuracy", "ned", "n"}


# ---------------------------------------------------------------------------
# two processes


def _global_batch(kind):
    """4 pages, 3 slots each; rank r takes pages 2r, 2r+1."""
    batch = _toy_batch(B=2, shared=kind == "shared", seed=5)
    more = _toy_batch(B=2, shared=kind == "shared", seed=6)
    batch = {k: np.concatenate([v, more[k]]) for k, v in batch.items()}
    return {k: v.astype(np.float64) if v.dtype == np.float32 and k != "rois" else v
            for k, v in batch.items()}


def _model64(kind):
    torch.manual_seed(3)
    model = _port(kind)
    model.net.double()
    return model


def _step(model, batch, mesh=None):
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    state = create_train_state(model, OptimizerConfig(**SGD))
    _, metrics = make_train_step(model, mesh=mesh)(state, batch)
    return float(metrics["loss"]), _state_arrays(model.net)


def _served_model():
    torch.manual_seed(4)
    return _port("shared")


def worker(init_method: str, rank: int, outdir: str) -> None:
    from megreader_tpu_torch.parallel import barrier, init_mesh, shard_batch, sync_batch_norm
    from megreader_tpu_torch.pipelines.spotter_e2e import SpotterE2EPipeline

    torch.set_num_threads(2)
    mesh = init_mesh(init_method, WORLD, rank, device="cpu")
    result = {}
    for kind in ("roi", "shared"):
        model = _model64(kind)
        sync_batch_norm(model.net, mesh)
        block = {k: v[2 * rank:2 * rank + 2] for k, v in _global_batch(kind).items()}
        loss, arrays = _step(model, shard_batch(block, mesh), mesh)
        result[kind] = loss
        if rank == 0:
            np.savez(os.path.join(outdir, f"{kind}.npz"), **arrays)
        barrier()
    pipe = SpotterE2EPipeline(_served_model(), max_regions=4, box_thresh=0.0, device="cpu")
    out = pipe.build(mesh)(None, _pages())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if rank == 0:
        np.savez(os.path.join(outdir, "served.npz"), **{k: v.numpy() for k, v in out.items()})
    barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spotter_parallel")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, __file__, init, str(rank), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for rank in range(WORLD)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return {"ranks": [json.load(open(tmp / f"rank{r}.json")) for r in range(WORLD)],
            "served": dict(np.load(tmp / "served.npz")),
            **{k: dict(np.load(tmp / f"{k}.npz")) for k in ("roi", "shared")}}


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["roi", "shared"])
def test_two_rank_spotter_step_equals_one_process(two_ranks, two_threads, kind):
    batch = _torch(_global_batch(kind))
    loss, want = _step(_model64(kind), batch)
    for r in two_ranks["ranks"]:
        assert r[kind] == pytest.approx(loss, rel=1e-6)
    got = two_ranks[kind]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9, err_msg=k)


def test_sharded_spotter_serving_equals_one_process(two_ranks, two_threads):
    from megreader_tpu_torch.pipelines.spotter_e2e import SpotterE2EPipeline

    pipe = SpotterE2EPipeline(_served_model(), max_regions=4, box_thresh=0.0, device="cpu")
    pages = _pages()
    with torch.no_grad():
        blocks = [pipe.run(None, pages[b:b + 1]) for b in range(WORLD)]
    got = two_ranks["served"]
    assert sorted(got) == sorted(blocks[0])
    for k in got:
        np.testing.assert_array_equal(got[k], np.concatenate([b[k].numpy() for b in blocks]),
                                      err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
