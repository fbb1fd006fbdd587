"""Port detector training (config #4) against the JAX package, on the CPU.

The DB losses, the device GT maps (whole-page and tiled) against the JAX
rasterizer and against the port's host maps (``data/raster.py``, equal to
the JAX package's cv2 maps, also with cv2 unimportable), one train-mode
``SegDetector.loss`` with every gradient leaf and the updated BatchNorm
statistics, the weights carried back to flax, the detection datasets and
collates, and ``Experiment``'s detection wiring.

One page shape (B 2, 128x128), a detector at fpn 32, head 16, trunk width 16,
and polygon buffers of 4; every JAX call is jitted. The loss step runs in
float64 on both sides, JAX's BatchNorm included (ROADMAP Queue 3: float32
BatchNorm statistics flip ReLUs and move earlier gradients by up to 11%);
the JAX head still casts its maps to float32. Tolerances: loss atol 1e-5;
gradients rtol 1e-3 / atol 1e-6; batch_stats atol 1e-6; GT masks equal,
threshold maps atol 1e-6 (float32 in another order); losses from the same
float64 maps rtol 1e-10."""

import functools
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.data import SyntheticDetectionDataset as JaxSyntheticDetectionDataset
from megreader_tpu.data.loader import detection_collate as jax_detection_collate
from megreader_tpu.data.loader import detection_collate_polys as jax_detection_collate_polys
from megreader_tpu.data import processes as jax_processes
from megreader_tpu.experiment import _detection_prepare_device as jax_prepare_device
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.ops import losses as jax_losses
from megreader_tpu.ops.gt_maps import make_detection_gt as jax_make_detection_gt
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.data import processes
from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
from megreader_tpu_torch.data.loader import detection_collate, detection_collate_polys
from megreader_tpu_torch.experiment import Experiment, _detection_prepare_device
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.ops import gt_maps, losses

B, H, W, P = 2, 128, 128, 4
DET = dict(fpn_dim=32, head_dim=16, width=16)
MAP_KEYS = ("gt", "mask", "thresh_map", "thresh_mask")


def _quad(x0, y0, w, h, rot=0.0):
    c = np.array([x0 + w / 2, y0 + h / 2])
    pts = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
    return (pts @ R.T + c).astype(np.float32)


#: pairs of pages (polygons, ignore flags): the cases of tests/test_gt_maps.py
PAGES = {
    "plain_and_two": [([_quad(20, 30, 60, 18)], [False]),
                      ([_quad(10, 10, 50, 16), _quad(70, 60, 40, 20)], [False, False])],
    "rotated_and_ignored": [([_quad(15, 25, 55, 17, rot=0.3)], [False]),
                            ([_quad(20, 20, 60, 18), _quad(30, 70, 50, 16)], [False, True])],
    "tiny_and_edges": [([_quad(40, 40, 3, 2), _quad(70, 80, 40, 20, rot=0.4)], [False, False]),
                       ([_quad(0, 0, 50, 16), _quad(75, 108, 50, 16)], [False, False])],
    "oversized_and_empty": [([_quad(5, 5, 115, 60), _quad(20, 100, 40, 14)], [False, False]),
                            ([], [])],
}


def _buffers(case):
    return [np.stack(a) for a in zip(*(gt_maps.pad_polygons(p, i, P) for p, i in PAGES[case]))]


@functools.partial(jax.jit, static_argnames="tile_hw")
def _jax_gt(polys, valid, ignore, tile_hw):
    return jax_make_detection_gt(polys, valid, ignore, hw=(H, W), tile_hw=tile_hw)


@pytest.mark.parametrize("tile_hw", [None, (48, 96), (192, 384)], ids=str)
@pytest.mark.parametrize("case", sorted(PAGES))
def test_detection_gt_matches_jax(case, tile_hw):
    bufs = _buffers(case)
    ref = _jax_gt(*(jnp.asarray(a) for a in bufs), tile_hw=tile_hw)
    got = gt_maps.make_detection_gt(*(torch.from_numpy(a) for a in bufs), hw=(H, W),
                                    tile_hw=tile_hw)
    for k in MAP_KEYS:
        assert got[k].dtype == torch.float32 and got[k].shape == (B, H, W)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-6 if k == "thresh_map" else 0, err_msg=k)
    dense = gt_maps.make_detection_gt(*(torch.from_numpy(a) for a in bufs), hw=(H, W),
                                      tile_hw=None)
    for k in MAP_KEYS:  # the tiles merge to the whole-page maps, bit for bit
        assert torch.equal(got[k], dense[k]), k


def _block_cv2(monkeypatch):
    """cv2 and PIL unimportable from here on, as on the card's machine."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _check_host_maps(case, block=None):
    dev = gt_maps.make_detection_gt(*(torch.from_numpy(a) for a in _buffers(case)), hw=(H, W))
    jmaps = [(jax_processes.make_seg_maps(polys, ignore, (H, W)),
              jax_processes.make_border_maps(polys, ignore, (H, W)))
             for polys, ignore in PAGES[case]]
    if block is not None:
        block()
    for b, ((polys, ignore), (jseg, jborder)) in enumerate(zip(PAGES[case], jmaps)):
        seg = processes.make_seg_maps(polys, ignore, (H, W))
        border = processes.make_border_maps(polys, ignore, (H, W))
        for k in ("gt", "mask"):
            np.testing.assert_array_equal(seg[k], jseg[k])
        for k in ("thresh_map", "thresh_mask"):
            np.testing.assert_array_equal(border[k], jborder[k])
        host = {**seg, **border}
        for k, budget in (("gt", 0.01), ("mask", 0.01), ("thresh_mask", 0.02)):
            frac = ((dev[k][b].numpy() > 0.5) != (host[k] > 0.5)).mean()
            assert frac <= budget, f"{k}: {frac:.4f} of the pixels differ"
        both = (dev["thresh_mask"][b].numpy() > 0.5) & (host["thresh_mask"] > 0.5)
        if both.any():
            assert np.abs(dev["thresh_map"][b].numpy() - host["thresh_map"])[both].mean() < 0.03


@pytest.mark.parametrize("case", sorted(PAGES))
def test_detection_gt_matches_host_maps(case):
    """Against the port's host maps (exact geometry against integer
    rasterization): differing pixels only along the boundaries, as
    tests/test_gt_maps.py allows; the host maps equal the JAX package's."""
    _check_host_maps(case)


@pytest.mark.parametrize("case", sorted(PAGES))
def test_detection_gt_matches_host_maps_without_cv2(case, monkeypatch):
    """The same with cv2 and PIL unimportable while the port draws."""
    _check_host_maps(case, lambda: _block_cv2(monkeypatch))


def test_pad_polygons_grows_nothing_and_warns_once():
    with pytest.raises(ValueError, match="exceed buffer capacity"):
        gt_maps.pad_polygons([_quad(0, 0, 9, 9)] * 3, [False] * 3, max_polys=2)
    arrow = np.array([[0, 0], [10, 5], [0, 10], [4, 5]], np.float32)  # not convex
    gt_maps._nonquad_warned = False
    with pytest.warns(UserWarning, match="non-convex"):
        buf, valid, ign = gt_maps.pad_polygons([arrow, _quad(1, 1, 5, 5)], [False, True], 4)
    np.testing.assert_array_equal(valid, [True, True, False, False])
    np.testing.assert_array_equal(ign, [False, True, False, False])
    np.testing.assert_array_equal(buf[0], arrow)


def test_host_geometry_matches_jax():
    lines = ["﻿10,10,60,12,58,30,9,28,hello", "1,2,3,4,5,6,7,8,###", "",
             "0,0,4,0,4,4,0,4,a,b"]
    got, ref = processes.parse_icdar_gt(lines), jax_processes.parse_icdar_gt(lines)
    assert got[1:] == ref[1:] and len(got[0]) == 3
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g, r)
    for poly in (_quad(20, 30, 60, 18), _quad(15, 25, 55, 17, rot=0.3), _quad(3, 4, 5, 6)[::-1]):
        for dist in (-4.0, 3.0):
            np.testing.assert_array_equal(processes.offset_polygon(poly, dist),
                                          jax_processes.offset_polygon_numpy(poly, dist))
        assert processes.shrink_distance(poly, 0.4) == jax_processes.shrink_distance(poly, 0.4)


def _bce_inputs():
    """Page 0: 40 positives, 60 hard negatives and 156 negatives tied at one
    loss; keeping 3 x 40 negatives puts the k-th inside the tie, which keeps
    every tied negative. Page 1: random, with masked-out pixels."""
    rng = np.random.default_rng(4)
    pred = rng.uniform(0.05, 0.95, (B, 16, 16))
    gt = np.zeros((B, 16, 16))
    mask = np.ones((B, 16, 16))
    flat = pred[0].reshape(-1)
    gt[0].reshape(-1)[:40] = 1.0
    flat[40:100] = rng.uniform(0.5, 0.9, 60)
    flat[100:] = 0.1
    gt[1] = rng.random((16, 16)) < 0.2
    mask[1] = rng.random((16, 16)) < 0.9
    thresh = rng.uniform(0.3, 0.7, (B, 16, 16))
    return pred, gt, mask, thresh


def test_losses_and_gradients_match_jax():
    pred, gt, mask, thresh = _bce_inputs()
    fns = {
        "bce": (lambda p: losses.balanced_bce_loss(p, *map(torch.from_numpy, (gt, mask))),
                lambda p: jax_losses.balanced_bce_loss(p, jnp.asarray(gt), jnp.asarray(mask))),
        "dice": (lambda p: losses.dice_loss(p, *map(torch.from_numpy, (gt, mask))),
                 lambda p: jax_losses.dice_loss(p, jnp.asarray(gt), jnp.asarray(mask))),
        "l1": (lambda p: losses.masked_l1_loss(p, *map(torch.from_numpy, (thresh, mask))),
               lambda p: jax_losses.masked_l1_loss(p, jnp.asarray(thresh), jnp.asarray(mask))),
    }
    assert losses.EPS == jax_losses.EPS
    with jax.enable_x64(True):
        for name, (tfn, jfn) in fns.items():
            ref, ref_grad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(pred))
            x = torch.from_numpy(pred.copy()).requires_grad_()
            got = tfn(x)
            got.backward()
            np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-10, err_msg=name)
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=1e-10,
                                       atol=1e-15, err_msg=name)


def test_ohem_keeps_every_tied_negative():
    pred, gt, mask, _ = _bce_inputs()
    p = torch.from_numpy(pred[:1])
    bce = -torch.log(1.0 - torch.clamp(p, losses.EPS, 1 - losses.EPS))
    n_pos, tied = 40, bce.reshape(-1)[100]
    # positives and the 216 kept negatives weigh equally
    kept = (bce.reshape(-1)[40:] >= tied).sum()
    assert int(kept) == 216
    want = (-torch.log(p).reshape(-1)[:40].sum() + bce.reshape(-1)[40:].sum()) \
        / (n_pos + 216 + losses.EPS)
    got = losses.balanced_bce_loss(p, torch.from_numpy(gt[:1]), torch.from_numpy(mask[:1]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


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
def jax_step():
    ds = JaxSyntheticDetectionDataset(n=B, hw=(H, W), seed=2, max_rotate=20.0)
    raw = jax_detection_collate_polys([ds[i] for i in range(B)], max_polys=P)
    batch = jax.device_get(jax.jit(jax_prepare_device)(
        {k: raw[k] for k in ("image", "polys", "poly_valid", "poly_ignore")}))
    model = JaxSegDetector(**DET)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    variables = seeded_flax_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 7)
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731

    def loss_fn(params, batch_stats, batch):
        loss, (metrics, new_state) = model.loss(
            {"params": params, "batch_stats": batch_stats}, batch, train=True)
        return loss, (metrics, new_state["batch_stats"])

    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        v64, b64 = f64(variables), f64(batch)
        (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"], b64)
        out = jax.device_get({"loss": loss, "metrics": metrics, "stats": stats, "grads": grads})
    return {"raw": raw, "batch": batch, "batch64": b64, "variables": variables, **out,
            "model": model}


@pytest.fixture(scope="module")
def port_step(jax_step):
    model = SegDetector(**DET, device="cpu")
    load_flax_variables(model.net, jax_step["variables"])
    model.net.to(torch.float64)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_step["batch64"].items()}
    loss, metrics = model.loss(batch, train=True)
    loss.backward()
    grads = export_flax_variables(model.net, {n: p.grad for n, p in model.net.named_parameters()})
    return {"model": model, "loss": float(loss.detach()), "metrics": metrics, "grads": grads,
            "variables": export_flax_variables(model.net)}


def test_prepared_batch_has_text(jax_step):
    """The comparison means something: text pixels and border bands on both pages."""
    batch = jax_step["batch"]
    assert all(batch["gt"][b].sum() > 20 and batch["thresh_mask"][b].sum() > 50
               for b in range(B))


def test_detector_loss_matches_jax(jax_step, port_step):
    np.testing.assert_allclose(port_step["loss"], float(jax_step["loss"]), rtol=0, atol=1e-5)
    for k in ("bce", "dice", "thresh_l1"):
        np.testing.assert_allclose(float(port_step["metrics"][k]), float(jax_step["metrics"][k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_detector_gradients_match_jax(jax_step, port_step):
    assert list(port_step["grads"]) == ["params"]
    _assert_trees_close(port_step["grads"]["params"], jax_step["grads"], rtol=1e-3, atol=1e-6)


def test_detector_batch_stats_match_jax(jax_step, port_step):
    _assert_trees_close(port_step["variables"]["batch_stats"], jax_step["stats"], rtol=0,
                        atol=1e-6)


def test_trained_port_detector_goes_back_to_flax(jax_step, port_step):
    """After an SGD step on the port, the exported flax tree (thresh head and
    moved batch_stats included) gives the JAX detector the port's maps."""
    model = port_step["model"]
    with torch.no_grad():
        for p in model.net.parameters():
            p -= 0.01 * p.grad
    net = model.net.float()
    variables = export_flax_variables(net)
    image = np.array(jax_step["batch"]["image"], np.float32)
    ref = jax.jit(lambda v, x: jax_step["model"].apply(v, x, train=False))(variables, image)
    got = model.predict_maps(torch.from_numpy(image))
    for k in ("prob", "thresh", "binary"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("opt", [{"dcn_stages": (3, 4)}, {"compute_dtype": "bfloat16"},
                                 {"stem_s2d": True}, {"stem_s2d4": True}],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_left_out_detector_options_raise(opt):
    """Every detector option is ported. ``compute_dtype='bfloat16'`` (held
    to JAX by ``tests/test_torch_port_bf16.py``): float32 parameters, bf16
    convs. ``dcn_stages`` and the space-to-depth stems ``stem_s2d`` /
    ``stem_s2d4``: the maps on carried weights equal JAX's within 1e-4
    (``tests/test_torch_port_deform.py`` and ``test_torch_port_stems.py``
    hold them further)."""
    if opt == {"compute_dtype": "bfloat16"}:
        det = SegDetector(**DET, device="cpu", **opt)
        assert {p.dtype for p in det.net.parameters()} == {torch.float32}
        assert det.net.prob_head.up2.compute_dtype == torch.bfloat16
        return
    if "dcn_stages" in opt or "stem_s2d" in opt or "stem_s2d4" in opt:
        det = SegDetector(**DET, device="cpu", **opt)
        jdet = JaxSegDetector(**DET, **opt)
        variables = seeded_flax_variables(export_flax_variables(det.net), 3)
        load_flax_variables(det.net, variables)
        image = np.random.default_rng(0).standard_normal((1, H, W, 3)).astype(np.float32)
        ref = jdet.net.apply(variables, image, train=False)
        got = det.predict_maps(torch.from_numpy(image))
        for k in ("prob", "thresh", "binary"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4,
                                       err_msg=k)
        return
    raise AssertionError(f"untested option {opt}")


def _check_datasets_and_collates(block=None):
    ds = SyntheticDetectionDataset(n=B, hw=(H, W), seed=3, max_rotate=15.0, max_persp=0.1)
    jds = JaxSyntheticDetectionDataset(n=B, hw=(H, W), seed=3, max_rotate=15.0, max_persp=0.1)
    jsamples = [jds[i] for i in range(B)]
    if block is not None:
        block()
    samples = [ds[i] for i in range(B)]
    for s, js in zip(samples, jsamples):
        assert s["texts"] == js["texts"] and s["ignore"] == js["ignore"]
        np.testing.assert_array_equal(s["image"], js["image"])
        for p, jp in zip(s["polygons"], js["polygons"]):
            np.testing.assert_array_equal(p, jp)
    for collate, jcollate in ((detection_collate, jax_detection_collate),
                              (functools.partial(detection_collate_polys, max_polys=P),
                               functools.partial(jax_detection_collate_polys, max_polys=P))):
        got, ref = collate(samples), jcollate(jsamples)
        assert sorted(got) == sorted(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    many = [{"image": samples[0]["image"], "polygons": [_quad(i, i, 4, 4) for i in range(9)],
             "ignore": [False] * 9}] * B
    grown = detection_collate_polys(many, max_polys=P)  # 9 polygons: 4 -> 8 -> 16
    assert grown["polys"].shape == (B, 16, 4, 2) and grown["poly_valid"].sum() == 9 * B


def test_datasets_and_collates_match_jax():
    _check_datasets_and_collates()


def test_datasets_and_collates_match_jax_without_cv2(monkeypatch):
    """The warped pages and their collates with cv2 and PIL unimportable
    while the port draws."""
    _check_datasets_and_collates(lambda: _block_cv2(monkeypatch))


def test_experiment_device_gt_wiring(jax_step):
    """device_gt (the default): polygon collate, host maps off, the maps
    rasterized in prepare equal to the JAX prepare's; device_gt=False: the
    host maps, cast."""
    ds = SyntheticDetectionDataset(n=B, hw=(H, W), seed=2, max_rotate=20.0)
    exp = Experiment(SegDetector(**DET, device="cpu"), ds, batch_size=B, max_polys=P,
                     loader_workers=1)
    assert ds.gt_maps is False
    raw = exp.collate([ds[i] for i in range(B)])
    assert "polys" in raw and "gt" not in raw
    np.testing.assert_array_equal(raw["polys"], jax_step["raw"]["polys"])
    prepared = exp.prepare(raw)
    ref = jax_step["batch"]
    np.testing.assert_allclose(prepared["image"].numpy(), ref["image"], rtol=0, atol=1e-5)
    for k in MAP_KEYS:
        np.testing.assert_allclose(prepared[k].numpy(), ref[k], rtol=0,
                                   atol=1e-6 if k == "thresh_map" else 0, err_msg=k)
    loss, _ = exp.model.loss(prepared, train=False)
    assert np.isfinite(float(loss.detach()))

    host_ds = SyntheticDetectionDataset(n=B, hw=(H, W), seed=2, max_rotate=20.0)
    host = Experiment(SegDetector(**DET, device="cpu"), host_ds, batch_size=B, device_gt=False,
                      loader_workers=1)
    assert host_ds.gt_maps is True
    raw = host.collate([host_ds[i] for i in range(B)])
    assert raw["gt"].dtype == np.uint8 and raw["thresh_map"].dtype == np.float16
    prepared = host.prepare(raw)
    for k in MAP_KEYS:
        np.testing.assert_array_equal(prepared[k].numpy(), raw[k].astype(np.float32))
    # a device-GT prepare passes host maps through
    passed = _detection_prepare_device(raw, device="cpu")
    assert torch.equal(passed["gt"], prepared["gt"])


def test_experiment_trains_and_validates_detection(tmp_path):
    """Two SGD steps through the Trainer on device GT maps, a validation
    through ``evaluate_detection`` after each, a resume that does nothing."""
    ds = SyntheticDetectionDataset(n=2 * B, hw=(H, W), seed=5)
    model = SegDetector(**DET, device="cpu")
    torch.manual_seed(0)
    exp = Experiment(model, ds, eval_dataset=SyntheticDetectionDataset(n=B, hw=(H, W), seed=6),
                     workspace=str(tmp_path), batch_size=B, epochs=1, log_every=1,
                     validate_every_steps=1, max_polys=P, loader_workers=1)
    state = exp.make_trainer().train()
    assert state.step == 2
    import json

    lines = [json.loads(line) for line in open(tmp_path / "train_metrics.jsonl")]
    losses_ = [r["loss"] for r in lines if "loss" in r]
    evals = [r for r in lines if "eval/hmean" in r]
    assert len(losses_) == 2 and all(np.isfinite(losses_))
    assert [r["step"] for r in evals] == [1, 2]
    assert all(0.0 <= r["eval/precision"] <= 1.0 for r in evals)
    assert exp.make_trainer().train(resume=True).step == 2
