"""The port's training data path against the JAX package on the CPU, on files
that cv2 writes: the list-file and ICDAR disk datasets (plain and augmented),
the mixture, ``det_augment``, the hard synthetic tier, process against
thread workers, and the weights of a JAX msgpack checkpoint.

Tolerances: pixels equal, resized ones too (the port's ``resize_linear`` is
``cv2.resize``'s fixed-point arithmetic); polygons, ignore flags,
texts, sizes, order and host GT maps exactly equal; the hard tier's items
bit for bit, the port's drawn with cv2, PIL and the fonts hidden; batches
of process and thread workers bit for bit; the logits of a restored
checkpoint within ``test_torch_port_models.py``'s 1e-4."""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.data import datasets as jax_datasets
from megreader_tpu.data import det_augment as jax_det_augment
from megreader_tpu.data import hard_synth as jax_hard
from megreader_tpu.models.recognizer import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from megreader_tpu.train.train_step import OptimizerConfig as JaxOptimizerConfig
from megreader_tpu.train.train_step import TrainState as JaxTrainState
from megreader_tpu_torch.compat.weights import seeded_flax_variables
from megreader_tpu_torch.core.charset import Charset
from megreader_tpu_torch.data import datasets, det_augment
from megreader_tpu_torch.data import hard_synth
from megreader_tpu_torch.data.loader import Loader, detection_collate_polys, recognition_collate
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.train.checkpoint import CheckpointManager


def _noise_image(rng, h, w):
    """A blurred noise image: resizes of it stay within a grey level of cv2."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


def write_crops(root, n=10, seed=0):
    """``n`` word crops written by cv2 and their list file; crops 3, 6 and 9
    are larger than the 64x256 canvas (the datasets shrink them)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "crops"), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = (80, 300) if i % 3 == 0 and i else (int(rng.integers(12, 60)),
                                                   int(rng.integers(20, 250)))
        rel = f"crops/w{i}.png"
        cv2.imwrite(os.path.join(root, rel), _noise_image(rng, h, w))
        lines.append(f"{rel}\tword{i} x")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")
    return path


def write_pages(root, n=4, hw=(96, 128), seed=0):
    """An ICDAR dir pair written by cv2: ``n`` pages with 3-5 quads each,
    one ``###`` line a page, GT named ``gt_<page>.txt`` for even pages and
    ``<page>.txt`` for odd ones, with a byte-order mark on the first."""
    rng = np.random.default_rng(seed)
    img_dir, gt_dir = os.path.join(root, "images"), os.path.join(root, "gts")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    H, W = hw
    for i in range(n):
        name = f"page_{i:03d}"
        cv2.imwrite(os.path.join(img_dir, name + ".png"), _noise_image(rng, H, W))
        lines = []
        for k in range(int(rng.integers(3, 6))):
            x0, y0 = rng.integers(0, W - 30), rng.integers(0, H - 12)
            x1, y1 = x0 + rng.integers(10, 30), y0 + rng.integers(6, 12)
            text = "###" if k == 0 else f"t{i}{k}"
            lines.append(f"{x0},{y0},{x1},{y0},{x1},{y1},{x0},{y1},{text}")
        gt = os.path.join(gt_dir, f"gt_{name}.txt" if i % 2 == 0 else f"{name}.txt")
        with open(gt, "w", encoding="utf-8-sig" if i == 0 else "utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return img_dir, gt_dir


def assert_pixels(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def assert_polygons(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_list_dataset_matches_jax(tmp_path):
    path = write_crops(str(tmp_path))
    ref, got = jax_datasets.RecognitionListDataset(path), datasets.RecognitionListDataset(path)
    assert len(got) == len(ref) == 10
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert b["text"] == a["text"] == f"word{i} x"
        np.testing.assert_array_equal(b["size"], a["size"])
        assert_pixels(b["image"], a["image"])


@pytest.mark.parametrize("augment", [False, True])
def test_icdar_dataset_matches_jax(tmp_path, augment):
    """Plain: resized to 80x112 with the polygons and scale; augmented:
    flipped, scaled and cropped to 64x64 from each page's stream (3 seeds).
    Host GT maps equal."""
    img_dir, gt_dir = write_pages(str(tmp_path))
    seeds = (0, 1, 2) if augment else (0,)
    hw = (64, 64) if augment else (80, 112)
    for seed in seeds:
        kw = dict(target_hw=hw, augment=augment, seed=seed)
        ref = jax_datasets.DetectionICDARDataset(img_dir, gt_dir, **kw)
        got = datasets.DetectionICDARDataset(img_dir, gt_dir, **kw)
        assert got.names == ref.names and len(got) == 4
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            assert_pixels(b["image"], a["image"])
            assert_polygons(b["polygons"], a["polygons"])
            assert b["ignore"] == a["ignore"] and b["texts"] == a["texts"]
            assert b["filename"] == a["filename"]
            np.testing.assert_array_equal(b["scale"], a["scale"])
            for k in ("gt", "mask", "thresh_map", "thresh_mask"):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            if not augment:
                assert a["ignore"][0] and a["texts"][0] == "###"
    with pytest.raises(FileNotFoundError, match="no GT"):
        os.remove(os.path.join(gt_dir, "page_001.txt"))
        got[1]


def test_mixture_matches_jax(tmp_path):
    path = write_crops(str(tmp_path), n=7)
    small = write_crops(str(tmp_path / "b"), n=3, seed=1)
    ref = jax_datasets.MixtureDataset([jax_datasets.RecognitionListDataset(path),
                                       jax_datasets.RecognitionListDataset(small)])
    got = datasets.MixtureDataset([datasets.RecognitionListDataset(path),
                                   datasets.RecognitionListDataset(small)])
    assert got._index == ref._index and len(got) == 10
    assert [got[i]["text"] for i in range(10)] == [ref[i]["text"] for i in range(10)]


@pytest.mark.parametrize("seed", range(6))
def test_det_augment_matches_jax(seed):
    """Each function and the whole chain on a 150x210 page, from equal numpy
    generators: the flip and the crop exact, the scale within a grey level."""
    rng = np.random.default_rng(100 + seed)
    img = _noise_image(rng, 150, 210)
    polys = [np.array([[x, y], [x + 30, y], [x + 30, y + 12], [x, y + 12]], np.float32)
             for x, y in rng.integers(0, 140, (5, 2))]
    ignore = [bool(v) for v in rng.random(5) < 0.3]

    def both(fn_ref, fn_got, *args):
        return (fn_ref(np.random.default_rng(seed), *args),
                fn_got(np.random.default_rng(seed), *args))

    (ri, rp), (gi, gp) = both(jax_det_augment.random_flip, det_augment.random_flip, img, polys)
    assert_pixels(gi, ri)
    assert_polygons(gp, rp)
    (ri, rp), (gi, gp) = both(jax_det_augment.random_scale, det_augment.random_scale, img,
                              polys)
    assert_pixels(gi, ri)
    assert_polygons(gp, rp)
    (ri, rp, rg), (gi, gp, gg) = both(jax_det_augment.random_crop_biased,
                                      det_augment.random_crop_biased, img, polys, ignore,
                                      (96, 96))
    assert_pixels(gi, ri)
    assert_polygons(gp, rp)
    assert gg == rg
    ref, got = both(jax_det_augment.augment_detection_sample,
                    det_augment.augment_detection_sample, img, polys, ignore, (96, 96))
    assert_pixels(got["image"], ref["image"])
    assert_polygons(got["polygons"], ref["polygons"])
    assert got["ignore"] == ref["ignore"]


def _assert_items_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        elif k == "polygons":
            assert_polygons(got[k], ref[k])
        else:
            assert got[k] == ref[k], k


def _hide_cv2_pil_and_fonts(monkeypatch):
    """The card's machine as the port sees it: cv2 and PIL unimportable, the
    JAX package's DejaVu directory pointed nowhere, the port's masks replayed
    anew from its glyph table. Call it after drawing the JAX items, which
    need all three."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(jax_hard, "_DEJAVU_DIR", "/nonexistent/fonts")
    monkeypatch.setattr(hard_synth, "_CHAR_CACHE", {})


HARD_REC = {
    "default": {},
    "curved": dict(curve_prob=1.0, curve_range=(0.35, 0.9), degrade=0.5, distractors=False,
                   canvas_hw=(48, 160)),
    "straight_clean": dict(curve_prob=0.0, degrade=0.0, distractors=True, fonts="ttf"),
    "hershey": dict(fonts="hershey", polarity="dark", max_len=6),
    # the keyword arguments of ctc_curved_ab (and ctc2d_curved_ab) and of
    # ctc_hard_small's second part
    "curved_ab": dict(seed=10, curve_prob=1.0, curve_range=(0.35, 0.9), degrade=0.5,
                      distractors=False),
    "hard_small": dict(seed=11, min_height=12, max_height=20),
}


@pytest.mark.parametrize("kind", list(HARD_REC))
def test_hard_recognition_items_match_jax(kind, monkeypatch):
    """The JAX items are drawn with cv2, PIL and the fonts; the port's without
    any of them."""
    kw = {"n": 8, "seed": 3, **HARD_REC[kind]}
    jds = jax_hard.HardSyntheticRecognitionDataset(**kw)
    ref = [jds[i] for i in range(8)]
    _hide_cv2_pil_and_fonts(monkeypatch)
    got = hard_synth.HardSyntheticRecognitionDataset(**kw)
    assert [hard_synth.font_label(f) for f in got.fonts] == \
        [jax_hard.font_label(f) for f in jds.fonts]
    for i in range(8):
        _assert_items_equal(got[i], ref[i])


@pytest.mark.parametrize("kind", ["curved", "straight", "spotter"])
def test_hard_detection_items_match_jax(kind, monkeypatch):
    """Pages with chain polygons (curved) or rotated quads, host GT maps from
    ``chain_seg_maps``, page degradation; ``spotter`` has
    shared_spotter_hard's keyword arguments (straight words rotated by up to
    15 degrees)."""
    kw = dict(n=2, hw=(160, 224), seed=4, words_range=(2, 4))
    if kind == "curved":
        kw.update(curve_prob=1.0, degrade=1.0)
    elif kind == "straight":
        kw.update(curve_prob=0.0, max_rotate=0.0)
    else:
        kw.update(curve_prob=0.0, max_rotate=15.0, seed=0)
    jds = jax_hard.HardSyntheticDetectionDataset(**kw)
    ref = [jds[i] for i in range(2)]
    _hide_cv2_pil_and_fonts(monkeypatch)
    got = hard_synth.HardSyntheticDetectionDataset(**kw)
    for i in range(2):
        a, b = ref[i], got[i]
        _assert_items_equal(b, a)
        assert a["polygons"]
        if kind == "curved":
            assert max(len(p) for p in a["polygons"]) > 4


def test_hard_tier_draws_without_cv2_pil_and_fonts(monkeypatch):
    """Every font of the tier at both ends of its heights, and items of both
    datasets, with cv2 and PIL unimportable and no font file readable: no
    file but the glyph table is opened."""
    import builtins

    _hide_cv2_pil_and_fonts(monkeypatch)
    hard_synth._glyph_table.cache_clear()
    real_open, opened = builtins.open, []

    def watch(path, *a, **k):
        opened.append(str(path))
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", watch)
    for font in hard_synth.available_fonts():
        for h in (12, 48):
            for ch in "a0z9":
                mask, base, adv = hard_synth._char_mask(font, h, ch)
                assert mask.dtype == np.uint8 and mask.any() and adv >= 1 and base > 0
    rec = hard_synth.HardSyntheticRecognitionDataset(n=4, seed=5)[3]
    det = hard_synth.HardSyntheticDetectionDataset(n=1, hw=(128, 160), seed=5)[0]
    assert rec["image"].shape == (64, 256, 3) and det["image"].shape == (128, 160, 3)
    assert set(opened) <= {hard_synth.GLYPHS}, opened
    assert sys.modules["cv2"] is None and sys.modules["PIL"] is None
    hard_synth._glyph_table.cache_clear()


def test_hard_tier_without_its_table_raises_file_not_found(monkeypatch, tmp_path):
    missing = str(tmp_path / "hard_tier.npz")
    monkeypatch.setattr(hard_synth, "GLYPHS", missing)
    monkeypatch.setattr(hard_synth, "_CHAR_CACHE", {})
    hard_synth._glyph_table.cache_clear()
    try:
        for ds in (hard_synth.HardSyntheticRecognitionDataset(n=2),
                   hard_synth.HardSyntheticDetectionDataset(n=1, hw=(96, 128))):
            with pytest.raises(FileNotFoundError, match=missing):
                ds[0]
    finally:
        hard_synth._glyph_table.cache_clear()


@pytest.mark.parametrize("height, ch", [(11, "a"), (49, "a"), (20, "A"), (20, "#")])
def test_hard_tier_outside_its_table_raises_key_error(height, ch, monkeypatch):
    """A height or character the table does not hold raises; nothing draws
    it instead, even where cv2 and PIL are installed."""
    monkeypatch.setattr(hard_synth, "_CHAR_CACHE", {})
    font = hard_synth.available_fonts()[2]
    with pytest.raises(KeyError, match=f"DejaVuSerif.*height {height}.*{ch!r}"):
        hard_synth._char_mask(font, height, ch)
    if ch == "a":  # a dataset asked for that height raises too
        ds = hard_synth.HardSyntheticRecognitionDataset(n=2, min_height=height,
                                                        max_height=height)
        with pytest.raises(KeyError, match=f"height {height}"):
            ds[0]


@pytest.mark.parametrize("task", ["recognition", "detection"])
def test_process_workers_give_the_thread_batches(tmp_path, task):
    """Two shuffled epochs through forkserver process workers and through
    threads: the same batches, bit for bit."""
    if task == "recognition":
        ds = datasets.RecognitionListDataset(write_crops(str(tmp_path), n=12))

        def collate(s):
            return recognition_collate(s, Charset())
    else:
        ds = datasets.DetectionICDARDataset(*write_pages(str(tmp_path), n=6), target_hw=(64, 64),
                                            augment=True, gt_maps=False)
        collate = detection_collate_polys
    runs = {}
    for mode in ("process", "thread"):
        loader = Loader(ds, 4, collate, shuffle=True, seed=3, workers=2, worker_mode=mode)
        runs[mode] = [b for _ in range(2) for b in loader]
        loader.close()
    assert len(runs["process"]) == len(runs["thread"]) == 2 * (len(ds) // 4)
    for p, t in zip(runs["process"], runs["thread"]):
        assert p.keys() == t.keys()
        for k in p:
            if isinstance(p[k], np.ndarray):
                assert p[k].dtype == t[k].dtype
                np.testing.assert_array_equal(p[k], t[k], err_msg=k)
            else:
                assert len(p[k]) == len(t[k])


def test_loader_raises_a_dataset_error(tmp_path):
    """An item that raises stops the epoch with that error (no batch is
    dropped in silence)."""
    ds = datasets.RecognitionListDataset(write_crops(str(tmp_path), n=8))
    os.remove(os.path.join(str(tmp_path), "crops", "w5.png"))
    loader = Loader(ds, 4, lambda s: recognition_collate(s, Charset()), workers=2)
    with pytest.raises(FileNotFoundError):
        list(loader)


def test_restore_jax_checkpoint(tmp_path):
    """A JAX msgpack checkpoint of a small CTC recognizer (hidden 32, one
    BiLSTM layer, seeded weights): the port reads its step and weights and
    gives the JAX logits within 1e-4. An orbax checkpoint and an empty
    workspace raise."""
    x = np.random.default_rng(0).standard_normal((2, 32, 100, 3)).astype(np.float32)
    jm = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
    variables = seeded_flax_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 5)
    state = JaxTrainState(step=jnp.asarray(7, jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=JaxOptimizerConfig(name="adam").make().init(
                              variables["params"]))
    jax_ws = str(tmp_path / "jax")
    JaxCheckpointManager(jax_ws, use_orbax=False).save(state, force=True)

    model = CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "port"))
    assert mgr.restore_jax_variables(model.net, jax_ws) == 7
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = model.net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)

    with pytest.raises(FileNotFoundError, match="no JAX msgpack checkpoint"):
        mgr.restore_jax_variables(model.net)
    orbax_ws = str(tmp_path / "orbax")
    orbax = JaxCheckpointManager(orbax_ws, use_orbax=True, async_save=False)
    orbax.save(state, force=True)
    orbax.wait()
    with pytest.raises(NotImplementedError, match="orbax"):
        mgr.restore_jax_variables(model.net, orbax_ws)
