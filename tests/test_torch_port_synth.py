"""The plain synthetic tier with cv2 and PIL unimportable, as on the card's
machine: the port's items equal the JAX package's bit for bit (images,
sizes, texts, polygons, and the gt, mask, thresh_map and thresh_mask maps),
ICDAR-style polygons that leave the page give the JAX package's maps, the
first items equal the digests ``scripts/make_port_text_assets.py`` wrote
from the JAX package (``assets/synth/manifest.json``, which phase synth of
``chip_smoke.py`` checks on the card), and each of the seven experiment
files that name the plain tier trains a step through ``cli.train`` at
narrow widths in a process where cv2 and PIL cannot be imported (process
loader workers included)."""

import json
import math
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from megreader_tpu.data import datasets as jax_datasets
from megreader_tpu.data import processes as jax_processes
from megreader_tpu_torch.data import datasets, processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _block(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _assert_items_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k == "polygons":
            assert len(got[k]) == len(v)
            for p, q in zip(got[k], v):
                assert p.dtype == q.dtype
                np.testing.assert_array_equal(p, q)
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, canvas_hw=(32, 100)),
                                dict(seed=2, canvas_hw=(24, 60), max_margin=9)],
                         ids=["default", "config_canvas", "shrunk"])
def test_recognition_items_match_jax_without_cv2(kw, monkeypatch):
    """``canvas_hw`` (24, 60) shrinks most crops (``resize_linear``)."""
    n = 48
    ref = [jax_datasets.SyntheticRecognitionDataset(**kw)[i] for i in range(n)]
    _block(monkeypatch)
    ds = datasets.SyntheticRecognitionDataset(**kw)
    for i in range(n):
        _assert_items_equal(ds[i], ref[i])


@pytest.mark.parametrize("kw", [
    dict(n=6, hw=(320, 320), seed=4),
    dict(n=6, hw=(256, 384), seed=1, max_rotate=15.0, max_persp=0.05),
    dict(n=6, hw=(320, 256), seed=9, max_rotate=30.0),
    dict(n=6, hw=(192, 192), seed=3, max_persp=0.1, gt_maps=False),
], ids=["plain", "warped", "rotated", "perspective_no_maps"])
def test_detection_items_match_jax_without_cv2(kw, monkeypatch):
    ref = [jax_datasets.SyntheticDetectionDataset(**kw)[i] for i in range(kw["n"])]
    _block(monkeypatch)
    ds = datasets.SyntheticDetectionDataset(**kw)
    for i in range(kw["n"]):
        _assert_items_equal(ds[i], ref[i])


def _pages_leaving_the_frame(seed, n=8, hw=(160, 224)):
    """Word quads centred anywhere within 25 px of the page, rotated and
    jittered; some ignored; some too small to shrink."""
    rng = np.random.default_rng(seed)
    H, W = hw
    pages = []
    for _ in range(n):
        polys, ignore = [], []
        for _ in range(int(rng.integers(2, 7))):
            w, h, a = rng.uniform(6, 120), rng.uniform(3, 40), rng.uniform(-0.5, 0.5)
            c = np.array([rng.uniform(-25, W + 25), rng.uniform(-25, H + 25)])
            base = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
            R = np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
            polys.append((base @ R.T + c + rng.uniform(-2, 2, (4, 2))).astype(np.float32))
            ignore.append(bool(rng.random() < 0.2))
        pages.append((polys, ignore))
    return pages


def test_maps_of_polygons_leaving_the_page_match_jax_without_cv2(monkeypatch):
    H, W = 160, 224
    pages = _pages_leaving_the_frame(0)
    assert any((p < 0).any() or (p[:, 0] >= W).any() or (p[:, 1] >= H).any()
               for polys, _ in pages for p in polys)
    ref = [(jax_processes.make_seg_maps(p, i, (H, W)),
            jax_processes.make_border_maps(p, i, (H, W))) for p, i in pages]
    _block(monkeypatch)
    for (polys, ignore), (jseg, jborder) in zip(pages, ref):
        seg = processes.make_seg_maps(polys, ignore, (H, W))
        border = processes.make_border_maps(polys, ignore, (H, W))
        for k in ("gt", "mask"):
            np.testing.assert_array_equal(seg[k], jseg[k], err_msg=k)
        for k in ("thresh_map", "thresh_mask"):
            np.testing.assert_array_equal(border[k], jborder[k], err_msg=k)


def test_icdar_dataset_with_polygons_leaving_the_page(tmp_path, monkeypatch):
    """``DetectionICDARDataset`` on PNG pages whose GT quads leave the page:
    resized and augmented items, maps included, equal to JAX's."""
    rng = np.random.default_rng(1)
    img_dir, gt_dir = tmp_path / "img", tmp_path / "gt"
    img_dir.mkdir()
    gt_dir.mkdir()
    for k, (polys, ignore) in enumerate(_pages_leaving_the_frame(2, n=3, hw=(150, 210))):
        cv2.imwrite(str(img_dir / f"p{k}.png"), rng.integers(0, 256, (150, 210, 3), np.uint8))
        lines = [",".join(str(int(v)) for v in p.reshape(-1)) + ("," + ("###" if ig else "word"))
                 for p, ig in zip(polys, ignore)]
        (gt_dir / f"gt_p{k}.txt").write_text("\n".join(lines) + "\n")
    for kw in (dict(target_hw=(128, 160)), dict(target_hw=(128, 128), augment=True, seed=3)):
        jds = jax_datasets.DetectionICDARDataset(str(img_dir), str(gt_dir), **kw)
        ref = [jds[i] for i in range(len(jds))]
        with monkeypatch.context() as m:
            _block(m)
            ds = datasets.DetectionICDARDataset(str(img_dir), str(gt_dir), **kw)
            for i in range(len(ds)):
                _assert_items_equal(ds[i], ref[i])


def test_first_items_match_the_manifest(monkeypatch):
    """The digests phase synth of ``chip_smoke.py`` holds the card's host to,
    here on the CPU with cv2 blocked."""
    import chip_smoke

    with open(os.path.join(REPO, "assets", "synth", "manifest.json")) as f:
        manifest = json.load(f)
    _block(monkeypatch)
    for name, entry in manifest["items"].items():
        ds = getattr(datasets, entry["class"])(**entry["kwargs"])
        for i, want in enumerate(entry["digests"][:6]):
            assert chip_smoke.item_digests(ds[i]) == want, (name, i)


#: the seven files that name the plain synthetic tier, each cut to a narrow
#: net, a few items and one step on the CPU
SEVEN = {
    "ctc_resnet18_synth": {"experiment.model.hidden": 32,
                           "experiment.model.num_encoder_layers": 1},
    "ctc2d_resnet18_synth": {"experiment.model.width": 8},
    "attention_resnet18_synth": {"experiment.model.width": 8, "experiment.model.dim": 32},
    "seg_detector_synth": {"experiment.model.width": 16, "experiment.model.fpn_dim": 32,
                           "experiment.model.head_dim": 16},
    "seg_detector_dcn_synth": {"experiment.model.width": 16, "experiment.model.fpn_dim": 32,
                               "experiment.model.head_dim": 16},
    "roi_spotter_synth": {"experiment.model.fpn_dim": 32, "experiment.model.pool_hw": "[2, 16]",
                          "experiment.model.hidden": 16},
    "shared_spotter_synth": {"experiment.model.fpn_dim": 32, "experiment.model.head_dim": 8,
                             "experiment.model.pool_hw": "[2, 16]",
                             "experiment.model.hidden": 16},
}
_DETECTION = ("seg_detector_synth", "seg_detector_dcn_synth", "roi_spotter_synth",
              "shared_spotter_synth")


@pytest.mark.parametrize("name", sorted(SEVEN))
def test_cli_train_each_synthetic_file_without_cv2(name, tmp_path):
    """``cv2`` and ``PIL`` are modules that raise ImportError, first on the
    path of the process and of its loader workers."""
    blocker = tmp_path / "blocked"
    (blocker / "PIL").mkdir(parents=True)
    for path in (blocker / "cv2.py", blocker / "PIL" / "__init__.py"):
        path.write_text("raise ImportError('not installed on the card machine')\n")
    over = {"experiment.model.device": "cpu", "experiment.workspace": str(tmp_path / "ws"),
            "experiment.batch_size": 2, "experiment.train_dataset.n": 2,
            "experiment.eval_dataset.n": 2, "experiment.epochs": 1, "experiment.log_every": 1,
            "experiment.loader_workers": 1, **SEVEN[name]}
    if name in _DETECTION:
        over.update({"experiment.train_dataset.hw": "[128, 128]",
                     "experiment.eval_dataset.hw": "[128, 128]"})
    argv = [os.path.join(REPO, "experiments", f"{name}.yaml"), "--no-resume"]
    argv += [a for k, v in over.items() for a in (f"--{k}", str(v))]
    code = ("import sys\n"
            "from megreader_tpu_torch.cli import train\n"
            "if __name__ == '__main__':\n"
            f"    state = train.main({argv!r})\n"
            "    assert state.step == 1, state.step\n"
            "    assert sys.modules.get('cv2') is None and sys.modules.get('PIL') is None\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), REPO])}
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    metrics = tmp_path / "ws"
    lines = [json.loads(line) for f in metrics.glob("*_metrics.jsonl")
             for line in f.read_text().splitlines()]
    losses = [v for rec in lines for k, v in rec.items() if "loss" in k]
    assert losses and all(math.isfinite(v) for v in losses), lines
