"""The port's tools against the JAX package's and cv2 on the CPU:

* ``utils/profiling.py``: ``StepTimer``'s percentiles (JAX's test), a
  ``trace`` file naming an ``annotate`` region;
* ``postproc/visualizer.py``: polylines pixel-equal to ``cv2.polylines(...,
  True, color, thickness)`` (quads, polygons of up to 16 points, polygons
  across the canvas edge, random backgrounds; thickness 0 and 1 too, with
  segments leaving the canvas and zero-length ones, open and closed), the JET table and
  ``heatmap_overlay`` bit-equal to the JAX package's, labels against
  ``cv2.putText`` within the bound measured here, ``draw_polygons`` and
  ``visualize`` pixel-equal to the JAX package's (decoded PNGs);
* ``utils/webviewer.py`` on a port the system picks, ``imageio.encode_png``;
* the entry points: ``cli.pipeline --out-dir`` and ``cli.demo`` with the
  trained detector of ``assets/bench_det_fp16.msgpack`` on two committed
  1280x720 pages (one baseline, one progressive JPEG). Their overlays are
  pixel-equal to what the JAX entry points write for the same detections:
  the JAX package's ``DetectionVisualizer.visualize`` with the same page,
  polygons and texts (the call its ``cli/pipeline.py`` and ``cli/demo.py``
  make); the detections themselves are held to ``DetectorPredictor`` here,
  to ``E2EPipeline`` in ``test_torch_port_cli.py`` and to JAX in
  ``test_torch_port_e2e.py``.
"""

import ast
import json
import os
import tempfile
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from megreader_tpu.postproc import visualizer as jax_vis
from megreader_tpu.utils import webviewer as jax_webviewer
from megreader_tpu_torch.cli import demo as cli_demo
from megreader_tpu_torch.cli import pipeline as cli_pipeline
from megreader_tpu_torch.compat.msgpack import load_flax_msgpack, msgpack_serialize
from megreader_tpu_torch.compat.weights import export_flax_variables, load_flax_variables
from megreader_tpu_torch.data import imageio
from megreader_tpu_torch.data.imageio import read_image, resize_linear
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.pipelines.predictors import DetectorPredictor, RecognizerPredictor
from megreader_tpu_torch.postproc import visualizer as vis
from megreader_tpu_torch.train.checkpoint import CheckpointManager
from megreader_tpu_torch.train.train_step import create_train_state
from megreader_tpu_torch.utils import profiling, webviewer

ROOT = Path(__file__).resolve().parents[1]
DET = str(ROOT / "experiments" / "seg_detector_synth.yaml")
CTC = str(ROOT / "experiments" / "ctc_resnet18_synth.yaml")
ASSET = str(ROOT / "assets" / "bench_det_fp16.msgpack")
PAGES = [str(ROOT / "assets" / "jpeg" / "pages" / "images" / "page_00000.jpg"),
         str(ROOT / "assets" / "jpeg" / "progressive" / "page_1280x720.jpg")]
CPU = ["--experiment.model.device", "cpu"]
PRINTABLE = [chr(c) for c in range(32, 127)]


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


# ------------------------------------------------------------- profiling
def test_step_timer_percentiles():
    t = profiling.StepTimer()
    t.times = [0.01, 0.02, 0.03, 0.04, 0.10]
    assert t.p50 == 0.03
    assert t.p99 == 0.10
    t.start()
    assert t.stop({"a": [torch.zeros(2)], "b": 3}) >= 0.0 and len(t.times) == 6


def test_trace_writes_a_chrome_trace_with_the_region(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = Path(prof.trace_path)
    assert path.parent == tmp_path and path.suffix == ".json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "port_region" in names and any("mm" in str(n) for n in names)


# ------------------------------------------------------------ polylines
def _poly_cases():
    rng = np.random.default_rng(0)
    for i in range(300):
        H, W = (int(v) for v in rng.integers(20, 140, 2))
        n = 4 if i % 3 == 0 else int(rng.integers(2, 17))
        margin = (0, 30, 400)[i % 3]
        pts = np.stack([rng.integers(-margin, W + margin, n),
                        rng.integers(-margin, H + margin, n)], 1).astype(np.int32)
        yield H, W, pts, (2, 2, 3, 4)[i % 4], bool(i % 5), rng.integers(0, 256, (H, W, 3))


def test_polylines_pixel_equal_cv2():
    for H, W, pts, thick, closed, bg in _poly_cases():
        ref = bg.astype(np.uint8)
        got = ref.copy()
        cv2.polylines(ref, [pts.reshape(-1, 1, 2)], closed, (0, 255, 0), thick)
        vis.polylines(got, pts, closed, (0, 255, 0), thick)
        np.testing.assert_array_equal(got, ref, err_msg=f"{pts.tolist()} {thick} {closed}")
    with pytest.raises(ValueError, match="thickness"):  # cv2 asserts 0 <= thickness
        vis.polylines(np.zeros((4, 4, 3), np.uint8), pts, True, (0, 255, 0), -1)


def _thin_cases(kind):
    """Thickness 0/1 cases: 'inside' (both ends on the canvas), 'leaving'
    (ends up to 30 or 5,000 px outside: clipped, or missing the canvas),
    'zero' (zero-length segments, on and off the canvas), on canvases from
    1x1 up."""
    rng = np.random.default_rng(("inside", "leaving", "zero").index(kind))
    for i in range(400):
        H, W = (int(v) for v in rng.integers(1, 90, 2))
        n = int(rng.integers(1, 9))
        margin = 0 if kind == "inside" else (30, 5000)[i % 2]
        pts = np.stack([rng.integers(-margin, W + margin, n),
                        rng.integers(-margin, H + margin, n)], 1).astype(np.int32)
        if kind == "zero":  # every point, or the first half, on the first one
            pts[:n if i % 2 else (n + 1) // 2] = pts[0]
        yield H, W, pts, i % 2, bool(i % 3), rng.integers(0, 256, (H, W, 3))


@pytest.mark.parametrize("kind", ["inside", "leaving", "zero"])
def test_polylines_thickness_one_pixel_equal_cv2(kind):
    """cv2's thickness-1 route (``Line``: ``clipLine`` then the 8-connected
    ``LineIterator``), which cv2 also takes for thickness 0; open and
    closed polylines."""
    for H, W, pts, thick, closed, bg in _thin_cases(kind):
        ref = bg.astype(np.uint8)
        got = ref.copy()
        cv2.polylines(ref, [pts.reshape(-1, 1, 2)], closed, (0, 255, 7), thick)
        vis.polylines(got, pts, closed, (0, 255, 7), thick)
        np.testing.assert_array_equal(got, ref, err_msg=f"{pts.tolist()} {thick} {closed}")


def test_draw_polygons_thickness_one_equals_jax():
    """``draw_polygons(thickness=1)`` equals the JAX visualizer's."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    polys = [rng.uniform(-10, 90, (4, 2)).astype(np.float32) for _ in range(6)]
    np.testing.assert_array_equal(vis.draw_polygons(image, polys, thickness=1),
                                  jax_vis.draw_polygons(image, polys, thickness=1))


# -------------------------------------------------------------- heatmap
def test_jet_and_heatmap_equal_cv2_and_jax():
    v = np.arange(256, dtype=np.uint8)
    jet = cv2.cvtColor(cv2.applyColorMap(v[:, None], cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(vis.jet_table(), jet[:, 0])
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    for dtype in (np.float32, np.float64):
        prob = (rng.random((37, 53)) * 1.4 - 0.2).astype(dtype)
        for alpha in (0.5, 0.3):
            np.testing.assert_array_equal(vis.heatmap_overlay(img, prob, alpha),
                                          jax_vis.heatmap_overlay(img, prob, alpha))


# --------------------------------------------------------------- labels
#: the label bound measured here (cv2 5.0.0) on printable ASCII: no pixel
#: differs (greatest channel difference 0, share of pixels 0)
LABEL_MAX_DIFF, LABEL_SHARE = 0, 0.0


def test_labels_within_the_measured_bound():
    rng = np.random.default_rng(2)
    worst, share = 0, 0.0
    for i in range(200):
        H, W = int(rng.integers(16, 60)), int(rng.integers(30, 200))
        text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 16))))
        org = (int(rng.integers(-20, W)), int(rng.integers(-5, H + 15)))
        bg = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        ref, got = bg.copy(), bg.copy()
        cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 64, 64), 1,
                    cv2.LINE_AA)
        vis.put_label(got, text, org)
        worst = max(worst, int(np.abs(got.astype(int) - ref).max()))
        share = max(share, float((got != ref).any(2).mean()))
    assert worst <= LABEL_MAX_DIFF and share <= LABEL_SHARE, (worst, share)


def test_labels_outside_printable_ascii():
    """cv2 draws a control character as '?'; one above 127 from a Unicode
    font the glyph table does not hold, where the port draws '?'."""
    for text, same in (("a\tb\x7f", True), ("café", False)):
        ref = np.zeros((24, 80, 3), np.uint8)
        cv2.putText(ref, text, (4, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 64, 64), 1,
                    cv2.LINE_AA)
        got = vis.put_label(np.zeros_like(ref), text, (4, 18))
        qmarks = vis.put_label(np.zeros_like(ref), "".join(
            c if 32 <= ord(c) <= 126 else "?" for c in text), (4, 18))
        np.testing.assert_array_equal(got, qmarks)
        assert np.array_equal(got, ref) == same


def _detections(rng, H, W, n):
    polys, texts = [], []
    for i in range(n):
        c = rng.uniform([-20, -20], [W + 20, H + 20])
        k = 4 if i % 2 else int(rng.integers(5, 17))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(5, 40, k)
        polys.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1))
        texts.append("".join(rng.choice(PRINTABLE, int(rng.integers(0, 12)))))
    return polys, texts


def test_draw_polygons_and_visualize_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    polys, texts = _detections(rng, 120, 160, 12)
    np.testing.assert_array_equal(vis.draw_polygons(img, polys, texts),
                                  jax_vis.draw_polygons(img, polys, texts))
    np.testing.assert_array_equal(vis.draw_polygons(img.astype(np.float32), polys[:3]),
                                  jax_vis.draw_polygons(img.astype(np.float32), polys[:3]))
    prob = rng.random((120, 160)).astype(np.float32)
    for kw in ({}, {"prob_map": prob}, {"texts": texts[:5]}):
        got = vis.DetectionVisualizer(str(tmp_path / "port")).visualize("p", img, polys, **kw)
        ref = jax_vis.DetectionVisualizer(str(tmp_path / "jax")).visualize("p", img, polys, **kw)
        assert got == str(tmp_path / "port" / "p.png")
        np.testing.assert_array_equal(_cv2_rgb(got), _cv2_rgb(ref))
    import megreader_tpu_torch.all  # noqa: F401
    from megreader_tpu_torch.core.registry import COMPONENTS

    assert COMPONENTS.get("DetectionVisualizer") is vis.DetectionVisualizer


def test_visualizer_without_workspace_writes_into_a_new_temporary_directory(
        tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a, b = vis.DetectionVisualizer(), vis.DetectionVisualizer()
    assert a.dir != b.dir and os.path.dirname(a.dir) == str(tmp_path)
    img = np.zeros((8, 8, 3), np.uint8)
    assert a.visualize("p", img, []) == os.path.join(a.dir, "p.png")


# ----------------------------------------------------- webviewer and PNG
def test_encode_png_decodes_to_the_image(tmp_path):
    rng = np.random.default_rng(4)
    for shape in ((9, 13), (9, 13, 3), (5, 7, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        data = imageio.encode_png(img, filters=(0, 1, 2, 3, 4))
        dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        want = img if img.ndim == 2 else cv2.cvtColor(
            img, cv2.COLOR_RGB2BGR if shape[2] == 3 else cv2.COLOR_RGBA2BGRA)
        np.testing.assert_array_equal(dec, want)
        imageio.write_png(str(tmp_path / "x.png"), img, filters=(0, 1, 2, 3, 4))
        assert (tmp_path / "x.png").read_bytes() == data


def test_webviewer_serves_images_on_the_port_it_bound():
    img = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(np.uint8)
    webviewer.imshow("port_test", img)
    port = webviewer.serve(port=0)
    assert port > 0 and webviewer.serve(port=0) == port
    html = urllib.request.urlopen(f"http://127.0.0.1:{port}/").read().decode()
    assert "port_test" in html
    png = urllib.request.urlopen(f"http://127.0.0.1:{port}/img/port_test").read()
    assert png[:4] == b"\x89PNG"
    dec = cv2.cvtColor(cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(dec, img)
    ref = cv2.imdecode(np.frombuffer(jax_webviewer._encode_png(img), np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv2.cvtColor(ref, cv2.COLOR_BGR2RGB), dec)
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/img/missing")


# ---------------------------------------------------------- entry points
@pytest.fixture(scope="module")
def det_workspaces(tmp_path_factory):
    """The asset detector in a port checkpoint and in a JAX msgpack state."""
    tmp = tmp_path_factory.mktemp("tools")
    port_ws, jax_ws = str(tmp / "det"), str(tmp / "det_jax")
    det = Experiment.from_yaml(DET, {"experiment.model.device": "cpu",
                                     "experiment.workspace": port_ws})
    load_flax_variables(det.model.net, load_flax_msgpack(ASSET)[0])
    CheckpointManager(port_ws).save(create_train_state(det.model, det.optimizer), 640,
                                    force=True)
    os.makedirs(os.path.join(jax_ws, "checkpoints"))
    with open(os.path.join(jax_ws, "checkpoints", "state_00000640.msgpack"), "wb") as f:
        f.write(msgpack_serialize({"step": np.int32(640),
                                   **export_flax_variables(det.model.net)}))
    return {"port": port_ws, "jax": jax_ws, "det": det, "tmp": tmp}


def test_cli_pipeline_out_dir_equals_jax_overlays(det_workspaces):
    out_dir = det_workspaces["tmp"] / "vis"
    got = cli_pipeline.main(["--detector", DET, "--det-workspace", det_workspaces["port"],
                             "--recognizer", CTC, "--images", *PAGES, "--out-dir",
                             str(out_dir), *CPU])
    assert sum(len(p["detections"]) for p in got) >= 8  # the trained detector finds words
    jax_dir = det_workspaces["tmp"] / "vis_jax"
    for path, page in zip(PAGES, got):
        img = read_image(path)
        polys = [np.array(d["polygon"]) for d in page["detections"]]
        texts = [d["text"] for d in page["detections"]]
        name = Path(path).stem
        ref_path = jax_vis.DetectionVisualizer(str(jax_dir)).visualize(name, img, polys, texts)
        np.testing.assert_array_equal(_cv2_rgb(out_dir / f"{name}.png"), _cv2_rgb(ref_path))
        assert not np.array_equal(_cv2_rgb(out_dir / f"{name}.png"), img)


@pytest.mark.parametrize("route", ["port", "jax"])
def test_cli_demo_detector_equals_jax_overlay(det_workspaces, route, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    got = cli_demo.main([DET, "--image", PAGES[0], "--out", "demo.png",
                         "--experiment.workspace", det_workspaces[route], *CPU])
    assert got["path"] == os.path.join(".", "demo.png")
    assert f"{len(got['polygons'])} regions -> ./demo.png" in capsys.readouterr().out
    img = read_image(PAGES[0])
    want = DetectorPredictor(det_workspaces["det"].model).predict(
        None, resize_linear(img, (640, 640))[None].astype(np.float32),
        scales=np.array([[1280 / 640, 720 / 640]], np.float32))[0]["polygons"]
    assert len(want) >= 4
    np.testing.assert_allclose(np.asarray(got["polygons"]), np.asarray(want), rtol=0, atol=1e-4)
    ref = jax_vis.DetectionVisualizer(str(tmp_path / "jax")).visualize("demo", img, want)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "demo.png"), _cv2_rgb(ref))


def test_cli_demo_recognizer_prints_the_transcription(tmp_path, capsys):
    crop = str(ROOT / "assets" / "jpeg" / "crops" / "word_00000.jpg")
    over = ["--experiment.workspace", str(tmp_path), "--experiment.model.hidden", "32",
            "--experiment.model.num_encoder_layers", "1", *CPU]
    exp = Experiment.from_yaml(CTC, {"experiment.workspace": str(tmp_path),
                                     "experiment.model.hidden": 32,
                                     "experiment.model.num_encoder_layers": 1,
                                     "experiment.model.device": "cpu"})
    with torch.no_grad():
        for p in exp.model.net.parameters():
            p.add_(0.01)
    CheckpointManager(str(tmp_path)).save(create_train_state(exp.model, exp.optimizer), 3,
                                          force=True)
    got = cli_demo.main([CTC, "--image", crop, *over])
    img = read_image(crop)
    h, w = img.shape[:2]
    canvas = np.zeros((1, max(64, h), max(256, w), 3), np.float32)
    canvas[0, :h, :w] = img
    want = RecognizerPredictor(exp.model, exp.charset, crop_hw=exp.crop_hw).predict(
        None, canvas, np.array([[h, w]], np.int32))[0]
    assert got == {"text": want}
    assert f"transcription: {want!r}" in capsys.readouterr().out


def test_port_imports_neither_cv2_nor_pil():
    """No port file does: the synthetic tiers and the host GT maps draw with
    numpy copies of cv2 and recorded glyph tables."""
    files = sorted((ROOT / "megreader_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("cv2", "PIL"), f"{path} imports {n}"
