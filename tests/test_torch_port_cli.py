"""The port's entry points on the CPU: ``Experiment.from_yaml`` of config #1 in
both packages (the first prepared batch, and the loss at shared weights),
``cli.train`` with a resume, ``cli.eval`` (greedy and beam), ``cli.pipeline``
on PNG pages against ``E2EPipeline.predict``, and ``data/imageio.py`` against
cv2. The models run on the CPU through the plain dotted override
``--experiment.model.device cpu``, as a user would pass it."""

import json
import os
import struct
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

import megreader_tpu.all  # noqa: F401  (the JAX registry)
from megreader_tpu.experiment import Experiment as JaxExperiment
from megreader_tpu_torch.cli import eval as cli_eval
from megreader_tpu_torch.cli import pipeline as cli_pipeline
from megreader_tpu_torch.cli import train as cli_train
from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.data import imageio
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.pipelines.e2e import E2EPipeline
from megreader_tpu_torch.train.checkpoint import CheckpointManager
from megreader_tpu_torch.train.train_step import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTC = os.path.join(REPO, "experiments", "ctc_resnet18_synth.yaml")
DET = os.path.join(REPO, "experiments", "seg_detector_synth.yaml")
ASSET = os.path.join(REPO, "assets", "bench_det_fp16.msgpack")
#: config #1 cut to a narrow net on 8 crops (the size of tests/test_train.py)
NARROW = {"experiment.model.hidden": 32, "experiment.model.num_encoder_layers": 1,
          "experiment.batch_size": 8, "experiment.train_dataset.n": 8,
          "experiment.eval_dataset.n": 8, "experiment.log_every": 1,
          "experiment.loader_workers": 1}


def _argv(overrides):
    return [a for k, v in overrides.items() for a in (f"--{k}", str(v))]


def test_from_yaml_batch_and_loss_match_jax():
    """The same YAML and overrides in both packages: the first batch off the
    loader equal bit for bit (canvases, sizes, labels, texts); prepared, its
    labels equal and its images within ``test_torch_port_train.py``'s 1e-4
    (the resampler's float32 sums round in another order: 6e-6 here); and
    the eval-mode loss at the JAX model's weights (carried by
    ``compat/weights.py``) within that file's loss tolerance (atol 1e-4)."""
    exp = Experiment.from_yaml(CTC, {**NARROW, "experiment.model.device": "cpu"})
    ref = JaxExperiment.from_yaml(CTC, NARROW)
    jraw, raw = next(iter(ref.train_loader)), next(iter(exp.train_loader))
    assert raw["text"] == jraw["text"]
    for key in ("image", "size", "label", "label_length"):
        np.testing.assert_array_equal(raw[key], jraw[key], err_msg=key)
    jbatch = jax.device_get(ref.prepare(jraw))
    batch = exp.prepare(raw)
    for key in ("label", "label_length"):
        np.testing.assert_array_equal(batch[key].numpy(), jbatch[key], err_msg=key)
    np.testing.assert_allclose(batch["image"].numpy(), jbatch["image"], rtol=0, atol=1e-4)
    variables = seeded_flax_variables(
        jax.eval_shape(ref.model.init, jax.random.PRNGKey(0), jbatch["image"]), 1)
    load_flax_variables(exp.model.net, variables)
    jloss = float(ref.model.loss(variables, jbatch, train=False)[0])
    with torch.no_grad():
        loss = float(exp.model.loss(batch, train=False)[0])
    assert abs(loss - jloss) <= 1e-4, (loss, jloss)


def test_cli_train_resumes_and_eval_prints_one_json_line(tmp_path, capsys):
    over = {**NARROW, "experiment.model.device": "cpu", "experiment.workspace": str(tmp_path),
            "experiment.epochs": 2}
    state = cli_train.main([CTC, "--no-resume", *_argv({**over, "experiment.epochs": 1})])
    assert state.step == 1
    state = cli_train.main([CTC, *_argv(over)])  # resumes at step 1, trains on to 2
    assert state.step == 2
    log = capsys.readouterr()
    assert "resumed at step 1" in log.out + log.err
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    for mode in ("greedy", "beam"):
        got = cli_eval.main([CTC, "--mode", mode, *_argv(over)])
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0]) == got
        assert got["step"] == 2 and got["n"] == 8 and 0.0 <= got["ned"] <= 1.0
    got = cli_eval.main([CTC, "--step", "1", *_argv(over)])
    assert got["step"] == 1
    # --int8 is ported; a recognizer's evaluation does not read it (as in the
    # JAX package), and a detector's is in test_torch_port_quantize.py
    assert cli_eval.main([CTC, "--step", "1", "--int8", *_argv(over)]) == got
    # --representer poly is ported; a recognizer's evaluation does not read it
    # (as in the JAX package), and a detector's is in test_torch_port_chains.py
    assert cli_eval.main([CTC, "--step", "1", "--representer", "poly", *_argv(over)]) == got


def test_restore_variables_loads_the_module_only(tmp_path):
    over = {**NARROW, "experiment.model.device": "cpu", "experiment.workspace": str(tmp_path)}
    exp = Experiment.from_yaml(CTC, over)
    state = create_train_state(exp.model, exp.optimizer)
    with torch.no_grad():
        for p in exp.model.net.parameters():
            p.add_(1.0)
    CheckpointManager(str(tmp_path)).save(state, 7, force=True)
    fresh = Experiment.from_yaml(CTC, {**over, "experiment.optimizer.name": "sgd"})
    CheckpointManager(str(tmp_path)).restore_variables(fresh.model.net)
    saved = exp.model.net.state_dict()
    assert all(torch.equal(v, saved[k]) for k, v in fresh.model.net.state_dict().items())


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """The trained detector (the repo's asset) in a port checkpoint, two
    pages of ``chip_smoke.TextPages`` written as PNG, and config #1 at its
    seeded initial weights."""
    from chip_smoke import TextPages

    tmp = tmp_path_factory.mktemp("pipeline")
    det_ws, rec_ws = str(tmp / "det"), str(tmp / "rec")
    cpu = {"experiment.model.device": "cpu"}
    det = Experiment.from_yaml(DET, {**cpu, "experiment.workspace": det_ws})
    load_flax_variables(det.model.net, load_flax_msgpack(ASSET)[0])
    CheckpointManager(det_ws).save(create_train_state(det.model, det.optimizer), 640,
                                   force=True)
    pages = np.stack([TextPages(2, 5, (320, 320))[i]["image"] for i in range(2)])
    paths = []
    for i, page in enumerate(pages):
        paths.append(str(tmp / f"page{i}.png"))
        imageio.write_png(paths[-1], page, filters=(0, 1, 2, 3, 4))
    return {"det_ws": det_ws, "rec_ws": rec_ws, "pages": pages, "paths": paths, "cpu": cpu}


@pytest.mark.parametrize("rectify", ["perspective", "deskew", "box"])
def test_cli_pipeline_matches_predict(pipeline_run, rectify, capsys):
    r = pipeline_run
    argv = ["--detector", DET, "--det-workspace", r["det_ws"], "--recognizer", CTC,
            "--rec-workspace", r["rec_ws"], "--images", *r["paths"], "--page-size", "320",
            "--rectify", rectify, *_argv(r["cpu"])]
    got = cli_pipeline.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == got
    det = Experiment.from_yaml(DET, r["cpu"])
    rec = Experiment.from_yaml(CTC, r["cpu"])
    CheckpointManager(r["det_ws"]).restore_variables(det.model.net)
    pipe = E2EPipeline(det.model, rec.model, rec.charset, box_thresh=0.5, rectify=rectify,
                       device="cpu")
    ref = pipe.predict(None, None, r["pages"].astype(np.float32))
    assert [p["image"] for p in got] == r["paths"]
    assert sum(len(p["detections"]) for p in got) >= 4  # the trained detector finds words
    for page, want in zip(got, ref):
        assert [d["text"] for d in page["detections"]] == [d["text"] for d in want]
        for d, w in zip(page["detections"], want):
            np.testing.assert_allclose(d["polygon"], w["polygon"], rtol=0, atol=1e-5)
            assert d["score"] == pytest.approx(w["score"], abs=1e-6)


def test_cli_pipeline_refuses_what_is_not_ported(pipeline_run, tmp_path):
    """Nothing is refused: --bucketed is ported (test_torch_port_bucketed.py),
    and --out-dir writes one overlay a page (held to the JAX package's
    overlays by test_torch_port_tools.py)."""
    base = ["--detector", DET, "--det-workspace", pipeline_run["det_ws"], "--recognizer", CTC,
            "--images", *pipeline_run["paths"]]
    got = cli_pipeline.main(base + ["--out-dir", str(tmp_path / "vis"),
                                    *_argv(pipeline_run["cpu"])])
    for path, page, img in zip(pipeline_run["paths"], got, pipeline_run["pages"]):
        vis = imageio.read_image(str(tmp_path / "vis" / os.path.basename(path)))
        assert vis.shape == img.shape
        assert page["detections"] and not np.array_equal(vis, img)


def _smooth(h, w, ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    return (base[..., None] + rng.integers(0, 20, (h, w, ch))).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "bgr", "bgra"])
def test_read_image_equals_cv2(tmp_path, channels):
    """cv2 writes a PNG of each colour type (its own choice of row filters);
    ``read_image`` gives what ``cv2.imread(IMREAD_COLOR)`` + BGR2RGB give."""
    for k, img in enumerate((_smooth(50, 70, channels, 0),
                             np.random.default_rng(1).integers(0, 256, (33, 41, channels),
                                                               dtype=np.uint8))):
        path = str(tmp_path / f"im{k}.png")
        cv2.imwrite(path, img[..., 0] if channels == 1 else img)
        ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        got = imageio.read_image(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_write_png_every_filter_read_by_cv2(tmp_path, channels):
    img = _smooth(40, 60, channels, 2)
    path = str(tmp_path / "w.png")
    imageio.write_png(path, img, filters=(0, 1, 2, 3, 4))
    if channels != 2:  # cv2 reads grey+alpha as grey only
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        back = back[..., None] if channels == 1 else back[..., [2, 1, 0, 3][:channels]]
        np.testing.assert_array_equal(back, img)
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(imageio.read_image(path), ref)


@pytest.mark.parametrize("src,size", [((50, 70), (640, 640)), ((123, 457), (100, 300)),
                                      ((640, 640), (320, 320)), ((640, 640), (17, 32)),
                                      ((60, 80), (80, 60)), ((96, 128), (128, 96))])
def test_resize_linear_equals_cv2(src, size):
    img = cv2.GaussianBlur(np.random.default_rng(3).integers(0, 256, (*src, 3), dtype=np.uint8),
                           (5, 5), 2)
    got = imageio.resize_linear(img, size)
    ref = cv2.resize(img, size)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,size", [((300, 420), (457, 327)), ((97, 201), (50, 33)),
                                      ((1, 50), (30, 7)), ((1, 97), (31, 1)), ((50, 1), (1, 30)),
                                      ((40, 1), (7, 90)), ((1, 1), (5, 9)), ((3, 5), (2, 2))])
@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_resize_linear_equals_cv2_on_channels_and_thin_sources(src, size, channels):
    """uint8 by cv2's fixed-point passes, up and down, on (H, W) and (H, W, C)
    images and one-row, one-column and 1x1 sources; float32 one-row sources
    by cv2's separate single-row route."""
    rng = np.random.default_rng(4)
    shape = src if channels is None else (*src, channels)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)]
    if src[0] == 1:
        images.append(rng.uniform(0, 255, shape).astype(np.float32))
    for img in images:
        got = imageio.resize_linear(img, size)
        ref = cv2.resize(img, size)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, ref.reshape(got.shape))
        assert got.shape == (size[1], size[0]) + shape[2:]


def _png(tmp_path, ihdr):
    body = struct.pack(">IIBBBBB", *ihdr)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    path = tmp_path / "x.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", body)
                     + chunk(b"IDAT", zlib.compress(b"\0" * 64)) + chunk(b"IEND", b""))
    return str(path)


def test_read_image_refuses_other_formats(tmp_path):
    # PNG, JPEG (baseline and progressive), BMP, PNM, PFM, Sun raster,
    # Radiance HDR, GIF, TIFF and WebP are read (test_torch_port_jpeg*.py,
    # test_torch_port_imageio_formats.py, test_torch_port_gif_tiff.py,
    # test_torch_port_webp.py, test_torch_port_hdr_pfm_ras.py) and so is JPEG 2000
    # (test_torch_port_jpeg2000.py); an AVIF file and a PNG header the standard
    # does not allow are refused by name
    tif = tmp_path / "x.tif"
    cv2.imwrite(str(tif), np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3))
    np.testing.assert_array_equal(imageio.read_image(str(tif)), cv2.cvtColor(
        cv2.imread(str(tif), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))  # TIFF is read
    webp = tmp_path / "x.webp"
    cv2.imwrite(str(webp), np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3))
    np.testing.assert_array_equal(imageio.read_image(str(webp)), cv2.cvtColor(
        cv2.imread(str(webp), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))  # WebP is read
    jp2 = tmp_path / "x.jp2"
    cv2.imwrite(str(jp2), np.zeros((64, 64, 3), np.uint8))
    np.testing.assert_array_equal(imageio.read_image(str(jp2)), cv2.cvtColor(
        cv2.imread(str(jp2), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))  # JPEG 2000 is read
    avif = tmp_path / "x.avif"
    cv2.imwrite(str(avif), np.zeros((64, 64, 3), np.uint8))
    assert cv2.imread(str(avif), cv2.IMREAD_COLOR) is not None
    with pytest.raises(NotImplementedError, match="not PNG, JPEG, JPEG 2000, BMP, PNM, PFM, Sun "
                                                  "raster, Radiance HDR, GIF, TIFF or WebP"):
        imageio.read_image(str(avif))
    bmp = tmp_path / "x.bmp"
    cv2.imwrite(str(bmp), np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3))
    np.testing.assert_array_equal(imageio.read_image(str(bmp)), cv2.cvtColor(
        cv2.imread(str(bmp), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))  # BMP is read
    jpg = tmp_path / "x.jpg"
    cv2.imwrite(str(jpg), np.zeros((8, 8, 3), np.uint8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(imageio.read_image(str(jpg)), cv2.cvtColor(
        cv2.imread(str(jpg), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))  # progressive is read
    for ihdr, what in (((4, 4, 16, 3, 0, 0, 0), "bit depth 16 and colour type 3"),
                       ((4, 4, 4, 2, 0, 0, 0), "bit depth 4 and colour type 2"),
                       ((4, 4, 8, 2, 0, 0, 2), "interlace 2")):
        with pytest.raises(ValueError, match=what):
            imageio.read_image(_png(tmp_path, ihdr))
    path = _png(tmp_path, (4, 4, 8, 0, 0, 0, 0))
    data = bytearray(open(path, "rb").read())
    data[30] ^= 1  # inside IHDR's CRC
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        imageio.read_image(path)
