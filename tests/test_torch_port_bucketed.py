"""Variable-size serving against the JAX package, on the CPU: ``pick_bucket``,
``fit_to_bucket`` and ``BucketBatcher`` (``data/bucketing.py``), then
``BucketedE2E`` over pages of mixed sizes, and ``cli.pipeline --bucketed``.

Tolerances: buckets, valid sizes and scales equal; float32 and uint8 pages
bit-equal to the JAX package's (cv2's ``INTER_LINEAR``, which
``resize_linear`` takes step for step: on float32 by cv2's float routes, a
page one pixel high by its single-row one, and on uint8 by its fixed-point
passes). ``BucketedE2E``: the same detections a page,
texts equal, polygons and quads within 1e-3 px, scores within 1e-5, as
``test_torch_port_e2e.py`` holds one bucket's batch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from megreader_tpu.data import bucketing as jax_bucketing
from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.pipelines import BucketedE2E as JaxBucketedE2E
from megreader_tpu.pipelines import E2EPipeline as JaxE2EPipeline
import megreader_tpu_torch.all  # noqa: F401  (the port's registry)
from megreader_tpu_torch.cli import pipeline as cli_pipeline
from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.core.registry import COMPONENTS
from megreader_tpu_torch.data import bucketing, imageio
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.pipelines.bucketed import BucketedE2E
from megreader_tpu_torch.pipelines.e2e import E2EPipeline
from megreader_tpu_torch.train.checkpoint import CheckpointManager
from megreader_tpu_torch.train.train_step import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ((64, 64), (64, 128), (128, 64), (128, 128))
#: two buckets for the page program (a JAX compile each)
TWO = ((64, 128), (128, 96))
#: (h, w): past the largest bucket, between, on a bucket, below the smallest
SIZES = [(1500, 900), (700, 1300), (2000, 2000), (640, 640), (300, 500), (641, 639),
         (1152, 640), (900, 1152), (33, 17), (1, 3000)]


def test_pick_bucket_matches_jax():
    rng = np.random.default_rng(0)
    sizes = SIZES + [tuple(int(v) for v in rng.integers(1, 2500, 2)) for _ in range(200)]
    for buckets in (bucketing.DEFAULT_BUCKETS, SMALL, ((100, 50), (50, 100), (60, 60))):
        for h, w in sizes:
            assert bucketing.pick_bucket(h, w, buckets) == jax_bucketing.pick_bucket(h, w,
                                                                                     buckets)
    assert bucketing.DEFAULT_BUCKETS == jax_bucketing.DEFAULT_BUCKETS


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_fit_to_bucket_matches_jax(dtype):
    """Downscaled pages, pages padded at their own scale, and pages already at
    their bucket's size (the identity resize copies)."""
    rng = np.random.default_rng(1)
    for h, w in SIZES:
        img = rng.uniform(0, 255, (h, w, 3)).astype(dtype)
        b = bucketing.pick_bucket(h, w)
        got, ref = bucketing.fit_to_bucket(img, b), jax_bucketing.fit_to_bucket(img, b)
        assert sorted(got) == sorted(ref)
        for k in ("valid_hw", "scale"):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        assert got["image"].dtype == ref["image"].dtype and got["image"].shape == (*b, 3)
        np.testing.assert_array_equal(got["image"], ref["image"])


def test_bucket_batcher_matches_jax():
    rng = np.random.default_rng(2)
    got, ref = bucketing.BucketBatcher(2, SMALL), jax_bucketing.BucketBatcher(2, SMALL)
    out, want = [], []
    for i, (h, w) in enumerate([(60, 60), (100, 50), (64, 64), (30, 200), (130, 140),
                                (50, 120), (64, 60)]):
        sample = {"image": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
                  "polygons": [np.full((4, 2), i, np.float32)], "ignore": [False],
                  "texts": [f"w{i}"], "filename": f"p{i}"}
        out += got.add(sample)
        want += ref.add(sample)
        assert len(out) == len(want)
    out += got.flush()
    want += ref.flush()
    assert len(out) == len(want) >= 4
    for g, r in zip(out, want):
        assert sorted(g) == sorted(r) and g["bucket"] == r["bucket"]
        for k in ("image", "valid_hw", "scale"):
            np.testing.assert_array_equal(g[k], r[k])
        assert g["texts"] == r["texts"] and g["filename"] == r["filename"]
        for a, b in zip(g["polygons"], r["polygons"]):
            np.testing.assert_array_equal(a, b)


def _mixed_pages(seed=3):
    """Light pages with dark word-like bars, of sizes for every small bucket,
    one past the largest (downscaled) and one below the smallest (padded)."""
    rng = np.random.default_rng(seed)
    pages = []
    for h, w in [(64, 64), (60, 120), (128, 60), (128, 128), (200, 170), (40, 50), (64, 128)]:
        page = 220.0 + 15.0 * rng.standard_normal((h, w, 3))
        for _ in range(max(2, h * w // 2500)):
            y, x = rng.integers(2, max(3, h - 12)), rng.integers(2, max(3, w - 30))
            page[y:y + rng.integers(5, 10), x:x + rng.integers(12, 28)] -= 150.0
        pages.append(np.clip(page, 0, 255).astype(np.float32))
    return pages


def _threshold(probs):
    """A threshold near the 80th percentile of every prob value, in the widest
    gap of its neighbourhood (so that no prob lies within 1e-5 of it)."""
    v = np.sort(np.concatenate([p.reshape(-1) for p in probs]))
    i = int(0.8 * len(v))
    lo, hi = max(i - 200, 0), min(i + 200, len(v) - 1)
    j = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    assert v[j + 1] - v[j] > 2e-5
    return float(0.5 * (v[j] + v[j + 1]))


def test_bucketed_e2e_matches_jax():
    """Narrow seeded nets (as ``test_torch_port_e2e.py``) over two small
    buckets, batch 2: a bucket of four pages (two padded at their own scale,
    one on the bucket), a bucket of three (two downscaled), the last batch
    short."""
    det = JaxSegDetector(fpn_dim=32, head_dim=16, width=16)
    rec = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
    key = jax.random.PRNGKey(0)
    # the seeded weights need init's shapes only
    det_vars = seeded_flax_variables(jax.eval_shape(det.init, key, jnp.zeros((1, 64, 64, 3))),
                                     13)
    rec_vars = seeded_flax_variables(jax.eval_shape(rec.init, key, jnp.zeros((1, 32, 100, 3))),
                                     113)
    rec_vars["params"]["classifier"]["kernel"] *= 8.0
    pages = _mixed_pages()
    fitted = [jax_bucketing.fit_to_bucket(p, jax_bucketing.pick_bucket(*p.shape[:2], TWO))
              for p in pages]
    prob_fn = jax.jit(lambda v, x: det.apply(v, jax_normalize(x), heads=("prob",))["prob"])
    probs = [np.asarray(prob_fn(det_vars, jnp.asarray(f["image"][None]))) for f in fitted]
    opts = dict(max_regions=6, box_thresh=0.0, bin_thresh=_threshold(probs))
    ref = JaxBucketedE2E(JaxE2EPipeline(det, rec, **opts), TWO, batch=2).predict(
        det_vars, rec_vars, pages)

    tdet = SegDetector("resnet18", 32, 16, width=16, device="cpu")
    trec = CTCRecognizer(37, hidden=32, num_encoder_layers=1, device="cpu")
    load_flax_variables(tdet.net, det_vars)
    load_flax_variables(trec.net, rec_vars)
    got = BucketedE2E(E2EPipeline(tdet, trec, device="cpu", **opts), TWO, batch=2).predict(
        None, None, pages)
    assert len(got) == len(ref) == len(pages)
    assert sum(len(r) for r in ref) >= 10
    for g_page, r_page in zip(got, ref):
        assert len(g_page) == len(r_page)
        for g, r in zip(g_page, r_page):
            assert sorted(g) == sorted(r) and g["text"] == r["text"]
            np.testing.assert_allclose(g["polygon"], r["polygon"], rtol=0, atol=1e-3)
            np.testing.assert_allclose(g["quad"], r["quad"], rtol=0, atol=1e-3)
            assert g["score"] == pytest.approx(r["score"], abs=1e-5)
    # the downscaled page's polygons are in its own pixels, past the bucket
    assert max(d["polygon"][:, 1].max() for d in got[4]) > 128
    assert [f["image"].shape[:2] for f in fitted].count((128, 96)) == 3


def test_cli_pipeline_bucketed(tmp_path, capsys):
    """``--bucketed`` on PNG pages of three sizes (one downscaled into 1152 x
    640, one padded into 640 x 640, one on its bucket) with the repo's
    trained detector: one JSON line a page, equal to ``BucketedE2E`` run on
    the pages as read."""
    from chip_smoke import TextPages

    det_yaml = os.path.join(REPO, "experiments", "seg_detector_synth.yaml")
    rec_yaml = os.path.join(REPO, "experiments", "ctc_resnet18_synth.yaml")
    cpu = {"experiment.model.device": "cpu"}
    det_ws = str(tmp_path / "det")
    det = Experiment.from_yaml(det_yaml, {**cpu, "experiment.workspace": det_ws})
    load_flax_variables(det.model.net, load_flax_msgpack(
        os.path.join(REPO, "assets", "bench_det_fp16.msgpack"))[0])
    CheckpointManager(det_ws).save(create_train_state(det.model, det.optimizer), 1, force=True)
    paths = []
    for i, hw in enumerate([(1300, 700), (320, 400), (640, 640)]):
        paths.append(str(tmp_path / f"page{i}.png"))
        imageio.write_png(paths[-1], TextPages(1, 20 + i, hw)[0]["image"])
    argv = ["--detector", det_yaml, "--det-workspace", det_ws, "--recognizer", rec_yaml,
            "--rec-workspace", str(tmp_path / "rec"), "--images", *paths, "--bucketed",
            "--experiment.model.device", "cpu"]
    out = cli_pipeline.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines] == out and len(out) == 3

    rec = Experiment.from_yaml(rec_yaml, cpu)
    pipe = E2EPipeline(det.model, rec.model, rec.charset, max_regions=32, box_thresh=0.5,
                       device="cpu")
    want = BucketedE2E(pipe).predict(None, None, [imageio.read_image(p) for p in paths])
    for page, w in zip(out, want):
        assert [d["text"] for d in page["detections"]] == [d["text"] for d in w]
        for d, e in zip(page["detections"], w):
            np.testing.assert_allclose(d["polygon"], e["polygon"], rtol=0, atol=1e-5)
    assert len(out[0]["detections"]) >= 2
    # page 0 (1300 x 700) was scaled by 1152 / 1300 into its bucket; its
    # words come back in its own pixels
    assert max(max(y for _, y in d["polygon"]) for d in out[0]["detections"]) > 700
    assert COMPONENTS.get("BucketedE2E") is BucketedE2E
