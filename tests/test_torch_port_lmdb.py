"""LMDB crops and JPEG files in the port's datasets, against the JAX package.

* The port's ``lmdb_lite.Reader`` reads what the JAX ``Reader`` reads, record
  for record: the JAX fixture writer's single-leaf file, and the port
  writer's files with overflow values, branch pages and a depth-3 tree (the
  JAX ``Reader`` reading those holds the writer to LMDB's layout).
* ``LMDBRecognitionDataset`` items equal the JAX dataset's bit for bit
  (cv2's ``imdecode`` and resize there), for PNG and JPEG crops, with and
  without the shrink to the canvas.
* ``RecognitionListDataset`` and ``DetectionICDARDataset`` items on the
  committed JPEG crops and 1280x720 pages (``assets/jpeg/``) equal JAX's
  (``cv2.imread`` there), plain and augmented, GT maps included."""

import os
import shutil

import cv2
import numpy as np
import pytest

from megreader_tpu.data import datasets as jax_datasets
from megreader_tpu.data import lmdb_lite as jax_lmdb
from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDBRecognitionDataset
from megreader_tpu_torch.core.registry import COMPONENTS
from megreader_tpu_torch.data import datasets, lmdb_lite
from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "jpeg")


def _assert_same_reads(path, records):
    """Both readers give ``records``: the whole file in key order by
    ``items``, keys by ``get`` (every key, or 1000 spread over a large
    file), and None for keys that are not there."""
    readers = (lmdb_lite.Reader(path), jax_lmdb.Reader(path))
    keys = sorted(records)[::max(1, len(records) // 1000)]
    try:
        for r in readers:
            assert r.entries == len(records)
            assert list(r.items()) == sorted(records.items())
            for k in keys:
                assert r.get(k) == records[k], k
            for missing in (b"\x00", b"image-", b"zzz", b"label-999999999"):
                assert r.get(missing) is None
        assert readers[0].depth == readers[1].depth
        return readers[0].depth
    finally:
        for r in readers:
            r.close()


def test_reader_reads_the_jax_fixture(tmp_path):
    records = {b"num-samples": b"2", b"image-000000001": b"\x89PNG..", b"label-000000001": b"a",
               b"image-000000002": bytes(range(256)), b"label-000000002": b"bc"}
    jax_lmdb.write_fixture_lmdb(str(tmp_path), records)
    assert _assert_same_reads(str(tmp_path), records) == 1


@pytest.mark.parametrize("n,value_bytes,depth", [(0, 0, 0), (1, 10, 1), (120, 3000, 2),
                                                 (2000, 40, 2), (25000, 1, 3), (40, 20000, 2)],
                         ids=str)
def test_port_writer_files_read_in_both_readers(tmp_path, n, value_bytes, depth):
    """Inline values, values on overflow runs of several pages (3000 and
    20000 bytes: past LMDB's 2038-byte node limit at 4096-byte pages),
    several leaves under one branch, and a depth-3 tree."""
    rng = np.random.default_rng(n)
    records = {}
    for i in range(n):
        size = int(rng.integers(1, value_bytes + 1))
        records[f"image-{i + 1:09d}".encode()] = rng.integers(0, 256, size, np.uint8).tobytes()
    lmdb_lite.write_fixture_lmdb(str(tmp_path), records)
    assert _assert_same_reads(str(tmp_path), records) == depth


def _crop_records(kind, n=6, big=False):
    """LMDB records of ``n`` crops encoded by cv2 (PNG or JPEG); ``big``
    crops are larger than a 32x100 canvas in both directions."""
    rng = np.random.default_rng(3)
    records = {b"num-samples": str(n).encode()}
    for i in range(n):
        h, w = (int(rng.integers(40, 90)), int(rng.integers(120, 300))) if big else (
            int(rng.integers(8, 30)), int(rng.integers(10, 90)))
        base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        ok, buf = cv2.imencode(".png" if kind == "png" else ".jpg", img)
        records[f"image-{i + 1:09d}".encode()] = buf.tobytes()
        records[f"label-{i + 1:09d}".encode()] = f"w{i}ü".encode()
    return records


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("shrink", [False, True], ids=["fit", "shrink"])
def test_lmdb_dataset_matches_jax(tmp_path, kind, shrink):
    records = _crop_records(kind, big=shrink)
    lmdb_lite.write_fixture_lmdb(str(tmp_path), records)
    canvas = (32, 100) if shrink else (64, 256)
    ref = JaxLMDBRecognitionDataset(str(tmp_path), canvas_hw=canvas)
    got = LMDBRecognitionDataset(str(tmp_path), canvas_hw=canvas)
    assert len(got) == len(ref) == 6
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert b["text"] == a["text"] == f"w{i}ü"
        np.testing.assert_array_equal(b["size"], a["size"])
        assert b["image"].dtype == a["image"].dtype == np.uint8
        np.testing.assert_array_equal(b["image"], a["image"])
        if shrink:
            assert tuple(a["size"]) != (64, 256) and (a["size"] <= (32, 100)).all()


def test_lmdb_dataset_refusals_and_registration(tmp_path):
    lmdb_lite.write_fixture_lmdb(str(tmp_path / "empty"), {b"other": b"1"})
    with pytest.raises(ValueError, match="num-samples"):
        LMDBRecognitionDataset(str(tmp_path / "empty"))
    records = _crop_records("jpeg", n=2)
    records[b"image-000000002"] = records[b"image-000000002"][:200]  # a damaged crop
    lmdb_lite.write_fixture_lmdb(str(tmp_path / "bad"), records)
    ds = LMDBRecognitionDataset(str(tmp_path / "bad"))
    ds[0]
    with pytest.raises(ValueError, match="image-000000002"):
        ds[1]
    import megreader_tpu_torch.all  # noqa: F401

    assert COMPONENTS.get("LMDBRecognitionDataset") is LMDBRecognitionDataset


def test_list_dataset_on_jpeg_crops_matches_jax():
    path = os.path.join(ASSETS, "crops", "list.txt")
    ref = jax_datasets.RecognitionListDataset(path)
    got = datasets.RecognitionListDataset(path)
    assert len(got) == len(ref) == 256
    for i in range(0, 256, 16):
        a, b = ref[i], got[i]
        assert b["text"] == a["text"]
        np.testing.assert_array_equal(b["size"], a["size"])
        np.testing.assert_array_equal(b["image"], a["image"])
    small = datasets.RecognitionListDataset(path, canvas_hw=(16, 40))  # the shrink path
    small_ref = jax_datasets.RecognitionListDataset(path, canvas_hw=(16, 40))
    for i in range(0, 256, 64):
        np.testing.assert_array_equal(small[i]["image"], small_ref[i]["image"])


@pytest.mark.parametrize("augment", [False, True])
def test_icdar_dataset_on_jpeg_pages_matches_jax(tmp_path, augment):
    """Two committed 1280x720 pages: resized to 640x640 (polygons, scale and
    host GT maps with them), or flipped, scaled and cropped."""
    img_dir, gt_dir = tmp_path / "images", tmp_path / "gts"
    img_dir.mkdir()
    gt_dir.mkdir()
    for name in ("page_00000", "page_00001"):
        shutil.copy(os.path.join(ASSETS, "pages", "images", name + ".jpg"), img_dir)
        shutil.copy(os.path.join(ASSETS, "pages", "gts", f"gt_{name}.txt"), gt_dir)
    kw = dict(target_hw=(640, 640), augment=augment, seed=1)
    ref = jax_datasets.DetectionICDARDataset(str(img_dir), str(gt_dir), **kw)
    got = datasets.DetectionICDARDataset(str(img_dir), str(gt_dir), **kw)
    assert got.names == ref.names and len(got) == 2
    for i in range(2):
        a, b = ref[i], got[i]
        np.testing.assert_array_equal(b["image"], a["image"])
        assert len(b["polygons"]) == len(a["polygons"]) > 0
        for p, q in zip(b["polygons"], a["polygons"]):
            np.testing.assert_array_equal(p, q)
        assert b["ignore"] == a["ignore"] and b["texts"] == a["texts"]
        np.testing.assert_array_equal(b["scale"], a["scale"])
        for k in ("gt", "mask", "thresh_map", "thresh_mask"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
