"""Progressive JPEG (SOF2) in ``data/jpeg.py`` against cv2: the committed
``assets/jpeg/progressive/`` files (``scripts/make_port_progressive_jpeg_
assets.py``: every sampling cv2 writes at 1x1, 7x13, 33x50 and 100x37,
restart intervals, optimized tables, grey, a 1280x720 page) equal to their
manifest's cv2 digests and to the port's decode of their baseline twins;
files made here by cv2 equal to cv2's decode; then the refusals: a bad
Huffman code and a scan truncated without EOI (``cv2.imdecode``) stay
``ValueError`` and a scan out of order is ``ValueError``; a file whose
scans leave coefficient bits unrefined is read as libjpeg-turbo smooths it
(``tests/test_torch_port_jpeg_cut.py`` holds the smoothing on many more).
The page's decode time is printed, not gated."""

import hashlib
import json
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data.imageio import decode_image
from megreader_tpu_torch.data.jpeg import decode_jpeg

ASSETS = Path(__file__).resolve().parents[1] / "assets" / "jpeg" / "progressive"
SAMPLINGS = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]


def _manifest():
    with open(ASSETS / "manifest.json") as f:
        return json.load(f)["files"]


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _image(seed, h, w, grey=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int64)
    img = np.clip(img + rng.integers(-24, 25, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _progressive(img, params=()):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params])
    assert ok
    return buf.tobytes()


def test_committed_files_equal_cv2_and_their_baseline_twins():
    files = _manifest()
    progressive = [rel for rel, f in files.items() if "twin" in f]
    assert len(progressive) == 27 and len(files) == 54
    samplings = {rel.split("_")[0] for rel in progressive if rel.startswith("s")}
    assert samplings == {"s444", "s422", "s420", "s411", "s440"}
    page_ms = None
    for rel in progressive:
        data = (ASSETS / rel).read_bytes()
        twin = (ASSETS / files[rel]["twin"]).read_bytes()
        assert data[:2] == b"\xff\xd8" and b"\xff\xc2" in data and b"\xff\xc2" not in twin
        assert data.count(b"\xff\xda") == files[rel]["scans"] > 1
        t0 = time.perf_counter()
        got = decode_image(data, rel)
        if rel.startswith("page"):
            page_ms = (time.perf_counter() - t0) * 1e3
        assert list(got.shape) == files[rel]["shape"], rel
        assert _digest(got) == files[rel]["sha256"], rel
        assert _digest(_cv2(data)) == files[rel]["sha256"], rel
        np.testing.assert_array_equal(got, decode_jpeg(twin, files[rel]["twin"]), err_msg=rel)
    print(f"1280x720 progressive page: {page_ms:.1f} ms on the host")


@pytest.mark.parametrize("seed,h,w,sampling,params", [
    (0, 16, 16, 0, ()), (1, 9, 17, 2, (cv2.IMWRITE_JPEG_QUALITY, 50)),
    (2, 37, 53, 1, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
    (3, 23, 61, 3, (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
    (4, 41, 19, 4, (cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)),
    (5, 64, 48, 2, (cv2.IMWRITE_JPEG_QUALITY, 10)),
])
def test_made_here_equal_cv2(seed, h, w, sampling, params):
    img = _image(seed, h, w)
    data = _progressive(img, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling], *params))
    np.testing.assert_array_equal(decode_jpeg(data), _cv2(data))
    grey = _progressive(_image(seed, h, w, grey=True), params)
    np.testing.assert_array_equal(decode_jpeg(grey), _cv2(grey))


def _scans(data):
    """Offsets of each SOS marker."""
    out, i = [], data.index(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def test_refusals():
    data = _progressive(_image(6, 40, 56))
    sos = _scans(data)
    assert len(sos) == 10
    # the scans up to the DC refinement: bits left unrefined, which
    # libjpeg-turbo smooths
    for end in (sos[6], sos[1]):
        np.testing.assert_array_equal(decode_jpeg(data[:end] + b"\xff\xd9"),
                                      _cv2(data[:end] + b"\xff\xd9"))
    # no DC first scan (the tables after it kept): the DC refinement comes
    # out of order
    end = sos[0] + 2 + int.from_bytes(data[sos[0] + 2:sos[0] + 4], "big")
    while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
        end += 1
    with pytest.raises(ValueError, match="out of order"):
        decode_jpeg(data[:sos[0]] + data[end:])
    # a truncated scan
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data[:sos[3] + 40])
    # all-ones data: no Huffman code is all ones
    start = sos[2] + 2 + int.from_bytes(data[sos[2] + 2:sos[2] + 4], "big")
    bad = data[:start] + b"\xff\x00" * 8 + data[start + 16:]
    with pytest.raises(ValueError, match="bad Huffman code"):
        decode_jpeg(bad)
