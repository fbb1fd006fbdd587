"""The port's JPEG decoder (``data/jpeg.py``) against cv2, bit for bit.

cv2 decodes through libjpeg-turbo (cv2 5.0.0 is built on libjpeg-turbo 3.1.2):
``cv2.imdecode(buf, IMREAD_COLOR)`` then ``BGR2RGB`` is the reference for
every file, each made by ``cv2.imencode``: every sampling cv2 writes
(4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0) at sizes 1x1, 7x13, 33x50, 100x37 and
479x641; qualities 50, 75, 95 and 100; grey; restart intervals; optimized
Huffman tables; an EXIF Orientation tag of each value; the committed
``assets/jpeg/`` files against their manifest and cv2. Then the refusals:
other codings by name (``NotImplementedError``), damaged
files (``ValueError``)."""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio
from megreader_tpu_torch.data.jpeg import decode_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "jpeg")
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (7, 13), (33, 50), (100, 37), (479, 641)]


def _image(seed, h, w, grey=False):
    """Smooth colour fields with noise on top: blocks with DC and AC terms,
    edges that saturate after the IDCT."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int64)
    img = np.clip(img + rng.integers(-24, 25, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _encode(img, params=()):
    ok, buf = cv2.imencode(".jpg", img, [int(p) for p in params])
    assert ok
    return buf.tobytes()


def _cv2(data):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _assert_equal_to_cv2(data):
    got, ref = decode_jpeg(data), _cv2(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_every_sampling_equals_cv2(sampling, size):
    img = _image(int(sampling) + 7 * size[0] + size[1], *size)
    _assert_equal_to_cv2(_encode(img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_qualities_equal_cv2(quality):
    for sampling in ("420", "444"):
        _assert_equal_to_cv2(_encode(_image(quality, 61, 83), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]))


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (100, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_equals_cv2_in_three_channels(size):
    for quality in (50, 95):
        data = _encode(_image(3, *size, grey=True), [cv2.IMWRITE_JPEG_QUALITY, quality])
        got = decode_jpeg(data)
        _assert_equal_to_cv2(data)
        assert (got[..., 0] == got[..., 1]).all() and (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("interval", [1, 3, 17])
def test_restart_intervals_equal_cv2(interval):
    for grey, sampling in ((False, "420"), (False, "422"), (True, "444")):
        data = _encode(_image(interval, 70, 90, grey), [
            cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
        assert b"\xff\xd0" in data  # the file holds restart markers
        _assert_equal_to_cv2(data)


def test_optimized_tables_equal_cv2():
    for grey in (False, True):
        for quality in (75, 100):
            _assert_equal_to_cv2(_encode(_image(quality, 100, 37, grey), [
                cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, quality]))
    # noise at quality 100: long codes and large coefficients
    noise = np.random.default_rng(9).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    _assert_equal_to_cv2(_encode(noise, [cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                         cv2.IMWRITE_JPEG_QUALITY, 100]))
    _assert_equal_to_cv2(_encode(noise, [cv2.IMWRITE_JPEG_QUALITY, 100]))


def _with_orientation(data, orientation, order="<"):
    mark = b"II" if order == "<" else b"MM"
    tiff = (mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_as_cv2_applies_it(orientation):
    """A 20x30 file with an APP1 Exif segment put in by hand: cv2 turns or
    flips it for Orientation 2-8 (6: 30x20), as the port does; 0, 1 and 9
    leave it."""
    base = _encode(_image(5, 20, 30))
    for order in ("<", ">"):
        data = _with_orientation(base, orientation, order)
        got = decode_jpeg(data)
        _assert_equal_to_cv2(data)
        assert got.shape == ((30, 20, 3) if orientation in (5, 6, 7, 8) else (20, 30, 3))


def test_committed_assets_match_their_manifest_and_cv2():
    """Every committed file: cv2's decode gives the manifest's digest, and so
    does the port's (as the card's phase jpeg checks it)."""
    with open(os.path.join(ASSETS, "manifest.json")) as f:
        files = json.load(f)["files"]
    assert sum(rel.startswith("pages/images/") for rel in files) == 8
    assert sum(rel.startswith("crops/") for rel in files) == 256
    for rel, want in files.items():
        with open(os.path.join(ASSETS, rel), "rb") as f:
            data = f.read()
        for img in (_cv2(data), imageio.decode_image(data, rel)):
            assert list(img.shape) == want["shape"], rel
            assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() \
                == want["sha256"], rel


def test_read_image_and_decode_image_dispatch_on_the_signature(tmp_path):
    img = _image(7, 21, 34)
    jpg, png = tmp_path / "a.jpg", tmp_path / "a.png"
    cv2.imwrite(str(jpg), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(png), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    for path in (jpg, png):
        ref = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(imageio.read_image(str(path)), ref)
        np.testing.assert_array_equal(imageio.decode_image(path.read_bytes()), ref)
    # the signature decides, not the name
    odd = tmp_path / "really_a_jpeg.png"
    odd.write_bytes(jpg.read_bytes())
    np.testing.assert_array_equal(imageio.read_image(str(odd)), imageio.read_image(str(jpg)))


def test_refusals_name_what_they_met(tmp_path):
    img = _image(11, 24, 40)
    prog = _encode(img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    _assert_equal_to_cv2(prog)  # progressive is read: test_torch_port_jpeg_progressive.py
    base = _encode(img)
    sof = base.index(b"\xff\xc0")
    for marker, what in ((0xC3, "lossless"), (0xC9, "arithmetic"), (0xC5, "differential")):
        data = bytearray(base)
        data[sof + 1] = marker
        with pytest.raises(NotImplementedError, match=what):
            decode_jpeg(bytes(data))
    # cv2 refuses 12-bit samples and two components (CMYK/YCCK's four are read:
    # test_torch_port_jpeg_colour.py), so the port raises ValueError through both routes
    path = tmp_path / "x.jpg"
    for at, value, what in ((sof + 4, 12, "12-bit"), (sof + 9, 2, "2 components")):
        data = bytearray(base)
        data[at] = value
        path.write_bytes(bytes(data))
        assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
        for read in (lambda: decode_jpeg(bytes(data)), lambda: imageio.read_image(str(path))):
            with pytest.raises(ValueError, match=what):
                read()


def test_damaged_files_raise_value_error():
    data = _encode(_image(12, 120, 160), [cv2.IMWRITE_JPEG_QUALITY, 95])
    for cut in (len(data) // 2, len(data) - 40, len(data) - 2, 300, 10):
        with pytest.raises(ValueError):
            decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="no SOI"):
        decode_jpeg(b"\x00" + data[1:])
    rst = _encode(_image(13, 64, 64), [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    with pytest.raises(ValueError, match="restart intervals"):
        decode_jpeg(rst.replace(b"\xff\xd3", b"", 1))  # a restart marker lost
