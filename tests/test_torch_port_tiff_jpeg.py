"""JPEG-compressed TIFF (compression 7) in the port (``data/tiff.py`` over
``jpeg.decode_tiff_strip``) against cv2 5 bit for bit, through
``read_image`` (``cv2.imread``) and ``decode_image`` (``cv2.imdecode``),
each then ``BGR2RGB``; where cv2 returns None the port raises
``ValueError``, and what cv2 reads that the port does not raises
``NotImplementedError`` naming it.

The committed ``tiffjpeg_*`` files and ``pages/page_jpeg.tif`` are held to
their manifest digests with every committed TIFF by
``test_torch_port_gif_tiff.py``; here, the layouts they cover, then seeded
files from ``scripts/make_port_image_assets.py``'s ``tiff_jpeg_bytes``
(YCbCr at each sampling, strips and tiles, whole or abbreviated streams
with ``JPEGTables``, grey, RGB) and PIL against cv2; the subsampling rules
libtiff checks; the refusals. These tests need cv2,
so they run where it is installed."""

import io
import json
import os
import sys

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio, jpeg, tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST if "tiffjpeg_" in rel or rel == "pages/page_jpeg.tif")


def test_committed_jpeg_tiffs_cover_the_layouts():
    names = " ".join(FILES)
    for part in ("ycbcr420_tables", "ycbcr444", "ycbcr422", "ycbcr440", "ycbcr411", "tiles",
                 "grey", "min_is_white", "pil_rgb", "last_strip_full", "progressive",
                 "restarts", "orientation", "wrong_subsampling"):
        assert part in names, part
    assert MANIFEST["cases/tiffjpeg_ycbcr411_wrong_subsampling_tag_33x50.tif"]["sha256"] is None


def _cv2(data, path=None):
    bgr = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, name="x.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    out = None
    for read, ref in ((lambda: imageio.read_image(str(path)), _cv2(data, path)),
                      (lambda: imageio.decode_image(data, name), _cv2(data))):
        if ref is None:
            with pytest.raises(ValueError):
                read()
            continue
        got = read()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        out = got
    return out


@pytest.mark.parametrize("sampling", sorted(assets.JPEG_SAMPLING))
def test_ycbcr_strips_and_tiles_equal_cv2(sampling, tmp_path):
    """YCbCr at one sampling: strips of 8, 16 and 32 rows (a short last
    strip), tiles of 16x16 and 32x16, whole streams or abbreviated ones with
    ``JPEGTables``, with and without the YCbCrSubsampling tag, 1x1 to
    37x100; each strip upsampled on its own, as libjpeg decodes it."""
    rng = np.random.default_rng(400 + sampling % 97)
    v = assets.JPEG_SAMPLING[sampling][1]
    for h, w in ((1, 1), (7, 13), (37, 100)):
        img = assets.smooth(rng, h, w)
        for kw in (dict(rows_per_strip=8 * v), dict(rows_per_strip=32, tables=True),
                   dict(tile=(16, 16), subsampling_tag=False), dict(tile=(32, 16), tables=True)):
            if sampling == 0x411111 and "tile" in kw and kw["tile"][0] == 16:
                continue
            assert_like_cv2(assets.tiff_jpeg_bytes(img, sampling=sampling,
                                                   quality=int(rng.integers(30, 96)), **kw),
                            tmp_path)


def test_grey_rgb_and_pil_files_equal_cv2(tmp_path):
    """Grey (both photometric interpretations) in strips and tiles, the
    same YCbCr streams declared RGB (their samples as coded), PIL's RGB and
    grey files with their ``JPEGTables``, the last strip coded at full
    height, restart intervals, a progressive strip, Orientation tags."""
    rng = np.random.default_rng(410)
    for h, w in ((1, 1), (33, 50)):
        grey = assets.smooth(rng, h, w, 1)
        img = assets.smooth(rng, h, w)
        for data in (assets.tiff_jpeg_bytes(grey, photometric=1, tables=True),
                     assets.tiff_jpeg_bytes(grey, photometric=0, tile=(16, 16)),
                     assets.tiff_jpeg_bytes(img, photometric=2, sampling=0x111111),
                     assets.pil_tiff(img, "RGB", compression="jpeg", quality=60),
                     assets.pil_tiff(grey, "L", compression="jpeg"),
                     assets.tiff_jpeg_bytes(img, last_full=True, rows_per_strip=16),
                     assets.tiff_jpeg_bytes(img, params=[cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
                     assets.tiff_jpeg_bytes(img, params=[cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
            assert_like_cv2(data, tmp_path)
    sq = assets.smooth(rng, 24, 24)
    for o in range(1, 9):
        assert_like_cv2(assets.tiff_jpeg_bytes(sq, orientation=o), tmp_path)
    assert_like_cv2(assets.tiff_jpeg_bytes(assets.smooth(rng, 24, 40), orientation=6), tmp_path)


def test_libtiff_subsampling_rules_equal_cv2(tmp_path):
    """libtiff's JPEG codec: a YCbCrSubsampling tag must equal the first
    component's factors (without the tag, the first strip's are taken), RGB
    and grey strips must not be subsampled: both refuse otherwise."""
    rng = np.random.default_rng(420)
    img = assets.smooth(rng, 33, 50)
    tags_off = assets.tiff_jpeg_bytes(img, sampling=0x411111, subsampling_tag=False)
    assert assert_like_cv2(tags_off, tmp_path) is not None
    assert assert_like_cv2(assets.tiff_jpeg_bytes(img, sampling=0x411111), tmp_path) is not None
    assert assert_like_cv2(assets.tiff_jpeg_bytes(img, photometric=2), tmp_path) is None  # 4:2:0
    for tag in ((1, 1), (2, 1), (1, 2)):
        wrong = assets.tiff_jpeg_bytes(img, sampling=0x221111, subsampling_tag=tag)
        assert assert_like_cv2(wrong, tmp_path) is None


def test_abbreviated_strip_reads_its_tables_from_outside():
    """``jpeg.decode_tiff_strip``: an abbreviated stream with the tables
    given apart decodes as the whole stream; without them it is refused."""
    rng = np.random.default_rng(430)
    whole = assets.cv_encode(".jpg", assets.smooth(rng, 16, 24), [cv2.IMWRITE_JPEG_QUALITY, 70])
    tables, strip = assets.split_jpeg_tables(whole)
    a, fa = jpeg.decode_tiff_strip(whole, b"", True, "x")
    b, fb = jpeg.decode_tiff_strip(strip, tables, True, "x")
    np.testing.assert_array_equal(a, b)
    assert fa == fb == [(2, 2), (1, 1), (1, 1)]
    np.testing.assert_array_equal(a, jpeg.decode_jpeg(whole))  # YCbCr: as cv2 reads the JPEG
    with pytest.raises(ValueError):
        jpeg.decode_tiff_strip(strip, b"", True, "x")


def test_jpeg_tiff_refusals_name_what_they_met(tmp_path):
    """CMYK under JPEG raises ``NotImplementedError`` naming it, old-style
    JPEG (6) ``ValueError``, as cv2's libtiff has no codec for it (CCITT is
    read: test_torch_port_fax_tiff.py); a grey strip
    in a file that says
    RGB is refused as cv2 refuses it; one sample in PlanarConfiguration 2
    reads as contiguous."""
    from PIL import Image

    rng = np.random.default_rng(440)
    rgb = assets.smooth(rng, 16, 24)

    def pil(img, mode="RGB", **kw):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "TIFF", **kw)
        return buf.getvalue()

    data = pil(np.concatenate([rgb, rgb[..., :1]], -1), "CMYK", compression="jpeg")
    with pytest.raises(NotImplementedError, match="photometric CMYK"):
        imageio.decode_image(data)
    # cv2's libtiff has no old-style JPEG codec: cv2 refuses every such file
    data = assets.tiff_bytes(rgb, 8, 2, 6)
    assert assert_like_cv2(data, tmp_path) is None
    with pytest.raises(ValueError, match="old-style JPEG \\(6\\)"):
        imageio.decode_image(data)
    grey = assets.tiff_jpeg_bytes(rgb[..., 0], photometric=1)
    planar = grey.replace(b"\x1c\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                          b"\x1c\x01\x03\x00\x01\x00\x00\x00\x02\x00")
    assert planar != grey and assert_like_cv2(planar, tmp_path) is not None
    as_rgb = grey.replace(b"\x06\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                          b"\x06\x01\x03\x00\x01\x00\x00\x00\x02\x00")
    assert as_rgb != grey and assert_like_cv2(as_rgb, tmp_path) is None
    with pytest.raises(ValueError, match="JPEG-compressed TIFF of photometric 2"):
        tiff.decode_tiff(as_rgb)
