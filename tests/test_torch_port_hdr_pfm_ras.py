"""The port's Radiance HDR (``data/radiance.py``), PFM and Sun raster
(``data/bitmap.py``) readers against cv2 5 bit for bit, through
``read_image`` (``cv2.imread``) and ``decode_image`` (``cv2.imdecode``),
each then ``BGR2RGB``; where cv2 returns None (or raises) the port raises
``ValueError``.

First the committed files of ``assets/images/`` against their manifest
digests; then seeded files from ``scripts/make_port_image_assets.py``'s
writers and ``cv2.imencode`` against cv2 itself: run-length and flat
scanlines, every mantissa and exponent, headers, cut files; PFM's byte
orders, scales, special values and header tokens, and a grey PFM's two
routes; Sun raster's types, depths and colour maps; the dispatch; then the
JAX package's datasets against the port's on all of this PR's formats."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from megreader_tpu_torch.data import bitmap, imageio, radiance  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST if rel.endswith((".hdr", ".pfm", ".ras")))


def _cv2(data, path=None):
    try:
        bgr = (cv2.imread(path, cv2.IMREAD_COLOR) if path
               else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    except cv2.error:  # cv2's size check raises instead of returning None
        return None
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, name="x"):
    """Each route equals cv2's, or refuses where cv2 returns None; returns
    (file route, bytes route), None where refused."""
    path = tmp_path / name
    path.write_bytes(data)
    out = []
    for want, read in ((_cv2(data, str(path)), lambda: imageio.read_image(str(path))),
                       (_cv2(data), lambda: imageio.decode_image(data))):
        if want is None:
            with pytest.raises(ValueError):
                read()
            out.append(None)
            continue
        got = read()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        out.append(got)
    return tuple(out)


@pytest.mark.parametrize("rel", FILES)
def test_committed_file_equals_its_manifest_through_both_routes(rel):
    path = os.path.join(ASSETS, rel)
    with open(path, "rb") as f:
        data = f.read()
    want = MANIFEST[rel]
    for digest, read in ((want, lambda: imageio.read_image(path)),
                         (want.get("imdecode", want), lambda: imageio.decode_image(data, rel))):
        if digest is None or digest["sha256"] is None:
            with pytest.raises(ValueError):
                read()
            continue
        img = read()
        assert list(img.shape) == digest["shape"]
        assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == digest["sha256"]


# ----------------------------------------------------------------- Radiance
def _rgbe(rng, h, w, exponents=(120, 140)):
    px = rng.integers(0, 256, (h, w, 4))
    px[..., 3] = rng.integers(*exponents, (h, w))
    px[:, 1:w // 2] = px[:, :1]  # runs
    return px


@pytest.mark.parametrize("w", [1, 7, 8, 13, 40, 300])
@pytest.mark.parametrize("layout", ["rle", "flat", "rle_then_flat"])
def test_hdr_scanlines_equal_cv2(w, layout, tmp_path):
    """Run-length scanlines (8 to 32767 wide), flat ones, and a run-length
    file that turns flat, which cv2 reads flat to its end."""
    rng = np.random.default_rng(w)
    px = _rgbe(rng, 5, w)
    data = assets.hdr_bytes(px, rle=layout != "flat",
                            flat_from=2 if layout == "rle_then_flat" else None)
    img, _ = assert_like_cv2(data, tmp_path)
    want = np.where(px[..., 3:] > 0, px[..., :3] * 255 * np.exp2(px[..., 3:] - 136.0), 0)
    assert np.abs(img - np.minimum(want, 255)).max() <= 0.5


def test_hdr_every_mantissa_and_exponent_equals_cv2(tmp_path):
    """m * 255 * 2^(e - 136) rounded half to even, saturated, and 0 from
    2^31 up (cv2's float-to-int rounding gives INT_MIN there)."""
    m, e = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([m, np.roll(m, 1, 1), np.roll(m, 7, 1), e], -1)
    img, _ = assert_like_cv2(assets.hdr_bytes(px), tmp_path)
    assert (img[e >= 160] == 0).all() and (img[(m == 255) & (e == 128), 0] == 254).all()


def test_cv2_written_hdr_files_equal_cv2(tmp_path):
    rng = np.random.default_rng(2)
    for h, w in ((1, 1), (7, 13), (33, 50)):
        x = (rng.random((h, w, 3)) * 1.5).astype(np.float32)
        x[0, 0] = 0
        assert_like_cv2(assets.cv_encode(".hdr", x), tmp_path)


HEADERS = [b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n",
           b"#?RADIANCE\n#comment\nFORMAT=32-bit_rle_rgbe\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCEX\n" + b"X" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCE\n" + b"X" * 127 + b"\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n", b"#?RADIANCE\n\n",
           b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n",
           b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
           b"#?RADIANCE FORMAT=32-bit_rle_rgbe\n\n", b"#?RADIANCE\n\0X\nFORMAT=32-bit_rle_rgbe\n\n",
           b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nX\0\n\n", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0\n",
           b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\0junk\n\n"]
RESOLUTIONS = [b"-Y 2 +X 10\n", b"+Y 2 +X 10\n", b"-Y 2 -X 10\n", b"+X 10 -Y 2\n",
               b"-Y2 +X10\n", b"-Y  2 +X 10 junk\n", b" -Y 2 +X 10\n", b"-Y 2 +X 10\r\n",
               b"-Y +2 +X 10\n", b"-Y 2\t+X 9\n", b"-Y 0 +X 10\n", b"-Y 2 +X 10", b"\n"]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_hdr_headers_as_cv2_reads_them(i, tmp_path):
    px = _rgbe(np.random.default_rng(i), 2, 10)
    assert_like_cv2(assets.hdr_bytes(px, header=HEADERS[i]), tmp_path)


@pytest.mark.parametrize("i", range(len(RESOLUTIONS)))
def test_hdr_resolution_lines_as_cv2_reads_them(i, tmp_path):
    px = _rgbe(np.random.default_rng(i), 2, 10)
    assert_like_cv2(assets.hdr_bytes(px, resolution=RESOLUTIONS[i]), tmp_path)


def test_damaged_hdr_files_equal_cv2(tmp_path):
    """Cut files, run counts of 0 or past the scanline, a scanline of
    another width: cv2 refuses them; data after the image is ignored."""
    rng = np.random.default_rng(3)
    data = assets.hdr_bytes(_rgbe(rng, 4, 20))
    start = data.index(b"+X 20\n") + 6
    cases = [data[:n] for n in (start, start + 3, start + 30, len(data) - 1)] + [data + b"xyz"]
    for at, value in ((start + 4, 0), (start + 4, 200), (start + 3, 21), (start + 4, 21)):
        bad = bytearray(data)
        bad[at] = value
        cases.append(bytes(bad))
    for k in range(20):
        bad = bytearray(data)
        bad[int(rng.integers(start, len(data)))] = int(rng.integers(0, 256))
        cases.append(bytes(bad))
    for case in cases:
        assert_like_cv2(case, tmp_path)


# ---------------------------------------------------------------------- PFM
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scale", [-1.0, 1.0, 2.5, -0.3, 1e-40, -float("inf")])
def test_pfm_byte_orders_and_scales_equal_cv2(channels, scale, tmp_path):
    """float32 times float32(1 / |scale|), rounded half to even, saturated,
    and 0 where not finite or from 2^31 up; a grey PFM only through
    cv2.imdecode (cv2.imread refuses it), grey in all three channels."""
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (5, 7), (13, 17)):
        x = (rng.standard_normal((h, w, channels)) * 150).astype(np.float32)
        x.flat[:10] = [0.5, 1.5, 2.5, 254.5, 255.5, -0.5, np.nan, np.inf, 2.0 ** 31, 1e10][
            :x.size][:10]
        by_file, by_bytes = assert_like_cv2(assets.pfm_bytes(x[..., 0] if channels == 1 else x,
                                                             scale), tmp_path)
        assert (by_file is None) == (channels == 1)
        if channels == 1:
            assert (by_bytes == by_bytes[..., :1]).all()


def test_pfm_rounding_is_a_float32_product(tmp_path):
    """Values next to the half-way points of x / |scale|: the product with
    float32(1 / |scale|) in float32 decides them, not a division."""
    rng = np.random.default_rng(4)
    for scale in (3.0, 7.0, 0.3, 1.7, 0.7, 1 / 255):
        x = ((rng.integers(0, 765, (4, 100, 3)) + 0.5) * scale).astype(np.float32)
        x[::2] = np.nextafter(x[::2], np.float32(np.inf))
        assert_like_cv2(assets.pfm_bytes(x, -scale), tmp_path)


PFM_HEADERS = [b"PF\n2 2\n-1\n", b"PF\r\n2 2\n-1\n", b"PF \n2 2\n-1\n", b"PF\n2  2\n-1\n",
               b"PF\n2\n2\n-1\n", b"PF\n 2 2\n-1\n", b"PF\n2 2 -1\n", b"PF\n2 2\n-1.0 \n",
               b"PF\n2a 2\n-1\n", b"PF\n+2 2\n-1\n", b"PF\n2 2\n-1x\n", b"PF\n2 2\nnan\n",
               b"PF\n-2 2\n-1\n", b"PF\n0 2\n-1\n", b"PF\n2.5 2\n-1\n", b"PF\n2\t2\n-1\n",
               b"PF\n2 2\n\n-1\n", b"PF\n2 2\nabc\n", b"PF\n2 2\n-0x1p1\n", b"PF\n0x2 2\n-1\n",
               b"PF\n2 2\n-1\r", b"PF\n2 2\n-1", b"PF\n2 2\n-.5e1\n", b"PF\n2 2\n-INF\n",
               b"PF\n2 \xff2\n-1\n", b"Pf\n2 2\n-1\n"]


@pytest.mark.parametrize("i", range(len(PFM_HEADERS)))
def test_pfm_headers_as_cv2_reads_them(i, tmp_path):
    """Tokens end at one whitespace byte each (two in a row make an empty
    token, read as 0); numbers are C's atoi and strtod of a token's start."""
    body = np.arange(1, 13, dtype="<f4").tobytes()
    assert_like_cv2(PFM_HEADERS[i] + body, tmp_path)
    assert_like_cv2(PFM_HEADERS[i] + body[:-1], tmp_path)


def test_pfm_is_not_taken_for_pnm():
    data = assets.pfm_bytes(np.full((2, 3, 3), 7.4, np.float32))
    np.testing.assert_array_equal(imageio.decode_image(data), np.full((2, 3, 3), 7))
    assert bitmap.is_pfm(data) and not bitmap.is_pfm(b"P6\n1 1\n255\n\0\0\0")


# --------------------------------------------------------------- Sun raster
@pytest.mark.parametrize("bpp", [1, 8, 24, 32])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sun_raster_types_and_depths_equal_cv2(bpp, kind, tmp_path):
    """Types 0 and 1 read (B, G, R and X, B, G, R; 1 and 8 bits through an
    RGB colour map or grey); byte-encoded (2) and RGB (3) files refused, as
    cv2's header test refuses them."""
    rng = np.random.default_rng(bpp + kind)
    maps = [None] + ([rng.integers(0, 256, (1 << bpp, 3)), rng.integers(0, 256, (1, 3))]
                     if bpp <= 8 else [])
    if bpp == 8:
        maps.append(np.repeat(rng.integers(0, 256, (200, 1)), 3, 1))
    for h, w in ((1, 1), (7, 13), (12, 33)):
        rows = rng.integers(0, 256 if bpp > 1 else 256, (h, (w * bpp + 7) // 8))
        if bpp == 8:
            rows = rng.integers(0, 256, (h, w))
        for cmap in maps:
            by_file, _ = assert_like_cv2(assets.sunras_bytes(rows, w, bpp, kind, cmap),
                                         tmp_path)
            assert (by_file is None) == (kind > 1)


def test_sun_raster_headers_maps_and_cuts_as_cv2_reads_them(tmp_path):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 256, (5, 7))
    good = assets.sunras_bytes(rows, 7, 8, 1, rng.integers(0, 256, (10, 3)))
    cases = [good[:n] for n in (4, 20, 31, 32, 61, len(good) - 1)] + [good + b"tail"]
    cases += [assets.sunras_bytes(rows[:, :(7 * bpp + 7) // 8], 7, bpp) for bpp in (2, 4, 16)]
    cases += [assets.sunras_bytes(rows, 7, 8, maptype=2), assets.sunras_bytes(rows, 7, 8,
                                                                              maptype=1)]
    cases += [assets.sunras_bytes(rows[:, :2], 7, 1, colormap=rng.integers(0, 256, (3, 3))),
              assets.sunras_bytes(rows, 7, 24, colormap=rng.integers(0, 256, (2, 3))),
              assets.sunras_bytes(rows[:0], 7, 8), assets.sunras_bytes(rows[:, :0], 0, 8)]
    odd = bytearray(assets.sunras_bytes(rows, 7, 8, colormap=rng.integers(0, 256, (3, 3))))
    odd[31] = 7  # a map of 7 bytes: two entries, from bytes 0, 2, 4 and 1, 3, 5
    cases.append(bytes(odd))
    for case in cases:
        assert_like_cv2(case, tmp_path)
    for img in (rng.integers(0, 256, (7, 13, 3)), rng.integers(0, 256, (7, 13))):
        assert_like_cv2(assets.cv_encode(".ras", img.astype(np.uint8)), tmp_path)


# ------------------------------------------------------------------ dispatch
def test_new_signatures_dispatch_and_others_are_refused_by_name(tmp_path):
    assert radiance.is_hdr(b"#?RADIANCE\n") and radiance.is_hdr(b"#?RGBE")
    assert not radiance.is_hdr(b"#?RGB")
    with pytest.raises(NotImplementedError, match="PFM, Sun raster, Radiance HDR, GIF, TIFF"):
        imageio.decode_image(b"\0\0\0\x20ftypavif\0\0\0\0")  # AVIF
    # JPEG 2000 is read (test_torch_port_jpeg2000.py): its signature box alone, no
    # jp2h, is a damaged file cv2 refuses
    assert cv2.imdecode(np.frombuffer(b"\0\0\0\x0cjP  \r\n\x87\n", np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="JP2"):
        imageio.decode_image(b"\0\0\0\x0cjP  \r\n\x87\n")


# ------------------------------------------------- the JAX package's datasets
def test_jax_datasets_equal_the_ports_on_the_new_formats(tmp_path):
    """``RecognitionListDataset`` (every file) and ``LMDBRecognitionDataset``
    (every file's bytes, with a grey PFM, which only cv2.imdecode reads) on
    CCITT Group 3 and 4 and YCbCr TIFF, Radiance HDR, PFM and Sun raster
    crops: the JAX package's items (cv2) equal the port's bit for bit."""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDB
    from megreader_tpu_torch.data import datasets
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    rng = np.random.default_rng(426)
    crop = assets.smooth(rng, 30, 70)
    bits = (crop[..., 0] > 128).astype(np.uint8)
    rgbe = np.concatenate([crop, rng.integers(128, 136, (30, 70, 1))], -1)
    listed = {
        "g4.tif": assets.fax_tiff(bits, 4, photometric=1),
        "g3.tif": assets.fax_tiff(bits, 3, 5, fill_order=2, rows_per_strip=8),
        "ycbcr.tif": assets.ycbcr_tiff(crop, (2, 2), 5),
        "ycbcr41.tif": assets.ycbcr_tiff(crop, (4, 1), 32773, tile=(16, 16)),
        "rle.hdr": assets.hdr_bytes(rgbe),
        "colour.pfm": assets.pfm_bytes(crop.astype(np.float32) * 1.3),
        "ras8.ras": assets.sunras_bytes(crop[..., 0], 70, 8, colormap=rng.integers(0, 256,
                                                                                   (256, 3))),
        "ras32.ras": assets.sunras_bytes(np.concatenate([crop, crop[..., :1]], -1).reshape(
            30, -1), 70, 32),
    }
    stored = {**listed, "grey.pfm": assets.pfm_bytes(crop[..., 1].astype(np.float32), 0.5)}
    (tmp_path / "images").mkdir()
    lines = []
    for i, (name, data) in enumerate(sorted(listed.items())):
        (tmp_path / "images" / name).write_bytes(data)
        lines.append(f"images/{name}\tword{i}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    records = {b"num-samples": str(len(stored)).encode()}
    for i, (name, data) in enumerate(sorted(stored.items())):
        records[f"image-{i + 1:09d}".encode()] = data
        records[f"label-{i + 1:09d}".encode()] = f"word{i}".encode()
    write_fixture_lmdb(str(tmp_path / "lmdb"), records)
    for ref, got, n in ((jax_datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                             canvas_hw=(48, 128)),
                         datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                         canvas_hw=(48, 128)), len(listed)),
                        (JaxLMDB(str(tmp_path / "lmdb"), canvas_hw=(48, 128)),
                         LMDBRecognitionDataset(str(tmp_path / "lmdb"), canvas_hw=(48, 128)),
                         len(stored))):
        assert len(ref) == len(got) == n
        for i in range(n):
            a, b = got[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
