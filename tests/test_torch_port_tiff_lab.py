"""The port's CIE L*a*b* TIFF reader (``data/tiff.py``, ``data/cielab.py``)
against cv2 5 (libtiff 4.7) bit for bit, through ``read_image``
(``cv2.imread``) and ``decode_image`` (``cv2.imdecode``), each then
``BGR2RGB``; where cv2 returns None the port raises ``ValueError``.

First the conversion's tables and arithmetic against libtiff's own
(``TIFFCIELabToRGBInit``, ``TIFFCIELabToXYZ``, ``TIFFXYZToRGB`` of PIL's
libtiff through ``ctypes``: ``scripts/libtiff_ctypes.py``); then every
pair of 8-bit L*, a*, b* values and seeded 16-bit ones against cv2; then
seeded files of ``scripts/make_port_image_assets.py``'s writers and PIL's
(mode ``LAB``): 8 and 16 bits, strips and tiles, every compression with
Predictor 2, both byte orders, each Orientation, a WhitePoint, JPEG-
compressed L*a*b* (PIL's, and cv2's JPEGs as strips and tiles); the
refusals; and the JAX datasets against the port's on an L*a*b* crop and a
signed one."""

import io
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from megreader_tpu_torch.data import cielab, imageio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import libtiff_ctypes as lt  # noqa: E402
import make_port_image_assets as assets  # noqa: E402

D65 = (3127, 10000, 3290, 10000)  # WhitePoint as two RATIONALs


def _cv2(data, path=None):
    bgr = (cv2.imread(path, cv2.IMREAD_COLOR) if path
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, routes=("file", "bytes")):
    """Each route equals cv2's, or refuses where cv2 returns None; returns
    the images (None where refused)."""
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    out = []
    for route in routes:
        want = _cv2(data, str(path) if route == "file" else None)
        read = ((lambda: imageio.read_image(str(path))) if route == "file"
                else (lambda: imageio.decode_image(data)))
        if want is None:
            with pytest.raises(ValueError):
                read()
            out.append(None)
            continue
        got = read()
        assert got.shape == want.shape, route
        np.testing.assert_array_equal(got, want, err_msg=route)
        out.append(got)
    return out


def _pil_lab(lab, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(lab, np.uint8), "LAB").save(buf, "TIFF", **kw)
    return buf.getvalue()


# ------------------------------------------------------------ libtiff's own
@pytest.fixture(scope="module")
def lib():
    return lt.library()


@pytest.mark.parametrize("white", [None, (0.3127, 0.329), (0.25, 0.4)])
def test_tables_and_conversion_are_libtiffs(white, lib):
    """``TIFFCIELabToRGBInit``'s tables, step and reference white entry for
    entry, then ``TIFFCIELabToXYZ`` + ``TIFFXYZToRGB`` on seeded values and
    the extremes."""
    wp = None if white is None else tuple(np.float32(v) for v in white)
    ref = cielab.reference_white(wp)
    state = lt.cielab_state(lib, ref)
    table, step = cielab.tables()
    assert state.range == cielab.RANGE
    for name in ("Yr2r", "Yg2g", "Yb2b"):
        np.testing.assert_array_equal(np.array(getattr(state, name), np.float32), table)
    assert np.float32(state.rstep) == np.float32(state.bstep) == step
    assert (np.float32(state.X0), np.float32(state.Y0), np.float32(state.Z0)) == ref
    rng = np.random.default_rng(0)
    lab = np.concatenate([rng.integers(0, 256, (1500, 3)), [[0, 0, 0], [255, 127, 128],
                                                           [255, 128, 127], [0, 127, 127]]])
    np.testing.assert_array_equal(cielab.lab8_to_rgb(lab, wp), lt.lab8_to_rgb(lib, state, lab))


def test_default_white_point_is_d50():
    x, y = cielab.default_white_point()
    assert abs(x - 0.3457) < 1e-4 and abs(y - 0.3585) < 1e-4


# ------------------------------------------------------ every value by cv2
@pytest.mark.parametrize("pair", ["l_a", "l_b", "a_b"])
def test_every_8bit_pair_equals_cv2(pair, tmp_path):
    """Every L* with every a* (or b*), and every a* with every b*, at three
    values of the third: float32 as libtiff computes."""
    p, q = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for third in (0, 127, 200):
        c = np.full_like(p, third)
        lab = {"l_a": (p, q, c), "l_b": (p, c, q), "a_b": (c, p, q)}[pair]
        data = assets.tiff_bytes(np.stack(lab, -1), 8, 8, 1)
        assert_like_cv2(data, tmp_path, ("bytes",))


def test_16bit_values_equal_cv2(tmp_path):
    """Seeded 16-bit L*, a*, b* over the whole range and near zero (a* and
    b* as signed 16-bit), both byte orders."""
    rng = np.random.default_rng(1)
    lab = rng.integers(0, 65536, (128, 256, 3))
    lab[:32, :, 1:] = (rng.integers(-300, 300, (32, 256, 2)) + 65536) % 65536
    for order in "<>":
        assert_like_cv2(assets.tiff_bytes(lab, 16, 8, 8, order), tmp_path, ("bytes",))


# ---------------------------------------------------------------- the files
@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
def test_strips_tiles_compressions_and_orders_equal_cv2(bps, compression, tmp_path):
    rng = np.random.default_rng(bps + compression)
    for (h, w), layout in (((1, 1), {}), ((7, 13), dict(rows_per_strip=3)),
                           ((33, 50), dict(tile=(16, 32))), ((37, 45), dict(rows_per_strip=8))):
        lab = assets.smooth(rng, h, w, 3, 1 << bps)
        for order in "<>":
            kw = dict(layout, predictor=2) if compression in (5, 8, 32946) else layout
            img = assert_like_cv2(assets.tiff_bytes(lab, bps, 8, compression, order, **kw),
                                  tmp_path)[0]
            if img is not None:
                assert img.shape == (h, w, 3)


def test_orientations_white_points_and_signed_tag_equal_cv2(tmp_path):
    """Each Orientation (a square image, since ``cv2.imread`` refuses a
    transposed non-square one), a D65 WhitePoint, a WhitePoint of one value
    (libtiff ignores it) and SampleFormat 2 (a* and b* are signed anyway)."""
    rng = np.random.default_rng(2)
    lab = assets.smooth(rng, 20, 20)
    plain = assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5), tmp_path)[0]
    for o in range(2, 9):
        assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5, orientation=o), tmp_path)
        assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5, orientation=o, tile=(16, 16)), tmp_path)
    d65 = assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5, more={318: (5, list(D65))}),
                          tmp_path)[0]
    assert not np.array_equal(d65, plain)
    one = assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5, more={318: (5, D65[:2])}), tmp_path)[0]
    np.testing.assert_array_equal(one, plain)
    signed = assert_like_cv2(assets.tiff_bytes(lab, 8, 8, 5, more={339: (3, [2] * 3)}),
                             tmp_path)[0]
    np.testing.assert_array_equal(signed, plain)


def test_pil_lab_files_equal_cv2(tmp_path):
    """PIL's mode ``LAB`` under every compression it writes, JPEG too."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (7, 13), (33, 50)):
        lab = assets.smooth(rng, h, w)
        for comp in (None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits", "jpeg"):
            img = assert_like_cv2(_pil_lab(lab, compression=comp), tmp_path)[0]
            assert img.shape == (h, w, 3)
    assert_like_cv2(_pil_lab(assets.smooth(rng, 40, 61), compression="jpeg", quality=40),
                    tmp_path)


def test_jpeg_compressed_lab_strips_and_tiles_equal_cv2(tmp_path):
    """cv2's 4:4:4 JPEGs declared L*a*b*: libtiff decodes them as coded
    (``JCS_UNKNOWN``), then converts; strips, tiles, ``JPEGTables``, an
    orientation. 4:2:0 is refused, as for RGB."""
    rng = np.random.default_rng(4)
    img = assets.smooth(rng, 37, 45)
    for kw in (dict(), dict(rows_per_strip=8, tables=True), dict(tile=(16, 16)),
               dict(tile=(32, 16), tables=True, quality=50)):
        assert_like_cv2(assets.tiff_jpeg_bytes(img, photometric=8, sampling=0x111111, **kw),
                        tmp_path)
    assert_like_cv2(assets.tiff_jpeg_bytes(img[:33, :33], photometric=8, sampling=0x111111,
                                           orientation=6), tmp_path)
    assert assert_like_cv2(assets.tiff_jpeg_bytes(img, photometric=8, sampling=0x221111),
                           tmp_path) == [None, None]


def test_lab_refusals(tmp_path):
    """cv2 returns None on L*a*b* of one, two or four samples (with or
    without ExtraSamples), of separate planes (JPEG-compressed too), of 4
    bits, and with a WhitePoint whose y is 0: the port raises ValueError."""
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 256, (10, 13, 3))
    four = np.concatenate([lab, lab[..., :1]], -1)
    planar_jpeg = assets.tiff_jpeg_bytes(assets.smooth(rng, 16, 16), photometric=8,
                                         sampling=0x111111)
    planar_jpeg = planar_jpeg.replace(b"\x1c\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                                      b"\x1c\x01\x03\x00\x01\x00\x00\x00\x02\x00")
    for data in (assets.tiff_bytes(lab[..., 0], 8, 8, 1), assets.tiff_bytes(lab[..., :2], 8, 8, 1),
                 assets.tiff_bytes(four, 8, 8, 1), assets.tiff_bytes(four, 8, 8, 5, extra=[0]),
                 assets.tiff_bytes(four, 8, 8, 5, extra=[1]),
                 assets.tiff_bytes(four, 8, 8, 5, extra=[2]),
                 assets.tiff_bytes(lab, 8, 8, 1, extra=[2]),
                 assets.tiff_bytes(lab, 8, 8, 1, planar=2), assets.tiff_bytes(lab, 16, 8, 8,
                                                                              planar=2),
                 assets.tiff_bytes(lab % 16, 4, 8, 1), planar_jpeg,
                 assets.tiff_bytes(lab, 8, 8, 1, more={318: (5, [3127, 10000, 0, 10000])}),
                 assets.tiff_bytes(lab, 8, 8, 1, more={318: (5, [3127, 10000, 1, 0])})):
        assert assert_like_cv2(data, tmp_path) == [None, None]
        with pytest.raises(ValueError, match="L\\*a\\*b\\*"):
            imageio.decode_image(data)


def test_a_lab_page_decodes_and_its_time_is_printed():
    import time

    rng = np.random.default_rng(6)
    lab = assets.smooth(rng, 640, 640)
    data = assets.tiff_bytes(lab, 8, 8, 5, predictor=2, rows_per_strip=32)
    t0 = time.perf_counter()
    img = imageio.decode_image(data)
    took = time.perf_counter() - t0
    np.testing.assert_array_equal(img, _cv2(data))
    print(f"640x640 CIE L*a*b* LZW TIFF: {took * 1e3:.0f} ms on this host")


# ------------------------------------------------------- the JAX datasets
def test_jax_datasets_equal_the_ports_on_lab_and_signed_crops(tmp_path):
    """``RecognitionListDataset`` (``cv2.imread``) and
    ``LMDBRecognitionDataset`` (``cv2.imdecode``): the JAX package's items
    equal the port's bit for bit on L*a*b* crops (8 and 16 bits, PIL's JPEG)
    and signed ones (8-bit grey, 16-bit RGB), and an old-style LZW crop."""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDB
    from megreader_tpu_torch.data import datasets
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    rng = np.random.default_rng(7)
    files = {
        "lab8.tif": assets.tiff_bytes(assets.smooth(rng, 31, 90), 8, 8, 5, predictor=2),
        "lab16.tif": assets.tiff_bytes(assets.smooth(rng, 24, 61, 3, 65536), 16, 8, 8),
        "lab_jpeg.tif": _pil_lab(assets.smooth(rng, 33, 51), compression="jpeg"),
        "signed_grey.tif": assets.tiff_bytes(assets.smooth(rng, 40, 70, 1), 8, 1, 32773,
                                             more={339: (3, [2])}),
        "signed_rgb16.tif": assets.tiff_bytes(assets.smooth(rng, 30, 64, 3, 65536), 16, 2, 8,
                                              predictor=2, more={339: (3, [2] * 3)}),
        "old_lzw.tif": assets.tiff_bytes(assets.smooth(rng, 28, 77), 8, 2, 5, old_lzw=True),
    }
    (tmp_path / "images").mkdir()
    lines, records = [], {b"num-samples": str(len(files)).encode()}
    for i, (name, data) in enumerate(sorted(files.items())):
        (tmp_path / "images" / name).write_bytes(data)
        lines.append(f"images/{name}\tword{i}")
        records[f"image-{i + 1:09d}".encode()] = data
        records[f"label-{i + 1:09d}".encode()] = f"word{i}".encode()
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    write_fixture_lmdb(str(tmp_path / "lmdb"), records)
    kw = dict(canvas_hw=(48, 128))
    for ref, got in ((jax_datasets.RecognitionListDataset(str(tmp_path / "list.txt"), **kw),
                      datasets.RecognitionListDataset(str(tmp_path / "list.txt"), **kw)),
                     (JaxLMDB(str(tmp_path / "lmdb"), **kw),
                      LMDBRecognitionDataset(str(tmp_path / "lmdb"), **kw))):
        assert len(ref) == len(got) == len(files)
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
