"""JPEGs cut short and progressive files with unrefined bits in
``data/jpeg.py``, bit for bit against cv2 5 (libjpeg-turbo 3.1):
``read_image`` against ``cv2.imread`` (libjpeg's stdio source supplies an
EOI where the file ends, the Huffman decoder reads zero bits from there, and
the rest of the scan stays grey or as earlier scans left it) and
``decode_image`` against ``cv2.imdecode`` (which refuses a cut file).

First the committed cut and unrefined files of ``assets/images/`` against
their manifest digests (no cv2 needed); then seeded files cut at many
offsets against cv2 itself; then libjpeg-turbo's block smoothing on files
made by hand (DC impulses isolate its 5x5 weights); then the AVX2 inverse
DCT's saturation on extreme coefficients; then the refusals by name."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

from megreader_tpu_torch.data import imageio, jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
CUT_FILES = sorted(rel for rel in MANIFEST
                   if rel.split("/")[1].startswith(("jpeg_cut", "jpeg_unrefined"))
                   or rel in ("pages/page_cut.jpg", "pages/page_progressive_cut.jpg"))


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("rel", CUT_FILES)
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
        assert list(img.shape) == digest["shape"] and _sha(img) == digest["sha256"]


def test_committed_cut_files_cover_every_kind():
    names = [rel.split("/")[1] for rel in CUT_FILES]
    for kind in ("s420", "grey", "s444", "s422", "rst2", "multiscan_33x50_scan1",
                 "multiscan_33x50_scan2", "progressive_33x50_dc", "progressive_33x50_ac_first",
                 "progressive_33x50_refine", "progressive_33x50_dc_refine", "in_headers",
                 "in_sos_tail", "after_sos", "unrefined"):
        assert any(kind in n for n in names), kind
    assert len(CUT_FILES) >= 30


# ------------------------------------------------------- against cv2 itself
@pytest.fixture(scope="module")
def cv():
    cv2 = pytest.importorskip("cv2")
    import make_port_image_assets as assets

    return cv2, assets


def _cv2_routes(cv2, data, tmp_path):
    path = tmp_path / "cut.jpg"
    path.write_bytes(data)
    out = []
    for bgr in (cv2.imread(str(path), cv2.IMREAD_COLOR),
                cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)):
        out.append(None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return str(path), out


def assert_like_cv2(cv2, data, tmp_path):
    """Both routes equal cv2's, or refuse where cv2 returns None; returns
    the file route's image (or None)."""
    path, (by_file, by_bytes) = _cv2_routes(cv2, data, tmp_path)
    for want, read in ((by_file, lambda: imageio.read_image(path)),
                       (by_bytes, lambda: imageio.decode_image(data))):
        if want is None:
            with pytest.raises(ValueError):
                read()
        else:
            np.testing.assert_array_equal(read(), want)
    return by_file


def _seeded(cv2, assets, kind, seed):
    rng = np.random.default_rng(seed)
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    img = assets.smooth(rng, 37, 53, 1 if kind == "grey" else 3)
    return {
        "baseline": lambda: assets.cv_encode(".jpg", img),
        "grey": lambda: assets.cv_encode(".jpg", img),
        "s444": lambda: assets.cv_encode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
        "restart": lambda: assets.cv_encode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
        "multiscan": lambda: assets.jpeg_rescan(assets.cv_encode(".jpg", img), [[1], [0, 2]]),
        "multiscan_restart": lambda: assets.jpeg_rescan(assets.cv_encode(".jpg", img),
                                                        [[0], [1, 2]], 3),
        "progressive": lambda: assets.cv_encode(".jpg", img, prog),
        "progressive_restart": lambda: assets.cv_encode(".jpg", img, prog + [
            cv2.IMWRITE_JPEG_RST_INTERVAL, 4]),
    }[kind]()


KINDS = ["baseline", "grey", "s444", "restart", "multiscan", "multiscan_restart", "progressive",
         "progressive_restart"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(6))
def test_seeded_cut_equals_cv2(kind, seed, cv, tmp_path):
    """48 seeded cuts (8 kinds of file, 6 offsets each, both routes): every
    scan of the file is cut somewhere, inside its data or its header."""
    cv2, assets = cv
    data = _seeded(cv2, assets, kind, 100 + seed)
    rng = np.random.default_rng(200 + seed)
    scans = assets.scans(data)
    start = scans[0][0] - 8
    cut = int(rng.integers(start, len(data) - 2))
    if seed < len(scans):  # one cut inside each scan's data, the others anywhere
        _, a, b = scans[seed]
        cut = int(rng.integers(a, max(a + 1, b)))
    img = assert_like_cv2(cv2, data[:cut], tmp_path)
    assert cut < scans[0][1] - 3 or img is not None


def test_the_grey_rest_and_the_mcu_where_the_data_ran_out(cv, tmp_path):
    """A baseline file cut at half its data: the MCUs after the cut are
    libjpeg's grey (every sample 128), the MCU in which the data ran out is
    decoded from zero bits, and cv2.imdecode refuses the file."""
    cv2, assets = cv
    data = assets.cv_encode(".jpg", assets.smooth(np.random.default_rng(3), 64, 64))
    cut = assets.cut_in_scan(data, 0, 0.5)
    img = assert_like_cv2(cv2, cut, tmp_path)
    grey = (img == 128).all(2)
    assert grey[48:].all() and not grey[:16].all()
    with pytest.raises(ValueError, match="truncated"):
        imageio.decode_image(cut)


def test_cuts_inside_the_headers(cv, tmp_path):
    """cv2.imread refuses a file cut inside its headers, but for a
    sequential scan header cut in its last 3 bytes (libjpeg reads them from
    the EOI it supplies and only warns); a progressive one is refused."""
    cv2, assets = cv
    rng = np.random.default_rng(4)
    for params in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        data = assets.cv_encode(".jpg", assets.smooth(rng, 24, 40), params)
        _, start, _ = assets.scans(data)[0]
        for cut in (2, 20, 100, start - 14, start - 4, start - 3, start - 1, start):
            img = assert_like_cv2(cv2, data[:cut], tmp_path)
            assert (img is not None) == (cut >= start - (3 if not params else 0)), cut
    with pytest.raises(ValueError, match="headers|before its scan"):
        imageio.read_image(_write(tmp_path, data[:150]))


def _write(tmp_path, data):
    path = tmp_path / "h.jpg"
    path.write_bytes(data)
    return str(path)


def test_a_cut_between_progressive_scans(cv, tmp_path):
    """Cut inside the segments between two scans: a table cut in its counts
    is refused, one cut in its symbols read (libjpeg never uses it), a cut
    inside the next scan header refused."""
    cv2, assets = cv
    data = assets.cv_encode(".jpg", assets.smooth(np.random.default_rng(5), 33, 50),
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    scans = assets.scans(data)
    _, _, end = scans[2]
    results = [assert_like_cv2(cv2, data[:cut], tmp_path) is not None
               for cut in range(end, scans[3][1] + 2)]
    assert any(results) and not all(results)


# ------------------------------------------------------- block smoothing
def _dc_only(dcs, quant, components=1):
    """A progressive JPEG of one DC scan (interleaved over ``components``
    grey-like components of sampling 1x1), DC values ``dcs`` (rows,
    columns), table ``quant`` (8, 8) natural order, Huffman codes of four
    bits for categories 0-11."""
    import struct

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    gy, gx = dcs.shape
    dqt = seg(0xDB, bytes([0]) + bytes(np.asarray(quant).reshape(-1)[jpeg.ZIGZAG].tolist()))
    sof = seg(0xC2, struct.pack(">BHHB", 8, gy * 8, gx * 8, components)
              + b"".join(bytes([c + 1, 0x11, 0]) for c in range(components)))
    dht = seg(0xC4, bytes([0, 0, 0, 0, 12] + [0] * 12 + list(range(12))))
    sos = seg(0xDA, bytes([components]) + b"".join(bytes([c + 1, 0]) for c in range(components))
              + b"\0\0\0")
    codes = []
    pred = [0] * components
    for v in dcs.reshape(-1).tolist():
        for c in range(components):
            d, pred[c] = v - pred[c], v
            cat = abs(d).bit_length()
            codes += [(cat, 4), (d if d > 0 else d + (1 << cat) - 1, cat)]
    bits = "".join(format(value & ((1 << n) - 1), f"0{n}b") if n else "" for value, n in codes)
    bits += "1" * (-len(bits) % 8)  # the fill bits
    out = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return (b"\xff\xd8" + dqt + sof + dht + sos + out.replace(b"\xff", b"\xff\0")
            + b"\xff\xd9")


def _decode_grey(cv2, data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("value", [1024, -300, 77])
def test_dc_impulses_equal_cv2(value, cv):
    """One block's DC in a field of zeros, at the centre, an edge and a
    corner of a 10x10 grid: each neighbour's estimates come from one term of
    each weight table (``jpeg._SMOOTHING``), so every weight and the
    rounding of each estimate are held to cv2 on their own."""
    cv2, _ = cv
    q = np.full((8, 8), 4, np.int64)
    q[0, 0] = 1
    for y, x in ((5, 5), (0, 4), (9, 9), (1, 8)):
        dcs = np.zeros((10, 10), np.int64)
        dcs[y, x] = value
        data = _dc_only(dcs, q)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data)[..., 0], _decode_grey(cv2, data))


@pytest.mark.parametrize("gy", [1, 2, 3, 4])
def test_dc_only_smoothing_at_every_small_grid(gy, cv):
    """Rows and columns of 1 to 5 blocks: the 5x5 window replicates at the
    edges (a row of two blocks too)."""
    cv2, _ = cv
    rng = np.random.default_rng(gy)
    q = rng.integers(1, 30, (8, 8))
    for gx in range(1, 6):
        data = _dc_only(rng.integers(-100, 100, (gy, gx)), q)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data)[..., 0], _decode_grey(cv2, data))


@pytest.mark.parametrize("height", [17, 20, 24, 33, 41, 49])
def test_smoothing_in_the_last_imcu_row_of_420_files(height, cv):
    """4:2:0 files of only their DC scan: in the last iMCU row of luma with
    an odd number of block rows, libjpeg-turbo counts block rows as its
    iMCU row times the rows it has, and its edge tests follow that count."""
    cv2, assets = cv
    data = assets.cv_encode(".jpg", assets.smooth(np.random.default_rng(height), height, 24),
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    dc = data[:assets.scans(data)[1][0]] + b"\xff\xd9"
    rgb = cv2.cvtColor(cv2.imdecode(np.frombuffer(dc, np.uint8), cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(imageio.decode_image(dc), rgb)


@pytest.mark.parametrize("last", range(1, 10))
def test_progressive_files_ending_after_each_scan(last, cv, tmp_path):
    """cv2's ten-scan script stopped after each scan (an EOI there): the
    smoothing of unknown and unrefined coefficients, and of the DC where no
    AC coefficient is known yet, at 7x13, 33x50 and 37x100."""
    cv2, assets = cv
    rng = np.random.default_rng(30 + last)
    for h, w in ((7, 13), (33, 50), (37, 100)):
        data = assets.cv_encode(".jpg", assets.smooth(rng, h, w), [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                                   1])
        assert_like_cv2(cv2, data[:assets.scans(data)[last][0]] + b"\xff\xd9", tmp_path)


# ----------------------------------------------------- the AVX2 inverse DCT
def test_extreme_coefficients_saturate_as_the_avx2_idct_does(cv, monkeypatch):
    """Coefficients up to the standard tables' limits with quantizers of a
    quality-5 file: the products and sums wrap at 16 bits and the outputs
    saturate, as ``jsimd_idct_islow_avx2`` computes them (the C code would
    wrap them through its range-limit table)."""
    cv2, assets = cv
    rng = np.random.default_rng(8)
    base = assets.cv_encode(".jpg", assets.smooth(rng, 32, 32, 1), [cv2.IMWRITE_JPEG_QUALITY, 5])
    coef = jpeg.read_coefficients(base)
    blocks = rng.integers(-1023, 1024, coef["blocks"][0].shape)
    blocks *= rng.random(blocks.shape) < 0.15
    blocks[..., 0, 0] = rng.integers(-200, 200, blocks.shape[:2])
    monkeypatch.setattr(jpeg, "read_coefficients",
                        lambda data: {**coef, "blocks": [blocks.astype(np.int16)]})
    data = assets.jpeg_rescan(base, [[0]])
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data)[..., 0], ref)
    assert ((ref == 0) | (ref == 255)).mean() > 0.2


# --------------------------------------------------------------- refusals
def test_refusals_name_what_they_met(cv, tmp_path):
    cv2, assets = cv
    data = assets.cv_encode(".jpg", assets.smooth(np.random.default_rng(9), 33, 50),
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cut = assets.cut_in_scan(data, 3, 0.5)
    assert imageio.read_image(_write(tmp_path, cut)).shape == (33, 50, 3)
    with pytest.raises(ValueError, match="truncated JPEG: a progressive scan runs to the end"):
        imageio.decode_image(cut)
    with pytest.raises(ValueError, match="truncated JPEG: the file ends inside its headers"):
        imageio.read_image(_write(tmp_path, data[:165]))  # inside the frame header
    base = assets.cv_encode(".jpg", assets.smooth(np.random.default_rng(10), 33, 50))
    with pytest.raises(ValueError, match="truncated"):
        imageio.decode_image(assets.cut_in_scan(base, 0, 0.5))
