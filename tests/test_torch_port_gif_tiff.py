"""The port's GIF and TIFF readers (``data/gif.py``, ``data/tiff.py``)
against cv2 5 bit for bit, through ``read_image`` (``cv2.imread``) and
``decode_image`` (``cv2.imdecode``), each then ``BGR2RGB``; where cv2 returns
None the port raises ``ValueError``, and what cv2 reads that the port does
not raises ``NotImplementedError`` naming it.

First the committed GIF and TIFF files of ``assets/images/`` against their
manifest digests (no cv2 needed); then seeded files from
``scripts/make_port_image_assets.py``'s writers against cv2 itself (tables,
transparency, frames, LZW code streams; every compression, photometric
interpretation, depth, layout and orientation); then the quirks of cv2 and
libtiff the port copies; then the refusals; then the JAX package's
``RecognitionListDataset`` and ``DetectionICDARDataset`` against the port's
on a cut JPEG, a GIF and a TIFF."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

from megreader_tpu_torch.data import gif, imageio, tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST if rel.endswith((".gif", ".tif")))


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


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
        assert list(img.shape) == digest["shape"] and _sha(img) == digest["sha256"]


def test_committed_files_cover_both_formats_and_pages():
    assert sum(rel.endswith(".gif") for rel in FILES) >= 15
    assert sum(rel.endswith(".tif") for rel in FILES) >= 40
    assert {"pages/page.gif", "pages/page_lzw_predictor.tif"} <= set(FILES)


# ------------------------------------------------------- against cv2 itself
@pytest.fixture(scope="module")
def cv():
    cv2 = pytest.importorskip("cv2")
    import make_port_image_assets as assets

    return cv2, assets


def assert_like_cv2(cv2, data, tmp_path, name="x"):
    """Both routes equal cv2's, or refuse where cv2 returns None; returns
    (file route, bytes route), None where refused."""
    path = tmp_path / name
    path.write_bytes(data)
    out = []
    for bgr, read in ((cv2.imread(str(path), cv2.IMREAD_COLOR),
                       lambda: imageio.read_image(str(path))),
                      (cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                       lambda: imageio.decode_image(data, name))):
        if bgr is None:
            with pytest.raises(ValueError):
                read()
            out.append(None)
            continue
        got = read()
        np.testing.assert_array_equal(got, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        out.append(got)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_seeded_gifs_equal_cv2(seed, cv, tmp_path):
    """Screens of 1-40 pixels a side, minimum code sizes 2-8, global and
    local tables of every size (or none), an image smaller than the screen
    at an offset, interlaced, a transparent index, clear codes every few
    codes or never once the table is full; a few indices past the tables
    and a few files cut short."""
    cv2, assets = cv
    rng = np.random.default_rng(seed)
    for _ in range(25):
        h, w = (int(v) for v in rng.integers(1, 41, 2))
        m = int(rng.integers(2, 9))
        gs = [None, 2, 4, 16, 256][rng.integers(0, 5)]
        ls = [None, None, 2, 8, 256][rng.integers(0, 5)]
        fh, fw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        top, left = int(rng.integers(0, h - fh + 1)), int(rng.integers(0, w - fw + 1))
        hi = min(1 << m, max(gs or 0, ls or 0) or 256) + (3 if rng.random() < 0.05 else 0)
        idx = rng.integers(0, min(hi, 1 << m), (fh, fw))
        if rng.random() < 0.5:
            idx = np.repeat(idx[:, :1], fw, 1)
        lzw = {}
        if rng.random() < 0.3:
            lzw["clear_when_full"] = False
        if rng.random() < 0.2:
            lzw["clear_every"] = int(rng.integers(5, 300))
        frame = dict(idx=idx, min_size=m, left=left, top=top, lzw=lzw,
                     interlace=bool(rng.random() < 0.3),
                     lct=rng.integers(0, 256, (ls, 3)) if ls else None,
                     transparent=int(rng.integers(0, hi)) if rng.random() < 0.3 else None)
        data = assets.gif_bytes([frame], (h, w), rng.integers(0, 256, (gs, 3)) if gs else None,
                                bg=int(rng.integers(0, gs or 256)))
        if rng.random() < 0.1:
            data = data[:int(rng.integers(10, len(data)))]
        assert_like_cv2(cv2, data, tmp_path)


def _codes(codes, min_size):
    """GIF LZW codes at the widths a decoder reads them, least significant
    bit first."""
    clear = 1 << min_size
    width, free, prev, acc, n = min_size + 1, clear + 2, None, 0, 0
    for c in codes:
        acc |= c << n
        n += width
        if c == clear:
            width, free, prev = min_size + 1, clear + 2, None
            continue
        if c != clear + 1 and prev is not None and free < 4096:
            free += 1
            if free == 1 << width and width < 12:
                width += 1
        prev = c
    return acc.to_bytes(-(-n // 8), "little")


@pytest.mark.parametrize("name,codes,refused", [
    ("whole", [4, 0, 1, 2, 3, 0, 1, 5], False),
    ("no end code", [4, 0, 1, 2, 3, 0, 1], False),
    ("no clear code", [0, 1, 2, 3, 0, 1, 5], False),
    ("a clear code inside", [4, 0, 4, 1, 2, 3, 0, 1, 5], False),
    ("a string past the last pixel", [4, 0, 1, 6, 6, 5], False),
    ("code = next (KwKwK)", [4, 0, 6, 1, 2, 3, 5], False),
    ("end code early", [4, 0, 1, 2, 5], True),
    ("codes past the last pixel", [4, 0, 1, 2, 3, 0, 1, 2, 3, 5], True),
    ("data after the end code", [4, 0, 1, 2, 3, 0, 1, 5, 0, 0], True),
    ("a code past the table", [4, 0, 9, 5], True),
    ("a first code past the literals", [4, 6, 5], True),
])
def test_gif_lzw_streams_as_cv2_reads_them(name, codes, refused, cv, tmp_path):
    """A 2x3 image of minimum code size 2 from hand-made code streams."""
    cv2, assets = cv
    pal = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90], [100, 110, 120]], np.uint8)
    import struct

    data = (b"GIF89a" + struct.pack("<HHBBB", 3, 2, 0xF1, 0, 0) + pal.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, 3, 2, 0) + b"\x02"
            + assets.sub_blocks(_codes(codes, 2)) + b";")
    by_file, _ = assert_like_cv2(cv2, data, tmp_path)
    assert (by_file is None) == refused


def test_gif_colour_rules(cv, tmp_path):
    """The transparent index and the pixels outside the image read the
    global table's background entry (black without a global table); a local
    table overlays the global one from entry 0 and the larger sets the
    bound; without tables index i reads grey i, but 1 white."""
    cv2, assets = cv
    rng = np.random.default_rng(3)
    gct, lct = rng.integers(0, 256, (32, 3)), rng.integers(0, 256, (8, 3))
    idx = rng.integers(0, 32, (9, 11))
    img, _ = assert_like_cv2(cv2, assets.gif_bytes(
        [dict(idx=idx, min_size=5, lct=lct, transparent=4, left=2, top=1)], (12, 16), gct, bg=7),
        tmp_path)
    frame = img[1:10, 2:13]
    assert (img[0] == gct[7]).all() and (frame[idx == 4] == gct[7]).all()
    mask = (idx != 4) & (idx >= 8)
    assert (frame[mask] == gct[idx[mask]]).all()
    assert (frame[(idx < 8) & (idx != 4)] == lct[idx[(idx < 8) & (idx != 4)]]).all()
    ramp = np.arange(256).reshape(16, 16)
    img, _ = assert_like_cv2(cv2, assets.gif_bytes([dict(idx=ramp)], (16, 16)), tmp_path)
    want = np.repeat(ramp[..., None], 3, 2)
    want[0, 1] = 255
    np.testing.assert_array_equal(img, want)
    for bad in (assets.gif_bytes([dict(idx=idx, min_size=5)], (9, 11), gct[:16]),
                assets.gif_bytes([dict(idx=idx, min_size=5)], (9, 11), gct, bg=40),
                assets.gif_bytes([dict(idx=idx, min_size=5, left=1)], (9, 11), gct)):
        assert assert_like_cv2(cv2, bad, tmp_path) == [None, None]


def test_gif_page_decodes_in_well_under_a_second(cv):
    """A 640x640 page of 256 colours of noise, LZW at 8 bits."""
    import time

    cv2, assets = cv
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 256, (640, 640))
    idx[100:300] = 7
    data = assets.gif_bytes([dict(idx=idx)], (640, 640), rng.integers(0, 256, (256, 3)))
    t0 = time.perf_counter()
    img = gif.decode_gif(data)
    took = time.perf_counter() - t0
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(img, ref)
    print(f"640x640 GIF of 256 colours: {took * 1e3:.0f} ms on this host")


# ------------------------------------------------------------------ TIFF
@pytest.mark.parametrize("seed", range(10))
def test_seeded_tiffs_equal_cv2(seed, cv, tmp_path):
    """Photometric 0, 1, 2, 3 and 5 at 1, 2, 4, 8 and 16 bits (cv2 reads
    some), one to five samples, every compression, either byte order,
    strips of any height or tiles of 16-48 pixels, planar, Predictor 2,
    orientations 0-9, BigTIFF; a few files cut short."""
    cv2, assets = cv
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        ph = int(rng.choice([0, 1, 2, 2, 3, 5]))
        bps = int(rng.choice({0: [1, 8, 16, 2, 4], 1: [1, 8, 16, 4], 2: [8, 16],
                              3: [1, 2, 4, 8, 16], 5: [8, 16]}[ph]))
        spp = {0: 1, 1: 1, 3: 1, 2: 3, 5: 4}[ph]
        kw = {}
        if ph in (0, 1) and bps in (8, 16) and rng.random() < 0.3:
            spp, kw["extra"] = 2, [int(rng.integers(0, 3))]
        if ph == 2 and rng.random() < 0.5:
            spp = int(rng.choice([4, 4, 5]))
            if rng.random() < 0.8:
                kw["extra"] = [int(rng.integers(0, 3))] * (spp - 3)
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        s = rng.integers(0, 1 << bps, (h, w, spp))
        if rng.random() < 0.5:
            s = np.repeat(s[:, :1], w, 1)
        if ph == 3:
            kw["colormap"] = rng.integers(0, 65536 if rng.random() < 0.6 else 256, (1 << bps, 3))
        if rng.random() < 0.3:
            kw["tile"] = (16 * int(rng.integers(1, 4)), 16 * int(rng.integers(1, 4)))
        else:
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if bps in (8, 16) and rng.random() < 0.4:
            kw["predictor"] = 2
        if rng.random() < 0.2:
            kw["orientation"] = int(rng.integers(0, 10))
        data = assets.tiff_bytes(s, bps, ph, int(rng.choice([1, 5, 8, 32946, 32773])),
                                 "<>"[int(rng.integers(0, 2))],
                                 planar=2 if spp > 1 and rng.random() < 0.4 else 1,
                                 big=bool(rng.random() < 0.15), **kw)
        if rng.random() < 0.05:
            data = data[:int(rng.integers(8, len(data)))]
        assert_like_cv2(cv2, data, tmp_path, "x.tif")


def test_tiff_conversions_of_libtiffs_rgba_reader(cv, tmp_path):
    """16-bit RGB rounded (v + 128) // 257, 16-bit grey by its high byte,
    min-is-white inverted, unassociated alpha premultiplied, CMYK
    (255 - k)(255 - ink) // 255, a colormap below 256 taken as 8-bit."""
    cv2, assets = cv
    v = np.arange(65536).reshape(256, 256)
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(np.stack([v] * 3, -1), 16, 2, 8), tmp_path)
    np.testing.assert_array_equal(img[..., 0], (v + 128) // 257)
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(v, 16, 0, 8), tmp_path)
    np.testing.assert_array_equal(img[..., 0], 255 - (v >> 8))
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (9, 11, 4))
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(rgba, 8, 2, 5, extra=[2]), tmp_path)
    np.testing.assert_array_equal(img, (rgba[..., :3] * rgba[..., 3:] + 127) // 255)
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(rgba, 8, 5, 5), tmp_path)
    np.testing.assert_array_equal(img, (255 - rgba[..., 3:]) * (255 - rgba[..., :3]) // 255)
    cmap = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (9, 11))
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(idx, 4, 3, 8, colormap=cmap), tmp_path)
    np.testing.assert_array_equal(img, cmap[idx])


def test_tiff_quirks_the_port_copies(cv, tmp_path):
    """Grey tiles clipped at the right edge read with libtiff's byte-count
    skew (16 bits, or grey with alpha); an orientation that mirrors mirrors
    each tile; ``cv2.imread`` refuses a transposing orientation of a
    non-square image, ``cv2.imdecode`` uncompressed tiles of other than a
    multiple of 1024 bytes; Predictor 2 is ignored with no compression and
    PackBits; FillOrder 2 reverses the bits of each byte."""
    cv2, assets = cv
    rng = np.random.default_rng(6)
    g16 = rng.integers(0, 65536, (20, 40))
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(g16, 16, 1, 8, tile=(32, 16)), tmp_path)
    assert (img[1:, 32:, 0] != g16[1:, 32:] >> 8).any()  # not where the samples lie
    np.testing.assert_array_equal(img[:, :32, 0], g16[:, :32] >> 8)
    ga = rng.integers(0, 256, (20, 40, 2))
    assert_like_cv2(cv2, assets.tiff_bytes(ga, 8, 1, 5, tile=(48, 16), extra=[2]), tmp_path)
    rgb = rng.integers(0, 256, (20, 40, 3))
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(rgb, 8, 2, 8, tile=(16, 16), orientation=2),
                             tmp_path)
    np.testing.assert_array_equal(img[:, :16], rgb[:, 15::-1])
    by_file, by_bytes = assert_like_cv2(cv2, assets.tiff_bytes(rgb, 8, 2, 8, orientation=6),
                                        tmp_path)
    assert by_file is None and by_bytes.shape == (40, 20, 3)
    assert_like_cv2(cv2, assets.tiff_bytes(rgb[:20, :20], 8, 2, 8, orientation=6), tmp_path)
    by_file, by_bytes = assert_like_cv2(cv2, assets.tiff_bytes(rgb, 8, 2, 1, tile=(16, 16)),
                                        tmp_path)
    assert by_bytes is None and by_file is not None
    assert all(x is not None for x in assert_like_cv2(
        cv2, assets.tiff_bytes(rgb, 8, 2, 1, tile=(32, 32)), tmp_path))
    for comp in (1, 32773):
        img, _ = assert_like_cv2(cv2, assets.tiff_bytes(rgb, 8, 2, comp, predictor=2), tmp_path)
        assert not np.array_equal(img, rgb)
    img, _ = assert_like_cv2(cv2, assets.tiff_bytes(rgb, 8, 2, 5, fill_order=2), tmp_path)
    np.testing.assert_array_equal(img, rgb)


def test_tiff_refusals_name_what_they_met(cv, tmp_path):
    """What cv2 reads and the port does not raises NotImplementedError
    naming it; what cv2 refuses raises ValueError."""
    import io

    from PIL import Image

    cv2, assets = cv
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)

    def pil(img, mode="RGB", **kw):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "TIFF", **kw)
        return buf.getvalue()

    def relabelled(data, compression):  # the strips stay uncompressed
        return data.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                            b"\x03\x01\x03\x00\x01\x00\x00\x00" + compression.to_bytes(2, "little"))

    data = pil(rgb, compression="jpeg")  # JPEG (7) is read (test_torch_port_tiff_jpeg.py)
    np.testing.assert_array_equal(imageio.decode_image(data), cv2.cvtColor(cv2.imdecode(
        np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    # CCITT (2-4) and YCbCr are read (test_torch_port_fax_tiff.py); signed samples, CIE
    # L*a*b*, old-style LZW and Predictor 2 on subsampled YCbCr too
    # (test_torch_port_tiff_lab.py, test_torch_port_tiff_signed_lzw.py)
    bits = rgb[..., 0] & 1
    cmap = rng.integers(0, 256, (16, 3))
    strips = []
    for k, old in enumerate((True, False)):  # strip 0 old-style, strip 1 not
        data = assets.tiff_bytes(rgb, 8, 2, 5, rows_per_strip=8, old_lzw=old)
        tags, _ = tiff._ifd(data, "x")
        strips.append(data[tags[273][k]:tags[273][k] + tags[279][k]])
    mixed = assets.tiff_file(strips, {256: (4, [24]), 257: (4, [16]), 258: (3, [8, 8, 8]),
                                      259: (3, [5]), 262: (3, [2]), 277: (3, [3]),
                                      278: (4, [8])}, False)
    for data, what in ((relabelled(assets.tiff_bytes(bits, 1, 1, 1), 32771), "CCITT RLEW"),
                       (relabelled(assets.tiff_bytes(rgb[..., 0] >> 4, 4, 3, 1, colormap=cmap),
                                   32809), "ThunderScan"),
                       (relabelled(assets.tiff_bytes(rgb[..., 0], 8, 32844, 1), 34676), "SGI LogL"),
                       (mixed, "old-style \\(LSB-first\\), then not")):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
        with pytest.raises(NotImplementedError, match=what):
            imageio.decode_image(data)
    # cv2 refuses these through both routes, so the port raises ValueError naming them
    path = tmp_path / "x.tif"
    for data, what in ((pil(rgb.astype(np.float32)[..., 0], "F"), "floating point samples"),
                       (pil(rgb.astype(np.float32)[..., 0], "F", compression="tiff_adobe_deflate",
                            tiffinfo={317: 3}), "floating point samples"),
                       (assets.tiff_bytes(rgb, 8, 2, 5, predictor=3), "Predictor 3"),
                       (assets.tiff_bytes(rgb, 8, 9, 1), "ICC L\\*a\\*b\\*"),
                       (assets.tiff_bytes(rgb, 8, 10, 1), "ITU L\\*a\\*b\\*"),
                       (assets.tiff_bytes(rgb, 8, 2, 6), "old-style JPEG \\(6\\)"),
                       (assets.tiff_bytes(rgb, 8, 2, 34925), "LZMA"),
                       (relabelled(assets.tiff_bytes(rgb, 8, 2, 1), 32909), "PixarLog"),
                       (relabelled(assets.tiff_bytes(rgb[..., 0] >> 6, 2, 1, 1), 32766),
                        "NeXT RLE"),
                       (relabelled(assets.tiff_bytes(rgb[..., 0], 8, 1, 1), 34676), "SGI LogL"),
                       (assets.tiff_bytes(rgb, 8, 2, 1, more={339: (3, [4] * 3)}), "untyped"),
                       (assets.tiff_bytes(rgb, 8, 2, 1, more={339: (3, [1, 2, 1])}),
                        "SampleFormat \\[1, 2, 1\\]"),
                       (assets.tiff_bytes(rgb[..., 0], 8, 4, 1), "transparency mask"),
                       (assets.tiff_bytes(rgb[..., 0], 8, 32844, 5), "SGI LogL"),
                       (assets.tiff_bytes(rgb[..., 0], 8, 8, 1), "CIE L\\*a\\*b\\* of 1 samples")):
        path.write_bytes(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
        for read in (lambda: imageio.decode_image(data), lambda: imageio.read_image(str(path))):
            with pytest.raises(ValueError, match=what):
                read()
    for data in (assets.tiff_bytes(rgb[..., 0] >> 6, 2, 1, 1),
                 assets.tiff_bytes(rgb[..., 0] >> 4, 4, 0, 1),
                 assets.tiff_bytes(rgb[..., 0].astype(np.int64) * 257, 16, 3, 1,
                                   colormap=rng.integers(0, 65536, (65536, 3))),
                 assets.tiff_bytes(np.concatenate([rgb, rgb[..., :2]], -1), 8, 2, 5)):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError):
            tiff.decode_tiff(data, from_file=False)


def test_tiff_page_decodes_in_well_under_a_second(cv):
    import time

    cv2, assets = cv
    rng = np.random.default_rng(8)
    page = np.repeat(rng.integers(0, 4, (640, 40, 3)) * 60, 16, 1)
    data = assets.tiff_bytes(page, 8, 2, 5, predictor=2, rows_per_strip=32)
    t0 = time.perf_counter()
    img = imageio.decode_image(data)
    took = time.perf_counter() - t0
    np.testing.assert_array_equal(img, page)
    print(f"640x640 LZW TIFF with Predictor 2: {took * 1e3:.0f} ms on this host")


# ------------------------------------------------------- the JAX datasets
def test_jax_datasets_equal_the_ports_on_a_cut_jpeg_a_gif_and_a_tiff(cv, tmp_path):
    """``RecognitionListDataset`` on a list naming a cut JPEG, a GIF and a
    TIFF, and ``DetectionICDARDataset`` on a page folder of the same three
    (named .jpg and .png, as scraped sets name them: cv2 and the port go by
    the signature): the JAX package's items (cv2) equal the port's bit for
    bit."""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu_torch.data import datasets

    cv2, assets = cv
    rng = np.random.default_rng(9)
    page = assets.smooth(rng, 45, 61)
    jpg = assets.cv_encode(".jpg", page)
    colours, idx = np.unique((page // 64 * 64).reshape(-1, 3), axis=0, return_inverse=True)
    files = {"cut.jpg": assets.cut_in_scan(jpg, 0, 0.6),
             "gif_named.png": assets.gif_bytes([dict(idx=idx.reshape(45, 61))], (45, 61),
                                               colours),
             "tiff_named.jpg": assets.tiff_bytes(page, 8, 2, 5, predictor=2, rows_per_strip=8)}
    pages, gts = tmp_path / "images", tmp_path / "gts"
    pages.mkdir()
    gts.mkdir()
    lines = []
    for i, (name, data) in enumerate(sorted(files.items())):
        (pages / name).write_bytes(data)
        (gts / f"gt_{os.path.splitext(name)[0]}.txt").write_text("3,4,30,4,30,20,3,20,word\n")
        lines.append(f"images/{name}\tword{i}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            elif k == "polygons":
                assert all(np.array_equal(p, q) for p, q in zip(a[k], b[k]))
            else:
                assert a[k] == b[k], k

    ref = jax_datasets.DetectionICDARDataset(str(pages), str(gts), target_hw=(64, 96))
    got = datasets.DetectionICDARDataset(str(pages), str(gts), target_hw=(64, 96))
    assert got.names == ref.names and len(ref) == 3
    pairs = [(ref, got), (jax_datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                              canvas_hw=(48, 128)),
                          datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                          canvas_hw=(48, 128)))]
    for a, b in pairs:
        assert len(a) == len(b) == 3
        for i in range(len(a)):
            same(b[i], a[i])
