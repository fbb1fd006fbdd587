"""The port's CCITT fax (``data/fax.py``) and YCbCr TIFF readers
(``data/tiff.py``) against cv2 5 (libtiff 4.7) bit for bit, through
``read_image`` (``cv2.imread``) and ``decode_image`` (``cv2.imdecode``),
each then ``BGR2RGB``; where cv2 returns None the port raises ``ValueError``.

First the committed files of ``assets/images/`` against their manifest
digests; then the code tables against libtiff's; then seeded files from
``scripts/make_port_image_assets.py``'s writers (libtiff's own encoder,
through PIL, for the CCITT data) against cv2 itself: every coding, option,
photometric interpretation, fill order and layout, damaged strips (libtiff
does not refuse them, and the port copies what it makes of them), every
YCbCr subsampling and compression, libtiff's YCbCr-to-RGB arithmetic on
every byte, and the refusals."""

import hashlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from megreader_tpu_torch.data import fax, imageio, tiff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import check_fax_tables  # noqa: E402
import make_port_image_assets as assets  # noqa: E402

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST
               if os.path.basename(rel).startswith(("fax_", "ycbcr_", "page_g4")))
CODINGS = [(2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)]  # compression, T4Options


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


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


def _page(rng, h, w):
    """A bilevel page: blocks and strokes of 1 (black runs) on 0."""
    bits = np.zeros((h, w), np.uint8)
    for _ in range(max(1, h * w // 150)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        bits[y:y + rng.integers(1, 6), x:x + rng.integers(1, 40)] = 1
    return bits


# ------------------------------------------------------- the committed files
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


def test_committed_files_cover_every_coding_and_subsampling():
    names = " ".join(FILES)
    for part in ("fax_mh", "fax_g3_1d", "fax_g3_2d_fill", "fax_g4_7x13", "fax_g4_cut",
                 "fill_order2", "tiles", "damaged", "pages/page_g4.tif"):
        assert part in names, part
    assert {re.search(r"ycbcr_(\d\d)_", n).group(1) for n in FILES
            if re.search(r"ycbcr_\d\d_", n)} == {"11", "21", "22", "41", "42", "44", "12"}


def test_g4_page_decodes_in_its_digest_and_its_time_is_printed():
    import time

    rel = "pages/page_g4.tif"
    with open(os.path.join(ASSETS, rel), "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    img = imageio.decode_image(data, rel)
    took = time.perf_counter() - t0
    assert _sha(img) == MANIFEST[rel]["sha256"] and img.shape == (640, 640, 3)
    print(f"640x640 CCITT Group 4 page of {len(data)} bytes: {took * 1e3:.0f} ms on this host")


# --------------------------------------------------------------- the tables
def test_code_tables_are_libtiffs():
    """The port's code lists, laid out as libtiff's three decoding tables,
    are found byte for byte in the libtiff that PIL's encoder loaded."""
    assets.fax_strip(np.ones((1, 8), np.uint8), 4)  # loads libtiff
    with open("/proc/self/maps") as f:
        libs = sorted({line.split()[-1] for line in f if "libtiff" in line.split()[-1]})
    assert libs
    with open(libs[0], "rb") as f:
        lib = f.read()
    for name, table in check_fax_tables.tables().items():
        assert lib.find(table) >= 0, name


@pytest.mark.parametrize("black", [False, True])
def test_every_run_length_decodes_as_libtiff_encodes_it(black):
    """Rows of one run of every length 0..2560 (terminating, make-up and
    shared make-up codes), the other colour around it, through libtiff's
    modified Huffman and T.6 encoders."""
    n = np.arange(2561)
    width = 2600
    col = np.arange(width)
    start = 1 if black else 0  # a black run needs a white run before it
    bits = ((col >= start) & (col < start + n[:, None])).astype(np.uint8)
    if not black:
        bits = (col >= n[:, None]).astype(np.uint8)
    for comp in (2, 4):
        data = assets.fax_tiff(bits, comp, photometric=0)
        img = tiff.decode_tiff(data, from_file=False)
        np.testing.assert_array_equal(img[..., 0] == 0, bits.astype(bool))


# ------------------------------------------------------- clean files vs cv2
@pytest.mark.parametrize("compression,options", CODINGS)
@pytest.mark.parametrize("photometric,fill_order", [(0, 1), (1, 2)])
def test_fax_files_equal_cv2_and_the_page(compression, options, photometric, fill_order,
                                          tmp_path):
    rng = np.random.default_rng(compression * 10 + options + photometric)
    for (h, w), rows in (((1, 1), None), ((7, 13), 3), ((37, 100), None), ((20, 1800), 7)):
        bits = _page(rng, h, w)
        data = assets.fax_tiff(bits, compression, options, photometric, fill_order,
                               rows_per_strip=rows, order="<>"[h % 2])
        img, _ = assert_like_cv2(data, tmp_path)
        np.testing.assert_array_equal(img[..., 0] == 255, bits.astype(bool) == bool(photometric))


def test_fax_tiles_and_palettes_equal_cv2(tmp_path):
    rng = np.random.default_rng(2)
    bits = _page(rng, 37, 100)
    for comp, options in CODINGS:
        img, _ = assert_like_cv2(assets.fax_tiff(bits, comp, options, tile=(32, 16)), tmp_path)
        np.testing.assert_array_equal(img[..., 0] == 0, bits.astype(bool))
    cmap = np.array([[10, 200, 30], [250, 20, 120]])
    img, _ = assert_like_cv2(assets.fax_tiff(bits, 4, photometric=3, colormap=cmap), tmp_path)
    np.testing.assert_array_equal(img, cmap[bits])
    # T4Options' uncompressed-mode bit changes nothing libtiff reads
    for comp, options in ((3, 2), (3, 3)):
        assert_like_cv2(assets.fax_tiff(bits, comp, options), tmp_path)


# ----------------------------------------------------------- damaged strips
def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _run_codes(runs):
    """1-D codes of ``runs`` (white first): make-up codes, then terminating."""
    out, white = "", True
    for r in runs:
        term, makeup = ((fax.WHITE_CODES, fax.WHITE_MAKEUP) if white
                        else (fax.BLACK_CODES, fax.BLACK_MAKEUP))
        while r >= 64:
            m = min(r // 64, 27)
            out += makeup[m - 1]
            r -= 64 * m
        out += term[r]
        white = not white
    return out


EOL = "000000000001"


def _hand(rows, eols=True, tags=False):
    """T.4 data by hand: each row's runs, after an EOL (and a 1-D tag bit)."""
    return _bits_to_bytes("".join((EOL if eols else "") + ("1" if tags else "") + _run_codes(r)
                                  for r in rows))


DAMAGE = ["cut_half", "cut_tail", "zero_tail", "zero_from_half", "bad_code_mid_row",
          "garbage_after", "bit_flips", "byte_junk"]


@pytest.mark.parametrize("compression,options", CODINGS)
@pytest.mark.parametrize("damage", DAMAGE)
def test_damaged_strips_read_as_libtiff_recovers_them(compression, options, damage, tmp_path):
    """libtiff reports a bad or missing code and fills in the rest of the
    row (and of the strip at the end of the data); cv2 returns what it
    made, and so does the port."""
    rng = np.random.default_rng(DAMAGE.index(damage) * 7 + compression + options)
    bits = _page(rng, 37, 100)
    strip = bytearray(assets.fax_strip(bits, compression, options))
    n = len(strip)
    if damage == "cut_half":
        strip = strip[:n // 2]
    elif damage == "cut_tail":
        strip = strip[:n - 3]
    elif damage == "zero_tail":
        strip[n - 5:] = bytes(5)
    elif damage == "zero_from_half":
        strip[n // 2:] = bytes(n - n // 2)
    elif damage == "bad_code_mid_row":
        strip[n // 2] ^= 0x10
    elif damage == "garbage_after":
        strip += rng.integers(0, 256, 20).astype(np.uint8).tobytes()
    elif damage == "bit_flips":
        for at in rng.integers(0, n, 3):
            strip[at] ^= 1 << int(rng.integers(0, 8))
    else:
        at = int(rng.integers(0, n - 4))
        strip[at:at + 4] = rng.integers(0, 256, 4).astype(np.uint8).tobytes()
    for chunks in ([bytes(strip)], [bytes(strip), assets.fax_strip(bits[:9], compression,
                                                                   options)]):
        page = bits if len(chunks) == 1 else np.concatenate([bits, bits[:9]])
        data = assets.fax_tiff(page, compression, options, rows_per_strip=37, chunks=chunks)
        img, _ = assert_like_cv2(data, tmp_path)
        assert img is not None


@pytest.mark.parametrize("case", ["no_eols", "first_eol_missing", "last_eol_missing", "rtc",
                                  "row_too_long", "row_too_short", "empty_row",
                                  "no_eols_2d", "eol_at_the_very_end", "eofb_then_junk"])
def test_eols_and_row_lengths_as_libtiff_reads_them(case, tmp_path):
    """T.4 rows are read after an EOL; where a search for one runs out of
    data after its 11 zero bits, libtiff starts the strip again and reads
    it without EOLs, for the rest of the image; a row too long is cut back
    to the runs that fit, a short one filled with white; T.6 stops at an
    EOFB."""
    r = [[2, 6, 5], [4, 4, 5], [6, 2, 5], [1, 7, 5], [0, 13]]
    comp, options, rows = 3, 0, 5
    if case == "no_eols":
        data = _hand(r, eols=False)
    elif case == "first_eol_missing":
        data = _bits_to_bytes(_run_codes(r[0]) + "".join(EOL + _run_codes(x) for x in r[1:]))
    elif case == "last_eol_missing":
        data = _bits_to_bytes("".join(EOL + _run_codes(x) for x in r[:-1]) + _run_codes(r[-1]))
    elif case == "rtc":
        data = _bits_to_bytes("".join(EOL + _run_codes(x) for x in r[:2]) + EOL * 6)
    elif case == "row_too_long":
        data = _hand([r[0], [2, 20, 3], r[2], [40], r[4]])
    elif case == "row_too_short":
        data = _hand([r[0], [2, 3], r[2], [], r[4]])
    elif case == "empty_row":
        data = _bits_to_bytes(EOL + _run_codes(r[0]) + EOL + EOL + _run_codes(r[1]))
    elif case == "no_eols_2d":
        comp, options = 3, 1
        data = _hand(r, eols=False, tags=True)
    elif case == "eol_at_the_very_end":
        comp, options = 3, 1
        data = _bits_to_bytes("0" + EOL + "1" + _run_codes([5, 3, 5]) + EOL)
    else:
        comp = 4
        data = assets.fax_strip(_page(np.random.default_rng(3), 5, 13)[:3], 4)
        data += _bits_to_bytes(EOL + EOL + "1010")
    bits = np.zeros((rows, 13), np.uint8)
    assert_like_cv2(assets.fax_tiff(bits, comp, options, chunks=[data]), tmp_path)


def test_seeded_corruptions_equal_cv2():
    """Random damage of every coding, several strips of one image (libtiff
    keeps its run arrays and its no-EOL mode from strip to strip)."""
    rng = np.random.default_rng(77)
    for trial in range(150):
        comp, options = CODINGS[trial % len(CODINGS)]
        h, w = int(rng.integers(2, 30)), int(rng.choice([5, 13, 64, 100, 333]))
        rows = int(rng.integers(1, h + 1))
        bits = _page(rng, h, w)
        chunks = [bytearray(assets.fax_strip(bits[y:y + rows], comp, options))
                  for y in range(0, h, rows)]
        for _ in range(int(rng.integers(1, 4))):
            c = chunks[int(rng.integers(0, len(chunks)))]
            at = int(rng.integers(0, len(c)))
            kind = int(rng.integers(0, 4))
            if kind == 0:
                c[at] ^= 1 << int(rng.integers(0, 8))
            elif kind == 1:
                del c[at + 1:]
            elif kind == 2:
                c[at:at + 3] = bytes(len(c[at:at + 3]))
            else:
                c[at:at + 2] = rng.integers(0, 256, 2).astype(np.uint8).tobytes()
        data = assets.fax_tiff(bits, comp, options, rows_per_strip=rows,
                               chunks=[bytes(c) or b"\0" for c in chunks])
        want = _cv2(data)
        np.testing.assert_array_equal(imageio.decode_image(data), want, err_msg=str(trial))


def test_fax_refusals():
    bits = _page(np.random.default_rng(4), 7, 13)
    data = assets.tiff_file([assets.fax_strip(bits, 4)], {
        256: (4, [13]), 257: (4, [7]), 258: (3, [8]), 259: (3, [4]), 262: (3, [0]),
        277: (3, [1]), 278: (4, [7])}, False)
    assert _cv2(data) is None
    with pytest.raises(ValueError, match="CCITT-compressed TIFF of 8 bits"):
        imageio.decode_image(data)


# --------------------------------------------------------------------- YCbCr
SAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)]


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_ycbcr_every_subsampling_and_compression_equals_cv2(sampling, compression, tmp_path):
    rng = np.random.default_rng(sampling[0] * 10 + sampling[1] + compression)
    for (h, w), rows, order in (((1, 1), None, "<"), ((7, 13), 5, ">"), ((33, 50), 7, "<"),
                                ((18, 21), None, ">")):
        ycc = assets.smooth(rng, h, w)
        img, _ = assert_like_cv2(assets.ycbcr_tiff(ycc, sampling, compression, rows, order=order),
                                 tmp_path)
        assert img.shape == (h, w, 3)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_ycbcr_tiles_positioning_and_orientation_equal_cv2(sampling, tmp_path):
    """Tiles clipped at the right and bottom edges (libtiff's 4x4 tile
    routine skips the units past the edge as 10 bytes each), a missing
    YCbCrSubsampling tag (2x2), YCbCrPositioning 2 (ignored) and each
    orientation."""
    rng = np.random.default_rng(sampling[0] * 10 + sampling[1])
    ycc = assets.smooth(rng, 37, 45)
    for tile in ((16, 16), (32, 16), (16, 48)):
        assert_like_cv2(assets.ycbcr_tiff(ycc, sampling, 5, tile=tile), tmp_path)
    assert_like_cv2(assets.ycbcr_tiff(ycc, sampling, 8, fields={531: (3, [2])}), tmp_path)
    for orientation in range(2, 9):
        assert_like_cv2(assets.ycbcr_tiff(ycc[:20, :20], sampling, 1,
                                          fields={274: (3, [orientation])}), tmp_path)
    assert_like_cv2(assets.ycbcr_tiff(ycc[:5, :9], sampling, 1, tile=(16, 16)), tmp_path)


def test_ycbcr_layouts_libtiff_reads_differently(tmp_path):
    """No YCbCrSubsampling tag: 2x2; separate planes and Predictor 2 at 1x1
    as RGB's; a 4x4 strip of an odd number of units a row loses its last
    bytes (read as zero)."""
    rng = np.random.default_rng(5)
    ycc = assets.smooth(rng, 13, 17)
    a, _ = assert_like_cv2(assets.ycbcr_tiff(ycc, (2, 2), 5, subsampling_tag=False), tmp_path)
    b, _ = assert_like_cv2(assets.ycbcr_tiff(ycc, (2, 2), 5), tmp_path)
    np.testing.assert_array_equal(a, b)
    assert_like_cv2(assets.ycbcr_tiff(ycc, (1, 1), 32773, rows_per_strip=4, planar=2), tmp_path)
    assert_like_cv2(assets.ycbcr_tiff(ycc, (1, 1), 5, fields={317: (3, [2])}), tmp_path)
    for w in (1, 3, 5, 9):  # 1 or 3 units of 4x4 a row
        assert_like_cv2(assets.ycbcr_tiff(ycc[:, :w], (4, 4), 1, rows_per_strip=8), tmp_path)


@pytest.mark.parametrize("pair", ["y_cr", "y_cb", "cb_cr"])
def test_ycbcr_to_rgb_is_libtiffs_on_every_byte(pair, tmp_path):
    """Every Y with every Cr (or Cb), and every Cb with every Cr, at three
    values of the third: libtiff's float32 tables and 16-bit fixed point."""
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for third in (0, 128, 255):
        c = np.full_like(a, third)
        ycc = {"y_cr": (a, c, b), "y_cb": (a, b, c), "cb_cr": (c, a, b)}[pair]
        assert_like_cv2(assets.ycbcr_tiff(np.stack(ycc, -1), (1, 1), 8), tmp_path, ("bytes",))


@pytest.mark.parametrize("fields", [
    {529: (5, [2990, 10000, 5870, 10000, 1140, 10000])},
    {529: (5, [2126, 10000, 7152, 10000, 722, 10000])},
    {529: (5, [1, 3, 1, 3, 1, 3])},
    {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
    {532: (5, [15, 2, 471, 2, 257, 2, 511, 2, 255, 2, 509, 2])},
    {532: (5, [10, 1, 5, 1, 128, 1, 255, 1, 128, 1, 255, 1])},
    {529: (5, [77, 255, 150, 255, 28, 255]), 532: (5, [0, 1, 0, 1, 128, 1, 128, 1, 0, 1, 0, 1])},
])
def test_ycbcr_coefficients_and_reference_range_equal_cv2(fields, tmp_path):
    ycc = np.random.default_rng(6).integers(0, 256, (16, 64, 3))
    assert_like_cv2(assets.ycbcr_tiff(ycc, (2, 1), 5, fields=fields), tmp_path)


def test_pil_ycbcr_files_equal_cv2(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(7)
    for h, w in ((1, 1), (7, 13), (33, 50)):
        rgb = assets.smooth(rng, h, w)
        for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            buf = io.BytesIO()
            Image.fromarray(rgb).convert("YCbCr").save(buf, "TIFF", compression=comp)
            img, _ = assert_like_cv2(buf.getvalue(), tmp_path)
            assert np.abs(img.astype(int) - rgb).max() <= 3


def test_ycbcr_refusals(tmp_path):
    rng = np.random.default_rng(8)
    ycc = assets.smooth(rng, 9, 12)
    for data in (assets.ycbcr_tiff(ycc, (1, 4), 1), assets.ycbcr_tiff(ycc, (3, 1), 1),
                 assets.ycbcr_tiff(ycc, (2, 2), 1, planar=2),
                 assets.ycbcr_tiff(ycc, (2, 2), 1, fields={258: (3, [16, 16, 16])}),
                 assets.ycbcr_tiff(ycc, (2, 2), 1, fields={529: (5, [1, 2, 0, 1, 1, 2])})):
        assert assert_like_cv2(data, tmp_path) == [None, None]
    # Predictor 2 on subsampled YCbCr is read (test_torch_port_tiff_signed_lzw.py); the
    # floating point Predictor 3 is refused there too
    data = assets.ycbcr_tiff(ycc, (2, 2), 5, fields={317: (3, [2])})
    assert assert_like_cv2(data, tmp_path)[0] is not None
    data = assets.ycbcr_tiff(ycc, (2, 2), 5, fields={317: (3, [3])})
    assert assert_like_cv2(data, tmp_path) == [None, None]
    with pytest.raises(ValueError, match="Predictor 3"):
        imageio.decode_image(data)
