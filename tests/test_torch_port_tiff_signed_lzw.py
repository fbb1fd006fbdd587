"""The port's TIFF reader (``data/tiff.py``) against cv2 5 (libtiff 4.7) bit
for bit, through ``read_image`` (``cv2.imread``) and ``decode_image``
(``cv2.imdecode``), each then ``BGR2RGB``, where cv2 returns None the port
raising ``ValueError``, on:

* signed samples (SampleFormat 2): every photometric cv2 reads, at 1, 4,
  8 and 16 bits, alpha, separate planes, tiles, every compression and
  Predictor 2, YCbCr and JPEG; each equal to the same file unsigned;
  per-sample tags libtiff refuses (values that differ, too few);
* old-style (least significant bit first) LZW from the asset script's
  ``tiff_lzw_old_style``, which counts only where cv2 decodes it to its
  source: every code width and resets at each, strips, tiles, Predictor 2,
  FillOrder 2, a table left to fill, streams cut short;
* Predictor 2 on subsampled YCbCr, its strips and tiles also equal to
  ``TIFFReadEncodedStrip`` / ``TIFFReadEncodedTile``'s bytes (PIL's libtiff
  through ``ctypes``: ``scripts/libtiff_ctypes.py``);
* strips and tiles whose data ends or breaks early (each codec's partial
  output equal to libtiff's), byte counts libtiff replaces, and
  compressions libtiff has no codec for."""

import os
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from megreader_tpu_torch.data import imageio, tiff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import libtiff_ctypes as lt  # noqa: E402
import make_port_image_assets as assets  # noqa: E402


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


def _signed(n):
    return {339: (3, [2] * n)}


@pytest.fixture(scope="module")
def lib():
    return lt.library()


# ------------------------------------------------------------ signed samples
#: photometric, bits, samples, options of ``tiff_bytes``
SIGNED = {
    "grey1": (1, 1, 1, {}), "white1": (0, 1, 1, {}), "grey8": (1, 8, 1, {}),
    "white8": (0, 8, 1, {}), "grey16": (1, 16, 1, {}), "white16": (0, 16, 1, {}),
    "grey_alpha8": (1, 8, 2, dict(extra=[2])), "grey_alpha16_planar": (1, 16, 2, dict(
        extra=[2], planar=2)), "rgb8": (2, 8, 3, {}), "rgb16": (2, 16, 3, {}),
    "rgba8": (2, 8, 4, dict(extra=[2])), "rgba16_associated": (2, 16, 4, dict(extra=[1])),
    "rgb8_planar": (2, 8, 3, dict(planar=2)), "palette1": (3, 1, 1, {}),
    "palette4": (3, 4, 1, {}), "palette8": (3, 8, 1, {}), "cmyk8": (5, 8, 4, {}),
}


@pytest.mark.parametrize("name", sorted(SIGNED))
def test_signed_samples_read_as_unsigned_like_cv2(name, tmp_path):
    """SampleFormat 2 at every photometric, depth and layout cv2 reads:
    equal to cv2 and to the same file without the tag (libtiff's RGBA
    reader ignores the sign), strips and tiles, every compression (Predictor
    2 where it applies), both byte orders."""
    ph, bps, spp, kw = SIGNED[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    s = rng.integers(0, 1 << bps, (21, 37, spp))
    if ph == 3:
        kw = dict(kw, colormap=rng.integers(0, 65536 if bps == 8 else 256, (1 << bps, 3)))
    for i, comp in enumerate((1, 5, 8, 32773)):
        layout = dict(tile=(16, 16)) if i % 2 else dict(rows_per_strip=6)
        if comp in (5, 8) and bps in (8, 16):
            layout["predictor"] = 2
        order = "<>"[i % 2]
        signed = assets.tiff_bytes(s, bps, ph, comp, order, more=_signed(spp), **kw, **layout)
        plain = assets.tiff_bytes(s, bps, ph, comp, order, **kw, **layout)
        got = assert_like_cv2(signed, tmp_path)
        assert got[0] is not None
        for a, b in zip(got, assert_like_cv2(plain, tmp_path)):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_signed_ycbcr_and_jpeg_equal_cv2(tmp_path):
    """Signed YCbCr (1x1 and subsampled) and PIL's JPEG-compressed grey, RGB
    and YCbCr with SampleFormat 2 read as their unsigned selves."""
    import io

    from PIL import Image

    rng = np.random.default_rng(1)
    ycc = assets.smooth(rng, 13, 17)
    for sampling in ((1, 1), (2, 2), (4, 2)):
        signed = assets.ycbcr_tiff(ycc, sampling, 5, fields=_signed(3))
        a = assert_like_cv2(signed, tmp_path)[0]
        np.testing.assert_array_equal(a, assert_like_cv2(assets.ycbcr_tiff(ycc, sampling, 5),
                                                         tmp_path)[0])
    for mode in ("L", "RGB", "YCbCr"):
        img = Image.fromarray(assets.smooth(rng, 24, 40)).convert(mode)
        out = []
        for info in ({339: 2}, {}):
            buf = io.BytesIO()
            img.save(buf, "TIFF", compression="jpeg", tiffinfo=info)
            out.append(assert_like_cv2(buf.getvalue(), tmp_path)[0])
        np.testing.assert_array_equal(*out)


def test_sample_format_and_depth_refusals(tmp_path):
    """cv2 returns None on signed 32-bit grey, on SampleFormat 4-6, 0 and 7,
    and on BitsPerSample or SampleFormat values that differ from sample to
    sample or are fewer than the samples (libtiff's directory reader fails):
    the port raises ValueError. A value a sample past the samples is
    ignored, as libtiff ignores it."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (6, 9, 3))
    grey32 = assets.tiff_file([rng.integers(0, 256, 6 * 9 * 4).astype(np.uint8).tobytes()], {
        256: (4, [9]), 257: (4, [6]), 258: (3, [32]), 259: (3, [1]), 262: (3, [1]),
        277: (3, [1]), 278: (4, [6]), 339: (3, [2])}, False)
    refused = [grey32] + [assets.tiff_bytes(rgb, 8, 2, 1, more={339: (3, v)}) for v in (
        [4] * 3, [5] * 3, [6] * 3, [0], [7, 7, 7], [1, 2, 1], [2, 1, 1], [2, 2], [1, 1])]
    refused += [assets.tiff_bytes(rgb, 8, 2, 1, more={258: (3, v)}) for v in (
        [8, 8], [8, 16, 8], [16, 8, 8])]
    refused.append(assets.tiff_bytes(rgb[..., 0], 16, 3, 1, more=_signed(1),
                                     colormap=rng.integers(0, 65536, (65536, 3))))
    for data in refused:
        assert assert_like_cv2(data, tmp_path) == [None, None]
    img = assert_like_cv2(assets.tiff_bytes(rgb, 8, 2, 1, more={339: (3, [2, 2, 2, 1])}),
                          tmp_path)[0]
    np.testing.assert_array_equal(img, rgb)


# --------------------------------------------------------- old-style LZW
def _lzw_tiff(img, **options):
    """An RGB TIFF of one old-style LZW strip, ``options`` to
    ``tiff_lzw_old_style``."""
    h, w, _ = img.shape
    strip = assets.tiff_lzw_old_style(img.astype(np.uint8).tobytes(), **options)
    return assets.tiff_file([strip], {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3),
                                      259: (3, [5]), 262: (3, [2]), 277: (3, [3]),
                                      278: (4, [h])}, False)


def _valid(data, img):
    """A file of the writer counts only where cv2 decodes it to its source."""
    np.testing.assert_array_equal(_cv2(data), img)


@pytest.mark.parametrize("clear_after", [0, 1, 253, 254, 255, 766, 767, 1790, 1791, 3837, 3839])
def test_old_style_lzw_every_code_width_and_reset_equals_cv2(clear_after, tmp_path):
    """Random bytes (few repeats) run the table through 9, 10, 11 and 12
    bits; a clear code after ``clear_after`` codes lands just before, at and
    after each widening."""
    rng = np.random.default_rng(clear_after)
    img = rng.integers(0, 256, (60, 100, 3))
    data = _lzw_tiff(img, clear_after=clear_after)
    _valid(data, img)
    got = assert_like_cv2(data, tmp_path)
    np.testing.assert_array_equal(got[1], img)


def test_old_style_lzw_layouts_equal_cv2(tmp_path):
    """Strips, tiles, Predictor 2 (8 and 16 bits), FillOrder 2, big-endian,
    grey and palette, smooth and random pages."""
    rng = np.random.default_rng(3)
    page = assets.smooth(rng, 70, 90)
    noise = rng.integers(0, 256, (40, 50, 3))
    for img, kw in ((page, {}), (page, dict(rows_per_strip=9)), (page, dict(tile=(32, 48))),
                    (page, dict(predictor=2)), (noise, dict(fill_order=2)),
                    (noise, dict(order=">", rows_per_strip=7, predictor=2)),
                    (noise[:1, :1], {})):
        data = assets.tiff_bytes(img, 8, 2, 5, old_lzw=True, **kw)
        _valid(data, img)
        assert_like_cv2(data, tmp_path)
    g16 = rng.integers(0, 65536, (20, 30))
    data = assets.tiff_bytes(g16, 16, 1, 5, predictor=2, old_lzw=True)
    np.testing.assert_array_equal(assert_like_cv2(data, tmp_path)[1][..., 0], g16 >> 8)
    idx = rng.integers(0, 16, (20, 30))
    cmap = rng.integers(0, 256, (16, 3))
    data = assets.tiff_bytes(idx, 4, 3, 5, colormap=cmap, old_lzw=True)
    np.testing.assert_array_equal(assert_like_cv2(data, tmp_path)[1], cmap[idx])


def test_old_and_new_style_strips_in_one_image(tmp_path):
    """libtiff decodes every strip as it decoded the first: old-style strips
    after a new-style first one are read most significant bit first (cv2
    gets what that makes of them); a new-style strip after an old-style
    first one is refused by name; a strip of one byte reads as zeros."""
    rng = np.random.default_rng(6)
    img = assets.smooth(rng, 24, 30)
    fields = {256: (4, [30]), 257: (4, [24]), 258: (3, [8] * 3), 259: (3, [5]), 262: (3, [2]),
              277: (3, [3]), 278: (4, [8])}
    raw = [img[y:y + 8].astype(np.uint8).tobytes() for y in range(0, 24, 8)]
    new, old = assets.tiff_lzw, assets.tiff_lzw_old_style
    for styles in ((new, old, old), (new, new, old), (new, old, new)):
        strips = [f(r) for f, r in zip(styles, raw)]
        got = assert_like_cv2(assets.tiff_file(strips, fields, False), tmp_path)[1]
        np.testing.assert_array_equal(got[:8], img[:8])
        strips[0] = strips[0][:1]
        assert_like_cv2(assets.tiff_file(strips, fields, False), tmp_path)
    strips = [old(r) for r in raw]
    strips[2] = strips[2][:1]
    got = assert_like_cv2(assets.tiff_file(strips, fields, False), tmp_path)[1]
    assert (got[16:] == 0).all() and np.array_equal(got[:16], img[:16])
    data = assets.tiff_file([old(raw[0]), new(raw[1]), old(raw[2])], fields, False)
    assert _cv2(data) is not None
    with pytest.raises(NotImplementedError, match="old-style \\(LSB-first\\), then not"):
        imageio.decode_image(data)


def test_old_style_lzw_cut_and_overfull_streams_equal_cv2(tmp_path):
    """Streams without their EOI, cut short (cv2 reads what libtiff
    decoded, zeros after it, the predictor not undone) and a table left to
    fill past 4096 entries (libtiff's old-style decoder stops at 5119)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (60, 100, 3))
    data = _lzw_tiff(img, eoi=False)
    _valid(data, img)
    assert_like_cv2(data, tmp_path)
    full = _lzw_tiff(img, clear_when_full=False)
    got = assert_like_cv2(full, tmp_path)[1]
    assert not np.array_equal(got, img) and np.array_equal(got.reshape(-1)[:4000],
                                                           img.reshape(-1)[:4000])
    for cut in (0.3, 0.7, 0.999):
        for predictor in (1, 2):
            data = assets.tiff_bytes(img, 8, 2, 5, rows_per_strip=20, predictor=predictor,
                                     old_lzw=True)
            tags, _ = tiff._ifd(data, "x")
            chunks = [data[o:o + n] for o, n in zip(tags[273], tags[279])]
            chunks[1] = chunks[1][:int(len(chunks[1]) * cut)]
            fields = {256: (4, [100]), 257: (4, [60]), 258: (3, [8] * 3), 259: (3, [5]),
                      262: (3, [2]), 277: (3, [3]), 278: (4, [20]), 317: (3, [predictor])}
            got = assert_like_cv2(assets.tiff_file(chunks, fields, False), tmp_path)[1]
            np.testing.assert_array_equal(got[:20], img[:20])


# ------------------------------------------------- partial decodes, libtiff's
CODECS = {"lzw": 5, "old_lzw": 5, "deflate": 8, "packbits": 32773}


def _encode(name, raw, rng):
    if name == "lzw":
        return assets.tiff_lzw(raw)
    if name == "old_lzw":
        return assets.tiff_lzw_old_style(raw, clear_when_full=bool(rng.random() < 0.7))
    return zlib.compress(raw, 6) if name == "deflate" else assets.packbits(raw)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_damaged_strips_decode_as_libtiffs(name, lib):
    """Each codec's output on seeded streams cut, bit-flipped or overwritten
    equals libtiff's ``TIFFReadEncodedStrip`` in a zeroed buffer byte for
    byte: what was decoded before the data ended or broke, zeros after."""
    comp = CODECS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    for trial in range(60):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 60))
        img = (rng.integers(0, 256, (h, w)) if trial % 2
               else assets.smooth(rng, h, w, 1)[..., 0]).astype(np.uint8)
        c = bytearray(_encode(name, img.tobytes(), rng))
        kind = trial % 4
        if kind == 0:
            c = c[:int(rng.integers(1, len(c) + 1))]
        elif kind == 1:
            for _ in range(int(rng.integers(1, 4))):
                c[int(rng.integers(0, len(c)))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            at = int(rng.integers(0, len(c)))
            c[at:at + 5] = rng.integers(0, 256, 5).astype(np.uint8).tobytes()
        if name == "old_lzw" and len(c) >= 2:  # keep its first code a clear code
            c[0], c[1] = 0, c[1] | 1
        c = bytes(c)
        data = assets.tiff_file([c], {256: (4, [w]), 257: (4, [h]), 258: (3, [8]),
                                      259: (3, [comp]), 262: (3, [1]), 277: (3, [1]),
                                      278: (4, [h])}, False)
        want = lt.read_encoded(lib, data, [h * w])[0]
        got = tiff._decoder(comp, c)(c, h * w, "x")
        assert got.ljust(h * w, b"\0") == want, (name, trial)


@pytest.mark.parametrize("shape", [(32, 32), (32, 64), (64, 64), (64, 96)])
def test_uncompressed_tile_counts_as_each_route_takes_them(shape, tmp_path):
    """Uncompressed 32x32 tiles, each in turn cut short or given more bytes
    than a tile: ``cv2.imread`` refuses any count but a tile's,
    ``cv2.imdecode`` a larger one or a first tile short by 1024 bytes or
    more, and reads a shorter tile as zeros; with more than two tiles whose
    first two counts differ, libtiff takes a tile's size for every count."""
    rng = np.random.default_rng(shape[0] + shape[1])
    rgb = rng.integers(0, 256, shape + (3,))
    data = assets.tiff_bytes(rgb, 8, 2, 1, tile=(32, 32))
    tags, _ = tiff._ifd(data, "x")
    fields = {t: (4 if t in (256, 257) else 3, v) for t, v in tags.items() if t not in (324, 325)}
    for k in range(len(tags[324])):
        for delta in (-1, -500, -1023, -1024, -2500, 1, 1024):
            chunks = [data[o:o + n] for o, n in zip(tags[324], tags[325])]
            chunks[k] = chunks[k][:delta] if delta < 0 else chunks[k] + bytes(delta)
            assert_like_cv2(assets.tiff_file(chunks, fields, True), tmp_path)


def test_short_counts_and_unknown_compressions_equal_cv2(tmp_path):
    """A strip or tile whose byte count is short: compressed, what its
    codec decoded; uncompressed, zeros (or, with more than two contiguous
    chunks whose first two counts differ, or a single strip, the counts
    libtiff estimates from the image); a count of 0 or past the file's end
    is refused. A compression libtiff has no codec for reads as zero
    samples."""
    rng = np.random.default_rng(5)
    rgb = assets.smooth(rng, 20, 30)

    def recut(data, tiled, fn):
        tags, _ = tiff._ifd(data, "x")
        off, cnt = (tags[324], tags[325]) if tiled else (tags[273], tags[279])
        chunks = fn([data[o:o + n] for o, n in zip(off, cnt)])
        fields = {t: (4 if t in (256, 257, 278) else 3, v) for t, v in tags.items()
                  if t not in (273, 279, 324, 325)}
        return assets.tiff_file(chunks, fields, tiled)

    cuts = (lambda ch: [ch[0][:len(ch[0]) // 2]] + ch[1:], lambda ch: [ch[0][:1]] + ch[1:],
            lambda ch: [b""] + ch[1:], lambda ch: ch[:-1] + [ch[-1][:-1]])
    for comp in (1, 5, 8, 32773):
        for layout in (dict(rows_per_strip=7), dict(rows_per_strip=10), dict(tile=(16, 16)), {}):
            for predictor in ((1, 2) if comp in (5, 8) else (1,)):
                data = assets.tiff_bytes(rgb, 8, 2, comp, predictor=predictor, **layout)
                for cut in cuts:
                    assert_like_cv2(recut(data, "tile" in layout, cut), tmp_path)
    data = bytearray(assets.tiff_bytes(rgb, 8, 2, 5, rows_per_strip=7))
    tags, _ = tiff._ifd(bytes(data), "x")
    at = data.index(np.array(tags[279], "<u4").tobytes())  # the counts, out of line
    data[at + 8:at + 12] = np.array([tags[279][2] + 10_000], "<u4").tobytes()
    assert assert_like_cv2(bytes(data), tmp_path) == [None, None]
    for comp in (9, 10, 34712, 50002, 7777):
        for ph, s, bps, kw in ((2, rgb, 8, {}), (0, rgb[..., 0], 8, {}),
                               (1, rgb[..., 0], 16, dict(tile=(16, 16))),
                               (3, rgb[..., 0] % 16, 4, dict(colormap=rng.integers(0, 256,
                                                                                   (16, 3)))),
                               (8, rgb, 8, {})):
            data = assets.tiff_bytes(s, bps, ph, 1, **kw).replace(
                b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                b"\x03\x01\x03\x00\x01\x00\x00\x00" + comp.to_bytes(2, "little"))
            assert assert_like_cv2(data, tmp_path)[1] is not None
        assert_like_cv2(assets.ycbcr_tiff(rgb, (2, 2), comp), tmp_path)


# ------------------------------------------- Predictor 2 on subsampled YCbCr
SAMPLINGS = [(2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)]


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_ycbcr_predictor_strips_and_tiles_are_libtiffs(sampling, lib, tmp_path):
    """The port's undone strips equal ``TIFFReadEncodedStrip``'s bytes (rows
    of ``TIFFScanlineSize``, 3-byte samples, left as decoded where a row
    does not divide into them) and its tiles ``TIFFReadEncodedTile``'s (rows
    of the tile's width times 3); the images equal cv2's through both
    routes."""
    hs, vs = sampling
    unit = hs * vs + 2
    rng = np.random.default_rng(hs * 10 + vs)
    for (h, w), rows in (((7, 13), 5), ((16, 10), None), ((19, 23), 8), ((5, 1), None)):
        ycc = assets.smooth(rng, h, w)
        for comp in (5, 8):
            data = assets.ycbcr_tiff(ycc, sampling, comp, rows, fields={317: (3, [2])})
            across = -(-w // hs)
            scan = across * unit // vs
            rps = rows or h
            sizes = [-(-min(rps, h - y) // vs) * vs * scan for y in range(0, h, rps)]
            tags, _ = tiff._ifd(data, "x")
            undone = [tiff._decoded(tiff._DECODERS[comp], data[o:o + n], size,
                                    tiff._ycbcr_undo(scan, size), "x")[0]
                      for o, n, size in zip(tags[273], tags[279], sizes)]
            assert undone == lt.read_encoded(lib, data, sizes)
            img = assert_like_cv2(data, tmp_path)[1]
            assert img.shape == (h, w, 3)
    ycc = assets.smooth(rng, 37, 45)
    for tile in ((16, 16), (32, 16), (16, 48)):
        data = assets.ycbcr_tiff(ycc, sampling, 8, tile=tile, fields={317: (3, [2])})
        size = -(-tile[1] // vs) * -(-tile[0] // hs) * unit
        n = -(-37 // tile[1]) * -(-45 // tile[0])
        tags, _ = tiff._ifd(data, "x")
        undo = tiff._ycbcr_undo(tile[0] * 3, size)
        got = [tiff._decoded(tiff._inflate, data[o:o + c], size, undo, "x")[0]
               for o, c in zip(tags[324], tags[325])]
        assert got == lt.read_encoded(lib, data, [size] * n, tiles=True)
        assert_like_cv2(data, tmp_path)


# ------------------------------------------------------------------ seeded
@pytest.mark.parametrize("seed", range(10))
def test_seeded_tiffs_with_the_new_variants_equal_cv2(seed, tmp_path):
    """Random files mixing what this reader learned: grey, RGB, palette,
    CMYK, YCbCr and CIE L*a*b* at their depths, signed or not, every
    compression (LZW new- or old-style), Predictor 2, strips or tiles,
    either byte order, an orientation, a strip or tile cut short."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(16):
        ph = int(rng.choice([0, 1, 2, 3, 5, 6, 8, 8]))
        bps = int(rng.choice({0: [1, 8, 16], 1: [1, 8, 16], 2: [8, 16], 3: [1, 4, 8], 5: [8],
                              6: [8], 8: [8, 16]}[ph]))
        spp = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3, 8: 3}[ph]
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        s = rng.integers(0, 1 << bps, (h, w, spp))
        if rng.random() < 0.5:
            s = np.repeat(s[:, :1], w, 1)
        comp = int(rng.choice([1, 5, 5, 8, 32946, 32773]))
        kw = dict(more=_signed(spp) if rng.random() < 0.5 else None,
                  old_lzw=bool(rng.random() < 0.5))
        tiled = rng.random() < 0.3
        if tiled:
            kw["tile"] = (16 * int(rng.integers(1, 4)), 16 * int(rng.integers(1, 4)))
        else:
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if bps in (8, 16) and comp in (5, 8, 32946) and rng.random() < 0.5:
            kw["predictor"] = 2
        if rng.random() < 0.2:
            kw["orientation"] = int(rng.integers(1, 9))
        if ph == 3:
            kw["colormap"] = rng.integers(0, 65536 if rng.random() < 0.6 else 256, (1 << bps, 3))
        order = "<>"[int(rng.integers(0, 2))]
        if ph == 6:
            fields = {**(kw["more"] or {}), **({317: (3, [2])} if "predictor" in kw else {})}
            data = assets.ycbcr_tiff(s, [(1, 1), (2, 2), (4, 2), (2, 1)][int(rng.integers(0, 4))],
                                     comp, kw.get("rows_per_strip"), kw.get("tile"),
                                     fields=fields, order=order)
        else:
            data = assets.tiff_bytes(s, bps, ph, comp, order, **kw)
        if rng.random() < 0.2:
            tags, _ = tiff._ifd(data, "x")
            key = (324, 325) if 324 in tags else (273, 279)
            chunks = [data[o:o + n] for o, n in zip(tags[key[0]], tags[key[1]])]
            k = int(rng.integers(0, len(chunks)))
            chunks[k] = chunks[k][:int(rng.integers(1, len(chunks[k]) + 1))]
            fields = {t: (4 if t in (256, 257, 278) else 3, v) for t, v in tags.items()
                      if t not in key and t not in (529, 532)}
            data = assets.tiff_file(chunks, fields, 324 in tags, order)
        assert_like_cv2(data, tmp_path)
