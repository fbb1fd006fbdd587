"""The port's PNG, BMP and PNM readers (``data/png.py``, ``data/bitmap.py``)
against cv2 5, bit for bit, through both of the port's entry points:
``read_image`` (a file) against ``cv2.imread(path, IMREAD_COLOR)`` and
``decode_image`` (bytes) against ``cv2.imdecode(buf, IMREAD_COLOR)``, each
then ``BGR2RGB``. Where cv2 returns None the port raises ``ValueError``.

Files come from ``scripts/make_port_image_assets.py``'s writers (PIL cannot
write grey PNG below 8 bits, BMP palettes, RLE or PNM maxvals) on seeded
numpy images; then the committed ``assets/images/`` against its manifest;
then the JAX package's ``DetectionICDARDataset``, ``RecognitionListDataset``
and ``LMDBRecognitionDataset`` (cv2) against the port's on files in the new
formats. These tests need cv2, so they run where it is installed."""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

ASSETS = os.path.join(REPO, "assets", "images")
SIZES = [(1, 1), (2, 3), (7, 13), (33, 50), (37, 100)]
#: PNG colour type -> (samples a pixel, bit depths)
PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
             6: (4, (8, 16))}


def _cv2(data, path=None):
    bgr = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, name="x"):
    """Both routes: the port's image equals cv2's, or both refuse (cv2's
    None, the port's ``ValueError``). Returns the decoded image or None."""
    path = tmp_path / name
    path.write_bytes(data)
    out = None
    for got_fn, ref in ((lambda: imageio.read_image(str(path)), _cv2(data, path)),
                        (lambda: imageio.decode_image(data, name), _cv2(data))):
        if ref is None:
            with pytest.raises(ValueError):
                got_fn()
            continue
        got = got_fn()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        out = got
    return out


# ------------------------------------------------------------------- PNG
@pytest.mark.parametrize("colour,depth", [(c, d) for c, (_, ds) in PNG_TYPES.items() for d in ds])
def test_png_every_colour_type_and_bit_depth_equals_cv2(colour, depth, tmp_path):
    """Each size plain and Adam7-interlaced, the five row filters in turn;
    a full palette, a short one (indices past it read black) and one with
    ``tRNS``; grey and RGB with ``tRNS`` (ignored)."""
    ch = PNG_TYPES[colour][0]
    rng = np.random.default_rng(10 * colour + depth)
    for h, w in SIZES:
        s = rng.integers(0, 1 << depth, (h, w, ch))
        for interlace in (0, 1):
            kw = {}
            if colour == 3:
                n = (1 << depth) if interlace else max(1, (1 << depth) // 2 - 1)
                kw["palette"] = rng.integers(0, 256, (n, 3))
                kw["trns"] = bytes(rng.integers(0, 256, min(n, 3)).tolist()) if h > 2 else None
            elif colour in (0, 2) and h > 2:
                kw["trns"] = struct.pack(">" + "H" * ch, *s[0, 0].tolist())
            data = assets.png_bytes(s, depth, colour, interlace=interlace, **kw)
            img = assert_like_cv2(data, tmp_path)
            assert img.shape == (h, w, 3)


def test_png_sixteen_bits_read_their_high_byte(tmp_path):
    """cv2 truncates (``png_set_strip_16``): 127, 128, 383 and 384 read
    0, 0, 1, 1, not ``round(v / 257)``; grey of 1, 2, 4 bits is scaled by
    255 / (2^n - 1)."""
    img = assert_like_cv2(assets.png_bytes(np.array([[127, 128, 383, 384]]), 16, 0), tmp_path)
    assert img[0, :, 0].tolist() == [0, 0, 1, 1]
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        img = assert_like_cv2(assets.png_bytes(np.arange(1 << depth)[None], depth, 0), tmp_path)
        assert img[0, :, 0].tolist() == [v * scale for v in range(1 << depth)]


@pytest.mark.parametrize("kind", range(5))
def test_png_adam7_passes_take_each_row_filter(kind, tmp_path):
    rng = np.random.default_rng(40 + kind)
    for h, w in ((9, 17), (16, 16), (41, 3)):
        for depth, colour, ch in ((8, 2, 3), (16, 6, 4), (2, 0, 1)):
            s = rng.integers(0, 1 << depth, (h, w, ch))
            assert_like_cv2(assets.png_bytes(s, depth, colour, interlace=1, filters=(kind,)),
                            tmp_path)


@pytest.mark.parametrize("orientation", range(10))
def test_png_exif_orientation_as_cv2_applies_it(orientation, tmp_path):
    """An ``eXIf`` chunk before or after the image data, either byte order:
    cv2 turns or flips the page for Orientation 2-8 (6 makes a 4x6 page
    6x4), through ``imread`` and ``imdecode`` alike; 0, 1 and 9 leave it."""
    s = np.random.default_rng(orientation).integers(0, 256, (4, 6, 3))
    for where in ("before", "after"):
        for order in ("<", ">"):
            for depth, colour, interlace in ((8, 2, 0), (16, 2, 1), (2, 0, 0)):
                samples = s if colour == 2 else s[..., 0] % 4
                data = assets.png_bytes(samples << (8 if depth == 16 else 0), depth, colour,
                                        interlace=interlace,
                                        **{where: [(b"eXIf", assets.exif_tiff(orientation,
                                                                               order))]})
                img = assert_like_cv2(data, tmp_path)
                assert img.shape == ((6, 4, 3) if orientation in (5, 6, 7, 8) else (4, 6, 3))


def test_png_exif_with_a_jpeg_prefix_is_not_applied(tmp_path):
    """libpng refuses an ``eXIf`` body that does not start with "II" or
    "MM" (such as JPEG's "Exif\\0\\0" prefix), and the page stays as coded."""
    s = np.random.default_rng(3).integers(0, 256, (4, 6, 3))
    data = assets.png_bytes(s, 8, 2, before=[(b"eXIf", b"Exif\0\0" + assets.exif_tiff(6))])
    assert assert_like_cv2(data, tmp_path).shape == (4, 6, 3)


def test_png_ancillary_chunks_are_ignored(tmp_path):
    s = np.random.default_rng(4).integers(0, 256, (9, 17, 3))
    for chunks in ([(b"gAMA", struct.pack(">I", 100000))], [(b"sBIT", bytes([3, 4, 5]))],
                   [(b"cHRM", bytes(32))], [(b"tEXt", b"Title\0a page"), (b"zTXt", b"x\0\0")]):
        img = assert_like_cv2(assets.png_bytes(s, 8, 2, before=chunks), tmp_path)
        np.testing.assert_array_equal(img, s)
    img = assert_like_cv2(assets.png_bytes(s * 257, 16, 2, before=[(b"sBIT", bytes([9] * 3))]),
                          tmp_path)
    np.testing.assert_array_equal(img, s)


def test_png_data_past_the_image_and_bad_ancillary_crcs_are_dropped(tmp_path):
    """libpng ignores decompressed data past the last row and drops an
    ancillary chunk whose CRC is wrong (an ``eXIf`` one too: no turn)."""
    s = np.random.default_rng(6).integers(0, 256, (5, 7, 3))
    for interlace in (0, 1):
        data = assets.png_bytes(s, 8, 2, interlace=interlace)
        at = data.index(b"IDAT") - 4
        (length,) = struct.unpack(">I", data[at:at + 4])
        raw = zlib.decompress(data[at + 8:at + 8 + length])
        for extra in (b"\0", bytes(100)):
            longer = (data[:at] + assets.png_chunk(b"IDAT", zlib.compress(raw + extra))
                      + data[at + 12 + length:])
            np.testing.assert_array_equal(assert_like_cv2(longer, tmp_path), s)
    for kind, body in ((b"tEXt", b"Title\0a page"), (b"eXIf", assets.exif_tiff(6))):
        data = assets.png_bytes(s, 8, 2, before=[(kind, body)])
        at = data.index(kind) + 4 + len(body)  # the chunk's CRC
        bad = data[:at] + bytes([data[at] ^ 1]) + data[at + 1:]
        np.testing.assert_array_equal(assert_like_cv2(bad, tmp_path), s)


def test_png_refusals(tmp_path):
    """What the standard does not allow raises ``ValueError`` (cv2 returns
    None)."""
    ok = assets.png_bytes(np.zeros((4, 4, 3), np.int64), 8, 2)
    for ihdr, what in (((4, 4, 16, 3, 0, 0, 0), "bit depth 16 and colour type 3"),
                       ((4, 4, 2, 6, 0, 0, 0), "bit depth 2 and colour type 6"),
                       ((4, 4, 8, 5, 0, 0, 0), "colour type 5"),
                       ((4, 4, 8, 2, 0, 0, 2), "interlace 2")):
        data = ok[:8] + assets.png_chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr)) + ok[33:]
        with pytest.raises(ValueError, match=what):
            imageio.decode_image(data)
        assert _cv2(data) is None
    no_plte = assets.png_bytes(np.zeros((4, 4), np.int64), 4, 3)
    with pytest.raises(ValueError, match="without PLTE"):
        imageio.decode_image(no_plte)
    assert _cv2(no_plte) is None
    short = (assets.PNG_SIGNATURE + assets.png_chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8,
                                                                          0, 0, 0, 0))
             + assets.png_chunk(b"IDAT", zlib.compress(bytes(10)))
             + assets.png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="holds 10 bytes, not 20"):
        imageio.decode_image(short)
    assert _cv2(short) is None


# ------------------------------------------------------------------- BMP
@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("header", [12, 40, 108, 124])
def test_bmp_palettes_equal_cv2(bpp, header, tmp_path):
    """Bottom-up and top-down rows, full and short palettes (an index past
    the palette reads black), every size; the OS/2 header's 3-byte entries."""
    rng = np.random.default_rng(bpp * 1000 + header)
    for h, w in SIZES:
        for top_down in ((False,) if header == 12 else (False, True)):
            n = 1 << bpp if header == 12 or top_down else max(1, (1 << bpp) - 3)
            data = assets.bmp_bytes(rng.integers(0, 1 << bpp, (h, w)), bpp,
                                    rng.integers(0, 256, (n, 3)), header=header,
                                    top_down=top_down)
            assert assert_like_cv2(data, tmp_path).shape == (h, w, 3)


@pytest.mark.parametrize("header", [40, 108, 124])
def test_bmp_16_24_32_bits_equal_cv2(header, tmp_path):
    """16 bits as 5-5-5, by 5-6-5 and 5-5-5 masks (cv2 takes them from the
    12 bytes after the header), each field shifted up; 24 bits; 32 bits,
    the fourth byte dropped, channels by byte masks in a header of 108
    bytes and more, masks ignored after a 40-byte one."""
    rng = np.random.default_rng(header)
    for h, w in SIZES:
        v = rng.integers(0, 1 << 16, (h, w))
        assert_like_cv2(assets.bmp_bytes(v, 16, header=header), tmp_path)
        for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            assert_like_cv2(assets.bmp_bytes(v, 16, compression=3, masks=masks), tmp_path)
        for top_down in (False, True):
            assert_like_cv2(assets.bmp_bytes(rng.integers(0, 256, (h, w, 3)), 24, header=header,
                                             top_down=top_down), tmp_path)
        px = rng.integers(0, 256, (h, w, 4))
        assert_like_cv2(assets.bmp_bytes(px, 32, header=header), tmp_path)
        for masks in ((0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000),
                      (0xFF00, 0xFF0000, 0xFF000000)):
            assert_like_cv2(assets.bmp_bytes(px, 32, header=header, compression=3, masks=masks),
                            tmp_path)
    v = rng.integers(0, 1 << 16, (3, 5))
    img = assert_like_cv2(assets.bmp_bytes(v, 16), tmp_path)
    np.testing.assert_array_equal(img[..., 0], ((v >> 10) & 31) << 3)


def _rle_stream(rng, h, w, four, valid):
    """A random RLE stream: runs, literal pixels, ends of line, jumps and
    an end of bitmap, sometimes past a row's end (``valid`` False)."""
    out, y, x = bytearray(), 0, 0
    for _ in range(60):
        if y >= h:
            break
        r = rng.random()
        if r < 0.45 and x < w:
            n = int(rng.integers(1, w - x + 1)) if valid else int(rng.integers(1, w + 3))
            out += bytes([n, int(rng.integers(0, 256))])
            x += n
            if not four and x >= w:
                x, y = 0, y + 1
        elif r < 0.7 and w - x >= 3:
            n = int(rng.integers(3, w - x + 1))
            lit = rng.integers(0, 256, (n + 1) // 2 if four else n).tolist()
            size = ((n + 1) // 2 + 1) & ~1 if four else (n + 1) & ~1
            out += bytes([0, n]) + bytes(lit) + b"\0" * (size - len(lit))
            x += n
        elif r < 0.85:
            out += b"\0\0"
            x, y = 0, y + 1
        elif r < 0.95:
            dx, dy = int(rng.integers(0, 4)), int(rng.integers(0, 2))
            out += bytes([0, 2, dx, dy])
            y, x = divmod(y * w + x + dx + dy * w, w)
        else:
            out += b"\0\1"
            break
    if rng.random() < 0.7:
        out += b"\0\1"
    return bytes(out)


@pytest.mark.parametrize("bpp", [8, 4])
def test_bmp_rle_streams_walk_as_cv2_walks_them(bpp, tmp_path):
    """120 random streams each: the pixels a jump, end of line or end of
    bitmap passes take palette entry 0; RLE8 moves to the next row when a
    run fills one, RLE4 does not (an end of bitmap or a jump ends or moves
    along its row only); a run past its row or a stream that ends early is
    refused, where cv2 returns None."""
    rng = np.random.default_rng(bpp)
    pal = rng.integers(0, 256, (1 << bpp, 3))
    refused = 0
    for t in range(120):
        h, w = (int(v) for v in rng.integers(1, 12, 2))
        data = assets.bmp_bytes(np.zeros((h, w)), bpp, pal, compression=1 if bpp == 8 else 2,
                                top_down=bool(rng.random() < 0.3),
                                rle=_rle_stream(rng, h, w, bpp == 4, t % 3 != 0))
        refused += assert_like_cv2(data, tmp_path) is None
    assert 0 < refused < 100
    for h, w in SIZES:  # the asset script's encoder
        idx = np.repeat(rng.integers(0, 1 << bpp, (h, w // 4 + 1)), 4, 1)[:, :w]
        idx[::2] = rng.integers(0, 1 << bpp, idx[::2].shape)
        data = assets.bmp_bytes(idx, bpp, pal, compression=1 if bpp == 8 else 2,
                                rle=assets.rle_encode(idx, bpp == 4))
        np.testing.assert_array_equal(assert_like_cv2(data, tmp_path), pal[idx][..., ::-1])


def test_bmp_cv2_files_and_refusals(tmp_path):
    rng = np.random.default_rng(5)
    for img in (rng.integers(0, 256, (33, 50, 3), dtype=np.uint8),
                rng.integers(0, 256, (7, 13), dtype=np.uint8)):
        assert_like_cv2(assets.cv_encode(".bmp", img), tmp_path)
    v = rng.integers(0, 1 << 16, (4, 4))
    data = assets.bmp_bytes(v, 16, compression=3, masks=(0xFC00, 0x3F0, 0xF))
    with pytest.raises(ValueError, match="neither 5-6-5 nor 5-5-5"):
        imageio.decode_image(data)
    assert _cv2(data) is None
    # masks inside a V4 header: cv2 reads the 12 bytes after it instead
    data = assets.bmp_bytes(v, 16, header=108, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    with pytest.raises(ValueError, match="after its header"):
        imageio.decode_image(data)
    assert _cv2(data) is None
    # 10-bit channels cv2 reads some way of its own: refused by name
    data = assets.bmp_bytes(rng.integers(0, 256, (4, 4, 4)), 32, header=124, compression=3,
                            masks=(0x3FF00000, 0xFFC00, 0x3FF))
    with pytest.raises(NotImplementedError, match="32-bit BMP masks"):
        imageio.decode_image(data)
    assert _cv2(data) is not None
    with pytest.raises(ValueError, match="cut short"):
        imageio.decode_image(assets.bmp_bytes(rng.integers(0, 256, (5, 5, 3)), 24)[:-4])


# ------------------------------------------------------------------- PNM
@pytest.mark.parametrize("ext", [".pbm", ".pgm", ".ppm"])
@pytest.mark.parametrize("binary", [0, 1])
def test_pnm_cv2_files_equal_cv2(ext, binary, tmp_path):
    rng = np.random.default_rng(len(ext) + binary)
    for h, w in SIZES:
        img = rng.integers(0, 256, (h, w, 3) if ext == ".ppm" else (h, w), dtype=np.uint8)
        if ext == ".pbm":
            img = (img > 127).astype(np.uint8) * 255
        assert_like_cv2(assets.cv_encode(ext, img, [cv2.IMWRITE_PXM_BINARY, binary]), tmp_path)
        if ext != ".pbm":
            wide = rng.integers(0, 65536, img.shape).astype(np.uint16)
            assert_like_cv2(assets.cv_encode(ext, wide, [cv2.IMWRITE_PXM_BINARY, binary]),
                            tmp_path)


@pytest.mark.parametrize("maxval", [1, 2, 7, 100, 254, 255, 256, 1000, 4095, 65535])
def test_pnm_maxval_as_cv2_reads_it(maxval, tmp_path):
    """ASCII samples clamped to maxval and, below 256, scaled by
    ``v * 255 // maxval``; binary one-byte samples taken as they are (maxval
    100 reads 100 as 100, 150 as 150); two-byte samples cut to their high
    byte (maxval 1000 reads 1000 as 3), binary or ASCII."""
    rng = np.random.default_rng(maxval)
    for kind, ch in ((2, 1), (3, 3), (5, 1), (6, 3)):
        v = rng.integers(0, maxval * 3 // 2 + 1, (5, 7, ch))
        head = f"P{kind}\n7 5\n{maxval}\n".encode()
        if kind in (5, 6):
            v = np.minimum(v, 255 if maxval < 256 else 65535)
            body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
        else:
            body = " ".join(map(str, v.reshape(-1).tolist())).encode() + b"\n"
        img = assert_like_cv2(head + body, tmp_path)
        if kind == 5 and maxval < 256:
            np.testing.assert_array_equal(img[..., 0], v[..., 0])


def test_pnm_headers_comments_and_refusals(tmp_path):
    """Comments anywhere before a header number (also inside ASCII data
    after a separator), one byte after the last header number (a CR of
    CRLF is it), P1 digits packed or spaced, P4's padding bits ignored;
    refused: maxval 0 or above 65535, short data, an ASCII sample at the
    very end of the data (cv2 reads one byte past a number)."""
    for data in (b"P2 # c1\n# c2\n3 # c3\n1\n#c4\n255\n1 2 3\n",
                 b"P5\n3 1\n255\r\n" + bytes([10, 32, 9]),
                 b"P5\n3 1\n255\n#c\n" + bytes([10, 32, 9]),
                 b"P2\n3 1\n255\n1 2 #x\n 3\n",
                 b"P1\n3 1\n1 0 2\n", b"P1 3 1 101", b"P4\n3 1\n\xbf",
                 b"P3\n2 1\n1000\n1 2 3 1500 2000 70000 ",
                 b"P6\n2 1\n255\n" + bytes(range(6)) + b"extra"):
        assert assert_like_cv2(data, tmp_path) is not None, data
    for data, what in ((b"P2\n2 1\n0\n0 0\n", "maxval 0"), (b"P2\n2 1\n65536\n0 0\n", "maxval"),
                       (b"P2\n3 1\n255\n1 2 3", "ends inside"),
                       (b"P5\n3 1\n255\n\x01\x02", "cut short"),
                       (b"P2\n3 1\n255\n1 2#x\n 3\n", "0x78"),
                       (b"P3\n1 1\n255\n1 2\n", "ends inside")):
        with pytest.raises(ValueError, match=what):
            imageio.decode_image(data)
        assert _cv2(data) is None


# ---------------------------------------------------------- the committed files
def test_committed_image_assets_match_their_manifest_cv2_and_the_port():
    """Every file of ``assets/images/``: cv2 (both routes) gives the
    manifest's digests, and so does the port (as the card's phase jpeg
    checks them)."""
    with open(os.path.join(ASSETS, "manifest.json")) as f:
        manifest = json.load(f)
    files = manifest["files"]
    assert manifest["made_by"] == "scripts/make_port_image_assets.py"
    assert sum(rel.startswith("pages/") for rel in files) == 13
    assert sum(v["bytes"] for v in files.values()) < 2_000_000

    def sha(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    for rel, want in files.items():
        path = os.path.join(ASSETS, rel)
        with open(path, "rb") as f:
            data = f.read()
        if want["sha256"] is None:  # cv2.imread refuses it
            assert _cv2(data, path) is None
            with pytest.raises(ValueError):
                imageio.read_image(path)
        else:
            for img in (_cv2(data, path), imageio.read_image(path)):
                assert list(img.shape) == want["shape"] and sha(img) == want["sha256"], rel
        by_bytes = want.get("imdecode", want)
        if by_bytes is None:
            assert _cv2(data) is None
            with pytest.raises(ValueError):
                imageio.decode_image(data, rel)
            continue
        for img in (_cv2(data), imageio.decode_image(data, rel)):
            assert list(img.shape) == by_bytes["shape"] and sha(img) == by_bytes["sha256"], rel


# ------------------------------------------------------- the JAX datasets
def _format_files(rng):
    """name -> bytes of small pages in the new formats."""
    page = assets.smooth(rng, 45, 61)
    idx = rng.integers(0, 6, (45, 61))
    pal = rng.integers(0, 256, (6, 3))
    cmyk = assets.pil_jpeg(assets.smooth(rng, 45, 61, 4), "CMYK", quality=90, subsampling=2)
    return {
        "cmyk.jpg": cmyk,
        "ycck.jpg": assets.with_adobe_transform(cmyk, 2),
        "multiscan.jpg": assets.jpeg_rescan(assets.cv_encode(".jpg", page), [[0], [1, 2]]),
        "rgb.jpg": assets.with_adobe_transform(assets.cv_encode(".jpg", page), 0),
        "palette.png": assets.png_bytes(idx, 4, 3, palette=pal, interlace=1),
        "deep.png": assets.png_bytes(page.astype(np.int64) * 257 + 99, 16, 2, interlace=1),
        "turned.png": assets.png_bytes(page, 8, 2, after=[(b"eXIf", assets.exif_tiff(6))]),
        "rle.bmp": assets.bmp_bytes(idx, 8, pal, compression=1, rle=assets.rle_encode(idx, False)),
        "grey.pgm": assets.cv_encode(".pgm", page[..., 0].astype(np.uint16) * 200),
        "ascii.ppm": assets.cv_encode(".ppm", page.astype(np.uint8), [cv2.IMWRITE_PXM_BINARY, 0]),
    }


def test_jax_datasets_equal_the_ports_on_the_new_formats(tmp_path):
    """``DetectionICDARDataset`` (the ``.jpg``/``.png`` pages: CMYK, YCCK,
    multi-scan and RGB-coded JPEG, palette, 16-bit Adam7 and rotated PNG),
    ``RecognitionListDataset`` (every file, BMP and PNM too) and
    ``LMDBRecognitionDataset`` (every file's bytes): the JAX package's items
    (cv2) equal the port's bit for bit."""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDB
    from megreader_tpu_torch.data import datasets
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    files = _format_files(np.random.default_rng(7))
    pages, gts = tmp_path / "images", tmp_path / "gts"
    pages.mkdir()
    gts.mkdir()
    lines, records = [], {b"num-samples": str(len(files)).encode()}
    for i, (name, data) in enumerate(sorted(files.items())):
        (pages / name).write_bytes(data)
        (gts / f"gt_{os.path.splitext(name)[0]}.txt").write_text("3,4,30,4,30,20,3,20,word\n")
        lines.append(f"images/{name}\tword{i}")
        records[f"image-{i + 1:09d}".encode()] = data
        records[f"label-{i + 1:09d}".encode()] = f"word{i}".encode()
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    write_fixture_lmdb(str(tmp_path / "lmdb"), records)

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

    kw = dict(target_hw=(64, 96))
    ref = jax_datasets.DetectionICDARDataset(str(pages), str(gts), **kw)
    got = datasets.DetectionICDARDataset(str(pages), str(gts), **kw)
    assert got.names == ref.names and len(ref) == 7
    for pair in [(ref, got), (jax_datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                                  canvas_hw=(48, 128)),
                              datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                              canvas_hw=(48, 128))),
                 (JaxLMDB(str(tmp_path / "lmdb"), canvas_hw=(48, 128)),
                  LMDBRecognitionDataset(str(tmp_path / "lmdb"), canvas_hw=(48, 128)))]:
        assert len(pair[0]) == len(pair[1])
        for i in range(len(pair[0])):
            same(pair[1][i], pair[0][i])
