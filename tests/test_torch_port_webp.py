"""The port's WebP reader (``data/webp.py`` over ``data/vp8l.py`` and
``data/vp8.py``) against cv2 5 bit for bit, through ``read_image``
(``cv2.imread``) and ``decode_image`` (``cv2.imdecode``), each then
``BGR2RGB``; where cv2 returns None the port raises ``ValueError``.

First the committed WebP files of ``assets/images/`` against their manifest
digests; then seeded files against cv2 itself: lossless and lossy files from
cv2, PIL and libwebp's own encoder, hand-made VP8L streams
(``scripts/make_port_image_assets.py``'s ``vp8l_bytes``: each predictor
mode, the colour and subtract-green transforms, colour indexing at every
bundling width, the colour cache, meta prefix codes, both code forms),
containers (ALPH, EXIF, animations, cut and padded files, refusals); then
the JAX package's ``RecognitionListDataset`` and ``LMDBRecognitionDataset``
(cv2) against the port's on WebP and JPEG-compressed TIFF files. These tests
need cv2, so they run where it is installed."""

import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio, vp8, vp8l, webp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST if rel.endswith(".webp"))


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("rel", FILES)
def test_committed_webp_equals_its_manifest_through_both_routes(rel):
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


def test_committed_webp_files_cover_the_forms_and_pages():
    names = " ".join(FILES)
    for part in ("lossless", "lossy", "rgba", "libwebp", "vp8l_predict", "vp8l_palette",
                 "alph_lossless", "exif", "anim", "cut", "padded", "bare_vp8l"):
        assert part in names, part
    assert {"pages/page_lossless.webp", "pages/page_lossy.webp"} <= set(FILES)
    assert sum(MANIFEST[r]["sha256"] is None for r in FILES) >= 10  # refusals


# ------------------------------------------------------- against cv2 itself
def _cv2(data, path=None):
    bgr = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, name="x.webp"):
    """Both routes equal cv2's, or both refuse (cv2's None, the port's
    ``ValueError``). Returns the decoded image or None."""
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


def _image(rng, h, w, kind):
    """(h, w, 4) RGBA test content: noise, a ramp with noise, few colours or
    flat with strokes."""
    if kind == 0:
        return rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if kind == 1:
        y, x = np.mgrid[:h, :w]
        ramp = np.stack([(3 * x + y) % 256, (2 * y) % 256, (x + 5 * y) % 256, 255 - x % 7], -1)
        return np.clip(ramp + rng.integers(0, 9, ramp.shape), 0, 255).astype(np.uint8)
    if kind == 2:
        pal = rng.integers(0, 256, (int(rng.integers(2, 40)), 4))
        return pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)
    img = np.full((h, w, 4), rng.integers(0, 256, 4), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + 3, x:x + int(rng.integers(1, 20))] = rng.integers(0, 256, 4)
    return img


@pytest.mark.parametrize("seed", range(4))
def test_seeded_lossless_files_equal_cv2(seed, tmp_path):
    """PIL's lossless encoder at every method and quality, with and without
    alpha and ``exact``, on 1x1 to 70x70 images of four kinds."""
    rng = np.random.default_rng(250 + seed)
    for i in range(20):
        h, w = int(rng.integers(1, 71)), int(rng.integers(1, 71))
        img = _image(rng, h, w, i % 4)
        opaque = rng.random() < 0.5
        data = assets.pil_webp(img[..., :3] if opaque else img, "RGB" if opaque else "RGBA",
                               lossless=True, method=int(rng.integers(0, 7)),
                               quality=int(rng.integers(0, 101)), exact=bool(rng.random() < 0.5))
        assert_like_cv2(data, tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_lossy_files_equal_cv2(seed, tmp_path):
    """cv2's and PIL's lossy encoders at every quality (PIL at every method,
    with alpha in half the files): segments, skipped macroblocks, both
    prediction sizes, the normal loop filter, fancy upsampling at odd sizes."""
    rng = np.random.default_rng(260 + seed)
    for i in range(16):
        h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        img = _image(rng, h, w, i % 4)
        q = int(rng.integers(1, 101))
        if i % 2:
            data = assets.cv_encode(".webp", img[..., 2::-1], [cv2.IMWRITE_WEBP_QUALITY, q])
        else:
            alpha = rng.random() < 0.5
            data = assets.pil_webp(img if alpha else img[..., :3], "RGBA" if alpha else "RGB",
                                   quality=q, method=int(rng.integers(0, 7)))
        assert_like_cv2(data, tmp_path)


@pytest.mark.parametrize("cfg", [dict(filter_type=0, filter_strength=50),
                                 dict(filter_type=0, filter_sharpness=7, filter_strength=100),
                                 dict(filter_type=1, filter_sharpness=2, filter_strength=80),
                                 dict(partitions=3, method=0), dict(partitions=2, method=2),
                                 dict(segments=1, filter_strength=0)])
def test_libwebp_encoder_options_equal_cv2(cfg, tmp_path):
    """libwebp's own encoder (``libwebp_lossy``) for what cv2 and PIL do not
    set: the simple loop filter, sharpness, 2-8 token partitions, one
    segment, no filtering."""
    rng = np.random.default_rng(270)
    for h, w in ((17, 23), (70, 49)):
        img = np.clip(assets.smooth(rng, h, w).astype(np.int64)
                      + rng.integers(-50, 51, (h, w, 3)), 0, 255)
        assert_like_cv2(assets.libwebp_lossy(img, float(rng.integers(10, 95)), **cfg), tmp_path)


def _argb(rng, h=13, w=37, kind=1):
    img = _image(rng, h, w, kind)
    return img[..., [3, 0, 1, 2]]  # (a, r, g, b)


def _vp8l_file(stream):
    return assets.webp_file(assets.riff_chunk(b"VP8L", stream))


@pytest.mark.parametrize("mode", range(14))
def test_each_predictor_mode_equals_cv2(mode, tmp_path):
    """A hand-made stream whose every block uses predictor ``mode`` (the
    first row, first column and rightmost column's top-right by RFC 9649),
    at block sizes 4 and 8, on noise and a ramp, at widths 1, 2 and 37."""
    rng = np.random.default_rng(280 + mode)
    for h, w, bits in ((13, 37, 2), (9, 37, 3), (7, 1, 2), (5, 2, 2)):
        for kind in (0, 1):
            blocks = -(-w // (1 << bits)) * -(-h // (1 << bits))
            stream = assets.vp8l_bytes(_argb(rng, h, w, kind), [("predict", bits, [mode] * blocks)])
            assert_like_cv2(_vp8l_file(stream), tmp_path)


@pytest.mark.parametrize("transforms", ["green", "colour", "green_predict_colour",
                                        "colour_green", "predict_mixed"])
def test_each_transform_and_order_equals_cv2(transforms, tmp_path):
    rng = np.random.default_rng(290 + len(transforms))
    argb = _argb(rng)
    mult = rng.integers(-128, 128, (40, 3))
    modes = list(rng.integers(0, 14, 40))
    spec = {"green": [("green",)], "colour": [("colour", 2, mult)],
            "green_predict_colour": [("green",), ("predict", 2, modes), ("colour", 2, mult)],
            "colour_green": [("colour", 2, mult), ("green",)],
            "predict_mixed": [("predict", 2, modes)]}[transforms]
    assert_like_cv2(_vp8l_file(assets.vp8l_bytes(argb, spec)), tmp_path)


@pytest.mark.parametrize("colours", [1, 2, 3, 4, 5, 16, 17, 256])
def test_colour_indexing_at_every_bundling_width_equals_cv2(colours, tmp_path):
    """Palettes of 1-256 colours: 8, 4, 2 or 1 pixels a packed pixel, widths
    that do not fill the last one, then a predictor over the packed indices."""
    rng = np.random.default_rng(300 + colours)
    pal = rng.integers(0, 256, (colours, 4))
    for h, w in ((3, 1), (11, 23), (2, 257)):
        img = pal[rng.integers(0, colours, (h, w))].astype(np.uint8)
        if colours == 256 and h * w >= 256:
            img.reshape(-1, 4)[:256] = pal  # every colour used
        assert_like_cv2(_vp8l_file(assets.vp8l_bytes(img, [("palette",)])), tmp_path)
    packed = -(-23 // (1 << (0 if colours > 16 else 1 if colours > 4 else 2 if colours > 2 else 3)))
    modes = list(rng.integers(0, 14, -(-packed // 4) * 3))
    img = pal[rng.integers(0, colours, (11, 23))].astype(np.uint8)
    assert_like_cv2(_vp8l_file(assets.vp8l_bytes(img, [("palette",), ("predict", 2, modes)])),
                    tmp_path)


@pytest.mark.parametrize("cache_bits", [1, 4, 11])
def test_colour_cache_and_backward_references_equal_cv2(cache_bits, tmp_path):
    """Copies from the left, from above (short distance codes) and 3 back
    (a long one), runs longer than the distance, cache hits."""
    rng = np.random.default_rng(310 + cache_bits)
    for kind in range(4):
        argb = _argb(rng, 17, 29, kind)
        assert_like_cv2(_vp8l_file(assets.vp8l_bytes(argb, cache_bits=cache_bits)), tmp_path)


def test_meta_prefix_codes_and_both_code_forms_equal_cv2(tmp_path):
    """Entropy images of 1-5 groups at block sizes 4 and 16; simple codes
    of one symbol (read with no bits) and of two (1- and 8-bit first
    symbols); the normal form for the same image."""
    rng = np.random.default_rng(320)
    argb = _argb(rng, 19, 41)
    for bits, groups in ((2, 1), (2, 5), (4, 3)):
        n = -(-41 // (1 << bits)) * -(-19 // (1 << bits))
        stream = assets.vp8l_bytes(argb, group_bits=bits, groups=list(rng.integers(0, groups, n)))
        assert_like_cv2(_vp8l_file(stream), tmp_path)
    two = (argb // 128 * 255).astype(np.uint8)
    two[..., 0] = 255
    for simple in (True, False):
        for img in (two, np.zeros_like(two) + np.array([255, 0, 1, 0], np.uint8)):
            stream = assets.vp8l_bytes(img, lz77=False, simple=simple)
            assert_like_cv2(_vp8l_file(stream), tmp_path)


def test_prefix_code_reader_builds_canonical_codes():
    """``vp8l._Code``: codes of RFC 9649's canonical order read back from an
    LSB-first stream, long codes through the slow path, refusals of
    incomplete and over-full codes."""
    lengths = np.array([3, 3, 3, 3, 3, 2, 4, 4] + [0] * 5 + [14, 14] + [13] * 1)
    with pytest.raises(ValueError, match="not complete"):
        vp8l._Code(lengths, "x")
    lengths = np.array(list(range(1, 16)) + [15])  # complete, codes of up to 15 bits
    assert (np.ldexp(1.0, -lengths)).sum() == 1.0
    code = vp8l._Code(lengths, "x")
    codes = assets._canonical({s: int(n) for s, n in enumerate(lengths)})
    bits = assets.LsbBits()
    for s in range(len(lengths)):
        bits.put(*codes[s])
    br = vp8l._Reader(bits.data(), "x")
    for s in range(len(lengths)):
        v = (br.words[br.pos >> 3] >> (br.pos & 7))
        e = code.table[v & ((1 << code.root) - 1)]
        got, n = code.slow(v) if e < 0 else (e >> 4, e & 15)
        br.pos += n
        assert (got, n) == (s, lengths[s])
    with pytest.raises(ValueError, match="without symbols"):
        vp8l._Code(np.zeros(5, np.int64), "x")


def test_container_rules_equal_cv2(tmp_path):
    """Chunks before and after the image, unknown chunks, ALPH (checked
    though dropped: reserved bits, methods, preprocessing, lengths, the last
    of two), RIFF and chunk sizes, trailing bytes, bare bitstreams, cut
    files, fewer than 32 bytes."""
    rng = np.random.default_rng(330)
    img = assets.smooth(rng, 13, 7)
    lossless = assets.webp_payload(assets.cv_encode(".webp", img[..., ::-1],
                                                    [cv2.IMWRITE_WEBP_QUALITY, 101]), b"VP8L")
    lossy = assets.webp_payload(assets.cv_encode(".webp", img[..., ::-1],
                                                 [cv2.IMWRITE_WEBP_QUALITY, 70]), b"VP8 ")
    chunk, vp8x, riff = assets.riff_chunk, assets.vp8x_chunk, assets.webp_file
    alpha = rng.integers(0, 256, (13, 7))
    stream = assets._alpha_stream(alpha)

    def with_alpha(*alphs, flags=0x10):
        return riff(vp8x(flags, 7, 13) + b"".join(chunk(b"ALPH", a) for a in alphs)
                    + chunk(b"VP8 ", lossy))

    cases = [
        riff(chunk(b"VP8L", lossless)), riff(chunk(b"VP8 ", lossy)),
        riff(vp8x(0, 7, 13) + chunk(b"ABCD", b"xyz") + chunk(b"VP8L", lossless)),
        riff(chunk(b"ABCD", b"xyz") + chunk(b"VP8L", lossless)),  # refused: no VP8X
        riff(vp8x(0, 8, 13) + chunk(b"VP8L", lossless)),  # refused: canvas
        riff(chunk(b"VP8L", lossless), riff_size=len(lossless) + 14),  # refused: RIFF size
        riff(chunk(b"VP8L", lossless), riff_size=len(lossless) + 10),  # refused: too small
        riff(b"VP8L" + (len(lossless) + 4).to_bytes(4, "little") + lossless),  # refused
        riff(b"VP8L" + (len(lossless) - 4).to_bytes(4, "little") + lossless),  # read
        riff(chunk(b"VP8L", lossless)) + b"garbage!!",
        lossless + bytes(40), lossy + bytes(40),  # bare bitstreams
        with_alpha(b"\x01" + stream), with_alpha(b"\x01" + stream, flags=0),
        with_alpha(b"\x05" + stream), with_alpha(b"\x11" + stream),
        with_alpha(b"\x21" + stream), with_alpha(b"\x41" + stream), with_alpha(b"\x03" + stream),
        with_alpha(b"\x01" + stream[:len(stream) // 2]), with_alpha(b"\x01"), with_alpha(b""),
        with_alpha(b"\x00" + bytes(90)), with_alpha(b"\x00" + bytes(91)),
        with_alpha(b"\x00", b"\x01" + stream), with_alpha(b"\x01" + stream, b"\x00"),
        riff(chunk(b"ALPH", b"\x01" + stream) + chunk(b"VP8 ", lossy)),  # refused: no VP8X
        riff(vp8x(0x10, 7, 13) + chunk(b"VP8 ", lossy) + chunk(b"ALPH", b"\x00")),  # after
        riff(vp8x(0x10, 7, 13) + chunk(b"ALPH", b"\x00" + bytes(91)) + chunk(b"VP8L", lossless)),
        riff(vp8x(0, 7, 13)) + bytes(20),  # refused: no image
    ]
    whole = riff(chunk(b"VP8L", lossless))
    cases += [whole[:n] for n in (31, 32, len(whole) // 2, len(whole) - 1)]
    for k, data in enumerate(cases):
        assert_like_cv2(data, tmp_path, f"c{k}.webp")


def test_exif_orientations_equal_cv2(tmp_path):
    """Orientation 1-8 of a VP8X file's EXIF chunk (either byte order,
    before or after the image, lossless and lossy), and where libwebp's
    demuxer drops it: no EXIF flag, reserved flag bits, a chunk past the
    end, two images; the first of two EXIF chunks."""
    rng = np.random.default_rng(340)
    img = assets.smooth(rng, 7, 13)
    lossless = assets.webp_payload(assets.cv_encode(".webp", img[..., ::-1],
                                                    [cv2.IMWRITE_WEBP_QUALITY, 101]), b"VP8L")
    lossy = assets.webp_payload(assets.cv_encode(".webp", img[..., ::-1],
                                                 [cv2.IMWRITE_WEBP_QUALITY, 60]), b"VP8 ")
    chunk, vp8x, riff, exif = assets.riff_chunk, assets.vp8x_chunk, assets.webp_file, \
        assets.exif_tiff
    turned = 0
    for o in range(1, 9):
        for order in "<>":
            for image in (chunk(b"VP8L", lossless), chunk(b"VP8 ", lossy)):
                for before in (False, True):
                    e = chunk(b"EXIF", exif(o, order))
                    body = e + image if before else image + e
                    out = assert_like_cv2(riff(vp8x(0x08, 13, 7) + body), tmp_path)
                    turned += out.shape[:2] == (13, 7)
    assert turned == 4 * 8  # orientations 5-8 transpose
    image = chunk(b"VP8L", lossless)
    for data in (riff(vp8x(0, 13, 7) + image + chunk(b"EXIF", exif(6))),
                 riff(vp8x(0xC8, 13, 7) + image + chunk(b"EXIF", exif(6))),
                 riff(vp8x(0x08, 13, 7) + image + b"EXIF" + (500).to_bytes(4, "little")
                      + exif(6)),
                 riff(vp8x(0x08, 13, 7) + image + image + chunk(b"EXIF", exif(6))),
                 riff(vp8x(0x08, 13, 7) + image + chunk(b"EXIF", exif(3))
                      + chunk(b"EXIF", exif(6))),
                 riff(vp8x(0x08, 13, 7) + image + chunk(b"EXIF", b"Exif\0\0" + exif(6)))):
        assert_like_cv2(data, tmp_path)


def test_animations_read_their_first_frame_like_cv2(tmp_path):
    """PIL's two-frame animations, lossless and lossy; by hand, a first
    frame smaller than the canvas at an offset (black elsewhere), with alpha
    under each blending and disposal flag and a background colour, a lossy
    frame with ALPH, EXIF; refused: a frame past the canvas, no ANIM chunk,
    the animation flag over a still image, cut files."""
    rng = np.random.default_rng(350)
    frames = [assets.smooth(rng, 20, 30), assets.smooth(rng, 20, 30)]
    for kw in (dict(lossless=True), dict(quality=50)):
        assert_like_cv2(assets.pil_webp_animation(frames, **kw), tmp_path)
    small = np.concatenate([assets.smooth(rng, 7, 13), rng.integers(0, 256, (7, 13, 1))], -1)
    lossless = assets.webp_payload(assets.pil_webp(small, "RGBA", lossless=True), b"VP8L")
    lossy = assets.pil_webp(small, "RGBA", quality=70)
    alph, vp8_chunk = assets.webp_payload(lossy, b"ALPH"), assets.webp_payload(lossy, b"VP8 ")
    second = assets.webp_payload(assets.cv_encode(".webp", frames[1][..., ::-1],
                                                  [cv2.IMWRITE_WEBP_QUALITY, 101]), b"VP8L")
    chunk, anim = assets.riff_chunk, assets.animation
    tail = (0, 0, 30, 20, 0, chunk(b"VP8L", second))
    for flags in range(4):
        for background in (0, 0xFFFFFFFF, 0x80402010):
            out = assert_like_cv2(anim([(8, 6, 13, 7, flags, chunk(b"VP8L", lossless)), tail],
                                       30, 20, flags=0x12, background=background), tmp_path)
            assert not out[:6].any() and not out[:, :8].any()  # a canvas of zeros
    assert_like_cv2(anim([(2, 0, 13, 7, 2, chunk(b"ALPH", alph) + chunk(b"VP8 ", vp8_chunk)),
                          tail], 30, 20, flags=0x12), tmp_path)
    out = assert_like_cv2(anim([tail], 30, 20, flags=0x0A,
                               extra=chunk(b"EXIF", assets.exif_tiff(6))), tmp_path)
    assert out.shape[:2] == (30, 20)
    whole = anim([(8, 6, 13, 7, 0, chunk(b"VP8L", lossless)), tail], 30, 20)
    refused = [anim([(20, 0, 13, 7, 0, chunk(b"VP8L", lossless))], 30, 20),
               assets.webp_file(assets.vp8x_chunk(0x12, 30, 20) + chunk(b"ANMF", bytes(16)
                                                                        + chunk(b"VP8L", second))),
               assets.webp_file(assets.vp8x_chunk(0x02, 30, 20) + chunk(b"VP8L", second))]
    refused += [whole[:int(len(whole) * f)] for f in (0.5, 0.97)]
    for data in refused + [whole + bytes(10)]:
        assert_like_cv2(data, tmp_path)


def test_yuv_to_rgb_and_upsampling_follow_libwebp():
    """libwebp's fixed-point conversion at the extremes, and the fancy
    upsampler: a constant plane stays constant, each output sample lies
    between its chroma neighbours, and the edges repeat."""
    y = np.array([0, 16, 128, 235, 255])
    rgb = vp8.yuv_to_rgb(y, np.full(5, 128), np.full(5, 128))
    assert rgb[:, 0].tolist() == [0, 0, 130, 255, 255] and (rgb[:, 0] == rgb[:, 2]).all()
    c = np.full((3, 4), 77)
    assert (webp.decode_vp8 is vp8.decode_vp8) and (vp8._upsample(c, 5, 7) == 77).all()
    c = np.arange(12).reshape(3, 4) * 20
    up = vp8._upsample(c, 6, 8)
    assert up[0, 0] == c[0, 0] and up[-1, -1] == c[-1, -1]
    assert (np.diff(up, axis=1) >= 0).all() and (np.diff(up, axis=0) >= 0).all()


def test_jax_datasets_equal_the_ports_on_webp_and_jpeg_tiff(tmp_path):
    """``RecognitionListDataset`` (every file) and ``LMDBRecognitionDataset``
    (every file's bytes) on lossless, lossy, RGBA, EXIF-turned and animated
    WebP and JPEG-compressed TIFF crops: the JAX package's items (cv2) equal
    the port's bit for bit. (``DetectionICDARDataset`` lists ``.jpg``,
    ``.png`` and ``.jpeg`` files only, in both packages.)"""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDB
    from megreader_tpu_torch.data import datasets
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    rng = np.random.default_rng(360)
    crop = assets.smooth(rng, 30, 70)
    rgba = np.concatenate([crop, rng.integers(0, 256, (30, 70, 1))], -1)
    lossless = assets.webp_payload(assets.cv_encode(".webp", crop[..., ::-1],
                                                    [cv2.IMWRITE_WEBP_QUALITY, 101]), b"VP8L")
    files = {
        "lossless.webp": assets.cv_encode(".webp", crop[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY,
                                                                      101]),
        "lossy.webp": assets.cv_encode(".webp", crop[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 80]),
        "rgba.webp": assets.pil_webp(rgba, "RGBA", quality=75),
        "turned.webp": assets.webp_file(assets.vp8x_chunk(0x08, 70, 30) + assets.riff_chunk(
            b"VP8L", lossless) + assets.riff_chunk(b"EXIF", assets.exif_tiff(8))),
        "animated.webp": assets.pil_webp_animation([crop, crop[::-1]], lossless=True),
        "strips.tif": assets.tiff_jpeg_bytes(crop, tables=True),
        "grey.tif": assets.tiff_jpeg_bytes(crop[..., 0], photometric=1),
    }
    lines, records = [], {b"num-samples": str(len(files)).encode()}
    (tmp_path / "images").mkdir()
    for i, (name, data) in enumerate(sorted(files.items())):
        (tmp_path / "images" / name).write_bytes(data)
        lines.append(f"images/{name}\tword{i}")
        records[f"image-{i + 1:09d}".encode()] = data
        records[f"label-{i + 1:09d}".encode()] = f"word{i}".encode()
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    write_fixture_lmdb(str(tmp_path / "lmdb"), records)
    for ref, got in ((jax_datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                          canvas_hw=(48, 128)),
                      datasets.RecognitionListDataset(str(tmp_path / "list.txt"),
                                                      canvas_hw=(48, 128))),
                     (JaxLMDB(str(tmp_path / "lmdb"), canvas_hw=(48, 128)),
                      LMDBRecognitionDataset(str(tmp_path / "lmdb"), canvas_hw=(48, 128)))):
        assert len(ref) == len(got) == len(files)
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
