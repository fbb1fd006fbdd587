"""The port's JPEG decoder (``data/jpeg.py``) on the files beyond one
interleaved YCbCr or grey scan, against cv2 5 (libjpeg-turbo 3.1) bit for
bit, through ``read_image`` (``cv2.imread``) and ``decode_image``
(``cv2.imdecode``): RGB-coded files, CMYK and YCCK, multi-scan sequential
files, marker segments after the scan, and files without EOI, which the two
routes read differently. Files come from cv2, PIL and
``scripts/make_port_image_assets.py``'s writers (its Huffman writer for
multi-scan files, byte patches for Adobe segments and component ids). These
tests need cv2 and PIL, so they run where those are installed."""

import os
import sys

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio
from megreader_tpu_torch.data.jpeg import cmyk_to_rgb, decode_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (7, 13), (33, 50), (37, 100)]


def _cv2(data, path=None):
    bgr = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path):
    """Both routes: the port equals cv2, or both refuse (cv2's None, the
    port's ``ValueError``). Returns (file route, bytes route), None where
    refused."""
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    out = []
    for got_fn, ref in ((lambda: imageio.read_image(str(path)), _cv2(data, path)),
                        (lambda: imageio.decode_image(data), _cv2(data))):
        if ref is None:
            with pytest.raises(ValueError):
                got_fn()
            out.append(None)
            continue
        got = got_fn()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        out.append(got)
    return out


def _ycc(rng, h, w, sampling, params=()):
    return assets.cv_encode(".jpg", assets.smooth(rng, h, w), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling], *params])


# ------------------------------------------------------------- RGB-coded
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_rgb_coded_files_equal_cv2(sampling, tmp_path):
    """A cv2 file's components taken as R, G, B (no YCbCr transform) by an
    Adobe segment of transform 0 or by the ids 'R', 'G', 'B' without JFIF,
    at every sampling; a JFIF segment wins over both (YCbCr)."""
    rng = np.random.default_rng(int(sampling))
    for h, w in SIZES:
        ycc = _ycc(rng, h, w, sampling)
        plain = assert_like_cv2(ycc, tmp_path)[0]
        by_adobe = assert_like_cv2(assets.with_adobe_transform(
            assets.without(ycc, 0xE0, b"JFIF"), 0), tmp_path)[0]
        by_ids = assert_like_cv2(assets.with_component_ids(
            assets.without(ycc, 0xE0, b"JFIF"), b"RGB"), tmp_path)[0]
        np.testing.assert_array_equal(by_adobe, by_ids)
        np.testing.assert_array_equal(assert_like_cv2(assets.with_adobe_transform(ycc, 0),
                                                      tmp_path)[0], plain)  # JFIF kept
        if h > 1:
            assert not np.array_equal(by_adobe, plain)


def test_pil_keep_rgb_files_equal_cv2(tmp_path):
    rng = np.random.default_rng(3)
    for h, w in SIZES:
        for quality in (75, 95):
            assert_like_cv2(assets.pil_jpeg(assets.smooth(rng, h, w), "RGB", keep_rgb=True,
                                            quality=quality, subsampling=0), tmp_path)


# ------------------------------------------------------------ CMYK, YCCK
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_cmyk_and_ycck_equal_cv2(subsampling, tmp_path):
    """PIL's CMYK files (Adobe transform 0, inverted inks), the same without
    their Adobe segment (still CMYK), and with transform 2 (YCCK: libjpeg's
    YCC -> RGB, inks 255 - RGB, K as coded), then cv2's own conversion."""
    rng = np.random.default_rng(subsampling)
    for h, w in SIZES:
        for quality in (60, 95):
            data = assets.pil_jpeg(assets.smooth(rng, h, w, 4), "CMYK", quality=quality,
                                   subsampling=subsampling)
            cmyk = assert_like_cv2(data, tmp_path)[0]
            np.testing.assert_array_equal(assert_like_cv2(
                assets.without(data, 0xEE, b"Adobe"), tmp_path)[0], cmyk)
            ycck = assert_like_cv2(assets.with_adobe_transform(data, 2), tmp_path)[0]
            assert ycck.shape == cmyk.shape


def test_cmyk_conversion_is_cv2s_integer_formula(tmp_path):
    """Flat colours and ramps at quality 100: each of R, G, B is
    ``k - ((255 - s) * k >> 8)`` of its decoded ink sample s and K (probed:
    cv2's ``icvCvt_CMYK2BGR_8u_C4C3R``), with PIL's inverted inks written
    as they are."""
    for colour in ((0, 0, 0, 0), (255, 255, 255, 255), (30, 200, 90, 60), (255, 0, 128, 0)):
        data = assets.pil_jpeg(np.broadcast_to(np.array(colour, np.uint8), (16, 16, 4)), "CMYK",
                               quality=100, subsampling=0)
        got = assert_like_cv2(data, tmp_path)[0]
        inks = 255 - np.array(colour)  # PIL writes Adobe's inverted inks
        want = cmyk_to_rgb(*(np.full((16, 16), v) for v in inks))
        assert np.abs(got.astype(int) - want).max() <= 1  # the DCT's rounding, flat blocks
    ramp = np.stack(np.meshgrid(np.arange(32) * 8, np.arange(32) * 8), -1)
    assert_like_cv2(assets.pil_jpeg(np.concatenate([ramp, 255 - ramp], -1), "CMYK",
                                    quality=100, subsampling=0), tmp_path)
    s, k = np.arange(256)[:, None], np.arange(256)[None, :]
    rgb = cmyk_to_rgb(s, s, s, k)
    np.testing.assert_array_equal(rgb[..., 0], k - ((255 - s) * k >> 8))


# ------------------------------------------------------------ multi-scan
GROUPS = {"one_each": [[0], [1], [2]], "chroma_first": [[1, 2], [0]], "split": [[0, 2], [1]],
          "reversed": [[2], [1], [0]], "luma_then_pair": [[0], [1, 2]]}


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("sampling", ["444", "420", "411"])
def test_multiscan_sequential_files_equal_cv2(groups, sampling, tmp_path):
    """A cv2 file's coefficients written again as one scan for each group
    of components (non-interleaved scans cover a component's own blocks),
    with and without restart intervals: equal to cv2, and to the one-scan
    file they came from."""
    rng = np.random.default_rng(len(groups) + int(sampling))
    for h, w in SIZES:
        data = _ycc(rng, h, w, sampling)
        want = assert_like_cv2(data, tmp_path)[0]
        for restart in (0, 2):
            got = assert_like_cv2(assets.jpeg_rescan(data, GROUPS[groups], restart), tmp_path)
            np.testing.assert_array_equal(got[0], want)


def test_multiscan_cmyk_grey_and_tables_between_scans(tmp_path):
    rng = np.random.default_rng(8)
    cmyk = assets.pil_jpeg(assets.smooth(rng, 33, 50, 4), "CMYK", quality=90, subsampling=2)
    assert_like_cv2(assets.jpeg_rescan(cmyk, [[0, 1], [2], [3]]), tmp_path)
    assert_like_cv2(assets.jpeg_rescan(cmyk, [[3], [0], [1], [2]], 1), tmp_path)
    grey = assets.cv_encode(".jpg", assets.smooth(rng, 37, 100, 1))
    assert_like_cv2(assets.jpeg_rescan(grey, [[0]], 3), tmp_path)
    # a comment, the tables again and a restart interval between two scans
    data = assets.jpeg_rescan(_ycc(rng, 33, 50, "420"), [[0], [1, 2]])
    second = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    dqt = [data[a:b] for m, a, b in assets.jpeg_segments(data) if m == 0xDB][0]
    extra = assets.segment(0xFE, b"between") + dqt + assets.segment(0xDD, b"\0\0")
    assert_like_cv2(data[:second] + extra + data[second:], tmp_path)


# ------------------------------------------------------ after the scan
@pytest.mark.parametrize("kind", ["baseline", "grey", "progressive", "multiscan"])
def test_segments_after_the_last_scan_equal_cv2(kind, tmp_path):
    """COM, APPn, DQT, DHT and DRI segments between the last scan and EOI.
    After one scan of every component cv2 reads nothing more: a second SOS
    or SOF there, or a segment cut short, leaves the image as it is."""
    rng = np.random.default_rng(len(kind))
    img = assets.smooth(rng, 33, 50, 1 if kind == "grey" else 3)
    base = assets.cv_encode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                          int(kind == "progressive")])
    if kind == "multiscan":
        base = assets.jpeg_rescan(base, [[0], [1, 2]])
    want = assert_like_cv2(base, tmp_path)[0]
    segs = assets.jpeg_segments(base)
    dqt, dht = ([base[a:b] for m, a, b in segs if m == marker][0] for marker in (0xDB, 0xC4))
    for tail in (assets.segment(0xFE, b"a comment"), assets.segment(0xE1, b"XMP\0x"),
                 assets.segment(0xEC, b"Ducky"), dqt + dht, assets.segment(0xDD, b"\0\5")):
        got = assert_like_cv2(assets.before_eoi(base, tail), tmp_path)
        np.testing.assert_array_equal(got[0], want)
    if kind in ("baseline", "grey"):
        sos = [base[a:b] for m, a, b in segs if m == 0xDA][0]
        sof = [base[a:b] for m, a, b in segs if m == 0xC0][0]
        for tail in (sos + b"\0" * 8, sof):
            np.testing.assert_array_equal(assert_like_cv2(assets.before_eoi(base, tail),
                                                          tmp_path)[0], want)
        np.testing.assert_array_equal(assert_like_cv2(
            base[:-2] + assets.segment(0xFE, b"cut")[:5], tmp_path)[1], want)


# ------------------------------------------------------------ without EOI
def test_files_without_eoi_follow_each_route(tmp_path):
    """``cv2.imread`` (libjpeg's stdio source supplies an EOI) decodes a
    file whose last scan runs to its end equal to the whole file;
    ``cv2.imdecode`` (cv2's memory source cannot) decodes a single-scan one
    only where libjpeg-turbo's bit reader reaches the last MCU without
    asking for more, and no multi-scan or progressive one. 120 seeded
    files, restart intervals in a third of them."""
    rng = np.random.default_rng(23)
    by_bytes = 0
    for t in range(120):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if t % 2
               else assets.smooth(rng, h, w))
        if t % 5 == 0:
            img = img[..., 0]
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(30, 101)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, list(SAMPLINGS.values())[t % 5]]
        if t % 3 == 0:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.integers(1, 6))]
        data = assets.cv_encode(".jpg", img, params)
        whole = _cv2(data)
        from_file, from_bytes = assert_like_cv2(data[:-2], tmp_path)
        np.testing.assert_array_equal(from_file, whole)
        by_bytes += from_bytes is not None
    for grey, params in ((False, []), (True, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])):
        from_file, from_bytes = assert_like_cv2(assets.reached_without_eoi(rng, params, grey),
                                                tmp_path)
        np.testing.assert_array_equal(from_bytes, from_file)
    assert 0 < by_bytes < 60
    prog = assets.cv_encode(".jpg", assets.smooth(rng, 33, 50), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    multi = assets.jpeg_rescan(_ycc(rng, 33, 50, "420"), [[0], [1, 2]])
    for data in (prog, multi):
        from_file, from_bytes = assert_like_cv2(data[:-2], tmp_path)
        np.testing.assert_array_equal(from_file, _cv2(data))
        assert from_bytes is None
        with pytest.raises(ValueError, match="truncated JPEG: .* without EOI"):
            decode_jpeg(data[:-2])


FRAMES = {  # name -> (planes (h, w, top or offset), precision, SOF, sampling, Adobe transform)
    "2_components": ([(16, 24)] * 2, 8, 0xC0, None, None),
    "2_components_adobe": ([(16, 24)] * 2, 8, 0xC0, None, 0),
    "2_components_2x2_1x1": ([(32, 32), (16, 16)], 8, 0xC0, [(2, 2), (1, 1)], None),
    "5_components": ([(16, 24)] * 5, 8, 0xC0, None, None),
    "5_components_adobe": ([(16, 24)] * 5, 8, 0xC1, None, 2),
    "12_bit_sof0": ([(16, 24)] * 3, 12, 0xC0, None, None),
    "12_bit_sof1": ([(16, 24)] * 3, 12, 0xC1, None, None),
    "12_bit_grey_sof1": ([(16, 24)], 12, 0xC1, None, None),
    "16_bit_sof1": ([(16, 24)], 16, 0xC1, None, None),
}


def _frame_file(rng, name):
    shapes, precision, sof, sampling, transform = FRAMES[name]
    planes = [assets.smooth(rng, h, w, 1).astype(np.int64) for h, w in shapes]
    if precision == 12:
        planes = [p * 16 + rng.integers(0, 16, p.shape) for p in planes]
    elif precision == 16:  # near mid-range, so the flat tables' 15 DC sizes hold the blocks
        planes = [32000 + p * 4 for p in planes]
    return assets.jpeg_frame_file(planes, precision, sof, sampling, transform)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_cv2_refuses_raise_value_error(name, tmp_path):
    """Hand-made files with real content (the asset script's Huffman
    writer): 2 and 5 components, with an Adobe segment or without, 12-bit
    and 16-bit samples. cv2 returns None through both routes; the port
    raises ``ValueError`` naming what it met."""
    data = _frame_file(np.random.default_rng(sorted(FRAMES).index(name)), name)
    assert assert_like_cv2(data, tmp_path) == [None, None]
    what = f"{FRAMES[name][1]}-bit" if FRAMES[name][1] != 8 else f"{len(FRAMES[name][0])} comp"
    with pytest.raises(ValueError, match=what):
        decode_jpeg(data)


def test_frame_writer_makes_files_cv2_reads(tmp_path):
    """The same writer's 8-bit grey and three-component files are read, by
    cv2 and the port alike, so the refusals above come from what the frames
    hold."""
    rng = np.random.default_rng(31)
    for planes in ([assets.smooth(rng, 16, 24, 1)],
                   [assets.smooth(rng, 16, 24, 1) for _ in range(3)]):
        data = assets.jpeg_frame_file([p.astype(np.int64) for p in planes])
        assert all(img is not None for img in assert_like_cv2(data, tmp_path))


def test_refusals_name_what_they_met(tmp_path):
    rng = np.random.default_rng(9)
    data = _ycc(rng, 16, 16, "444")
    twice = assets.jpeg_rescan(data, [[0], [1], [2], [1]])
    with pytest.raises(NotImplementedError, match="codes component 2 in two scans"):
        decode_jpeg(twice)
    sof = data.index(b"\xff\xc0")
    two = bytearray(data)
    two[sof + 9] = 2
    assert assert_like_cv2(bytes(two), tmp_path) == [None, None]  # cv2 refuses: ValueError
    with pytest.raises(ValueError, match="2 components"):
        decode_jpeg(bytes(two))
    cut = _ycc(rng, 64, 80, "420")
    # cut inside the scan: cv2.imread greys the rest (test_torch_port_jpeg_cut.py holds
    # many more), cv2.imdecode refuses it
    for end in (len(cut) // 2, len(cut) - 40):
        from_file, _ = assert_like_cv2(cut[:end], tmp_path)
        np.testing.assert_array_equal(decode_jpeg(cut[:end], from_file=True), from_file)
        with pytest.raises(ValueError, match="truncated"):
            decode_jpeg(cut[:end])
