"""The port's JPEG 2000 reader (``data/jp2.py`` over ``data/j2k.py``,
``data/ebcot.py`` and ``data/dwt.py``) against cv2 5 bit for bit, through
``read_image`` (``cv2.imread``) and ``decode_image`` (``cv2.imdecode``),
each then ``BGR2RGB``; where cv2 returns None the port raises
``ValueError``.

First the committed JPEG 2000 files of ``assets/images/`` against their
manifest digests; then files made here from seeds: PIL's JP2 and raw
codestreams (grey, grey with alpha, RGB, RGBA, 16-bit grey; 5/3 and 9/7,
with and without the component transform; layers, tiles, precincts,
progressions, code-block sizes, offsets), ``cv2.imencode``'s, libopenjp2's
own encoder through ``ctypes`` (``scripts/openjpeg_ctypes.py``: every
code-block style, SOP/EPH, POC, ROI, tile-parts, PLT/TLM, precisions,
signed and subsampled components, colour spaces), JP2 boxes of the asset
script's writer (palettes, channel definitions, ICC, 64-bit and open
lengths), cut files and files without EOC; then the JAX package's
``RecognitionListDataset`` and ``LMDBRecognitionDataset`` (cv2) against
the port's on JPEG 2000 crops. These tests need cv2, PIL and libopenjp2, so
they run where those are installed."""

import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import imageio, j2k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "images")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_port_image_assets as assets  # noqa: E402

with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FILES = sorted(rel for rel in MANIFEST if rel.endswith((".jp2", ".j2k")))


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("rel", FILES)
def test_committed_jpeg2000_equals_its_manifest_through_both_routes(rel):
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


def test_committed_jpeg2000_files_cover_the_forms_and_the_page():
    names = " ".join(FILES)
    for part in ("jp2_53", "j2k_97", "layers_precincts", "pclr_cdef", "cut"):
        assert part in names, part
    assert "pages/page_97.jp2" in FILES
    assert MANIFEST["pages/page_97.jp2"]["shape"] == [640, 640, 3]


# ------------------------------------------------------- against cv2 itself
def _cv2(data, path=None):
    bgr = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data, tmp_path, name="x.jp2"):
    """Both routes equal cv2's, or both refuse (cv2's None, the port's
    ``ValueError``). Returns the decoded image or None."""
    path = tmp_path / name
    path.write_bytes(data)
    out = None
    for got_fn, ref in ((lambda: imageio.read_image(str(path)), _cv2(data, path)),
                        (lambda: imageio.decode_image(data), _cv2(data))):
        if ref is None:
            with pytest.raises(ValueError):
                got_fn()
            continue
        got = got_fn()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        out = got
    return out


def _smooth(rng, h, w, ch=3, top=256):
    """(h, w, ch) int64, values below ``top``."""
    img = assets.smooth(rng, h, w, ch).astype(np.int64).reshape(h, w, ch)
    if top > 256:
        img = img * (top // 256) + rng.integers(0, top // 256, img.shape)
    return img


PIL_OPTIONS = {
    "53": {},
    "97": dict(irreversible=True),
    "layers": dict(quality_mode="rates", quality_layers=[40, 12, 4]),
    "97_lossy_mct": dict(irreversible=True, mct=1, quality_mode="rates", quality_layers=[12]),
    "raw_codestream": dict(no_jp2=True),
    "tiles": dict(tile_size=(8, 12), num_resolutions=2),
    "precincts_rpcl": dict(progression="RPCL", precinct_size=(16, 16), codeblock_size=(8, 8),
                           num_resolutions=3),
    "pcrl_cblk_4x16": dict(progression="PCRL", codeblock_size=(4, 16), num_resolutions=2),
    "cprl_layers": dict(progression="CPRL", quality_mode="rates", quality_layers=[20, 5]),
    "rlcp_97": dict(progression="RLCP", irreversible=True, num_resolutions=4),
    "offset": dict(offset=(3, 1), tile_size=(64, 64), num_resolutions=3),
    "tile_offset": dict(offset=(5, 6), tile_offset=(1, 2), tile_size=(16, 16)),
    "plt_comment": dict(plt=True, comment="megreader"),
    "1_resolution": dict(num_resolutions=1),
}
PIL_MODES = {"L": (np.uint8, 1), "LA": (np.uint8, 2), "RGB": (np.uint8, 3),
             "RGBA": (np.uint8, 4), "I;16": (np.uint16, 1)}


@pytest.mark.parametrize("mode", sorted(PIL_MODES))
@pytest.mark.parametrize("option", sorted(PIL_OPTIONS))
def test_pil_files_equal_cv2(mode, option, tmp_path):
    """PIL's writer (its bundled OpenJPEG) in each mode and option: JP2
    files in grey (colr 17), sRGB; raw codestreams (grey refused: no colour
    space, one component); offsets (refused: cv2 reads no offset)."""
    rng = np.random.default_rng(sorted(PIL_OPTIONS).index(option) * 8
                                + sorted(PIL_MODES).index(mode))
    dtype, ch = PIL_MODES[mode]
    img = _smooth(rng, 23, 31, ch, 65536 if dtype == np.uint16 else 256).astype(dtype)
    data = assets.pil_jpeg2000(img[..., 0] if ch == 1 else img, **PIL_OPTIONS[option])
    got = assert_like_cv2(data, tmp_path, "x.j2k" if option == "raw_codestream" else "x.jp2")
    refused = "offset" in option or (option == "raw_codestream" and ch < 3)
    assert (got is None) == refused
    if option == "53" and not refused:  # lossless: the pixels themselves
        want = img >> 8 if dtype == np.uint16 else img
        want = np.repeat(want[..., :1] if want.ndim == 3 else want[..., None], 3, -1) \
            if ch < 3 else want[..., :3]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", [1000, 400, 60])
def test_cv2_encoded_files_equal_cv2(compression, tmp_path):
    rng = np.random.default_rng(compression)
    for img in (_smooth(rng, 40, 37, 3), _smooth(rng, 40, 37, 1)):
        data = assets.cv_encode(".jp2", img.astype(np.uint8),
                                [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, compression])
        assert assert_like_cv2(data, tmp_path) is not None


OPENJPEG = {  # libopenjp2's encoder options a case (scripts/openjpeg_ctypes.py)
    **{f"style_{m}": dict(mode=m, cblockw_init=16, cblockh_init=8, rates=[10, 3, 0])
       for m in (1, 2, 4, 8, 16, 32, 5, 40, 63)},
    **{f"style_{m}_97": dict(mode=m, irreversible=1, rates=[16, 6]) for m in (1, 8, 63)},
    "sop_eph": dict(csty=6, rates=[20, 0], precincts=[(16, 16), (8, 8)]),
    "sop": dict(csty=2, prog_order="PCRL"),
    "eph_cprl": dict(csty=4, prog_order="CPRL", rates=[8, 0]),
    "poc": dict(rates=[30, 10, 0], pocs=[dict(resno0=0, compno0=0, layno1=3, resno1=3,
                                              compno1=3, prg="CPRL")]),
    "poc_two": dict(rates=[30, 10, 0], pocs=[
        dict(resno0=0, compno0=0, layno1=2, resno1=2, compno1=3, prg="RLCP"),
        dict(resno0=0, compno0=0, layno1=3, resno1=3, compno1=3, prg="LRCP")]),
    "roi": dict(roi_compno=0, roi_shift=5, rates=[20]),
    "roi_97": dict(roi_compno=1, roi_shift=3, irreversible=1, rates=[10]),
    **{f"tile_parts_{f}": dict(tile_parts=f, rates=[30, 10, 0], tile_size_on=1, cp_tdx=16,
                               cp_tdy=16) for f in "RLC"},
    "plt_tlm": dict(extra=["PLT=YES", "TLM=YES"], tile_size_on=1, cp_tdx=12, cp_tdy=20),
    "mct_97": dict(irreversible=1, tcp_mct=1),
    "mct_53": dict(tcp_mct=1),
    "no_mct_97": dict(irreversible=1, tcp_mct=0, rates=[6]),
    **{f"cblk_{w}x{h}": dict(cblockw_init=w, cblockh_init=h, irreversible=1, rates=[4])
       for w, h in ((4, 4), (4, 64), (64, 4), (32, 8), (64, 64))},
    **{f"resolutions_{n}": dict(numresolution=n, irreversible=1, rates=[5]) for n in (1, 2, 5)},
    "precincts_small": dict(precincts=[(8, 8), (4, 4), (4, 4)], cblockw_init=4, cblockh_init=4,
                            prog_order="RPCL", rates=[10, 0]),
}


@pytest.mark.parametrize("case", sorted(OPENJPEG))
def test_openjpeg_encoder_variants_equal_cv2(case, tmp_path):
    """libopenjp2's own encoder through ctypes, an RGB image at 25x29 as a
    JP2 file (sRGB) and as a raw codestream."""
    rng = np.random.default_rng(sorted(OPENJPEG).index(case))
    planes = list(np.moveaxis(_smooth(rng, 29, 25, 3), -1, 0))
    kw = {"numresolution": 3, **OPENJPEG[case]}
    for jp2 in (True, False):
        data = assets.openjpeg(planes, jp2=jp2, colour_space=1 if jp2 else 0, **kw)
        assert assert_like_cv2(data, tmp_path, "x.jp2" if jp2 else "x.j2k") is not None


COMPONENTS = {  # name -> (components, colour space, precision, signed, sampling, offset)
    **{f"space_{s}_{n}": (n, s, 8, False, None, (0, 0)) for s in (0, 1, 2, 3, 4, 5)
       for n in (1, 2, 3, 4)},
    "five": (5, 1, 8, False, None, (0, 0)),
    **{f"precision_{p}": (3, 1, p, False, None, (0, 0)) for p in (4, 7, 9, 12, 16, 20)},
    **{f"grey_precision_{p}": (1, 2, p, False, None, (0, 0)) for p in (1, 10, 15)},
    "mixed_precisions": (3, 1, [12, 8, 4], False, None, (0, 0)),
    "signed": (3, 1, 8, True, None, (0, 0)),
    "signed_grey_12": (1, 2, 12, True, None, (0, 0)),
    "subsampled_chroma": (3, 3, 8, False, [(1, 1), (2, 2), (2, 2)], (0, 0)),
    "subsampled_all": (3, 1, 8, False, [(2, 1)] * 3, (0, 0)),
    **{f"offset_{x}_{y}": (3, 1, 8, False, None, (x, y)) for x, y in ((1, 0), (0, 1), (7, 5))},
}


@pytest.mark.parametrize("case", sorted(COMPONENTS))
def test_components_colour_spaces_and_precisions_equal_cv2(case, tmp_path):
    """Components as cv2 takes them: 1-4 (5 refused), unsigned (signed
    refused), the widest at least 8 bits (shifted down to 8), no offset or
    subsampling; grey, sRGB, unspecified, sYCC (cv2's YUV conversion),
    eYCC and CMYK (refused) colour spaces of JP2 files, and the raw
    codestream's unspecified one."""
    n, space, prec, signed, sampling, offset = COMPONENTS[case]
    rng = np.random.default_rng(sorted(COMPONENTS).index(case))
    precs = prec if isinstance(prec, list) else [prec] * n
    sampling = sampling or [(1, 1)] * n
    planes = []
    for p, (dx, dy) in zip(precs, sampling):
        h, w = -(-(19 + offset[1]) // dy) - -(-offset[1] // dy), \
            -(-(23 + offset[0]) // dx) - -(-offset[0] // dx)
        v = _smooth(rng, h, w, 1, 65536)[..., 0] >> (16 - p) if p <= 16 else \
            rng.integers(0, 1 << p, (h, w))
        planes.append(v - (1 << (p - 1)) if signed else v)
    for jp2 in (True, False):
        data = assets.openjpeg(planes, jp2=jp2, prec=precs, signed=signed, sampling=sampling,
                               offset=offset, colour_space=space, numresolution=2)
        assert_like_cv2(data, tmp_path, "x.jp2" if jp2 else "x.j2k")


def _palette_codestream(rng, entries, prec=8):
    return assets.openjpeg([rng.integers(0, entries + 2, (13, 7))], prec=prec, numresolution=2)


BOXES = {  # name -> a function of rng giving a JP2 file
    "pclr_rgb": lambda r: assets.jp2_file(_palette_codestream(r, 6), 16, pclr=(
        r.integers(0, 256, (6, 3)), [8, 8, 8]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
    "pclr_without_cmap": lambda r: assets.jp2_file(_palette_codestream(r, 6), 16, pclr=(
        r.integers(0, 256, (6, 3)), [8, 8, 8])),
    "pclr_16_bit_entries": lambda r: assets.jp2_file(_palette_codestream(r, 6), 16, pclr=(
        r.integers(0, 65536, (6, 3)), [16, 16, 16]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
    "pclr_signed_entries": lambda r: assets.jp2_file(_palette_codestream(r, 6), 16, pclr=(
        r.integers(-128, 128, (6, 3)), [-8, -8, -8]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
    "pclr_grey": lambda r: assets.jp2_file(_palette_codestream(r, 9), 17, pclr=(
        r.integers(0, 256, (9, 1)), [8]), cmap=[(0, 1, 0)]),
    "pclr_4_bit_index": lambda r: assets.jp2_file(_palette_codestream(r, 6, 4), 16, pclr=(
        r.integers(0, 256, (6, 3)), [8, 8, 8]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
    "pclr_column_mapped_twice": lambda r: assets.jp2_file(_palette_codestream(r, 6), 16, pclr=(
        r.integers(0, 256, (6, 3)), [8, 8, 8]), cmap=[(0, 1, 0), (0, 1, 0), (0, 1, 2)]),
    "cdef_reversed": lambda r: assets.jp2_file(_rgb(r, 3), 16, cdef=[(0, 0, 3), (1, 0, 2),
                                                                     (2, 0, 1)]),
    "cdef_rotated": lambda r: assets.jp2_file(_rgb(r, 3), 16, cdef=[(0, 0, 2), (1, 0, 3),
                                                                    (2, 0, 1)]),
    "cdef_alpha_first": lambda r: assets.jp2_file(_rgb(r, 4), 16, cdef=[
        (0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]),
    "cdef_incomplete": lambda r: assets.jp2_file(_rgb(r, 3), 16, cdef=[(0, 0, 1), (1, 0, 2)]),
    "cdef_sycc": lambda r: assets.jp2_file(_rgb(r, 3), 18, cdef=[(0, 0, 1), (2, 0, 3),
                                                                 (1, 0, 2)]),
    "icc_profile": lambda r: assets.jp2_file(_rgb(r, 3), bytes(r.integers(0, 256, 132))),
    "lab_enumerated": lambda r: assets.jp2_file(_rgb(r, 3), 14),
    "xl_box": lambda r: assets.jp2_file(_rgb(r, 3), 16, xl=True),
    "box_to_end": lambda r: assets.jp2_file(_rgb(r, 1), 17, to_end=True),
    "other_boxes": lambda r: assets.jp2_file(_rgb(r, 3), 16, before=[
        assets.jp2_box(b"xml ", b"<x/>")], inside=[assets.jp2_box(b"res ", assets.jp2_box(
            b"resc", bytes(10)))]),
    "two_colr": lambda r: assets.jp2_file(_rgb(r, 3), 17, inside=[assets.jp2_box(
        b"colr", b"\x01\x00\x00\x00\x00\x00\x10")]),
    "trailing_bytes": lambda r: assets.jp2_file(_rgb(r, 3), 16) + b"after the codestream",
}


def _rgb(rng, n):
    return assets.openjpeg(list(np.moveaxis(_smooth(rng, 13, 7, 4)[..., :n], -1, 0)),
                           numresolution=2, irreversible=1, rates=[3])


@pytest.mark.parametrize("case", sorted(BOXES))
def test_jp2_boxes_equal_cv2(case, tmp_path):
    """The box writer's JP2 files: palettes (OpenJPEG maps them; cv2 casts
    entries past 8 bits to their low byte), channel definitions (OpenJPEG
    reorders the channels), ICC and Lab colour specifications (cv2 then
    assumes sRGB), 64-bit and open box lengths, boxes it skips."""
    rng = np.random.default_rng(sorted(BOXES).index(case))
    assert_like_cv2(BOXES[case](rng), tmp_path)


@pytest.mark.parametrize("cut", [0.1, 0.3, 0.6, 0.9, 0.97])
def test_cut_files_and_files_without_eoc_are_refused(cut, tmp_path):
    """cv2 refuses a JP2 or raw codestream cut anywhere, and a codestream
    without its EOC marker (OpenJPEG decodes strictly): the port raises
    ``ValueError`` on each."""
    rng = np.random.default_rng(int(cut * 100))
    planes = list(np.moveaxis(_smooth(rng, 30, 41, 3), -1, 0))
    for data in (assets.openjpeg(planes, jp2=True, colour_space=1, numresolution=3),
                 assets.openjpeg(planes, numresolution=3, rates=[10, 0])):
        for bad in (data[:int(len(data) * cut)], data[:-2]):
            assert assert_like_cv2(bad, tmp_path, "x.jp2") is None


@pytest.mark.parametrize("seed", range(4))
def test_damaged_files_follow_cv2(seed):
    """One to three random bytes changed in PIL's and libopenjp2's files
    (SOP/EPH, every code-block style, layers, a raw codestream): the port
    reads what cv2 reads, bit for bit, and raises ``ValueError`` where it
    returns None (or ``NotImplementedError`` where a changed byte names a
    format or an HT code-block). OpenJPEG's strict rules show here: its
    marker places, the JP2 header's size against SIZ, the two bytes after
    the last tile-part, EPH, QCD's lengths, Scod's bits."""
    rng = np.random.default_rng(seed)
    img = _smooth(rng, 21, 30).astype(np.uint8)
    bases = [assets.pil_jpeg2000(img, num_resolutions=3),
             assets.pil_jpeg2000(img, num_resolutions=3, irreversible=True, quality_mode="rates",
                                 quality_layers=[20, 5]),
             assets.pil_jpeg2000(img, num_resolutions=3, no_jp2=True, progression="PCRL"),
             assets.openjpeg(list(np.moveaxis(img, -1, 0)), numresolution=3, mode=63, csty=6,
                             rates=[10, 0])]
    for i in range(40):
        data = bytearray(bases[i % len(bases)])
        for _ in range(rng.integers(1, 4)):
            data[rng.integers(0, len(data))] = rng.integers(0, 256)
        data = bytes(data)
        ref = _cv2(data)
        try:
            got = imageio.decode_image(data)
        except ValueError:
            assert ref is None, i
            continue
        except NotImplementedError:
            assert ref is None, i
            continue
        assert ref is not None, i
        np.testing.assert_array_equal(got, ref)


def test_what_no_encoder_here_writes_is_refused_by_name():
    """Packed packet headers (PPM, PPT) and HTJ2K's HT code-blocks:
    ``NotImplementedError`` naming them."""
    rng = np.random.default_rng(3)
    data = assets.openjpeg([_smooth(rng, 16, 16, 1)[..., 0]], numresolution=2)
    cod = data.index(b"\xff\x52")
    ppm = data[:cod] + assets.segment(0x60, b"\x00" + bytes(8)) + data[cod:]
    sot = data.index(b"\xff\x90")
    sod = data.index(b"\xff\x93", sot)
    ppt = bytearray(data[:sod] + assets.segment(0x61, b"\x00" + bytes(4)) + data[sod:])
    ppt[sot + 6:sot + 10] = (int.from_bytes(data[sot + 6:sot + 10], "big") + 9).to_bytes(4, "big")
    ht = bytearray(data)
    ht[cod + 12] |= 0x40  # SPcod's code-block style: HT
    for bad, what in ((ppm, "PPM"), (bytes(ppt), "PPT"), (bytes(ht), "HT code-blocks")):
        with pytest.raises(NotImplementedError, match=what):
            imageio.decode_image(bad)


def test_the_codestream_reader_names_damage():
    rng = np.random.default_rng(4)
    data = assets.openjpeg([_smooth(rng, 16, 16, 1)[..., 0]] * 3, numresolution=2)
    assert j2k.decode_codestream(data[:-2] + b"\xff\xd8").comps  # two last bytes: read
    for bad, what in ((data[:20], "cut inside its headers|runs past"),
                      (data.replace(b"\xff\x52", b"\xff\x30", 1), "without COD"),
                      (data[:-2] + b"\xff\xd8\0\0", "expected SOT or EOC"),
                      (data[:-2] + b"\xff", "ends without EOC")):
        with pytest.raises(ValueError, match=what):
            j2k.decode_codestream(bad)


# ------------------------------------------------------- the JAX datasets
def test_jax_datasets_equal_the_ports_on_jpeg2000_crops(tmp_path):
    """``RecognitionListDataset`` (``cv2.imread``) and
    ``LMDBRecognitionDataset`` (``cv2.imdecode``): the JAX package's items
    equal the port's bit for bit on JP2 files (PIL's grey, RGB and 16-bit
    grey, 5/3 and 9/7, a palette) and raw codestreams."""
    from megreader_tpu.data import datasets as jax_datasets
    from megreader_tpu.data.lmdb_dataset import LMDBRecognitionDataset as JaxLMDB
    from megreader_tpu_torch.data import datasets
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    rng = np.random.default_rng(11)
    files = {
        "grey_53.jp2": assets.pil_jpeg2000(_smooth(rng, 31, 90, 1)[..., 0].astype(np.uint8)),
        "rgb_97.jp2": assets.pil_jpeg2000(_smooth(rng, 40, 70).astype(np.uint8),
                                          irreversible=True, quality_mode="rates",
                                          quality_layers=[8]),
        "grey_16.jp2": assets.pil_jpeg2000(
            _smooth(rng, 24, 61, 1, 65536)[..., 0].astype(np.uint16), irreversible=True),
        "rgb.j2k": assets.pil_jpeg2000(_smooth(rng, 33, 51).astype(np.uint8), no_jp2=True,
                                       progression="RPCL", precinct_size=(16, 16),
                                       num_resolutions=3),
        "palette.jp2": BOXES["pclr_rgb"](rng),
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
