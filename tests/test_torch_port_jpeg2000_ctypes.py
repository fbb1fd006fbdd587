"""The port's JPEG 2000 codestream decoder (``data/j2k.py``: tier-2,
``data/ebcot.py``'s tier-1, ``data/dwt.py``'s transforms) against
libopenjp2's own decode, component plane by component plane, before any
step to 8 bits: the samples ``opj_decode`` leaves (int32, clamped to each
component's precision), through ``ctypes`` (``scripts/openjpeg_ctypes.py``).

Each codestream is made by libopenjp2's encoder and decoded by both copies
of the library here (Pillow's bundled 2.5.4 and the system's 2.5.0; cv2
itself carries 2.5.3 and is the judge in ``test_torch_port_jpeg2000.py``).
The cases: sizes from 1x1 up with odd image and tile offsets (which move
the parity of each lifting step), component subsampling, signed and 1-16
bit components, 5/3 and 9/7 with and without the component transform,
1-6 resolutions, code-blocks of 4x4 to 64x64 and non-square, precincts,
the five progression orders and POC, layers, tiles and tile-parts, every
code-block style, SOP/EPH, PLT/TLM, COM and ROI. These tests need
libopenjp2 (Pillow's), so they run where it is installed."""

import os
import sys

import numpy as np
import pytest

from megreader_tpu_torch.data import dwt, ebcot, j2k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import openjpeg_ctypes as opj  # noqa: E402

LIBS = opj.candidates()


def _planes(rng, n, h, w, prec=8, signed=False, sampling=None, offset=(0, 0)):
    """Smooth planes with noise, each the size the grid gives its component."""
    out = []
    for dx, dy in sampling or [(1, 1)] * n:
        ch = -(-(h + offset[1]) // dy) - -(-offset[1] // dy)
        cw = -(-(w + offset[0]) // dx) - -(-offset[0] // dx)
        y, x = np.mgrid[:ch, :cw]
        top = 1 << prec
        v = top / 2 + top / 3 * np.sin(x / 3.1 + rng.random() * 6) * np.cos(y / 4.3)
        v = np.clip(v + rng.normal(0, top / 24, v.shape), 0, top - 1).astype(np.int64)
        out.append(v - top // 2 if signed else v)
    return out


def assert_planes_equal_libopenjp2(data):
    """Every component's samples, sampling and precision equal each
    library's decode; returns the port's image."""
    got = j2k.decode_codestream(data)
    for path in LIBS:
        want = opj.decode(data, lib=opj.library(path))
        assert (got.x0, got.y0, got.x1, got.y1) == (want["x0"], want["y0"], want["x1"], want["y1"])
        assert len(got.comps) == len(want["comps"])
        for (dx, dy, prec, signed, plane), comp in zip(got.comps, want["comps"]):
            assert (dx, dy, prec, int(signed)) == (comp["dx"], comp["dy"], comp["prec"],
                                                   comp["sgnd"]), path
            np.testing.assert_array_equal(plane, comp["plane"], err_msg=path)
    return got


CASES = {  # name -> (components, h, w, planes' options, encoder options)
    **{f"size_{h}x{w}": (1, h, w, {}, dict(numresolution=1)) for h, w in
       ((1, 1), (1, 9), (9, 1), (2, 3), (5, 4))},
    **{f"size_{h}x{w}_97": (3, h, w, {}, dict(numresolution=1, irreversible=1, tcp_mct=1))
       for h, w in ((1, 1), (3, 2), (7, 1))},
    **{f"offset_{x}_{y}_{t}": (3, 21, 18, dict(offset=(x, y)),
                               dict(numresolution=4, irreversible=int(t == "97"),
                                    tcp_mct=1, rates=[6] if t == "97" else [0]))
       for x, y in ((1, 0), (0, 1), (3, 5), (1, 1), (6, 2)) for t in ("53", "97")},
    "tiles_offset_odd": (3, 30, 27, dict(offset=(5, 3)), dict(
        numresolution=3, tile_size_on=1, cp_tdx=8, cp_tdy=11, cp_tx0=1, cp_ty0=2,
        irreversible=1)),
    "tiles_53": (1, 29, 33, {}, dict(numresolution=2, tile_size_on=1, cp_tdx=16, cp_tdy=8)),
    "subsampled_420": (3, 22, 19, dict(sampling=[(1, 1), (2, 2), (2, 2)]), dict(numresolution=3)),
    "subsampled_odd_offset": (3, 17, 20, dict(sampling=[(1, 1), (2, 1), (1, 3)], offset=(3, 1)),
                              dict(numresolution=2, irreversible=1)),
    "signed_53": (2, 19, 23, dict(signed=True), dict(numresolution=3)),
    "signed_97_12": (1, 19, 23, dict(signed=True, prec=12), dict(numresolution=3,
                                                                 irreversible=1)),
    **{f"precision_{p}": (1, 17, 21, dict(prec=p), dict(numresolution=3)) for p in
       (1, 2, 5, 10, 12, 16)},
    "precision_12_97": (3, 17, 21, dict(prec=12), dict(numresolution=3, irreversible=1,
                                                       rates=[8])),
    **{f"resolutions_{n}_{t}": (1, 40, 36, {}, dict(numresolution=n, irreversible=t == "97"))
       for n in (1, 2, 4, 6) for t in ("53", "97")},
    **{f"cblk_{w}x{h}": (1, 44, 38, {}, dict(numresolution=3, cblockw_init=w, cblockh_init=h))
       for w, h in ((4, 4), (8, 4), (4, 32), (16, 64), (64, 64), (64, 16))},
    **{f"progression_{p}": (3, 33, 26, {}, dict(
        numresolution=3, prog_order=p, rates=[30, 8, 0], precincts=[(16, 16), (8, 8), (4, 4)],
        cblockw_init=4, cblockh_init=4)) for p in opj.PROGRESSIONS},
    **{f"progression_{p}_subsampled": (3, 33, 26, dict(sampling=[(1, 1), (2, 2), (2, 1)]), dict(
        numresolution=3, prog_order=p, precincts=[(8, 8), (4, 4)], cblockw_init=4,
        cblockh_init=4)) for p in ("RPCL", "PCRL", "CPRL")},
    "poc_cprl": (3, 25, 26, {}, dict(numresolution=3, rates=[20, 0], pocs=[
        dict(resno0=0, compno0=0, layno1=2, resno1=3, compno1=3, prg="CPRL")])),
    "poc_three": (3, 25, 26, {}, dict(numresolution=3, rates=[30, 10, 0], pocs=[
        dict(resno0=0, compno0=0, layno1=1, resno1=3, compno1=3, prg="PCRL"),
        dict(resno0=1, compno0=1, layno1=3, resno1=3, compno1=3, prg="RLCP"),
        dict(resno0=0, compno0=0, layno1=3, resno1=3, compno1=3, prg="LRCP")])),
    **{f"style_{m}": (1, 37, 41, {}, dict(numresolution=3, mode=m, cblockw_init=16,
                                          cblockh_init=16, rates=[12, 4, 0]))
       for m in (1, 2, 4, 8, 16, 32, 9, 63)},
    **{f"style_{m}_97": (1, 37, 41, {}, dict(numresolution=3, mode=m, irreversible=1,
                                             rates=[6, 2])) for m in (1, 4, 8, 63)},
    "sop_eph": (3, 22, 25, {}, dict(numresolution=3, csty=6, rates=[20, 0])),
    "plt_tlm_com": (1, 22, 25, {}, dict(numresolution=3, extra=["PLT=YES", "TLM=YES"],
                                        comment="a comment", tile_size_on=1, cp_tdx=8,
                                        cp_tdy=16)),
    **{f"tile_parts_{f}": (3, 30, 30, {}, dict(numresolution=3, tile_parts=f, rates=[20, 6, 0],
                                               tile_size_on=1, cp_tdx=16, cp_tdy=16))
       for f in "RLC"},
    "roi_53": (3, 25, 22, {}, dict(numresolution=3, roi_compno=0, roi_shift=6, rates=[15])),
    "roi_97": (1, 25, 22, {}, dict(numresolution=3, roi_compno=0, roi_shift=4, irreversible=1,
                                   rates=[10])),
    "mct_53": (3, 25, 22, {}, dict(numresolution=3, tcp_mct=1)),
    "mct_97_lossy": (4, 25, 22, {}, dict(numresolution=3, tcp_mct=1, irreversible=1,
                                         rates=[20, 5])),
    "five_components": (5, 9, 12, {}, dict(numresolution=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_planes_equal_libopenjp2(case):
    n, h, w, plane_kw, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    planes = _planes(rng, n, h, w, **plane_kw)
    data = opj.encode(planes, prec=plane_kw.get("prec", 8), signed=plane_kw.get("signed", False),
                      sampling=plane_kw.get("sampling"), offset=plane_kw.get("offset", (0, 0)),
                      **kw)
    got = assert_planes_equal_libopenjp2(data)
    if kw.get("rates", [0])[-1] == 0 and not kw.get("irreversible") and "roi" not in case \
            and "poc" not in case:  # lossless: the planes themselves
        for (*_, plane), want in zip(got.comps, planes):
            np.testing.assert_array_equal(plane, want)


def test_poc_in_the_main_header_equals_libopenjp2():
    """libopenjp2's encoder writes POC in the tile-part header; moved to the
    main header (the tile-part's length less its bytes), the entries apply
    to every tile, and a tile-part's own entries would follow them."""
    rng = np.random.default_rng(5)
    planes = _planes(rng, 3, 27, 30)
    data = opj.encode(planes, numresolution=3, rates=[20, 0], tile_size_on=1, cp_tdx=16,
                      cp_tdy=16, pocs=[dict(resno0=0, compno0=0, layno1=2, resno1=3, compno1=3,
                                            prg="CPRL")])
    poc = data.index(b"\xff\x5f")
    seg = data[poc:poc + 2 + int.from_bytes(data[poc + 2:poc + 4], "big")]
    first_sot = data.index(b"\xff\x90")
    out, at = bytearray(data[:first_sot]) + seg, first_sot
    while data[at:at + 2] == b"\xff\x90":
        psot = int.from_bytes(data[at + 6:at + 10], "big")
        part = data[at:at + psot].replace(seg, b"", 1)
        out += part[:6] + len(part).to_bytes(4, "big") + part[10:]
        at += psot
    out += data[at:]
    assert bytes(out).count(seg) == 1 and bytes(out).index(seg) < bytes(out).index(b"\xff\x90")
    assert_planes_equal_libopenjp2(bytes(out))


def test_typed_tables_follow_their_rules():
    """The context tables against T.800's tables written out for a few
    neighbourhoods, and the MQ table's shape (``scripts/check_mq_tables.py``
    holds both against libopenjp2 itself)."""
    n, s, w, e = 2, 128, 8, 32  # significant north, south, west, east
    nw, ne, sw, se = 1, 4, 64, 256
    zc = ebcot.ZC_TABLE
    assert [zc[0 * 512 + f] for f in (0, nw, nw | se, n, n | s, w, w | nw, w | n, w | e)] \
        == [0, 1, 2, 3, 4, 5, 6, 7, 8]
    assert [zc[1 * 512 + f] for f in (w, w | e, n, n | nw, n | w, n | s)] == [3, 4, 5, 6, 7, 8]
    assert [zc[3 * 512 + f] for f in (0, n, n | w, nw, nw | n, nw | n | w, nw | se, nw | se | n,
                                      nw | se | ne)] == [0, 1, 2, 3, 4, 5, 6, 7, 8]
    # sign: (context, prediction) of (horizontal, vertical) contributions
    pos_e, neg_e, pos_n, neg_n = 32, 32 | 4, 2, 2 | 16
    assert [(ebcot.SC_TABLE[lu], ebcot.SPB_TABLE[lu]) for lu in
            (0, pos_e, neg_e, pos_n, neg_n, pos_e | pos_n, neg_e | neg_n, pos_e | neg_n)] == [
        (9, 0), (12, 0), (12, 1), (10, 0), (10, 1), (13, 0), (13, 1), (11, 0)]
    assert len(ebcot.MQ_STATES) == 47 and ebcot.MQ_STATES[46] == (0x5601, 46, 46, 0)


def test_inverse_wavelets_on_single_samples_and_pairs():
    """OpenJPEG's edge cases: a lone 5/3 sample on an odd coordinate is
    halved toward zero, a lone 9/7 sample is left as it is; a pair at an
    odd start takes the mirrored neighbour on both sides."""
    lone = np.array([[-7], [7], [-1]])  # three rows of one high-pass sample each
    assert dwt._inverse_53(lone, 0, 1)[:, 0].tolist() == [-3, 3, 0]
    assert dwt._inverse_53(lone, 1, 0)[:, 0].tolist() == [-7, 7, -1]
    f = np.array([[1.5]], np.float32)
    assert dwt._inverse_97(f, 0, 1)[0, 0] == np.float32(1.5)
    pair = np.array([[10, 4]])  # low 10 then high 4, at an odd start: [H, L]
    low = 10 - ((4 + 4 + 2) >> 2)
    assert dwt._inverse_53(pair, 1, 1).tolist() == [[4 + low, low]]
