"""OpenJPEG's encoder and decoder through ``ctypes``, for tests and asset
scripts on a machine that has the library (Pillow bundles one; the system
may have another). No headers are needed: the structs are laid out from
OpenJPEG 2.5's public ``openjpeg.h``, and ``library()`` checks the layout
against the defaults ``opj_set_default_encoder_parameters`` writes.

* ``encode(planes, ...)``: numpy planes -> a J2K codestream or a JP2 file,
  with the options PIL does not expose: code-block styles (``mode``),
  SOP/EPH (``csty``), POC entries, ROI shifts, component subsampling,
  signed and odd precisions, tile-parts, PLT/TLM, image and tile offsets.
* ``decode(data)``: the decoded image as OpenJPEG hands it to its callers
  (cv2 among them): every component's plane (int32), precision,
  signedness, alpha flag and sampling, and the colour space, or
  ``OpenJPEGError`` with the library's messages.

    python3 scripts/openjpeg_ctypes.py    # a self-check: encode, decode, compare
"""

from __future__ import annotations

import ctypes
import glob
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

PATH_LEN = 4096
MAX_RESOLUTIONS = 33
JPWL_SPECS = 16
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}

_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


class OpenJPEGError(RuntimeError):
    pass


class Poc(ctypes.Structure):
    _fields_ = [("resno0", ctypes.c_uint32), ("compno0", ctypes.c_uint32),
                ("layno1", ctypes.c_uint32), ("resno1", ctypes.c_uint32),
                ("compno1", ctypes.c_uint32), ("layno0", ctypes.c_uint32),
                ("precno0", ctypes.c_uint32), ("precno1", ctypes.c_uint32),
                ("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5),
                ("tile", ctypes.c_uint32)] + [
        (n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")] + [
        (n, ctypes.c_uint32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                                       "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                                       "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")]


class CParameters(ctypes.Structure):
    _fields_ = [("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int), ("cp_ty0", ctypes.c_int),
                ("cp_tdx", ctypes.c_int), ("cp_tdy", ctypes.c_int),
                ("cp_disto_alloc", ctypes.c_int), ("cp_fixed_alloc", ctypes.c_int),
                ("cp_fixed_quality", ctypes.c_int), ("cp_matrice", ctypes.c_void_p),
                ("cp_comment", ctypes.c_char_p), ("csty", ctypes.c_int),
                ("prog_order", ctypes.c_int), ("POC", Poc * 32), ("numpocs", ctypes.c_uint32),
                ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
                ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", ctypes.c_int),
                ("cblockw_init", ctypes.c_int), ("cblockh_init", ctypes.c_int),
                ("mode", ctypes.c_int), ("irreversible", ctypes.c_int),
                ("roi_compno", ctypes.c_int), ("roi_shift", ctypes.c_int),
                ("res_spec", ctypes.c_int), ("prcw_init", ctypes.c_int * MAX_RESOLUTIONS),
                ("prch_init", ctypes.c_int * MAX_RESOLUTIONS),
                ("infile", ctypes.c_char * PATH_LEN), ("outfile", ctypes.c_char * PATH_LEN),
                ("index_on", ctypes.c_int), ("index", ctypes.c_char * PATH_LEN),
                ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int),
                ("subsampling_dx", ctypes.c_int), ("subsampling_dy", ctypes.c_int),
                ("decod_format", ctypes.c_int), ("cod_format", ctypes.c_int),
                ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
                ("jpwl_hprot_TPH_tileno", ctypes.c_int * JPWL_SPECS),
                ("jpwl_hprot_TPH", ctypes.c_int * JPWL_SPECS),
                ("jpwl_pprot_tileno", ctypes.c_int * JPWL_SPECS),
                ("jpwl_pprot_packno", ctypes.c_int * JPWL_SPECS),
                ("jpwl_pprot", ctypes.c_int * JPWL_SPECS), ("jpwl_sens_size", ctypes.c_int),
                ("jpwl_sens_addr", ctypes.c_int), ("jpwl_sens_range", ctypes.c_int),
                ("jpwl_sens_MH", ctypes.c_int),
                ("jpwl_sens_TPH_tileno", ctypes.c_int * JPWL_SPECS),
                ("jpwl_sens_TPH", ctypes.c_int * JPWL_SPECS), ("cp_cinema", ctypes.c_int),
                ("max_comp_size", ctypes.c_int), ("cp_rsiz", ctypes.c_int),
                ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
                ("jpip_on", ctypes.c_int), ("mct_data", ctypes.c_void_p),
                ("max_cs_size", ctypes.c_int), ("rsiz", ctypes.c_uint16),
                ("_spare", ctypes.c_char * 1024)]


class ComponentParameters(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd")]


class Component(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd", "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class Image(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(Component)),
        ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


_LIB: Dict[str, ctypes.CDLL] = {}


def candidates() -> List[str]:
    """The libopenjp2 files found: Pillow's bundled copy first, then the one
    the system's loader finds (its file as this process maps it, Linux)."""
    import ctypes.util

    import PIL

    found = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                          "pillow.libs", "libopenjp2*.so*")))
    name = ctypes.util.find_library("openjp2")
    if name:
        ctypes.CDLL(name)
        with open("/proc/self/maps") as f:
            mapped = {line.split()[-1] for line in f if "libopenjp2.so" in line}
        found += sorted(p for p in mapped if os.path.basename(p).startswith("libopenjp2.so"))[:1]
    return found


def library(path: Optional[str] = None) -> ctypes.CDLL:
    """libopenjp2 (Pillow's copy unless ``path`` names another), its
    prototypes set and the parameter layout checked."""
    path = path or candidates()[0]
    if path in _LIB:
        return _LIB[path]
    lib = ctypes.CDLL(path)
    vp, c_bool = ctypes.c_void_p, ctypes.c_int
    protos = {
        "opj_version": (ctypes.c_char_p, []),
        "opj_create_compress": (vp, [ctypes.c_int]),
        "opj_create_decompress": (vp, [ctypes.c_int]),
        "opj_destroy_codec": (None, [vp]),
        "opj_set_default_encoder_parameters": (None, [vp]),
        "opj_set_default_decoder_parameters": (None, [vp]),
        "opj_setup_encoder": (c_bool, [vp, vp, vp]),
        "opj_setup_decoder": (c_bool, [vp, vp]),
        "opj_encoder_set_extra_options": (c_bool, [vp, ctypes.POINTER(ctypes.c_char_p)]),
        "opj_image_create": (ctypes.POINTER(Image), [ctypes.c_uint32, vp, ctypes.c_int]),
        "opj_image_destroy": (None, [vp]),
        "opj_stream_create_default_file_stream": (vp, [ctypes.c_char_p, c_bool]),
        "opj_stream_destroy": (None, [vp]),
        "opj_start_compress": (c_bool, [vp, vp, vp]),
        "opj_encode": (c_bool, [vp, vp]),
        "opj_end_compress": (c_bool, [vp, vp]),
        "opj_read_header": (c_bool, [vp, vp, ctypes.POINTER(ctypes.POINTER(Image))]),
        "opj_decode": (c_bool, [vp, vp, vp]),
        "opj_end_decompress": (c_bool, [vp, vp]),
        "opj_set_error_handler": (c_bool, [vp, _MSG, vp]),
        "opj_set_warning_handler": (c_bool, [vp, _MSG, vp]),
        "opj_set_info_handler": (c_bool, [vp, _MSG, vp]),
        "opj_mqc_resetstates": (None, [vp]),
        "opj_mqc_setstate": (None, [vp, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32]),
    }
    for name, (res, args) in protos.items():
        if not hasattr(lib, name) and name.startswith("opj_mqc"):
            continue  # internal: exported by Pillow's build, not by every one
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    p = CParameters()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx,
           p.subsampling_dy, p.decod_format, p.cod_format, p.tp_on)
    if got != (6, 64, 64, -1, 1, 1, -1, -1, b"\x00"):
        raise OpenJPEGError(f"{path}: opj_cparameters_t is not laid out as expected: {got}")
    _LIB[path] = lib
    return lib


def version(lib=None) -> str:
    return (lib or library()).opj_version().decode()


class _Messages:
    def __init__(self, lib, codec):
        self.errors: List[str] = []
        self.warnings: List[str] = []
        self._keep = [_MSG(lambda m, _: self.errors.append(m.decode().strip())),
                      _MSG(lambda m, _: self.warnings.append(m.decode().strip())),
                      _MSG(lambda m, _: None)]
        lib.opj_set_error_handler(codec, self._keep[0], None)
        lib.opj_set_warning_handler(codec, self._keep[1], None)
        lib.opj_set_info_handler(codec, self._keep[2], None)


def encode(planes: Sequence[np.ndarray], *, jp2: bool = False, prec: int = 8,
           signed: bool = False, sampling: Sequence = None, offset=(0, 0),
           colour_space: int = 0, lib=None, extra: Sequence[str] = (), **options) -> bytes:
    """Planes (each (h_c, w_c) ints, component c sampled by ``sampling[c] =
    (dx, dy)``) -> a codestream (``jp2=False``) or a JP2 file.

    ``offset`` is the image's (x0, y0) on the reference grid; the planes'
    sizes must be those the grid gives each component. ``prec`` and
    ``signed`` apply to every component (or pass lists). ``options`` are
    ``opj_cparameters_t`` fields (``irreversible``, ``numresolution``,
    ``cblockw_init``, ``mode``, ``csty``, ``prog_order`` (a name),
    ``tcp_mct``, ``roi_compno``/``roi_shift``, ``tile_size_on``/``cp_tdx``
    ...) plus ``rates`` (one a layer, 0 for lossless), ``precincts`` (a
    list of (w, h), from the highest resolution down), ``pocs`` (dicts of
    ``Poc`` fields with ``prg`` a name), ``tile_parts`` ('R', 'L' or 'C')
    and ``comment``; ``extra`` are ``opj_encoder_set_extra_options`` strings
    (``"PLT=YES"``, ``"TLM=YES"``)."""
    lib = lib or library()
    n = len(planes)
    precs = list(prec) if isinstance(prec, (list, tuple)) else [prec] * n
    signs = list(signed) if isinstance(signed, (list, tuple)) else [signed] * n
    sampling = list(sampling) if sampling is not None else [(1, 1)] * n
    x0, y0 = offset
    cmpt = (ComponentParameters * n)()
    # the image's extent on the grid, from component 0's plane and sampling
    h0, w0 = planes[0].shape
    dx0, dy0 = sampling[0]
    # grid extent: the largest x1 that gives component 0 its width
    x1 = max(x0 + 1, (-(-x0 // dx0) + w0 - 1) * dx0 + 1)
    y1 = max(y0 + 1, (-(-y0 // dy0) + h0 - 1) * dy0 + 1)
    for c, plane in enumerate(planes):
        dx, dy = sampling[c]
        want = (-(-y1 // dy) - -(-y0 // dy), -(-x1 // dx) - -(-x0 // dx))
        if plane.shape != want:
            raise ValueError(f"component {c}: plane {plane.shape}, the grid gives {want}")
        cmpt[c].dx, cmpt[c].dy = dx, dy
        cmpt[c].w, cmpt[c].h = want[1], want[0]
        cmpt[c].x0, cmpt[c].y0 = x0, y0
        cmpt[c].prec, cmpt[c].bpp, cmpt[c].sgnd = precs[c], precs[c], int(signs[c])
    image = lib.opj_image_create(n, ctypes.byref(cmpt), colour_space)
    if not image:
        raise OpenJPEGError("opj_image_create failed")
    try:
        img = image.contents
        img.x0, img.y0, img.x1, img.y1 = x0, y0, x1, y1
        for c, plane in enumerate(planes):
            comp = img.comps[c]
            assert (comp.w, comp.h, comp.sgnd, comp.prec) == (
                cmpt[c].w, cmpt[c].h, int(signs[c]), precs[c]), "opj_image_comp_t layout"
            flat = np.ascontiguousarray(plane, dtype=np.int32).ravel()
            ctypes.memmove(comp.data, flat.ctypes.data, flat.nbytes)
        p = _parameters(lib, options)
        codec = lib.opj_create_compress(2 if jp2 else 0)
        msgs = _Messages(lib, codec)
        try:
            if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
                raise OpenJPEGError(f"opj_setup_encoder: {msgs.errors}")
            if extra:
                arr = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
                if not lib.opj_encoder_set_extra_options(codec, arr):
                    raise OpenJPEGError(f"extra options {extra}: {msgs.errors}")
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "out.j2k")
                stream = lib.opj_stream_create_default_file_stream(out.encode(), 0)
                ok = (lib.opj_start_compress(codec, image, stream)
                      and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream))
                lib.opj_stream_destroy(stream)
                if not ok:
                    raise OpenJPEGError(f"encoding failed: {msgs.errors}")
                with open(out, "rb") as f:
                    return f.read()
        finally:
            lib.opj_destroy_codec(codec)
    finally:
        lib.opj_image_destroy(image)


def _parameters(lib, options: dict) -> CParameters:
    p = CParameters()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    options = dict(options)
    rates = options.pop("rates", [0])
    p.tcp_numlayers = len(rates)
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    if "prog_order" in options:
        options["prog_order"] = PROGRESSIONS[options["prog_order"]]
    precincts = options.pop("precincts", None)
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for i, (w, h) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = w, h
    pocs = options.pop("pocs", ())
    for i, poc in enumerate(pocs):
        poc = {"tile": 1, **poc}  # the encoder takes entries of tile number + 1 ...
        poc["prg1"] = poc.pop("prg")  # ... and their progression from prg1
        for k, v in poc.items():
            setattr(p.POC[i], k, PROGRESSIONS[v] if k == "prg1" else v)
    p.numpocs = len(pocs)
    tile_parts = options.pop("tile_parts", None)
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    comment = options.pop("comment", None)
    if comment is not None:
        p._comment = ctypes.create_string_buffer(comment.encode())
        p.cp_comment = ctypes.cast(p._comment, ctypes.c_char_p)
    if "tcp_mct" in options:
        options["tcp_mct"] = bytes([options["tcp_mct"]])
    csty = options.pop("csty", 0)
    p.csty |= csty
    for k, v in options.items():
        if not hasattr(p, k):
            raise TypeError(f"no opj_cparameters_t field {k}")
        setattr(p, k, v)
    return p


def decode(data: bytes, lib=None) -> dict:
    """A J2K codestream or JP2 file -> {"x0", "y0", "x1", "y1",
    "colour_space", "warnings", "comps": [{"dx", "dy", "x0", "y0", "prec",
    "sgnd", "alpha", "plane" (h, w) int32}, ...]}, as ``opj_decode`` leaves
    the image. Raises ``OpenJPEGError`` with the library's messages."""
    lib = lib or library()
    jp2 = data[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"
    codec = lib.opj_create_decompress(2 if jp2 else 0)
    msgs = _Messages(lib, codec)
    params = ctypes.create_string_buffer(16384)
    lib.opj_set_default_decoder_parameters(params)
    image = ctypes.POINTER(Image)()
    try:
        if not lib.opj_setup_decoder(codec, params):
            raise OpenJPEGError(f"opj_setup_decoder: {msgs.errors}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "in.jp2" if jp2 else "in.j2k")
            with open(path, "wb") as f:
                f.write(data)
            stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
            try:
                ok = lib.opj_read_header(stream, codec, ctypes.byref(image))
                if ok:
                    ok = lib.opj_decode(codec, stream, image) and lib.opj_end_decompress(codec,
                                                                                         stream)
            finally:
                lib.opj_stream_destroy(stream)
        if not ok:
            raise OpenJPEGError("; ".join(msgs.errors) or "decoding failed")
        img = image.contents
        comps = []
        for c in range(img.numcomps):
            comp = img.comps[c]
            plane = np.ctypeslib.as_array(comp.data, (comp.h, comp.w)).copy() if comp.data else None
            comps.append(dict(dx=comp.dx, dy=comp.dy, x0=comp.x0, y0=comp.y0, prec=comp.prec,
                              sgnd=comp.sgnd, alpha=comp.alpha, plane=plane))
        return dict(x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1, colour_space=img.color_space,
                    comps=comps, warnings=msgs.warnings)
    finally:
        if image:
            lib.opj_image_destroy(image)
        lib.opj_destroy_codec(codec)


def mq_states(lib=None) -> List[tuple]:
    """The library's MQ coder state table, read from its memory: for each
    of its 47 states (Qe, next state after an MPS, after an LPS, switch),
    found by pointing a context at each table entry with
    ``opj_mqc_setstate`` and following the entries' pointers."""
    lib = lib or library()
    mqc = ctypes.create_string_buffer(4096)
    lib.opj_mqc_resetstates(mqc)
    before = mqc.raw
    lib.opj_mqc_setstate(mqc, 5, 0, 1)
    diff = [i for i in range(len(before)) if before[i] != mqc.raw[i]]
    slot = diff[0] - diff[0] % 8
    base = ctypes.c_uint64.from_buffer(mqc, slot - 8 * 5)  # context 0: entry 0 after reset
    entry0 = base.value
    size = 24  # {uint32 qeval, uint32 mps, pointer nmps, pointer nlps}
    raw = ctypes.string_at(entry0, size * 94)
    entries = [np.frombuffer(raw[i * size:(i + 1) * size], "<u4,<u4,<u8,<u8")[0]
               for i in range(94)]
    out = []
    for s in range(47):
        qe, mps, nmps, nlps = (int(v) for v in entries[2 * s])
        assert mps == 0
        nm, nl = (nmps - entry0) // size, (nlps - entry0) // size
        out.append((qe, nm // 2, nl // 2, int(nl % 2 == 1)))
    return out


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 13, 7))
    for path in candidates():
        lib = library(path)
        data = encode(list(img), lib=lib, tcp_mct=1, numresolution=3)
        out = decode(data, lib=lib)
        assert all(np.array_equal(c["plane"], p) for c, p in zip(out["comps"], img))
        print(path, version(lib), len(data), "bytes, lossless round trip equal")
