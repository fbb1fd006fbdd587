"""WebP in numpy and the standard library, bit-equal to ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` then ``cv2.cvtColor(BGR2RGB)``.

cv2 5 reads WebP through libwebp: a file whose first 32 bytes pass
``WebPGetFeatures`` (``is_webp``: a RIFF container, or a bare VP8 or VP8L
bitstream) is decoded with ``WebPDecodeBGR(A)Into``, or, with the VP8X
animation flag, with ``WebPAnimDecoder``, and turned by the EXIF
Orientation that libwebp's demuxer finds. ``decode_webp`` copies the rules,
as probed on cv2 5.0.0:

* the containers: the simple ``VP8 `` and ``VP8L`` forms; ``VP8X`` with its
  canvas size (which must equal the image's) and any chunks before the image
  (``ICCP``, ``XMP ``, ``EXIF``, unknown ones) skipped; ``ALPH`` (the last
  one before the image) decoded and checked though ``IMREAD_COLOR`` drops
  the alpha (a header with reserved bits, a method above 1, preprocessing
  above 1, too few raw bytes or a broken lossless stream makes cv2 refuse
  the file); the colour as coded, never blended with the alpha;
* ``EXIF``: applied (``jpeg.apply_orientation``) when the VP8X flags announce
  it and libwebp's demuxer accepts the whole file (no reserved flag bits, no
  chunk past the RIFF size, one image, alpha before it); the first chunk,
  raw TIFF;
* animations (``ANIM`` then ``ANMF`` frames): the first frame only, decoded
  on a canvas of zeros at its offset (the first frame is a key frame, so
  neither its blending flag nor the background colour acts), the whole file
  checked as the demuxer checks it (frames inside the canvas, ``ANIM``
  before them);
* refusals (``ValueError``): fewer than 32 bytes, a RIFF size past the data
  or below its chunks, a chunk or bitstream that runs past the end, a
  canvas that disagrees with the image, and what the bitstream decoders
  refuse (``data/vp8l.py``, ``data/vp8.py``). Bytes after the RIFF size are
  ignored.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from .jpeg import apply_orientation, tiff_orientation
from .vp8 import decode_vp8, frame_size
from .vp8l import decode_alpha_stream, decode_vp8l, image_size, rgb as argb_to_rgb

HEADER = 32  # cv2 reads this many bytes for WebPGetFeatures
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_ANIMATION, _EXIF, _ALPHA, _VALID_FLAGS = 0x02, 0x08, 0x10, 0x3E


def _le24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _features(data: bytes, all_data: bool, path: str) -> dict:
    """libwebp's ``ParseHeadersInternal``: the RIFF size, the VP8X fields,
    the ALPH chunk and where the image bitstream starts. ``all_data``:
    decoding (a cut file is refused) rather than ``WebPGetFeatures`` on the
    first 32 bytes (where a VP8X header alone is enough)."""
    def refuse(why: str):
        raise ValueError(f"{path}: {why} (cv2 refuses the WebP file)")

    out = dict(riff=0, vp8x=False, flags=0, alpha=None)
    at = 0
    if len(data) >= 12 and data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            refuse("RIFF file that is not WEBP")
        size = struct.unpack("<I", data[4:8])[0]
        if size < 12 or size > _MAX_PAYLOAD:
            refuse(f"RIFF size {size}")
        if all_data and size > len(data) - 8:
            refuse("file cut short before its RIFF size")
        out["riff"], at = size, 12
    if len(data) - at < 8:
        refuse("WebP cut short")
    if data[at:at + 4] == b"VP8X":
        if struct.unpack("<I", data[at + 4:at + 8])[0] != 10:
            refuse("VP8X chunk not of 10 bytes")
        if len(data) - at < 18:
            refuse("WebP cut short in its VP8X chunk")
        out["flags"] = struct.unpack("<I", data[at + 8:at + 12])[0]
        out["canvas"] = (_le24(data[at + 12:at + 15]) + 1, _le24(data[at + 15:at + 18]) + 1)
        if out["canvas"][0] * out["canvas"][1] >= 1 << 32:
            refuse("WebP canvas too large")
        if not out["riff"]:
            refuse("VP8X chunk outside a RIFF container")
        out["vp8x"] = True
        at += 18
        if out["flags"] & _ANIMATION and not all_data:
            return out
    if len(data) - at < 4:
        if out["vp8x"] and not all_data:
            return out
        refuse("WebP cut short")
    if out["vp8x"] or (not out["riff"] and data[at:at + 4] == b"ALPH"):
        total = 22
        while True:
            if len(data) - at < 8:
                if out["vp8x"] and not all_data:
                    return out
                refuse("WebP cut short among its chunks")
            size = struct.unpack("<I", data[at + 4:at + 8])[0]
            if size > _MAX_PAYLOAD:
                refuse("WebP chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if out["riff"] and total > out["riff"]:
                refuse("WebP chunk past the RIFF size")
            if data[at:at + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(data) - at < disk:
                if out["vp8x"] and not all_data:
                    return out
                refuse("WebP chunk runs past the end of the file")
            if data[at:at + 4] == b"ALPH":
                out["alpha"] = data[at + 8:at + 8 + size]
            at += disk
    tag = data[at:at + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        if out["riff"] >= 12 and size > out["riff"] - 12:
            refuse("WebP image chunk larger than the RIFF size")
        if all_data and size > len(data) - at - 8:
            refuse("WebP image chunk runs past the end of the file")
        lossless, at = tag == b"VP8L", at + 8
    else:  # a bare bitstream
        size = len(data) - at
        lossless = len(data) - at >= 5 and data[at] == 0x2F and not data[at + 4] >> 5
    if lossless:
        if len(data) - at < 5:
            refuse("WebP cut short in its VP8L header")
        w, h, alpha_bit = image_size(data[at:], path)
        out["alpha_bit"] = alpha_bit
    else:
        if len(data) - at < 10:
            refuse("WebP cut short in its VP8 header")
        w, h = frame_size(data[at:], size, path)
    if out["vp8x"] and (w, h) != out["canvas"]:
        refuse(f"WebP canvas {out['canvas']} differs from its image's size {(w, h)}")
    out.update(size=(w, h), lossless=lossless, start=at)
    return out


def is_webp(data: bytes) -> bool:
    """Whether cv2 takes ``data`` for WebP: its first 32 bytes pass
    ``WebPGetFeatures``."""
    if len(data) < HEADER:
        return False
    try:
        _features(bytes(data[:HEADER]), False, "")
    except ValueError:
        return False
    return True


def _check_alpha(alpha: bytes, w: int, h: int, path: str) -> None:
    """libwebp's ``ALPHInit``/``ALPHDecode`` on an ALPH payload, whose
    failure fails the whole decode."""
    if len(alpha) <= 1:
        raise ValueError(f"{path}: WebP ALPH chunk without data (cv2 refuses the file)")
    method, pre, reserved = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"{path}: WebP ALPH header {alpha[0]:#04x} (cv2 refuses the file)")
    if method == 0 and len(alpha) - 1 < w * h:
        raise ValueError(f"{path}: WebP ALPH chunk too short (cv2 refuses the file)")
    if method == 1:
        decode_alpha_stream(alpha[1:], w, h, path)


def _bitstream(data: bytes, f: dict, path: str) -> np.ndarray:
    """The image bitstream at ``f['start']`` (read to the end of ``data``,
    as libwebp reads it) -> (H, W, 3) uint8 RGB."""
    body = data[f["start"]:]
    if f["lossless"]:
        return argb_to_rgb(decode_vp8l(body, path))
    img = decode_vp8(body, path)
    if f["alpha"] is not None:
        _check_alpha(f["alpha"], f["size"][0], f["size"][1], path)
    return img


# ---------------------------------------------------------------- demuxer
def _demux(data: bytes, path: str) -> Optional[dict]:
    """libwebp's ``WebPDemux`` of a VP8X file: {"canvas", "frames": [frame
    dicts of ``_store_frame``], "exif": the first EXIF payload or None}, or
    None where the demuxer refuses the file."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 8 or riff > _MAX_PAYLOAD:
        return None
    riff_end = riff + 8
    end = min(len(data), riff_end)  # nothing past the RIFF size is read
    at = 12
    if data[at:at + 4] != b"VP8X":
        return None
    size = struct.unpack("<I", data[at + 4:at + 8])[0]
    if size > _MAX_PAYLOAD or size < 10:
        return None
    size += size & 1
    if size > riff_end - at - 8 or end - at - 8 < size:
        return None
    flags = data[at + 8]
    canvas = (_le24(data[at + 12:at + 15]) + 1, _le24(data[at + 15:at + 18]) + 1)
    at += 8 + size
    if 8 > riff_end - at or end - at < 8:
        return None
    animated = bool(flags & _ANIMATION)
    frames: List[dict] = []
    exif = None
    anims = 0
    while True:
        tag = data[at:at + 4]
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        if size > _MAX_PAYLOAD:
            return None
        padded = size + (size & 1)
        if padded > riff_end - at - 8 or tag == b"VP8X":
            return None
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if anims or animated or frames:
                return None
            frame = _store_frame(data, at, end, riff_end, 0, 0, 0, path)
            if frame is None:
                return None
            if not flags & _ALPHA:  # the demuxer drops an alpha the flags do not announce
                frame["alpha"] = None
            frames.append(frame)
            at = frame["next"]
        elif tag == b"ANIM":
            if padded < 6 or end - at - 8 < padded:
                return None
            anims += 1
            at += 8 + padded
        elif tag == b"ANMF":
            if not anims or padded < 16 or 16 > riff_end - at - 8 or end - at - 8 < 16:
                return None
            p = data[at + 8:at + 24]
            if (_le24(p[6:9]) + 1) * (_le24(p[9:12]) + 1) >= 1 << 32:
                return None
            frame = _store_frame(data, at + 24, end, riff_end, padded - 16, 2 * _le24(p[0:3]),
                                 2 * _le24(p[3:6]), path)
            if frame is None or frame["next"] - (at + 24) > padded - 16:
                return None
            if animated and (frame["alpha"] is not None or frame["image"] is not None):
                if frames and not frames[-1]["complete"]:
                    return None
                frames.append(frame)
            at = frame["next"]
        else:
            if end - at - 8 < padded:
                return None
            if tag == b"EXIF" and flags & _EXIF and exif is None:
                exif = data[at + 8:at + 8 + size]
            at += 8 + padded
        if at == riff_end:
            break
        if end - at < 8:
            return None
    if not frames or flags & ~_VALID_FLAGS:
        return None
    for f in frames:
        if not f["complete"] or f["image"] is None or f["w"] <= 0:
            return None
        if f["alpha"] is not None and f["alpha"] > f["image"]:
            return None
        if animated:
            if f["x"] + f["w"] > canvas[0] or f["y"] + f["h"] > canvas[1]:
                return None
        elif (f["x"], f["y"], f["w"], f["h"]) != (0, 0) + canvas:
            return None
    return dict(canvas=canvas, frames=frames, exif=exif)


def _store_frame(data: bytes, at: int, end: int, riff_end: int, min_size: int, x: int, y: int,
                 path: str) -> Optional[dict]:
    """libwebp's ``StoreFrame``: the first ALPH chunk and the first image
    chunk from ``at``, up to any other chunk -> {"x", "y", "w", "h",
    "alpha"/"image" (their offsets or None), "complete", "bytes" (ALPH to
    the image's end), "next"}, or None where the demuxer refuses them."""
    if end - at < 8 or end - at < min_size:
        return None
    frame = dict(x=x, y=y, w=0, h=0, alpha=None, image=None, complete=False)
    while True:
        tag = data[at:at + 4]
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        if size > _MAX_PAYLOAD:
            return None
        padded = size + (size & 1)
        if padded > riff_end - at - 8:
            return None
        available = min(padded, end - at - 8)
        if tag == b"ALPH" and frame["alpha"] is None:
            frame["alpha"] = at
        elif tag in (b"VP8 ", b"VP8L") and frame["image"] is None:
            if tag == b"VP8L" and frame["alpha"] is not None:
                return None
            try:
                frame["w"], frame["h"] = _features(data[at:at + 8 + available], False,
                                                   path)["size"]
            except ValueError:
                return None
            frame["image"] = at
            frame["complete"] = available == padded
            start = frame["alpha"] if frame["alpha"] is not None else at
            frame["bytes"] = data[start:at + 8 + available]
        else:
            break
        at += 8 + available
        if available < padded:
            return None
        if at == riff_end:
            break
        if end - at < 8:
            return None
    frame["next"] = at
    return frame


def decode_webp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A WebP file (``is_webp``) -> (H, W, 3) uint8 RGB, equal to cv2's
    decode (see the module's docstring); ``cv2.imread`` and ``cv2.imdecode``
    agree on WebP."""
    data = bytes(data)
    if len(data) < HEADER:
        raise ValueError(f"{path}: WebP of {len(data)} bytes (cv2 reads at least {HEADER})")
    head = _features(data[:HEADER], False, path)
    if head["flags"] & _ANIMATION:
        dmux = _demux(data, path)
        if dmux is None:
            raise ValueError(f"{path}: animated WebP that libwebp's demuxer refuses")
        frame = dmux["frames"][0]
        f = _features(frame["bytes"], True, path)
        canvas = np.zeros((dmux["canvas"][1], dmux["canvas"][0], 3), np.uint8)
        canvas[frame["y"]:frame["y"] + frame["h"], frame["x"]:frame["x"] + frame["w"]] = \
            _bitstream(frame["bytes"], f, path)
        img = canvas
    else:
        f = _features(data, True, path)
        img = _bitstream(data, f, path)
        dmux = _demux(data, path) if f["vp8x"] else None
    exif = dmux and dmux["exif"]
    return apply_orientation(img, tiff_orientation(exif) if exif else None)


__all__ = ["decode_webp", "is_webp", "HEADER"]
