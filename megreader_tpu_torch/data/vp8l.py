"""WebP lossless (VP8L, RFC 9649) in numpy and the standard library, as
libwebp decodes it for ``cv2.imread`` / ``cv2.imdecode``.

* ``decode_vp8l``: a ``VP8L`` chunk's payload (the 0x2f signature, 14-bit
  width and height, the alpha hint and a version of 0) -> (H, W) uint32
  ARGB; ``decode_alpha_stream`` the header-less stream of a lossy file's
  ``ALPH`` chunk (its green channel is the alpha plane).
* The entropy-coded image: prefix codes in their simple form (one or two
  symbols of 1 or 8 bits) or their normal form (code-length code lengths
  in ``_CODE_LENGTH_ORDER``, repeat codes 16-18, an optional count of
  symbols), canonical and read most significant bit first from an
  LSB-first stream; five codes a group (green with the LZ77 length prefixes
  and the colour cache, red, blue, alpha, distance); LZ77 backward
  references whose distances below 121 go through the 120-entry
  ``_DISTANCE_MAP``; the colour cache (``0x1e35a7bd`` hash); the meta
  prefix codes (an entropy image of group indices). The symbols are read
  one by one in Python, the rest with numpy.
* The transforms, undone in the reverse of their order in the stream:
  subtract-green, colour (``ColorTransformDelta``: signed products
  shifted right by 5), colour indexing with pixel bundling (indices past
  the palette give 0) and the predictor with its 14 modes. The predictor
  depends on the pixel to the left and the row above, so it is undone
  along anti-diagonals ``x + 2y``: every pixel of one diagonal at once.

What libwebp refuses raises ``ValueError``: a prefix code that is neither
complete nor of one symbol, a transform read twice, a colour cache of 0 or
more than 11 bits, a backward reference before the first pixel or past the
last, and a stream that its decoding reads past the end of.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

SIGNATURE = 0x2F

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)  # green (without the cache), red, blue, alpha, distance

#: the 120 short distance codes as (dy << 4) | (8 - dx) (RFC 9649 section
#: 3.5.2.2's table of (dx, dy), in libwebp's ``kCodeToPlane`` encoding)
_DISTANCE_MAP = bytes([
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
])

_ROOT_BITS = 11  # codes longer than this are resolved by a slower path


class _Reader:
    """An LSB-first bit reader. ``words[i]`` holds the 8 bytes from byte i,
    so ``peek`` is one shift and one mask."""

    def __init__(self, data: bytes, name: str):
        self.n_bits = 8 * len(data)
        b = np.frombuffer(bytes(data) + bytes(16), np.uint8).astype(np.uint64)
        n = len(data) + 8
        w = np.zeros(n, np.uint64)
        for k in range(8):
            w |= b[k:k + n] << np.uint64(8 * k)
        self.words = w.tolist()
        self.pos = 0
        self.name = name

    def read(self, n: int) -> int:
        pos = self.pos
        self.pos = pos + n
        return (self.words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        # libwebp's end of stream: more bits read than the data holds, or,
        # from fewer than 8 bytes, more than the 64 its first load holds
        if self.pos > max(self.n_bits, 64):
            raise ValueError(f"{self.name}: WebP lossless stream ends early")


class _Code:
    """A canonical prefix code: ``table[peeked root bits]`` is
    ``symbol << 4 | length``, or -1 for a code longer than ``root`` bits
    (looked up in ``long``, one dict of reversed codes a length)."""

    __slots__ = ("table", "root", "long", "single")

    def __init__(self, lengths: np.ndarray, name: str):
        used = np.flatnonzero(lengths)
        if len(used) == 0:
            raise ValueError(f"{name}: WebP lossless prefix code without symbols")
        self.long = {}
        if len(used) == 1:  # libwebp: one symbol, read with no bits
            self.table, self.root, self.single = [int(used[0]) << 4], 0, int(used[0])
            return
        self.single = None
        lens = lengths[used].astype(np.int64)
        if (np.ldexp(1.0, -lens)).sum() != 1.0:
            raise ValueError(f"{name}: WebP lossless prefix code is not complete")
        order = np.lexsort((used, lens))
        used, lens = used[order], lens[order]
        counts = np.bincount(lens, minlength=16)
        code, next_code = 0, [0] * 16
        for n in range(1, 16):
            code = (code + counts[n - 1]) << 1
            next_code[n] = code
        codes = np.empty(len(used), np.int64)
        for n in range(1, 16):
            sel = lens == n
            codes[sel] = next_code[n] + np.arange(int(sel.sum()))
        rev = np.zeros_like(codes)
        for k in range(int(lens.max())):  # bit-reverse each code within its length
            rev |= np.where(k < lens, ((codes >> k) & 1) << np.maximum(lens - 1 - k, 0), 0)
        self.root = root = min(int(lens.max()), _ROOT_BITS)
        table = np.full(1 << root, -1, np.int64)
        for n in range(1, root + 1):
            sel = lens == n
            if sel.any():
                idx = rev[sel][:, None] + (np.arange(1 << (root - n)) << n)[None, :]
                table[idx] = ((used[sel] << 4) | n)[:, None]
        for n in range(root + 1, int(lens.max()) + 1):
            sel = lens == n
            self.long[n] = dict(zip(rev[sel].tolist(), used[sel].tolist()))
        self.table = table.tolist()

    def slow(self, bits: int) -> Tuple[int, int]:
        """(symbol, length) of a code longer than ``root`` bits."""
        for n, codes in self.long.items():
            s = codes.get(bits & ((1 << n) - 1))
            if s is not None:
                return s, n
        raise AssertionError("a complete code always decodes")


def _read_code(br: _Reader, alphabet: int) -> _Code:
    lengths = np.zeros(alphabet, np.int64)
    if br.read(1):  # simple
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if two else [])
        if max(symbols) >= alphabet:
            raise ValueError(f"{br.name}: WebP lossless simple code symbol past its alphabet")
        lengths[symbols] = 1
    else:
        cl = np.zeros(19, np.int64)
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        lcode = _Code(cl, br.name)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise ValueError(f"{br.name}: WebP lossless code length count past its alphabet")
        else:
            max_symbol = alphabet
        symbol, prev = 0, 8
        table, root = lcode.table, lcode.root
        while symbol < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            e = table[_peek(br, root)]
            br.pos += e & 15
            n = e >> 4
            if n < 16:
                lengths[symbol] = n
                symbol += 1
                if n:
                    prev = n
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
                repeat = br.read(extra) + offset
                if symbol + repeat > alphabet:
                    raise ValueError(f"{br.name}: WebP lossless code lengths past the alphabet")
                lengths[symbol:symbol + repeat] = prev if n == 16 else 0
                symbol += repeat
    br.check()
    return _Code(lengths, br.name)


def _peek(br: _Reader, n: int) -> int:
    pos = br.pos
    return (br.words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)


def _sub_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_image(br: _Reader, w: int, h: int, level0: bool) -> np.ndarray:
    """One entropy-coded image (with its transforms when ``level0``) ->
    (h, w) uint32 ARGB."""
    transforms = []
    xsize = w
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError(f"{br.name}: WebP lossless transform {kind} read twice")
            seen.add(kind)
            if kind in (0, 1):  # predictor, colour
                bits = br.read(3) + 2
                data = _decode_image(br, _sub_size(xsize, bits), _sub_size(h, bits), False)
                transforms.append((kind, xsize, bits, data))
            elif kind == 3:  # colour indexing
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                data = _decode_image(br, n, 1, False).reshape(-1)
                transforms.append((kind, xsize, bits, data))
                xsize = _sub_size(xsize, bits)
            else:
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"{br.name}: WebP lossless colour cache of {cache_bits} bits")
    group_bits, group_map, n_groups = 0, None, 1
    if level0 and br.read(1):
        group_bits = br.read(3) + 2
        gw = _sub_size(xsize, group_bits)
        meta = _decode_image(br, gw, _sub_size(h, group_bits), False)
        group_map = ((meta >> 8) & 0xFFFF).astype(np.int64)
        n_groups = int(group_map.max()) + 1
        group_map = group_map.reshape(-1).tolist()
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a + (cache_size if i == 0 else 0))
                       for i, a in enumerate(_ALPHABETS)])
    argb = _pixels(br, xsize, h, groups, group_map, group_bits, cache_bits)
    for kind, tw, bits, data in reversed(transforms):
        argb = _inverse(kind, argb, tw, h, bits, data)
    return argb.reshape(h, w)


def _copy_length(br: _Reader, prefix: int) -> int:
    if prefix < 4:
        return prefix + 1
    extra = (prefix - 2) >> 1
    return ((2 + (prefix & 1)) << extra) + br.read(extra) + 1


def _pixels(br: _Reader, w: int, h: int, groups: list, group_map: Optional[list],
            group_bits: int, cache_bits: int) -> np.ndarray:
    """The entropy-coded pixels -> (w * h,) uint32."""
    total = w * h
    out = [0] * total
    words = br.words
    pos = br.pos
    name = br.name
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    cached = 0  # pixels before this one are in the cache
    gw = _sub_size(w, group_bits) if group_map is not None else 0
    i = x = y = 0
    group = groups[0]

    def symbol(code: _Code) -> int:
        nonlocal pos
        root = code.root
        v = words[pos >> 3] >> (pos & 7)
        e = code.table[v & ((1 << root) - 1)]
        if e < 0:
            s, n = code.slow(v)
            pos += n
            return s
        pos += e & 15
        return e >> 4

    while i < total:
        if group_map is not None:
            group = groups[group_map[(y >> group_bits) * gw + (x >> group_bits)]]
        green, red, blue, alpha, dist_code = group
        # the green symbol, inlined
        v = words[pos >> 3] >> (pos & 7)
        e = green.table[v & ((1 << green.root) - 1)]
        if e < 0:
            g, n = green.slow(v)
            pos += n
        else:
            pos += e & 15
            g = e >> 4
        if g < 256:
            r = symbol(red)
            b = symbol(blue)
            out[i] = (symbol(alpha) << 24) | (r << 16) | (g << 8) | b
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        elif g < 280:
            br.pos = pos
            length = _copy_length(br, g - 256)
            pos = br.pos
            d = symbol(dist_code)
            br.pos = pos
            d = _copy_length(br, d)
            pos = br.pos
            if d > 120:
                d -= 120
            else:
                c = _DISTANCE_MAP[d - 1]
                d = max((c >> 4) * w + 8 - (c & 15), 1)
            if d > i or length > total - i:
                raise ValueError(f"{name}: WebP lossless backward reference outside the image")
            if d >= length:
                out[i:i + length] = out[i - d:i - d + length]
            else:
                run = out[i - d:i]
                out[i:i + length] = (run * (length // d + 1))[:length]
            i += length
            x += length
            if x >= w:
                y += x // w
                x %= w
        else:
            key = g - 280
            if cached < i:
                _insert(cache, out, cached, i, cache_shift)
                cached = i
            out[i] = cache[key]
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
    br.pos = pos
    br.check()
    return np.array(out, np.uint32)


def _insert(cache: list, out: list, start: int, stop: int, shift: int) -> None:
    """Pixels ``out[start:stop]`` put in the colour cache in turn."""
    if stop - start < 16:
        for p in out[start:stop]:
            cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
        return
    px = np.array(out[start:stop], np.uint64)
    keys = ((px * np.uint64(0x1E35A7BD)) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)
    keys = keys[::-1]
    uniq, first = np.unique(keys, return_index=True)  # the last pixel of each key wins
    for k, p in zip(uniq.tolist(), px[::-1][first].tolist()):
        cache[k] = p


def _channels(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB -> (..., 4) int64 (alpha, red, green, blue)."""
    a = argb.astype(np.int64)
    return np.stack([a >> 24, (a >> 16) & 255, (a >> 8) & 255, a & 255], -1)


def _pack(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.uint32)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _inverse(kind: int, argb: np.ndarray, w: int, h: int, bits: int,
             data: Optional[np.ndarray]) -> np.ndarray:
    """One transform undone on (w * h,) or (h, w) ARGB of width ``w`` (the
    width the transform was read at)."""
    if kind == 2:  # subtract green
        c = _channels(argb.reshape(-1))
        c[:, 1] = (c[:, 1] + c[:, 2]) & 255
        c[:, 3] = (c[:, 3] + c[:, 2]) & 255
        return _pack(c)
    if kind == 3:  # colour indexing
        n_colours = len(data)
        palette = _channels(data)
        palette = np.cumsum(palette, 0) & 255  # each entry coded as a delta from the one before
        full = np.zeros((256, 4), np.int64)
        full[:n_colours] = palette[:256]
        packed = (argb.reshape(h, -1).astype(np.int64) >> 8) & 255
        per = 1 << bits
        depth = 8 >> bits
        cols = np.arange(w)
        idx = (packed[:, cols >> bits] >> ((cols & (per - 1)) * depth)) & ((1 << depth) - 1)
        return _pack(full[idx]).reshape(-1)
    blocks = _channels(data).reshape(_sub_size(h, bits), _sub_size(w, bits), 4)
    ys, xs = np.arange(h) >> bits, np.arange(w) >> bits
    if kind == 1:  # colour transform
        c = _channels(argb.reshape(-1)).reshape(h, w, 4)
        t = blocks[ys[:, None], xs[None, :]]
        s8 = lambda v: (v ^ 128) - 128  # noqa: E731 - a byte as int8
        g = s8(c[..., 2])
        red = (c[..., 1] + ((s8(t[..., 3]) * g) >> 5)) & 255
        blue = c[..., 3] + ((s8(t[..., 2]) * g) >> 5) + ((s8(t[..., 1]) * s8(red)) >> 5)
        c[..., 1], c[..., 3] = red, blue & 255
        return _pack(c).reshape(-1)
    modes = blocks[ys[:, None], xs[None, :], 2] & 15  # predictor: the mode is in green
    modes[modes >= 14] = 0  # libwebp's sentinels: 14 and 15 predict as 0
    return _unpredict(_channels(argb.reshape(-1)), modes, w, h)


def _avg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + b) >> 1


def _predict(mode: int, L, T, TR, TL) -> np.ndarray:
    """RFC 9649's predictor ``mode`` on (n, 4) neighbours."""
    if mode == 0:
        return np.broadcast_to(np.array([255, 0, 0, 0]), L.shape)
    if mode in (1, 2, 3, 4):
        return (L, T, TR, TL)[mode - 1]
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:  # select: whichever of L and T is nearer to L + T - TL
        p_l = np.abs(T - TL).sum(1)
        p_t = np.abs(L - TL).sum(1)
        return np.where((p_l < p_t)[:, None], L, T)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    a = _avg(L, T)  # 13: clamp(a + (a - TL) / 2), C's division
    d = a - TL
    return np.clip(a + np.where(d < 0, -((-d) >> 1), d >> 1), 0, 255)


def _unpredict(res: np.ndarray, modes: np.ndarray, w: int, h: int) -> np.ndarray:
    """The predictor transform undone: (w * h, 4) residuals -> ARGB. Each
    pixel's prediction reads its left, top, top-right and top-left
    neighbours in the flat array (the rightmost column's top-right is the
    first pixel of its own row, as RFC 9649 has it), so all pixels on one
    line ``x + 2y = t`` are predicted at once."""
    m = modes.astype(np.int64)
    m[0, :] = 1
    m[:, 0] = 2
    m[0, 0] = 0
    m = m.reshape(-1)
    out = np.zeros_like(res)
    yy, xx = np.divmod(np.arange(w * h), w)
    t = xx + 2 * yy
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(t.max() + 2))
    for k in range(len(bounds) - 1):
        idx = order[bounds[k]:bounds[k + 1]]
        if not len(idx):
            continue
        L = out[np.maximum(idx - 1, 0)]
        T = out[np.maximum(idx - w, 0)]
        TR = out[np.maximum(idx - w + 1, 0)]
        TL = out[np.maximum(idx - w - 1, 0)]
        mk = m[idx]
        pred = np.empty_like(L)
        for mode in np.unique(mk).tolist():
            sel = mk == mode
            pred[sel] = _predict(mode, L[sel], T[sel], TR[sel], TL[sel])
        out[idx] = (pred + res[idx]) & 255
    return _pack(out)


def image_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int, bool]:
    """A VP8L payload's header -> (width, height, alpha hint), as libwebp's
    ``VP8LGetInfo`` checks it."""
    if len(data) < 5 or data[0] != SIGNATURE or data[4] >> 5:
        raise ValueError(f"{name}: not a WebP lossless bitstream")
    v = int.from_bytes(data[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def decode_vp8l(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A ``VP8L`` payload -> (H, W) uint32 ARGB."""
    w, h, _ = image_size(data, name)
    br = _Reader(data, name)
    br.pos = 40
    return _decoded(br, w, h)


def decode_alpha_stream(data: bytes, w: int, h: int, name: str = "<bytes>") -> np.ndarray:
    """A header-less VP8L stream of ``w`` x ``h`` (an ``ALPH`` chunk's
    lossless data) -> (h, w) uint32 ARGB."""
    return _decoded(_Reader(data, name), w, h)


def _decoded(br: _Reader, w: int, h: int) -> np.ndarray:
    try:
        return _decode_image(br, w, h, True)
    except IndexError:  # read far past the end of the stream
        raise ValueError(f"{br.name}: WebP lossless stream ends early") from None


def rgb(argb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB -> (H, W, 3) uint8 RGB, the colour as coded."""
    return np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255], -1).astype(np.uint8)


__all__: List[str] = ["decode_vp8l", "decode_alpha_stream", "image_size", "rgb", "SIGNATURE"]
