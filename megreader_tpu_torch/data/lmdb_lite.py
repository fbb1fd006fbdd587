"""A pure-Python LMDB reader, and a writer of whole databases for tests and
the smoke run.

The port's own copy of ``megreader_tpu/data/lmdb_lite.py``: recognition
data in the community layout (``num-samples`` / ``image-%09d`` /
``label-%09d``) ships as LMDB files, and the card's machine has no
``lmdb`` C package. LMDB's file is a copy-on-write B+tree of
fixed-size pages; ``Reader`` reads its main database as the JAX reader does:

- the meta page (0 or 1) with the higher txnid;
- trees of any depth (branch pages walked down by their separator keys);
- leaf nodes with inline values and ``F_BIGDATA`` overflow values;
- page sizes 4096 to 65536 (probed from the meta magic).

Named sub-databases and DUPSORT are not read (recognition LMDBs have none).

``write_fixture_lmdb`` bulk-loads a database the way LMDB lays one out:
values whose node exceeds LMDB's ``me_nodemax`` go to runs of overflow pages,
leaves are filled in key order, and branch levels (each page's first key
empty, as LMDB keeps it) are built up to one root; the metas name the page
size, depth, page counts, entries and root. Unlike the JAX fixture writer,
which refuses anything past one leaf, it writes a database of any size.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
F_BIGDATA = 0x01  # node flag: data is an 8-byte overflow pgno

_PGHDR = struct.Struct("<Q2sHHH")  # pgno, pad, flags, lower, upper
#: MDB_db: pad, flags, depth, branch_pages, leaf_pages, overflow_pages,
#: entries, root
_MDB_DB = struct.Struct("<IHHQQQQq")
#: MDB_meta head: magic, version, address, mapsize (then dbs[2], then
#: last_pg, txnid)
_META_HEAD = struct.Struct("<IIqQ")
_NODE = struct.Struct("<HHHH")  # lo, hi, flags, ksize
_NODESIZE = _NODE.size


class LmdbLiteError(RuntimeError):
    pass


class Reader:
    """Read-only, cursorless access to an LMDB data file (a directory
    holding ``data.mdb``, or the file itself)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.page_size, self.depth, self.entries, self.root = self._pick_meta()

    def _parse_meta(self, off: int) -> Optional[Tuple[int, int, int, int]]:
        if off + _META_HEAD.size + 2 * _MDB_DB.size + 16 > len(self._mm):
            return None
        magic, _version, _addr, _mapsize = _META_HEAD.unpack_from(self._mm, off)
        if magic != MDB_MAGIC:
            return None
        main = _MDB_DB.unpack_from(self._mm, off + _META_HEAD.size + _MDB_DB.size)
        _pad, _flags, depth, _bp, _lp, _op, entries, root = main
        _last_pg, txnid = struct.unpack_from("<QQ", self._mm,
                                             off + _META_HEAD.size + 2 * _MDB_DB.size)
        return txnid, depth, entries, root

    def _pick_meta(self) -> Tuple[int, int, int, int]:
        for ps in (4096, 8192, 16384, 32768, 65536):
            metas = [m for m in (self._parse_meta(_PGHDR.size),
                                 self._parse_meta(ps + _PGHDR.size)) if m is not None]
            if metas:
                _txn, depth, entries, root = max(metas, key=lambda t: t[0])
                return ps, depth, entries, root
        raise LmdbLiteError("no LMDB meta page found (bad magic)")

    def _page(self, pgno: int) -> Tuple[int, int, Tuple[int, ...]]:
        """-> (byte offset of the page, flags, node offsets)."""
        off = pgno * self.page_size
        _pg, _pad, flags, lower, _upper = _PGHDR.unpack_from(self._mm, off)
        n = (lower - _PGHDR.size) // 2
        return off, flags, struct.unpack_from(f"<{n}H", self._mm, off + _PGHDR.size)

    def _node(self, off: int) -> Tuple[bytes, int, int, int]:
        """-> (key, lo | hi << 16, flags, offset of the data)."""
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, off)
        koff = off + _NODESIZE
        return bytes(self._mm[koff:koff + ksize]), lo | (hi << 16), flags, koff + ksize

    def _child(self, off: int) -> Tuple[bytes, int]:
        """A branch node: (separator key, 48-bit child pgno)."""
        key, lohi, flags, _ = self._node(off)
        return key, lohi | (flags << 32)

    def _value(self, size: int, flags: int, doff: int) -> bytes:
        if flags & F_BIGDATA:
            (pgno,) = struct.unpack_from("<Q", self._mm, doff)
            off = pgno * self.page_size
            if not _PGHDR.unpack_from(self._mm, off)[2] & P_OVERFLOW:
                raise LmdbLiteError(f"page {pgno} is not an overflow page")
            doff = off + _PGHDR.size
        return bytes(self._mm[doff:doff + size])

    def get(self, key: bytes) -> Optional[bytes]:
        if self.entries == 0 or self.root < 0:
            return None
        pgno = self.root
        while True:
            off, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                # separator i is the smallest key of subtree i (the first is
                # empty): descend into the last subtree whose key <= want
                chosen = 0
                for i in range(1, len(ptrs)):
                    if key >= self._child(off + ptrs[i])[0]:
                        chosen = i
                    else:
                        break
                pgno = self._child(off + ptrs[chosen])[1]
                continue
            if not flags & P_LEAF:
                raise LmdbLiteError(f"page {pgno} is neither branch nor leaf")
            for p in ptrs:
                k, size, nflags, doff = self._node(off + p)
                if k == key:
                    return self._value(size, nflags, doff)
            return None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Every record in key order."""

        def walk(pgno):
            off, flags, ptrs = self._page(pgno)
            for p in ptrs:
                if flags & P_BRANCH:
                    yield from walk(self._child(off + p)[1])
                else:
                    k, size, nflags, doff = self._node(off + p)
                    yield k, self._value(size, nflags, doff)

        if self.entries:
            yield from walk(self.root)

    def close(self):
        self._mm.close()
        self._f.close()


def _node_bytes(key: bytes, lohi: int, flags: int, data: bytes) -> bytes:
    body = _NODE.pack(lohi & 0xFFFF, (lohi >> 16) & 0xFFFF, flags, len(key)) + key + data
    return body + b"\0" * (len(body) & 1)  # nodes sit at even offsets


def _branch_node(key: bytes, pgno: int) -> bytes:
    """A branch node: the child's 48-bit pgno packed into lo, hi and flags."""
    return _node_bytes(key, pgno & 0xFFFFFFFF, pgno >> 32, b"")


def _child_pgno(node: bytes) -> int:
    lo, hi, flags, _ = _NODE.unpack_from(node)
    return lo | (hi << 16) | (flags << 32)


def _fill(nodes: List[bytes], page_size: int) -> List[List[bytes]]:
    """Split nodes, in order, into pages: each node takes its bytes and a
    2-byte pointer after the page header."""
    pages, cur, room = [], [], page_size - _PGHDR.size
    for nd in nodes:
        if cur and len(nd) + 2 > room:
            pages.append(cur)
            cur, room = [], page_size - _PGHDR.size
        cur.append(nd)
        room -= len(nd) + 2
    if cur:
        pages.append(cur)
    return pages


def _node_page(pgno: int, flags: int, nodes: List[bytes], page_size: int) -> bytearray:
    page = bytearray(page_size)
    upper, ptrs = page_size, []
    for nd in nodes:
        upper -= len(nd)
        page[upper:upper + len(nd)] = nd
        ptrs.append(upper)
    lower = _PGHDR.size + 2 * len(ptrs)
    if lower > upper:
        raise LmdbLiteError("a node does not fit its page")
    _PGHDR.pack_into(page, 0, pgno, b"\0\0", flags, lower, upper)
    struct.pack_into(f"<{len(ptrs)}H", page, _PGHDR.size, *ptrs)
    return page


def write_fixture_lmdb(path: str, records: Dict[bytes, bytes], page_size: int = 4096) -> None:
    """Write ``records`` as ``<path>/data.mdb``, a valid LMDB main database
    of any size (see the module's docstring)."""
    nodemax = ((page_size - _PGHDR.size) // 2 & -2) - 2  # LMDB's me_nodemax
    items = sorted(records.items())
    pages: Dict[int, bytes] = {}
    next_pg = 2
    n_overflow = 0
    leaf_nodes = []
    for k, v in items:
        if len(k) > nodemax // 2 or not k:
            raise LmdbLiteError(f"key of {len(k)} bytes: LMDB takes 1-{nodemax // 2}")
        if _NODESIZE + len(k) + len(v) > nodemax:  # the value goes to overflow pages
            n = -(-(_PGHDR.size + len(v)) // page_size)
            run = bytearray(n * page_size)
            struct.pack_into("<Q2sHI", run, 0, next_pg, b"\0\0", P_OVERFLOW, n)
            run[_PGHDR.size:_PGHDR.size + len(v)] = v
            pages[next_pg] = bytes(run)
            leaf_nodes.append(_node_bytes(k, len(v), F_BIGDATA, struct.pack("<Q", next_pg)))
            next_pg += n
            n_overflow += n
        else:
            leaf_nodes.append(_node_bytes(k, len(v), 0, v))
    # leaves, then branch levels of (first key, pgno) up to a single root;
    # a branch page's first separator is empty, as LMDB keeps it
    level, flags, depth, root = leaf_nodes, P_LEAF, 0, -1
    counts = {P_LEAF: 0, P_BRANCH: 0}
    firsts = [k for k, _ in items]
    while level:
        depth += 1
        parents, at = [], 0
        for group in _fill(level, page_size):
            if flags == P_BRANCH:
                group = [_branch_node(b"", _child_pgno(group[0]))] + group[1:]
            pages[next_pg] = bytes(_node_page(next_pg, flags, group, page_size))
            parents.append((firsts[at], next_pg))
            at += len(group)
            next_pg += 1
            counts[flags] += 1
        if len(parents) == 1:
            root = parents[0][1]
            break
        firsts = [k for k, _ in parents]
        level = [_branch_node(k, pg) for k, pg in parents]
        flags = P_BRANCH

    def meta_page(pgno: int, txnid: int) -> bytes:
        pg = bytearray(page_size)
        _PGHDR.pack_into(pg, 0, pgno, b"\0\0", P_META, 0, 0)
        off = _PGHDR.size
        _META_HEAD.pack_into(pg, off, MDB_MAGIC, 1, 0, max(1 << 20, next_pg * page_size))
        off += _META_HEAD.size
        _MDB_DB.pack_into(pg, off, page_size, 0, 0, 0, 0, 0, 0, -1)  # free DB; pad = psize
        off += _MDB_DB.size
        _MDB_DB.pack_into(pg, off, 0, 0, depth, counts[P_BRANCH], counts[P_LEAF], n_overflow,
                          len(items), root)
        off += _MDB_DB.size
        struct.pack_into("<QQ", pg, off, next_pg - 1, txnid)  # last_pg, txnid
        return bytes(pg)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pgno in range(2, next_pg):
            if pgno in pages:
                f.write(pages[pgno])
