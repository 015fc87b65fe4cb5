"""Dependency-free Caffe-LMDB dataset reader (+ minimal writer).

The port's copy of ``yolofastest_tpu/data/lmdb_reader.py``: ``struct`` and
numpy, no ``lmdb`` package.

Capability-equivalent of the reference's ``Caffe/caffe_lmdb.py:5-34``
(``Read_Caffe_LMDB``): iterate an LMDB environment of Caffe ``Datum``
records as ``(CHW uint8 array, label)`` pairs.  The reference leans on the
``lmdb`` C binding and 10.9k lines of generated protobuf; neither exists in
this image, so both halves are implemented from the public on-disk formats:

* **LMDB**: the memory-mapped B+tree layout from the LMDB source
  (``mdb.c``): two alternating meta pages (magic ``0xBEEFC0DE``), page
  size recorded in ``mm_dbs[0].md_pad``, branch/leaf pages with a sorted
  ``mp_ptrs`` index array, node headers packing the data size in
  ``mn_lo | mn_hi << 16``, and ``F_BIGDATA`` values spilled to overflow
  page chains.  Read-only — exactly the capability the reference uses.
* **Caffe Datum**: hand-written protobuf wire coding (fields
  channels/height/width/data/label), same approach as
  :mod:`yolofastest_torch.export.caffe`.

``write_caffe_lmdb`` is a minimal single-transaction writer (one leaf, or
one branch level of leaves; big values on overflow pages) so tests can
round-trip without the ``lmdb`` package — and datasets can be *exported*
to Caffe tooling, which the reference never could.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Tuple

import numpy as np

# ---------------------------------------------------------------- constants
_MDB_MAGIC = 0xBEEFC0DE
_MDB_VERSION = 1
_PAGEHDRSZ = 16
# page flags
_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
# node flags
_F_BIGDATA = 0x01
_P_INVALID = 0xFFFFFFFFFFFFFFFF


# ------------------------------------------------------------- Caffe Datum
def encode_datum(arr: np.ndarray, label: int) -> bytes:
    """(C, H, W) uint8 array + label -> Caffe ``Datum`` wire bytes."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"Datum wants a (C, H, W) array, got {arr.shape}")
    c, h, w = arr.shape

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    raw = arr.tobytes()
    return (bytes([0x08]) + varint(c) + bytes([0x10]) + varint(h)
            + bytes([0x18]) + varint(w)
            + bytes([0x22]) + varint(len(raw)) + raw
            + bytes([0x28]) + varint(label))


def decode_datum(buf: bytes) -> Tuple[np.ndarray, int]:
    """Caffe ``Datum`` wire bytes -> ((C, H, W) uint8 array, label).
    Unknown fields are skipped (forward compatible); a Datum without pixel
    ``data`` raises ``ValueError``."""
    pos, end = 0, len(buf)
    c = h = w = label = 0
    data = None

    def read_varint() -> int:
        nonlocal pos
        shift, v = 0, 0
        while True:
            if pos >= end:
                raise ValueError("Datum: truncated varint")
            b = buf[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while pos < end:
        tag = read_varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v = read_varint()
            if field == 1:
                c = v
            elif field == 2:
                h = v
            elif field == 3:
                w = v
            elif field == 5:
                label = v
        elif wire == 2:
            n = read_varint()
            if pos + n > end:
                raise ValueError("Datum: truncated bytes field")
            if field == 4:
                data = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"Datum: unsupported wire type {wire}")
    if data is None:
        raise ValueError("Datum: no pixel data field")
    flat = np.frombuffer(data, np.uint8)
    if flat.size != c * h * w:
        raise ValueError(
            f"Datum: data size {flat.size} != channels*height*width "
            f"{c}*{h}*{w}")
    return flat.reshape(c, h, w), label


# ------------------------------------------------------------- LMDB reader
class CaffeLMDBReader:
    """Iterate a Caffe-LMDB dataset as ``(CHW uint8 array, label)`` pairs
    in key order — drop-in capability for the reference's
    ``Read_Caffe_LMDB`` (``caffe_lmdb.py:5-34``).

    ``path`` may be the environment directory (containing ``data.mdb``,
    the ``lmdb.open`` convention) or the data file itself.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        if not os.path.exists(path):
            raise ValueError(f"lmdb: no such environment: {path}")
        with open(path, "rb") as f:
            self._buf = f.read()
        if len(self._buf) < 2 * _PAGEHDRSZ + 96:
            raise ValueError(f"lmdb: file too small: {path}")
        meta = self._pick_meta(path)
        # MDB_meta: magic u32, version u32, address u64, mapsize u64,
        # then mm_dbs[2] (48 bytes each), last_pg u64, txnid u64.
        self._psize = struct.unpack_from("<I", meta, 24)[0]  # mm_dbs[0].md_pad
        if self._psize < 512 or self._psize & (self._psize - 1):
            raise ValueError(f"lmdb: implausible page size {self._psize}")
        main_db = meta[24 + 48:24 + 96]
        (self._entries, self._root) = struct.unpack_from("<QQ", main_db, 32)
        n_pages = len(self._buf) // self._psize
        if self._root != _P_INVALID and self._root >= n_pages:
            raise ValueError(f"lmdb: root page {self._root} out of range")

    def _pick_meta(self, path: str):
        """The newer of the two alternating meta pages (crash-safe commit
        protocol); both carry the magic."""
        best = None
        best_txn = -1
        # the second meta lives one page in; page size is inside the meta,
        # so probe common sizes for meta 1's offset
        offs = [_PAGEHDRSZ]
        m0 = self._buf[_PAGEHDRSZ:]
        if len(m0) >= 28 and struct.unpack_from("<I", m0, 0)[0] == _MDB_MAGIC:
            ps = struct.unpack_from("<I", m0, 24)[0]
            if 512 <= ps <= 1 << 20 and ps + _PAGEHDRSZ + 96 <= len(self._buf):
                offs.append(ps + _PAGEHDRSZ)
        for off in offs:
            m = self._buf[off:off + 144]
            if len(m) < 144:
                continue
            magic, version = struct.unpack_from("<II", m, 0)
            if magic != _MDB_MAGIC or version != _MDB_VERSION:
                continue
            txn = struct.unpack_from("<Q", m, 24 + 96 + 8)[0]
            if txn >= best_txn:
                best, best_txn = m, txn
        if best is None:
            raise ValueError(f"lmdb: bad meta pages (not an LMDB file): {path}")
        return best

    # -------------------------------------------------------- tree walking
    def _page(self, pgno: int) -> Tuple[int, bytes]:
        off = pgno * self._psize
        if off + self._psize > len(self._buf):
            raise ValueError(f"lmdb: page {pgno} beyond end of file")
        pg = self._buf[off:off + self._psize]
        flags = struct.unpack_from("<H", pg, 10)[0]
        return flags, pg

    def _iter_pairs(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        flags, pg = self._page(pgno)
        lower = struct.unpack_from("<H", pg, 12)[0]
        nkeys = (lower - _PAGEHDRSZ) // 2
        if nkeys < 0 or lower > self._psize:
            raise ValueError(f"lmdb: corrupt page {pgno} bounds")
        ptrs = struct.unpack_from(f"<{nkeys}H", pg, _PAGEHDRSZ)
        if flags & _P_BRANCH:
            for p in ptrs:
                lo, hi, fl = struct.unpack_from("<HHH", pg, p)
                child = lo | (hi << 16) | (fl << 32)
                yield from self._iter_pairs(child)
            return
        if not flags & _P_LEAF:
            raise ValueError(f"lmdb: page {pgno} is neither branch nor leaf")
        for p in ptrs:
            lo, hi, fl, ksize = struct.unpack_from("<HHHH", pg, p)
            dsize = lo | (hi << 16)
            key = pg[p + 8:p + 8 + ksize]
            vstart = p + 8 + ksize
            if fl & _F_BIGDATA:
                (ovpg,) = struct.unpack_from("<Q", pg, vstart)
                _, ov = self._page(ovpg)
                n_ov = struct.unpack_from("<I", ov, 12)[0]  # pb_pages
                off = ovpg * self._psize + _PAGEHDRSZ
                if off + dsize > len(self._buf) or dsize > n_ov * self._psize:
                    raise ValueError("lmdb: overflow value out of range")
                yield key, self._buf[off:off + dsize]
            else:
                yield key, pg[vstart:vstart + dsize]

    # ------------------------------------------------------------- public
    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Raw ``(key, value)`` pairs in key order."""
        if self._root == _P_INVALID:
            return
        yield from self._iter_pairs(self._root)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        for _key, value in self.items():
            yield decode_datum(value)

    def __len__(self) -> int:
        return int(self._entries)


# ------------------------------------------------------------- LMDB writer
def write_caffe_lmdb(path: str,
                     items: Iterable[Tuple[np.ndarray, int]]) -> int:
    """Write ``(CHW uint8 array, label)`` pairs as a Caffe-LMDB environment
    at directory ``path`` (keys ``b"%08d"`` like Caffe's tools).  Minimal
    single-commit writer: one leaf page, or one branch level of leaf pages;
    values too big for half a page go to overflow chains.  Returns the
    entry count."""
    psize = 4096
    pairs: List[Tuple[bytes, bytes]] = [
        (b"%08d" % i, encode_datum(arr, label))
        for i, (arr, label) in enumerate(items)
    ]

    pages: List[bytes] = []  # data pages, page number = 2 + index
    hdr_pages: List[int] = []  # indices whose header pgno must be patched

    def add_page(raw: bytes) -> int:
        pages.append(raw.ljust(psize, b"\0"))
        hdr_pages.append(len(pages) - 1)
        return 2 + len(pages) - 1

    def page_hdr(pgno: int, flags: int, lower: int, upper: int) -> bytes:
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    def ov_hdr(pgno: int, n_pages: int) -> bytes:
        return struct.pack("<QHHI", pgno, 0, _P_OVERFLOW, n_pages)

    # value larger than this goes to overflow (mdb's nodemax is ~psize/2;
    # any threshold <= that reads back fine)
    big = psize // 2 - 64

    def build_leaf(chunk: List[Tuple[bytes, bytes]],
                   overflow: List[Tuple[int, bytes]]) -> bytes:
        """chunk -> leaf page bytes; big values appended to ``overflow`` as
        (node_offset_patch_index, value) handled by caller via pgno slots."""
        nodes = []
        for key, val in chunk:
            if len(val) > big:
                # 8-byte pgno slot patched after overflow pages are placed
                nodes.append((key, None, len(val)))
            else:
                nodes.append((key, val, len(val)))
        # layout nodes from the top down
        ptrs = []
        blob = bytearray(psize)
        upper = psize
        for key, val, dsize in nodes:
            body = val if val is not None else b"\0" * 8
            sz = 8 + len(key) + len(body)
            sz += sz & 1  # even alignment
            upper -= sz
            ptrs.append(upper)
            fl = 0 if val is not None else _F_BIGDATA
            struct.pack_into("<HHHH", blob, upper, dsize & 0xFFFF,
                             (dsize >> 16) & 0xFFFF, fl, len(key))
            blob[upper + 8:upper + 8 + len(key)] = key
            blob[upper + 8 + len(key):upper + 8 + len(key) + len(body)] = body
        lower = _PAGEHDRSZ + 2 * len(nodes)
        if lower > upper:
            raise ValueError("lmdb writer: chunk does not fit a page")
        struct.pack_into(f"<{len(ptrs)}H", blob, _PAGEHDRSZ, *ptrs)
        # header pgno patched by caller
        blob[0:_PAGEHDRSZ] = page_hdr(0, _P_LEAF, lower, upper)
        for (key, val, dsize), p in zip(nodes, ptrs):
            if val is None:
                overflow.append((p + 8 + len(key), dsize))
        return bytes(blob)

    # chunk pairs into leaves by size
    leaves: List[List[Tuple[bytes, bytes]]] = [[]]
    used = _PAGEHDRSZ
    for key, val in pairs:
        body = 8 if len(val) > big else len(val)
        sz = 8 + len(key) + body
        sz += sz & 1
        if used + 2 + sz > psize and leaves[-1]:
            leaves.append([])
            used = _PAGEHDRSZ
        leaves[-1].append((key, val))
        used += 2 + sz
    if not pairs:
        leaves = []

    # materialize leaves, then overflow chains, then (maybe) a branch root
    leaf_pgnos = []
    patches: List[Tuple[int, int, bytes]] = []  # (leaf_idx, offset, value)
    leaf_blobs = []
    for chunk in leaves:
        ovs: List[Tuple[int, int]] = []
        blob = build_leaf(chunk, ovs)
        bigvals = [val for _k, val in chunk if len(val) > big]
        leaf_blobs.append((blob, ovs, bigvals))

    n_branch = n_ov = 0
    for blob, ovs, bigvals in leaf_blobs:
        pgno = add_page(blob)
        leaf_pgnos.append(pgno)
        for (slot_off, dsize), val in zip(ovs, bigvals):
            n_pages = (len(val) + _PAGEHDRSZ + psize - 1) // psize
            raw = ov_hdr(0, n_pages) + val
            ovpg = 2 + len(pages)
            # overflow chains may span multiple page slots
            full = raw.ljust(n_pages * psize, b"\0")
            for k in range(n_pages):
                pages.append(full[k * psize:(k + 1) * psize])
            n_ov += n_pages
            # patch chain header pgno + the leaf's value slot
            first = bytearray(pages[ovpg - 2])
            first[0:8] = struct.pack("<Q", ovpg)
            pages[ovpg - 2] = bytes(first)
            lp = bytearray(pages[pgno - 2])
            struct.pack_into("<Q", lp, slot_off, ovpg)
            pages[pgno - 2] = bytes(lp)

    if not leaf_pgnos:
        root = _P_INVALID
        depth = 0
    elif len(leaf_pgnos) == 1:
        root = leaf_pgnos[0]
        depth = 1
    else:
        # one branch root over the leaves (first node carries an empty key)
        blob = bytearray(psize)
        ptrs = []
        upper = psize
        for i, (chunk, pgno) in enumerate(zip(leaves, leaf_pgnos)):
            key = b"" if i == 0 else chunk[0][0]
            sz = 8 + len(key)
            sz += sz & 1
            upper -= sz
            ptrs.append(upper)
            struct.pack_into("<HHHH", blob, upper, pgno & 0xFFFF,
                             (pgno >> 16) & 0xFFFF, (pgno >> 32) & 0xFFFF,
                             len(key))
            blob[upper + 8:upper + 8 + len(key)] = key
        lower = _PAGEHDRSZ + 2 * len(ptrs)
        struct.pack_into(f"<{len(ptrs)}H", blob, _PAGEHDRSZ, *ptrs)
        blob[0:_PAGEHDRSZ] = page_hdr(0, _P_BRANCH, lower, upper)
        root = add_page(bytes(blob))
        n_branch = 1
        depth = 2

    # patch page numbers into the headers of branch/leaf pages (overflow
    # first pages were patched when placed; continuation pages are raw
    # value bytes and must not be touched)
    for i in hdr_pages:
        pg = bytearray(pages[i])
        if struct.unpack_from("<H", pg, 10)[0] != _P_OVERFLOW:
            struct.pack_into("<Q", pg, 0, 2 + i)
        pages[i] = bytes(pg)

    last_pg = 1 + len(pages)

    def meta(txnid: int) -> bytes:
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0,
                              _P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, depth, n_branch,
                              len(leaf_pgnos), n_ov, len(pairs), root)
        body = struct.pack("<IIQQ", _MDB_MAGIC, _MDB_VERSION, 0,
                           max(len(pages) + 2, 16) * psize)
        body += free_db + main_db
        body += struct.pack("<QQ", last_pg, txnid)
        return (page_hdr(txnid, _P_META, 0, 0) + body).ljust(psize, b"\0")

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(meta(0))
        f.write(meta(1))
        for pg in pages:
            f.write(pg)
    return len(pairs)
