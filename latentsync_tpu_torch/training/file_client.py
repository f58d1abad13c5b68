"""Storage backends for restoration training data
(ref:basicsr/utils/file_client.py, ref:basicsr/utils/lmdb_util.py).

Counterpart of ``latentsync_tpu/training/file_client.py``, kept as its own
copy (the port imports nothing of the JAX package): the same byte format,
so either package reads what the other writes.

The reference trains FFHQ from LMDB blobs through a pluggable FileClient
(disk / lmdb / memcached). This re-derivation keeps the same get() /
get_text() client surface and adds a dependency-free LMDB codec:

- `LmdbReader` — a pure-Python, mmap-backed reader of the LMDB on-disk
  format (meta page selection by txnid, B-tree descent, leaf nodes,
  F_BIGDATA overflow chains). The `lmdb` wheel is not needed: the
  format itself (lmdb.h / mdb.c data version 1) is stable
  and small enough to parse directly — and reading via one shared mmap
  per host process is exactly what the C library does anyway.
- `LmdbWriter` — bulk writer (sorted keys → packed leaves → branch
  levels) emitting the same format; used by `make_lmdb_from_imgs`
  (ref:lmdb_util.py:9-129) and as the fixture generator for the reader
  tests. Derived from the published struct layout; if the real `lmdb`
  package is importable it is preferred for both ends automatically.

Byte-layout notes (64-bit, little-endian, data version 1):
  page header (16B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  meta page: header + magic u32 (0xBEEFC0DE) | version u32 | address u64
             | mapsize u64 | dbs[2] (48B each) | last_pg u64 | txnid u64
  db (48B): pad u32 | flags u16 | depth u16 | branch u64 | leaf u64
            | overflow u64 | entries u64 | root u64   (dbs[0].pad = psize)
  node (8B hdr): lo u16 | hi u16 | flags u16 | ksize u16 | key | data
    leaf:   datasize = lo | hi<<16; F_BIGDATA(0x01) → data = u64 ovpgno
    branch: child pgno = lo | hi<<16 | flags<<32
  overflow page: header (pb_pages u32 at offset 12) + raw data spanning
    pages*psize - 16 contiguous bytes.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF
PAGEHDRSZ = 16
PSIZE = 4096

_PAGEHDR = struct.Struct("<QHHHH")
_NODEHDR = struct.Struct("<HHHH")
_DB = struct.Struct("<IHHQQQQQ")
_META_HEAD = struct.Struct("<IIQQ")


def _even(n: int) -> int:
    return (n + 1) & ~1


def _nodemax(psize: int) -> int:
    # mdb.c: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2
    return ((psize - PAGEHDRSZ) // 2) & ~1


class LmdbReader:
    """Read-only keyed-blob access to an LMDB environment directory
    (or a bare data.mdb file) without the lmdb package."""

    def __init__(self, path: str):
        data = path if path.endswith(".mdb") else os.path.join(path, "data.mdb")
        self._f = open(data, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0, PSIZE)
        psize = meta0["psize"] or PSIZE
        meta0 = self._read_meta(0, psize)
        meta1 = self._read_meta(1, psize)
        meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        if meta["magic"] != MAGIC:
            raise ValueError(f"{data}: not an LMDB data file")
        if meta["version"] != VERSION:
            raise ValueError(f"{data}: LMDB data version {meta['version']} "
                             f"(reader implements version {VERSION})")
        self.psize = meta["psize"]
        self.entries = meta["main"][6]
        self._root = meta["main"][7]

    def _read_meta(self, n: int, psize: int) -> Dict:
        off = n * psize + PAGEHDRSZ
        magic, version, _addr, _mapsize = _META_HEAD.unpack_from(self._m, off)
        free = _DB.unpack_from(self._m, off + 24)
        main = _DB.unpack_from(self._m, off + 24 + 48)
        (last_pg, txnid) = struct.unpack_from("<QQ", self._m, off + 24 + 96)
        return {"magic": magic, "version": version, "psize": free[0],
                "free": free, "main": main, "last_pg": last_pg,
                "txnid": txnid}

    # -- page/node parsing --------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, List[int]]:
        base = pgno * self.psize
        _pg, _pad, flags, lower, _upper = _PAGEHDR.unpack_from(self._m, base)
        nkeys = (lower - PAGEHDRSZ) // 2
        ptrs = list(struct.unpack_from(f"<{nkeys}H", self._m,
                                       base + PAGEHDRSZ)) if nkeys else []
        return base, flags, ptrs

    def _node(self, base: int, off: int) -> Tuple[bytes, int, int, int]:
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._m, base + off)
        kstart = base + off + 8
        key = self._m[kstart:kstart + ksize]
        return key, lo, hi, flags

    def _leaf_value(self, base: int, off: int) -> bytes:
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._m, base + off)
        dsize = lo | (hi << 16)
        dstart = base + off + 8 + ksize
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._m, dstart)
            s = ovpg * self.psize + PAGEHDRSZ
            return self._m[s:s + dsize]
        return self._m[dstart:dstart + dsize]

    # -- lookup / iteration -------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            base, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                # node i holds the lowest key of subtree i; node 0's key
                # is ignored by the C search too (low bound starts at 1)
                child = 0
                for i, off in enumerate(ptrs):
                    k, lo, hi, nflags = self._node(base, off)
                    if i > 0 and k > key:
                        break
                    child = lo | (hi << 16) | (nflags << 32)
                pgno = child
            elif flags & P_LEAF:
                for off in ptrs:
                    k, _lo, _hi, _f = self._node(base, off)
                    if k == key:
                        return self._leaf_value(base, off)
                return None
            else:  # pragma: no cover — corrupt page
                raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            base, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                for off in reversed(ptrs):
                    _k, lo, hi, nflags = self._node(base, off)
                    stack.append(lo | (hi << 16) | (nflags << 32))
            else:
                for off in ptrs:
                    k, _lo, _hi, _f = self._node(base, off)
                    yield k, self._leaf_value(base, off)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def close(self):
        self._m.close()
        self._f.close()


class LmdbWriter:
    """Bulk-build an LMDB environment from (key, value) pairs.

    Emits data.mdb in one pass: values >nodemax spill to overflow
    chains, sorted nodes pack into leaves, then branch levels are built
    bottom-up. Not an incremental transaction engine — the equivalent of
    the reference's write-once dataset prep (ref:lmdb_util.py LmdbMaker),
    which also only ever bulk-loads."""

    def __init__(self, path: str, psize: int = PSIZE):
        self.path = path
        self.psize = psize
        self._pairs: List[Tuple[bytes, bytes]] = []

    def put(self, key, value: bytes):
        if isinstance(key, str):
            key = key.encode()
        self._pairs.append((bytes(key), bytes(value)))

    # -- layout -------------------------------------------------------------

    def _build_pages(self):
        psize, nodemax = self.psize, _nodemax(self.psize)
        pages: List[bytes] = []  # data pages, index 0 ⇒ pgno 2
        next_pg = 2
        stats = {"leaf": 0, "branch": 0, "overflow": 0}

        def page_bytes(flags: int, nodes: List[bytes], pgno: int) -> bytes:
            lower = PAGEHDRSZ + 2 * len(nodes)
            body = b"".join(nodes[::-1])  # nodes packed top-down
            upper = psize - len(body)
            ptrs, off = [], psize
            for n in nodes:
                off -= len(n)
                ptrs.append(off)
            buf = bytearray(psize)
            _PAGEHDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
            struct.pack_into(f"<{len(ptrs)}H", buf, PAGEHDRSZ, *ptrs)
            buf[upper:] = body
            return bytes(buf)

        # leaves (+ overflow chains interleaved at allocation order)
        pairs = sorted(self._pairs)
        if len({k for k, _ in pairs}) != len(pairs):
            raise ValueError("duplicate keys")
        leaf_entries: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_room = psize - PAGEHDRSZ

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_room, next_pg
            if not cur_nodes:
                return
            leaf_entries.append((cur_first, next_pg))
            pages.append(page_bytes(P_LEAF, cur_nodes, next_pg))
            stats["leaf"] += 1
            next_pg += 1
            cur_nodes, cur_first, cur_room = [], None, psize - PAGEHDRSZ

        ov_chunks: List[Tuple[int, bytes]] = []  # (pgno, raw chain)

        for key, value in pairs:
            if 8 + len(key) + len(value) > nodemax:
                npages = -(-(PAGEHDRSZ + len(value)) // psize)
                node = (_NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                                      F_BIGDATA, len(key))
                        + key + struct.pack("<Q", 0))  # pgno patched below
                node_sz = _even(len(node))
            else:
                node = (_NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                                      0, len(key)) + key + value)
                npages = 0
                node_sz = _even(len(node))
            if node_sz + 2 > cur_room:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            if npages:
                # allocate the overflow chain NOW so pgnos stay ordered;
                # the leaf page itself is allocated at flush time, so
                # patch the ov pgno into the node lazily via a marker
                ovpg = next_pg
                next_pg += npages
                hdr = bytearray(PAGEHDRSZ)
                _PAGEHDR.pack_into(hdr, 0, ovpg, 0, P_OVERFLOW, 0, 0)
                struct.pack_into("<I", hdr, 12, npages)
                chain = bytes(hdr) + value
                chain += b"\0" * (npages * psize - len(chain))
                ov_chunks.append((ovpg, chain))
                stats["overflow"] += npages
                node = node[:-8] + struct.pack("<Q", ovpg)
            node += b"\0" * (node_sz - len(node))
            cur_nodes.append(node)
            cur_room -= node_sz + 2
        flush_leaf()

        # hole-free image: leaves/overflow were allocated pgnos in order,
        # but `pages` holds only leaves — rebuild in pgno order
        by_pgno: Dict[int, bytes] = {}
        for pg, chain in ov_chunks:
            for i in range(len(chain) // psize):
                by_pgno[pg + i] = chain[i * psize:(i + 1) * psize]
        leaf_iter = iter(pages)
        for first_key, pg in leaf_entries:
            by_pgno[pg] = next(leaf_iter)

        # branch levels bottom-up
        level = leaf_entries
        depth = 1
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            nodes: List[bytes] = []
            first: Optional[bytes] = None
            room = psize - PAGEHDRSZ

            def flush_branch():
                nonlocal nodes, first, room, next_pg
                if not nodes:
                    return
                nxt.append((first, next_pg))
                by_pgno[next_pg] = page_bytes(P_BRANCH, nodes, next_pg)
                stats["branch"] += 1
                next_pg += 1
                nodes, first, room = [], None, psize - PAGEHDRSZ

            for i, (k, child) in enumerate(level):
                ksize = 0 if not nodes else len(k)  # node 0: empty key
                node = _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                     (child >> 32) & 0xFFFF, ksize)
                node += k[:ksize]
                sz = _even(len(node))
                if sz + 2 > room:
                    flush_branch()
                    node = _NODEHDR.pack(child & 0xFFFF,
                                         (child >> 16) & 0xFFFF,
                                         (child >> 32) & 0xFFFF, 0)
                    sz = _even(len(node))
                if first is None:
                    first = k
                nodes.append(node + b"\0" * (sz - len(node)))
                room -= sz + 2
            flush_branch()
            level = nxt

        root = level[0][1] if level else P_INVALID
        return by_pgno, next_pg, root, depth if level else 0, stats

    def close(self):
        by_pgno, next_pg, root, depth, stats = self._build_pages()
        psize = self.psize
        os.makedirs(self.path, exist_ok=True)
        data = os.path.join(self.path, "data.mdb")
        with open(data, "wb") as f:
            for n in (0, 1):
                buf = bytearray(psize)
                _PAGEHDR.pack_into(buf, 0, n, 0, P_META, 0, 0)
                _META_HEAD.pack_into(buf, PAGEHDRSZ, MAGIC, VERSION, 0,
                                     next_pg * psize)
                _DB.pack_into(buf, PAGEHDRSZ + 24,  # FREE_DBI: psize + empty
                              psize, 0, 0, 0, 0, 0, 0, P_INVALID)
                _DB.pack_into(buf, PAGEHDRSZ + 24 + 48,  # MAIN_DBI
                              0, 0, depth, stats["branch"], stats["leaf"],
                              stats["overflow"], len(self._pairs), root)
                struct.pack_into("<QQ", buf, PAGEHDRSZ + 24 + 96,
                                 next_pg - 1, 1)
                f.write(buf)
            for pg in range(2, next_pg):
                f.write(by_pgno[pg])


def make_lmdb_from_imgs(data_path: str, lmdb_path: str,
                        img_path_list: List[str], keys: List[str],
                        compress_level: int = 1) -> None:
    """Build an image LMDB + meta_info.txt the way the reference prep
    does (ref:basicsr/utils/lmdb_util.py:9-129): each value is the
    PNG-encoded image, meta lines are '<key>.png (h,w,c) <level>'."""
    import cv2

    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'")
    if len(img_path_list) != len(keys):
        raise ValueError(f"{len(img_path_list)} images vs {len(keys)} keys")
    writer = LmdbWriter(lmdb_path)
    meta: List[str] = []
    for rel, key in zip(img_path_list, keys):
        img = cv2.imread(os.path.join(data_path, rel), cv2.IMREAD_UNCHANGED)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        ok, enc = cv2.imencode(
            ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        if not ok:  # pragma: no cover
            raise ValueError(f"encode failed: {rel}")
        writer.put(key, enc.tobytes())
        meta.append(f"{key}.png ({h},{w},{c}) {compress_level}")
    writer.close()
    with open(os.path.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.write("\n".join(meta) + "\n")


def read_lmdb_meta(lmdb_path: str) -> List[str]:
    """Keys from meta_info.txt (the basicsr dataset index convention)."""
    with open(os.path.join(lmdb_path, "meta_info.txt")) as f:
        return [line.split(".png")[0] for line in f if line.strip()]


class _DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath) as f:
            return f.read()


class _LmdbBackend:
    """(ref:file_client.py:74-129) — multiple named environments
    ('lq'/'gt'), each opened once and shared."""

    def __init__(self, db_paths, client_keys="default", **kwargs):
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(db_paths) != len(client_keys):
            raise ValueError("db_paths and client_keys length mismatch")
        self._clients = {}
        for key, path in zip(client_keys, db_paths):
            try:
                import lmdb  # the real package wins when present

                env = lmdb.open(str(path), readonly=True, lock=False,
                                readahead=False, **kwargs)

                class _Env:
                    def __init__(self, env):
                        self.env = env

                    def get(self, k):
                        with self.env.begin(write=False) as txn:
                            return txn.get(k)

                self._clients[key] = _Env(env)
            except ImportError:
                self._clients[key] = LmdbReader(str(path))

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if client_key not in self._clients:
            raise ValueError(f"client_key {client_key} not configured")
        value = self._clients[client_key].get(str(filepath).encode())
        if value is None:
            raise KeyError(f"{filepath} not in lmdb '{client_key}'")
        return value

    def get_text(self, filepath: str) -> str:  # pragma: no cover
        raise NotImplementedError


class FileClient:
    """(ref:file_client.py:132-168) — backend='disk' | 'lmdb'.
    ('memcached' needs the proprietary mc client and is not shipped.)"""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend == "disk":
            self.client = _DiskBackend()
        elif backend == "lmdb":
            self.client = _LmdbBackend(**kwargs)
        else:
            raise ValueError(f"backend {backend!r} not supported "
                             "(disk, lmdb)")
        self.backend = backend

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)
