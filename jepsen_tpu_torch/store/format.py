"""Block-structured binary ``.jepsen`` file format (the port's copy of
`jepsen_tpu/store/format.py`: the same bytes on disk, so each package
reads the other's files).

Equivalent of the reference's `jepsen/src/jepsen/store/format.clj`
(SURVEY.md §2.1): a single on-disk file holding a test run, built from
checksummed blocks, with

- a **partial test block** (the test map minus its history and results, so
  loading a test for browsing never deserializes 10M ops),
- **chunked history blocks** (~16k ops per chunk) referenced from a history
  index block, loaded lazily one chunk at a time,
- **in-place append of results**: `save_1` appends a results block and a new
  root block and rewrites only the fixed-size root pointer at the file head —
  history blocks are never rewritten.

Layout::

    magic "JPTPUv1\\n" | u64 root-offset | block*
    block := u8 type | u64 payload-len | u32 crc32(payload) | payload

The chunked layout is what lets the checker stream a long history to the
card chunk-by-chunk (pinned host buffers -> PCIe) without materialising
the whole run in host memory, mirroring the reference's big-vector blocks +
soft-reference chunks (`jepsen/history/core.clj`).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Sequence

from jepsen_tpu_torch.history.ops import History, Op
from jepsen_tpu_torch.store import codec

MAGIC = b"JPTPUv1\n"
_ROOT_SLOT = len(MAGIC)  # offset of the u64 root pointer
_HEADER_LEN = _ROOT_SLOT + 8

# Block types.
B_ROOT = 1  # codec map {"test": off, "history": off, "results": off}
B_TEST = 2  # codec map: partial test (no history/results)
B_HISTORY_INDEX = 3  # codec map {"count": n, "chunks": [off, ...]}
B_HISTORY_CHUNK = 4  # codec list of op dicts
B_RESULTS = 5  # codec map

CHUNK_SIZE = 16384  # ops per history chunk, as in the reference (~16k)

_BLOCK_HDR = struct.Struct("<BQI")


class FormatError(Exception):
    pass


def _write_block(f, btype: int, payload: bytes) -> int:
    """Append one block at EOF; returns its offset."""
    f.seek(0, os.SEEK_END)
    off = f.tell()
    f.write(_BLOCK_HDR.pack(btype, len(payload), zlib.crc32(payload)))
    f.write(zlib.compress(payload, 1))
    return off


def _read_block(f, off: int, expect: Optional[int] = None) -> bytes:
    f.seek(off)
    hdr = f.read(_BLOCK_HDR.size)
    if len(hdr) < _BLOCK_HDR.size:
        raise FormatError(f"truncated block header at {off}")
    btype, plen, crc = _BLOCK_HDR.unpack(hdr)
    if expect is not None and btype != expect:
        raise FormatError(f"expected block type {expect} at {off}, got {btype}")
    # Compressed payload runs to the next block; decompressObj consumes
    # exactly one zlib stream so we can read generously.
    d = zlib.decompressobj()
    chunks: List[bytes] = []
    try:
        while True:
            raw = f.read(1 << 20)
            if not raw:
                break
            chunks.append(d.decompress(raw))
            if d.eof:
                break
    except zlib.error as e:
        raise FormatError(f"block at {off}: corrupt payload ({e})") from e
    payload = b"".join(chunks)
    if len(payload) != plen:
        raise FormatError(f"block at {off}: length {len(payload)} != {plen}")
    if zlib.crc32(payload) != crc:
        raise FormatError(f"block at {off}: checksum mismatch")
    return payload


def _set_root(f, off: int) -> None:
    f.seek(_ROOT_SLOT)
    f.write(struct.pack("<Q", off))
    f.flush()
    os.fsync(f.fileno())


def _get_root(f) -> int:
    f.seek(_ROOT_SLOT)
    (off,) = struct.unpack("<Q", f.read(8))
    return off


class LazyHistory:
    """Chunk-lazy view of a stored history.

    Indexable and iterable like :class:`History`; chunks are decoded on
    demand and a small LRU of decoded chunks is kept (the soft-reference
    analogue).  `materialize()` returns a fully-loaded History.
    """

    def __init__(self, path: str, chunk_offsets: Sequence[int], count: int):
        self._path = path
        self._chunks = list(chunk_offsets)
        self._count = count
        self._cache: dict = {}
        self._cache_order: List[int] = []
        self._max_cached = 8

    def __len__(self) -> int:
        return self._count

    def _load_chunk(self, ci: int) -> List[Op]:
        if ci in self._cache:
            return self._cache[ci]
        with open(self._path, "rb") as f:
            payload = _read_block(f, self._chunks[ci], B_HISTORY_CHUNK)
        ops = [Op.from_dict(d) for d in codec.loads(payload)]
        self._cache[ci] = ops
        self._cache_order.append(ci)
        while len(self._cache_order) > self._max_cached:
            evict = self._cache_order.pop(0)
            self._cache.pop(evict, None)
        return ops

    def __getitem__(self, i: int) -> Op:
        if i < 0:
            i += self._count
        if not 0 <= i < self._count:
            raise IndexError(i)
        return self._load_chunk(i // CHUNK_SIZE)[i % CHUNK_SIZE]

    def __iter__(self) -> Iterator[Op]:
        for ci in range(len(self._chunks)):
            yield from self._load_chunk(ci)

    def iter_chunks(self) -> Iterator[List[Op]]:
        """Stream decoded chunks in order — the device-staging entry point."""
        for ci in range(len(self._chunks)):
            yield self._load_chunk(ci)

    def materialize(self) -> History:
        return History(list(self), reindex=False)


class JepsenFile:
    """Reader/writer for one ``.jepsen`` file."""

    def __init__(self, path: str):
        self.path = path

    # -- writing -----------------------------------------------------------

    # Never persisted: credentials would otherwise be readable by anyone
    # with store access (incl. the web UI's file browser).
    SECRET_KEYS = ("password", "private_key_path")

    def write_test(self, test: dict, history: Optional[History]) -> None:
        """Phase-0 write: partial test + chunked history + root."""
        partial = {
            k: v for k, v in test.items()
            if k not in ("history", "results") and k not in self.SECRET_KEYS
        }
        with open(self.path, "w+b") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", 0))
            test_off = _write_block(f, B_TEST, codec.dumps(partial))
            hist_off = -1
            if history is not None:
                chunk_offs = []
                ops = list(history)
                for i in range(0, len(ops), CHUNK_SIZE):
                    chunk = [op.to_dict() for op in ops[i : i + CHUNK_SIZE]]
                    chunk_offs.append(
                        _write_block(f, B_HISTORY_CHUNK, codec.dumps(chunk))
                    )
                hist_off = _write_block(
                    f,
                    B_HISTORY_INDEX,
                    codec.dumps({"count": len(ops), "chunks": chunk_offs}),
                )
            root_off = _write_block(
                f,
                B_ROOT,
                codec.dumps({"test": test_off, "history": hist_off, "results": -1}),
            )
            _set_root(f, root_off)

    def append_results(self, results: dict) -> None:
        """Phase-1 write: append results + new root; history untouched."""
        with open(self.path, "r+b") as f:
            root = codec.loads(_read_block(f, _get_root(f), B_ROOT))
            res_off = _write_block(f, B_RESULTS, codec.dumps(results))
            root["results"] = res_off
            new_root = _write_block(f, B_ROOT, codec.dumps(root))
            _set_root(f, new_root)

    # -- reading -----------------------------------------------------------

    def _root(self, f) -> dict:
        if f.read(len(MAGIC)) != MAGIC:
            raise FormatError(f"{self.path}: bad magic")
        off = _get_root(f)
        if off == 0:
            raise FormatError(f"{self.path}: no root written")
        return codec.loads(_read_block(f, off, B_ROOT))

    def read_test(self) -> dict:
        """Load the partial test map (no history/results decode)."""
        with open(self.path, "rb") as f:
            root = self._root(f)
            return codec.loads(_read_block(f, root["test"], B_TEST))

    def read_history(self) -> Optional[LazyHistory]:
        with open(self.path, "rb") as f:
            root = self._root(f)
            if root["history"] < 0:
                return None
            idx = codec.loads(_read_block(f, root["history"], B_HISTORY_INDEX))
        return LazyHistory(self.path, idx["chunks"], idx["count"])

    def read_results(self) -> Optional[dict]:
        with open(self.path, "rb") as f:
            root = self._root(f)
            if root["results"] is None or root["results"] < 0:
                return None
            return codec.loads(_read_block(f, root["results"], B_RESULTS))

    def read(self) -> dict:
        """Full load: test map with :history (lazy) and :results attached."""
        test = self.read_test()
        h = self.read_history()
        if h is not None:
            test["history"] = h
        res = self.read_results()
        if res is not None:
            test["results"] = res
        return test
