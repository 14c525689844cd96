"""Structure-of-array packing of transactional histories (the port's copy).

A copy of the `PackedTxns` layout of `jepsen_tpu/history/soa.py`: a
completed history flattened into dense numpy arrays, laid out so that
Elle-style edge inference runs as vectorized segment ops on the device.

Layout (all int32 unless noted):

  txn_*   — one row per completed client transaction (ok / fail / info):
            type (i8: 1 ok, 2 fail, 3 info), process, invoke_pos /
            complete_pos (event indices in the original history — these are
            the realtime & process orders), orig_index (completion op index).
  mop_*   — one row per micro-op, flattened across all txns in txn order:
            txn (owner), kind (i8: 0 append/write, 1 read), key (dense id),
            val (append/write value id), rd_start / rd_len (list-append read
            lists into rd_elems; rd_len == -1 means the read's result is
            unknown — info/fail).
  rd_elems — concatenated list-append read lists (value ids).

Keys and values are remapped to dense ids; `key_names` / `val_names` map
back for reporting.  Value ids are globally unique *per (key, value) pair*
so that `(key, val_id)` identity is just `val_id`.

`pack_txns` (with its chunk-feedable `TxnPacker`) flattens an op history;
`packed_from_arrays` takes any object with these field names, a
`PackedTxns` of the JAX package included.  `save_packed` / `load_packed`
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np

from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, History, Op

MOP_APPEND = 0  # also rw-register write
MOP_READ = 1

TXN_OK = 1
TXN_FAIL = 2
TXN_INFO = 3


@dataclasses.dataclass
class PackedTxns:
    """A transactional history flattened to structure-of-arrays."""

    # per-txn
    txn_type: np.ndarray  # i8 [T]
    txn_process: np.ndarray  # i32 [T]
    txn_invoke_pos: np.ndarray  # i32 [T]
    txn_complete_pos: np.ndarray  # i32 [T]
    txn_orig_index: np.ndarray  # i32 [T]
    # per-mop
    mop_txn: np.ndarray  # i32 [M]
    mop_kind: np.ndarray  # i8 [M]
    mop_key: np.ndarray  # i32 [M]
    mop_val: np.ndarray  # i32 [M]
    mop_rd_start: np.ndarray  # i32 [M]
    mop_rd_len: np.ndarray  # i32 [M]
    rd_elems: np.ndarray  # i32 [R]
    # id maps
    key_names: List[Any]
    val_names: Sequence[Any]  # val id -> (key id, value)
    n_events: int  # number of events in the original history

    @property
    def n_txns(self) -> int:
        return len(self.txn_type)

    @property
    def n_mops(self) -> int:
        return len(self.mop_txn)

    @property
    def n_keys(self) -> int:
        return len(self.key_names)

    @property
    def n_vals(self) -> int:
        return len(self.val_names)


PACKED_COLS = (
    "txn_type", "txn_process", "txn_invoke_pos", "txn_complete_pos",
    "txn_orig_index", "mop_txn", "mop_kind", "mop_key", "mop_val",
    "mop_rd_start", "mop_rd_len", "rd_elems",
)


def packed_from_arrays(obj: Any) -> PackedTxns:
    """A `PackedTxns` from any object with the `PackedTxns` field names
    (array fields are copied as numpy arrays of their own dtype; the id
    maps are kept as given — only their lengths are read)."""
    cols = {name: np.array(getattr(obj, name)) for name in PACKED_COLS}
    return PackedTxns(**cols, key_names=list(obj.key_names),
                      val_names=obj.val_names, n_events=int(obj.n_events))


class _DenseValNames:
    """Lazy `val_names` for densely-id'd histories: val id v maps to
    (key_of_v, v).  Reconstructs key_of_v from the mop columns on first
    access; `len()` never materializes anything.  Lets a 10M-txn
    history carry its names without building 30M Python tuples."""

    def __init__(self, n_vals: int, mop_key: np.ndarray, mop_val: np.ndarray):
        self._n = n_vals
        self._mop_key = mop_key
        self._mop_val = mop_val
        self._val_keys: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self._n

    def _keys(self) -> np.ndarray:
        if self._val_keys is None:
            vk = np.full(self._n, -1, dtype=np.int32)
            w = self._mop_val >= 0
            vk[self._mop_val[w]] = self._mop_key[w]
            self._val_keys = vk
        return self._val_keys

    def __getitem__(self, v):
        if isinstance(v, slice):
            return [self[i] for i in range(*v.indices(self._n))]
        if v < 0:
            v += self._n  # match list semantics (the eager form)
        if not 0 <= v < self._n:
            raise IndexError(v)
        return (int(self._keys()[v]), int(v))


def _mops_of(op: Op) -> Sequence:
    v = op.value
    if v is None:
        return []
    if not isinstance(v, (list, tuple)):
        raise ValueError(f"txn op value must be a list of mops, got {v!r}")
    return v


_CHUNK_COLS = (
    ("txn_type", np.int8), ("txn_process", np.int32),
    ("txn_invoke_pos", np.int32), ("txn_complete_pos", np.int32),
    ("txn_orig_index", np.int32), ("mop_txn", np.int32),
    ("mop_kind", np.int8), ("mop_key", np.int32), ("mop_val", np.int32),
    ("mop_rd_start", np.int32), ("mop_rd_len", np.int32),
    ("rd_elems", np.int32),
)


class TxnPacker:
    """Chunk-feedable packer: flattens completed client txns to SoA
    column chunks without ever holding the whole op list.

    The streaming equivalent of the reference's big-vector blocks +
    soft-reference chunks (`store/format.clj`, `history/core.clj`,
    SURVEY.md §2.2 "Chunked storage"): `feed(ops)` consumes one history
    chunk in order and returns that chunk's column arrays with *global*
    txn ids and read-element offsets, so chunks can be shipped to the
    device as they are packed.  Host state
    between chunks is O(concurrency + distinct keys/values): the
    pending-invocation table plus the interner maps.
    """

    def __init__(self, workload: str = "list-append"):
        self.la = workload == "list-append"
        self.key_ids: dict = {}
        self.key_names: List[Any] = []
        self.val_ids: dict = {}  # (key_id, value) -> val id
        self.val_names: List[Any] = []
        self.pending: dict = {}  # process -> invoke Op
        self.pos = 0             # global event position
        self.n_txns = 0
        self.n_mops = 0
        self.max_mops_txn = 0  # longest single txn seen (layout fact
        #                        consumed by streamed device staging)
        self.n_rd_elems = 0

    def _key_id(self, k) -> int:
        i = self.key_ids.get(k)
        if i is None:
            i = len(self.key_names)
            self.key_ids[k] = i
            self.key_names.append(k)
        return i

    def _val_id(self, ki: int, v) -> int:
        i = self.val_ids.get((ki, v))
        if i is None:
            i = len(self.val_names)
            self.val_ids[(ki, v)] = i
            self.val_names.append((ki, v))
        return i

    def feed(self, ops: Sequence[Op]) -> dict:
        """Pack one chunk of ops (must be fed in history order).  Returns
        {column: np.ndarray} for the txns COMPLETED in this chunk."""
        cols: dict = {name: [] for name, _ in _CHUNK_COLS}
        for op in ops:
            pos = self.pos
            self.pos += 1
            if not op.is_client_op():
                continue
            if op.type == INVOKE:
                self.pending[op.process] = op
                continue
            inv = self.pending.pop(op.process, None)
            if op.type == OK:
                ttype, mops, known_reads = TXN_OK, _mops_of(op), True
            else:
                src = inv if inv is not None else op
                ttype = TXN_FAIL if op.type == FAIL else TXN_INFO
                mops, known_reads = _mops_of(src), False
            t = self.n_txns
            self.n_txns += 1
            self.max_mops_txn = max(self.max_mops_txn, len(mops))
            cols["txn_type"].append(ttype)
            cols["txn_process"].append(int(op.process))
            cols["txn_invoke_pos"].append(inv.index if inv is not None
                                          else pos)
            cols["txn_complete_pos"].append(pos)
            cols["txn_orig_index"].append(op.index)
            for m in mops:
                fkind = m[0]
                k = self._key_id(m[1])
                self.n_mops += 1
                cols["mop_txn"].append(t)
                cols["mop_key"].append(k)
                if fkind in ("append", "w"):
                    cols["mop_kind"].append(MOP_APPEND)
                    cols["mop_val"].append(self._val_id(k, m[2]))
                    cols["mop_rd_start"].append(-1)
                    cols["mop_rd_len"].append(-1)
                elif fkind == "r":
                    cols["mop_kind"].append(MOP_READ)
                    rv = m[2] if len(m) > 2 else None
                    if self.la:
                        cols["mop_val"].append(-1)
                        if known_reads and rv is not None:
                            cols["mop_rd_start"].append(self.n_rd_elems)
                            cols["mop_rd_len"].append(len(rv))
                            cols["rd_elems"].extend(
                                self._val_id(k, v) for v in rv)
                            self.n_rd_elems += len(rv)
                        else:
                            cols["mop_rd_start"].append(-1)
                            cols["mop_rd_len"].append(-1)
                    else:  # rw-register: scalar read (None -> unborn/-1)
                        if known_reads:
                            cols["mop_val"].append(
                                -1 if rv is None else self._val_id(k, rv))
                            cols["mop_rd_len"].append(0)
                        else:
                            cols["mop_val"].append(-1)
                            cols["mop_rd_len"].append(-1)
                        cols["mop_rd_start"].append(-1)
                else:
                    raise ValueError(f"unknown mop kind {fkind!r}")
        return {name: np.asarray(cols[name], dtype=dt)
                for name, dt in _CHUNK_COLS}

    def to_packed(self, chunks: Sequence[dict]) -> PackedTxns:
        """Concatenate fed chunks into one PackedTxns."""
        def cat(name, dt):
            parts = [c[name] for c in chunks]
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dt))

        return PackedTxns(
            **{name: cat(name, dt) for name, dt in _CHUNK_COLS},
            key_names=self.key_names,
            val_names=self.val_names,
            n_events=self.pos,
        )


def pack_txns(h: History | Sequence[Op], workload: str = "list-append") -> PackedTxns:
    """Flatten a history's completed client transactions to SoA arrays.

    Follows the reference's semantics for op visibility (elle/list_append.clj):
    - `ok` txns contribute their completion value (reads filled in);
    - `info` txns contribute the *invocation*'s mops — their writes may have
      committed, their reads are unknown;
    - `fail` txns' writes are known-uncommitted (used for G1a); reads unknown.
    """
    if not isinstance(h, History):
        ops = list(h)
        # raw op sequences may lack indices; (re)index unless already indexed
        h = History(ops, reindex=any(op.index < 0 for op in ops))
    pk = TxnPacker(workload)
    chunk = pk.feed(h.ops)
    return pk.to_packed([chunk])
