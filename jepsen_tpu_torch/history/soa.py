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

The packer itself (`TxnPacker`, `pack_txns`) is not ported yet;
`packed_from_arrays` takes any object with these field names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np

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
