"""Synthetic packed list-append histories (the port's copy).

`packed_la_history` is a copy of `jepsen_tpu/workloads/synth.py`'s
vectorized generator: it emits `PackedTxns` arrays directly, the bench
path for histories too large to build as Python Op objects.  A test pins
it equal to the original.
"""

from __future__ import annotations

import numpy as np

from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_OK,
    PackedTxns,
)


def packed_la_history(n_txns: int, n_keys: int, concurrency: int = 10,
                      mops_per_txn: int = 4, read_frac: float = 0.5,
                      seed: int = 0) -> PackedTxns:
    """Vectorized strict-serializable list-append history as PackedTxns.

    Commit order == txn index.  Each txn has `mops_per_txn` mops; reads
    observe the full committed prefix of their key at commit time.  All txns
    ok.  Runs in O(n) numpy; used for 10M-op benchmarking where Python-object
    histories are too slow to build.
    """
    rng = np.random.default_rng(seed)
    T = n_txns
    M = T * mops_per_txn
    mop_txn = np.repeat(np.arange(T, dtype=np.int32), mops_per_txn)
    is_read = rng.random(M) < read_frac
    mop_kind = np.where(is_read, MOP_READ, MOP_APPEND).astype(np.int8)
    mop_key = rng.integers(0, n_keys, M).astype(np.int32)

    # Appends: assign global value ids in commit order per key -> the version
    # order of key k is exactly the sequence of append val-ids with key k.
    n_app = int((~is_read).sum())
    app_idx = np.nonzero(~is_read)[0]
    mop_val = np.full(M, -1, dtype=np.int32)
    mop_val[app_idx] = np.arange(n_app, dtype=np.int32)

    # Position of each append within its key's order (0-based).
    app_keys = mop_key[app_idx]
    order = np.argsort(app_keys, kind="stable")
    sorted_keys = app_keys[order]

    # For reads: number of appends to key k committed strictly before txn t,
    # by any txn with index < t, plus own txn's earlier appends in mop order.
    # Build per-key cumulative append counts by mop position.
    app_flag = (~is_read).astype(np.int64)
    # cumulative appends per key up to (and excluding) each mop, computed via
    # sorting mops by (key, position)
    mop_order = np.lexsort((np.arange(M), mop_key))
    k_sorted = mop_key[mop_order]
    a_sorted = app_flag[mop_order]
    key_start = np.searchsorted(k_sorted, k_sorted)
    base = np.cumsum(a_sorted) - a_sorted  # appends before this mop in key run
    run_base = base[key_start]
    before_in_key = base - run_base
    read_len = np.empty(M, dtype=np.int64)
    read_len[mop_order] = before_in_key  # appends to this key before this mop
    # This counts appends by *mop order across all txns*, which equals
    # commit-time visibility because commit order == txn order and mop order
    # is txn-major.  Reads therefore see every append with a smaller global
    # mop index and same key — including own-txn earlier appends.  This is a
    # serial execution, hence valid.

    rd_len = np.where(is_read, read_len, -1).astype(np.int32)
    rd_start = np.full(M, -1, dtype=np.int32)
    read_ids = np.nonzero(is_read)[0]
    lens = rd_len[read_ids].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if len(lens) else \
        np.zeros(0, dtype=np.int64)
    rd_start[read_ids] = starts
    R = int(lens.sum()) if len(lens) else 0

    # read elements: for read mop r of key k with length L, the first L
    # appends (val ids) of key k in global order.
    # Per-key sorted append val ids:
    app_vals_sorted = mop_val[app_idx][order]  # grouped by key, in order
    key_first_app = np.searchsorted(sorted_keys, np.arange(n_keys))
    rd_elems = np.empty(R, dtype=np.int32)
    if R:
        # element j of read i is app_vals_sorted[key_first_app[rk[i]] + j]
        rk = mop_key[read_ids].astype(np.int64)
        reps = np.repeat(np.arange(len(read_ids)), lens)
        offs = np.arange(R) - np.repeat(starts, lens)
        rd_elems[:] = app_vals_sorted[key_first_app[rk[reps]] + offs]

    txn_process = (np.arange(T, dtype=np.int32) % concurrency)
    # fully serial: invoke at 2t, complete at 2t+1 (realtime edges dense,
    # but the barrier construction keeps them O(n))
    txn_invoke_pos = (2 * np.arange(T, dtype=np.int32))
    txn_complete_pos = txn_invoke_pos + 1

    key_names = list(range(n_keys))
    # val id -> (key, value) ; value == global append id
    val_keys = np.empty(n_app, dtype=np.int64)
    val_keys[mop_val[app_idx]] = app_keys
    val_names = [(int(val_keys[v]), int(v)) for v in range(n_app)]

    return PackedTxns(
        txn_type=np.full(T, TXN_OK, dtype=np.int8),
        txn_process=txn_process,
        txn_invoke_pos=txn_invoke_pos,
        txn_complete_pos=txn_complete_pos,
        txn_orig_index=np.arange(T, dtype=np.int32) * 2 + 1,
        mop_txn=mop_txn,
        mop_kind=mop_kind,
        mop_key=mop_key,
        mop_val=mop_val,
        mop_rd_start=rd_start,
        mop_rd_len=rd_len,
        rd_elems=rd_elems,
        key_names=key_names,
        val_names=val_names,
        n_events=2 * T,
    )
