"""Synthetic histories (the port's copy of parts of
`jepsen_tpu/workloads/synth.py`).

`packed_la_history` and `packed_rw_history` are copies of the vectorized
generators: they emit `PackedTxns` arrays directly, the bench path for
histories too large to build as Python Op objects.  `rw_history` is the
op-level rw-register simulator, and `lin_register_history` the
linearizable r/w/cas register simulator of the Knossos tests (BASELINE
config 1).  Tests pin each equal to the original.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, History, Op
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_OK,
    PackedTxns,
)

#: `packed_rw_history`'s arguments for BASELINE config 3 (the rw-register
#: 1M-op history), as the JAX package's `compilecache/warm.py` (`_RW_KW`)
#: and `utils/prestage.py` (`rw_history`) give them; the key count is
#: `rw_keys_for(n_txns)`
RW_KW = dict(concurrency=10, mops_per_txn=3, read_frac=0.5, seed=11)


def rw_keys_for(n_txns: int) -> int:
    """Config 3's key count for `n_txns` (`scripts/aot_warm.py`)."""
    return max(64, n_txns // 8)


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


def packed_rw_history(n_txns: int, n_keys: int, concurrency: int = 10,
                      mops_per_txn: int = 3, read_frac: float = 0.5,
                      seed: int = 0) -> PackedTxns:
    """Vectorized strict-serializable rw-register history as PackedTxns.

    Serial execution in txn order (commit order == txn index): writes get
    globally unique value ids; each read observes the latest write of its
    key by mop order (txn-major, so txn-local writes are visible).  All
    txns ok.  O(n) numpy — the BASELINE config-3 scale (1M ops) can't be
    built through Python Op objects in reasonable time.
    """
    from jepsen_tpu_torch.checkers.elle.rw_register import _seg_exclusive_max

    rng = np.random.default_rng(seed)
    T = n_txns
    M = T * mops_per_txn
    mop_txn = np.repeat(np.arange(T, dtype=np.int32), mops_per_txn)
    is_read = rng.random(M) < read_frac
    mop_kind = np.where(is_read, MOP_READ, MOP_APPEND).astype(np.int8)
    mop_key = rng.integers(0, n_keys, M).astype(np.int32)

    n_app = int((~is_read).sum())
    app_idx = np.nonzero(~is_read)[0]
    mop_val = np.full(M, -1, dtype=np.int32)
    mop_val[app_idx] = np.arange(n_app, dtype=np.int32)

    # latest write of the key strictly before each mop, via per-key runs
    mop_order = np.lexsort((np.arange(M), mop_key))
    k_sorted = mop_key[mop_order]
    run_start = np.concatenate([[True], k_sorted[1:] != k_sorted[:-1]])
    seg_id = np.cumsum(run_start) - 1
    app_sorted = (~is_read)[mop_order]
    wq = np.where(app_sorted, np.arange(M), -1)
    prev_w = _seg_exclusive_max(wq, seg_id)
    val_sorted = mop_val[mop_order]
    read_val_sorted = np.where(prev_w >= 0,
                               val_sorted[np.maximum(prev_w, 0)], -1)
    read_val = np.empty(M, dtype=np.int32)
    read_val[mop_order] = read_val_sorted
    mop_val = np.where(is_read, read_val, mop_val).astype(np.int32)

    rd_len = np.where(is_read, 0, -1).astype(np.int32)  # known scalar reads
    rd_start = np.full(M, -1, dtype=np.int32)

    txn_process = (np.arange(T, dtype=np.int32) % concurrency)
    txn_invoke_pos = (2 * np.arange(T, dtype=np.int32))
    txn_complete_pos = txn_invoke_pos + 1

    key_names = list(range(n_keys))
    app_keys = mop_key[app_idx]
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
        rd_elems=np.zeros(0, dtype=np.int32),
        key_names=key_names,
        val_names=val_names,
        n_events=2 * T,
    )


def rw_history(n_txns: int = 100, n_keys: int = 5, concurrency: int = 5,
               max_mops: int = 3, read_prob: float = 0.5,
               fail_prob: float = 0.0, info_prob: float = 0.0,
               seed: int = 0) -> History:
    """Simulate a strict-serializable rw-register history (unique writes)."""
    rng = np.random.default_rng(seed)
    db: Dict[int, Optional[int]] = {k: None for k in range(n_keys)}
    next_val = 1
    ops: List[Op] = []
    open_txn: Dict[int, List] = {}
    committed = 0
    while committed < n_txns or open_txn:
        p = int(rng.integers(0, concurrency))
        if p not in open_txn:
            if committed + len(open_txn) >= n_txns:
                if not open_txn:
                    break
                p = list(open_txn.keys())[int(rng.integers(0, len(open_txn)))]
            else:
                mops = []
                for _ in range(int(rng.integers(1, max_mops + 1))):
                    k = int(rng.integers(0, n_keys))
                    if rng.random() < read_prob:
                        mops.append(["r", k, None])
                    else:
                        mops.append(["w", k, next_val])
                        next_val += 1
                ops.append(Op(type=INVOKE, process=p, f="txn",
                              value=[list(m) for m in mops]))
                open_txn[p] = mops
                continue
        mops = open_txn.pop(p)
        committed += 1
        r = rng.random()
        if r < fail_prob:
            ops.append(Op(type=FAIL, process=p, f="txn",
                          value=[list(m) for m in mops]))
            continue
        is_info = r < fail_prob + info_prob
        apply_w = (not is_info) or rng.random() < 0.5
        local = dict(db)
        filled = []
        for m in mops:
            if m[0] == "w":
                local[m[1]] = m[2]
                filled.append(["w", m[1], m[2]])
            else:
                filled.append(["r", m[1], local[m[1]]])
        if apply_w:
            db.update(local)
        if is_info:
            ops.append(Op(type=INFO, process=p, f="txn", value=None))
        else:
            ops.append(Op(type=OK, process=p, f="txn", value=filled))
    return History(ops)


def lin_register_history(n_ops: int = 50, concurrency: int = 3,
                         stale_read_prob: float = 0.0,
                         info_prob: float = 0.05,
                         cas_prob: float = 0.2,
                         seed: int = 0) -> History:
    """Simulate a linearizable r/w/cas register; optionally inject stale
    reads (which make the history non-linearizable w.h.p.)."""
    rng = np.random.default_rng(seed)
    ops: List[Op] = []
    value = None        # current register value
    history_vals = [None]  # all past values (for stale reads)
    open_p: Dict[int, Tuple[str, object]] = {}
    done = 0
    while done < n_ops or open_p:
        p = int(rng.integers(0, concurrency))
        if p not in open_p:
            if done + len(open_p) >= n_ops:
                if not open_p:
                    break
                p = list(open_p.keys())[int(rng.integers(0, len(open_p)))]
            else:
                r = rng.random()
                if r < cas_prob:
                    f, v = "cas", [value if value is not None and
                                   rng.random() < 0.7
                                   else int(rng.integers(0, 5)),
                                   int(rng.integers(0, 5))]
                elif r < 0.6:
                    f, v = "write", int(rng.integers(0, 5))
                else:
                    f, v = "read", None
                ops.append(Op(type=INVOKE, process=p, f=f, value=v))
                open_p[p] = (f, v)
                continue
        f, v = open_p.pop(p)
        done += 1
        if rng.random() < info_prob:
            # crashed: effect applied with probability 1/2
            if f == "write" and rng.random() < 0.5:
                value = v
                history_vals.append(value)
            elif f == "cas" and value == v[0] and rng.random() < 0.5:
                value = v[1]
                history_vals.append(value)
            ops.append(Op(type=INFO, process=p, f=f, value=v))
            continue
        if f == "write":
            value = v
            history_vals.append(value)
            ops.append(Op(type=OK, process=p, f=f, value=v))
        elif f == "cas":
            if value == v[0]:
                value = v[1]
                history_vals.append(value)
                ops.append(Op(type=OK, process=p, f=f, value=v))
            else:
                ops.append(Op(type=FAIL, process=p, f=f, value=v))
        else:  # read
            rv = value
            if stale_read_prob and rng.random() < stale_read_prob \
                    and len(history_vals) > 1:
                rv = history_vals[int(rng.integers(0, len(history_vals) - 1))]
            ops.append(Op(type=OK, process=p, f=f, value=rv))
    return History(ops)
