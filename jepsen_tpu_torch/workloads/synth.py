"""Synthetic histories (the port's copy of parts of
`jepsen_tpu/workloads/synth.py`).

`la_history` simulates a strict-serializable list-append database at
the op level, and the injectors (`inject_g1a`, `inject_g1b`,
`inject_wr_cycle`, `inject_rw_cycle`) make surgical anomalies in its
histories.  `packed_la_history` and `packed_rw_history` are copies of
the vectorized generators: they emit `PackedTxns` arrays directly, the
bench path for histories too large to build as Python Op objects.
`rw_history` is the op-level rw-register simulator, and
`lin_register_history` the linearizable r/w/cas register simulator of
the Knossos tests (BASELINE config 1).  Tests pin each equal to the
original.
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


def la_history(n_txns: int = 100, n_keys: int = 5, concurrency: int = 5,
               max_mops: int = 4, read_prob: float = 0.5,
               fail_prob: float = 0.0, info_prob: float = 0.0,
               multi_append_prob: float = 0.1,
               seed: int = 0) -> History:
    """Simulate a strict-serializable list-append history.

    Each process runs txns one at a time; a txn's effects apply atomically at
    a commit point between its invoke and completion, so the result is
    always valid (strict-serializable) before any injector runs.
    """
    rng = np.random.default_rng(seed)
    db: Dict[int, List[int]] = {k: [] for k in range(n_keys)}
    append_log: Dict[int, List[int]] = {k: [] for k in range(n_keys)}
    next_val = 1
    ops: List[Op] = []
    open_txn: Dict[int, Tuple[List, int]] = {}  # process -> (mops, invoke idx)
    committed = 0
    t = 0

    def gen_mops():
        nonlocal next_val
        mops = []
        n = int(rng.integers(1, max_mops + 1))
        for _ in range(n):
            k = int(rng.integers(0, n_keys))
            if rng.random() < read_prob:
                mops.append(["r", k, None])
            else:
                mops.append(["append", k, next_val])
                next_val += 1
                if rng.random() < multi_append_prob:
                    mops.append(["append", k, next_val])
                    next_val += 1
        return mops

    while committed < n_txns or open_txn:
        p = int(rng.integers(0, concurrency))
        t += 1
        if p not in open_txn:
            if committed + len(open_txn) >= n_txns:
                # drain: complete somebody instead
                if not open_txn:
                    break
                p = list(open_txn.keys())[int(rng.integers(0, len(open_txn)))]
            else:
                mops = gen_mops()
                ops.append(Op(type=INVOKE, process=p, f="txn",
                              value=[list(m) for m in mops], time=t))
                open_txn[p] = (mops, len(ops) - 1)
                continue
        # complete p's open txn
        mops, _ = open_txn.pop(p)
        r = rng.random()
        if r < fail_prob:
            ops.append(Op(type=FAIL, process=p, f="txn",
                          value=[list(m) for m in mops], time=t))
        else:
            is_info = r < fail_prob + info_prob
            apply_writes = (not is_info) or rng.random() < 0.5
            filled = []
            state_snapshot = {k: list(v) for k, v in db.items()} \
                if not apply_writes else db
            target = db if apply_writes else state_snapshot
            for m in mops:
                if m[0] == "append":
                    target[m[1]].append(m[2])
                    if apply_writes:
                        append_log[m[1]].append(m[2])
                    filled.append(["append", m[1], m[2]])
                else:
                    filled.append(["r", m[1], list(target[m[1]])])
            if is_info:
                ops.append(Op(type=INFO, process=p, f="txn",
                              value=[list(m) for m in mops], time=t))
            else:
                ops.append(Op(type=OK, process=p, f="txn", value=filled, time=t))
        committed += 1
    return History(ops)


# ---------------------------------------------------------------------------
# Anomaly injectors: surgical edits on a valid history.
# ---------------------------------------------------------------------------


def _ok_txns(h: History):
    return [op for op in h.ops if op.type == OK and op.f == "txn"]


def _appends(op: Op):
    return [(i, m) for i, m in enumerate(op.value or []) if m[0] == "append"]


def _reads(op: Op):
    return [(i, m) for i, m in enumerate(op.value or [])
            if m[0] == "r" and m[2] is not None]


def inject_g1a(h: History, rng=None) -> bool:
    """Flip an observed writer ok->fail: its reads become aborted reads."""
    observed = set()
    for op in _ok_txns(h):
        for _, m in _reads(op):
            observed.update(m[2])
    for op in _ok_txns(h):
        vals = [m[2] for _, m in _appends(op)]
        if any(v in observed for v in vals):
            op.type = FAIL
            return True
    return False


def inject_g1b(h: History) -> bool:
    """Truncate a read so it ends at an intermediate (non-final) append."""
    # find a txn appending twice to one key
    for wop in _ok_txns(h):
        per_key: Dict[int, List[int]] = {}
        for _, m in _appends(wop):
            per_key.setdefault(m[1], []).append(m[2])
        for k, vs in per_key.items():
            if len(vs) < 2:
                continue
            inter = vs[0]
            for rop in _ok_txns(h):
                if rop is wop:
                    continue
                for _, m in _reads(rop):
                    if m[1] == k and inter in m[2] and m[2][-1] != inter:
                        # truncating keeps this read a prefix of longer reads,
                        # so the only injected anomaly is the G1b itself
                        m[2][:] = m[2][: m[2].index(inter) + 1]
                        return True
    return False


def _touched_keys(op: Op):
    return {m[1] for m in (op.value or [])}


def inject_wr_cycle(h: History) -> bool:
    """Create a pure wr cycle (G1c): T1 reads T2's append, T2 reads T1's."""
    oks = _ok_txns(h)
    # find two txns each having an append, in different keys
    cand = [(op, _appends(op)[0][1]) for op in oks if _appends(op)]
    for i in range(len(cand)):
        for j in range(i + 1, len(cand)):
            (t1, m1), (t2, m2) = cand[i], cand[j]
            k1, v1 = m1[1], m1[2]
            k2, v2 = m2[1], m2[2]
            # keys must be disjoint from the other txn's touched keys, or the
            # appended read would break the txn's own internal consistency
            if k1 == k2 or k2 in _touched_keys(t1) or k1 in _touched_keys(t2):
                continue
            p1 = _prefix_through(h, k1, v1)
            p2 = _prefix_through(h, k2, v2)
            if p1 is None or p2 is None:
                continue
            t1.value.append(["r", k2, p2])
            t2.value.append(["r", k1, p1])
            return True
    return False


def inject_rw_cycle(h: History) -> bool:
    """Create a write-skew-style cycle of two rw edges (G2-item).

    T1 reads key k1 missing T2's later append; T2 reads key k2 missing T1's
    append: rw edges T1->T2 and T2->T1.
    """
    oks = _ok_txns(h)
    cand = [(op, _appends(op)[0][1]) for op in oks if _appends(op)]
    for i in range(len(cand)):
        for j in range(i + 1, len(cand)):
            (t1, m1), (t2, m2) = cand[i], cand[j]
            k1, v1 = m1[1], m1[2]
            k2, v2 = m2[1], m2[2]
            if k1 == k2 or k2 in _touched_keys(t1) or k1 in _touched_keys(t2):
                continue
            p1 = _prefix_before(h, k1, v1)
            p2 = _prefix_before(h, k2, v2)
            if p1 is None or p2 is None:
                continue
            t1.value.append(["r", k2, p2])  # T1 misses v2 -> rw T1->T2
            t2.value.append(["r", k1, p1])  # T2 misses v1 -> rw T2->T1
            return True
    return False


def _key_order(h: History, k: int) -> List[int]:
    longest: List[int] = []
    for op in _ok_txns(h):
        for _, m in _reads(op):
            if m[1] == k and len(m[2]) > len(longest):
                longest = list(m[2])
    return longest


def _prefix_through(h: History, k: int, v: int) -> Optional[List[int]]:
    order = _key_order(h, k)
    if v in order:
        return order[: order.index(v) + 1]
    # v unobserved: extend the longest observed order with v (stays compatible
    # only if v was appended after everything observed — best effort)
    return None


def _prefix_before(h: History, k: int, v: int) -> Optional[List[int]]:
    order = _key_order(h, k)
    if v in order:
        return order[: order.index(v)]
    return None


# ---------------------------------------------------------------------------
# Fast vectorized packed-history generator (bench path).
# ---------------------------------------------------------------------------


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
