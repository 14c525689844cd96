"""Elle rw-register checker (write/read registers with unique writes) on
the device (PyTorch).

Counterpart of `jepsen_tpu/checkers/elle/rw_register.py`, the equivalent
of the reference's `elle/rw_register.clj` (SURVEY.md §2.3): txns of
``[:w k v] / [:r k v]`` mops with globally unique writes per key.
Version orders are inferred from the default sources — the initial state
(nil precedes every written version) and transaction-internal structure
(write-after-write and read-then-write sequences) — then lifted to a txn
dependency graph:

  wr — reader of version v  <- writer of v          (exact: writes unique)
  ww — writer of u -> writer of v for direct u << v
  rw — external reader of u -> writer of v for direct u << v

Non-cycle anomalies: internal, G1a (aborted read), G1b (intermediate
read), lost-update (>= 2 txns update the same observed version),
duplicate-writes, cyclic-versions (version inference contradiction).

Histories of `FUSED_MIN_TXNS` txns or more take the device path first
(`device_rw.check`: inference and sweeps on the card); a clean exact
verdict returns from there.  Anything else gets the full report of the
host path: edge inference in vectorized numpy (segment scans over
(txn, key)-sorted mops), cycle detection by the device rank sweep
(`txn_cycles.cycle_anomalies`), witness cycles and Explainer edges.

The fallback differs from the JAX package's, which degrades any error of
the device path to the host path.  Here only a synthetic `FaultInjected`
of a caller's `FaultPlan` degrades, stamped as in JAX (``"degraded":
"host-fallback"`` and ``"device-error"``); `KernelError`,
`NoDeviceError`, a sweep that does not converge and every other error
are raised.  `DeadlineExceeded` maps to the canonical deadline unknown.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from jepsen_tpu_torch import backend, resilience
from jepsen_tpu_torch.checkers.elle import consistency, device_rw
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_RW,
    REL_WR,
    REL_WW,
    EdgeList,
    nontrivial_sccs,
    process_edges,
    realtime_edges_subset,
)
from jepsen_tpu_torch.checkers.elle.txn_cycles import cycle_anomalies
from jepsen_tpu_torch.history.ir import HistoryIR
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
    PackedTxns,
    pack_txns,
)

NO_PREV = -3


FUSED_MIN_TXNS = 100_000


def sessions_guarantees():
    from jepsen_tpu_torch.checkers.elle import sessions

    return sessions.GUARANTEES


def check(history, consistency_models: Sequence[str] = ("snapshot-isolation",),
          anomalies: Sequence[str] = (), use_device: bool = True,
          max_reported: int = 8, deadline=None, policy=None,
          plan=None, device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check an rw-register history.  Accepts History / op list /
    PackedTxns (packed with workload='rw-register') / HistoryIR, whose
    packed and padded rw-register sections are built once and reused.

    With `use_device`, the device work runs on `device` (the CUDA card
    unless the caller names the CPU; no card raises
    `backend.NoDeviceError`).  Large histories take the device fast path
    first (`device_rw.check` — inference AND sweeps on the device): a
    clean exact verdict returns without any host inference; anything else
    falls through to the host path, which produces the full anomaly
    report (witness cycles, Explainer edges).  `use_device=False` is the
    host path alone, with host Tarjan for the cycles.

    Resilience: a synthetic fault of `plan` (or of the installed plan)
    that outlives its `policy` retries on the fast path degrades to the
    host path with ``"degraded": "host-fallback"`` stamped; every other
    error is raised (see the module docstring).  `deadline` expiry
    returns the canonical deadline-exceeded unknown."""
    dev = backend.resolve(device) if use_device else None
    ir = history if isinstance(history, HistoryIR) else None
    if isinstance(history, PackedTxns):
        p = history
    else:
        p = ir.packed("rw-register") if ir is not None \
            else pack_txns(history, "rw-register")
    if p.n_txns == 0 or not (p.txn_type == TXN_OK).any():
        return {"valid?": "unknown", "anomaly-types": [], "anomalies": {},
                "not": [], "also-not": []}

    # session-guarantee tokens in the requested set run the dedicated
    # per-process checker (needs the op-level history; a PackedTxns-only
    # caller skips them — the packed form drops per-process sequencing)
    want = set(consistency.anomalies_for_models(
        [consistency.canonical(m) for m in consistency_models]))
    want |= set(anomalies)
    want |= {"duplicate-writes", "cyclic-versions"}
    sess_found: Dict[str, List[Any]] = {}
    suffix = "-violation"
    sess_want = {w for w in want if w.endswith(suffix)
                 and w[:-len(suffix)] in sessions_guarantees()}
    # packed input drops the op-level view the session checker walks: a
    # session-family request then cannot be session-checked.  When the
    # request also proscribes process-edge cycles (strict/strong-session
    # class), per-session ordering violations surface as process-edge
    # cycles in the transactional graph (the reference's own treatment),
    # so the verdict stands; a BARE session request (e.g. just
    # ["monotonic-reads"]) has no such coverage and must degrade to
    # unknown rather than silently report valid
    # only G-single-process qualifies: read-centric session violations
    # (monotonic-reads, RYW) surface through anti-dependency (rw)
    # edges, which the G0-process/G1c-process projections never search
    proc_covered = "G-single-process" in want
    # full "-violation" tokens, matching the la checkers' key shape
    # (coverage.finalize_la) so callers see ONE degradation contract
    sess_unchecked = sorted(sess_want) \
        if (sess_want and isinstance(history, PackedTxns)
            and not proc_covered) else []
    if sess_want and not isinstance(history, PackedTxns):
        from jepsen_tpu_torch.checkers.elle import sessions

        sres = sessions.check(history,
                              guarantees=[w[:-len(suffix)]
                                          for w in sess_want])
        sess_found = sres["anomalies"]

    degraded = None
    device_error = None

    def finalize(result: Dict[str, Any]) -> Dict[str, Any]:
        from jepsen_tpu_torch.checkers.elle import coverage

        if degraded:
            result["degraded"] = degraded
            if device_error:
                result["device-error"] = device_error
        return coverage.apply_unchecked(result, sess_unchecked)

    if use_device and p.n_txns >= FUSED_MIN_TXNS:
        try:
            fast = device_rw.check(ir if ir is not None else p,
                                   deadline=deadline, policy=policy,
                                   plan=plan, device=dev)
        except resilience.DeadlineExceeded:
            return resilience.deadline_result(checker="rw-register")
        except resilience.FaultInjected as e:  # the degradation drill
            # the host path below IS the oracle; degrade to it through
            # the shared tail (deadline poll — an expired budget must not
            # buy an unbounded host run)
            try:
                resilience.degrade_to_host(
                    "elle.rw-register", lambda: None, e,
                    deadline=deadline)
            except resilience.DeadlineExceeded:
                return resilience.deadline_result(checker="rw-register")
            degraded = resilience.DEGRADED_HOST
            device_error = f"{type(e).__name__}: {e}"
            fast = None
        if fast is not None and fast["valid?"] is True and fast["exact"]:
            anomaly_types = sorted(sess_found)
            boundary = consistency.friendly_boundary(anomaly_types)
            bad = set(boundary["not"]) | set(boundary["also-not"])
            requested_bad = bad & {consistency.canonical(m)
                                   for m in consistency_models}
            return finalize({"valid?": not requested_bad,
                             "anomaly-types": anomaly_types,
                             "anomalies": sess_found,
                             "not": boundary["not"],
                             "also-not": boundary["also-not"],
                             "fused-device": True})
        # invalid or inexact: fall through for the detailed host report

    T = p.n_txns
    M = p.n_mops
    V = p.n_vals
    nk = max(p.n_keys, 1)
    found: Dict[str, List[Any]] = {}

    def report(name, item):
        found.setdefault(name, [])
        if len(found[name]) < max_reported:
            found[name].append(item)

    ttype = p.txn_type.astype(np.int32)
    ok = ttype == TXN_OK
    graph_txn = ok | (ttype == TXN_INFO)

    kind = p.mop_kind.astype(np.int32)
    mtxn = p.mop_txn.astype(np.int64)
    mkey = p.mop_key.astype(np.int64)
    mval = p.mop_val.astype(np.int64)
    known = np.where(kind == MOP_READ, p.mop_rd_len >= 0, True)

    # writers (unique by contract; duplicates flagged).  On a duplicate,
    # attribute the value to a *committed* writer when one exists (ok over
    # info over fail) so an aborted duplicate can't fabricate a G1a against
    # readers of the committed write; the broken contract itself is
    # reported as duplicate-writes, which invalidates read-uncommitted.
    writer = np.full(V, -1, np.int64)
    wsel = np.nonzero(kind == MOP_APPEND)[0]
    wvals = mval[wsel]
    dup = np.zeros(0, np.int64)
    if len(wsel):
        prio = np.select([ok[mtxn[wsel]], ttype[mtxn[wsel]] == TXN_INFO],
                         [0, 1], 2)
        order = np.lexsort((wsel, prio, wvals))
        sv = wvals[order]
        first = np.concatenate([[True], sv[1:] != sv[:-1]])
        writer[sv[first]] = mtxn[wsel][order][first]
        dup = np.unique(sv[~first])
    for v in dup[:max_reported]:
        report("duplicate-writes", {"value": p.val_names[int(v)]})

    # final write per (txn, key): last write mop of the run
    run_order = np.lexsort((np.arange(M), mkey, mtxn))
    rt, rk = mtxn[run_order], mkey[run_order]
    rkind = kind[run_order]
    rval = mval[run_order]
    rknown = known[run_order]
    run_start = np.concatenate([[True], (rt[1:] != rt[:-1]) |
                                (rk[1:] != rk[:-1])])
    # is this write the last write in its run?
    wpos = np.where(rkind == MOP_APPEND, np.arange(M), -1)
    # reverse cummax within segments (flip trick)
    seg_id = np.cumsum(run_start) - 1
    last_w = _seg_reverse_max(wpos, seg_id)
    r_final = (rkind == MOP_APPEND) & (np.arange(M) == last_w)
    is_final = np.zeros(V + nk, bool)
    fw = (rkind == MOP_APPEND) & r_final
    is_final[rval[fw]] = True

    # cur version before each mop within its run:
    # defining mops: writes (-> own val), known reads (-> read val)
    defines = (rkind == MOP_APPEND) | ((rkind == MOP_READ) & rknown)
    def_val = np.where(rkind == MOP_APPEND, rval,
                       np.where(rval >= 0, rval, V + rk))
    def_pos = np.where(defines, np.arange(M), -1)
    prev_def = _seg_exclusive_max(def_pos, seg_id)
    cur_before = np.where(prev_def >= 0, def_val[np.maximum(prev_def, 0)],
                          NO_PREV)
    # unknown reads poison (info reads excluded from is_read anyway, and
    # they don't define); nothing else to do

    # external read = first mop of run is a read (no prior define)
    r_is_read = (rkind == MOP_READ) & rknown & ok[rt]
    external_read = r_is_read & (cur_before == NO_PREV)
    ext_read_val = def_val  # for reads, the read value (init-encoded)

    # ---- internal: read disagrees with txn-local state -------------------
    internal_bad = r_is_read & (cur_before != NO_PREV) & \
        (def_val != cur_before)
    for q in np.nonzero(internal_bad)[0][:max_reported]:
        report("internal", {"op": int(p.txn_orig_index[rt[q]])})

    # ---- G1a / G1b on external reads -------------------------------------
    ext_idx = np.nonzero(external_read)[0]
    ev = ext_read_val[ext_idx]
    real = ev < V
    evr = ev[real].astype(np.int64)
    w_of = writer[evr]
    g1a = w_of >= 0
    g1a &= ttype[np.maximum(writer[evr], 0)] == TXN_FAIL
    for i in np.nonzero(g1a)[0][:max_reported]:
        report("G1a", {"op": int(p.txn_orig_index[rt[ext_idx[real][i]]]),
                       "value": p.val_names[int(evr[i])]})
    g1b = (w_of >= 0) & ~is_final[evr] & \
        (w_of != rt[ext_idx[real]])
    for i in np.nonzero(g1b)[0][:max_reported]:
        report("G1b", {"op": int(p.txn_orig_index[rt[ext_idx[real][i]]]),
                       "value": p.val_names[int(evr[i])]})

    # ---- version edges ---------------------------------------------------
    # write with known predecessor u: u -> v; blind write: init(k) -> v
    w_idx = np.nonzero((rkind == MOP_APPEND) & graph_txn[rt])[0]
    u = np.where((cur_before[w_idx] >= 0), cur_before[w_idx],
                 V + rk[w_idx])
    v = rval[w_idx]
    v_src, v_dst = u.astype(np.int64), v.astype(np.int64)

    # cyclic-versions: cycle among version nodes
    if len(v_src):
        vs = nontrivial_sccs(V + nk, v_src.astype(np.int32),
                             v_dst.astype(np.int32))
        if vs:
            report("cyclic-versions",
                   {"scc-size": int(len(vs[0])),
                    "values": [p.val_names[int(x)] for x in vs[0][:6]
                               if int(x) < V]})

    # ---- lost update: >= 2 ok txns externally read u then write k --------
    upd = external_read.copy()
    # txn wrote k after the external read: last write exists in run after q
    upd &= last_w > np.arange(M)
    upd &= ok[rt]
    if upd.any():
        uu = def_val[np.nonzero(upd)[0]]
        ut = rt[np.nonzero(upd)[0]]
        order2 = np.lexsort((ut, uu))
        su, st = uu[order2], ut[order2]
        uniq = np.concatenate([[True], (su[1:] != su[:-1]) |
                               (st[1:] != st[:-1])])
        su, st = su[uniq], st[uniq]
        grp = np.concatenate([[True], su[1:] != su[:-1]])
        gid = np.cumsum(grp) - 1
        counts = np.bincount(gid)
        bad_groups = np.nonzero(counts >= 2)[0]
        for g in bad_groups[:max_reported]:
            vals = su[gid == g]
            txns = st[gid == g]
            report("lost-update",
                   {"version": (p.val_names[int(vals[0])]
                                if vals[0] < V else "nil"),
                    "txns": [int(p.txn_orig_index[t]) for t in txns[:6]]})

    # ---- txn dependency edges --------------------------------------------
    es: List[np.ndarray] = []
    ed: List[np.ndarray] = []
    er: List[np.ndarray] = []

    def add(src, dst, rel):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        m = (src >= 0) & (dst >= 0) & (src != dst)
        m &= graph_txn[np.maximum(src, 0)] & graph_txn[np.maximum(dst, 0)]
        es.append(src[m].astype(np.int32))
        ed.append(dst[m].astype(np.int32))
        er.append(np.full(int(m.sum()), rel, np.int8))

    # wr: external reader of real v <- writer(v)
    wr_r = rt[ext_idx[real]]
    add(w_of, wr_r, REL_WR)
    # ww: writer(u) -> writer(v) for version edges with real u
    real_u = v_src < V
    ww_src = np.where(real_u, writer[np.minimum(v_src, V - 1)], -1)
    ww_dst = np.where(v_dst < V, writer[np.minimum(v_dst, V - 1)], -1)
    add(ww_src, ww_dst, REL_WW)
    # rw: external readers of u -> writer(v), for each version edge u->v
    # join readers (sorted by value) with version edges (sorted by src)
    if len(ext_idx) and len(v_src):
        rd_vals = ext_read_val[ext_idx]
        rd_txn = rt[ext_idx]
        r_ord = np.argsort(rd_vals, kind="stable")
        rv_sorted = rd_vals[r_ord]
        rt_sorted = rd_txn[r_ord]
        lo = np.searchsorted(rv_sorted, v_src, side="left")
        hi = np.searchsorted(rv_sorted, v_src, side="right")
        cnt = hi - lo
        tot = int(cnt.sum())
        if tot:
            eidx = np.repeat(np.arange(len(v_src)), cnt)
            off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            readers = rt_sorted[lo[eidx] + off]
            wdst = writer[np.minimum(v_dst[eidx], V - 1)]
            wdst = np.where(v_dst[eidx] < V, wdst, -1)
            add(readers, wdst, REL_RW)

    dep = EdgeList()
    dep.src = np.concatenate(es) if es else np.zeros(0, np.int32)
    dep.dst = np.concatenate(ed) if ed else np.zeros(0, np.int32)
    dep.rel = np.concatenate(er) if er else np.zeros(0, np.int8)

    # process + realtime (barrier) orders over ok/info txns
    proc = p.txn_process.astype(np.int64)
    inv = p.txn_invoke_pos.astype(np.int64)
    comp = p.txn_complete_pos.astype(np.int64)
    pe = process_edges(np.where(graph_txn, proc, -10 ** 9 - np.arange(T)),
                       inv)
    ok_ids = np.nonzero(ok)[0]
    rte, n_b, b_ranks = realtime_edges_subset(inv, comp, ok_ids, graph_txn, T)
    edges = EdgeList.concat([dep, pe, rte]).dedup()
    n_nodes = T + n_b
    rank = np.concatenate([2 * comp, b_ranks]).astype(np.int32)

    # ---- cycle anomalies --------------------------------------------------
    found.update(sess_found)
    from jepsen_tpu_torch.checkers.elle.explain import rw_explainer

    expl = rw_explainer(p, writer, v_src, v_dst,
                        ext_read_txn=rt[ext_idx],
                        ext_read_val=ext_read_val[ext_idx])
    found.update(cycle_anomalies(edges, n_nodes, rank, want,
                                 use_device=use_device, explainer=expl,
                                 n_txns=T, orig_index=p.txn_orig_index,
                                 device=dev))

    found = {k: val for k, val in found.items() if k in want}
    anomaly_types = sorted(found.keys())
    boundary = consistency.friendly_boundary(anomaly_types)
    bad = set(boundary["not"]) | set(boundary["also-not"])
    requested_bad = bad & {consistency.canonical(m)
                           for m in consistency_models}
    return finalize({
        "valid?": not requested_bad,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
    })


def _seg_reverse_max(vals: np.ndarray, seg_id: np.ndarray) -> np.ndarray:
    """Per-segment max over [i, end] (suffix max)."""
    if not len(vals):
        return vals
    rev_vals = vals[::-1]
    # reversed seg ids must stay nondecreasing for the encoding trick
    rev_seg = (seg_id.max() - seg_id)[::-1]
    out = _seg_inclusive_max(rev_vals, rev_seg)
    return out[::-1]


def _seg_inclusive_max(vals: np.ndarray, seg_id: np.ndarray) -> np.ndarray:
    """Vectorized segmented cummax for nondecreasing seg_id and vals in
    [-1, BOUND): encode seg_id*(BOUND+1) + (val+1); a later segment's
    encodings dominate all earlier ones, so a global cummax restricted to
    the encoding stays within-segment after decode."""
    if not len(vals):
        return vals
    bound = int(vals.max(initial=0)) + 2
    enc = seg_id.astype(np.int64) * bound + (vals.astype(np.int64) + 1)
    cm = np.maximum.accumulate(enc)
    return (cm % bound - 1).astype(vals.dtype)


def _seg_exclusive_max(vals: np.ndarray, seg_id: np.ndarray) -> np.ndarray:
    inc = _seg_inclusive_max(vals, seg_id)
    out = np.full_like(vals, -1)
    if len(vals):
        same = np.concatenate([[False], seg_id[1:] == seg_id[:-1]])
        out[same] = inc[:-1][same[1:]]
    return out
