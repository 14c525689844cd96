"""Exact host reference checker for list-append histories (the port's
copy of `jepsen_tpu/checkers/elle/oracle.py`).

This is the semantic ground truth the device pipeline is differentially
tested against — the `elle/list_append.clj` equivalent (SURVEY.md §2.3),
written for clarity, not speed (use on histories up to ~10^5 ops; the
device path in `jepsen_tpu_torch.checkers.elle.list_append` is the
at-scale engine).  It is host code and takes no device.

Implements:
 - non-cycle anomalies: duplicate-elements, duplicate-appends, internal,
   G1a (aborted read), G1b (intermediate read), dirty-update,
   incompatible-order;
 - per-key version-order inference (longest ok-read prefix; every read must
   be a prefix of it);
 - ww / wr / rw dependency edges + process + realtime (barrier) orders;
 - cycle anomalies per CYCLE_ANOMALY_SPECS via Tarjan SCC + rel-constrained
   BFS (elle.txn/cycles! analogue);
 - consistency-model verdicts via the lattice.

Telemetric runs get the JAX package's phase spans (``elle.pack``,
``elle.infer``, ``elle.graph-build``, ``elle.sessions``,
``elle.cycle-sweep``, all ``device=False``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.resilience import DeadlineExceeded, deadline_result
from jepsen_tpu_torch.checkers.elle import consistency
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_NAMES,
    REL_RW,
    REL_WR,
    REL_WW,
    EdgeList,
    nontrivial_sccs,
    find_cycle,
    process_edges,
)
from jepsen_tpu_torch.checkers.elle.specs import CYCLE_ANOMALY_SPECS, SPEC_ORDER
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
    PackedTxns,
    pack_txns,
)


class Txn:
    """Unpacked view of one transaction (oracle-side convenience)."""

    __slots__ = ("i", "type", "process", "invoke_pos", "complete_pos",
                 "orig_index", "mops")

    def __init__(self, i, type_, process, invoke_pos, complete_pos, orig_index):
        self.i = i
        self.type = type_
        self.process = process
        self.invoke_pos = invoke_pos
        self.complete_pos = complete_pos
        self.orig_index = orig_index
        # mops: (kind, key, val, read_list_or_None)
        self.mops: List[Tuple[int, int, int, Optional[List[int]]]] = []


def boundary_verdict(found: Dict[str, List[Any]],
                     consistency_models: Sequence[str],
                     want, has_ok: bool, sess_checked: bool,
                     edge_counts: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
    """THE list-append verdict tail, shared by the batch oracle, the
    device pipeline, and the incremental verifier session: filter found
    anomalies to the requested set, derive the friendly model boundary,
    decide ``valid?`` (unknown when no txn ever committed), and apply
    the coverage contract.  One implementation so a checker pair that
    agrees on the anomaly set cannot disagree on the verdict."""
    from jepsen_tpu_torch.checkers.elle import coverage

    found = {k: v for k, v in found.items() if k in want}
    anomaly_types = sorted(found.keys())
    boundary = consistency.friendly_boundary(anomaly_types)
    bad = set(boundary["not"]) | set(boundary["also-not"])
    requested_bad = bad & {consistency.canonical(m)
                           for m in consistency_models}
    valid: Any = "unknown" if not has_ok else not requested_bad
    res: Dict[str, Any] = {
        "valid?": valid,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
    }
    if edge_counts is not None:
        res["edge-counts"] = edge_counts
    return coverage.finalize_la(res, want, sess_checked)


def _unpack(p: PackedTxns) -> List[Txn]:
    txns = [
        Txn(i, int(p.txn_type[i]), int(p.txn_process[i]),
            int(p.txn_invoke_pos[i]), int(p.txn_complete_pos[i]),
            int(p.txn_orig_index[i]))
        for i in range(p.n_txns)
    ]
    for m in range(p.n_mops):
        t = txns[int(p.mop_txn[m])]
        kind = int(p.mop_kind[m])
        key = int(p.mop_key[m])
        val = int(p.mop_val[m])
        if kind == MOP_READ:
            s, ln = int(p.mop_rd_start[m]), int(p.mop_rd_len[m])
            rd = None if ln < 0 else [int(x) for x in p.rd_elems[s:s + ln]]
            t.mops.append((kind, key, val, rd))
        else:
            t.mops.append((kind, key, val, None))
    return txns


def check(history, consistency_models: Sequence[str] = ("serializable",),
          anomalies: Sequence[str] = (), max_cycle_steps: int = 2_000_000,
          max_reported: int = 8, deadline=None) -> Dict[str, Any]:
    """Check a list-append history.  Accepts a History / op list / PackedTxns.

    `deadline` (a `resilience.Deadline`, e.g. the shared
    ``opts["deadline"]`` placed by `check_safe`) is polled between
    stages and inside the per-txn / per-key / per-spec loops: expiry
    returns ``{"valid?": "unknown", "error": "deadline-exceeded"}``
    carrying whatever anomalies the interrupted stages already found,
    instead of running unbounded — the host oracle honors the same
    budget contract as the device pipelines it backs up."""
    # sequential phase spans (telemetry, no-op when disabled): the same
    # infer / graph-build / cycle-sweep stage names as the device
    # pipeline, so host-vs-device time is comparable in one trace
    ph = telemetry.phases()
    if isinstance(history, PackedTxns):
        p = history
    else:
        ph.start("elle.pack", device=False)
        p = pack_txns(history, "list-append")
    ph.start("elle.infer", device=False, txns=p.n_txns)
    txns = _unpack(p)
    found: Dict[str, List[Any]] = {}
    try:
        return _check_body(history, p, txns, found, consistency_models,
                           anomalies, max_cycle_steps, max_reported,
                           deadline, ph)
    except DeadlineExceeded as e:
        ph.end()
        return deadline_result(
            checker="elle-oracle",
            **{"anomaly-types": sorted(found), "anomalies": found,
               "not": [], "also-not": [],
               "partial": f"interrupted at {e.what or 'oracle'}"})


def _check_body(history, p: PackedTxns, txns, found,
                consistency_models, anomalies, max_cycle_steps,
                max_reported, deadline, ph) -> Dict[str, Any]:
    # cooperative budget: cheap monotonic poll every POLL_EVERY
    # iterations of the hot loops, and once per stage boundary
    POLL_EVERY = 256
    n_polls = [0]

    def poll(site: str, every: int = 1) -> None:
        if deadline is None:
            return
        n_polls[0] += 1
        if n_polls[0] % every == 0:
            deadline.check(site)

    def report(name: str, item: Any):
        found.setdefault(name, [])
        if len(found[name]) < max_reported:
            found[name].append(item)

    # -- writer map: val -> (txn index, is_final_append_of_txn_for_key) -----
    writer: Dict[int, int] = {}
    final_append: Dict[int, bool] = {}
    for t in txns:
        poll("elle.infer", POLL_EVERY)
        last_per_key: Dict[int, int] = {}
        for (kind, key, val, _) in t.mops:
            if kind == MOP_APPEND:
                if val in writer:
                    report("duplicate-appends",
                           {"value": p.val_names[val], "txns":
                            [txns[writer[val]].orig_index, t.orig_index]})
                else:
                    writer[val] = t.i
                last_per_key[key] = val
        for v in [v for (k2, k, v, _) in t.mops
                  if k2 == MOP_APPEND and writer.get(v) == t.i]:
            final_append[v] = False
        for key, val in last_per_key.items():
            if writer.get(val) == t.i:
                final_append[val] = True

    # -- internal consistency + duplicate elements (ok txns only) ----------
    for t in txns:
        poll("elle.internal", POLL_EVERY)
        if t.type != TXN_OK:
            continue
        cur: Dict[int, Optional[List[int]]] = {}
        suffix: Dict[int, List[int]] = {}
        for mi, (kind, key, val, rd) in enumerate(t.mops):
            if kind == MOP_APPEND:
                if cur.get(key) is not None:
                    cur[key] = cur[key] + [val]
                else:
                    suffix.setdefault(key, []).append(val)
            else:
                if rd is None:
                    continue
                if len(set(rd)) != len(rd):
                    report("duplicate-elements",
                           {"op": t.orig_index, "mop": mi,
                            "key": p.key_names[key]})
                c = cur.get(key)
                if c is not None:
                    if rd != c:
                        report("internal", {"op": t.orig_index, "mop": mi,
                                            "expected": c, "got": rd})
                else:
                    sfx = suffix.get(key, [])
                    if sfx and (len(rd) < len(sfx) or rd[-len(sfx):] != sfx):
                        report("internal", {"op": t.orig_index, "mop": mi,
                                            "expected-suffix": sfx, "got": rd})
                cur[key] = list(rd)

    # -- G1a (aborted read) / G1b (intermediate read) -----------------------
    for t in txns:
        poll("elle.g1", POLL_EVERY)
        if t.type != TXN_OK:
            continue
        for mi, (kind, key, val, rd) in enumerate(t.mops):
            if kind != MOP_READ or not rd:
                continue
            for v in rd:
                w = writer.get(v)
                if w is not None and txns[w].type == TXN_FAIL:
                    report("G1a", {"op": t.orig_index, "mop": mi,
                                   "value": p.val_names[v],
                                   "writer": txns[w].orig_index})
            last = rd[-1]
            w = writer.get(last)
            if (w is not None and w != t.i
                    and not final_append.get(last, True)):
                report("G1b", {"op": t.orig_index, "mop": mi,
                               "value": p.val_names[last],
                               "writer": txns[w].orig_index})

    # -- per-key version orders (longest ok-read; prefix compatibility) ----
    # reads: (key, tuple(rd), txn, mop index)
    reads_by_key: Dict[int, List[Tuple[List[int], int, int]]] = {}
    for t in txns:
        if t.type != TXN_OK:
            continue
        for mi, (kind, key, val, rd) in enumerate(t.mops):
            if kind == MOP_READ and rd is not None:
                reads_by_key.setdefault(key, []).append((rd, t.i, mi))

    version_order: Dict[int, List[int]] = {}
    for key, reads in reads_by_key.items():
        poll("elle.version-order", 64)
        longest = max(reads, key=lambda r: len(r[0]))[0]
        for (rd, ti, mi) in reads:
            if rd != longest[: len(rd)]:
                report("incompatible-order",
                       {"key": p.key_names[key],
                        "read": rd, "longest": longest,
                        "op": txns[ti].orig_index, "mop": mi})
        version_order[key] = longest

    # -- dirty-update: committed write follows an aborted one ---------------
    for key, order in version_order.items():
        for a, b in zip(order[:-1], order[1:]):
            wa, wb = writer.get(a), writer.get(b)
            if (wa is not None and wb is not None
                    and txns[wa].type == TXN_FAIL and txns[wb].type == TXN_OK):
                report("dirty-update",
                       {"key": p.key_names[key], "aborted-value":
                        p.val_names[a], "committed-value": p.val_names[b],
                        "aborted-writer": txns[wa].orig_index,
                        "committed-writer": txns[wb].orig_index})

    # -- dependency edges ---------------------------------------------------
    poll("elle.graph-build")
    ph.start("elle.graph-build", device=False)

    def graph_txn(i: int) -> bool:
        return txns[i].type in (TXN_OK, TXN_INFO)

    ww_s: List[int] = []; ww_d: List[int] = []
    wr_s: List[int] = []; wr_d: List[int] = []
    rw_s: List[int] = []; rw_d: List[int] = []
    for key, order in version_order.items():
        poll("elle.graph-build", 64)
        for a, b in zip(order[:-1], order[1:]):
            wa, wb = writer.get(a), writer.get(b)
            if (wa is not None and wb is not None and wa != wb
                    and graph_txn(wa) and graph_txn(wb)):
                ww_s.append(wa); ww_d.append(wb)
    for key, reads in reads_by_key.items():
        poll("elle.graph-build", 64)
        order = version_order[key]
        for (rd, ti, mi) in reads:
            if rd != order[: len(rd)]:
                continue  # incompatible read; already reported
            if rd:
                w = writer.get(rd[-1])
                if w is not None and w != ti and graph_txn(w):
                    wr_s.append(w); wr_d.append(ti)
            if len(rd) < len(order):
                nxt = writer.get(order[len(rd)])
                if nxt is not None and nxt != ti and graph_txn(nxt):
                    rw_s.append(ti); rw_d.append(nxt)

    def mk(src, dst, rel):
        e = EdgeList()
        e.src = np.asarray(src, dtype=np.int32)
        e.dst = np.asarray(dst, dtype=np.int32)
        e.rel = np.full(len(src), rel, dtype=np.int8)
        return e

    ok_info = np.array([t.type in (TXN_OK, TXN_INFO) for t in txns], dtype=bool)
    proc = np.asarray([t.process for t in txns], dtype=np.int64)
    inv = np.asarray([t.invoke_pos for t in txns], dtype=np.int64)
    comp = np.asarray([t.complete_pos for t in txns], dtype=np.int64)

    # process edges over ok/info txns only
    pe_all = process_edges(np.where(ok_info, proc, -10**9 - np.arange(len(txns))),
                           inv)
    # realtime: barriers from ok completions; in-edges to ok/info invokes
    ok_ids = np.nonzero(np.array([t.type == TXN_OK for t in txns]))[0]
    n_nodes = len(txns)
    rt = EdgeList(); n_barriers = 0
    if len(ok_ids):
        rt, n_barriers = _realtime_with_subset(
            inv, comp, ok_ids, ok_info, n_nodes)

    edges = EdgeList.concat([
        mk(ww_s, ww_d, REL_WW), mk(wr_s, wr_d, REL_WR), mk(rw_s, rw_d, REL_RW),
        pe_all, rt,
    ]).dedup()

    total_nodes = n_nodes + n_barriers

    # -- cycle anomalies ----------------------------------------------------
    # Only anomalies relevant to the requested models (plus explicitly
    # requested ones) are searched and reported, as in the reference;
    # structural breakdowns of version inference are always reported.
    want = set(consistency.anomalies_for_models(
        [consistency.canonical(m) for m in consistency_models]))
    want |= set(anomalies)
    want |= {"duplicate-appends", "duplicate-elements", "incompatible-order"}

    # session-guarantee tokens: dedicated per-process checker on
    # op-level input; coverage.py owns the degradation rule
    from jepsen_tpu_torch.checkers.elle import coverage

    poll("elle.sessions")
    ph.start("elle.sessions", device=False)
    sess_found, sess_checked = coverage.run_la_sessions(
        history, want, isinstance(history, PackedTxns),
        max_reported=max_reported)
    for k, v in sess_found.items():
        found.setdefault(k, []).extend(v)

    cycle_specs = [s for s in SPEC_ORDER
                   if s in want and s in CYCLE_ANOMALY_SPECS]

    ph.start("elle.cycle-sweep", device=False, specs=len(cycle_specs))
    for name in cycle_specs:
        # per-spec poll: the SCC + rel-constrained search is the
        # unbounded part of the host path — the budget must bite here
        poll("elle.cycle-sweep")
        spec = CYCLE_ANOMALY_SPECS[name]
        proj = edges.project(spec.rels)
        if not len(proj):
            continue
        sccs = nontrivial_sccs(total_nodes, proj.src, proj.dst)
        for scc in sccs:
            poll("elle.cycle-sweep", 16)
            cyc = find_cycle(scc, proj, spec, max_steps=max_cycle_steps)
            if cyc is not None:
                report(name, {"cycle": _render_cycle(cyc, txns, n_nodes),
                              "scc-size": int(len(scc))})
                break  # one witness per spec, like the reference's default

    ph.end()
    return boundary_verdict(
        found, consistency_models, want,
        has_ok=any(t.type == TXN_OK for t in txns),
        sess_checked=sess_checked,
        edge_counts={REL_NAMES[r]: int((edges.rel == r).sum())
                     for r in np.unique(edges.rel)} if len(edges) else {})


def _realtime_with_subset(inv, comp, ok_ids, ok_info, n_nodes):
    """Realtime barrier edges where only ok txns complete, ok/info invoke."""
    ok_comp = comp[ok_ids]
    order = np.argsort(ok_comp, kind="stable")
    comp_sorted = ok_comp[order]
    n_b = len(ok_ids)
    src: List[np.ndarray] = []
    dst: List[np.ndarray] = []
    src.append(ok_ids[order].astype(np.int32))
    dst.append((n_nodes + np.arange(n_b)).astype(np.int32))
    if n_b > 1:
        src.append((n_nodes + np.arange(n_b - 1)).astype(np.int32))
        dst.append((n_nodes + np.arange(1, n_b)).astype(np.int32))
    cand = np.nonzero(ok_info)[0]
    b_idx = np.searchsorted(comp_sorted, inv[cand], side="left") - 1
    mask = b_idx >= 0
    if mask.any():
        src.append((n_nodes + b_idx[mask]).astype(np.int32))
        dst.append(cand[mask].astype(np.int32))
    e = EdgeList()
    e.src = np.concatenate(src)
    e.dst = np.concatenate(dst)
    from jepsen_tpu_torch.checkers.elle.graph import REL_REALTIME
    e.rel = np.full(len(e.src), REL_REALTIME, dtype=np.int8)
    return e, n_b


def _render_cycle(cyc, txns, n_txns):
    """Render a cycle, contracting realtime-barrier pseudo-nodes into single
    txn->txn realtime steps (barriers are an internal encoding detail)."""
    # rotate so the cycle starts at a txn node (one must exist: barrier-only
    # cycles are impossible — the barrier chain is acyclic)
    k = next(i for i, (s, _, _) in enumerate(cyc) if s < n_txns)
    cyc = cyc[k:] + cyc[:k]
    out = []
    pend_src = None
    for (s, rel, d) in cyc:
        if d >= n_txns:  # entering/along barriers: remember the txn source
            if s < n_txns:
                pend_src = s
            continue
        src = s if s < n_txns else pend_src
        out.append({
            "src": txns[src].orig_index,
            "rel": REL_NAMES[rel],
            "dst": txns[d].orig_index,
        })
    return out
