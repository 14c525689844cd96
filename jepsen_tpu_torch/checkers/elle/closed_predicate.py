"""Closed-predicate checker: phantoms and predicate anomalies (the port's
copy of `jepsen_tpu/checkers/elle/closed_predicate.py`).

Equivalent of the reference's `elle/closed_predicate.clj` (SURVEY.md
§2.3, the last unimplemented component cell): transactions over a keyed
universe with inserts, writes, deletes, and **closed predicate reads** —
reads that return every element matching a predicate and thereby promise
completeness.  That promise is what makes phantoms checkable: a key
MISSING from a predicate read's result set binds that key to a version
that does not match, and later writes that would have matched become
anti-dependencies (the phantom edge).

Mop vocabulary (tuples, like the other workloads):

  ("insert", k, v)   insert k (must be unborn); version :init -> v
  ("w", k, v)        overwrite k with v (unique values per key)
  ("delete", k)      delete k; version v -> :dead
  ("rp", pred, res)  closed predicate read; res = {k: v} of matches.
                     pred: "all" (the whole table) or ("=", v)

Version semantics follow rw-register (unique writes; version edges from
txn-internal read/write chains and the initial state), extended with
:unborn/:dead sentinel versions per key.  Edge derivation for a
predicate read T:

  matched k=v    ->  wr  writer(v) -> T;  rw  T -> writer(next(v))
  unmatched k    ->  the bound version u is the unique non-matching
                     version consistent with the history; when that
                     binding is FORCED (pred = "all": u must be
                     :unborn/:dead; pred = ("=", x) with exactly one
                     possible non-matching version), emit
                     wr writer(u) -> T and the phantom rw T ->
                     writer(next(u)).  Ambiguous bindings emit nothing —
                     exactness first, no false positives.

Cycles are hunted with the shared taxonomy (`txn_cycles`, device rank
sweep on the entry point's device — the CUDA card unless the caller names
the CPU — + host classification); cycles traversing a phantom edge are
reported with the `-predicate` suffix (G2-predicate etc.), mirroring the
reference's predicate-anomaly naming.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.elle import consistency
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_RW,
    REL_WR,
    REL_WW,
    EdgeList,
    process_edges,
    realtime_edges_subset,
)
from jepsen_tpu_torch.checkers.elle.txn_cycles import cycle_anomalies
from jepsen_tpu_torch.history.ops import INVOKE, OK, FAIL, History, Op

UNBORN = "unborn"
DEAD = "dead"


class _Key:
    """Per-key version chain built from the serial structure the
    workload controls (insert/write/delete order per key is recoverable
    from unique values + txn-internal chains, as in rw-register)."""

    def __init__(self):
        self.versions: List[Tuple[Any, int]] = [(UNBORN, -1)]  # (val, txn)

    def add(self, val, txn: int):
        self.versions.append((val, txn))

    def index_of(self, val) -> int:
        for i, (v, _) in enumerate(self.versions):
            if v == val:
                return i
        return -1


def _txns_of(h: History):
    """[(txn_id, type, mops, process, invoke_pos, complete_pos, orig)]"""
    out = []
    for pos, op in enumerate(h.ops):
        if op.type == INVOKE or not op.is_client_op():
            continue
        inv = h.invocation(op)
        mops = op.value if op.type == OK else (inv.value if inv is not None
                                               else op.value)
        out.append((len(out), op.type, mops or [], int(op.process),
                    inv.index if inv is not None else pos, pos, op.index))
    return out


def check(history, consistency_models: Sequence[str] = ("serializable",),
          anomalies: Sequence[str] = (), use_device: bool = True,
          max_reported: int = 8,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a closed-predicate history.  With `use_device`, the cycle
    sweep runs on `device` (the CUDA card unless the caller names the
    CPU; no card raises `backend.NoDeviceError`); ``use_device=False``
    finds cycles by host Tarjan alone."""
    dev = backend.resolve(device) if use_device else None
    h = history if isinstance(history, History) else History(
        list(history), reindex=True)
    txns = _txns_of(h)
    T = len(txns)
    if T == 0 or not any(t[1] == OK for t in txns):
        return {"valid?": "unknown", "anomaly-types": [], "anomalies": {},
                "not": [], "also-not": []}

    found: Dict[str, List[Any]] = {}

    def report(name, item):
        found.setdefault(name, [])
        if len(found[name]) < max_reported:
            found[name].append(item)

    ok = np.array([t[1] == OK for t in txns])
    graph_txn = np.array([t[1] != FAIL for t in txns])

    # ---- version chains (serial recovery over ok/info writes) ----------
    # Writes are applied in completion order — the workload generator's
    # contract (unique values; predicate tests control their universe).
    keys: Dict[Any, _Key] = {}
    writer: Dict[Tuple[Any, Any], int] = {}  # (k, val) -> txn
    for (t, ttype, mops, *_rest) in txns:
        if ttype == FAIL:
            continue
        for m in mops:
            kind = m[0]
            if kind in ("insert", "w"):
                k, v = m[1], m[2]
                keys.setdefault(k, _Key()).add(v, t)
                writer[(k, v)] = t
                if kind == "insert":
                    ver = keys[k].versions
                    if len(ver) >= 2 and ver[-2][0] not in (UNBORN, DEAD):
                        report("insert-of-live-key",
                               {"key": k, "value": v, "txn": txns[t][6]})
            elif kind == "delete":
                k = m[1]
                kk = keys.setdefault(k, _Key())
                kk.add((DEAD, len(kk.versions)), t)
            elif kind == "rp":
                pass
            else:
                raise ValueError(f"unknown mop kind {m[0]!r}")

    def is_dead(v) -> bool:
        return v == UNBORN or (isinstance(v, tuple) and v[0] == DEAD)

    def matches(pred, v) -> bool:
        if is_dead(v):
            return False
        if pred == "all":
            return True
        if isinstance(pred, (tuple, list)) and pred[0] == "=":
            return v == pred[1]
        raise ValueError(f"unknown predicate {pred!r}")

    # ---- predicate read bindings + edges -------------------------------
    es: List[int] = []
    ed: List[int] = []
    er: List[int] = []
    phantom: set = set()

    def add_edge(a: int, b: int, rel: int, is_phantom=False):
        if a < 0 or b < 0 or a == b:
            return
        if not (graph_txn[a] and graph_txn[b]):
            return
        es.append(a)
        ed.append(b)
        er.append(rel)
        if is_phantom:
            phantom.add((a, b))

    # ww edges from the version chains
    for k, kk in keys.items():
        prev_writer = -1
        for (v, t) in kk.versions[1:]:
            if prev_writer >= 0:
                add_edge(prev_writer, t, REL_WW)
            prev_writer = t

    for (t, ttype, mops, *_rest) in txns:
        if ttype != OK:
            continue
        for m in mops:
            if m[0] != "rp":
                continue
            pred, res = m[1], (m[2] or {})
            # matched keys: bind the observed version
            for k, v in res.items():
                kk = keys.get(k)
                if kk is None or kk.index_of(v) < 0:
                    report("predicate-read-of-unwritten",
                           {"key": k, "value": v, "txn": txns[t][6]})
                    continue
                if not matches(pred, v):
                    report("predicate-mismatch",
                           {"key": k, "value": v, "pred": pred,
                            "txn": txns[t][6]})
                vi = kk.index_of(v)
                add_edge(writer.get((k, v), -1), t, REL_WR)
                if vi + 1 < len(kk.versions):
                    add_edge(t, kk.versions[vi + 1][1], REL_RW)
            # unmatched keys: forced bindings only (exactness first)
            for k, kk in keys.items():
                if k in res:
                    continue
                nonmatch = [i for i, (v, _) in enumerate(kk.versions)
                            if not matches(pred, v)]
                if len(nonmatch) != 1:
                    continue  # ambiguous — no edge (sound, incomplete)
                ui = nonmatch[0]
                u_writer = kk.versions[ui][1]
                if u_writer >= 0:
                    add_edge(u_writer, t, REL_WR)
                if ui + 1 < len(kk.versions):
                    # the phantom: a later version WOULD have matched,
                    # so the read anti-depends on its writer
                    add_edge(t, kk.versions[ui + 1][1], REL_RW,
                             is_phantom=True)

    dep = EdgeList()
    dep.src = np.asarray(es, np.int32)
    dep.dst = np.asarray(ed, np.int32)
    dep.rel = np.asarray(er, np.int8)

    proc = np.asarray([t[3] for t in txns], np.int64)
    inv = np.asarray([t[4] for t in txns], np.int64)
    comp = np.asarray([t[5] for t in txns], np.int64)
    pe = process_edges(np.where(graph_txn, proc, -10 ** 9 - np.arange(T)),
                       inv)
    ok_ids = np.nonzero(ok)[0]
    rte, n_b, b_ranks = realtime_edges_subset(inv, comp, ok_ids, graph_txn,
                                              T)
    edges = EdgeList.concat([dep, pe, rte]).dedup()
    n_nodes = T + n_b
    rank = np.concatenate([2 * comp, b_ranks]).astype(np.int32)

    want = set(consistency.anomalies_for_models(
        [consistency.canonical(m) for m in consistency_models]))
    want |= set(anomalies)
    orig_index = np.asarray([t[6] for t in txns], np.int32)
    cyc = cycle_anomalies(edges, n_nodes, rank, want,
                          use_device=use_device, n_txns=T,
                          orig_index=orig_index, device=dev)

    # cycles through a phantom edge are predicate anomalies — rename,
    # matching the reference's predicate taxonomy
    orig_to_internal = {int(orig_index[i]): i for i in range(T)}
    for name in list(cyc.keys()):
        items = cyc.pop(name)
        for item in items:
            uses_phantom = any(
                e.get("rel") == "rw" and
                (orig_to_internal.get(e.get("src"), -1),
                 orig_to_internal.get(e.get("dst"), -2)) in phantom
                for e in item.get("cycle", []))
            out_name = f"{name}-predicate" if uses_phantom else name
            found.setdefault(out_name, []).append(item)

    found = {k: v for k, v in found.items() if _wanted(k, want)}
    anomaly_types = sorted(found.keys())
    boundary = consistency.friendly_boundary(
        [a.replace("-predicate", "") for a in anomaly_types
         if a.replace("-predicate", "") in want or a in want] +
        [a for a in anomaly_types
         if a in ("insert-of-live-key", "predicate-mismatch",
                  "predicate-read-of-unwritten")])
    bad = set(boundary["not"]) | set(boundary["also-not"])
    requested_bad = bad & {consistency.canonical(m)
                           for m in consistency_models}
    structural = {"insert-of-live-key", "predicate-mismatch",
                  "predicate-read-of-unwritten"} & set(anomaly_types)
    return {
        "valid?": not (requested_bad or structural),
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
    }


def _wanted(name: str, want: set) -> bool:
    if name in ("insert-of-live-key", "predicate-mismatch",
                "predicate-read-of-unwritten"):
        return True
    return name in want or name.replace("-predicate", "") in want
