"""Session-guarantee checker: monotonic reads / monotonic writes /
read-your-writes / writes-follow-reads over rw-register histories (the
port's copy of `jepsen_tpu/checkers/elle/sessions.py`).

Completes the lattice's session family (reference:
`elle/consistency_model.clj` models the guarantees; the checking idea is
the classic Terry et al. formulation over a per-key version order).  The
version order is the same one the rw-register checker infers — per-key
edges u -> v when a committed txn externally reads u (or writes blind,
u = init) and then writes v, chained through the txn's write sequence.
Only *definite* violations are reported: two versions are compared only
when one is an ancestor of the other in the version DAG, so branching
(itself an anomaly, reported elsewhere as cyclic-versions/lost-update)
never manufactures a false session violation.

Guarantees (each emits the lattice's "<model>-violation" token):
- monotonic-reads: a session's successive reads of a key never go
  backwards in the version order.
- read-your-writes: after a session writes v, its later reads of that
  key return v or a successor.
- monotonic-writes: a session's writes to a key are installed in
  session order.
- writes-follow-reads: a session's write to a key is ordered after the
  versions the session previously read from that key — PLUS the
  cross-key propagation side: if session
  S1 read u(k1) and then wrote v(k2), any session that causally
  observes v (reads v or a DAG successor of it) and afterwards reads
  k1 must see u or a successor — an older read demonstrates v applied
  before the write it depends on.
- monotonic-writes likewise gets the cross-key side: S1 wrote w1(k1)
  then v(k2); an observer of v that afterwards reads k1 older than w1
  saw S1's writes applied out of session order.

Cross-key detection is two-pass: pass A registers, for every written
version, the writer session's prior reads/writes per other key (its
causal dependencies); pass B walks each session online, activating
obligations when a read causally includes a registered version and
reporting definite regressions on later reads.  All comparisons stay
ancestor-definite, so DAG branching never manufactures violations.

Scope notes: ok txns only (an indeterminate txn's effects are not
session-ordered), external reads only (txn-internal read-own-write is
`internal`'s job), sessions = processes (the reference's convention).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from jepsen_tpu_torch.checkers.elle import consistency
from jepsen_tpu_torch.history.ops import INVOKE, OK, History

GUARANTEES = ("monotonic-reads", "monotonic-writes", "read-your-writes",
              "writes-follow-reads")

#: the unwritten initial version of every key (a read returning None
#: observes it; it precedes every written version of its key)
INIT = "__init__"


def _sessions(h: History):
    """Per-process list of (invoke_index, [mops]) for ok client txns."""
    out: Dict[Any, List] = {}
    for op in h.ops:
        if op.type != INVOKE or not op.is_client_op():
            continue
        ci = h.pair_index(op.index)
        if ci < 0 or h.ops[ci].type != OK:
            continue
        out.setdefault(op.process, []).append((op.index,
                                               h.ops[ci].value))
    for seq in out.values():
        seq.sort()
    return out


def _version_dag(sessions) -> Dict[Any, Dict[Any, set]]:
    """Per-key successor sets: succ[k][u] = direct successor versions."""
    succ: Dict[Any, Dict[Any, set]] = {}
    for seq in sessions.values():
        for _, mops in seq:
            cur: Dict[Any, Any] = {}  # txn-local last version per key
            for f, k, v in mops:
                if f == "r":
                    if k not in cur:
                        cur[k] = v if v is not None else INIT
                elif f == "w":
                    u = cur.get(k, INIT)
                    succ.setdefault(k, {}).setdefault(
                        u, set()).add(v)
                    cur[k] = v
    return succ


def _ancestors(succ_k: Dict[Any, set]) -> Dict[Any, set]:
    """version -> set of strict ancestors, via DFS over the (small,
    chain-shaped in valid histories) per-key DAG."""
    anc: Dict[Any, set] = {}
    # build predecessor map
    preds: Dict[Any, set] = {}
    for u, vs in succ_k.items():
        for v in vs:
            preds.setdefault(v, set()).add(u)

    def walk(v, seen):
        if v in anc:
            return anc[v]
        if v in seen:
            return set()  # cycle: cyclic-versions territory; stay sound
        seen.add(v)
        out = set()
        for u in preds.get(v, ()):
            out.add(u)
            out |= walk(u, seen)
        anc[v] = out
        return out

    for v in list(preds):
        walk(v, set())
    return anc


def check(history, guarantees: Sequence[str] = GUARANTEES,
          max_reported: int = 8) -> Dict[str, Any]:
    """Check session guarantees; result shape matches the elle checkers."""
    h = history if isinstance(history, History) else History(history)
    sessions = _sessions(h)
    dag = _version_dag(sessions)
    anc_of = {k: _ancestors(sk) for k, sk in dag.items()}

    found: Dict[str, List[dict]] = {}

    def report(name, item):
        lst = found.setdefault(name + "-violation", [])
        if len(lst) < max_reported:
            lst.append(item)

    def precedes(k, a, b) -> bool:
        """a is a strict ancestor of b in key k's version order."""
        return a in anc_of.get(k, {}).get(b, ())

    want = set(guarantees)

    # ---- pass A: per-written-version causal dependencies (cross-key) ----
    # wfr_dep[(k, v)] = {k1: u} — writer session had read u(k1) before
    # writing v(k2); mw_dep likewise for its prior writes.
    wfr_dep: Dict[tuple, Dict[Any, Any]] = {}
    mw_dep: Dict[tuple, Dict[Any, Any]] = {}
    if "writes-follow-reads" in want or "monotonic-writes" in want:
        for proc, seq in sessions.items():
            lr: Dict[Any, Any] = {}
            lw: Dict[Any, Any] = {}
            for inv, mops in seq:
                cur: Dict[Any, Any] = {}
                for f, k, v in mops:
                    if f == "r":
                        if k in cur:
                            continue
                        lr[k] = cur[k] = v if v is not None else INIT
                    elif f == "w":
                        d = {k1: u for k1, u in lr.items() if k1 != k}
                        if d:
                            wfr_dep[(k, v)] = d
                        dw = {k1: w for k1, w in lw.items() if k1 != k}
                        if dw:
                            mw_dep[(k, v)] = dw
                        lw[k] = cur[k] = v

    # ---- pass B: per-session walk (same-key rules + obligations) --------
    for proc, seq in sessions.items():
        last_read: Dict[Any, Any] = {}   # key -> last externally read ver
        last_write: Dict[Any, Any] = {}  # key -> last written ver
        # the versions whose dependencies this session has activated, and
        # those read with all their ancestors: activating again adds
        # nothing to a set, so it is skipped (the JAX module repeats it)
        activated: Dict[Any, set] = {}
        closed: Dict[Any, set] = {}
        # cross-key obligations activated by causally-observed versions:
        # reads of k1 must not precede any version in oblig_*[k1]
        oblig_wfr: Dict[Any, set] = {}
        oblig_mw: Dict[Any, set] = {}
        for inv, mops in seq:
            cur: Dict[Any, Any] = {}
            for f, k, v in mops:
                if f == "r":
                    if k in cur:
                        continue  # internal read: `internal`'s job
                    if v is None:
                        v = INIT  # observed the unwritten initial state
                    # cross-key checks against previously activated
                    # obligations (check BEFORE activating this read's)
                    # (`precedes` inlined: these loops are the walk's
                    # hottest)
                    anc_k = anc_of.get(k, {})
                    if "writes-follow-reads" in want:
                        for u in oblig_wfr.get(k, ()):
                            if v in anc_k.get(u, ()):
                                report("writes-follow-reads",
                                       {"process": proc, "op": inv,
                                        "key": k, "read": v,
                                        "cross-key-dependency": u})
                                break
                    if "monotonic-writes" in want:
                        for w in oblig_mw.get(k, ()):
                            if v in anc_k.get(w, ()):
                                report("monotonic-writes",
                                       {"process": proc, "op": inv,
                                        "key": k, "read": v,
                                        "cross-key-prior-write": w})
                                break
                    read_all = closed.setdefault(k, set())
                    if (wfr_dep or mw_dep) and v not in read_all:
                        read_all.add(v)
                        done = activated.setdefault(k, set())
                        for ver in ({v} | anc_of.get(k, {}).get(v, set())):
                            if ver in done:
                                continue
                            done.add(ver)
                            for k1, u in wfr_dep.get((k, ver), {}).items():
                                oblig_wfr.setdefault(k1, set()).add(u)
                            for k1, w in mw_dep.get((k, ver), {}).items():
                                oblig_mw.setdefault(k1, set()).add(w)
                    if "monotonic-reads" in want and k in last_read and \
                            precedes(k, v, last_read[k]):
                        report("monotonic-reads",
                               {"process": proc, "op": inv, "key": k,
                                "read": v, "after-reading": last_read[k]})
                    if "read-your-writes" in want and k in last_write and \
                            precedes(k, v, last_write[k]):
                        report("read-your-writes",
                               {"process": proc, "op": inv, "key": k,
                                "read": v, "after-writing": last_write[k]})
                    last_read[k] = v
                    cur[k] = v
                elif f == "w":
                    if "monotonic-writes" in want and k in last_write and \
                            precedes(k, v, last_write[k]):
                        report("monotonic-writes",
                               {"process": proc, "op": inv, "key": k,
                                "wrote": v, "after-writing": last_write[k]})
                    if "writes-follow-reads" in want and k in last_read \
                            and precedes(k, v, last_read[k]):
                        report("writes-follow-reads",
                               {"process": proc, "op": inv, "key": k,
                                "wrote": v, "after-reading": last_read[k]})
                    last_write[k] = v
                    cur[k] = v

    anomaly_types = sorted(found)
    boundary = consistency.friendly_boundary(anomaly_types)
    return {
        "valid?": not found,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
    }


def check_la(history, guarantees: Sequence[str] = GUARANTEES,
             max_reported: int = 8) -> Dict[str, Any]:
    """Session guarantees over LIST-APPEND histories.

    The per-key version order is the longest ok read of the key — the
    same order the list-append checkers infer — and a read's observed
    version is its list length (reads are prefixes of the order;
    disagreement is `incompatible-order`, reported by the main checker
    and making the history invalid regardless).  Definite-violation
    rules under prefix semantics:

    - monotonic-reads: a session's later read of a key is shorter than
      an earlier one (the observed prefix went backwards).
    - read-your-writes: a session's earlier committed append v to k is
      absent from a later read of k (v's global position can only be
      past the read's end, so the read observed a pre-v state).
    - monotonic-writes: a session's appends v1 then v2 (separate txns)
      land in the key's order with v2 before v1.
    - writes-follow-reads: a session's append v lands inside a prefix
      the session had already read (pos(v) < earlier read length) —
      v was installed before versions the session had observed.

    Cross-key, prefix semantics: when S1 read n1
    elements of k1 and then appended v to k2, a session whose read of
    k2 contains v must afterwards see >= n1 elements of k1 (WFR), and
    must see S1's prior appends to other keys present (MW); shorter /
    missing reads demonstrate v applied before its dependencies.
    """
    h = history if isinstance(history, History) else History(history)
    sessions = _sessions(h)

    # per-key order: the longest ok read (list values), like the
    # list-append checkers' version inference
    order_pos: Dict[Any, Dict[Any, int]] = {}
    order_len: Dict[Any, int] = {}
    for seq in sessions.values():
        for _, mops in seq:
            for f, k, v in mops:
                if f == "r" and isinstance(v, (list, tuple)) and \
                        len(v) > order_len.get(k, -1):
                    order_len[k] = len(v)
                    order_pos[k] = {e: i for i, e in enumerate(v)}

    found: Dict[str, List[dict]] = {}

    def report(name, item):
        lst = found.setdefault(name + "-violation", [])
        if len(lst) < max_reported:
            lst.append(item)

    want = set(guarantees)

    # ---- pass A: per-appended-value causal dependencies (cross-key) ----
    wfr_dep: Dict[tuple, Dict[Any, int]] = {}   # (k, v) -> {k1: read len}
    mw_dep: Dict[tuple, Dict[Any, Any]] = {}    # (k, v) -> {k1: prior val}
    if "writes-follow-reads" in want or "monotonic-writes" in want:
        for proc, seq in sessions.items():
            lrl: Dict[Any, int] = {}
            lap: Dict[Any, Any] = {}
            for inv, mops in seq:
                seen: set = set()
                added: set = set()
                for f, k, v in mops:
                    if f == "r":
                        if k in seen or k in added or \
                                not isinstance(v, (list, tuple)):
                            continue
                        seen.add(k)
                        lrl[k] = max(len(v), lrl.get(k, 0))
                    elif f == "append":
                        d = {k1: n for k1, n in lrl.items()
                             if k1 != k and n > 0}
                        if d:
                            wfr_dep[(k, v)] = d
                        dw = {k1: w for k1, w in lap.items() if k1 != k}
                        if dw:
                            mw_dep[(k, v)] = dw
                        added.add(k)
                        lap[k] = v

    # ---- pass B: per-session walk --------------------------------------
    for proc, seq in sessions.items():
        last_read_len: Dict[Any, int] = {}
        last_appended: Dict[Any, List[Any]] = {}
        oblig_wfr: Dict[Any, int] = {}   # k1 -> min required read length
        oblig_mw: Dict[Any, set] = {}    # k1 -> values that must appear
        for inv, mops in seq:
            seen_in_txn: set = set()
            appended_in_txn: set = set()
            for f, k, v in mops:
                if f == "r":
                    if k in seen_in_txn or k in appended_in_txn or \
                            not isinstance(v, (list, tuple)):
                        # own-append contamination / repeat read:
                        # `internal`'s job; unknown reads carry nothing
                        continue
                    seen_in_txn.add(k)
                    n = len(v)
                    # cross-key checks (before activating this read's)
                    if "writes-follow-reads" in want and \
                            n < oblig_wfr.get(k, 0):
                        report("writes-follow-reads",
                               {"process": proc, "op": inv, "key": k,
                                "read-len": n,
                                "cross-key-required-len": oblig_wfr[k]})
                    if "monotonic-writes" in want and k in oblig_mw:
                        missing = [w for w in oblig_mw[k]
                                   if w not in set(v)]
                        if missing:
                            report("monotonic-writes",
                                   {"process": proc, "op": inv, "key": k,
                                    "cross-key-missing-writes":
                                        missing[:4]})
                    if wfr_dep or mw_dep:
                        for el in v:
                            for k1, n1 in wfr_dep.get((k, el), {}).items():
                                if n1 > oblig_wfr.get(k1, 0):
                                    oblig_wfr[k1] = n1
                            for k1, w in mw_dep.get((k, el), {}).items():
                                oblig_mw.setdefault(k1, set()).add(w)
                    if "monotonic-reads" in want and \
                            n < last_read_len.get(k, -1):
                        report("monotonic-reads",
                               {"process": proc, "op": inv, "key": k,
                                "read-len": n,
                                "after-read-len": last_read_len[k]})
                    if "read-your-writes" in want:
                        missing = [w for w in last_appended.get(k, ())
                                   if w not in set(v)]
                        if missing:
                            report("read-your-writes",
                                   {"process": proc, "op": inv, "key": k,
                                    "missing-own-appends": missing[:4]})
                    last_read_len[k] = max(n, last_read_len.get(k, -1))
                elif f == "append":
                    pos = order_pos.get(k, {}).get(v)
                    if "monotonic-writes" in want and pos is not None:
                        for w in last_appended.get(k, ()):
                            wp = order_pos.get(k, {}).get(w)
                            if wp is not None and pos < wp:
                                report("monotonic-writes",
                                       {"process": proc, "op": inv,
                                        "key": k, "appended": v,
                                        "after-appending": w})
                    if "writes-follow-reads" in want and pos is not None \
                            and pos < last_read_len.get(k, 0):
                        report("writes-follow-reads",
                               {"process": proc, "op": inv, "key": k,
                                "appended": v,
                                "inside-read-prefix-len":
                                    last_read_len[k]})
                    appended_in_txn.add(k)
                    last_appended.setdefault(k, []).append(v)

    anomaly_types = sorted(found)
    boundary = consistency.friendly_boundary(anomaly_types)
    return {
        "valid?": not found,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
    }
