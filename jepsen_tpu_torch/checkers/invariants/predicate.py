"""Predicate-workload checkers: long fork and write skew (the port's copy
of `jepsen_tpu/checkers/invariants/predicate.py`).

Long-fork and write-skew histories are rw-register shaped (single
writes per key, whole-group predicate reads), so this checker rides the
shared packed core (:func:`packed.pack_rw` + :func:`packed.infer_rw`)
and judges two ways, cheapest first:

1. **Vectorized witness passes** over the packed arrays:
   - *long fork*: committed group reads bucketed by key set; for each
     key pair inside a bucket, boolean column reductions find a read
     observing ``(w1, ¬w2)`` against a read observing ``(¬w1, w2)`` —
     two reads ordering two writes oppositely.  The observed/absent
     flags come straight from the packed mop columns; the pass is
     O(group² · reads) array ops, no Python pair loop.
   - *write skew*: mutual anti-dependency pairs — txns A, B with rw
     edges both ways (each read a version the other overwrote /
     installed over) — found by intersecting the encoded rw edge set
     with its transpose.

2. **Cycle confirmation** through the elle graph machinery: the same
   edge list (ww / wr / rw including the predicate "absence"
   anti-dependencies) swept for ``G-single`` / ``G2-item`` /
   ``G-nonadjacent`` cycles by `txn_cycles.cycle_anomalies` — the
   device rank sweep, then host Tarjan on the regions it reports — each
   witness edge explained by the rw Explainer (key, values, the "why"
   sentence).

The vectorized pass runs as a guarded device seam (site
``invariants.predicate`` via `resilience.with_fallback`): two torch
matrix products on the entry point's device (the CUDA card unless the
caller names the CPU) on the device path, numpy on the host oracle twin
(``use_device=False``), pinned equal verdict-for-verdict.  Only a
synthetic `FaultInjected` of a fault plan degrades to the twin; every
other device error is raised.
"""

from __future__ import annotations

from itertools import combinations
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.elle import consistency
from jepsen_tpu_torch.checkers.elle.graph import REL_RW
from jepsen_tpu_torch.checkers.elle.txn_cycles import cycle_anomalies
from jepsen_tpu_torch.checkers.invariants import packed as packed_mod
from jepsen_tpu_torch.checkers.invariants.packed import RwInference
from jepsen_tpu_torch.history.soa import MOP_READ, TXN_OK, PackedTxns

LONG_FORK = "long-fork"
WRITE_SKEW = "write-skew"

SITE = "invariants.predicate"

#: cycle families predicate anomalies surface as (write skew = a pure
#: anti-dependency cycle -> G2-item/G-nonadjacent; long fork = two
#: reads + two writers -> G-nonadjacent)
CYCLE_WANT = ("G-single", "G2-item", "G-nonadjacent")


# ---------------------------------------------------------------------------
# vectorized witness passes
# ---------------------------------------------------------------------------


def _group_reads(p: PackedTxns) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Committed pure-read txns as (txn ids, [R, K] observed flags,
    [R, K] value ids).  K = n_keys; a txn row only covers its own key
    set (mask via per-txn key membership)."""
    T, M = p.n_txns, p.n_mops
    kind = p.mop_kind.astype(np.int64)
    mtxn = p.mop_txn.astype(np.int64)
    ok = p.txn_type == TXN_OK
    # pure-read committed txns with known results
    is_read = kind == MOP_READ
    known = p.mop_rd_len >= 0
    has_write = np.zeros(T, bool)
    has_unknown = np.zeros(T, bool)
    np.logical_or.at(has_write, mtxn, ~is_read)
    np.logical_or.at(has_unknown, mtxn, is_read & ~known)
    n_mops_txn = np.bincount(mtxn, minlength=T)
    pure = ok & ~has_write & ~has_unknown & (n_mops_txn > 0)
    sel = pure[mtxn] & is_read
    rt = np.unique(mtxn[sel])
    if not len(rt):
        z = np.zeros((0, p.n_keys), dtype=np.int64)
        return rt, z.astype(bool), z
    row = np.full(T, -1, np.int64)
    row[rt] = np.arange(len(rt))
    covered = np.zeros((len(rt), p.n_keys), bool)
    vals = np.full((len(rt), p.n_keys), -1, np.int64)
    mk = p.mop_key.astype(np.int64)[sel]
    mv = p.mop_val.astype(np.int64)[sel]
    rr = row[mtxn[sel]]
    covered[rr, mk] = True
    vals[rr, mk] = mv
    return rt, covered, vals


def _fork_scan_host(covered: np.ndarray, observed: np.ndarray
                    ) -> np.ndarray:
    """The reducible half of the long-fork pass on the host (the JAX
    package's ``run(np)``): for every key pair (i, j) over reads covering
    both, are there reads with (obs i, ¬obs j) AND reads with (¬obs i,
    obs j)?  Returns the [K, K] boolean fork matrix.

    The JAX package multiplies int32 planes.  numpy multiplies integer
    matrices without BLAS, minutes for the [50,000, 1,024] planes of a
    long-fork history, so here the 0/1 planes multiply in float64, whose
    counts are exact below 2^53: the same matrix."""
    cov = np.asarray(covered)
    obs = np.asarray(observed)
    # reads covering key i with i observed / absent: [R, K]
    o = cov & obs
    a = cov & ~obs
    # pair (i, j): exists read covering both with i obs, j absent
    both = (cov.astype(np.float64).T @ cov.astype(np.float64))
    oa = (o.astype(np.float64).T @ a.astype(np.float64))
    # fork iff oa[i, j] > 0 and oa[j, i] > 0 over co-covered reads
    return (oa > 0) & (oa.T > 0) & (both > 0)


def _fork_scan_device(covered: np.ndarray, observed: np.ndarray,
                      dev: torch.device) -> np.ndarray:
    """`_fork_scan_host` as two torch matrix products on `dev`.

    torch has no int32 matmul on CUDA, so the 0/1 planes multiply in
    float32.  Only ``> 0`` of each product is read, and a sum of
    non-negative terms is 0 only when every term is 0, so rounding can
    never turn a positive count into 0 or the reverse: the result is
    exact.  The same holds under TF32 (if enabled), which represents 0 and
    1 exactly and also only adds non-negative products."""
    cov = torch.from_numpy(np.ascontiguousarray(covered)).to(dev)
    obs = torch.from_numpy(np.ascontiguousarray(observed)).to(dev)
    o = (cov & obs).float()
    a = (cov & ~obs).float()
    c = cov.float()
    both = c.T @ c
    oa = o.T @ a
    fork = (oa > 0) & (oa.T > 0) & (both > 0)
    return fork.cpu().numpy()


def long_forks(p: PackedTxns, *, use_device: bool = True,
               max_reported: int = 8, deadline=None, plan=None,
               policy=None, device: backend.DeviceLike = None
               ) -> Tuple[List[dict], int, Optional[str]]:
    """Vectorized long-fork witnesses, the fork matrix on `device` (the
    CUDA card unless the caller names the CPU) with `use_device`.
    Returns (witness list, group-read count, degraded flag)."""
    from jepsen_tpu_torch import resilience

    dev = backend.resolve(device) if use_device else None
    rt, covered, vals = _group_reads(p)
    if not len(rt):
        return [], 0, None
    observed = vals >= 0
    degraded = None
    if use_device:
        fork, degraded = resilience.with_fallback(
            SITE, lambda: _fork_scan_device(covered, observed, dev),
            lambda: _fork_scan_host(covered, observed), deadline=deadline,
            plan=plan, policy=policy)
    else:
        fork = _fork_scan_host(covered, observed)
    out: List[dict] = []
    ki, kj = np.nonzero(np.triu(fork, 1))
    orig = p.txn_orig_index
    o = covered & observed
    a = covered & ~observed
    for i, j in zip(ki.tolist(), kj.tolist()):
        if len(out) >= max_reported:
            break
        # first witness pair: a read with (i obs, j absent) and one
        # with (i absent, j obs)
        r1 = np.nonzero(o[:, i] & a[:, j])[0]
        r2 = np.nonzero(a[:, i] & o[:, j])[0]
        if not (len(r1) and len(r2)):
            continue
        out.append({
            "keys": [p.key_names[i], p.key_names[j]],
            "reads": [int(orig[rt[r1[0]]]), int(orig[rt[r2[0]]])],
            "why": (f"read T{int(orig[rt[r1[0]]])} observed key "
                    f"{p.key_names[i]!r} but not {p.key_names[j]!r}; "
                    f"read T{int(orig[rt[r2[0]]])} observed "
                    f"{p.key_names[j]!r} but not {p.key_names[i]!r} — "
                    "the two reads order the writes oppositely"),
        })
    return out, len(rt), degraded


def write_skews(inf: RwInference, max_reported: int = 8) -> List[dict]:
    """Mutual anti-dependency pairs: txns (a, b) with rw edges both
    ways.  Encoded-intersection over the rw projection — one sorted
    pass, no pair loop."""
    e = inf.edges
    m = e.rel == REL_RW
    src = e.src[m].astype(np.int64)
    dst = e.dst[m].astype(np.int64)
    if not len(src):
        return []
    n = int(inf.n_nodes)
    fwd = np.unique(src * n + dst)
    rev = np.unique(dst * n + src)
    both = np.intersect1d(fwd, rev, assume_unique=True)
    out: List[dict] = []
    orig = inf.p.txn_orig_index
    seen = set()
    for code in both.tolist():
        a, b = divmod(code, n)
        if a >= b or (a, b) in seen:
            continue  # report each unordered pair once
        seen.add((a, b))
        if len(out) >= max_reported:
            break
        out.append({
            "txns": [int(orig[a]), int(orig[b])],
            "why": (f"T{int(orig[a])} and T{int(orig[b])} each read a "
                    "version the other overwrote (mutual "
                    "anti-dependency): write skew"),
        })
    return out


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------


def check(history, consistency_models: Sequence[str] = (
              "snapshot-isolation",),
          anomalies: Sequence[str] = (),
          use_device: bool = True, max_reported: int = 8,
          deadline=None, plan=None, policy=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a predicate (long-fork / write-skew) history.

    Accepts a History / op list / PackedTxns (rw-register packing) /
    HistoryIR, whose packing and `rw_inference` are built once and shared
    with the session checker.  With `use_device`, the fork matrix and
    the cycle sweep run on `device` (the CUDA card unless the caller
    names the CPU; no card raises `backend.NoDeviceError`).
    ``use_device=False`` is the host oracle twin: the same passes on
    numpy and host Tarjan cycle search."""
    from jepsen_tpu_torch import resilience, telemetry
    from jepsen_tpu_torch.checkers.elle.explain import rw_explainer
    from jepsen_tpu_torch.history.ir import HistoryIR

    dev = backend.resolve(device) if use_device else None
    ph = telemetry.phases()
    ir = history if isinstance(history, HistoryIR) else None
    if isinstance(history, PackedTxns):
        p = history
    else:
        ph.start("invariants.pack", device=False)
        p = ir.packed("rw-register") if ir is not None \
            else packed_mod.pack_rw(history)
    if p.n_txns == 0 or not (p.txn_type == TXN_OK).any():
        ph.end()
        return {"valid?": "unknown", "anomaly-types": [], "anomalies": {},
                "not": [], "also-not": [], "read-count": 0}

    found: Dict[str, List[dict]] = {}
    degraded = None
    n_reads = 0
    try:
        ph.start("invariants.long-fork", device=use_device, txns=p.n_txns)
        forks, n_reads, degraded = long_forks(
            p, use_device=use_device, max_reported=max_reported,
            deadline=deadline, plan=plan, policy=policy, device=dev)
        if forks:
            found[LONG_FORK] = forks

        ph.start("invariants.infer", device=False)
        # the IR shares ONE RwInference between the predicate and
        # session checkers of a composed check (docs/IR.md)
        inf = ir.rw_inference() if ir is not None \
            else packed_mod.infer_rw(p)
        skews = write_skews(inf, max_reported=max_reported)
        if skews:
            found[WRITE_SKEW] = skews

        # cycle confirmation over the same edges: device rank sweep
        # (txn_cycles), then host Tarjan on its regions, per-edge evidence
        want = set(consistency.anomalies_for_models(
            [consistency.canonical(m) for m in consistency_models]))
        want |= set(anomalies) | set(CYCLE_WANT)
        if deadline is not None:
            deadline.check(SITE)
        ph.start("invariants.cycle-sweep", device=use_device)
        expl = rw_explainer(p, inf.writer, inf.v_src, inf.v_dst,
                            ext_read_txn=inf.ext_read_txn,
                            ext_read_val=inf.ext_read_val)
        found.update(cycle_anomalies(
            inf.edges, inf.n_nodes, inf.rank, want,
            use_device=use_device, max_reported=max_reported,
            explainer=expl, n_txns=p.n_txns,
            orig_index=p.txn_orig_index, device=dev))
    except resilience.DeadlineExceeded:
        ph.end()
        return resilience.deadline_result(
            checker="predicate",
            **{"anomaly-types": sorted(found), "anomalies": found})
    ph.end()

    anomaly_types = sorted(found)
    boundary = consistency.friendly_boundary(anomaly_types)
    bad = set(boundary["not"]) | set(boundary["also-not"])
    requested_bad = bad & {consistency.canonical(m)
                           for m in consistency_models}
    # the predicate tokens themselves invalidate regardless of the
    # lattice: a long fork / write skew is what this workload exists
    # to find
    invalid = bool(requested_bad) or LONG_FORK in found \
        or WRITE_SKEW in found
    res: Dict[str, Any] = {
        "valid?": not invalid,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
        "read-count": n_reads,
        "fork-count": len(found.get(LONG_FORK, ())),
        "skew-count": len(found.get(WRITE_SKEW, ())),
    }
    if degraded:
        res["degraded"] = degraded
    return res


# ---------------------------------------------------------------------------
# pairwise reference oracle (differential anchor for the vectorized pass)
# ---------------------------------------------------------------------------


def oracle_long_forks(history) -> List[dict]:
    """The quadratic pairwise long-fork scan (the original
    `long_fork.clj` formulation) — the semantic anchor the vectorized
    pass is differentially tested against.  Returns [{keys, reads}]."""
    from jepsen_tpu_torch.history.ops import OK

    reads = []
    for op in history:
        if op.type != OK or op.f != "txn":
            continue
        mops = op.value or []
        if mops and all(m[0] == "r" for m in mops):
            reads.append(op)
    forks = []
    obs = [{m[1]: m[2] for m in op.value} for op in reads]
    buckets: Dict[frozenset, List[int]] = {}
    for i, o in enumerate(obs):
        buckets.setdefault(frozenset(o), []).append(i)
    for idxs in buckets.values():
        for ia, ib in combinations(idxs, 2):
            shared = [k for k in obs[ia] if k in obs[ib]]
            for k1, k2 in combinations(shared, 2):
                a1, a2 = obs[ia][k1], obs[ia][k2]
                b1, b2 = obs[ib][k1], obs[ib][k2]
                if a1 is not None and a2 is None and b1 is None \
                        and b2 is not None:
                    forks.append({"keys": [k1, k2],
                                  "reads": [reads[ia].index,
                                            reads[ib].index]})
                elif a1 is None and a2 is not None and b1 is not None \
                        and b2 is None:
                    forks.append({"keys": [k2, k1],
                                  "reads": [reads[ia].index,
                                            reads[ib].index]})
    return forks
