"""Session guarantees as vectorized per-process passes (the port's copy
of `jepsen_tpu/checkers/invariants/session.py`).

Monotonic reads / monotonic writes / read-your-writes /
writes-follow-reads over rw-register-shaped histories, checked against
the per-key version orders the shared packed core derives
(:func:`packed.infer_rw`): every committed external read / write
becomes one event row ``(process, key, seq, is_write, rank)`` where
``rank`` is the version's position in its key's chain, and each
guarantee is a segmented comparison against the LAST prior event of
the relevant type in the same ``(process, key)`` segment —

    monotonic-reads      read rank  < last prior read rank
    read-your-writes     read rank  < last prior write rank
    monotonic-writes     write rank < last prior write rank
    writes-follow-reads  write rank < last prior read rank

"last prior X" is one encoded cumulative max (position-dominant
encoding, the `_seg_inclusive_max` trick), so the whole pass is a
handful of array ops: sort, cummax, compare.  The **device path** runs
the cummax + comparisons in torch on the entry point's device (the CUDA
card unless the caller names the CPU) behind `resilience.with_fallback`
(site ``invariants.session``).  Its running max of matching positions is
a forward fill of the last match, so it is the LOCF of `ops.fill` (on the
card, the hand-written kernel `csrc/locf.cu`; the JAX package's
``jax.lax.cummax``).  The **host oracle twin** is the identical numpy,
pinned equal verdict-for-verdict.  Only a synthetic `FaultInjected` of a
fault plan degrades to the twin; every other device error is raised.

Cross-key obligation propagation (the walker's pass A/B, ROADMAP 5c)
is ALSO vectorized here (:func:`_cross_key_violations`): dep
registration is a writes x same-session-group array join, activation a
deps x reader-group join over per-group prefix-max / suffix-min rank
scans — multi-key writer sessions stay on the array path.

Exactness first: rank comparison is only definite on keys whose
version graph is a simple chain (`RwInference.chain_ok`).  Histories
with branched/cyclic keys fall back to the exact DAG walker
(`checkers.elle.sessions.check`), the same degradation rule the elle
family uses (an oracle that cannot look must say so, never silently
validate)."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.elle import consistency
from jepsen_tpu_torch.checkers.elle.sessions import GUARANTEES
from jepsen_tpu_torch.checkers.invariants import packed as packed_mod
from jepsen_tpu_torch.checkers.invariants.packed import RwInference
from jepsen_tpu_torch.history.soa import MOP_APPEND, TXN_OK, PackedTxns
from jepsen_tpu_torch.ops import fill

SITE = "invariants.session"

_SUFFIX = "-violation"


def _session_events(p: PackedTxns, inf: RwInference):
    """Flatten committed reads/writes to (proc, key, seq, is_write,
    rank) rows sorted session-major.  Returns None when any event's
    rank is unknown or its key is not chain-shaped — the walker owns
    those histories."""
    ok = p.txn_type == TXN_OK
    V = p.n_vals
    # writes: committed append mops, in mop order
    kind = p.mop_kind.astype(np.int64)
    mtxn = p.mop_txn.astype(np.int64)
    w_sel = np.nonzero((kind == MOP_APPEND) & ok[mtxn])[0]
    # reads: the inference's external reads from committed txns
    r_txn = inf.ext_read_txn
    r_val = inf.ext_read_val
    r_mop = inf.ext_read_mop

    ev_txn = np.concatenate([mtxn[w_sel], r_txn]).astype(np.int64)
    ev_mop = np.concatenate([w_sel, r_mop]).astype(np.int64)
    ev_val = np.concatenate([p.mop_val.astype(np.int64)[w_sel],
                             r_val]).astype(np.int64)
    ev_write = np.concatenate([np.ones(len(w_sel), bool),
                               np.zeros(len(r_txn), bool)])
    if not len(ev_txn):
        return (np.zeros(0, np.int64),) * 5
    ev_key = p.mop_key.astype(np.int64)[ev_mop]
    if not inf.chain_ok[np.unique(ev_key)].all():
        return None
    rank = inf.chain_rank[ev_val]
    if (rank < 0).any():
        return None
    proc = p.txn_process.astype(np.int64)[ev_txn]
    inv = p.txn_invoke_pos.astype(np.int64)[ev_txn]
    # session order: invoke position, then mop order within the txn
    order = np.lexsort((ev_mop, inv, ev_key, proc))
    return (proc[order], ev_key[order], ev_write[order], rank[order],
            ev_txn[order])


def _chron_events(p: PackedTxns, inf: RwInference):
    """Committed writes + external reads in SESSION-CHRONOLOGICAL
    order (proc, invoke, mop) — the event stream the cross-key
    obligation pass walks.  Same event set as `_session_events`, whose
    key-major sort serves the same-key masks instead."""
    ok = p.txn_type == TXN_OK
    kind = p.mop_kind.astype(np.int64)
    mtxn = p.mop_txn.astype(np.int64)
    w_sel = np.nonzero((kind == MOP_APPEND) & ok[mtxn])[0]
    ev_mop = np.concatenate([w_sel, inf.ext_read_mop]).astype(np.int64)
    ev_txn = np.concatenate([mtxn[w_sel], inf.ext_read_txn])
    ev_val = np.concatenate([p.mop_val.astype(np.int64)[w_sel],
                             inf.ext_read_val])
    ev_w = np.concatenate([np.ones(len(w_sel), bool),
                           np.zeros(len(inf.ext_read_txn), bool)])
    if not len(ev_txn):
        return None
    ev_key = p.mop_key.astype(np.int64)[ev_mop]
    rank = inf.chain_rank[ev_val]
    proc = p.txn_process.astype(np.int64)[ev_txn]
    inv = p.txn_invoke_pos.astype(np.int64)[ev_txn]
    order = np.lexsort((ev_mop, inv, proc))
    return (proc[order], ev_key[order], ev_w[order], rank[order],
            ev_txn[order])


def _seg_cummax(vals: np.ndarray, start: np.ndarray,
                minimum: bool = False) -> np.ndarray:
    """Segmented inclusive prefix max (or min) over CONTIGUOUS
    segments: encode (segment, value) into one int so a plain
    `np.maximum.accumulate` can never carry a previous segment's value
    across a boundary (every element of segment s encodes above all of
    segment s-1)."""
    if not len(vals):
        return vals
    seg = np.cumsum(start) - 1
    lo = int(vals.min())
    span = int(vals.max()) - lo + 1
    base = vals - lo
    enc = seg * span + (span - 1 - base if minimum else base)
    dec = np.maximum.accumulate(enc) - seg * span
    return (span - 1 - dec if minimum else dec) + lo


def _cross_key_violations(p: PackedTxns, inf: RwInference, want,
                          max_reported: int = 8) -> Dict[str, List[dict]]:
    """Cross-key obligation propagation, vectorized (the JAX package's
    ROADMAP 5c — the last host-only hot path in this family).

    Walker semantics (`elle/sessions.check`), restated over chain
    ranks (valid here because every touched key is chain-shaped, the
    same gate the same-key pass uses):

    - pass A: a session that last read u(k1) [WFR] / last wrote w1(k1)
      [MW] and then writes w(k) registers a dep (k, rank(w), k1,
      rank(u|w1)).
    - pass B: any session whose read of k observes rank >= rank(w)
      activates the dep; a LATER read of k1 with rank < rank(u|w1) is
      a definite violation.

    Both passes are array joins: deps come from a writes x same-session
    (proc, key) group product with a composite-key searchsorted for
    "last prior event"; activations from a deps x reader-group product
    over per-group prefix-max / suffix-min rank scans.  The work is
    bounded by the same sums the walker's dict copies pay."""
    ev = _chron_events(p, inf)
    out: Dict[str, List[dict]] = {}
    if ev is None:
        return out
    proc, key, is_w, rank, ev_txn = ev
    n = len(proc)
    orig = p.txn_orig_index

    def grouped(sel):
        """(proc, key)-grouped view of selected rows: proc-major.
        Returns (rows_sorted, group_starts, group_ends, gid_of_row)."""
        idx = np.nonzero(sel)[0]
        o = np.lexsort((idx, key[idx], proc[idx]))
        ri = idx[o]
        if not len(ri):
            return ri, np.zeros(0, np.int64), np.zeros(0, np.int64), ri
        pi, ki = proc[ri], key[ri]
        start = np.concatenate(
            [[True], (pi[1:] != pi[:-1]) | (ki[1:] != ki[:-1])])
        gs = np.nonzero(start)[0]
        ge = np.concatenate([gs[1:], [len(ri)]])
        return ri, gs, ge, np.cumsum(start) - 1

    w_rows = np.nonzero(is_w)[0]
    if not len(w_rows):
        return out

    # per-observer-group read scans, shared by both dep kinds
    r_ri, r_gs, r_ge, r_gid = grouped(~is_w)
    if not len(r_ri):
        return out
    r_rank = rank[r_ri]
    r_start = np.zeros(len(r_ri), bool)
    r_start[r_gs] = True
    pmax = _seg_cummax(r_rank, r_start)
    smin = _seg_cummax(r_rank[::-1],
                       np.concatenate([r_start[1:], [True]])[::-1],
                       minimum=True)[::-1]
    r_gkey = key[r_ri][r_gs]
    r_key_ord = np.argsort(r_gkey, kind="stable")
    r_gkey_s = r_gkey[r_key_ord]
    rmax = int(rank.max()) + 2

    for name, prior_is_write in (("writes-follow-reads", False),
                                 ("monotonic-writes", True)):
        if name not in want:
            continue
        # ---- pass A: deps from writes x same-session prior groups ----
        pi_, gs_, ge_, gid_ = grouped(is_w if prior_is_write else ~is_w)
        if not len(gs_):
            continue
        g_proc = proc[pi_][gs_]
        g_key = key[pi_][gs_]
        wp = proc[w_rows]
        lo = np.searchsorted(g_proc, wp, side="left")
        hi = np.searchsorted(g_proc, wp, side="right")
        cnt = hi - lo
        tot = int(cnt.sum())
        if not tot:
            continue
        w_e = np.repeat(w_rows, cnt)
        g_e = np.repeat(lo, cnt) + (
            np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        keep = g_key[g_e] != key[w_e]
        w_e, g_e = w_e[keep], g_e[keep]
        if not len(w_e):
            continue
        # last prior event of that group strictly before the write row:
        # rows ascend within each contiguous group, so (gid, row) pairs
        # encode into one ascending key
        comp = gid_ * (n + 1) + pi_
        pos = np.searchsorted(comp, g_e * (n + 1) + w_e, side="left")
        has = pos > gs_[g_e]
        w_e, g_e, pos = w_e[has], g_e[has], pos[has]
        if not len(w_e):
            continue
        dep_kw = key[w_e]
        dep_wrank = rank[w_e]
        dep_k1 = g_key[g_e]
        dep_urank = rank[pi_[pos - 1]]

        # ---- pass B: activation x observer read groups ---------------
        dlo = np.searchsorted(r_gkey_s, dep_kw, side="left")
        dhi = np.searchsorted(r_gkey_s, dep_kw, side="right")
        dcnt = dhi - dlo
        dtot = int(dcnt.sum())
        if not dtot:
            continue
        d_e = np.repeat(np.arange(len(dep_kw)), dcnt)
        og = r_key_ord[np.repeat(dlo, dcnt) + (
            np.arange(dtot) -
            np.repeat(np.cumsum(dcnt) - dcnt, dcnt))]
        # first read position in the observer group whose prefix-max
        # rank reaches the dep's write rank (prefix-max ascends within
        # a group, so (gid, pmax) encodes into one ascending key)
        pm_comp = r_gid * rmax + pmax
        act = np.searchsorted(pm_comp, og * rmax + dep_wrank[d_e],
                              side="left")
        ok_act = act < r_ge[og]
        d_e, og, act = d_e[ok_act], og[ok_act], act[ok_act]
        if not len(d_e):
            continue
        # a later read of k1 below the dep threshold = violation; the
        # observer group here is the k-group — now check the SAME
        # session's k1 group after the activation row
        act_row = r_ri[act]
        # k1 group of the observer's session: composite (proc, key)
        gp_comp = proc[r_ri][r_gs] * (int(key.max()) + 2) + r_gkey
        obs_proc = proc[r_ri][r_gs][og]
        k1g = np.searchsorted(
            gp_comp, obs_proc * (int(key.max()) + 2) + dep_k1[d_e])
        in_range = (k1g < len(r_gs)) & \
            (gp_comp[np.clip(k1g, 0, max(len(r_gs) - 1, 0))] ==
             obs_proc * (int(key.max()) + 2) + dep_k1[d_e])
        d_e, og, act_row, k1g = (d_e[in_range], og[in_range],
                                 act_row[in_range], k1g[in_range])
        if not len(d_e):
            continue
        # first k1-group position strictly after the activation row
        comp_r = r_gid * (n + 1) + r_ri
        p1 = np.searchsorted(comp_r, k1g * (n + 1) + act_row,
                             side="right")
        ok_pos = p1 < r_ge[k1g]
        viol = np.zeros(len(d_e), bool)
        viol[ok_pos] = smin[p1[ok_pos]] < dep_urank[d_e[ok_pos]]
        hits = np.nonzero(viol)[0]
        if not len(hits):
            continue
        items: List[dict] = []
        seen_pairs = set()
        for hidx in hits.tolist():
            if len(items) >= max_reported:
                break
            d = int(d_e[hidx])
            # first violating read in the k1 group after activation
            sl = slice(int(p1[hidx]), int(r_ge[k1g[hidx]]))
            rel = np.nonzero(r_rank[sl] < dep_urank[d])[0]
            if not len(rel):
                continue
            j = int(p1[hidx]) + int(rel[0])
            t = int(ev_txn[r_ri[j]])
            pair = (int(proc[r_ri[j]]), t, int(dep_k1[d]))
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
            items.append({
                "process": int(proc[r_ri[j]]),
                "op": int(orig[t]),
                "key": p.key_names[int(dep_k1[d])],
                "rank": int(r_rank[j]),
                "kind": "read",
                "cross-key": {
                    "via-key": p.key_names[int(dep_kw[d])],
                    "required-rank": int(dep_urank[d]),
                },
            })
        if items:
            out[name + _SUFFIX] = items
    return out


def _viol_masks(seg_id: np.ndarray, is_write: np.ndarray,
                rank: np.ndarray):
    """Violation masks on either side.  Returns run(dev) computing the
    four masks via a 1-based-position cummax ("latest matching event so
    far") plus a segment-start comparison: numpy for ``dev=None`` (the
    host twin), else torch on `dev`.  The encoding stays within the event
    count, so int32 positions cannot overflow below 2^31 events."""
    n = len(seg_id)
    # per-row first index of its own (process, key) segment
    new = np.concatenate([[True], seg_id[1:] != seg_id[:-1]]) \
        if n else np.zeros(0, bool)
    seg_start_np = np.maximum.accumulate(
        np.where(new, np.arange(n), 0)) if n else np.zeros(0, np.int64)

    def run_host():
        w = np.asarray(is_write)
        r = np.asarray(rank)
        pos1 = np.arange(1, n + 1)

        def last_prior(of_write):
            # cummax of (1-based position where the event matches)
            # gives the latest matching event at-or-before each row;
            # the exclusive shift makes it strictly prior, and a match
            # from an earlier (process, key) segment is rejected by
            # the segment-start comparison
            match = w if of_write else ~w
            enc = np.where(match, pos1, 0)
            cm = np.maximum.accumulate(enc)
            prior = np.concatenate([cm[:1] * 0, cm[:-1]])
            has = (prior > 0) & ((prior - 1) >= seg_start_np)
            prank = r[np.clip(prior - 1, 0, max(n - 1, 0))]
            return has, prank

        return last_prior(False), last_prior(True), w, r

    def run_device(dev):
        if n >= 2 ** 31:
            raise ValueError(f"{n} session events: the masks' positions "
                             "are int32")
        w = torch.from_numpy(np.ascontiguousarray(is_write)).to(dev)
        r = torch.from_numpy(np.ascontiguousarray(rank)).to(dev)
        seg_start = torch.from_numpy(seg_start_np).to(dev)
        pos1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)

        def last_prior(of_write):
            # as in run_host; the running max goes to the LOCF kernel
            match = w if of_write else ~w
            enc = torch.where(match, pos1, 0)
            cm = _cummax(enc)
            prior = torch.cat([cm[:1] * 0, cm[:-1]])
            has = (prior > 0) & ((prior - 1) >= seg_start)
            prank = r[(prior - 1).clamp(0, max(n - 1, 0)).long()]
            return has, prank

        return last_prior(False), last_prior(True), w, r

    def run(dev=None):
        (has_r, last_r), (has_w, last_w), w, r = \
            run_host() if dev is None else run_device(dev)
        # mask order == sessions.GUARANTEES order
        masks = (
            (~w) & has_r & (r < last_r),   # monotonic-reads
            w & has_w & (r < last_w),      # monotonic-writes
            (~w) & has_w & (r < last_w),   # read-your-writes
            w & has_r & (r < last_r),      # writes-follow-reads
        )
        if dev is None:
            return masks
        return tuple(m.cpu().numpy() for m in masks)

    return run


def _cummax(enc: torch.Tensor) -> torch.Tensor:
    """The running max of ``enc = where(match, pos1, 0)``, int32 (the JAX
    package's ``lax.cummax``).  The nonzero entries are 1-based positions,
    which increase along the axis, so the running max at row i is the
    position of the last match at or before i: a forward fill.  ``enc - 1``
    is the fill's input (the 0-based position of a match, the hole -1
    elsewhere), and `fill.locf` fills it: the LOCF kernel on the card,
    its plain version on the CPU."""
    return fill.locf(enc - 1) + 1


def check(history, guarantees: Sequence[str] = GUARANTEES,
          use_device: bool = True, max_reported: int = 8,
          deadline=None, plan=None, policy=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check session guarantees.  Accepts a History / op list /
    PackedTxns (rw-register packing) / HistoryIR, whose `rw_inference`
    is shared with the predicate checker.  With `use_device`, the masks
    run on `device` (the CUDA card unless the caller names the CPU; no
    card raises `backend.NoDeviceError`).  Result shape matches the elle
    checkers; anomalies use the lattice's ``<guarantee>-violation``
    tokens."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.history.ir import HistoryIR

    dev = backend.resolve(device) if use_device else None
    ir = history if isinstance(history, HistoryIR) else None
    op_level = None if (isinstance(history, PackedTxns)
                        or (ir is not None and ir.packed_only)) \
        else history
    if op_level is None:
        p = ir.packed("rw-register") if ir is not None else history
    else:
        p = ir.packed("rw-register") if ir is not None \
            else packed_mod.pack_rw(history)
    if p.n_txns == 0 or not (p.txn_type == TXN_OK).any():
        return {"valid?": "unknown", "anomaly-types": [], "anomalies": {},
                "not": [], "also-not": []}

    inf = ir.rw_inference() if ir is not None else packed_mod.infer_rw(p)
    ev = _session_events(p, inf)
    want = set(guarantees)

    if ev is None:
        # branched/cyclic version graphs: only the ancestor-definite
        # DAG walker can compare versions soundly (op-level input
        # required).  Cross-key writer sessions do not route here: the
        # vectorized obligation pass below covers them
        return _walker_fallback(op_level, want)

    proc, key, is_write, rank, ev_txn = ev
    seg = np.zeros(len(proc), np.int64)
    if len(proc):
        new = np.concatenate([[True], (proc[1:] != proc[:-1]) |
                              (key[1:] != key[:-1])])
        seg = np.cumsum(new) - 1
    run = _viol_masks(seg, is_write, rank)
    degraded = None
    try:
        if use_device and len(proc):
            masks, degraded = resilience.with_fallback(
                SITE, lambda: run(dev), run, deadline=deadline,
                plan=plan, policy=policy)
        else:
            masks = run() if len(proc) else (np.zeros(0, bool),) * 4
    except resilience.DeadlineExceeded:
        return resilience.deadline_result(checker="session")

    found: Dict[str, List[dict]] = {}
    orig = p.txn_orig_index
    for g, mask in zip(GUARANTEES, masks):
        if g not in want:
            continue
        hits = np.nonzero(np.asarray(mask))[0]
        if not len(hits):
            continue
        lst = found.setdefault(g + _SUFFIX, [])
        for i in hits[:max_reported]:
            lst.append({
                "process": int(proc[i]),
                "op": int(orig[ev_txn[i]]),
                "key": p.key_names[int(key[i])],
                "rank": int(rank[i]),
                "kind": "write" if is_write[i] else "read",
            })

    # cross-key obligation propagation (vectorized; walker-equivalent
    # on chain-shaped keys — differential-pinned in test_invariants)
    if "writes-follow-reads" in want or "monotonic-writes" in want:
        cross = _cross_key_violations(p, inf, want, max_reported)
        for nm, items in cross.items():
            lst = found.setdefault(nm, [])
            lst.extend(items[:max(0, max_reported - len(lst))])

    anomaly_types = sorted(found)
    boundary = consistency.friendly_boundary(anomaly_types)
    res: Dict[str, Any] = {
        "valid?": not found,
        "anomaly-types": anomaly_types,
        "anomalies": found,
        "not": boundary["not"],
        "also-not": boundary["also-not"],
        "events": int(len(proc)),
    }
    if degraded:
        res["degraded"] = degraded
    return res


def _walker_fallback(op_level, want) -> Dict[str, Any]:
    from jepsen_tpu_torch.checkers.elle import coverage, sessions

    if op_level is None:
        # packed-only input: the walker needs the op-level view —
        # degrade rather than silently validate
        return coverage.apply_unchecked(
            {"valid?": True, "anomaly-types": [], "anomalies": {},
             "not": [], "also-not": [],
             "fallback": "walker-needs-op-history"},
            sorted(g + _SUFFIX for g in want))
    res = sessions.check(op_level, guarantees=sorted(want))
    res["fallback"] = "dag-walker"
    return res
