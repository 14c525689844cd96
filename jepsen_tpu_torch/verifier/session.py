"""Incremental list-append verification sessions (the port's copy of
`jepsen_tpu/verifier/session.py`).

The batch checkers answer "was this finished history valid?".  A
:class:`VerifierSession` answers the production question instead: ops
stream in (client-appended segments, in history order) and a *rolling*
verdict streams out, recomputed incrementally —

- **packing** reuses :class:`~jepsen_tpu_torch.history.soa.TxnPacker`'s
  chunk-feed path: a segment becomes SoA columns with global txn ids,
  never a whole-history op list;
- **edges** are maintained against a per-key tail index: a new txn
  touches only the keys its mops name, and each touched key re-derives
  its version order / ww / wr / rw edges from that key's own state
  (bounded by per-key activity — real list-append generators rotate
  keys, so a key's read/append set stays small while the session
  grows).  Process and realtime(barrier) edges are append-only by
  construction because segments arrive in history order;
- **cycle detection** re-sweeps only the *dirty region*: every cycle
  that is new since the last sweep must pass through an edge added
  since the last sweep, so the sweep BFS-bounds the search to
  ``reach(new-edge heads) ∩ coreach(new-edge tails)`` per rel
  projection and runs Tarjan + the rel-constrained cycle search only
  there.  Dirty work is batched into device-sized chunks
  (``sweep_chunk``, default the device sweep's ``MAX_K_CAP``) with
  each chunk dispatched through ``resilience.device_call`` — the same
  guard seam (fault injection, transient retries, deadline polls) as
  the device pipelines, so chaos tooling reaches it;
- **the verdict tail is shared**: :func:`oracle.boundary_verdict` is
  the single implementation the batch oracle, the device pipeline, and
  this session all call, so agreement on the anomaly set implies
  agreement on the verdict.

Equality contract (pinned by tests and asserted at :meth:`seal`): for
any op stream, sealing a session yields the same ``valid?`` and
``anomaly-types`` as the batch checker run once over the concatenated
history.  The port's default batch checker is
``list_append.check`` on the session's device (the CUDA card unless the
caller names the CPU: LOCF fills in `infer`, seg-OR chain passes when
the history has backward edges); the JAX package's is its host oracle,
whose verdict the device checker equals.  The incremental state is a pure function of the op sequence
— not of its segmentation — which is what makes journal replay
(:mod:`.journal`) reach the identical verdict digest after a crash.

Retraction corner: a later, longer-but-incompatible read can *replace*
a key's inferred version order, invalidating edges derived from the
old order.  Edges are therefore owned per key; a retraction marks the
graph for one full re-sweep (the rare slow path) instead of poisoning
the dirty-region induction.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from jepsen_tpu_torch import backend, resilience, telemetry
from jepsen_tpu_torch.checkers.elle import consistency, list_append, oracle
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_NAMES,
    REL_PROCESS,
    REL_REALTIME,
    REL_RW,
    REL_WR,
    REL_WW,
    EdgeList,
    find_cycle,
)
from jepsen_tpu_torch.checkers.elle.specs import CYCLE_ANOMALY_SPECS, SPEC_ORDER
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.history.soa import (
    _CHUNK_COLS,
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
    PackedTxns,
    TxnPacker,
    _DenseValNames,
)
from jepsen_tpu_torch.resilience import Deadline, DeadlineExceeded, deadline_result

__all__ = ["VerifierSession", "VerdictMismatch", "verdict_digest",
           "iter_packed_segments", "SWEEP_SITE", "INGEST_SITE"]

#: resilience fault/guard sites on the verifier path (FaultPlan targets)
SWEEP_SITE = "verifier.sweep"
INGEST_SITE = "verifier.ingest"

#: default dirty-edge batch per guarded sweep dispatch — the device
#: sweep's backward-edge cap, so host chunks mirror the unit the device
#: path amortizes over (import kept lazy-free: the cap is a constant)
SWEEP_CHUNK = 8192


class VerdictMismatch(AssertionError):
    """Sealing found the incremental verdict != the batch verdict —
    an incremental-maintenance bug, never expected in production."""

    def __init__(self, incremental: Dict[str, Any], batch: Dict[str, Any]):
        super().__init__(
            f"incremental verdict {incremental.get('valid?')!r} "
            f"{incremental.get('anomaly-types')} != batch "
            f"{batch.get('valid?')!r} {batch.get('anomaly-types')}")
        self.incremental = incremental
        self.batch = batch


def verdict_digest(verdict: Dict[str, Any]) -> str:
    """Stable digest of the parts of a verdict that replay must
    reproduce bit-identically: the verdict, the anomaly set, and the
    graph shape.  Timestamps and report items (which carry caps and
    wall-clock fields) are deliberately excluded."""
    doc = {
        "valid?": verdict.get("valid?"),
        "anomaly-types": verdict.get("anomaly-types"),
        "txns": verdict.get("txns"),
        "edge-counts": verdict.get("edge-counts"),
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


class _KeyState:
    """Per-key tail index: this key's reads, inferred version order,
    derived edges, and structural reports — everything a touched-key
    recompute needs, with no global scans."""

    __slots__ = ("reads", "order", "edges", "reports")

    def __init__(self) -> None:
        # (rd tuple, txn node, orig op index) for OK reads with a
        # known result (rd may be empty — empty reads still anchor rw)
        self.reads: List[Tuple[Tuple[int, ...], int, int]] = []
        self.order: List[int] = []
        self.edges: Set[Tuple[int, int, int]] = set()
        self.reports: Dict[str, List[Any]] = {}


class VerifierSession:
    """One always-on checking session over a streamed list-append
    history.  Feed segments with :meth:`append_ops` (op dicts / Ops,
    the service path) or :meth:`append_columns` (pre-packed SoA
    columns, the bench path); read :meth:`verdict` any time; call
    :meth:`seal` to run the batch checker over the concatenated
    history and assert incremental/batch equality."""

    def __init__(self, name: str = "session",
                 consistency_models: Sequence[str] = ("serializable",),
                 anomalies: Sequence[str] = (),
                 max_reported: int = 8,
                 sweep_chunk: int = SWEEP_CHUNK,
                 batch_check=None,
                 plan=None,
                 device: backend.DeviceLike = None):
        self.name = name
        self.consistency_models = tuple(consistency_models)
        self.extra_anomalies = tuple(anomalies)
        self.max_reported = int(max_reported)
        self.sweep_chunk = max(1, int(sweep_chunk))
        self.plan = plan  # pinned FaultPlan for the guarded sweep seam
        self.device = device
        # batch_check(PackedTxns) -> result; default = the list-append
        # checker on the session's device
        self._batch_check = batch_check or (
            lambda p: list_append.check(p, self.consistency_models,
                                        self.extra_anomalies,
                                        max_reported=self.max_reported,
                                        device=self.device))
        self.want = set(consistency.anomalies_for_models(
            [consistency.canonical(m) for m in self.consistency_models]))
        self.want |= set(self.extra_anomalies)
        self.want |= {"duplicate-appends", "duplicate-elements",
                      "incompatible-order"}
        self._cycle_specs = [s for s in SPEC_ORDER
                             if s in self.want and s in CYCLE_ANOMALY_SPECS]

        # -- ingest state ---------------------------------------------------
        self.packer = TxnPacker("list-append")
        self._mode: Optional[str] = None  # "ops" | "packed"
        self._chunks: List[dict] = []     # retained columns for seal
        self._next_op_index = 0
        self.n_events = 0                 # op positions consumed
        self.n_txns = 0
        self.n_ok = 0
        self.segments = 0
        self.sealed: Optional[Dict[str, Any]] = None
        # packed-mode bookkeeping for seal-time PackedTxns assembly
        self._pk_keys = 0
        self._pk_vals = 0
        self._packed_rd: Optional[np.ndarray] = None

        # -- graph node space (txns and barriers share one dense space) -----
        self._n_nodes = 0
        self._node_orig: List[int] = []   # node -> orig op index (-1 barrier)
        self._node_type: List[int] = []   # node -> txn type (0 = barrier)
        self._txn_node: List[int] = []    # txn id -> node id

        # -- incremental checker state --------------------------------------
        self._writer: Dict[int, int] = {}        # val -> writer node
        self._fail_vals: Set[int] = set()        # vals written by FAIL txns
        self._final_append: Dict[int, bool] = {}
        self._keys: Dict[int, _KeyState] = {}
        self._global_reports: Dict[str, List[Any]] = {}
        self._last_proc: Dict[int, int] = {}     # process -> last ok/info node
        self._barrier_comps: List[int] = []      # ok completion positions
        self._barrier_nodes: List[int] = []

        # -- edge store + sweep state ---------------------------------------
        self._swept: List[np.ndarray] = []       # (n,3) chunks, already swept
        self._pending: List[Tuple[int, int, int]] = []
        self._rebuild = False                    # retraction -> full resweep
        #: monotonic count of sweep commits — the batched sweep's
        #: staleness stamp (len(_swept) won't do: a rebuild resets it)
        self._sweep_epoch = 0
        self._cycle_found: Dict[str, Any] = {}
        self._first_seen: Dict[str, float] = {}
        self._last_names: List[str] = []
        self._edge_counts_cache: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #

    def append_ops(self, ops: Iterable[Any]) -> int:
        """Append one segment of ops (dicts or Ops, history order).
        Returns txns completed by this segment."""
        if self._mode == "packed":
            raise ValueError("session already fed packed columns")
        self._mode = "ops"
        seq: List[Op] = []
        for o in ops:
            op = Op.from_dict(o) if isinstance(o, dict) else o
            if op.index is None or op.index < 0:
                op.index = self._next_op_index
            self._next_op_index = max(self._next_op_index, op.index + 1)
            seq.append(op)
        rd_base = self.packer.n_rd_elems
        cols = self.packer.feed(seq)
        return self.append_columns(cols, rd_elems=cols["rd_elems"],
                                   rd_base=rd_base,
                                   n_events=self.packer.pos)

    def append_columns(self, cols: Dict[str, np.ndarray], *,
                       rd_elems: Optional[np.ndarray] = None,
                       rd_base: int = 0,
                       n_events: Optional[int] = None) -> int:
        """Append one segment of packed SoA columns (the TxnPacker
        chunk shape, with GLOBAL txn ids / rd offsets).  ``rd_elems``
        is the array the segment's ``mop_rd_start`` offsets index
        (minus ``rd_base``)."""
        if self._mode is None:
            self._mode = "packed"
        if self._mode == "packed" and rd_base != 0:
            raise ValueError(
                "packed-mode segments must carry global rd offsets "
                "(rd_base == 0, one stable rd_elems array)")
        if rd_elems is None:
            rd_elems = cols.get("rd_elems", np.zeros(0, np.int32))
        n = len(cols["txn_type"])
        with telemetry.span("verifier.append", session=self.name, txns=n):
            self._ingest_segment(cols, rd_elems, rd_base)
        self.segments += 1
        if n_events is not None:
            self.n_events = max(self.n_events, int(n_events))
        else:
            cp = cols["txn_complete_pos"]
            if len(cp):
                self.n_events = max(self.n_events, int(cp[-1]) + 1)
        if self._mode == "packed":
            # rd offsets are global into ONE stable array — keep a
            # reference, never concatenate per-segment copies
            self._packed_rd = np.asarray(rd_elems)
            self._chunks.append({k: v for k, v in cols.items()
                                 if k != "rd_elems"})
            if len(cols["mop_key"]):
                self._pk_keys = max(self._pk_keys,
                                    int(cols["mop_key"].max()) + 1)
            mv = cols["mop_val"]
            if len(mv):
                self._pk_vals = max(self._pk_vals, int(mv.max()) + 1)
            re_ = np.asarray(rd_elems)
            if len(re_):
                self._pk_vals = max(self._pk_vals, int(re_.max()) + 1)
        else:
            self._chunks.append(cols)
        return n

    def _ingest_segment(self, cols, rd_elems, rd_base) -> None:
        tt = np.asarray(cols["txn_type"]).tolist()
        tp = np.asarray(cols["txn_process"]).tolist()
        ti = np.asarray(cols["txn_invoke_pos"]).tolist()
        tc = np.asarray(cols["txn_complete_pos"]).tolist()
        to = (np.asarray(cols["txn_orig_index"]).tolist()
              if "txn_orig_index" in cols else [-1] * len(tt))
        m_txn = np.asarray(cols["mop_txn"]).tolist()
        m_kind = np.asarray(cols["mop_kind"]).tolist()
        m_key = np.asarray(cols["mop_key"]).tolist()
        m_val = np.asarray(cols["mop_val"]).tolist()
        rs_arr = np.asarray(cols["mop_rd_start"])
        rl_arr = np.asarray(cols["mop_rd_len"])
        m_rs = rs_arr.tolist()
        m_rl = rl_arr.tolist()
        # convert only the rd window this segment references — in
        # packed mode rd_elems is the WHOLE global array and a
        # full-array conversion per segment would be O(history) each
        live = (rl_arr > 0) & (rs_arr >= 0)
        if live.any():
            lo = int(rs_arr[live].min())
            hi = int((rs_arr[live] + rl_arr[live]).max())
        else:
            lo = hi = rd_base
        rd_l = np.asarray(rd_elems)[lo - rd_base:hi - rd_base].tolist()
        touched: Set[int] = set()
        mi = 0
        n_m = len(m_txn)
        t_base = self.n_txns
        for i, ttype in enumerate(tt):
            t_global = t_base + i
            node = self._n_nodes
            self._n_nodes += 1
            self._node_orig.append(to[i])
            self._node_type.append(ttype)
            self._txn_node.append(node)
            self.n_txns += 1
            if ttype == TXN_OK:
                self.n_ok += 1
            # this txn's mops (mop_txn ascending, packer layout)
            mops: List[Tuple[int, int, int, Optional[Tuple[int, ...]]]] = []
            while mi < n_m and m_txn[mi] == t_global:
                kind, key, val = m_kind[mi], m_key[mi], m_val[mi]
                rd: Optional[Tuple[int, ...]] = None
                if kind == MOP_READ and m_rl[mi] >= 0:
                    s = m_rs[mi] - lo
                    rd = tuple(rd_l[s:s + m_rl[mi]])
                mops.append((kind, key, val, rd))
                touched.add(key)
                mi += 1
            self._arrive_txn(node, ttype, tp[i], ti[i], tc[i], to[i], mops)
        for k in touched:
            self._recompute_key(k)
        self._edge_counts_cache = None

    def _arrive_txn(self, node, ttype, proc, inv, comp, orig, mops) -> None:
        """Global (non-per-key) arrival work, ported stage by stage from
        the oracle's whole-history passes — each is per-txn local."""
        writer = self._writer
        # writer map + duplicate-appends + final-append flags
        last_per_key: Dict[int, int] = {}
        own_vals: List[int] = []
        for (kind, key, val, _rd) in mops:
            if kind == MOP_APPEND:
                if val in writer:
                    self._report("duplicate-appends", {
                        "value": val,
                        "txns": [self._node_orig[writer[val]], orig]})
                else:
                    writer[val] = node
                    own_vals.append(val)
                    if ttype == TXN_FAIL:
                        self._fail_vals.add(val)
                last_per_key[key] = val
        for v in own_vals:
            self._final_append[v] = False
        for key, val in last_per_key.items():
            if writer.get(val) == node:
                self._final_append[val] = True
        # internal consistency + duplicate elements (ok txns only)
        if ttype == TXN_OK:
            cur: Dict[int, Optional[List[int]]] = {}
            suffix: Dict[int, List[int]] = {}
            for mj, (kind, key, val, rd) in enumerate(mops):
                if kind == MOP_APPEND:
                    if cur.get(key) is not None:
                        cur[key] = cur[key] + [val]
                    else:
                        suffix.setdefault(key, []).append(val)
                else:
                    if rd is None:
                        continue
                    rdl = list(rd)
                    if len(set(rdl)) != len(rdl):
                        self._report("duplicate-elements",
                                     {"op": orig, "mop": mj, "key": key})
                    c = cur.get(key)
                    if c is not None:
                        if rdl != c:
                            self._report("internal",
                                         {"op": orig, "mop": mj,
                                          "expected": c, "got": rdl})
                    else:
                        sfx = suffix.get(key, [])
                        if sfx and (len(rdl) < len(sfx)
                                    or rdl[-len(sfx):] != sfx):
                            self._report("internal",
                                         {"op": orig, "mop": mj,
                                          "expected-suffix": sfx,
                                          "got": rdl})
                    cur[key] = rdl
            # per-key read store (edges + G1 recomputed per key)
            for (kind, key, val, rd) in mops:
                if kind == MOP_READ and rd is not None:
                    self._key(key).reads.append((rd, node, orig))
        # process chain (ok/info only; fail txns chain nowhere)
        if ttype in (TXN_OK, TXN_INFO):
            prev = self._last_proc.get(proc)
            if prev is not None:
                self._pending.append((prev, node, REL_PROCESS))
            self._last_proc[proc] = node
            # realtime in-edge: latest ok completion before our invoke
            b = bisect.bisect_left(self._barrier_comps, inv) - 1
            if b >= 0:
                self._pending.append(
                    (self._barrier_nodes[b], node, REL_REALTIME))
        # realtime barrier for ok completions (arrival order == comp order)
        if ttype == TXN_OK:
            bnode = self._n_nodes
            self._n_nodes += 1
            self._node_orig.append(-1)
            self._node_type.append(0)
            self._pending.append((node, bnode, REL_REALTIME))
            if self._barrier_nodes:
                self._pending.append(
                    (self._barrier_nodes[-1], bnode, REL_REALTIME))
            self._barrier_comps.append(comp)
            self._barrier_nodes.append(bnode)

    def _key(self, k: int) -> _KeyState:
        ks = self._keys.get(k)
        if ks is None:
            ks = self._keys[k] = _KeyState()
        return ks

    def _graph_txn(self, node: int) -> bool:
        return self._node_type[node] in (TXN_OK, TXN_INFO)

    def _report(self, name: str, item: Any) -> None:
        lst = self._global_reports.setdefault(name, [])
        if len(lst) < self.max_reported:
            lst.append(item)

    # ------------------------------------------------------------------ #
    # per-key recompute (the tail index)
    # ------------------------------------------------------------------ #

    def _recompute_key(self, k: int) -> None:
        """Re-derive one key's version order, structural reports, and
        ww/wr/rw edges from that key's own state — the oracle's per-key
        passes, scoped to a single key.  Added edges go dirty; any
        removed edge (a replaced version order) arms the full resweep."""
        ks = self._keys.get(k)
        if ks is None:
            return
        writer = self._writer
        ntype = self._node_type
        # version order: the FIRST longest ok read (max() semantics)
        order: List[int] = []
        for (rd, _t, _o) in ks.reads:
            if len(rd) > len(order):
                order = list(rd)
        reports: Dict[str, List[Any]] = {}

        def rep(name: str, item: Any) -> None:
            lst = reports.setdefault(name, [])
            if len(lst) < self.max_reported:
                lst.append(item)

        compat: List[Tuple[Tuple[int, ...], int]] = []
        for (rd, t, o) in ks.reads:
            if list(rd) != order[:len(rd)]:
                rep("incompatible-order",
                    {"key": k, "read": list(rd), "longest": order, "op": o})
            else:
                compat.append((rd, t))
        for a, b in zip(order[:-1], order[1:]):
            wa, wb = writer.get(a), writer.get(b)
            if (wa is not None and wb is not None
                    and ntype[wa] == TXN_FAIL and ntype[wb] == TXN_OK):
                rep("dirty-update",
                    {"key": k, "aborted-value": a, "committed-value": b,
                     "aborted-writer": self._node_orig[wa],
                     "committed-writer": self._node_orig[wb]})
        # G1a / G1b over this key's reads (writer types known at their
        # arrival; a late writer touches this key and re-triggers us).
        # The per-element G1a scan is gated on the global fail-written
        # value set — almost always empty, and set.isdisjoint is a
        # C-speed pre-check against the O(len(rd)) inner loop
        fail_vals = self._fail_vals
        for (rd, t, o) in ks.reads:
            if not rd:
                continue
            if fail_vals and not fail_vals.isdisjoint(rd):
                for v in rd:
                    if v in fail_vals:
                        w = writer[v]
                        rep("G1a", {"op": o, "value": v,
                                    "writer": self._node_orig[w]})
            last = rd[-1]
            w = writer.get(last)
            if (w is not None and w != t
                    and not self._final_append.get(last, True)):
                rep("G1b", {"op": o, "value": last,
                            "writer": self._node_orig[w]})
        # edges
        edges: Set[Tuple[int, int, int]] = set()
        for a, b in zip(order[:-1], order[1:]):
            wa, wb = writer.get(a), writer.get(b)
            if (wa is not None and wb is not None and wa != wb
                    and self._graph_txn(wa) and self._graph_txn(wb)):
                edges.add((wa, wb, REL_WW))
        for (rd, t) in compat:
            if rd:
                w = writer.get(rd[-1])
                if w is not None and w != t and self._graph_txn(w):
                    edges.add((w, t, REL_WR))
            if len(rd) < len(order):
                nxt = writer.get(order[len(rd)])
                if nxt is not None and nxt != t and self._graph_txn(nxt):
                    edges.add((t, nxt, REL_RW))
        added = edges - ks.edges
        removed = ks.edges - edges
        if removed:
            # a replaced version order retracted edges: the dirty-region
            # induction no longer covers the graph — full resweep
            self._rebuild = True
        self._pending.extend(sorted(added))
        ks.edges = edges
        ks.order = order
        ks.reports = reports

    # ------------------------------------------------------------------ #
    # dirty-region cycle sweep
    # ------------------------------------------------------------------ #

    def _all_edges(self) -> np.ndarray:
        parts = [c for c in self._swept if len(c)]
        if self._pending:
            parts.append(np.asarray(self._pending, dtype=np.int64)
                         .reshape(-1, 3))
        if not parts:
            return np.zeros((0, 3), dtype=np.int64)
        return np.concatenate(parts, axis=0)

    def _compute_rebuilt(self) -> np.ndarray:
        """The whole edge array reconstructed from the per-key sets +
        the append-only process/realtime edges (pure — the caller
        commits it into the swept store only after a successful
        sweep)."""
        stat = [c for c in self._swept if len(c)]
        static = (np.concatenate(stat, axis=0) if stat
                  else np.zeros((0, 3), np.int64))
        # swept chunks may contain per-key edges from former sweeps:
        # keep only process/realtime rows, the truly append-only part
        if len(static):
            static = static[np.isin(static[:, 2],
                                    (REL_PROCESS, REL_REALTIME))]
        pend = (np.asarray(self._pending, np.int64).reshape(-1, 3)
                if self._pending else np.zeros((0, 3), np.int64))
        if len(pend):
            pend = pend[np.isin(pend[:, 2], (REL_PROCESS, REL_REALTIME))]
        keyed = [np.asarray(sorted(ks.edges), np.int64).reshape(-1, 3)
                 for ks in self._keys.values() if ks.edges]
        allp = [p for p in (static, pend, *keyed) if len(p)]
        return (np.concatenate(allp, axis=0) if allp
                else np.zeros((0, 3), np.int64))

    def sweep(self, deadline: Optional[Deadline] = None) -> None:
        """Run the incremental cycle sweep over dirty edges.  Batches
        dirty work into ``sweep_chunk``-sized dispatches, each through
        the resilience guard (fault site ``verifier.sweep``) — expiry
        raises :class:`DeadlineExceeded` to the caller.  Failure-safe:
        dirty state commits only after every chunk succeeded, so an
        injected fault / expired budget leaves the backlog intact for
        the next sweep instead of silently dropping dirtiness."""
        if not self._pending and not self._rebuild:
            return
        with telemetry.span("verifier.sweep", session=self.name,
                            dirty=len(self._pending),
                            rebuild=self._rebuild):
            rebuilding = self._rebuild
            if rebuilding:
                full = self._compute_rebuilt()
                dirty = full
                prev_found = self._cycle_found
                self._cycle_found = {}
            else:
                dirty = np.asarray(self._pending,
                                   np.int64).reshape(-1, 3)
                full = self._all_edges()  # swept + pending
            try:
                ctx = self._sweep_context(full)
                for c0 in range(0, len(dirty), self.sweep_chunk):
                    chunk = dirty[c0:c0 + self.sweep_chunk]
                    t0 = time.perf_counter()
                    resilience.device_call(
                        SWEEP_SITE, self._sweep_chunk, ctx, chunk,
                        deadline, deadline=deadline, plan=self.plan)
                    telemetry.add_phase("sweep_s",
                                        time.perf_counter() - t0)
            except BaseException:
                if rebuilding:
                    # restore the pre-rebuild cache; _rebuild stays
                    # armed, so the next sweep redoes the whole pass
                    self._cycle_found = prev_found
                raise
            if rebuilding:
                self._swept = [full]
                self._rebuild = False
            else:
                self._swept.append(dirty)
            self._pending = []
            self._sweep_epoch += 1
        self._edge_counts_cache = None

    def _sweep_context(self, full: np.ndarray) -> Dict[str, Any]:
        """Per-sweep shared state: the union projection (one rel set
        covers every cycle spec — a spec cycle is strongly connected
        under the union too, and `find_cycle` restricts itself to the
        spec's rels) with its forward/backward CSR adjacency, built
        ONCE and reused by every dirty chunk of this sweep."""
        union: Set[int] = set()
        for name in self._cycle_specs:
            union |= CYCLE_ANOMALY_SPECS[name].rels
        p_mask = np.isin(full[:, 2], list(union)) if len(full) else \
            np.zeros(0, bool)
        src = full[p_mask, 0]
        dst = full[p_mask, 1]
        rel = full[p_mask, 2]
        return {
            "union": union,
            "src": src, "dst": dst, "rel": rel,
            "fwd": _csr(self._n_nodes, src, dst),
            "bwd": _csr(self._n_nodes, dst, src),
        }

    def _sweep_chunk(self, ctx: Dict[str, Any], dirty: np.ndarray,
                     deadline: Optional[Deadline] = None) -> None:
        """Sweep one dirty-edge chunk: bound the search to
        ``reach(dirty heads) ∩ coreach(dirty tails)`` in the union
        projection, find nontrivial SCCs there (none on the steady
        valid path), then run the per-spec rel-constrained cycle
        search inside each."""
        pending_specs = [s for s in self._cycle_specs
                         if s not in self._cycle_found]
        if not pending_specs or not len(dirty):
            return
        if deadline is not None:
            deadline.check(SWEEP_SITE)
        src, dst = ctx["src"], ctx["dst"]
        if not len(src):
            return
        d_mask = np.isin(dirty[:, 2], list(ctx["union"]))
        if not d_mask.any():
            return
        heads = np.unique(dirty[d_mask, 1])
        tails = np.unique(dirty[d_mask, 0])
        fwd = _reach(self._n_nodes, ctx["fwd"], heads)
        bwd = _reach(self._n_nodes, ctx["bwd"], tails, within=fwd)
        region = np.nonzero(fwd & bwd)[0]
        if not len(region):
            return
        remap = np.full(self._n_nodes, -1, np.int64)
        remap[region] = np.arange(len(region))
        in_r = (remap[src] >= 0) & (remap[dst] >= 0)
        sccs = _nontrivial_groups(len(region), remap[src[in_r]],
                                  remap[dst[in_r]])
        if not sccs:
            return  # region acyclic: the steady valid-history path
        proj = EdgeList()
        proj.src = src.astype(np.int32)
        proj.dst = dst.astype(np.int32)
        proj.rel = ctx["rel"].astype(np.int8)
        for name in pending_specs:
            if deadline is not None:
                deadline.check(SWEEP_SITE)
            spec = CYCLE_ANOMALY_SPECS[name]
            for scc in sccs:
                cyc = find_cycle(region[scc], proj, spec)
                if cyc is not None:
                    self._cycle_found[name] = {
                        "cycle": self._render_cycle(cyc)}
                    break

    def _render_cycle(self, cyc) -> List[Dict[str, Any]]:
        """Contract barrier pseudo-nodes into txn->txn realtime steps
        (the oracle's rendering rule, over the unified node space)."""
        is_txn = [self._node_type[s] != 0 for (s, _r, _d) in cyc]
        k = next((i for i, t in enumerate(is_txn) if t), 0)
        cyc = cyc[k:] + cyc[:k]
        out = []
        pend_src = None
        for (s, rel, d) in cyc:
            s_txn = self._node_type[s] != 0
            d_txn = self._node_type[d] != 0
            if not d_txn:
                if s_txn:
                    pend_src = s
                continue
            src = s if s_txn else pend_src
            out.append({"src": self._node_orig[src] if src is not None
                        else None,
                        "rel": REL_NAMES[rel],
                        "dst": self._node_orig[d]})
        return out

    # ------------------------------------------------------------------ #
    # verdicts
    # ------------------------------------------------------------------ #

    def edge_counts(self) -> Dict[str, int]:
        """Deduplicated per-rel edge counts — the oracle's
        ``edge-counts`` map, for cross-checking the incremental graph
        against the batch one.  Dedup runs on a scalar int64 encoding
        of (src, dst, rel): one 1-D sort instead of np.unique(axis=0)'s
        structured row sort (~50x on 100k-session edge arrays)."""
        if self._edge_counts_cache is None:
            full = self._all_edges()
            if not len(full):
                self._edge_counts_cache = {}
            else:
                m = int(self._n_nodes) + 1
                codes = (full[:, 0] * m + full[:, 1]) * 8 + full[:, 2]
                rels = np.unique(codes) % 8
                cnt = np.bincount(rels.astype(np.int64), minlength=8)
                self._edge_counts_cache = {
                    REL_NAMES[int(r)]: int(cnt[r])
                    for r in np.nonzero(cnt)[0]}
        return self._edge_counts_cache

    def _found(self) -> Dict[str, List[Any]]:
        found: Dict[str, List[Any]] = {}
        for name, items in self._global_reports.items():
            if items:
                found.setdefault(name, []).extend(
                    items[:self.max_reported])
        for ks in self._keys.values():
            for name, items in ks.reports.items():
                lst = found.setdefault(name, [])
                for it in items:
                    if len(lst) < self.max_reported:
                        lst.append(it)
        for name, item in self._cycle_found.items():
            found.setdefault(name, []).append(item)
        return found

    def verdict(self, deadline: Optional[Deadline] = None,
                sweep: bool = True) -> Dict[str, Any]:
        """The rolling verdict: sweep dirty work (unless ``sweep`` is
        False), then assemble the oracle-shaped result plus session
        meta, anomaly first-seen timestamps, and the delta vs the
        previous verdict call."""
        try:
            if sweep:
                self.sweep(deadline=deadline)
        except DeadlineExceeded as e:
            res = deadline_result(
                checker="verifier", session=self.name,
                **{"anomaly-types": sorted(self._found()),
                   "partial": f"sweep interrupted at {e.what or 'sweep'}"})
            return res
        found = self._found()
        res = oracle.boundary_verdict(
            found, self.consistency_models, self.want,
            has_ok=self.n_ok > 0, sess_checked=False,
            edge_counts=self.edge_counts())
        now = time.time()
        names = res["anomaly-types"]
        for n in names:
            self._first_seen.setdefault(n, round(now, 3))
        res.update({
            "session": self.name,
            "txns": self.n_txns,
            "ops": self.n_events,
            "segments": self.segments,
            "sealed": self.sealed is not None,
            "first-seen": {n: self._first_seen[n] for n in names},
            "new": [n for n in names if n not in self._last_names],
            "cleared": [n for n in self._last_names if n not in names],
        })
        self._last_names = list(names)
        return res

    def restore_rolling(self, first_seen: Optional[Dict[str, float]],
                        last_names: Optional[Sequence[str]]) -> None:
        """Re-seed the rolling-delta state from a persisted snapshot
        (the service's recovery path): without this, every anomaly a
        restarted session still sees would re-report as ``new`` with a
        reset first-seen timestamp."""
        if first_seen:
            for k, v in first_seen.items():
                if isinstance(v, (int, float)):
                    self._first_seen.setdefault(str(k), float(v))
        if last_names:
            self._last_names = [str(n) for n in last_names]

    def to_packed(self) -> PackedTxns:
        """The concatenated history as one PackedTxns — what the batch
        checker sees at seal."""
        if self._mode == "ops" or self._mode is None:
            return self.packer.to_packed(self._chunks)
        cols = {}
        names = ("txn_type", "txn_process", "txn_invoke_pos",
                 "txn_complete_pos", "txn_orig_index", "mop_txn",
                 "mop_kind", "mop_key", "mop_val", "mop_rd_start",
                 "mop_rd_len")
        for name in names:
            parts = [c[name] for c in self._chunks if name in c]
            cols[name] = (np.concatenate(parts) if parts
                          else np.zeros(0, np.int32))
        cols["rd_elems"] = (self._packed_rd if self._packed_rd is not None
                            else np.zeros(0, np.int32))
        return PackedTxns(
            key_names=list(range(self._pk_keys)),
            val_names=_DenseValNames(self._pk_vals, cols["mop_key"],
                                     cols["mop_val"]),
            n_events=self.n_events, **cols)

    # ------------------------------------------------------------------ #
    # checkpoint / restore (journal compaction)
    # ------------------------------------------------------------------ #

    def checkpoint_state(self) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, Any]]:
        """Snapshot the ingested prefix for journal compaction: the
        concatenated packed columns (binary, ~10x smaller than the
        jsonl they let the journal drop) plus the packer's interner
        state and counters.  The incremental checker state itself is
        NOT serialized — it is a pure function of the op sequence, so
        :meth:`load_checkpoint` re-derives it from the columns with one
        vectorized re-ingest (no JSON parse, no re-packing), and the
        restored session's verdict digest is identical by construction.
        Only op-fed (service-path) sessions checkpoint; the packed
        bench path keeps its own columns already."""
        if self._mode == "packed":
            raise ValueError("packed-mode sessions don't checkpoint")
        cols: Dict[str, np.ndarray] = {}
        for name, dt in _CHUNK_COLS:
            parts = [c[name] for c in self._chunks if name in c]
            cols[name] = (np.concatenate(parts) if parts
                          else np.zeros(0, dt))
        pk = self.packer
        meta = {
            "packer": {
                "key_names": list(pk.key_names),
                "val_names": [list(v) for v in pk.val_names],
                "pending": {str(p): op.to_dict()
                            for p, op in pk.pending.items()},
                "pos": pk.pos, "n_txns": pk.n_txns,
                "n_mops": pk.n_mops,
                "max_mops_txn": pk.max_mops_txn,
                "n_rd_elems": pk.n_rd_elems,
            },
            "n_events": self.n_events,
            "n_txns": self.n_txns,
            "segments": self.segments,
            "next_op_index": self._next_op_index,
        }
        return cols, meta

    def load_checkpoint(self, cols: Dict[str, np.ndarray],
                        meta: Dict[str, Any]) -> None:
        """Restore a fresh session from a checkpoint: re-seed the
        packer interners, re-ingest the packed prefix (one vectorized
        segment), and resume counters — after this, :meth:`append_ops`
        continues exactly where the checkpointed session stopped."""
        if self.n_txns or self._mode is not None:
            raise ValueError("load_checkpoint needs a fresh session")
        pkm = meta["packer"]
        pk = self.packer
        pk.key_names = list(pkm["key_names"])
        pk.key_ids = {k: i for i, k in enumerate(pk.key_names)}
        pk.val_names = [tuple(v) for v in pkm["val_names"]]
        pk.val_ids = {(int(ki), v): i
                      for i, (ki, v) in enumerate(pk.val_names)}
        pk.pending = {int(p): Op.from_dict(d)
                      for p, d in (pkm.get("pending") or {}).items()}
        pk.pos = int(pkm["pos"])
        pk.n_txns = int(pkm["n_txns"])
        pk.n_mops = int(pkm["n_mops"])
        pk.max_mops_txn = int(pkm["max_mops_txn"])
        pk.n_rd_elems = int(pkm["n_rd_elems"])
        self._mode = "ops"
        cols = {k: np.asarray(v) for k, v in cols.items()}
        self._chunks.append(cols)
        if len(cols["txn_type"]):
            with telemetry.span("verifier.restore", session=self.name,
                                txns=len(cols["txn_type"])):
                self._ingest_segment(cols, cols["rd_elems"], 0)
        self.n_ok = int(np.sum(cols["txn_type"] == TXN_OK))
        self.n_events = int(meta["n_events"])
        self.n_txns = int(meta["n_txns"])
        self.segments = int(meta["segments"])
        self._next_op_index = int(meta["next_op_index"])
        self._edge_counts_cache = None

    def seal(self, deadline: Optional[Deadline] = None) -> Dict[str, Any]:
        """Seal the session: final incremental verdict, then the full
        batch checker over the concatenated history, asserting the two
        agree on ``valid?`` and the anomaly set.  Raises
        :class:`VerdictMismatch` on disagreement."""
        inc = self.verdict(deadline=deadline)
        with telemetry.span("verifier.seal-batch-check",
                            session=self.name, txns=self.n_txns):
            batch = resilience.device_call(
                "verifier.seal", self._batch_check, self.to_packed(),
                deadline=deadline, plan=self.plan)
        equal = (batch.get("valid?") == inc.get("valid?")
                 and list(batch.get("anomaly-types") or [])
                 == list(inc.get("anomaly-types") or []))
        if not equal:
            raise VerdictMismatch(inc, batch)
        self.sealed = {
            "sealed": True,
            "equal": True,
            "verdict": batch,
            "incremental": inc,
            "digest": verdict_digest(inc),
            "txns": self.n_txns,
            "ops": self.n_events,
        }
        return self.sealed

    def digest(self) -> str:
        """Digest of the current rolling verdict (sweeps first)."""
        return verdict_digest(self.verdict())


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #

def _nontrivial_groups(n: int, src: np.ndarray, dst: np.ndarray
                       ) -> List[np.ndarray]:
    """Nontrivial SCC node groups (size > 1, or a self-loop) over a
    compacted subgraph.  Same answer as `graph.nontrivial_sccs`, but
    materializes ONLY the nontrivial groups — the generic version
    np.split's one array per component, which is millions of tiny
    allocations on the all-singleton (acyclic) sweeps this path runs
    all day."""
    from jepsen_tpu_torch.checkers.elle.graph import tarjan_scc

    if n == 0 or not len(src):
        return []
    comp = tarjan_scc(n, src, dst)
    cnt = np.bincount(comp)
    want = cnt > 1
    loops = src[src == dst]
    if len(loops):
        want[comp[loops]] = True
    labels = np.nonzero(want)[0]
    return [np.nonzero(comp == lbl)[0].astype(np.int64)
            for lbl in labels]


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    """CSR-ish adjacency (sorted-dst array + per-node slice bounds) —
    built once per sweep, shared by every chunk's reach passes."""
    order = np.argsort(src, kind="stable")
    ss, dd = src[order], dst[order]
    starts = np.searchsorted(ss, np.arange(n))
    ends = np.searchsorted(ss, np.arange(n), side="right")
    return dd, starts, ends


def _reach(n: int, csr, roots: np.ndarray,
           within: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean reachability from ``roots`` over a prebuilt CSR,
    optionally restricted to nodes where ``within`` is True (the
    coreach-inside-reach bound that keeps the dirty region small on
    acyclic graphs)."""
    dd, starts, ends = csr
    seen = np.zeros(n, bool)
    if not len(roots):
        return seen
    if within is not None:
        roots = roots[within[roots]]
        if not len(roots):
            return seen
    seen[roots] = True
    frontier = np.unique(roots)
    while len(frontier):
        counts = ends[frontier] - starts[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        # vectorized multi-slice gather (device_core._expand_all shape)
        idx = np.repeat(starts[frontier], counts) + \
            (np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                          counts))
        outs = dd[idx]
        if within is not None:
            outs = outs[within[outs]]
        outs = outs[~seen[outs]]
        if not len(outs):
            break
        seen[outs] = True
        frontier = np.unique(outs)
    return seen


def iter_packed_segments(p: PackedTxns, seg_txns: int):
    """Slice a PackedTxns into append_columns-shaped segments of
    ``seg_txns`` transactions each (the bench --streaming feeder).
    Yields ``(cols, rd_elems, rd_base)`` triples; rd offsets stay
    global, so ``rd_elems`` is the whole array with ``rd_base`` 0."""
    mop_txn = np.asarray(p.mop_txn)
    for t0 in range(0, p.n_txns, seg_txns):
        t1 = min(t0 + seg_txns, p.n_txns)
        m0, m1 = np.searchsorted(mop_txn, [t0, t1])
        cols = {
            "txn_type": p.txn_type[t0:t1],
            "txn_process": p.txn_process[t0:t1],
            "txn_invoke_pos": p.txn_invoke_pos[t0:t1],
            "txn_complete_pos": p.txn_complete_pos[t0:t1],
            "txn_orig_index": p.txn_orig_index[t0:t1],
            "mop_txn": mop_txn[m0:m1],
            "mop_kind": p.mop_kind[m0:m1],
            "mop_key": p.mop_key[m0:m1],
            "mop_val": p.mop_val[m0:m1],
            "mop_rd_start": p.mop_rd_start[m0:m1],
            "mop_rd_len": p.mop_rd_len[m0:m1],
        }
        yield cols, p.rd_elems, 0
