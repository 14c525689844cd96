"""The list-append checker on the device (PyTorch).

Counterpart of `jepsen_tpu/checkers/elle/list_append.py`.  `check()` is
API-compatible with the host oracle (`oracle.check`): same anomaly
taxonomy, same consistency-model verdicts, the same result dict.

Split of labor:
  device — SoA packing -> `device_infer.infer` (version orders, non-cycle
           anomaly scans, ww/wr/rw/process/realtime edges; the forward
           fills run the LOCF kernel) -> one cycle sweep per rel
           projection (`ops.cycle_sweep.detect_cycles`; its chain passes
           run the seg-OR kernel).
  host   — only when a projection reports a cycle: extract the small
           offending region around witness backward edges (numpy frontier
           BFS) and classify/render the exact cycle per anomaly spec with
           the shared rel-constrained search (`graph.find_cycle`).

A valid history never leaves the device except for O(1) flags and counts.

Verdicts are never approximated, and the host oracle never hides the
device path: a sweep that fails to converge raises `SweepNotConverged`, and
every real error of the device path (a kernel that cannot be built, a fault
inside a kernel that surfaces at the next copy, an out-of-memory that
outlives its retries, a missing card) is raised as it is.  Only a synthetic
fault of a `resilience.FaultPlan` degrades to the oracle, stamped
``"degraded": "host-fallback"``: the drill that exercises the degradation
tail.  The phase spans and the staged-bytes counter are the JAX
package's, and so is the sharded-by-default sweep over the mesh that
`parallel.slots.default_mesh` resolves; its compile cache is not carried
over.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend, resilience, telemetry
from jepsen_tpu_torch.checkers.elle import consistency, coverage, oracle
from jepsen_tpu_torch.checkers.elle.device_infer import infer, pad_packed
from jepsen_tpu_torch.checkers.elle.explain import la_explainer
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_PROCESS,
    REL_REALTIME,
    REL_RW,
    REL_WR,
    REL_WW,
    CycleSpec,
    EdgeList,
    find_cycle,
)
from jepsen_tpu_torch.checkers.elle.specs import (
    CYCLE_ANOMALY_SPECS,
    SPEC_ORDER,
)
from jepsen_tpu_torch.checkers.elle.txn_cycles import _render_cycle
from jepsen_tpu_torch.history.ir import HistoryIR
from jepsen_tpu_torch.history.soa import TXN_OK, PackedTxns, pack_txns
from jepsen_tpu_torch.ops.cycle_sweep import (
    SweepGraph,
    detect_cycles,
    unconverged_reason,
)

#: edge families of `infer`, in the order they are concatenated
EDGE_FAMILIES = ("ww", "wr", "rw", "tb", "bt")
FAMILY_RELS = (REL_WW, REL_WR, REL_RW, REL_REALTIME, REL_REALTIME)

# first-call-in-process tracking of `infer`: the "warm" attr of its
# telemetry span (the JAX package's proxy for compile vs execute)
_WARM: Dict[str, bool] = {}


class SweepNotConverged(RuntimeError):
    """A projection's cycle sweep reached its growth caps without a
    fixpoint.  The JAX package answers this with a host-oracle run; the
    port raises it, so that no result of the device path comes from the
    host."""


def check(history, consistency_models: Sequence[str] = ("serializable",),
          anomalies: Sequence[str] = (), max_reported: int = 8,
          _force_no_fallback: bool = False, deadline=None, policy=None,
          plan=None, device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a list-append history on `device` (the CUDA card unless the
    caller names the CPU; no card raises `backend.NoDeviceError`).
    Accepts History / op list / PackedTxns / HistoryIR; an IR's packed
    and padded sections are built once and reused by every check of it.

    `deadline` (a `resilience.Deadline`) is polled between device stages
    and per sweep projection — expiry returns ``{"valid?": "unknown",
    "error": "deadline-exceeded"}`` with whatever anomaly counts inference
    already produced.  The device entry points (infer, cycle sweep) run
    under the resilience guard: transient failures retry per `policy`.
    A synthetic fault of `plan` (or of the installed plan) that outlives
    its retries degrades to the host oracle with ``"degraded":
    "host-fallback"`` stamped into the result; every other error is
    raised (see the module docstring)."""
    try:
        return _check_device(history, consistency_models, anomalies,
                             max_reported, deadline, policy, plan,
                             backend.resolve(device))
    except resilience.DeadlineExceeded:
        # expiry before/inside a device stage: the canonical unknown —
        # the sweep loop returns richer partial stats on its own
        return resilience.deadline_result(checker="list-append")
    except resilience.FaultInjected as e:  # the degradation drill
        if _force_no_fallback:
            raise
        try:
            # shared degradation tail: deadline poll + "degraded" /
            # "device-error" stamps (guard.py) — an expired budget is
            # never converted into a host run
            return resilience.degrade_to_host(
                "elle.list-append",
                lambda: oracle.check(history, consistency_models,
                                     anomalies,
                                     max_reported=max_reported,
                                     deadline=deadline),
                e, deadline=deadline)
        except resilience.DeadlineExceeded:
            return resilience.deadline_result(checker="list-append")


def _check_device(history, consistency_models, anomalies, max_reported,
                  deadline, policy, plan, dev: torch.device) -> Dict[str, Any]:
    def poll(site: str) -> None:
        if deadline is not None:
            deadline.check(site)

    def guarded(site: str, fn):
        # guarded seam: synthetic faults fire here, transients retry;
        # a persistent failure raises out to check()
        return resilience.device_call(site, fn, policy=policy,
                                      deadline=deadline, plan=plan)

    # phase spans matching the host oracle's stage names (device=True
    # distinguishes them in one trace)
    ph = telemetry.phases()
    ir = history if isinstance(history, HistoryIR) else None
    if isinstance(history, PackedTxns):
        p = history
    else:
        ph.start("elle.pack", device=True)
        p = (ir.packed("list-append") if ir is not None
             else pack_txns(history, "list-append"))
    if ir is not None and ir.packed_only:
        # packed-only IR: downstream consumers (oracle fallback, session
        # coverage) must see the bare PackedTxns degradation semantics
        history = p
    if p.n_txns == 0 or not (p.txn_type == TXN_OK).any():
        ph.end()
        return {"valid?": "unknown", "anomaly-types": [], "anomalies": {},
                "not": [], "also-not": []}

    poll("elle.infer")
    ph.start("elle.infer", device=True, txns=p.n_txns,
             warm=_WARM.get("infer", False))
    _WARM["infer"] = True
    # the IR caches the padded layout per device: repeat checks of one
    # history skip the pad, and a transient retry of infer never pads again
    h = ir.padded("list-append", dev) if ir is not None \
        else pad_packed(p, device=dev)
    # sharded by default, as in the JAX package: with more than one
    # visible device and a large enough history (or a forced shard
    # count), each projection sweep splits its backward-edge axis over
    # the mesh; inference runs on the mesh's first device
    from jepsen_tpu_torch.parallel import slots as _slots

    mesh = _slots.default_mesh(h.txn_type.shape[0], device=dev)
    if mesh is not None:
        from jepsen_tpu_torch.parallel.op_shard import shard_padded

        h, _ = shard_padded(h, mesh, "batch")
    if telemetry.enabled():
        telemetry.registry().counter("device-bytes-staged").inc(
            sum(a.numel() * a.element_size() for a in (
                h.txn_type, h.txn_process, h.txn_invoke_pos,
                h.txn_complete_pos, h.txn_mask, h.mop_txn, h.mop_kind,
                h.mop_key, h.mop_val, h.mop_rd_start, h.mop_rd_len,
                h.mop_mask, h.rd_elems, h.rd_elem_mask)))
    out = guarded("elle.infer", lambda: infer(h, p.n_keys))

    found: Dict[str, List[Any]] = {}
    names = list(out["counts"])
    counts = torch.stack([out["counts"][k].to(torch.int64)
                          for k in names]).cpu().tolist()
    for name, cnt in zip(names, counts):
        if cnt > 0:
            found[name] = [{"count": cnt}]

    # which anomalies to search/report
    want = set(consistency.anomalies_for_models(
        [consistency.canonical(m) for m in consistency_models]))
    want |= set(anomalies)
    want |= {"duplicate-appends", "duplicate-elements", "incompatible-order"}

    # ---- cycle anomalies: group specs by rel projection -------------------
    ph.start("elle.graph-build", device=True)
    specs = [(name, CYCLE_ANOMALY_SPECS[name]) for name in SPEC_ORDER
             if name in want]
    projections: Dict[frozenset, List[Tuple[str, CycleSpec]]] = {}
    for name, spec in specs:
        projections.setdefault(spec.rels, []).append((name, spec))

    T = out["ranks"]["txn"].shape[0]
    edges = out["edges"]
    chains = out["chains"]
    rank = torch.cat([out["ranks"]["txn"], out["ranks"]["barrier"]])

    # static concatenated edge arrays; per-projection masks
    e_src = torch.cat([edges[k][0] for k in EDGE_FAMILIES])
    e_dst = torch.cat([edges[k][1] for k in EDGE_FAMILIES])
    base_mask = torch.cat([edges[k][2] for k in EDGE_FAMILIES])
    rel_of = np.concatenate([
        np.full(edges[k][0].shape[0], rel, np.int8)
        for k, rel in zip(EDGE_FAMILIES, FAMILY_RELS)])
    rel_arr = torch.from_numpy(rel_of).to(dev)

    pc_nodes, pc_starts, pc_mask = chains["process"]
    bc_nodes, bc_starts, bc_mask = chains["barrier"]
    chain_nodes = torch.cat([pc_nodes, bc_nodes])
    chain_starts = torch.cat([pc_starts, bc_starts])

    host = None        # (src, dst, EdgeList) on the host, at a first cycle
    explainer = None   # lazily built per-edge Explainer
    ph.start("elle.cycle-sweep", device=True,
             projections=len(projections))
    for rels, group in projections.items():
        # deadline poll per projection: the sweep fixpoint retries
        # (grow max_k/max_rounds) can stretch a pathological history —
        # expiry returns unknown + the counts inference already found
        if deadline is not None:
            try:
                deadline.check("elle.cycle-sweep")
            except resilience.DeadlineExceeded:
                ph.end()
                return resilience.deadline_result(
                    **{"anomaly-types": sorted(found),
                       "anomalies": found, "not": [], "also-not": [],
                       "partial": "cycle-sweep interrupted"})
        sel = torch.zeros_like(base_mask)
        for r in rels:
            sel = sel | (rel_arr == r)
        mask = base_mask & sel
        # a Python bool and'ed with a bool tensor stays a bool tensor
        cmask = torch.cat([pc_mask & (REL_PROCESS in rels),
                           bc_mask & (REL_REALTIME in rels)])
        g = SweepGraph(n_nodes=2 * T, rank=rank, nc_src=e_src, nc_dst=e_dst,
                       nc_mask=mask, chain_nodes=chain_nodes,
                       chain_starts=chain_starts, chain_mask=cmask)
        res = guarded("elle.cycle-sweep",
                      lambda g=g: detect_cycles(g, deadline=deadline,
                                                device=dev, mesh=mesh))
        if not res.converged:
            raise SweepNotConverged(
                f"cycle sweep of projection {sorted(rels)} did not converge "
                f"({unconverged_reason(res)})")
        if not res.has_cycle:
            continue
        # ---- host classification over witness regions --------------------
        if host is None:
            host = _materialize_host_edges(e_src, e_dst, base_mask, rel_of,
                                           chains)
        src, dst, host_edges = host
        proj = host_edges.project(rels)
        regions = _witness_regions(proj, src, dst, res.witness_edge_ids,
                                   2 * T, limit=16)
        for name, spec in group:
            hit = None
            for region in regions:
                hit = find_cycle(region, proj, spec)
                if hit is not None:
                    break
            if hit is not None:
                if explainer is None:
                    explainer = la_explainer(
                        p, {k: v.cpu().numpy()
                            for k, v in out["order"].items()})
                found.setdefault(name, []).append(
                    {"cycle": _render(hit, p, T, explainer),
                     "witnesses": int(len(res.witness_edge_ids))})

    # session-guarantee tokens run the dedicated per-process checker (see
    # coverage.py for the PackedTxns degradation rule)
    poll("elle.sessions")
    ph.start("elle.sessions", device=False)
    sess_found, sess_checked = coverage.run_la_sessions(
        history, want, isinstance(history, PackedTxns),
        max_reported=max_reported)
    for k, v in sess_found.items():
        found.setdefault(k, []).extend(v)
    ph.end()

    # shared verdict tail: the device pipeline reached this point only
    # with committed txns (the no-ok case returned unknown above)
    return oracle.boundary_verdict(found, consistency_models, want,
                                   has_ok=True, sess_checked=sess_checked)


def _materialize_host_edges(e_src, e_dst, base_mask, rel_of, chains
                            ) -> Tuple[np.ndarray, np.ndarray, EdgeList]:
    """Copy the concatenated edge arrays, their mask and the chains to the
    host, each once, and build the host EdgeList: the masked edges plus
    the chain-implied ones.  Returns (src, dst, EdgeList); `src` and `dst`
    keep the sweep's concatenation order, so witness edge ids index
    them."""
    src, dst, m = (t.cpu().numpy() for t in (e_src, e_dst, base_mask))
    parts_s = [src[m]]
    parts_d = [dst[m]]
    parts_r = [rel_of[m]]
    for cname, rel in (("process", REL_PROCESS), ("barrier", REL_REALTIME)):
        nodes, starts, cm = (t.cpu().numpy() for t in chains[cname])
        ok = cm[:-1] & cm[1:] & ~starts[1:]
        parts_s.append(nodes[:-1][ok])
        parts_d.append(nodes[1:][ok])
        parts_r.append(np.full(int(ok.sum()), rel, np.int8))
    e = EdgeList()
    e.src = np.concatenate(parts_s).astype(np.int32)
    e.dst = np.concatenate(parts_d).astype(np.int32)
    e.rel = np.concatenate(parts_r).astype(np.int8)
    return src, dst, e


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    order = np.argsort(src, kind="stable")
    ss, dd = src[order], dst[order]
    starts = np.searchsorted(ss, np.arange(n + 1))
    return dd, starts


def _bfs_reach(n: int, src, dst, roots: np.ndarray) -> np.ndarray:
    """Boolean reachability from roots via numpy frontier expansion."""
    dd, starts = _csr(n, src, dst)
    seen = np.zeros(n, bool)
    seen[roots] = True
    frontier = np.unique(roots)
    while len(frontier):
        outs = (np.concatenate([dd[starts[v]:starts[v + 1]]
                                for v in frontier])
                if len(frontier) < 1024 else
                _expand_all(dd, starts, frontier))
        outs = outs[~seen[outs]]
        if not len(outs):
            break
        seen[outs] = True
        frontier = np.unique(outs)
    return seen


def _expand_all(dd, starts, frontier):
    counts = starts[frontier + 1] - starts[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dd.dtype)
    idx = np.repeat(starts[frontier], counts) + \
        (np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
    return dd[idx]


def _witness_regions(proj: EdgeList, e_src, e_dst, witness_ids, n_nodes,
                     limit: int = 16) -> List[np.ndarray]:
    """Nodes on cycles through each witness backward edge (u -> w):
    forward-reach(w) ∩ reverse-reach(u) in the projection."""
    regions = []
    for wid in witness_ids[:limit]:
        u, w = int(e_src[wid]), int(e_dst[wid])
        fwd = _bfs_reach(n_nodes, proj.src, proj.dst, np.array([w]))
        bwd = _bfs_reach(n_nodes, proj.dst, proj.src, np.array([u]))
        nodes = np.nonzero(fwd & bwd)[0]
        if len(nodes):
            regions.append(nodes.astype(np.int64))
    return regions


def _render(cyc, p: PackedTxns, T: int, explainer=None):
    """Collapse barrier hops and emit reported edges, each carrying the
    Explainer's per-edge justification (key, values, why) — the
    reference's `elle/core.clj` Explainer output shape."""
    return _render_cycle(cyc, explainer, T, np.asarray(p.txn_orig_index))
