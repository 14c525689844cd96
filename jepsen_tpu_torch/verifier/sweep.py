"""Multi-tenant batched dirty-region sweeps (the port's copy of
`jepsen_tpu/verifier/sweep.py`).

The per-session sweep (`session.VerifierSession.sweep`) is exact but
host-bound: each session computes its own dirty region and runs Tarjan
plus the per-spec cycle search there.  With hundreds of live sessions
that per-session host pass is the scaling wall — each dispatch is tiny,
so nothing amortizes.

This module packs MANY sessions' dirty regions into ONE
`ops.cycle_sweep.detect_cycles` dispatch:

1. per session (cheap, host, under that session's lock): compute the
   dirty region ``reach(dirty heads) ∩ coreach(dirty tails)`` in the
   union cycle-spec projection and extract its compacted subgraph —
   an empty region means the session is clean this round and commits
   without any dispatch;
2. concatenate every non-empty region block-diagonally (node offsets;
   rank = node id, so each block keeps its arrival order and no edge
   crosses blocks), pad nodes/edges to power-of-two shape classes (the
   JAX package's executable-sharing rule, kept so both packages sweep
   the same graph), and run ONE guarded `detect_cycles` rank-sweep on
   the card (the port's `ops.cycle_sweep`; the graph has no chain rows,
   so it launches no seg-OR) (fault site ``verifier.sweep`` — the
   same seam the per-session chunks use, so chaos tooling and retry
   policies reach it);
3. sessions whose block carries **no backward-edge witness** are
   proven acyclic in their region — every new cycle must lie inside
   it — and commit their dirty backlog; sessions with witnesses (or a
   non-converged sweep) fall back to their own exact per-session sweep
   for spec classification, preserving verdict equality bit for bit.

The batched dispatch runs under a ``verifier.sweep`` telemetry span
(``batched=True``), so `cli obs gate` can regression-gate it like any
checker span.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend, resilience, telemetry
from jepsen_tpu_torch.checkers.elle.specs import CYCLE_ANOMALY_SPECS
from jepsen_tpu_torch.resilience import Deadline

from .session import SWEEP_SITE, VerifierSession, _csr, _reach

logger = logging.getLogger("jepsen.verifier")

__all__ = ["region_snapshot", "batched_sweep"]


def _union_rels(sess: VerifierSession) -> set:
    union: set = set()
    for name in sess._cycle_specs:
        union |= CYCLE_ANOMALY_SPECS[name].rels
    return union


def region_snapshot(sess: VerifierSession) -> Optional[Dict[str, Any]]:
    """One session's dirty-region subgraph, computed under the caller's
    (the session's) lock.  Returns None when there is nothing to sweep,
    ``{"kind": "rebuild"}`` when a retraction armed the full resweep
    (that session sweeps itself), ``{"kind": "clean", "k": n}`` when
    the dirty edges provably close no region (commit immediately), or
    ``{"kind": "region", ...}`` with the compacted region subgraph."""
    if sess._rebuild:
        return {"kind": "rebuild"}
    k = len(sess._pending)
    if not k:
        return None
    # staleness stamp: a concurrent per-session sweep (an HTTP verdict
    # between this snapshot and the batched commit) bumps the epoch —
    # the commit must notice and not mark the POST-snapshot dirty
    # edges as swept.  The epoch is monotonic; len(_swept) would not
    # do, since a rebuild sweep resets it to 1
    stamp = sess._sweep_epoch
    pending_specs = [s for s in sess._cycle_specs
                     if s not in sess._cycle_found]
    if not pending_specs:
        return {"kind": "clean", "k": k, "stamp": stamp}
    union = _union_rels(sess)
    full = sess._all_edges()
    p_mask = np.isin(full[:, 2], list(union)) if len(full) else \
        np.zeros(0, bool)
    src = full[p_mask, 0]
    dst = full[p_mask, 1]
    dirty = np.asarray(sess._pending, np.int64).reshape(-1, 3)
    d_mask = np.isin(dirty[:, 2], list(union))
    if not d_mask.any() or not len(src):
        return {"kind": "clean", "k": k, "stamp": stamp}
    heads = np.unique(dirty[d_mask, 1])
    tails = np.unique(dirty[d_mask, 0])
    fwd = _reach(sess._n_nodes, _csr(sess._n_nodes, src, dst), heads)
    bwd = _reach(sess._n_nodes, _csr(sess._n_nodes, dst, src), tails,
                 within=fwd)
    region = np.nonzero(fwd & bwd)[0]
    if not len(region):
        return {"kind": "clean", "k": k, "stamp": stamp}
    remap = np.full(sess._n_nodes, -1, np.int64)
    remap[region] = np.arange(len(region))
    in_r = (remap[src] >= 0) & (remap[dst] >= 0)
    rs = remap[src[in_r]]
    rd = remap[dst[in_r]]
    if not len(rs):
        return {"kind": "clean", "k": k, "stamp": stamp}
    return {"kind": "region", "k": k, "stamp": stamp,
            "n": int(len(region)),
            "src": rs.astype(np.int32), "dst": rd.astype(np.int32)}


def _commit(sess: VerifierSession, k: int) -> None:
    """Move the first ``k`` dirty edges (the swept snapshot prefix —
    `_pending` is append-only between sweeps, so edges ingested after
    the snapshot stay dirty) into the swept store."""
    if k <= 0:
        return
    chunk = np.asarray(sess._pending[:k], np.int64).reshape(-1, 3)
    if len(chunk):
        sess._swept.append(chunk)
    sess._pending = sess._pending[k:]
    sess._sweep_epoch += 1


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _dispatch(regions: List[Dict[str, Any]],
              deadline: Optional[Deadline],
              n_sessions: int,
              device: backend.DeviceLike = None) -> Tuple[bool, set]:
    """One block-diagonal `detect_cycles` over every region.  Returns
    ``(converged, hit_blocks)`` — blocks whose region carries a
    backward-edge witness (a cycle passes through them)."""
    from jepsen_tpu_torch.ops.cycle_sweep import SweepGraph, detect_cycles

    dev = backend.resolve(device)

    node_off: List[int] = []
    edge_bounds: List[int] = [0]
    srcs, dsts = [], []
    n_nodes = 0
    for r in regions:
        node_off.append(n_nodes)
        srcs.append(r["src"] + n_nodes)
        dsts.append(r["dst"] + n_nodes)
        n_nodes += r["n"]
        edge_bounds.append(edge_bounds[-1] + len(r["src"]))
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    n_edges = len(src)
    # pow2 shape classes, as the JAX package pads them
    n_pad = _pow2(max(2, n_nodes))
    e_pad = _pow2(max(2, n_edges))
    mask = np.zeros(e_pad, bool)
    mask[:n_edges] = True

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    g = SweepGraph(
        n_nodes=n_pad,
        rank=on_dev(np.arange(n_pad, dtype=np.int32)),
        nc_src=on_dev(np.concatenate(
            [src, np.zeros(e_pad - n_edges, np.int32)])),
        nc_dst=on_dev(np.concatenate(
            [dst, np.zeros(e_pad - n_edges, np.int32)])),
        nc_mask=on_dev(mask),
        chain_nodes=on_dev(np.zeros(0, np.int32)),
        chain_starts=on_dev(np.zeros(0, bool)),
        chain_mask=on_dev(np.zeros(0, bool)),
    )
    with telemetry.span("verifier.sweep", batched=True,
                        sessions=n_sessions, regions=len(regions),
                        nodes=n_nodes, edges=n_edges):
        t0 = time.perf_counter()
        res = resilience.device_call(SWEEP_SITE, detect_cycles, g,
                                     deadline=deadline, device=dev)
        telemetry.add_phase("sweep_s", time.perf_counter() - t0)
    if not res.converged:
        return False, set()
    hits: set = set()
    if res.has_cycle:
        bounds = np.asarray(edge_bounds[1:])
        for eid in np.asarray(res.witness_edge_ids):
            hits.add(int(np.searchsorted(bounds, int(eid),
                                         side="right")))
    return True, hits


def batched_sweep(lives: List[Any],
                  deadline: Optional[Deadline] = None,
                  device: backend.DeviceLike = None
                  ) -> Dict[str, int]:
    """Sweep every dirty session in ``lives`` (service `_Live` objects)
    through one batched dispatch on `device` (the CUDA card unless the
    caller names the CPU).  Returns stats: sessions considered /
    committed clean / classified via their own sweep / rebuilt."""
    stats = {"dirty": 0, "clean": 0, "classified": 0, "rebuild": 0,
             "dispatched": 0}
    snaps: List[Tuple[Any, Dict[str, Any]]] = []
    for live in lives:
        with live.lock:
            if live.dead or live.state == "sealed":
                continue
            snap = region_snapshot(live.session)
        if snap is not None:
            snaps.append((live, snap))
    if not snaps:
        return stats
    stats["dirty"] = len(snaps)
    regions = [(i, live, s) for i, (live, s) in enumerate(snaps)
               if s["kind"] == "region"]
    conv = True
    hits: set = set()
    if regions:
        stats["dispatched"] = 1
        conv, hit_blocks = _dispatch([s for _, _, s in regions],
                                     deadline, len(snaps), device)
        hits = {regions[b][0] for b in hit_blocks if b < len(regions)}
    for i, (live, snap) in enumerate(snaps):
        with live.lock:
            if live.dead:
                continue
            sess = live.session
            if snap["kind"] == "rebuild":
                stats["rebuild"] += 1
                sess.sweep(deadline=deadline)
            elif snap["kind"] == "region" and (not conv or i in hits):
                # a witness passes through this block (or the batched
                # pass could not prove anything): the session's own
                # exact sweep classifies per spec — verdict equality
                # with the unbatched path holds bit for bit
                stats["classified"] += 1
                sess.sweep(deadline=deadline)
            elif sess._sweep_epoch != snap["stamp"] \
                    or len(sess._pending) < snap["k"] \
                    or sess._rebuild:
                # STALE: a per-session sweep (an HTTP verdict) ran
                # between our snapshot and this commit — the first k
                # pending edges are no longer the ones we proved
                # acyclic.  Re-sweep exactly; never mark post-snapshot
                # edges swept.
                stats["classified"] += 1
                sess.sweep(deadline=deadline)
            else:
                stats["clean"] += 1
                _commit(sess, snap["k"])
    return stats
