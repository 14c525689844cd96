"""Cycle anomalies over host-built txn dependency edges (the port's copy
of `jepsen_tpu/checkers/elle/txn_cycles.py`).

Used by checkers whose edge inference runs on the host (rw-register) but
whose cycle *detection* rides the device rank sweep
(`ops.cycle_sweep.detect_cycles`) — the same split `list_append` uses with
device-built edges.  The list-append checker also renders the cycles it
classifies through `_render_cycle`.

The fallback differs from the JAX package's.  There, any error of the
device sweep, and a sweep that does not converge, falls back to host
Tarjan.  Here an error of `detect_cycles` propagates, and a sweep that
does not converge raises `list_append.SweepNotConverged`: only a sweep
that converges with no witness region takes the Tarjan path, exactly as
in JAX.  `use_device=False` keeps its JAX meaning: Tarjan only, no
tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.elle.graph import (
    REL_NAMES,
    CycleSpec,
    EdgeList,
    find_cycle,
    nontrivial_sccs,
)
from jepsen_tpu_torch.checkers.elle.specs import (
    CYCLE_ANOMALY_SPECS,
    SPEC_ORDER,
)


def cycle_anomalies(edges: EdgeList, n_nodes: int, rank: np.ndarray,
                    want: set, use_device: bool = True,
                    max_reported: int = 4, explainer=None,
                    n_txns: int = None, orig_index: np.ndarray = None,
                    device: backend.DeviceLike = None
                    ) -> Dict[str, List[dict]]:
    """Find cycle anomalies among `want` specs over the given edges.

    rank: per-node order where most edges go forward (completion order);
    used by the device sweep, which runs on `device` (the CUDA card unless
    the caller names the CPU).  Returns {anomaly: [witness dicts]}.

    `explainer(src, rel_name, dst) -> dict` (see `explain.py`) adds
    per-edge justification fields to each reported cycle edge — the
    reference's Explainer protocol.  When `n_txns` is given, nodes >=
    n_txns (realtime barrier nodes) are collapsed out of reported
    cycles; `orig_index` maps internal txn ids to history indices.
    """
    specs = [(name, CYCLE_ANOMALY_SPECS[name]) for name in SPEC_ORDER
             if name in want]
    projections: Dict[frozenset, List[Tuple[str, CycleSpec]]] = {}
    for name, spec in specs:
        projections.setdefault(spec.rels, []).append((name, spec))

    found: Dict[str, List[dict]] = {}
    for rels, group in projections.items():
        proj = edges.project(rels)
        if not len(proj):
            continue
        regions = _cycle_regions(proj, n_nodes, rank, use_device, device)
        if regions is None:
            continue
        for name, spec in group:
            for region in regions[:max_reported * 4]:
                hit = find_cycle(region, proj, spec)
                if hit is not None:
                    found.setdefault(name, []).append(
                        {"cycle": _render_cycle(hit, explainer, n_txns,
                                                orig_index)})
                    break
    return found


def _render_cycle(hit, explainer, n_txns, orig_index) -> List[dict]:
    """Emit reported edges: collapse barrier hops (nodes >= n_txns) into
    single realtime edges, map ids to history indices, and attach the
    Explainer's justification per edge."""
    if n_txns is None:
        return [{"src": int(s), "rel": REL_NAMES[r], "dst": int(d)}
                for (s, r, d) in hit]
    out = []
    pend_src = None
    k = next((i for i, (s, _, _) in enumerate(hit) if s < n_txns), 0)
    hit = hit[k:] + hit[:k]
    for (s, r, d) in hit:
        if d >= n_txns:
            if s < n_txns:
                pend_src = s
            continue
        src = s if s < n_txns else pend_src
        rel_name = REL_NAMES[r]
        edge = {"src": int(orig_index[src]) if orig_index is not None and
                src is not None and src < len(orig_index) else src,
                "rel": rel_name,
                "dst": int(orig_index[d]) if orig_index is not None and
                d < len(orig_index) else int(d)}
        if explainer is not None and src is not None:
            edge.update(explainer(int(src), rel_name, int(d)))
        out.append(edge)
    return out


def _cycle_regions(proj: EdgeList, n_nodes: int, rank: np.ndarray,
                   use_device: bool, device: backend.DeviceLike = None):
    """Node regions containing cycles, or None if the projection is
    acyclic.  Device path: rank sweep on `device` -> witness backward
    edges -> local BFS regions.  Host path (`use_device=False`, or a
    converged sweep whose witnesses give no region): Tarjan SCCs.  Every
    error of the device path is raised."""
    if use_device:
        from jepsen_tpu_torch.checkers.elle.list_append import (
            SweepNotConverged,
            _witness_regions,
        )
        from jepsen_tpu_torch.ops.cycle_sweep import (
            SweepGraph,
            detect_cycles,
            unconverged_reason,
        )

        dev = backend.resolve(device)
        src = torch.from_numpy(np.ascontiguousarray(proj.src, np.int32))
        dst = torch.from_numpy(np.ascontiguousarray(proj.dst, np.int32))
        g = SweepGraph(
            n_nodes=n_nodes,
            rank=torch.from_numpy(np.ascontiguousarray(rank, np.int32)
                                  ).to(dev),
            nc_src=src.to(dev), nc_dst=dst.to(dev),
            nc_mask=torch.ones(len(proj.src), dtype=torch.bool, device=dev),
            chain_nodes=torch.zeros(0, dtype=torch.int32, device=dev),
            chain_starts=torch.zeros(0, dtype=torch.bool, device=dev),
            chain_mask=torch.zeros(0, dtype=torch.bool, device=dev))
        res = detect_cycles(g, device=dev)
        if not res.converged:
            raise SweepNotConverged(
                f"cycle sweep over {len(proj.src)} host-built edges did not "
                f"converge ({unconverged_reason(res)})")
        if not res.has_cycle:
            return None
        regions = _witness_regions(
            proj, proj.src, proj.dst, res.witness_edge_ids, n_nodes)
        if regions:
            return regions
    sccs = nontrivial_sccs(n_nodes, proj.src, proj.dst)
    return sccs if sccs else None
