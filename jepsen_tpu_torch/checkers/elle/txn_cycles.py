"""Rendering of reported dependency cycles (the port's copy of
`_render_cycle` from `jepsen_tpu/checkers/elle/txn_cycles.py`).

The list-append checker renders the cycles it classifies through
`_render_cycle`.  The module's `cycle_anomalies` (cycle detection over
host-built edges) comes with the rw-register slice.
"""

from __future__ import annotations

from typing import List

from jepsen_tpu_torch.checkers.elle.graph import REL_NAMES


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
