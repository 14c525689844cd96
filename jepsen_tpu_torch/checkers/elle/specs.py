"""Cycle-anomaly specs — the `elle.txn/cycle-anomaly-specs` equivalent
(the port's copy of `jepsen_tpu/checkers/elle/specs.py`).

Each spec names a cycle-shaped anomaly, the dependency rels whose projection
to search, and the constraint on rw (anti-dependency) edges in the cycle
(SURVEY.md §2.3 cycle taxonomy engine).
"""

from __future__ import annotations

from typing import Dict

from jepsen_tpu_torch.checkers.elle.graph import (
    REL_PROCESS,
    REL_REALTIME,
    REL_RW,
    REL_WR,
    REL_WW,
    CycleSpec,
)

_BASE = {REL_WW, REL_WR, REL_RW}

CYCLE_ANOMALY_SPECS: Dict[str, CycleSpec] = {
    # write cycles
    "G0": CycleSpec({REL_WW}, "any"),
    "G0-process": CycleSpec({REL_WW, REL_PROCESS}, "any"),
    "G0-realtime": CycleSpec({REL_WW, REL_REALTIME}, "any"),
    # circular information flow
    "G1c": CycleSpec({REL_WW, REL_WR}, "any"),
    "G1c-process": CycleSpec({REL_WW, REL_WR, REL_PROCESS}, "any"),
    "G1c-realtime": CycleSpec({REL_WW, REL_WR, REL_REALTIME}, "any"),
    # single anti-dependency cycles
    "G-single": CycleSpec(_BASE, "single"),
    "G-single-process": CycleSpec(_BASE | {REL_PROCESS}, "single"),
    "G-single-realtime": CycleSpec(_BASE | {REL_REALTIME}, "single"),
    # non-adjacent anti-dependency cycles
    "G-nonadjacent": CycleSpec(_BASE, "multi-nonadj"),
    "G-nonadjacent-process": CycleSpec(_BASE | {REL_PROCESS}, "multi-nonadj"),
    "G-nonadjacent-realtime": CycleSpec(_BASE | {REL_REALTIME}, "multi-nonadj"),
    # item anti-dependency cycles
    "G2-item": CycleSpec(_BASE, "some"),
    "G2-item-process": CycleSpec(_BASE | {REL_PROCESS}, "some"),
    "G2-item-realtime": CycleSpec(_BASE | {REL_REALTIME}, "some"),
}

#: the one anomaly family whose search is a budgeted simple-cycle DFS
#: ("never a false positive, may give up"): differential comparisons may
#: see a legitimate device-vs-oracle asymmetry here on dense graphs
NONADJACENT_FAMILY = frozenset({
    "G-nonadjacent", "G-nonadjacent-process", "G-nonadjacent-realtime"})

# Search order: report the strongest (most specific / weakest-model-violating)
# anomalies first, as the reference does.
SPEC_ORDER = [
    "G0", "G0-process", "G0-realtime",
    "G1c", "G1c-process", "G1c-realtime",
    "G-single", "G-single-process", "G-single-realtime",
    "G-nonadjacent", "G-nonadjacent-process", "G-nonadjacent-realtime",
    "G2-item", "G2-item-process", "G2-item-realtime",
]
