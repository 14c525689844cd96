"""Vectorized consistency-model checkers (the invariants family; the
port's copy of `jepsen_tpu/checkers/invariants/__init__.py`).

The breadth layer over the elle core (ROADMAP item 5): where
`checkers/elle` judges list-append and rw-register dependency graphs,
this package judges the rest of the Jepsen scenario surface the paper
names — bank transfers (total-balance + snapshot reads), predicate
workloads (long fork / write skew), and session guarantees — each as a
vectorized pass over one shared packed-history core (:mod:`.packed`),
with a host numpy oracle twin and a device path on the CUDA card (the
`txn_cycles` rank sweep, torch reductions and products, and the LOCF
kernel for the session masks) behind `resilience.with_fallback` guards.

Registry: :data:`MODELS` maps model name -> metadata the flywheel
consumes (workload name, device classification, anomaly vocabulary) so
campaign specs, `DeviceSlots` classification, shrink probe twins, and
the web witness renderers agree on one table.
"""

from __future__ import annotations

from jepsen_tpu_torch.checkers.invariants import (
    bank,
    packed,
    predicate,
    session,
)

__all__ = ["bank", "packed", "predicate", "session", "MODELS"]

#: model name -> flywheel metadata.  `device`: the checker dispatches to
#: the device (in the JAX package: DeviceSlots serialization + shrink
#: probe classification);
#: `anomalies`: the vocabulary its witnesses report (web renderers key
#: model-specific evidence off these).
MODELS = {
    "bank": {
        "workload": "bank",
        "device": True,
        "anomalies": ("bank-wrong-total", "bank-negative-balance"),
    },
    "long-fork": {
        "workload": "long-fork",
        "device": True,
        "anomalies": ("long-fork", "G2-item", "G-nonadjacent", "G-single"),
    },
    "write-skew": {
        "workload": "write-skew",
        "device": True,
        "anomalies": ("write-skew", "G2-item", "G-nonadjacent", "G-single"),
    },
    "session": {
        "workload": "session",
        "device": True,
        "anomalies": tuple(
            g + "-violation"
            for g in ("monotonic-reads", "monotonic-writes",
                      "read-your-writes", "writes-follow-reads")),
    },
}
