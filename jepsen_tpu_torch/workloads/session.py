"""Session-guarantee workload (the port's copy of
`jepsen_tpu/workloads/session.py`).

Register traffic shaped so the per-key version orders chain exactly
(every write is a read-modify-write), checked by the vectorized
session-guarantee checker (`checkers/invariants/session.py`):
monotonic reads / monotonic writes / read-your-writes /
writes-follow-reads as segmented array passes over the packed history
on `device` (the CUDA card unless the caller names the CPU; the masks'
forward fills are the LOCF kernel's), DAG-walker fallback on branched
histories.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.elle.sessions import GUARANTEES
from ..checkers.invariants import session as inv_session


class _SessionGen:
    """Per-key rmw chains + plain reads (the causal workload's shape,
    biased toward rmw so chains grow)."""

    def __init__(self, *, key_count: int = 4, rmw_frac: float = 0.6,
                 rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.key_count = key_count
        self.rmw_frac = rmw_frac
        self.next_val = 0

    def __call__(self, test, ctx):
        k = self.rng.randrange(self.key_count)
        if self.rng.random() < self.rmw_frac:
            v = self.next_val
            self.next_val += 1
            return {"f": "txn", "value": [("r", k, None), ("w", k, v)]}
        return {"f": "txn", "value": [("r", k, None)]}


def gen(**opts) -> Any:
    return _SessionGen(**opts)


class SessionChecker(checker_api.Checker):
    def __init__(self, guarantees=None, *, device: DeviceLike = None):
        self.guarantees = guarantees
        self.device = device

    def name(self) -> str:
        return "session"

    def check(self, test, history, opts=None):
        return inv_session.check(
            history, guarantees=self.guarantees or GUARANTEES,
            deadline=(opts or {}).get("deadline"), device=self.device)


def workload(*, key_count: int = 4, rmw_frac: float = 0.6,
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    return {
        "generator": gen(key_count=key_count, rmw_frac=rmw_frac, rng=rng),
        "checker": SessionChecker(device=device),
        "workload-kind": "session",
    }
