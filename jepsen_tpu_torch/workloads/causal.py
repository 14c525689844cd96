"""Causal-consistency workload (the port's copy of
`jepsen_tpu/workloads/causal.py`).

Equivalent of the reference's `jepsen/tests/causal.clj` (SURVEY.md §2.6,
(L)): register operations whose checker verifies *causal* consistency —
session guarantees (monotonic reads, read-your-writes) plus causal
write ordering — rather than serializability.

Operations are read-modify-write transactions
(``[("r", k, None), ("w", k, v)]``) and plain reads, so causality is
visible to dependency inference (an rmw's read pins its write's
predecessor version — `elle/rw_register.clj`'s read-then-write source).
A session violation (e.g. a process reading version 2 then version 1)
then shows up as a cycle over {ww, wr, process} edges, optionally with
anti-dependency edges for monotonic-read breaks, and is checked by the
same rw-register pipeline as the wr workload, on `device` (the CUDA
card unless the caller names the CPU):

- causal write cycles  -> G0-process / G1c-process (causal-cerone's
  prohibited anomalies in the consistency lattice)
- monotonic-read / read-your-writes breaks -> G-single-process
  (explicitly requested — session anomalies are causal violations even
  though the lattice maps them to snapshot-family models)
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.elle import rw_register, viz

#: anomalies that break causal consistency: causal write cycles per the
#: lattice, plus single-anti-dependency session cycles (monotonic reads)
CAUSAL_ANOMALIES = ("G-single-process",)


class _CausalGen:
    def __init__(self, *, key_count: int = 4, rmw_frac: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.key_count = key_count
        self.rmw_frac = rmw_frac
        self.next_val: Dict[int, int] = {}

    def __call__(self, test, ctx):
        k = self.rng.randrange(self.key_count)
        if self.rng.random() < self.rmw_frac:
            v = self.next_val.get(k, 0)
            self.next_val[k] = v + 1
            value = [("r", k, None), ("w", k, v)]
        else:
            value = [("r", k, None)]
        return {"f": "txn", "value": value}


def gen(**opts) -> Any:
    return _CausalGen(**opts)


class CausalChecker(checker_api.Checker):
    """Causal-consistency verdict over an rw-register-shaped history."""

    def __init__(self, *, device: DeviceLike = None):
        self.device = device

    def check(self, test, history, opts=None):
        res = rw_register.check(
            history, consistency_models=("causal-cerone",),
            anomalies=CAUSAL_ANOMALIES, device=self.device)
        # session anomalies invalidate causal even when the lattice
        # boundary alone wouldn't reject causal-cerone
        session_bad = [a for a in res["anomaly-types"]
                       if a in CAUSAL_ANOMALIES]
        if session_bad and res["valid?"] is True:
            res["valid?"] = False
            res.setdefault("not", []).append("causal-cerone")
        if res["valid?"] is False:
            viz.viz_for_test(res, test, history=history)
        return res


def checker(*, device: DeviceLike = None) -> checker_api.Checker:
    return CausalChecker(device=device)


def workload(*, device: DeviceLike = None, **opts) -> Dict[str, Any]:
    """{generator, checker} bundle, reference workload-map shape."""
    return {"generator": gen(**opts), "checker": checker(device=device)}
