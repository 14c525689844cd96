"""Long-fork workload (the port's copy of
`jepsen_tpu/workloads/long_fork.py`).

Equivalent of the reference's `jepsen/src/jepsen/tests/long_fork.clj`
(SURVEY.md §2.6): writers insert distinct values into distinct keys (one
write per txn); readers read a whole key group in one txn.  Under snapshot
isolation all reads must observe the writes in a single order; a **long
fork** is two reads that order two writes oppositely:

    read A sees w1 but not w2;  read B sees w2 but not w1.
"""

from __future__ import annotations

import random
from typing import Any, List, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.invariants import predicate


class _LongForkGen:
    """Writes cycle through key groups; each key is written at most once
    (value = a global counter), reads cover one whole group."""

    def __init__(self, *, group_size: int = 3, read_frac: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.n = group_size
        self.read_frac = read_frac
        self.rng = rng or random.Random()
        self.next_write = 0

    def _group_of(self, k: int) -> List[int]:
        g = k // self.n
        return list(range(g * self.n, (g + 1) * self.n))

    def __call__(self, test, ctx):
        if self.rng.random() < self.read_frac and self.next_write > 0:
            k = self.rng.randrange(self.next_write)
            return {"f": "txn",
                    "value": [("r", k2, None) for k2 in self._group_of(k)]}
        k = self.next_write
        self.next_write += 1
        return {"f": "txn", "value": [("w", k, k)]}


def gen(**opts) -> Any:
    return _LongForkGen(**opts)


class LongForkChecker(checker_api.Checker):
    """Finds long-fork read pairs (reference `long-fork/checker`),
    delegated to the vectorized predicate checker
    (`checkers/invariants/predicate.py`): group reads become boolean
    observed/absent matrices and fork pairs fall out of a handful of
    matrix reductions on `device` (the CUDA card unless it names
    another), then the elle graph machinery confirms each fork as a
    G-nonadjacent / G2-item cycle with per-edge evidence."""

    def __init__(self, *, device: DeviceLike = None):
        self.device = device

    def name(self) -> str:
        return "long-fork"

    def check(self, test, history, opts=None):
        res = predicate.check(history,
                              deadline=(opts or {}).get("deadline"),
                              device=self.device)
        if res.get("valid?") != "unknown" and not res.get("read-count"):
            return {"valid?": "unknown", "read-count": 0}
        # legacy keys the workload tests / perf plots consume
        res["long-forks"] = [
            {"reads": e["reads"], "keys": e["keys"]}
            for e in res.get("anomalies", {}).get("long-fork", ())]
        return res


def workload(*, group_size: int = 3,
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    return {
        "generator": gen(group_size=group_size, rng=rng),
        "checker": LongForkChecker(device=device),
        "workload-kind": "long-fork",
    }
