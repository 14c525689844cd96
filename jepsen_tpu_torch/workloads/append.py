"""List-append workload — the Elle flagship (the port's copy of
`jepsen_tpu/workloads/append.py`).

Equivalent of the reference's `jepsen/src/jepsen/tests/cycle/append.clj` +
`elle.list-append/gen` (SURVEY.md §2.6): random transactions of
``("append", k, v)`` / ``("r", k, None)`` micro-ops over a rotating pool of
integer keys, with appends globally unique per key, checked by the
Elle list-append pipeline on `device` (the CUDA card unless the caller
names the CPU: `python -m jepsen_tpu_torch --cpu` passes ``"cpu"``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.elle import list_append, viz
from ..resilience import plan_for


class _TxnGen:
    """Stateful op factory (closed over by the fn-generator): rotates a
    window of active keys so per-key version chains stay bounded, and
    hands out unique append values per key — elle.list-append `gen`."""

    def __init__(self, *, key_count: int = 10, min_txn_length: int = 1,
                 max_txn_length: int = 4, max_writes_per_key: int = 32,
                 read_frac: float = 0.5, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.max_writes = max_writes_per_key
        self.read_frac = read_frac
        self.next_key = key_count
        self.active = list(range(key_count))
        self.writes: Dict[int, int] = {}

    def _mop(self):
        k = self.rng.choice(self.active)
        if self.rng.random() < self.read_frac:
            return ("r", k, None)
        v = self.writes.get(k, 0)
        self.writes[k] = v + 1
        if self.writes[k] >= self.max_writes:
            # retire the key, introduce a fresh one (elle's key rotation)
            self.active[self.active.index(k)] = self.next_key
            self.next_key += 1
        return ("append", k, v)

    def __call__(self, test, ctx):
        n = self.rng.randint(self.min_len, self.max_len)
        return {"f": "txn", "value": [self._mop() for _ in range(n)]}


def gen(**opts) -> Any:
    """An infinite list-append txn generator (lift-able op factory)."""
    return _TxnGen(**opts)


class AppendChecker(checker_api.Checker):
    """Adapts `elle.list_append.check` to the Checker protocol; the check
    runs on `device` (the CUDA card unless it names another)."""

    def __init__(self, consistency_models=("serializable",), anomalies=(),
                 device: DeviceLike = None):
        self.models = tuple(consistency_models)
        self.anomalies = tuple(anomalies)
        self.device = device

    def check(self, test, history, opts=None):
        opts = opts or {}
        res = list_append.check(
            history,
            consistency_models=opts.get("consistency-models", self.models),
            anomalies=opts.get("anomalies", self.anomalies),
            # resilience plumbing: the shared checker deadline placed in
            # opts by check_safe, the run's fault plan, and an optional
            # retry-policy override from the test map
            deadline=opts.get("deadline"),
            policy=(test or {}).get("retry-policy"),
            plan=plan_for(test), device=self.device)
        if test and test.get("store-dir") is not None:
            viz.viz_for_test(res, test, history)
        return res

    def name(self):
        return "list-append"


def workload(*, key_count: int = 10, min_txn_length: int = 1,
             max_txn_length: int = 4, max_writes_per_key: int = 32,
             consistency_models=("serializable",), anomalies=(),
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    """The workload map: {generator, checker} (+ client supplied by the
    db-specific suite, as in the reference)."""
    return {
        "generator": gen(key_count=key_count, min_txn_length=min_txn_length,
                         max_txn_length=max_txn_length,
                         max_writes_per_key=max_writes_per_key, rng=rng),
        "checker": AppendChecker(consistency_models, anomalies,
                                 device=device),
    }
