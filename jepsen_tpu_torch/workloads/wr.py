"""RW-register workload (the port's copy of `jepsen_tpu/workloads/wr.py`).

Equivalent of the reference's `jepsen/src/jepsen/tests/cycle/wr.clj` +
`elle.rw-register` (SURVEY.md §2.6): transactions of ``("w", k, v)`` /
``("r", k, None)`` with globally unique writes per key, checked by the
rw-register pipeline on `device` (the CUDA card unless the caller names
the CPU: `python -m jepsen_tpu_torch --cpu` passes ``"cpu"``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.elle import rw_register, viz


class _TxnGen:
    def __init__(self, *, key_count: int = 8, min_txn_length: int = 1,
                 max_txn_length: int = 4, read_frac: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.read_frac = read_frac
        self.next_val: Dict[int, int] = {}

    def _mop(self):
        k = self.rng.randrange(self.key_count)
        if self.rng.random() < self.read_frac:
            return ("r", k, None)
        v = self.next_val.get(k, 0)
        self.next_val[k] = v + 1  # unique writes — rw-register's invariant
        return ("w", k, v)

    def __call__(self, test, ctx):
        n = self.rng.randint(self.min_len, self.max_len)
        return {"f": "txn", "value": [self._mop() for _ in range(n)]}


def gen(**opts) -> Any:
    return _TxnGen(**opts)


class WrChecker(checker_api.Checker):
    """Adapts `elle.rw_register.check` to the Checker protocol; the check
    runs on `device` (the CUDA card unless it names another)."""

    def __init__(self, consistency_models=("snapshot-isolation",),
                 anomalies=(), device: DeviceLike = None):
        self.models = tuple(consistency_models)
        self.anomalies = tuple(anomalies)
        self.device = device

    def check(self, test, history, opts=None):
        opts = opts or {}
        res = rw_register.check(
            history,
            consistency_models=opts.get("consistency-models", self.models),
            anomalies=opts.get("anomalies", self.anomalies),
            device=self.device)
        if test and test.get("store-dir") is not None:
            viz.viz_for_test(res, test, history)
        return res

    def name(self):
        # the canonical checker name (like AppendChecker's
        # "list-append"): span labels, error attribution, and the
        # shrink probe pool's device classification all key on it
        return "rw-register"


def workload(*, key_count: int = 8, min_txn_length: int = 1,
             max_txn_length: int = 4,
             consistency_models=("snapshot-isolation",), anomalies=(),
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    return {
        "generator": gen(key_count=key_count, min_txn_length=min_txn_length,
                         max_txn_length=max_txn_length, rng=rng),
        "checker": WrChecker(consistency_models, anomalies, device=device),
    }
