"""Write-skew workload (the port's copy of
`jepsen_tpu/workloads/write_skew.py`).

The classic snapshot-isolation counterexample as a generator/checker
bundle: keys come in pairs (a "constraint group"); every update txn
reads BOTH keys of its pair and then writes one of them (a
read-then-write, so version inference chains exactly).  Two concurrent
txns that each read the pre-state and write different keys of the same
pair form mutual anti-dependencies — write skew — which the predicate
checker (`checkers/invariants/predicate.py`) finds as a vectorized
mutual-rw pass plus a G2-item cycle with per-edge evidence.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.invariants import predicate


class _WriteSkewGen:
    """Txns over key pairs (2g, 2g+1): read both, write one (unique
    values); plus plain pair reads."""

    def __init__(self, *, pairs: int = 2, read_frac: float = 0.3,
                 rng: Optional[random.Random] = None):
        self.pairs = pairs
        self.read_frac = read_frac
        self.rng = rng or random.Random()
        self.next_val = 0

    def __call__(self, test, ctx):
        g = self.rng.randrange(self.pairs)
        k1, k2 = 2 * g, 2 * g + 1
        if self.rng.random() < self.read_frac:
            return {"f": "txn", "value": [("r", k1, None), ("r", k2, None)]}
        w = self.rng.choice((k1, k2))
        v = self.next_val
        self.next_val += 1
        return {"f": "txn",
                "value": [("r", k1, None), ("r", k2, None), ("w", w, v)]}


def gen(**opts) -> Any:
    return _WriteSkewGen(**opts)


class WriteSkewChecker(checker_api.Checker):
    """Predicate checker pinned on the write-skew anomaly family, on
    `device` (the CUDA card unless it names another)."""

    def __init__(self, *, device: DeviceLike = None):
        self.device = device

    def name(self) -> str:
        return "write-skew"

    def check(self, test, history, opts=None):
        return predicate.check(history,
                               deadline=(opts or {}).get("deadline"),
                               device=self.device)


def workload(*, pairs: int = 2, read_frac: float = 0.3,
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    return {
        "generator": gen(pairs=pairs, read_frac=read_frac, rng=rng),
        "checker": WriteSkewChecker(device=device),
        "workload-kind": "write-skew",
    }
