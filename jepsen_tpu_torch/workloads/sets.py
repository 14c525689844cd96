"""Set workload: add elements, then read them back (the port's copy of
`jepsen_tpu/workloads/sets.py`).

Equivalent of the reference's set workloads (SURVEY.md §2.6, built-in
`checker/set` and `set-full`): clients add unique integers; a final read
(or interleaved reads, for set-full's stale-window analysis) returns the
set.  Lost adds ⇒ invalid.  Both checkers are host scans.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Optional

from ..checkers import api as checker_api
from ..generator import core as g


class _AddGen:
    def __init__(self):
        self.counter = itertools.count()

    def __call__(self, test, ctx):
        return {"f": "add", "value": next(self.counter)}


def gen(*, reads: bool = False, read_frac: float = 0.1,
        rng: Optional[random.Random] = None) -> Any:
    """Adds of unique ints; with `reads`, interleaved set reads (the
    set-full shape)."""
    adds = _AddGen()
    if not reads:
        return adds
    rng = rng or random.Random()

    def mixed(test, ctx):
        if rng.random() < read_frac:
            return {"f": "read", "value": None}
        return adds(test, ctx)

    return mixed


def final_read() -> Any:
    """The final-generator: one read per thread once clients go quiet
    (reference :final-generator with until-ok semantics)."""
    return g.clients(g.each_thread(g.until_ok({"f": "read", "value": None})))


def workload(*, full: bool = False,
             rng: Optional[random.Random] = None) -> dict:
    """`full=False`: add-then-final-read with `checker/set`.
    `full=True`: interleaved reads with `set-full` stale-window analysis."""
    return {
        "generator": gen(reads=full, rng=rng),
        "final-generator": final_read(),
        "checker": (checker_api.SetFullChecker() if full
                    else checker_api.SetChecker()),
        "workload-kind": "set",
    }
