"""Queue workload: enqueue/dequeue with a final drain (the port's copy of
`jepsen_tpu/workloads/queue.py`).

Equivalent of the reference's queue workloads (SURVEY.md §2.6, built-in
`checker/queue` and `total-queue`): clients enqueue unique values and
dequeue concurrently; the final generator drains.  `total-queue` semantics:
every enqueued value should be dequeued exactly once (lost = enqueued-ok
never dequeued, duplicated = dequeued twice, phantom = dequeued but never
enqueued).  Both checkers run on `device` (the CUDA card unless the caller
names the CPU).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.queue.fifo import PackedQueueChecker
from ..generator import core as g


class _QueueGen:
    def __init__(self, *, dequeue_frac: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.counter = itertools.count()
        self.dequeue_frac = dequeue_frac
        self.rng = rng or random.Random()

    def __call__(self, test, ctx):
        if self.rng.random() < self.dequeue_frac:
            return {"f": "dequeue", "value": None}
        return {"f": "enqueue", "value": next(self.counter)}


def gen(**opts) -> Any:
    return _QueueGen(**opts)


def _is_empty_fail(event: dict) -> bool:
    """Did this completion signal queue-empty?  Only an explicit empty
    error counts — an aborted/transient failed dequeue must NOT end the
    drain (items would be falsely reported lost)."""
    return (event.get("type") == "fail" and event.get("f") == "dequeue"
            and str(event.get("error", "")).lower() in ("empty", "exhausted"))


class _Drain(g.Generator):
    """Dequeue until this thread observes empty.  With no producers left,
    first-empty implies drained."""

    def __init__(self, inner=None, done: bool = False):
        self.inner = inner if inner is not None \
            else g.lift(g.repeat({"f": "dequeue", "value": None}))
        self.done = done

    def op(self, test, ctx):
        if self.done:
            return None
        res = g.next_op(self.inner, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        return (op_, _Drain(gen2, False))

    def update(self, test, ctx, event):
        if _is_empty_fail(event):
            return _Drain(self.inner, True)
        return _Drain(g.gen_update(self.inner, test, ctx, event), self.done)


def drain(n: int = 10_000) -> Any:
    """Final drain: every thread dequeues until it sees empty (n is a
    runaway bound, not the expected drain size)."""
    return g.clients(g.each_thread(g.limit(n, _Drain())))


def workload(*, total: bool = True, fifo: bool = False,
             drain_ops: int = 10_000,
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    if total:
        checker: Any = PackedQueueChecker(fifo=fifo, device=device)
    else:
        checker = checker_api.QueueChecker(device=device)
    return {
        "generator": gen(rng=rng),
        "final-generator": drain(drain_ops),
        "checker": checker,
        "workload-kind": "queue",
    }
