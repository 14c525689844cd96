"""In-process simulated queue (the port's copy of the queue part of
`jepsen_tpu/workloads/mem.py`).

The reference tests `core/run!` without SSH via noop dbs and docker
(SURVEY.md §4); the JAX module is the equivalent pure-Python strategy: a
shared in-memory store with a `Client` implementation covering the standard
workload op shapes, plus fault knobs so checker tests can exercise :info
paths and adversarial queues deterministically.

Only what a queue corpus needs is ported: `MemStore`'s queue and lock, and
`MemClient`'s ``enqueue`` / ``dequeue`` with the knobs `crash_p`,
`fail_p`, `dup_enqueue_p`, `lose_enqueue_p` and `reorder_dequeue_p`.  With
the same seed and knobs it writes the same history as the JAX client.  The
register, txn, set and bank shapes, latency, clock skew and membership
wait until a ported caller needs them; the telemetry counter of each
injection is left out.
"""

from __future__ import annotations

import copy
import random
import threading
from typing import Any, List, Optional

from jepsen_tpu_torch.client import Client


class MemStore:
    """The 'cluster': a lock-protected shared queue."""

    def __init__(self):
        self.lock = threading.Lock()
        self.queue: List[Any] = []


class MemClient(Client):
    """Queue client over a MemStore.

    `crash_p` completes ops as :info with that probability *after*
    applying them (indeterminate but actually-applied — the hard case
    checkers must handle); `fail_p` completes as :fail *without* applying
    (clean abort).  Queue adversarial shapes: `dup_enqueue_p`, the
    duplicate-request retry (applied twice, acked once -> queue-phantom);
    `lose_enqueue_p`, ack-without-apply (-> queue-lost);
    `reorder_dequeue_p`, a tail pop (-> queue-fifo-violation)."""

    def __init__(self, store: Optional[MemStore] = None, *,
                 crash_p: float = 0.0, fail_p: float = 0.0,
                 rng: Optional[random.Random] = None,
                 dup_enqueue_p: float = 0.0, lose_enqueue_p: float = 0.0,
                 reorder_dequeue_p: float = 0.0):
        self.store = store or MemStore()
        self.crash_p = crash_p
        self.fail_p = fail_p
        self.rng = rng or random.Random(0)
        self.dup_enqueue_p = dup_enqueue_p
        self.lose_enqueue_p = lose_enqueue_p
        self.reorder_dequeue_p = reorder_dequeue_p

    def open(self, test, node):
        # connectionless — every worker's handle shares the store
        return copy.copy(self)

    def invoke(self, test, op):
        if self.fail_p and self.rng.random() < self.fail_p:
            return dict(op, type="fail", error="simulated-abort")
        s = self.store
        f = op["f"]
        v = op.get("value")
        with s.lock:
            if f == "enqueue":
                # lose: acked, never applied
                if not (self.lose_enqueue_p and
                        self.rng.random() < self.lose_enqueue_p):
                    s.queue.append(v)
                    if self.dup_enqueue_p and \
                            self.rng.random() < self.dup_enqueue_p:
                        s.queue.append(v)       # retry applied twice
                out = dict(op, type="ok")
            elif f == "dequeue":
                if s.queue:
                    i = 0
                    if len(s.queue) >= 2 and self.reorder_dequeue_p and \
                            self.rng.random() < self.reorder_dequeue_p:
                        i = -1                  # tail pop: FIFO broken
                    out = dict(op, type="ok", value=s.queue.pop(i))
                else:
                    out = dict(op, type="fail", error="empty")
            else:
                raise ValueError(f"unknown op f {f!r} (the port's MemClient "
                                 f"takes enqueue and dequeue)")
        if out["type"] == "ok" and self.crash_p \
                and self.rng.random() < self.crash_p:
            return dict(op, type="info", error="simulated-crash")
        return out
