"""Generator context (the port's copy of `jepsen_tpu/generator/context.py`).

Equivalent of the reference's `jepsen/generator/context.clj` (SURVEY.md
§2.1): an immutable context tracking the logical test time, the set of free
threads, and the thread<->process translation table.  Client threads are
ints 0..concurrency-1; the nemesis thread is the string "nemesis".  A
client process starts equal to its thread id and, when it crashes (an
:info completion), is replaced by process + concurrency — so processes are
unique forever while threads are a fixed pool, exactly the reference's
scheme.

Contexts are persistent values: every mutator returns a new Context.  The
reference uses bifurcan sets for O(log n) updates; at Python workload scale
(10^2 threads, 10^5 ops host-side) frozenset/dict copies are fine, and the
device-side checkers never see contexts at all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, FrozenSet, Optional, Tuple

NEMESIS_THREAD = "nemesis"


@dataclasses.dataclass(frozen=True)
class Context:
    time: int                        # logical test time, nanoseconds
    free_threads: FrozenSet[Any]     # threads with no op in flight
    workers: Tuple[Tuple[Any, Any], ...]  # sorted (thread, process) pairs

    # -- construction ------------------------------------------------------

    @staticmethod
    def make(concurrency: int, *, with_nemesis: bool = True) -> "Context":
        threads = list(range(concurrency)) + (
            [NEMESIS_THREAD] if with_nemesis else [])
        return Context(
            time=0,
            free_threads=frozenset(threads),
            workers=tuple((t, t) for t in threads),
        )

    # -- lookups -----------------------------------------------------------

    def _worker_map(self) -> dict:
        return dict(self.workers)

    def all_threads(self) -> list:
        return [t for t, _ in self.workers]

    def all_processes(self) -> list:
        return [p for _, p in self.workers]

    def process_for_thread(self, thread) -> Any:
        return self._worker_map()[thread]

    def thread_for_process(self, process) -> Any:
        for t, p in self.workers:
            if p == process:
                return t
        raise KeyError(process)

    def free_processes(self) -> list:
        wm = self._worker_map()
        return [wm[t] for t in self._sorted_free()]

    def _sorted_free(self) -> list:
        # ints first in order, then nemesis — deterministic dispatch order
        ints = sorted(t for t in self.free_threads if isinstance(t, int))
        other = [t for t in self.free_threads if not isinstance(t, int)]
        return ints + other

    def some_free_process(self) -> Optional[Any]:
        free = self.free_processes()
        return free[0] if free else None

    def free_count(self) -> int:
        return len(self.free_threads)

    # -- transitions -------------------------------------------------------

    def with_time(self, t: int) -> "Context":
        return dataclasses.replace(self, time=t)

    def busy_thread(self, thread) -> "Context":
        return dataclasses.replace(
            self, free_threads=self.free_threads - {thread})

    def free_thread(self, thread) -> "Context":
        return dataclasses.replace(
            self, free_threads=self.free_threads | {thread})

    def with_next_process(self, thread, concurrency: int) -> "Context":
        """Replace thread's crashed process with a fresh one (p + n)."""
        workers = tuple(
            (t, p + concurrency if t == thread and isinstance(p, int) else p)
            for t, p in self.workers)
        return dataclasses.replace(self, workers=workers)

    # -- restricted views (reference: thread filters with precompiled
    # translation; used by on-threads / clients / nemesis / reserve) -------

    def restrict(self, thread_pred: Callable[[Any], bool]) -> "Context":
        """A view containing only threads satisfying the predicate."""
        workers = tuple((t, p) for t, p in self.workers if thread_pred(t))
        keep = {t for t, _ in workers}
        return Context(
            time=self.time,
            free_threads=frozenset(t for t in self.free_threads if t in keep),
            workers=workers,
        )


def context(test: dict) -> Context:
    """Build the initial context for a test map (reference
    `generator.context/context`)."""
    return Context.make(int(test.get("concurrency", 1)))
