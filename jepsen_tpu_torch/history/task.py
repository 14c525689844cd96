"""Dependency-DAG task scheduler on a fixed thread pool (the port's copy
of `jepsen_tpu/history/task.py`).

Equivalent of the reference's `jepsen/history/task.clj` (SURVEY.md §2.2):
tasks declare dependencies on other tasks; a task becomes runnable when
every dependency has finished, and receives their results as positional
arguments.  Cancellation cascades to dependents; a failed dependency
fails its dependents with the same exception.  This powers the Folder's
concurrent fold fusion (fold.py) the way task.clj powers fold.clj.

Host-side by design: scheduling is control flow, not compute — the
numeric work inside tasks is numpy or torch, which release the GIL.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Sequence

PENDING = "pending"      # waiting on deps
READY = "ready"          # queued on the pool
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


class Task:
    """Future-like handle with dependency metadata."""

    def __init__(self, fn: Callable, deps: Sequence["Task"], name: str):
        self.fn = fn
        self.deps = list(deps)
        self.name = name
        self.state = PENDING
        self.result_value: Any = None
        self.error: Optional[BaseException] = None
        self._dependents: list[Task] = []
        self._unmet = 0
        self._done = threading.Event()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"task {self.name!r} not done")
        if self.state == CANCELLED:
            raise CancelledError(self.name)
        if self.state == FAILED:
            raise self.error
        return self.result_value

    def done(self) -> bool:
        return self._done.is_set()

    def __repr__(self) -> str:
        return f"<Task {self.name!r} {self.state}>"


class CancelledError(Exception):
    pass


class TaskExecutor:
    """Fixed pool + DAG bookkeeping.  Use as a context manager or call
    shutdown()."""

    def __init__(self, max_workers: Optional[int] = None):
        self.pool = ThreadPoolExecutor(
            max_workers or min(8, (os.cpu_count() or 2)))
        self.lock = threading.Lock()

    # -- public API --------------------------------------------------------

    def submit(self, fn: Callable, *, deps: Sequence[Task] = (),
               name: str = "task") -> Task:
        """Schedule fn(*dep_results) after every dep finishes."""
        t = Task(fn, deps, name)
        with self.lock:
            unmet = 0
            for d in deps:
                if d.state in (DONE,):
                    continue
                if d.state in (FAILED, CANCELLED):
                    # fail fast: dependency already failed
                    self._finish(t, FAILED if d.state == FAILED else
                                 CANCELLED, error=d.error or
                                 CancelledError(d.name))
                    return t
                d._dependents.append(t)
                unmet += 1
            t._unmet = unmet
            if unmet == 0:
                self._enqueue(t)
        return t

    def cancel(self, t: Task) -> bool:
        """Cancel a task that hasn't started; cascades to dependents.
        Returns True if the task was cancelled."""
        with self.lock:
            if t.state in (PENDING, READY):
                self._finish(t, CANCELLED, error=CancelledError(t.name))
                return True
            return False

    def shutdown(self, wait: bool = True) -> None:
        self.pool.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- internals (lock held) ---------------------------------------------

    def _enqueue(self, t: Task) -> None:
        t.state = READY
        self.pool.submit(self._run, t)

    def _run(self, t: Task) -> None:
        with self.lock:
            if t.state != READY:
                return
            t.state = RUNNING
        try:
            args = [d.result_value for d in t.deps]
            out = t.fn(*args)
        except BaseException as e:  # noqa: BLE001 — must fail dependents
            with self.lock:
                self._finish(t, FAILED, error=e)
            return
        with self.lock:
            self._finish(t, DONE, value=out)

    def _finish(self, t: Task, state: str, *, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        if t.state in (DONE, FAILED, CANCELLED):
            return
        t.state = state
        t.result_value = value
        t.error = error
        t._done.set()
        deps_ok = state == DONE
        for child in t._dependents:
            if deps_ok:
                child._unmet -= 1
                if child._unmet == 0 and child.state == PENDING:
                    self._enqueue(child)
            else:
                # cascade failure/cancellation
                self._finish(child,
                             FAILED if state == FAILED else CANCELLED,
                             error=error or CancelledError(t.name))
        t._dependents.clear()
