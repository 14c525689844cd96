"""Search control: abort flags, deadlines, budgets (the port's copy of
`jepsen_tpu/checkers/knossos/search.py`).

Equivalent of `knossos/search.clj` (SURVEY.md §2.4): a small handle the
long-running searches poll so a competition can abort the loser, a
deadline can bound wall time, and callers can read progress.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np


class Search:
    """Shared control block for one search run.

    `flag` is a (1,) int32 shared with native searches: ctypes calls
    release the GIL, so the C++ WGL polls this memory while another
    thread aborts — the loser of a competition stops within ~1k configs
    instead of running out its full budget.

    Aborts carry a *reason* ("aborted" for competition losers /
    caller cancels, "deadline-exceeded" for expired budgets) so the
    final result can attribute WHY the search stopped — the resilience
    contract that a bounded run returns `error: deadline-exceeded`
    rather than a bare unknown.  `deadline` may also be a cooperative
    `resilience.Deadline` object shared with the rest of a composed
    checker run (one budget over the whole analysis): the port's
    `resilience.Deadline`."""

    def __init__(self, *, deadline_s: Optional[float] = None,
                 deadline=None):
        self._abort = threading.Event()
        self.flag = np.zeros(1, dtype=np.int32)
        # `is not None`: deadline_s=0 means already expired, not "no
        # deadline"
        self.deadline = (time.monotonic() + deadline_s
                         if deadline_s is not None else None)
        self.deadline_obj = deadline  # resilience.Deadline, cooperative
        self.abort_reason: Optional[str] = None
        self._explored_lock = threading.Lock()
        self.explored = 0
        self.result: Optional[dict] = None

    def add_explored(self, n: int) -> None:
        """Thread-safe progress increment: concurrently racing legs all
        funnel into one parent counter, and a bare `explored += n` is a
        non-atomic read-modify-write that loses updates under the race."""
        with self._explored_lock:
            self.explored += n

    def abort(self, reason: str = "aborted") -> None:
        if self.abort_reason is None:
            self.abort_reason = reason
        self._abort.set()
        self.flag[0] = 1

    def aborted(self) -> bool:
        if self._abort.is_set():
            return True
        if self.deadline is not None and time.monotonic() > self.deadline:
            self.abort(DEADLINE_REASON)
            return True
        if self.deadline_obj is not None and self.deadline_obj.expired():
            self.abort(DEADLINE_REASON)
            return True
        return False

    def report(self, result: dict) -> dict:
        self.result = result
        return result


DEADLINE_REASON = "deadline-exceeded"


def stamp_abort(res: dict, ctl) -> dict:
    """Attribute an aborted search's cause in its result: a
    deadline-driven abort becomes ``error: deadline-exceeded`` (the
    canonical resilience verdict shape); other aborts keep their
    ``reason``.  No-op for definitive results or ctl-less calls."""
    if (ctl is not None and isinstance(res, dict)
            and res.get("valid?") == "unknown"
            and getattr(ctl, "abort_reason", None) == DEADLINE_REASON):
        res = dict(res, error=DEADLINE_REASON)
        res["explored"] = res.get("explored", ctl.explored)
    return res


class ChildSearch(Search):
    """A Search linked to a parent: aborting the child never touches the
    parent (so a competition can abort its losers while the caller's ctl
    stays reusable), while a parent abort — or the parent's deadline —
    propagates to the child at the child's next `aborted()` poll.  The
    child inherits the parent's deadline implicitly through that poll;
    its own `deadline_s` (if any) is additional.  Note the propagation
    is poll-driven: a leg that only watches the shared `flag` memory
    (the native C++ DFS) sees a parent abort once any python-side
    participant polls this child."""

    def __init__(self, parent: Optional[Search] = None, *,
                 deadline_s: Optional[float] = None, deadline=None):
        super().__init__(deadline_s=deadline_s, deadline=deadline)
        self._parent = parent

    def aborted(self) -> bool:
        p = self._parent
        if p is not None and p.aborted():
            # inherit the parent's reason: a deadline that fired on the
            # root must surface as deadline-exceeded from every leg
            self.abort(p.abort_reason or "aborted")
        return super().aborted()

    # `explored` forwards up the chain so a campaign polling ITS handle
    # still sees progress when the work runs under a derived child (the
    # base-class ctor's `explored = 0` lands in the local slot — the
    # parent is not attached yet — so attaching never resets the
    # parent's count).
    @property
    def explored(self) -> int:
        p = getattr(self, "_parent", None)
        return p.explored if p is not None else \
            getattr(self, "_explored_local", 0)

    @explored.setter
    def explored(self, v: int) -> None:
        p = getattr(self, "_parent", None)
        if p is not None:
            p.explored = v
        else:
            self._explored_local = v

    def add_explored(self, n: int) -> None:
        # delegate to the root so its lock serializes sibling legs
        p = getattr(self, "_parent", None)
        if p is not None:
            p.add_explored(n)
        else:
            super().add_explored(n)
