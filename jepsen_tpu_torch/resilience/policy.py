"""Retry policies and cooperative deadlines (the port's copy).

Counterpart of `jepsen_tpu/resilience/policy.py`:

- :class:`RetryPolicy` — bounded retries with exponential backoff and
  *seeded* jitter (same seed -> same delay sequence, so faulted runs
  replay bit-identically) plus a transient-error classifier written for
  PyTorch and CUDA (:func:`is_transient`).

- :class:`Deadline` — a cooperative wall-clock budget that long loops
  poll (`expired()`/`check()`); expiry surfaces as
  :class:`DeadlineExceeded`, which the checkers and
  `checkers.api.check_safe` turn into ``{"valid?": "unknown", "error":
  "deadline-exceeded"}`` instead of an unbounded hang;
  :meth:`Deadline.resolve` reads one from a check's opts or test map.

An expiry seen by :meth:`Deadline.check` bumps the
``resilience-deadline-expired`` counter and streams a ``deadline``
event, as in the JAX package.  :func:`is_transient_http` classifies the
live-check client's verifier calls.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

__all__ = ["Deadline", "DeadlineExceeded", "RetryPolicy", "is_transient",
           "is_transient_http",
           "DEADLINE_ERROR", "DEFAULT_POLICY", "deadline_result"]

DEADLINE_ERROR = "deadline-exceeded"


class DeadlineExceeded(Exception):
    """A cooperative checker deadline expired.  Checkers map this to an
    "unknown" verdict; internal loops use it for early unwind."""

    def __init__(self, what: str = ""):
        super().__init__(what or DEADLINE_ERROR)
        self.what = what


class Deadline:
    """A wall-clock budget polled cooperatively by long-running loops.

    ``Deadline(5.0)`` expires 5 s from construction; ``Deadline(None)``
    never expires (every poll is cheap and False).  Monotonic-clock
    based, so shareable across threads; sharing ONE deadline object
    across a composed checker run is what makes the budget cover the
    whole analysis rather than restarting per sub-checker.
    """

    __slots__ = ("t_end",)

    def __init__(self, seconds: Optional[float] = None):
        self.t_end = (time.monotonic() + float(seconds)
                      if seconds is not None else None)

    @classmethod
    def resolve(cls, opts: Optional[dict], test: Optional[dict] = None
                ) -> Optional["Deadline"]:
        """The one rule for where a checker deadline comes from: an
        already-created ``opts["deadline"]`` (shared by composed
        checkers), else ``opts["time-limit"]`` (per-check opt), else
        the test map's ``"checker-time-limit"``.  None when unbounded.
        """
        opts = opts or {}
        dl = opts.get("deadline")
        if isinstance(dl, Deadline):
            return dl
        limit = opts.get("time-limit")
        if limit is None:
            limit = (test or {}).get("checker-time-limit")
        return cls(float(limit)) if limit is not None else None

    def remaining(self) -> Optional[float]:
        """Seconds left, clamped at 0; None when unbounded."""
        if self.t_end is None:
            return None
        return max(0.0, self.t_end - time.monotonic())

    def expired(self) -> bool:
        return self.t_end is not None and time.monotonic() >= self.t_end

    def check(self, what: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent —
        the poll long loops drop into their iteration step."""
        if self.expired():
            _count_deadline(what)
            raise DeadlineExceeded(what)

    def bound_sleep(self, seconds: float) -> float:
        """Clamp a backoff sleep so it never overshoots the deadline."""
        rem = self.remaining()
        return seconds if rem is None else min(seconds, rem)

    def __repr__(self) -> str:
        r = self.remaining()
        return f"<Deadline {'unbounded' if r is None else f'{r:.3f}s left'}>"


def deadline_result(**partial: Any) -> Dict[str, Any]:
    """The canonical deadline verdict: unknown + deadline-exceeded, with
    whatever partial stats the interrupted checker already computed."""
    return {"valid?": "unknown", "error": DEADLINE_ERROR, **partial}


def _count_deadline(what: str) -> None:
    from jepsen_tpu_torch import telemetry

    telemetry.registry().counter("resilience-deadline-expired",
                                 site=what or "unspecified").inc()
    telemetry.stream_event("deadline", site=what or "unspecified")


def is_transient(exc: BaseException) -> bool:
    """Is this a transient device failure a retry could clear?

    - :class:`DeadlineExceeded` never is (the budget IS what expired);
    - an exception carrying ``.transient`` (a synthetic fault from
      `faults.FaultPlan`) gives its own verdict;
    - `torch.cuda.OutOfMemoryError` is: allocator pressure from other
      work on the card can clear;
    - nothing else is.  A CUDA launch or illegal-address error leaves the
      context poisoned, so a retry in the same process cannot clear it,
      and a Python-side bug (TypeError, a bad shape) would only burn the
      budget before the fallback."""
    if isinstance(exc, DeadlineExceeded):
        return False
    transient = getattr(exc, "transient", None)
    if transient is not None:
        return bool(transient)
    return isinstance(exc, torch.cuda.OutOfMemoryError)


#: 5xx statuses a control-plane client rides out (overload / gateway)
_TRANSIENT_HTTP = frozenset({502, 503, 504})


def is_transient_http(exc: BaseException) -> bool:
    """Transient classifier for control-plane HTTP clients (the
    live-check client's verifier calls): everything :func:`is_transient`
    accepts, plus connection-level failures and 5xx overload/gateway
    responses.  A verifier restart window looks like ECONNREFUSED and a
    partition like a timeout — both are ridden out with bounded backoff,
    while 4xx protocol errors (bad cursor, bad body) propagate
    immediately.  :class:`DeadlineExceeded` stays non-retryable."""
    if isinstance(exc, DeadlineExceeded):
        return False
    if is_transient(exc):
        return True
    import urllib.error

    if isinstance(exc, urllib.error.HTTPError):  # before URLError: subclass
        return exc.code in _TRANSIENT_HTTP
    # URLError wraps the socket-level reason; raw socket errors appear
    # when the failure races the response read
    return isinstance(exc, (urllib.error.URLError, ConnectionError,
                            TimeoutError, socket.timeout, OSError))


class RetryPolicy:
    """Bounded retries with exponential backoff and seeded jitter.

    ``max_attempts`` counts total tries (1 = no retry).  Delay before
    retry i (0-based) is ``base_delay_s * multiplier**i`` capped at
    ``max_delay_s``, scaled by a jitter factor drawn uniformly from
    ``[1 - jitter, 1 + jitter]`` by a ``random.Random(seed)`` — the
    seed makes a faulted run's timing schedule reproducible, the same
    determinism contract as :class:`faults.FaultPlan`.

    ``classify(exc) -> bool`` decides retryability; default
    :func:`is_transient`.
    """

    __slots__ = ("max_attempts", "base_delay_s", "multiplier",
                 "max_delay_s", "jitter", "seed", "classify")

    def __init__(self, max_attempts: int = 3, *,
                 base_delay_s: float = 0.05, multiplier: float = 2.0,
                 max_delay_s: float = 2.0, jitter: float = 0.5,
                 seed: int = 0,
                 classify: Callable[[BaseException], bool] = is_transient):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.multiplier = multiplier
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.seed = seed
        self.classify = classify

    def delays(self) -> Iterator[float]:
        """The (max_attempts - 1) backoff delays, jitter included.  A
        fresh iterator restarts the seeded sequence — one per guarded
        call, so concurrent guarded calls don't interleave draws."""
        rng = random.Random(self.seed)
        for i in range(self.max_attempts - 1):
            d = min(self.base_delay_s * (self.multiplier ** i),
                    self.max_delay_s)
            yield max(0.0, d * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)))


DEFAULT_POLICY = RetryPolicy()
