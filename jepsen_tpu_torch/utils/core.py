"""General helpers (the port's copy of `jepsen_tpu/utils/core.py`).

Equivalent of the reference's `jepsen/src/jepsen/util.clj` (SURVEY.md §2.1):
the monotonic relative test clock, `timeout`, `majority`, random
distributions for generators, retry-with-backoff, `fcatch`, and
`nemesis-intervals` (pairing nemesis start/stop ops into shaded windows for
perf plots).
"""

from __future__ import annotations

import random
import threading
import time as _time
from typing import Any, Callable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Relative test clock (reference: `util/relative-time-nanos` — a monotonic
# clock whose origin is the start of the test, so op :time fields are small
# and comparable across processes).

_origin_lock = threading.Lock()
_origin_ns: Optional[int] = None


def init_time_origin() -> None:
    """Reset the relative clock origin to now (called at test start)."""
    global _origin_ns
    with _origin_lock:
        _origin_ns = _time.monotonic_ns()


def relative_time_nanos() -> int:
    """Nanoseconds since the test clock origin (auto-initializes)."""
    global _origin_ns
    if _origin_ns is None:
        init_time_origin()
    return _time.monotonic_ns() - _origin_ns


# ---------------------------------------------------------------------------
# Timeouts


class TimeoutError_(Exception):
    pass


def timeout(seconds: float, fn: Callable[[], Any], *,
            on_timeout: Any = TimeoutError_) -> Any:
    """Run `fn` with a wall-clock timeout (reference `util/timeout` macro).

    Python threads can't be safely killed, so like the JVM original (which
    interrupts), the worker may linger; we abandon it.  If `on_timeout` is an
    exception class it is raised; otherwise it is returned as the value.
    """
    done = threading.Event()
    result: list = [None]
    error: list = [None]

    def run():
        try:
            result[0] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            error[0] = e
        finally:
            done.set()

    # daemon thread: an abandoned (hung) worker must not block process exit
    t = threading.Thread(target=run, daemon=True)
    t.start()
    if not done.wait(timeout=seconds):
        if isinstance(on_timeout, type) and issubclass(on_timeout, BaseException):
            raise on_timeout(f"timed out after {seconds}s")
        return on_timeout
    if error[0] is not None:
        raise error[0]
    return result[0]


# ---------------------------------------------------------------------------
# Small numeric helpers


def majority(n: int) -> int:
    """Smallest majority of n nodes: majority(5) == 3 (reference
    `util/majority`)."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest minority: minority(5) == 2."""
    return (n - 1) // 2


def fcatch(fn: Callable) -> Callable:
    """Wrap fn so thrown exceptions are returned instead (reference
    `util/fcatch`)."""

    def wrapper(*args, **kw):
        try:
            return fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — mirror of fcatch semantics
            return e

    return wrapper


# ---------------------------------------------------------------------------
# Random distributions (reference `util/rand-distribution`, used by
# generators and nemesis interval schedules).


def rand_distribution(spec: dict, rng: Optional[random.Random] = None) -> float:
    """Draw from a distribution spec.

    Specs (mirroring the reference's map flavor):
      {"distribution": "constant", "value": x}
      {"distribution": "uniform",  "min": a, "max": b}
      {"distribution": "exponential", "mean": m}
      {"distribution": "zipf", "n": n, "skew": s}  -> int in [0, n)
    """
    rng = rng or random
    kind = spec.get("distribution", "uniform")
    if kind == "constant":
        return spec["value"]
    if kind == "uniform":
        return rng.uniform(spec["min"], spec["max"])
    if kind == "exponential":
        return rng.expovariate(1.0 / spec["mean"])
    if kind == "zipf":
        n, s = spec["n"], spec.get("skew", 1.0001)
        # inverse-CDF draw over the finite zipf pmf
        weights = [1.0 / (i + 1) ** s for i in range(n)]
        total = sum(weights)
        u = rng.random() * total
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if u <= acc:
                return i
        return n - 1
    raise ValueError(f"unknown distribution {kind!r}")


# ---------------------------------------------------------------------------
# Retry with backoff (reference `util/with-retry` idiom + `control/retry.clj`
# policies).


def with_retry(fn: Callable[[], Any], *, retries: int = 5,
               backoff: float = 0.2, max_backoff: float = 5.0,
               retry_on: type = Exception,
               log: Optional[Callable[[str], None]] = None) -> Any:
    """Call fn, retrying on exception with exponential backoff."""
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == retries:
                raise
            if log:
                log(f"retry {attempt + 1}/{retries} after {type(e).__name__}: {e}")
            _time.sleep(delay)
            delay = min(max_backoff, delay * 2)


# ---------------------------------------------------------------------------
# Nemesis intervals (reference `util/nemesis-intervals`: pair nemesis ops
# into [start, stop] windows — used by perf plots for activity shading).

# f names conventionally marking window starts/stops
_DEFAULT_START_FS = {"start", "start!", "start-partition", "kill", "pause",
                     "corrupt", "bump-clock", "strobe-clock"}
_DEFAULT_STOP_FS = {"stop", "stop!", "stop-partition", "restart", "resume",
                    "heal", "reset-clock"}


def nemesis_intervals(ops: Sequence, *, start_fs: Optional[set] = None,
                      stop_fs: Optional[set] = None
                      ) -> List[Tuple[Any, Any]]:
    """Pair nemesis ops into (start-op, stop-op-or-None) intervals.

    Each start op opens a window closed by the next stop op; unclosed
    windows get None (open until end of test)."""
    start_fs = _DEFAULT_START_FS if start_fs is None else start_fs
    stop_fs = _DEFAULT_STOP_FS if stop_fs is None else stop_fs
    intervals: List[Tuple[Any, Any]] = []
    open_starts: List[Any] = []
    for op in ops:
        f = getattr(op, "f", None)
        if f in start_fs:
            open_starts.append(op)
        elif f in stop_fs:
            for s in open_starts:
                intervals.append((s, op))
            open_starts = []
    for s in open_starts:
        intervals.append((s, None))
    return intervals


# ---------------------------------------------------------------------------
# Misc


def coll(x: Any) -> list:
    """Coerce scalar-or-sequence to a list (reference `util/coll`)."""
    if x is None:
        return []
    if isinstance(x, (list, tuple, set)):
        return list(x)
    return [x]


def seconds_to_nanos(s: float) -> int:
    return int(s * 1e9)


def nanos_to_seconds(ns: int) -> float:
    return ns / 1e9
