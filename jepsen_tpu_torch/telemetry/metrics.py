"""Process-wide metrics registry — counters, gauges, histograms (the
port's copy of `jepsen_tpu/telemetry/metrics.py`).

The second half of the telemetry layer: where spans answer
"where did the time go", metrics answer "how much work happened" —
ops invoked/ok/fail/info per worker, generator stall time, checker
throughput, bytes staged to device.

Shapes:
- :class:`Counter` — monotonically increasing float/int (`inc`).
- :class:`Gauge` — last-write-wins value (`set`).
- :class:`Histogram` — fixed bucket upper bounds chosen at creation;
  `observe` bins the value, tracking count/sum (Prometheus-style
  cumulative counts are computed at snapshot time).

Instruments are keyed by (name, sorted labels); asking twice returns
the same instrument, so instrumentation sites never need module-level
handles.  Creation is lock-protected; per-instrument mutation uses one
small lock per instrument — single-writer hot paths (the interpreter
accumulates per-worker counts locally and flushes once) keep that off
the op path entirely.

The process-wide default registry lives here (:func:`registry`);
`export.snapshot` serializes it next to the span tree.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "reset"]

LabelKey = Tuple[Tuple[str, Any], ...]


def _key(name: str, labels: Dict[str, Any]) -> Tuple[str, LabelKey]:
    return name, tuple(sorted(labels.items()))


class Counter:
    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v  # single 8-byte store; races just last-write-win


DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0)


class Histogram:
    """Fixed-bucket histogram: `bounds` are inclusive upper bounds, with
    an implicit +inf bucket at the end."""

    __slots__ = ("name", "labels", "bounds", "_lock", "counts", "sum",
                 "count")

    def __init__(self, name: str, labels: Dict[str, Any],
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        self._lock = threading.Lock()
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class Registry:
    """Threadsafe instrument registry.  `counter/gauge/histogram` create
    on first use and return the cached instrument afterwards."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any], *args):
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._lock:
                m = self._metrics.get(k)
                if m is None:
                    m = self._metrics[k] = cls(name, labels, *args)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels, buckets)

    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """Serializable view: {"counters": [...], "gauges": [...],
        "histograms": [...]}, each entry carrying name/labels/value(s)."""
        out: Dict[str, List[Dict[str, Any]]] = {
            "counters": [], "gauges": [], "histograms": []}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            base = {"name": m.name, "labels": dict(m.labels)}
            if isinstance(m, Counter):
                out["counters"].append({**base, "value": m.value})
            elif isinstance(m, Gauge):
                out["gauges"].append({**base, "value": m.value})
            else:
                out["histograms"].append({
                    **base,
                    "buckets": list(m.bounds) + ["+inf"],
                    "counts": list(m.counts),
                    "sum": m.sum, "count": m.count,
                })
        return out

    def remove(self, name: str, **labels: Any) -> bool:
        """Drop one instrument — e.g. a per-session labeled gauge when
        the session ends, so a long-lived service doesn't accumulate
        stale label series on /metrics forever."""
        with self._lock:
            return self._metrics.pop(_key(name, labels), None) is not None

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_default = Registry()


def registry() -> Registry:
    """The process-wide registry of counters, gauges, and fixed-bucket
    histograms."""
    return _default


def reset() -> None:
    """Drop all instruments (tests; runs normally accumulate)."""
    _default.clear()
