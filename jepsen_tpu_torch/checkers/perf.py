"""Performance graphs: latency and rate over time (the port's copy of
`jepsen_tpu/checkers/perf.py`).

Equivalent of the reference's `jepsen/src/jepsen/checker/perf.clj`
(SURVEY.md §2.1): extracts latency/rate point series from the history with
vectorised folds (numpy on the host) and
renders PNGs with matplotlib (replacing the reference's external gnuplot,
§2.5 #8), with nemesis activity windows shaded behind the series.

Checkers: :class:`LatencyGraph`, :class:`RateGraph`, and :func:`perf`
composing both — always valid; their value is the artifacts written into
the store directory.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..history.ops import FAIL, INFO, INVOKE, OK
from .api import Checker, output_path as _output_path

logger = logging.getLogger("jepsen.checker.perf")

_TYPE_COLOR = {OK: "#81F749", FAIL: "#E9A4A0", INFO: "#FFAA26"}
_NS = 1e9


def latency_points(history) -> Dict[str, np.ndarray]:
    """Per completed client op: invoke time (s), latency (ms), completion
    type code, and an interned :f id.  One pass, SoA output."""
    t_inv: List[float] = []
    lat: List[float] = []
    typ: List[str] = []
    fs: List[Any] = []
    for op in history:
        if not op.is_client_op() or op.type == INVOKE:
            continue
        inv = history.invocation(op) if hasattr(history, "invocation") else None
        if inv is None:
            continue
        t_inv.append(inv.time / _NS)
        lat.append(max(op.time - inv.time, 0) / 1e6)
        typ.append(op.type)
        fs.append(op.f)
    return {"time": np.asarray(t_inv), "latency_ms": np.asarray(lat),
            "type": np.asarray(typ, dtype=object),
            "f": np.asarray(fs, dtype=object)}


def rate_points(history, dt: float = 1.0) -> Dict[Tuple[Any, str], Tuple[np.ndarray, np.ndarray]]:
    """Ops/sec per (f, completion-type), bucketed into dt-second windows."""
    pts = latency_points(history)
    out: Dict[Tuple[Any, str], Tuple[np.ndarray, np.ndarray]] = {}
    if len(pts["time"]) == 0:
        return out
    t_end = float(pts["time"].max()) + dt
    edges = np.arange(0.0, t_end + dt, dt)
    for f in sorted(set(pts["f"]), key=repr):
        for typ in (OK, FAIL, INFO):
            sel = (pts["f"] == f) & (pts["type"] == typ)
            if not sel.any():
                continue
            counts, _ = np.histogram(pts["time"][sel], bins=edges)
            out[(f, typ)] = (edges[:-1], counts / dt)
    return out


# Fallback name heuristics for tests without perf metadata.  Note the
# exact f="start" is a *start* here (the conventional start/stop nemesis);
# the kill package, whose recovery op is f="start", supplies metadata.
_DEFAULT_STARTS = frozenset({"partition", "kill", "pause", "bump-clock",
                             "strobe-clock"})
_DEFAULT_STOPS = frozenset({"resume", "restart", "reset-clock"})


def _perf_specs(test: Optional[dict]) -> List[Tuple[frozenset, frozenset]]:
    """(start-fs, stop-fs) pairs.  Prefers the nemesis packages' exact perf
    metadata on the test map (`nemesis/combined.py` exports
    {"perf": {"start": {...}, "stop": {...}}}); falls back to name
    heuristics.  Note the kill package's *recovery* op is f="start", which
    is why metadata beats heuristics."""
    t = test or {}
    metas = list((t.get("plot") or {}).get("nemeses") or ())
    for pkg in t.get("nemesis-packages", ()) or ():
        perf_val = (pkg or {}).get("perf")
        if isinstance(perf_val, list):  # composed package: list of metas
            metas.extend(m for m in perf_val if m)
        elif perf_val:
            metas.append(perf_val)
    specs = []
    for perf_meta in metas:
        if perf_meta.get("start") or perf_meta.get("stop"):
            specs.append((frozenset(perf_meta.get("start", ())),
                          frozenset(perf_meta.get("stop", ()))))
    if not specs:
        specs.append((_DEFAULT_STARTS, _DEFAULT_STOPS))
    return specs


def nemesis_intervals(history, test: Optional[dict] = None
                      ) -> List[Tuple[float, float, Any]]:
    """(start, end, f) windows of nemesis activity, for plot shading
    (reference `util/nemesis-intervals` + perf's shaded regions).  Windows
    open/close on completions, when the fault has actually taken effect."""
    out = []
    specs = _perf_specs(test)
    open_at: List[Optional[float]] = [None] * len(specs)
    open_f: List[Any] = [None] * len(specs)
    for op in history:
        if op.process != "nemesis" or op.type == INVOKE:
            continue
        f = str(op.f or "")
        t = op.time / _NS
        for si, (starts, stops) in enumerate(specs):
            generic = starts is _DEFAULT_STARTS
            is_start = f in starts or (generic and f.startswith("start"))
            is_stop = f in stops or (generic and (f.startswith("stop")
                                                  or f.startswith("heal")))
            if generic and f == "start" and open_at[si] is not None:
                # heuristic mode: a bare "start" while a window is open is
                # the kill nemesis's recovery — close, don't open
                is_start, is_stop = False, True
            if is_start and open_at[si] is None:
                open_at[si], open_f[si] = t, op.f
            elif is_stop and open_at[si] is not None:
                out.append((open_at[si], t, open_f[si]))
                open_at[si], open_f[si] = None, None
    for si in range(len(specs)):
        if open_at[si] is not None:
            end = (history[len(history) - 1].time / _NS
                   if len(history) else open_at[si])
            out.append((open_at[si], end, open_f[si]))
    return sorted(out)


def _shade(ax, history, test: Optional[dict] = None):
    for (t0, t1, f) in nemesis_intervals(history, test):
        ax.axvspan(t0, t1, color="#FF8B8B", alpha=0.2, lw=0)


def _matplotlib():
    """pyplot with the Agg backend, or None when matplotlib is absent —
    the graphs then degrade to returning their computed counts instead
    of raising into `check_safe` (a missing plotting dep must never
    turn a run's results "unknown")."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        logger.warning("matplotlib unavailable; perf graphs skipped")
        return None


class LatencyGraph(Checker):
    """Scatter of op latencies over time, colored by completion type,
    one marker style per :f; nemesis windows shaded (reference
    `latency-graph`, rendered with matplotlib instead of gnuplot)."""

    def __init__(self, filename: str = "latency-raw.png"):
        self.filename = filename

    def check(self, test, history, opts=None):
        pts = latency_points(history)
        if len(pts["time"]) == 0:
            return {"valid?": True, "points": 0}
        plt = _matplotlib()
        if plt is None:
            return {"valid?": True, "points": int(len(pts["time"])),
                    "plot": "skipped (no matplotlib)"}

        fig, ax = plt.subplots(figsize=(10, 5))
        _shade(ax, history, test)
        markers = "ox+sd^v*"
        for i, f in enumerate(sorted(set(pts["f"]), key=repr)):
            for typ in (OK, FAIL, INFO):
                sel = (pts["f"] == f) & (pts["type"] == typ)
                if not sel.any():
                    continue
                ax.scatter(pts["time"][sel], pts["latency_ms"][sel],
                           s=8, marker=markers[i % len(markers)],
                           c=_TYPE_COLOR[typ], label=f"{f} {typ}",
                           alpha=0.7, linewidths=0.5, edgecolors="none")
        ax.set_yscale("log")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("latency (ms)")
        ax.set_title(test.get("name", "test"))
        ax.legend(fontsize=6, loc="upper right", ncol=2)
        path = _output_path(test, opts, self.filename)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return {"valid?": True, "points": int(len(pts["time"])),
                "file": path}


class RateGraph(Checker):
    """Throughput (ops/sec per :f × outcome) over time (reference
    `rate-graph`)."""

    def __init__(self, filename: str = "rate.png", dt: float = 1.0):
        self.filename = filename
        self.dt = dt

    def check(self, test, history, opts=None):
        series = rate_points(history, self.dt)
        if not series:
            return {"valid?": True, "points": 0}
        plt = _matplotlib()
        if plt is None:
            return {"valid?": True,
                    "points": sum(len(t) for t, _ in series.values()),
                    "series": len(series),
                    "plot": "skipped (no matplotlib)"}

        fig, ax = plt.subplots(figsize=(10, 5))
        _shade(ax, history, test)
        for (f, typ), (t, rate) in sorted(series.items(),
                                          key=lambda kv: repr(kv[0])):
            ax.plot(t, rate, drawstyle="steps-post",
                    color=_TYPE_COLOR[typ], alpha=0.8, lw=1.2,
                    label=f"{f} {typ}")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("ops / s")
        ax.set_title(test.get("name", "test"))
        ax.legend(fontsize=6, loc="upper right", ncol=2)
        path = _output_path(test, opts, self.filename)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return {"valid?": True, "points": sum(len(t) for t, _ in
                                              series.values()),
                "file": path}


def perf() -> Checker:
    """Both graphs (reference `checker/perf`)."""
    from .api import compose
    return compose({"latency-graph": LatencyGraph(),
                    "rate-graph": RateGraph()})
