"""Telemetry persistence: ``telemetry.json`` + Chrome ``trace.json`` (the
port's copy of `jepsen_tpu/telemetry/export.py`).

Two artifacts per run, written into the store dir during
``store.save_1`` (so a crashed checker still has the phase-0 history,
and the telemetry covers the checking phase itself):

- ``telemetry.json`` — the span forest (nested, durations in ns) plus a
  snapshot of the process-wide metrics registry.  Machine-readable; the
  CLI ``trace`` command and the web UI's telemetry page render it.
- ``trace.json`` — Chrome trace-event format (the ``{"traceEvents":
  [...]}`` object form), loadable in Perfetto / ``chrome://tracing``.
  Spans become ``"ph": "X"`` complete events with microsecond
  timestamps; each thread gets a named row via ``"M"`` metadata events.

Open spans (export runs inside the still-open ``run`` and
``store.save_1`` spans) get a provisional end stamped by
``Collector.close_open_spans`` and are marked ``"open": true``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from .spans import Collector, Span

__all__ = ["span_to_dict", "snapshot", "chrome_trace", "write_run",
           "summarize", "histogram_quantiles", "top_spans",
           "render_top_spans"]

TELEMETRY_FILE = "telemetry.json"
TRACE_FILE = "trace.json"


def span_to_dict(sp: Span) -> Dict[str, Any]:
    return {
        "name": sp.name,
        "t0_ns": sp.t0,
        "dur_ns": sp.duration_ns,
        "thread": sp.thread_name,
        "tid": sp.tid,
        "attrs": _jsonable(sp.attrs),
        "children": [span_to_dict(c) for c in sp.children],
    }


def _jsonable(v: Any) -> Any:
    """Best-effort JSON coercion: attrs may hold numpy scalars, sets,
    arbitrary objects — telemetry must never crash a run over one."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    item = getattr(v, "item", None)  # numpy scalar
    if callable(item):
        try:
            return item()
        except Exception:  # noqa: BLE001
            pass
    return repr(v)


def snapshot(collector: Collector,
             registry: Optional[_metrics.Registry] = None,
             meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The full telemetry document: span forest + metric snapshot.
    Defaults to the collector's own registry (per-run isolation), then
    the process-wide default."""
    collector.close_open_spans()
    reg = (registry or getattr(collector, "registry", None)
           or _metrics.registry())
    doc = {
        "version": 1,
        "epoch_ns": collector.epoch_ns,
        "perf0_ns": collector.perf0_ns,
        "meta": _jsonable(meta or {}),
        "spans": [span_to_dict(r) for r in collector.roots],
        "metrics": reg.snapshot(),
    }
    trace = getattr(collector, "trace", None)
    if trace is not None:
        # the distributed trace triple: what the warehouse
        # stitches cross-host timelines on
        doc["trace"] = trace.to_dict()
    return doc


def chrome_trace(collector: Collector,
                 process_name: str = "jepsen-tpu") -> Dict[str, Any]:
    """Chrome trace-event document for the collector's span forest."""
    collector.close_open_spans()
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    seen_tids = set()

    def emit(sp: Span) -> None:
        if sp.tid not in seen_tids:
            seen_tids.add(sp.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": sp.tid,
                           "args": {"name": sp.thread_name}})
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        events.append({
            "ph": "X",
            "name": sp.name,
            "pid": pid,
            "tid": sp.tid,
            # trace-event timestamps are microseconds; anchor at the
            # collector's perf origin so the run starts near t=0
            "ts": (sp.t0 - collector.perf0_ns) / 1e3,
            "dur": (t1 - sp.t0) / 1e3,
            "args": _jsonable(sp.attrs),
        })
        for c in sp.children:
            emit(c)

    for r in collector.roots:
        emit(r)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_run(dirpath: str, collector: Collector,
              registry: Optional[_metrics.Registry] = None,
              meta: Optional[Dict[str, Any]] = None,
              suffix: str = "") -> Dict[str, str]:
    """Persist both artifacts into `dirpath`; returns their paths.
    `suffix` distinguishes artifact sets (e.g. "-analyze" keeps a
    re-check from clobbering the original run's trace)."""
    doc = snapshot(collector, registry, meta)
    tel_path = os.path.join(
        dirpath, TELEMETRY_FILE.replace(".json", suffix + ".json"))
    with open(tel_path, "w") as f:
        json.dump(doc, f, indent=1)
    trace_path = os.path.join(
        dirpath, TRACE_FILE.replace(".json", suffix + ".json"))
    with open(trace_path, "w") as f:
        json.dump(chrome_trace(collector, meta.get("name", "jepsen-tpu")
                               if meta else "jepsen-tpu"), f)
    return {"telemetry": tel_path, "trace": trace_path}


def histogram_quantiles(bounds: List[Any], counts: List[int],
                        qs: List[float] = (0.50, 0.95, 0.99)
                        ) -> Dict[str, float]:
    """Quantile estimates from fixed-bucket counts — the
    histogram_quantile rule: find the bucket holding the target rank,
    linear-interpolate within its [lower, upper) bounds.  `bounds` is
    the snapshot's ``buckets`` list (finite upper bounds, possibly with
    a trailing ``"+inf"``); a rank landing in the +inf bucket clamps to
    the largest finite bound (no upper edge to interpolate toward).
    Returns {"p50": ..., "p95": ..., "p99": ...} (empty when count 0)."""
    finite = [float(b) for b in bounds if isinstance(b, (int, float))]
    total = sum(counts)
    if not total or not finite:
        return {}
    out: Dict[str, float] = {}
    for q in qs:
        rank = q * total
        cum = 0.0
        val = finite[-1]
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= rank and c:
                lo = finite[i - 1] if 0 < i <= len(finite) else 0.0
                if i < len(finite):
                    hi = finite[i]
                    val = lo + (hi - lo) * (rank - prev) / c
                else:  # +inf bucket: clamp to the last finite bound
                    val = finite[-1]
                break
        out[f"p{int(q * 100)}"] = round(val, 6)
    return out


def quantile(sorted_vals: List[float], p: float) -> float:
    """THE floor nearest-rank quantile rule, shared by every surface
    that quotes span/probe percentiles (``trace --top``, the shrink
    probe stats) — one formula, so two reports of the same samples
    can't disagree."""
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(p * (len(sorted_vals) - 1)))]


def top_spans(doc: Dict[str, Any], n: int = 10) -> List[Dict[str, Any]]:
    """The slowest-spans table (``cli trace --top N``): per span name,
    count / total self-time / p95 self-time, sorted by total self-time
    descending.  Self-time = a span's duration minus its children's
    (clamped at 0 — provisional closes can overlap), so a parent that
    merely *waits* on an expensive child doesn't crowd it out.  Makes a
    span regression quotable without opening Perfetto."""
    agg: Dict[str, List[float]] = {}

    def walk(sp: Dict[str, Any]) -> None:
        dur = sp.get("dur_ns")
        kids = sp.get("children") or []
        if isinstance(dur, (int, float)):
            child_ns = sum(c.get("dur_ns") or 0 for c in kids
                           if isinstance(c.get("dur_ns"), (int, float)))
            agg.setdefault(sp["name"], []).append(
                max(0.0, float(dur) - child_ns))
        for c in kids:
            walk(c)

    for r in doc.get("spans", []):
        walk(r)
    rows: List[Dict[str, Any]] = []
    for name, selfs in agg.items():
        s = sorted(selfs)
        p95 = quantile(s, 0.95)
        rows.append({"name": name, "count": len(s),
                     "total_self_s": round(sum(s) / 1e9, 6),
                     "p95_self_s": round(p95 / 1e9, 6)})
    rows.sort(key=lambda r: -r["total_self_s"])
    return rows[:max(1, int(n))]


def render_top_spans(rows: List[Dict[str, Any]]) -> str:
    lines = [f"{'span':<40} {'n':>6} {'total self':>12} {'p95 self':>12}"]
    for r in rows:
        lines.append(f"{r['name']:<40} {r['count']:>6} "
                     f"{r['total_self_s']:>11.4f}s {r['p95_self_s']:>11.4f}s")
    return "\n".join(lines)


# -- summaries (cli `trace` command) ---------------------------------------

def _fmt_dur(ns: Optional[float], fallback: str = "open") -> str:
    if not isinstance(ns, (int, float)):
        return fallback
    if ns >= 1e9:
        return f"{ns / 1e9:.2f}s"
    if ns >= 1e6:
        return f"{ns / 1e6:.1f}ms"
    return f"{ns / 1e3:.0f}us"


def _render_span(sp: Dict[str, Any], depth: int, lines: List[str],
                 max_depth: int = 6) -> None:
    attrs = {k: v for k, v in (sp.get("attrs") or {}).items()
             if k != "open"}
    extra = (" " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
             if attrs else "")
    lines.append(f"{'  ' * depth}{sp['name']:<{max(1, 40 - 2 * depth)}} "
                 f"{_fmt_dur(sp.get('dur_ns')):>10}{extra}")
    if depth < max_depth:
        for c in sp.get("children") or []:
            _render_span(c, depth + 1, lines, max_depth)


def summarize(dirpath: str, max_depth: int = 6,
              doc: Optional[Dict[str, Any]] = None) -> str:
    """Human summary of a stored run's telemetry.json: the span tree
    with durations, then non-zero counters and gauges.  Pass an
    already-parsed `doc` to skip the file read (the web handler loads
    the json once for both its percentile table and this summary)."""
    if doc is None:
        path = os.path.join(dirpath, TELEMETRY_FILE)
        with open(path) as f:
            doc = json.load(f)
    lines: List[str] = [f"telemetry for {dirpath}", ""]
    for root in doc.get("spans", []):
        _render_span(root, 0, lines, max_depth)
    m = doc.get("metrics", {})
    counters = [c for c in m.get("counters", []) if c.get("value")]
    gauges = [g for g in m.get("gauges", []) if g.get("value") is not None]
    if counters or gauges:
        lines.append("")
        lines.append("metrics:")
        for c in sorted(counters, key=lambda c: (c["name"],
                                                 str(c["labels"]))):
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(c["labels"].items()))
            lines.append(f"  {c['name']}{{{lbl}}} = {c['value']}")
        for g in sorted(gauges, key=lambda g: (g["name"],
                                               str(g["labels"]))):
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(g["labels"].items()))
            lines.append(f"  {g['name']}{{{lbl}}} = {g['value']}")
    for h in m.get("histograms", []):
        if h.get("count"):
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(h["labels"].items()))
            quant = histogram_quantiles(h.get("buckets") or [],
                                        h.get("counts") or [])
            qs = " ".join(f"{k}={v:.4g}" for k, v in quant.items())
            lines.append(f"  {h['name']}{{{lbl}}} count={h['count']} "
                         f"sum={h['sum']:.6g}"
                         + (f" {qs}" if qs else ""))
    return "\n".join(lines)
