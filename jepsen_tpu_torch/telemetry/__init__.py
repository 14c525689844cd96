"""Telemetry: run/checker span tracing + metrics registry (the port's
copy of `jepsen_tpu/telemetry/__init__.py`).

Zero-dependency, thread-safe observability for the whole pipeline::

    run → os-setup / db-setup / workload / nemesis / store.save_0
        / check:<name> / store.save_1

Usage — instrumentation sites call the module-level API and pay nothing
when telemetry is off (the active collector is a no-op singleton)::

    from jepsen_tpu_torch import telemetry

    with telemetry.span("elle.infer", txns=n) as sp:
        ...
        sp.set_attr(edges=m)

    telemetry.registry().counter("ops", worker=3, type="ok").inc()

Enabling — any of:

- per run: ``test["telemetry"] = True`` (``core.run`` activates a fresh
  collector for the run and ``store.save_1`` writes ``telemetry.json``
  + Chrome ``trace.json`` into the store dir);
- per process: :func:`enable` (or env ``JEPSEN_TELEMETRY=1``), which
  makes every run telemetric;
- manually: ``collector = telemetry.activate()`` ...
  ``telemetry.deactivate(collector)`` around any code, then
  ``export.snapshot(collector)``.

See ``docs/TELEMETRY.md`` for reading ``trace.json`` in Perfetto.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from . import export, metrics, spans, stream
from .export import chrome_trace, snapshot, summarize, write_run
from .metrics import Registry
from .stream import Heartbeat, HttpHeartbeat, read_events
from .stream import attach as attach_stream
from .stream import event as stream_event

# NOTE: gate, prometheus, alerts and warehouse are sibling modules
# imported lazily by their consumers (cli obs, Index fast paths) —
# importing sqlite3 here would tax every `import jepsen_tpu_torch`.
from .spans import (
    NOOP,
    PHASE_BUCKETS,
    TRACE_HEADER,
    Collector,
    NoopCollector,
    PhaseTimer,
    Span,
    TraceContext,
    activate,
    active,
    add_phase,
    current,
    current_trace,
    deactivate,
    enabled,
    mint_trace,
    parse_trace_header,
    phases,
    set_trace,
    span,
    trace_context,
    trace_id_for,
    trace_scope,
    traced,
)

__all__ = [
    "Collector", "NoopCollector", "PhaseTimer", "Span", "NOOP",
    "Registry", "activate", "active", "current", "deactivate",
    "enabled", "phases", "span", "traced", "registry", "snapshot",
    "chrome_trace", "write_run", "summarize", "enable", "disable",
    "wanted_for", "export", "metrics", "spans", "stream",
    "attach_stream", "stream_event", "read_events", "Heartbeat",
    "HttpHeartbeat",
    "TraceContext", "TRACE_HEADER", "mint_trace", "trace_id_for",
    "trace_context", "parse_trace_header", "current_trace",
    "set_trace", "trace_scope", "add_phase", "PHASE_BUCKETS",
]

def registry() -> Registry:
    """The metrics registry instrumentation should write to: the active
    collector's own registry when a run is being traced (per-run
    isolation — two telemetric runs in one process don't mix tallies),
    else the process-wide default (accumulates across the process, the
    "process-wide registry" backstop for collector-less use)."""
    r = getattr(active(), "registry", None)
    return r if r is not None else metrics.registry()


_process_enabled = False


def enable() -> None:
    """Make every subsequent run telemetric (process-wide opt-in)."""
    global _process_enabled
    _process_enabled = True


def disable() -> None:
    global _process_enabled
    _process_enabled = False


def _env_enabled() -> bool:
    return os.environ.get("JEPSEN_TELEMETRY", "").strip().lower() in (
        "1", "true", "yes", "on")


def wanted_for(test: Optional[dict]) -> bool:
    """Should this run collect telemetry?  True when the test map opts
    in (``"telemetry"`` truthy), the process opted in via
    :func:`enable`, or ``JEPSEN_TELEMETRY`` is truthy."""
    if test and test.get("telemetry"):
        return True
    return _process_enabled or _env_enabled()
