"""Prometheus text exposition (the port's copy of
`jepsen_tpu/telemetry/prometheus.py`, the web ``/metrics`` endpoint).

Renders the live metrics registry — the active run's counters, gauges,
and histogram buckets — plus campaign heartbeat freshness and warehouse
rollup gauges as Prometheus **text exposition format 0.0.4**: one
``# HELP``/``# TYPE`` block per metric family, cumulative
``_bucket{le=...}`` lines for histograms, backslash/quote/newline label
escaping.  Scrape-compatible output is pinned by a golden test
(``tests/data/prometheus-golden.txt``) so it can't drift under a
refactor.

Conventions:

- instrument names are sanitized to the Prometheus charset and prefixed
  ``jepsen_`` (``checker-ops-per-s`` → ``jepsen_checker_ops_per_s``);
- counters get the ``_total`` suffix;
- every family's samples are sorted (name, then serialized labels) so
  the exposition is deterministic.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as _metrics

__all__ = ["exposition", "render_registry", "render_heartbeats",
           "render_warehouse", "render_fleet", "render_alerts",
           "metric_name", "escape_label_value", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


def metric_name(name: str, prefix: str = "jepsen_") -> str:
    """Sanitize an instrument name to the Prometheus charset (every
    illegal character becomes ``_``) and prefix it."""
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    out = prefix + s
    assert _NAME_OK.match(out), out
    return out


def _label_name(name: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def escape_label_value(v: Any) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_label_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items(), key=lambda kv: str(kv[0])))
    return "{" + inner + "}"


def _merge_labels(labels: Dict[str, Any], extra: Dict[str, Any]) -> str:
    merged = dict(labels)
    merged.update(extra)
    return _labels_str(merged)


class _Doc:
    """Accumulates families: one # HELP/# TYPE header per family, then
    its sample lines.  Counter/gauge samples are sorted for
    determinism; histogram samples keep append order — their buckets
    MUST stay in increasing ``le`` order (lexical sort would put
    ``+Inf`` first and ``le="1"`` after ``le="0.1"``), and the callers
    already append label groups in sorted order."""

    def __init__(self) -> None:
        self.families: Dict[str, Tuple[str, str, List[str]]] = {}
        self.order: List[str] = []

    def family(self, name: str, typ: str, help_: str) -> List[str]:
        fam = self.families.get(name)
        if fam is None:
            fam = self.families[name] = (typ, help_, [])
            self.order.append(name)
        return fam[2]

    def render(self) -> List[str]:
        out: List[str] = []
        for name in self.order:
            typ, help_, samples = self.families[name]
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {typ}")
            out.extend(samples if typ == "histogram"
                       else sorted(samples))
        return out


def render_registry(reg: _metrics.Registry,
                    prefix: str = "jepsen_") -> List[str]:
    """The live registry as exposition lines: counters (``_total``),
    gauges, and histograms (cumulative ``_bucket`` + ``_sum`` +
    ``_count``)."""
    snap = reg.snapshot()
    doc = _Doc()
    for c in sorted(snap["counters"],
                    key=lambda c: (c["name"], str(sorted(
                        c["labels"].items(), key=str)))):
        name = metric_name(c["name"], prefix)
        if not name.endswith("_total"):
            name += "_total"
        doc.family(name, "counter", f"jepsen-tpu counter {c['name']}") \
            .append(f"{name}{_labels_str(c['labels'])} "
                    f"{_fmt_value(c['value'])}")
    for g in sorted(snap["gauges"],
                    key=lambda g: (g["name"], str(sorted(
                        g["labels"].items(), key=str)))):
        if g["value"] is None:
            continue
        name = metric_name(g["name"], prefix)
        doc.family(name, "gauge", f"jepsen-tpu gauge {g['name']}") \
            .append(f"{name}{_labels_str(g['labels'])} "
                    f"{_fmt_value(g['value'])}")
    for h in sorted(snap["histograms"],
                    key=lambda h: (h["name"], str(sorted(
                        h["labels"].items(), key=str)))):
        name = metric_name(h["name"], prefix)
        samples = doc.family(name, "histogram",
                             f"jepsen-tpu histogram {h['name']}")
        cum = 0
        bounds = h.get("buckets") or []
        counts = h.get("counts") or []
        for b, n in zip(bounds, counts):
            cum += n
            le = "+Inf" if b == "+inf" else _fmt_value(b)
            samples.append(
                f"{name}_bucket{_merge_labels(h['labels'], {'le': le})}"
                f" {cum}")
        # the snapshot's trailing implicit +inf bucket (buckets list
        # carries finite bounds + "+inf"; counts is one longer than
        # the finite bounds)
        if len(counts) == len(bounds):
            pass  # +inf already emitted above
        elif len(counts) == len(bounds) + 1:
            cum += counts[-1]
            samples.append(
                f"{name}_bucket"
                f"{_merge_labels(h['labels'], {'le': '+Inf'})} {cum}")
        samples.append(f"{name}_sum{_labels_str(h['labels'])} "
                       f"{_fmt_value(h['sum'])}")
        samples.append(f"{name}_count{_labels_str(h['labels'])} "
                       f"{h['count']}")
    return doc.render()


def render_heartbeats(base: str,
                      now: Optional[float] = None) -> List[str]:
    """Campaign heartbeat freshness gauges from every
    ``<store>/campaigns/*.live.json``: age since last update, done/
    total progress, in-flight worker count, finished flag."""
    cdir = os.path.join(base, "campaigns")
    if not os.path.isdir(cdir):
        return []
    now = time.time() if now is None else now
    doc = _Doc()
    for fn in sorted(os.listdir(cdir)):
        if not fn.endswith(".live.json"):
            continue
        try:
            with open(os.path.join(cdir, fn)) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(hb, dict):
            continue
        name = fn[:-len(".live.json")]
        lbl = _labels_str({"campaign": hb.get("campaign") or name})
        upd = hb.get("updated")
        if isinstance(upd, (int, float)):
            doc.family("jepsen_campaign_heartbeat_age_seconds", "gauge",
                       "seconds since the campaign heartbeat was "
                       "last written").append(
                "jepsen_campaign_heartbeat_age_seconds"
                f"{lbl} {_fmt_value(max(0.0, round(now - upd, 3)))}")
        doc.family("jepsen_campaign_runs_total_planned", "gauge",
                   "total runs in the campaign plan").append(
            f"jepsen_campaign_runs_total_planned{lbl} "
            f"{_fmt_value(hb.get('total') or 0)}")
        doc.family("jepsen_campaign_runs_done", "gauge",
                   "campaign runs completed").append(
            f"jepsen_campaign_runs_done{lbl} "
            f"{_fmt_value(hb.get('done') or 0)}")
        doc.family("jepsen_campaign_workers_in_flight", "gauge",
                   "campaign worker slots currently holding a run"
                   ).append(
            f"jepsen_campaign_workers_in_flight{lbl} "
            f"{len(hb.get('workers') or {})}")
        doc.family("jepsen_campaign_finished", "gauge",
                   "1 once the campaign scheduler closed its heartbeat"
                   ).append(
            f"jepsen_campaign_finished{lbl} "
            f"{1 if hb.get('finished') else 0}")
    return doc.render()


def render_warehouse(wh: Any) -> List[str]:
    """Warehouse rollup gauges: store runs by verdict, per-campaign
    latest verdict counts, and the bench throughput series."""
    doc = _Doc()
    try:
        roll = wh.rollups()
    except Exception:  # noqa: BLE001 — rollups are best-effort
        return []
    for verdict, n in sorted((roll.get("runs_by_verdict") or {}).items()):
        doc.family("jepsen_warehouse_runs", "gauge",
                   "ingested store runs by verdict").append(
            f"jepsen_warehouse_runs{_labels_str({'valid': verdict})} {n}")
    for camp, counts in sorted((roll.get("campaigns") or {}).items()):
        for verdict in ("true", "false", "unknown"):
            doc.family("jepsen_warehouse_campaign_runs", "gauge",
                       "latest campaign verdict counts").append(
                "jepsen_warehouse_campaign_runs"
                f"{_labels_str({'campaign': camp, 'valid': verdict})} "
                f"{counts.get(verdict, 0)}")
    for state, n in sorted((roll.get("verifier_by_state") or {}).items()):
        doc.family("jepsen_warehouse_verifier_sessions", "gauge",
                   "ingested verifier sessions by state").append(
            "jepsen_warehouse_verifier_sessions"
            f"{_labels_str({'state': state})} {n}")
    for row in roll.get("bench") or []:
        if not isinstance(row.get("value"), (int, float)):
            continue
        doc.family("jepsen_warehouse_bench_ops_per_sec", "gauge",
                   "bench check throughput by source").append(
            "jepsen_warehouse_bench_ops_per_sec"
            f"{_labels_str({'source': row.get('source'), 'n_txns': row.get('n_txns'), 'backend': row.get('backend')})} "
            f"{_fmt_value(row['value'])}")
    return doc.render()


def render_alerts(base: str,
                  now: Optional[float] = None) -> List[str]:
    """The watchtower's alert state as the Prometheus
    convention's literal ``ALERTS`` gauge family — NO ``jepsen_``
    prefix, exactly the series an Alertmanager-era scraper expects:
    ``ALERTS{alertname=...,severity=...,state="pending"|"firing"} 1``.

    Replayed from the store's ``alerts.jsonl`` journal, read-only (a
    reader never heals the journal).  Cardinality is bounded by
    construction: a series exists ONLY while its rule is pending or
    firing and retires the moment it resolves — the same discipline as
    the fleet host series retiring with worker liveness."""
    from . import alerts as alerts_mod

    path = alerts_mod.alerts_path(base)
    if not os.path.exists(path):
        return []
    try:
        journal = alerts_mod.AlertJournal(path)
        active = journal.active()
    except Exception:  # noqa: BLE001 — alerts are best-effort
        return []
    if not active:
        return []
    doc = _Doc()
    fam = doc.family("ALERTS", "gauge",
                     "active watchtower alert rules by state")
    for a in active:
        fam.append(
            "ALERTS" + _labels_str({
                "alertname": a["rule"],
                "severity": a.get("severity") or "warn",
                "state": a.get("state")}) + " 1")
    return doc.render()


def render_fleet(fleet: Any) -> List[str]:
    """Metrics federation: the fleet
    coordinator's view of every ALIVE worker's last pushed metrics
    snapshot, as ``jepsen_fleet_host_*`` series with a ``host=`` label
    (one scrape of the coordinator sees the whole fleet) plus
    ``jepsen_fleet_rollup_*`` sums across hosts.  Cardinality is
    bounded by construction: the coordinator caps rows per worker, and
    a worker's series RETIRE with its liveness — expired workers
    simply stop being rendered (the same discipline as the
    verifier's per-session gauge retirement)."""
    doc = _Doc()
    try:
        fed = fleet.federated_metrics()
    except Exception:  # noqa: BLE001 — federation is best-effort
        return []
    doc.family("jepsen_fleet_fed_workers_reporting", "gauge",
               "alive workers whose metrics snapshot is being "
               "federated").append(
        f"jepsen_fleet_fed_workers_reporting {len(fed)}")
    # rolling-upgrade visibility: one info series
    # per ALIVE versioned worker.  Cardinality is pinned the same way
    # as every host_* series — the set retires with worker liveness,
    # so an upgrade churning through worker names keeps the scrape
    # flat instead of accreting dead versions.
    for w in sorted(fed):
        ver = fed[w].get("version")
        if ver:
            doc.family("jepsen_fleet_host_info", "gauge",
                       "alive fleet workers by stamped version"
                       ).append(
                "jepsen_fleet_host_info"
                f"{_labels_str({'host': w, 'version': ver})} 1")
    rollup: Dict[Tuple[str, str, str], float] = {}
    for w in sorted(fed):
        for r in fed[w].get("rows") or []:
            raw = str(r.get("name") or "")
            kind = "counter" if r.get("kind") == "counter" else "gauge"
            try:
                v = float(r.get("value"))
            except (TypeError, ValueError):
                continue
            name = metric_name(raw, "jepsen_fleet_host_")
            if kind == "counter" and not name.endswith("_total"):
                name += "_total"
            labels = dict(r.get("labels") or {})
            labels["host"] = w
            doc.family(name, kind,
                       f"fleet-federated worker {kind} {raw}").append(
                f"{name}{_labels_str(labels)} {_fmt_value(v)}")
            key = (raw, kind, json.dumps(r.get("labels") or {},
                                         sort_keys=True))
            rollup[key] = rollup.get(key, 0.0) + v
    for (raw, kind, lbl) in sorted(rollup):
        name = metric_name(raw, "jepsen_fleet_rollup_")
        if kind == "counter" and not name.endswith("_total"):
            name += "_total"
        doc.family(name, kind,
                   f"fleet rollup (sum over alive hosts) of {raw}"
                   ).append(
            f"{name}{_labels_str(json.loads(lbl))} "
            f"{_fmt_value(rollup[(raw, kind, lbl)])}")
    return doc.render()


def exposition(base: Optional[str] = None,
               registry: Optional[_metrics.Registry] = None,
               now: Optional[float] = None,
               fleet: Any = None) -> str:
    """The full ``/metrics`` document: live registry + federated fleet
    worker series (when a coordinator is attached) + campaign
    heartbeats + warehouse rollups (each section present only when its
    source exists).  Always ends with a newline."""
    from . import registry as active_registry

    reg = registry if registry is not None else active_registry()
    lines = render_registry(reg)
    if fleet is not None:
        lines += render_fleet(fleet)
    if base:
        lines += render_heartbeats(base, now=now)
        lines += render_alerts(base, now=now)
        try:
            from . import warehouse as wmod

            wh = wmod.open_if_exists(base)
        except Exception:  # noqa: BLE001
            wh = None
        if wh is not None:
            lines += render_warehouse(wh)
    return "\n".join(lines) + "\n"
