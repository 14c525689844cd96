"""The watchtower: a declarative SLO/alert engine (the port's copy of
`jepsen_tpu/telemetry/alerts.py`).

Every health signal the fleet already records — verdict freshness,
claim-latency p95, worker liveness, quarantine rate, journal growth,
RSS/device watermarks, compile-cache fallthrough — was only visible to
a human staring at ``/fleet`` or ``/metrics``.  This module makes the
store *watch itself*: a rule pack evaluated each autopilot/coordinator
tick against three signal sources, with Prometheus-style alert state
on the exposition and durable crash-safe notification bookkeeping.

Signal sources (cheap by construction — an evaluation tick must cost
O(rollup rows), never O(runs)):

- the **live registry** (``gauge:<name>`` / ``counter:<name>``,
  summed across label sets);
- **campaign heartbeat files** (``heartbeat:max-age-s`` and per-
  campaign ``heartbeat:<name>:age-s``/``done``/``total``);
- the **autopilot journal** (``autopilot:gate-regression``,
  ``autopilot:gate-rc2-streak``, ``autopilot:quarantined-active``);
- **store growth** (``store:fleet-bytes``);
- **warehouse rollups** (``warehouse:flip-regressions``,
  ``warehouse:span-p95-s:<name>`` — flip_rollup/span_rollup tables
  ONLY; the per-record tables are never touched).

Rule kinds:

``threshold``
    breach when the signal exists and ``value <op> rule.value``.
``absence``
    breach when the signal is missing from the snapshot.
``freshness``
    the signal is an age in seconds; breach when it is PRESENT and
    older than ``rule.value``.  A missing signal is quiet — an idle
    store with no campaigns must not page; pair with an ``absence``
    rule when the signal is required to exist.
``rate``
    breach when the signal's rate of change over ``window_s``
    satisfies ``<op> rule.value`` (per second).  The sample ring is
    in-memory derived state — never journaled.

State machine (per rule): ``inactive → pending → firing → resolved``.
A breach makes the rule pending; once it has held for ``for_s`` the
rule fires (``for_s == 0`` fires in the same tick — pending and firing
are both journaled, in order).  A clean tick resolves a pending or
firing rule; only resolve-from-firing notifies.

Durability is the ``AutopilotJournal`` discipline verbatim: an
append-only fsync'd jsonl ledger at ``<store>/alerts.jsonl``, torn
final line ignored on replay and healed before the first append,
``digest()`` pins the replayed state so kill -9 tests can compare
independent replays.  Notification is at-most-once: the ``notify``
INTENT is journaled *before* any sink send, so a crash between intent
and send loses at most one delivery and a replay never re-sends.
Sink results are a digest-excluded audit trail (same rule as the
autopilot's scale events).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Rule", "AlertJournal", "AlertEngine", "FileSink",
           "WebhookSink", "alerts_path", "stock_rules", "load_rules",
           "load_config", "collect_signals", "STOCK_PACK"]

ALERTS_JSONL = "alerts.jsonl"

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}

_KINDS = ("threshold", "absence", "freshness", "rate")
_SEVERITIES = ("page", "warn", "info")


def alerts_path(base: str) -> str:
    """The journal lives at the store root — NOT under ``fleet/``,
    whose ``*.jsonl`` files the warehouse ingests as work ledgers."""
    return os.path.join(base, ALERTS_JSONL)


class Rule:
    """One declarative alert rule.  Plain data — ``from_dict`` /
    ``to_dict`` round-trip so packs load from JSON (specs/ ships an
    example)."""

    def __init__(self, name: str, *, kind: str = "threshold",
                 severity: str = "warn", signal: str = "",
                 op: str = ">", value: float = 0.0,
                 for_s: float = 0.0, window_s: float = 60.0,
                 description: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"unknown rule kind {kind!r}")
        if severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}")
        self.name = str(name)
        self.kind = kind
        self.severity = severity
        self.signal = str(signal)
        self.op = op
        self.value = float(value)
        self.for_s = float(for_s)
        self.window_s = float(window_s)
        self.description = str(description)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "severity": self.severity, "signal": self.signal,
                "op": self.op, "value": self.value,
                "for_s": self.for_s, "window_s": self.window_s,
                "description": self.description}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Rule":
        # `for:`/`window:` are the Prometheus-style spellings rule
        # files naturally use; the `_s`-suffixed forms are the
        # canonical to_dict() output — accept both
        return cls(d["name"],
                   kind=d.get("kind", "threshold"),
                   severity=d.get("severity", "warn"),
                   signal=d.get("signal", ""),
                   op=d.get("op", ">"),
                   value=d.get("value", 0.0),
                   for_s=d.get("for_s", d.get("for", 0.0)),
                   window_s=d.get("window_s", d.get("window", 60.0)),
                   description=d.get("description", ""))


#: The stock pack: the fleet's known failure smells, one rule each.
STOCK_PACK: Tuple[Dict[str, Any], ...] = (
    {"name": "campaign-heartbeat-stale", "kind": "freshness",
     "severity": "page", "signal": "heartbeat:max-age-s",
     "op": ">", "value": 300.0, "for_s": 0.0,
     "description": "verifier verdict freshness: a live campaign's "
                    "heartbeat has not been written for 5 minutes"},
    {"name": "fleet-claim-latency-p95-high", "kind": "threshold",
     "severity": "warn", "signal": "gauge:fleet-claim-latency-p95-s",
     "op": ">", "value": 5.0, "for_s": 10.0,
     "description": "workers wait too long between enqueue and claim"},
    {"name": "fleet-workers-alive-low", "kind": "threshold",
     "severity": "page", "signal": "gauge:fleet-workers-alive",
     "op": "<", "value": 1.0, "for_s": 5.0,
     "description": "worker liveness dropped to zero with work queued"},
    {"name": "quarantine-storm", "kind": "rate",
     "severity": "page", "signal": "gauge:fleet-quarantined-cells",
     "op": ">", "value": 0.2, "window_s": 60.0,
     "description": "quarantines accruing faster than one per 5s "
                    "sustained over a minute — gate or fleet sickness, "
                    "not a real regression"},
    {"name": "autopilot-gate-regression", "kind": "threshold",
     "severity": "page", "signal": "autopilot:gate-regression",
     "op": ">=", "value": 1.0, "for_s": 0.0,
     "description": "the latest closed generation's gate found a "
                    "perf regression (rc 1)"},
    {"name": "autopilot-gate-rc2-streak", "kind": "threshold",
     "severity": "warn", "signal": "autopilot:gate-rc2-streak",
     "op": ">=", "value": 3.0, "for_s": 0.0,
     "description": "three consecutive generations closed "
                    "inconclusive — the gate is starved of data"},
    {"name": "fleet-journal-bytes-growth", "kind": "rate",
     "severity": "warn", "signal": "store:fleet-bytes",
     "op": ">", "value": 1e6, "window_s": 60.0,
     "description": "fleet ledgers/journals growing >1MB/s sustained"},
    {"name": "worker-rss-watermark", "kind": "threshold",
     "severity": "warn", "signal": "gauge:worker-rss-peak-bytes",
     "op": ">", "value": 4e9, "for_s": 0.0,
     "description": "a worker's peak RSS crossed the 4GB watermark"},
    {"name": "compile-cache-fallthrough-rate", "kind": "rate",
     "severity": "warn", "signal": "counter:compile-cache-fallthrough",
     "op": ">", "value": 1.0, "window_s": 60.0,
     "description": "AOT cache misses falling through to online "
                    "compile faster than 1/s — pre-warm drifted from "
                    "the plan"},
)


def stock_rules() -> List[Rule]:
    return [Rule.from_dict(d) for d in STOCK_PACK]


def load_rules(doc: Any) -> List[Rule]:
    """Rules from a parsed JSON doc: either a bare list of rule dicts
    or ``{"rules": [...]}``."""
    rows = doc.get("rules") if isinstance(doc, dict) else doc
    return [Rule.from_dict(d) for d in (rows or [])]


def load_config(base: str) -> Tuple[List[Rule], List[Any]]:
    """Store-local config: ``<store>/alerts.json`` may override the
    rule pack and declare sinks (``{"rules": [...], "sinks":
    [{"file": path}, {"webhook": url}]}``).  Absent or unreadable →
    stock pack, no sinks."""
    path = os.path.join(base, "alerts.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return stock_rules(), []
    if isinstance(doc, list):
        return (load_rules(doc) or stock_rules()), []
    if not isinstance(doc, dict):
        return stock_rules(), []
    rules = load_rules(doc) if doc.get("rules") else stock_rules()
    sinks: List[Any] = []
    for s in doc.get("sinks") or []:
        if not isinstance(s, dict):
            continue
        if s.get("file"):
            p = s["file"]
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            sinks.append(FileSink(p))
        elif s.get("webhook"):
            sinks.append(WebhookSink(s["webhook"],
                                     timeout=s.get("timeout", 3.0)))
    return rules, sinks


# -- sinks -------------------------------------------------------------------


class FileSink:
    """Append-one-json-line-per-notification sink — the soak test's
    duplicate counter and the zero-dep default."""

    def __init__(self, path: str):
        self.path = path

    def send(self, payload: Dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(payload, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def __repr__(self) -> str:
        return f"FileSink({self.path})"


class WebhookSink:
    """POST the notification JSON to a URL (stdlib urllib — zero
    deps).  Failures raise; the engine audits and moves on."""

    def __init__(self, url: str, timeout: float = 3.0):
        self.url = url
        self.timeout = float(timeout)

    def send(self, payload: Dict[str, Any]) -> None:
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()

    def __repr__(self) -> str:
        return f"WebhookSink({self.url})"


# -- journal -----------------------------------------------------------------


class AlertJournal:
    """Durable alert state: the exact ``AutopilotJournal`` /
    ``queue.WorkQueue`` discipline — in-memory state is a pure
    function of the event sequence, a torn final line (crash
    mid-append) is ignored on replay and healed by the writer before
    its first append, and ``digest`` pins the replayed state.

    Events: ``state`` (a rule's transition — pending/firing/resolved,
    each bumping the rule's transition ``seq``), ``notify`` (the
    at-most-once delivery INTENT, written before any sink send),
    ``notify-result`` (per-sink delivery audit — derived telemetry,
    digest-excluded, same rule as the autopilot's scale events)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        #: rule -> {state, since, value, severity, seq}
        self.states: Dict[str, Dict[str, Any]] = {}
        #: rule -> seq of the last journaled notify INTENT
        self.notified: Dict[str, int] = {}
        #: digest-excluded audit counters
        self.sends_ok = 0
        self.sends_failed = 0
        self._good_bytes = 0
        self._healed = False
        self._load()

    # -- replay --------------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail: crash mid-append — ignore
            try:
                ev = json.loads(line.decode("utf-8"))
            except ValueError:
                break
            self._apply(ev)
            good += len(line)
        self._good_bytes = good

    def _apply(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("ev")
        if kind == "state":
            rule = str(ev.get("rule"))
            st = self.states.get(rule) or {"seq": 0}
            st["state"] = ev.get("state")
            st["since"] = ev.get("at")
            st["value"] = ev.get("value")
            st["severity"] = ev.get("severity")
            st["seq"] = int(st.get("seq") or 0) + 1
            self.states[rule] = st
        elif kind == "notify":
            self.notified[str(ev.get("rule"))] = int(ev.get("seq") or 0)
        elif kind == "notify-result":
            if ev.get("ok"):
                self.sends_ok += 1
            else:
                self.sends_failed += 1

    # -- append --------------------------------------------------------------

    def _event(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        ev = dict(ev)
        ev["ts"] = round(time.time(), 3)
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            if not self._healed:
                # only the writer heals: truncate a torn tail right
                # before the first append so readers of a crashed
                # journal replay the same prefix we extend
                if os.path.exists(self.path) and \
                        os.path.getsize(self.path) > self._good_bytes:
                    with open(self.path, "rb+") as f:
                        f.truncate(self._good_bytes)
                self._healed = True
            with open(self.path, "ab") as f:
                f.write((json.dumps(ev, sort_keys=True) + "\n")
                        .encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            self._apply(ev)
        return ev

    def transition(self, rule: Rule, state: str, value: Any, *,
                   at: float) -> None:
        self._event({"ev": "state", "rule": rule.name, "state": state,
                     "value": value, "severity": rule.severity,
                     "at": round(float(at), 3)})

    def notify(self, rule: str, state: str, seq: int) -> None:
        """The at-most-once commit point: journaled BEFORE the send."""
        self._event({"ev": "notify", "rule": rule, "state": state,
                     "seq": int(seq)})

    def notify_result(self, rule: str, sink: str, ok: bool,
                      error: Optional[str] = None) -> None:
        self._event({"ev": "notify-result", "rule": rule,
                     "sink": sink, "ok": bool(ok), "error": error})

    # -- state ---------------------------------------------------------------

    def active(self) -> List[Dict[str, Any]]:
        """Pending + firing rules (the ``ALERTS`` exposition set)."""
        with self._lock:
            return sorted(
                (dict(v, rule=k) for k, v in self.states.items()
                 if v.get("state") in ("pending", "firing")),
                key=lambda d: d["rule"])

    def digest(self) -> str:
        """Replayed-state digest (notify-result audit counters
        excluded — they are derived telemetry, same rule as the
        autopilot's scale events)."""
        with self._lock:
            state = {
                "states": sorted(
                    (k, v.get("state"), v.get("since"), v.get("seq"),
                     v.get("severity"))
                    for k, v in self.states.items()),
                "notified": sorted(self.notified.items()),
            }
        blob = json.dumps(state, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


# -- signal collection -------------------------------------------------------


def collect_signals(base: Optional[str] = None, *,
                    registry: Any = None,
                    autopilot: Any = None,
                    warehouse: Any = None,
                    now: Optional[float] = None) -> Dict[str, float]:
    """One flat snapshot of every signal the rule selectors can
    reference.  Each source is best-effort and independently cheap;
    the warehouse leg reads ROLLUP tables only (``flip_rollup``,
    ``span_rollup``) so a 100k-run store costs the same tick as a
    100-run one."""
    now = time.time() if now is None else now
    out: Dict[str, float] = {}
    _registry_signals(out, registry)
    if base:
        _heartbeat_signals(out, base, now)
        _store_signals(out, base)
    _autopilot_signals(out, autopilot)
    _warehouse_signals(out, warehouse, base)
    return out


def _registry_signals(out: Dict[str, float], registry: Any) -> None:
    if registry is None:
        from jepsen_tpu_torch import telemetry

        registry = telemetry.registry()
    try:
        snap = registry.snapshot()
    except Exception:  # noqa: BLE001 — a source never kills the tick
        return
    for g in snap.get("gauges") or []:
        v = g.get("value")
        if isinstance(v, (int, float)):
            key = f"gauge:{g['name']}"
            out[key] = out.get(key, 0.0) + float(v)
    for c in snap.get("counters") or []:
        v = c.get("value")
        if isinstance(v, (int, float)):
            key = f"counter:{c['name']}"
            out[key] = out.get(key, 0.0) + float(v)


def _heartbeat_signals(out: Dict[str, float], base: str,
                       now: float) -> None:
    cdir = os.path.join(base, "campaigns")
    if not os.path.isdir(cdir):
        return
    max_age = None
    try:
        names = sorted(os.listdir(cdir))
    except OSError:
        return
    for fn in names:
        if not fn.endswith(".live.json"):
            continue
        try:
            with open(os.path.join(cdir, fn)) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(hb, dict):
            continue
        name = hb.get("campaign") or fn[:-len(".live.json")]
        upd = hb.get("updated")
        if isinstance(upd, (int, float)):
            age = max(0.0, round(now - upd, 3))
            out[f"heartbeat:{name}:age-s"] = age
            if not hb.get("finished") and \
                    (max_age is None or age > max_age):
                max_age = age
        for k in ("done", "total"):
            v = hb.get(k)
            if isinstance(v, (int, float)):
                out[f"heartbeat:{name}:{k}"] = float(v)
        out[f"heartbeat:{name}:finished"] = \
            1.0 if hb.get("finished") else 0.0
    if max_age is not None:
        out["heartbeat:max-age-s"] = max_age


def _store_signals(out: Dict[str, float], base: str) -> None:
    """Growth watermarks: total bytes under ``<store>/fleet/`` (work
    ledgers, autopilot journals, staging) + the alerts journal."""
    total = 0
    fdir = os.path.join(base, "fleet")
    if os.path.isdir(fdir):
        for root, _dirs, files in os.walk(fdir):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(root, fn))
                except OSError:
                    pass
    out["store:fleet-bytes"] = float(total)


def _autopilot_signals(out: Dict[str, float], autopilot: Any) -> None:
    """Gate state straight off the (already in-memory) journal:
    regression in the latest closed generation, the trailing rc-2
    streak, and the active-quarantine census."""
    journal = getattr(autopilot, "journal", autopilot)
    if journal is None or not hasattr(journal, "gens"):
        return
    try:
        closed = [l for l in journal.order
                  if journal.gens[l].get("closed")]
        regression = 0.0
        streak = 0.0
        if closed:
            last = journal.gens[closed[-1]].get("verdicts") or []
            regression = 1.0 if any(
                v.get("rc") == 1 for v in last) else 0.0
            for l in reversed(closed):
                vs = journal.gens[l].get("verdicts") or []
                if vs and all(v.get("rc") == 2 for v in vs):
                    streak += 1
                else:
                    break
        out["autopilot:gate-regression"] = regression
        out["autopilot:gate-rc2-streak"] = streak
        out["autopilot:quarantined-active"] = float(sum(
            1 for v in journal.quarantined.values()
            if "paroled-gen" not in v))
    except Exception:  # noqa: BLE001 — a source never kills the tick
        pass


def _warehouse_signals(out: Dict[str, float], warehouse: Any,
                       base: Optional[str]) -> None:
    """Rollup-table-only aggregates.  ``warehouse`` may be a
    Warehouse instance; when None and a store warehouse exists it is
    opened read-only.  NEVER queries campaign_records/record_spans —
    the O(rollup rows) pin."""
    wh = warehouse
    if wh is None and base:
        try:
            from . import warehouse as wmod

            wh = wmod.open_if_exists(base)
        except Exception:  # noqa: BLE001
            return
    if wh is None:
        return
    try:
        sig = wh.alert_signals()
    except Exception:  # noqa: BLE001 — a source never kills the tick
        return
    for k, v in (sig or {}).items():
        if isinstance(v, (int, float)):
            out[f"warehouse:{k}"] = float(v)


# -- engine ------------------------------------------------------------------


class AlertEngine:
    """Evaluate the rule pack against a signal snapshot, drive the
    per-rule state machine through the journal, and deliver
    at-most-once notifications through ``device_call``-guarded
    sinks."""

    def __init__(self, base: str, *, rules: Optional[List[Rule]] = None,
                 sinks: Optional[List[Any]] = None,
                 journal: Optional[AlertJournal] = None):
        self.base = base
        if rules is None and sinks is None:
            rules, sinks = load_config(base)
        self.rules = list(rules) if rules is not None else stock_rules()
        self.sinks = list(sinks or [])
        self.journal = journal or AlertJournal(alerts_path(base))
        #: rule -> [(ts, value)] sample ring for rate rules — derived
        #: state, deliberately NOT journaled (a replay restarts the
        #: window; a rate alert needs window_s of post-restart data
        #: before it can re-breach, which is the conservative side)
        self._samples: Dict[str, List[Tuple[float, float]]] = {}

    # -- breach tests --------------------------------------------------------

    def _breach(self, rule: Rule, value: Optional[float],
                now: float) -> bool:
        if rule.kind == "absence":
            return value is None
        if rule.kind == "freshness":
            return value is not None and _OPS[">"](value, rule.value)
        if rule.kind == "rate":
            return self._rate_breach(rule, value, now)
        if value is None:
            return False
        return _OPS[rule.op](float(value), rule.value)

    def _rate_breach(self, rule: Rule, value: Optional[float],
                     now: float) -> bool:
        if value is None:
            return False
        buf = self._samples.setdefault(rule.name, [])
        buf.append((now, float(value)))
        horizon = now - max(rule.window_s, 1e-9)
        while len(buf) > 1 and buf[1][0] <= horizon:
            buf.pop(0)
        if buf[0][0] > horizon or len(buf) < 2:
            return False  # window not yet covered — no verdict
        dt = buf[-1][0] - buf[0][0]
        if dt <= 0:
            return False
        rate = (buf[-1][1] - buf[0][1]) / dt
        return _OPS[rule.op](rate, rule.value)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, signals: Optional[Dict[str, float]] = None, *,
                 now: Optional[float] = None,
                 autopilot: Any = None,
                 warehouse: Any = None) -> Dict[str, Any]:
        """One tick: snapshot signals (unless given), run every rule
        through the state machine, notify transitions.  Returns the
        status doc."""
        now = time.time() if now is None else now
        if signals is None:
            signals = collect_signals(self.base, autopilot=autopilot,
                                      warehouse=warehouse, now=now)
        for rule in self.rules:
            value = signals.get(rule.signal)
            breach = self._breach(rule, value, now)
            st = self.journal.states.get(rule.name) or {}
            state = st.get("state") or "inactive"
            if breach:
                if state in ("inactive", "resolved"):
                    self.journal.transition(rule, "pending", value,
                                            at=now)
                    state = "pending"
                if state == "pending":
                    since = self.journal.states[rule.name].get("since")
                    if since is None or now - since >= rule.for_s:
                        self.journal.transition(rule, "firing", value,
                                                at=now)
                        self._notify(rule, "firing", value)
            elif state in ("pending", "firing"):
                self.journal.transition(rule, "resolved", value,
                                        at=now)
                if state == "firing":
                    self._notify(rule, "resolved", value)
        return self.status_doc()

    def _notify(self, rule: Rule, state: str,
                value: Optional[float]) -> None:
        """At-most-once delivery: the journal INTENT is the commit
        point (a crash after intent, before send, drops the delivery
        rather than ever duplicating it; replay sees the intent's seq
        and skips)."""
        seq = int(self.journal.states[rule.name].get("seq") or 0)
        if self.journal.notified.get(rule.name) == seq:
            return  # intent already journaled for this transition
        self.journal.notify(rule.name, state, seq)
        if not self.sinks:
            return
        payload = {"alertname": rule.name, "state": state,
                   "severity": rule.severity, "signal": rule.signal,
                   "value": value, "description": rule.description}
        from jepsen_tpu_torch import resilience

        for sink in self.sinks:
            try:
                resilience.device_call("alerts.notify", sink.send,
                                       payload)
            except Exception as e:  # noqa: BLE001 — audit, move on
                self.journal.notify_result(
                    rule.name, repr(sink), False,
                    error=f"{type(e).__name__}: {e}")
            else:
                self.journal.notify_result(rule.name, repr(sink), True)

    # -- reporting -----------------------------------------------------------

    def status_doc(self) -> Dict[str, Any]:
        active = self.journal.active()
        return {
            "rules": len(self.rules),
            "firing": [d["rule"] for d in active
                       if d.get("state") == "firing"],
            "pending": [d["rule"] for d in active
                        if d.get("state") == "pending"],
            "active": active,
            "sends-ok": self.journal.sends_ok,
            "sends-failed": self.journal.sends_failed,
            "digest": self.journal.digest(),
        }
