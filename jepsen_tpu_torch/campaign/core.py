"""Campaign orchestration: spec → scheduled fleet → indexed verdicts
(the port's copy of `jepsen_tpu/campaign/core.py`).

`run_campaign` is the L6-of-L6: where `core.run` turns one test map
into one verdict, this turns a campaign spec into a fully-indexed
fleet of `core.run` invocations — expanded by `plan.expand`, placed by
`scheduler.Scheduler` (device-aware slots, retries, isolation),
recorded durably by `index.Index` as each run lands (a killed campaign
resumes where it stopped), and rolled up into a summary the CLI, the
web dashboard, and `report.render_campaign` all share.

The per-run contract matches the resilience layer's: every scheduled
run terminates with an attributable verdict (True / False / "unknown"
with an error) — a crashing workload, checker, or executor becomes an
``unknown`` record, never a campaign abort.

The port's differences: `run_campaign(..., cpu=True)` puts ``"cpu"``
into each cell's opts after `plan.expand` (beside ``"_base"``), so the
CPU choice never changes a run id; `_auto_shrink` re-raises
`KernelError` and `NoDeviceError`, so a card that cannot check makes
the cell an attributable unknown naming the error instead of a quiet
shrink failure.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

from jepsen_tpu_torch import store
from jepsen_tpu_torch.campaign import plan as plan_mod
from jepsen_tpu_torch.campaign.index import Index
from jepsen_tpu_torch.campaign.plan import RunSpec
from jepsen_tpu_torch.campaign.scheduler import Scheduler
from jepsen_tpu_torch.resilience import DEADLINE_ERROR

logger = logging.getLogger("jepsen.campaign")

__all__ = ["run_campaign", "status_campaign", "report_campaign",
           "execute_run", "index_path", "live_path", "result_flags",
           "summarize"]


def index_path(name: str, base: Optional[str] = None) -> str:
    """The campaign's ledger path: ``<store>/campaigns/<name>.jsonl``."""
    return os.path.join(base or store.BASE, "campaigns",
                        store.sanitize(name) + ".jsonl")


def live_path(name: str, base: Optional[str] = None) -> str:
    """The campaign's heartbeat state file (atomically replaced by the
    scheduler as workers pick up / finish runs): ``<store>/campaigns/
    <name>.live.json`` — the data behind the ``/campaign/<name>/live``
    dashboard."""
    return os.path.join(base or store.BASE, "campaigns",
                        store.sanitize(name) + ".live.json")


def result_flags(results: Any) -> Dict[str, Any]:
    """Scan a (possibly nested, composed-checker) results map for the
    attribution flags the index and the web badges surface: the first
    ``error`` string, any ``degraded`` stamp, and whether any level
    reported ``deadline-exceeded``."""
    out: Dict[str, Any] = {"error": None, "degraded": None,
                           "deadline": False}

    def walk(r: Any) -> None:
        if not isinstance(r, dict):
            return
        err = r.get("error")
        if isinstance(err, str) and err:
            if out["error"] is None:
                out["error"] = err
            if DEADLINE_ERROR in err:
                out["deadline"] = True
        deg = r.get("degraded")
        if deg and out["degraded"] is None:
            out["degraded"] = str(deg)
        for v in r.values():
            walk(v)

    walk(results)
    return out


def _read_telemetry(d: Optional[str]) -> Optional[Dict[str, Any]]:
    """The run dir's parsed telemetry.json, or None — read ONCE per
    record build (spans + phases + counters all come from it)."""
    if not d:
        return None
    path = os.path.join(d, "telemetry.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _spans_from_doc(doc: Optional[Dict[str, Any]],
                    cap: int = 48) -> Dict[str, float]:
    """Per-span total durations (seconds) from a run's telemetry doc —
    the material for the index's span-duration trend queries.  Missing
    or unreadable telemetry is just an empty dict."""
    if not doc:
        return {}
    out: Dict[str, float] = {}

    def walk(sp: Dict[str, Any]) -> None:
        dur = sp.get("dur_ns")
        if dur is not None:
            out[sp["name"]] = out.get(sp["name"], 0.0) + dur / 1e9
        for c in sp.get("children") or []:
            walk(c)

    for r in doc.get("spans", []):
        walk(r)
    if len(out) > cap:  # biggest spans win: the trend queries want the
        out = dict(sorted(out.items(),  # expensive stages, not leaf noise
                          key=lambda kv: -kv[1])[:cap])
    return {k: round(v, 6) for k, v in out.items()}


def _spans_from_dir(d: Optional[str], cap: int = 48) -> Dict[str, float]:
    return _spans_from_doc(_read_telemetry(d), cap)


def _phases_from_doc(doc: Optional[Dict[str, Any]],
                     cap: int = 48) -> Dict[str, Dict[str, float]]:
    """Per-span phase self-time buckets: ``{span-name:
    {bucket: seconds}}`` summed over the forest — the ledger-side half
    of the forensics parity contract (the warehouse explodes the same
    attrs into ``span_profile``; `obs diff` must reach one verdict from
    either)."""
    if not doc:
        return {}
    from jepsen_tpu_torch.telemetry import PHASE_BUCKETS

    out: Dict[str, Dict[str, float]] = {}

    def walk(sp: Dict[str, Any]) -> None:
        attrs = sp.get("attrs") or {}
        for b in PHASE_BUCKETS:
            v = attrs.get(b)
            if isinstance(v, (int, float)) and v:
                cell = out.setdefault(sp["name"], {})
                cell[b] = cell.get(b, 0.0) + float(v)
        for c in sp.get("children") or []:
            walk(c)

    for r in doc.get("spans", []):
        walk(r)
    if len(out) > cap:
        out = dict(sorted(
            out.items(),
            key=lambda kv: -sum(kv[1].values()))[:cap])
    return {name: {b: round(v, 6) for b, v in cell.items()}
            for name, cell in out.items()}


#: counters whose per-run deltas the forensics report attributes a
#: regression to (compile misses, retries, fallbacks, anomalies) —
#: allowlisted so index records stay small
_FORENSIC_COUNTERS = ("compile-cache-miss", "resilience-retries",
                      "resilience-fallbacks", "resilience-env-anomalies",
                      "scheduler-requeues")


def _counters_from_doc(doc: Optional[Dict[str, Any]]
                       ) -> Dict[str, float]:
    """Allowlisted counter totals (plus sweep-dispatch counts) from the
    run's metric snapshot, keyed ``name{k=v,...}`` so label-level deltas
    ("compile-cache-miss{site=elle.infer} 0→14") survive the ledger."""
    if not doc:
        return {}
    m = doc.get("metrics") or {}
    out: Dict[str, float] = {}
    for c in m.get("counters") or []:
        name = c.get("name")
        if name not in _FORENSIC_COUNTERS or not c.get("value"):
            continue
        lbl = ",".join(f"{k}={v}" for k, v in
                       sorted((c.get("labels") or {}).items()))
        out[f"{name}{{{lbl}}}" if lbl else name] = float(c["value"])
    for h in m.get("histograms") or []:
        if h.get("name") == "verifier-sweep-s" and h.get("count"):
            out["verifier-sweeps"] = (
                out.get("verifier-sweeps", 0.0) + float(h["count"]))
    return out


def execute_run(rs: RunSpec, base: str) -> Dict[str, Any]:
    """Run one campaign cell end to end and build its index record.
    Exceptions out of `core.run` (setup/workload crashes — checker
    crashes are already absorbed by `check_safe`) PROPAGATE: the
    scheduler owns the retry policy and converts whatever survives its
    retries into the attributable ``unknown`` crash record — absorbing
    them here would silently disable those retries."""
    from jepsen_tpu_torch import core as jcore

    t0 = time.monotonic()
    test = plan_mod.build_test(rs, base)
    done = jcore.run(test)
    results = done.get("results") or {}
    flags = result_flags(results)
    d = store.test_dir(done)
    rel = os.path.relpath(d, base)
    try:
        ops = len(done.get("history") or ())
    except TypeError:
        ops = 0
    rec = {
        "run": rs.run_id, "key": rs.key, "campaign": rs.campaign,
        "workload": rs.workload_label, "fault": rs.fault_label,
        "seed": rs.seed,
        # the distributed trace id: derived from the stable
        # run id, so a lease-lapse re-execution's record carries the
        # same trace as the attempt it replaced
        "trace": test.get("trace-id"),
        "valid?": results.get("valid?", "unknown"),
        "error": flags["error"],
        "degraded": flags["degraded"],
        "deadline": flags["deadline"],
        "dir": rel,
        "ops": ops,
        "wall_s": round(time.monotonic() - t0, 3),
    }
    doc = _read_telemetry(d)
    rec["spans"] = _spans_from_doc(doc)
    phases = _phases_from_doc(doc)
    if phases:
        rec["phases"] = phases
    counters = _counters_from_doc(doc)
    if counters:
        rec["counters"] = counters
    if rs.opts.get("nemesis-windows"):
        # the installed window set's identity: what the soak compares
        # between a fleet-distributed cell and its single-process twin,
        # straight off the index record
        rec["windows-digest"] = plan_mod.windows_digest(
            rs.opts["nemesis-windows"])
    if rec["valid?"] is False and rs.opts.get("shrink"):
        rec["witness"] = _auto_shrink(rs, done, d)
    return rec


def _auto_shrink(rs: RunSpec, done: dict, d: str) -> Optional[dict]:
    """The campaign auto-shrink hook (spec opts ``"shrink": true`` or a
    knob dict): delta-debug an invalid cell's history right after the
    run, while its checker object is still live, and index the witness
    summary alongside the verdict.  A failed shrink never fails the
    cell — the verdict already stands — unless the card could not check
    (`KernelError`, `NoDeviceError`): that propagates to the scheduler,
    which indexes the cell as an unknown naming the error."""
    from jepsen_tpu_torch import minimize
    from jepsen_tpu_torch.backend import NoDeviceError
    from jepsen_tpu_torch.ops.kernels import KernelError

    knobs = rs.opts.get("shrink")
    knobs = dict(knobs) if isinstance(knobs, dict) else {}
    try:
        s = minimize.shrink(
            done, checker=done.get("checker"),
            rounds=knobs.get("rounds"),
            # bounded by default: ddmin generates exactly the
            # adversarial sub-histories per-probe deadlines exist for,
            # and a thread-executor campaign has no hard kill
            probe_deadline_s=knobs.get("probe-deadline", 30.0),
            workers=int(knobs.get("workers", 2)),
            device_slots=int(knobs.get("device-slots", 1)),
            host_oracle=bool(knobs.get("host-oracle", True)),
            device="cpu" if rs.opts.get("cpu") else None)
    except (KernelError, NoDeviceError):
        raise
    except Exception as e:  # noqa: BLE001 — triage must not fail the run
        logger.warning("auto-shrink of %s failed: %s", rs.run_id, e)
        return {"error": f"{type(e).__name__}: {e}"}
    if s.get("error"):
        return {"error": s["error"]}
    out = {"ops": s.get("ops"), "source-ops": s.get("source-ops"),
           "digest": s.get("digest"),
           "anomaly-types": s.get("anomaly-types"),
           "probes": s.get("probes"), "cached": bool(s.get("cached"))}
    fw = s.get("fault-windows")
    if fw:
        # the surviving window identities ride the index record too, so
        # cross-host witness comparisons (distributed vs single-process
        # of the same spec + seed) need only the campaign ledger — the
        # full descriptors stay in witness.json
        out["fault-windows"] = [
            {k: w.get(k) for k in ("f", "pos", "digest", "fault",
                                   "host", "kept") if w.get(k)
             is not None} for w in fw]
    return out


def summarize(spec: Union[str, dict], base: Optional[str] = None,
              *, executed: int = 0, skipped: int = 0,
              wall_s: float = 0.0, idx: Optional[Index] = None
              ) -> Dict[str, Any]:
    """Build the suite rollup for a spec from its index: the one
    summary shape `report.render_campaign`, the CLI, and the web
    dashboard consume.  Pass `idx` to reuse an already-loaded Index
    (run_campaign does) instead of re-parsing the ledger."""
    spec = plan_mod.load_spec(spec)
    base = base or store.BASE
    specs = plan_mod.expand(spec)
    if idx is None:
        idx = Index(index_path(spec["name"], base))
    rows: List[Dict[str, Any]] = []
    for rs in specs:
        rec = idx.latest(rs.run_id)
        row = {"run": rs.run_id, "key": rs.key,
               "workload": rs.workload_label, "fault": rs.fault_label,
               "seed": rs.seed, "device": rs.device}
        if rec is not None:
            row.update({k: rec.get(k) for k in
                        ("valid?", "error", "degraded", "deadline",
                         "dir", "ops", "wall_s", "gen", "witness")})
        else:
            row["valid?"] = None  # not yet run
        rows.append(row)
    flips = idx.flips()
    return {
        "campaign": spec["name"],
        "spec-digest": plan_mod.spec_digest(spec),
        "index": idx.path,
        "total": len(specs),
        "executed": executed,
        "skipped": skipped,
        "pending": sum(1 for r in rows if r["valid?"] is None),
        "wall_s": round(wall_s, 3),
        "counts": idx.verdict_counts(runs=[rs.run_id for rs in specs]),
        "seeds": sorted({rs.seed for rs in specs}),
        "rows": rows,
        "regressions": [f for f in flips if f["regression"]],
        "flips": flips,
        "span-stats": idx.span_stats(),
    }


def run_campaign(spec: Union[str, dict], base: Optional[str] = None, *,
                 workers: int = 2, device_slots: int = 1,
                 executor: str = "thread", rerun: bool = False,
                 run_deadline_s: Optional[float] = None,
                 retry=None, cpu: bool = False) -> Dict[str, Any]:
    """Run a campaign: expand, skip already-indexed runs (unless
    `rerun`), schedule the rest over `workers`, index every verdict as
    it lands, and return the suite summary.  `cpu` runs the cells'
    checkers on the CPU instead of the card."""
    spec = plan_mod.load_spec(spec)
    base = base or store.BASE
    specs = plan_mod.expand(spec)
    idx = Index(index_path(spec["name"], base))
    done = set() if rerun else idx.completed_ids()
    todo = [rs for rs in specs if rs.run_id not in done]
    gen = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    digest = plan_mod.spec_digest(spec)
    logger.info("campaign %s: %d runs (%d already indexed), %d workers, "
                "%s executor", spec["name"], len(specs),
                len(specs) - len(todo), workers, executor)
    for rs in todo:
        # a hard per-run wall also bounds the checkers cooperatively
        if run_deadline_s and rs.opts.get("checker-time-limit") is None:
            rs.opts["checker-time-limit"] = run_deadline_s
        rs.opts["_base"] = base  # the subprocess runner needs the store
        if cpu:
            rs.opts["cpu"] = True  # after expand: the run id is the same

    def on_result(rec: Dict[str, Any]) -> None:
        rec["gen"] = gen
        rec["spec"] = digest
        idx.append(rec)
        logger.info("campaign %s: %s -> valid? = %s", spec["name"],
                    rec.get("run"), rec.get("valid?"))

    t0 = time.monotonic()
    # heartbeat routing: when a fleet coordinator
    # URL is configured (spec opts "coordinator", or the
    # JEPSEN_COORDINATOR env for whole-process routing), progress is
    # PUSHED over HTTP and the coordinator's single Heartbeat writer
    # renders the live.json; the file-only path stays the fallback —
    # both produce the same /campaign/<name>/live shape.
    coord_url = spec["opts"].get("coordinator") or \
        os.environ.get("JEPSEN_COORDINATOR", "").strip()
    if coord_url:
        from jepsen_tpu_torch.telemetry import HttpHeartbeat

        hb = HttpHeartbeat(coord_url, campaign=spec["name"],
                           total=len(specs),
                           done=len(specs) - len(todo))
    else:
        from jepsen_tpu_torch.telemetry import Heartbeat

        hb = Heartbeat(live_path(spec["name"], base),
                       campaign=spec["name"],
                       total=len(specs), done=len(specs) - len(todo))
    sched = Scheduler(workers, device_slots=device_slots,
                      executor=executor, retry=retry,
                      run_deadline_s=run_deadline_s, heartbeat=hb)
    sched.run(todo, lambda rs: execute_run(rs, base),
              on_result=on_result)
    # normal completion only: an interrupted fleet must leave its
    # in-flight worker state in live.json for the /live post-mortem
    hb.close()
    # keep an existing warehouse warm: ingest the records this fleet
    # just appended (cursor-incremental, cheap), so summarize() and the
    # next dashboard render take the SQL fast path.  No warehouse on
    # this store -> nothing to do (cli obs ingest builds one).  The
    # warehouse is a derived index with no device path: its failure is
    # logged and the ledger stays the source of truth.
    try:
        from jepsen_tpu_torch.telemetry import warehouse as wmod

        wh = wmod.open_if_exists(base)
        if wh is not None:
            wh.ingest_ledger(idx.path, base)
    except Exception as e:  # noqa: BLE001 — derived index only
        logger.warning("warehouse ingest after campaign failed: %s", e)
    return summarize(spec, base, executed=len(todo),
                     skipped=len(specs) - len(todo),
                     wall_s=time.monotonic() - t0, idx=idx)


def status_campaign(spec: Union[str, dict], base: Optional[str] = None
                    ) -> Dict[str, Any]:
    """Cheap index-only view: how much of the spec has verdicts."""
    s = summarize(spec, base)
    return {k: s[k] for k in ("campaign", "index", "total", "pending",
                              "counts")}


def report_campaign(spec: Union[str, dict], base: Optional[str] = None
                    ) -> str:
    """The suite-level text rollup (grid + aggregates + regressions)."""
    from jepsen_tpu_torch import report

    return report.render_campaign(summarize(spec, base))
