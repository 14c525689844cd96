"""Test orchestration — the spine (the port's copy of `jepsen_tpu/core.py`).

Equivalent of the reference's `jepsen/src/jepsen/core.clj` (SURVEY.md §2.1,
§3.1): :func:`run` takes a test map and returns it completed with
``history`` and ``results``, wiring every layer in order:

    logging → node sessions → OS setup → DB setup → nemesis setup
    → generator interpreter (the workload)
    → nemesis/DB teardown → log download
    → store.save_0 (history persisted BEFORE analysis)
    → checker.check_safe → store.save_1

Also :func:`analyze`, the re-check entry point for a stored run (reference
`jepsen.core/analyze!`-style path), and :func:`noop_test`, the base test
map everything merges into (reference `jepsen.tests/noop-test`).

The checking step is where the card comes in: checkers hand the history
to the device pipeline (`jepsen_tpu_torch.checkers.elle.*`); everything
before it is host-side orchestration, exactly as in the reference where
L2–L3 are pure and L1/L4b are imperative.

Telemetry (``"telemetry"`` in the test map, ``telemetry.enable()`` or
``JEPSEN_TELEMETRY``) gives the run one span per phase and a flight
recorder; ``"profile-dir"`` adds a ``torch.profiler`` trace; ``"live-check"``
streams the history into a verifier session while the workload runs
(``{"inproc": true}``; a URL target waits for the web server's ingest
routes).
"""

from __future__ import annotations

import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

from . import db as db_proto
from . import net as net_proto
from . import os_setup, store, telemetry
from .checkers import api as checker_api
from .control import api as control
from .control.core import Remote, Session
from .generator import core as gen_core
from .generator import interpreter
from .history.ops import History
from .utils import profiling

logger = logging.getLogger("jepsen.core")


def noop_test(**overrides) -> dict:
    """The base test map (reference `jepsen.tests/noop-test`): runs no ops
    against no cluster and is always valid.  Merge overrides in."""
    t: Dict[str, Any] = {
        "name": "noop",
        "nodes": [],
        "concurrency": 1,
        "os": os_setup.noop,
        "db": db_proto.Noop(),
        "net": net_proto.noop,
        "client": None,
        "nemesis": None,
        "generator": None,
        "checker": None,
        "start-time": None,
    }
    t.update(overrides)
    return t


def _start_logging(test: dict) -> Optional[logging.Handler]:
    """Write the run log into the store dir (reference
    `store/start-logging!` → `jepsen.log`)."""
    try:
        path = store.path(test, "jepsen.log")
    except OSError:
        return None
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    h.setLevel(logging.INFO)
    root = logging.getLogger("jepsen")
    root.addHandler(h)
    if root.level == logging.NOTSET or root.level > logging.INFO:
        root.setLevel(logging.INFO)
    return h


def _stop_logging(h: Optional[logging.Handler]) -> None:
    if h is not None:
        logging.getLogger("jepsen").removeHandler(h)
        h.close()


def _open_sessions(test: dict) -> Dict[str, Session]:
    remote: Optional[Remote] = test.get("remote")
    if remote is None or not test.get("nodes"):
        return {}
    opts = control._node_opts(test)
    return {n: remote.connect(n, opts) for n in test["nodes"]}


def _close_sessions(sessions: Dict[str, Session]) -> None:
    for s in sessions.values():
        try:
            s.disconnect()
        except Exception as e:  # noqa: BLE001
            logger.warning("session disconnect failed: %s", e)


def _db_setup(test: dict) -> None:
    db = test.get("db")
    if db is None:
        return
    control.on_nodes(test, db.setup)
    if db_proto.supports(db, db_proto.Primary):
        prims = db.primaries(test) or test["nodes"][:1]
        if prims:
            control.on_nodes(
                test, lambda t, n: db.setup_primary(t, n), prims[:1])


def _db_teardown(test: dict) -> None:
    db = test.get("db")
    if db is None or test.get("leave-db-running"):
        return
    control.on_nodes(test, db.teardown)


def _download_logs(test: dict) -> None:
    """Pull db log files into the store dir, one subdir per node
    (reference: `core/run!`'s log snarfing via `db/log-files`)."""
    db = test.get("db")
    if db is None or not db_proto.supports(db, db_proto.LogFiles):
        return

    def snarf(t: dict, node: str) -> None:
        files = list(db.log_files(t, node) or ())
        if not files:
            return
        dest = store.path(t, node)
        os.makedirs(dest, exist_ok=True)
        try:
            control.download(files, dest)
        except Exception as e:  # noqa: BLE001
            logger.warning("log download from %s failed: %s", node, e)

    control.on_nodes(test, snarf)


def run(test: dict) -> dict:
    """Run a full test: setup, workload, teardown, analysis, storage.

    Returns the test map with ``history`` (a History) and ``results``
    (``{"valid?": True|False|"unknown", ...}``) attached.  Exceptions in
    setup/workload propagate after best-effort teardown; exceptions in
    checkers are captured by `check_safe` as invalid results, and the
    phase-0 store write has already preserved the history by then.
    """
    test = {**noop_test(), **test}
    if test.get("live-check"):
        from .verifier.client import live_check_config

        # a value the port cannot serve (a URL target, a malformed value)
        # raises here, before the run starts anything, rather than run
        # without the checking the test map asked for
        live_check_config(test)
    if test.get("start-time") is None:
        test["start-time"] = time.time()
    # telemetry: a fresh collector per run when opted in (test map key,
    # telemetry.enable(), or JEPSEN_TELEMETRY); the NOOP singleton
    # otherwise — every span below is then a shared no-op object.  A
    # "profile-dir" run is implicitly telemetric: its spans bridge to
    # torch.profiler as record_function ranges of the same names
    profile_dir = test.get("profile-dir")
    tel = (telemetry.activate()
           if telemetry.wanted_for(test) or profile_dir
           else telemetry.NOOP)
    recorder = None
    # distributed trace context: a cell executed by a fleet
    # worker (or any caller stamping test["trace-id"]) runs its whole
    # body as ONE segment of the run's cross-host trace — stamped into
    # span attrs, the event stream meta, and telemetry.json, and
    # readable by the live-check client and every control-plane call
    # made from this thread.  Derivable from the campaign run id too,
    # so single-process campaign cells stitch identically.
    tctx = None
    tid = test.get("trace-id") or (
        telemetry.trace_id_for(test["campaign-run-id"])
        if test.get("campaign-run-id") else None)
    if tid:
        tctx = telemetry.trace_context(str(tid), "run")
        test["trace-id"] = str(tid)
    if tel.enabled:
        test["telemetry-collector"] = tel
        # a full run always writes the unsuffixed artifacts, even for a
        # test map reloaded from a store dir that was later analyzed
        test.pop("telemetry-artifact-suffix", None)
        tel.annotate = bool(profile_dir)
        tel.trace = tctx
        # the flight recorder: stream span/metric/resilience events to
        # <run-dir>/events.jsonl as they happen, so a killed run still
        # leaves a readable partial trace (docs/TELEMETRY.md)
        try:
            import socket as _socket

            mb = test.get("events-max-bytes")
            meta = {"name": test.get("name"),
                    # fleet cells identify by worker name — one lane
                    # per worker on the stitched timeline
                    "host": test.get("fleet-host")
                    or _socket.gethostname()}
            if tctx is not None:
                meta["trace-id"] = tctx.trace_id
            recorder = telemetry.attach_stream(
                tel, store.test_dir(test),
                meta=meta,
                interval_s=float(
                    test.get("telemetry-sample-interval", 1.0)),
                max_bytes=int(mb) if mb else None,
                keep=test.get("events-keep"))
        except Exception as e:  # noqa: BLE001 — never fail a run for it
            logger.warning("flight recorder unavailable: %s", e)
    prev_trace = telemetry.set_trace(tctx) if tctx is not None else None
    try:
        with profiling.trace(profile_dir):
            with tel.span("run", name=test.get("name"),
                          nodes=len(test.get("nodes") or ()),
                          concurrency=test.get("concurrency")):
                return _run_phases(test, tel)
    finally:
        if tctx is not None:
            telemetry.set_trace(prev_trace)
        if recorder is not None:
            recorder.close(
                valid=(test.get("results") or {}).get("valid?"))
        if tel.enabled:
            telemetry.deactivate(tel)


def _run_phases(test: dict, tel) -> dict:
    """The body of :func:`run`, one telemetry span per phase."""
    log_handler = _start_logging(test)
    logger.info("Running test %s on nodes %s", test.get("name"),
                test.get("nodes"))
    sessions: Dict[str, Session] = {}
    nemesis = test.get("nemesis")
    # live checking: opt-in via the "live-check" test key.  The interpreter
    # streams every history event into the client's sink; a verifier
    # partitioned past the budget degrades the client and the ordinary
    # stored-history check below stands alone — the run never depends
    # on the live path.
    live = None
    if test.get("live-check"):
        from .verifier.client import live_check_for

        try:
            with tel.span("live-check.open"):
                live = live_check_for(test)
        except Exception as e:  # noqa: BLE001 — opt-in accelerant
            logger.warning("live-check unavailable: %s", e)
        if live is not None:
            test["op-sink"] = live.feed
    try:
        sessions = _open_sessions(test)
        test["sessions"] = sessions
        try:
            if test.get("nodes") and test.get("remote") is not None:
                os_ = test.get("os") or os_setup.noop
                with tel.span("os-setup"):
                    control.on_nodes(test, os_.setup)
                with tel.span("db-setup"):
                    _db_setup(test)
            if nemesis is not None:
                with tel.span("nemesis-setup"):
                    test["nemesis"] = nemesis = \
                        nemesis.setup(test) or nemesis

            logger.info("Starting workload")
            fg = test.get("final-generator")
            if fg is not None:
                # quiesce, then the final phase (reference: run! drives
                # :generator then :final-generator once clients settle)
                test["generator"] = gen_core.phases(
                    test.get("generator"), fg)
            with tel.span("workload") as w_span:
                hist = interpreter.run(test)
                w_span.set_attr(ops=len(hist))
            test["history"] = hist
            logger.info("Workload complete: %d ops", len(hist))
        except BaseException as e:
            if live is not None:
                _quietly("live-check close", live.close)
                live = None
            log_run_failure(test, e)
            raise
        finally:
            # Best-effort teardown runs whether the workload completed or
            # died mid-setup: faults must be healed and dbs stopped either
            # way, and node logs are most valuable for crashed runs.
            if nemesis is not None:
                with tel.span("nemesis-teardown"):
                    _quietly("nemesis teardown",
                             lambda: nemesis.teardown(test))
            if test.get("nodes") and test.get("remote") is not None:
                with tel.span("log-download"):
                    _quietly("log download", lambda: _download_logs(test))
                with tel.span("db-teardown"):
                    _quietly("db teardown", lambda: _db_teardown(test))
                os_ = test.get("os") or os_setup.noop
                with tel.span("os-teardown"):
                    _quietly("os teardown",
                             lambda: control.on_nodes(test, os_.teardown))
    finally:
        _close_sessions(sessions)
        test.pop("sessions", None)

    test.pop("op-sink", None)  # the feed hook must not persist
    try:
        with tel.span("store.save_0"):
            store.save_0(test)
        # the check phase gets one span per (composed) checker, opened
        # inside checker_api.check_safe with the checker's name attached
        test["results"] = _check(test, test.get("history"))
        if live is not None:
            # drain + verdict (+seal) the live session; a degraded
            # stream stamps {"state": "degraded"} and the stored-
            # history verdict above is the sole authority.  In-proc
            # services run their sweeps here, so verifier.sweep spans
            # land in this run's telemetry.
            with tel.span("live-check.finish"):
                summary = live.finish()
            live = None  # finished — the close-on-error below is moot
            if isinstance(test.get("results"), dict):
                test["results"]["live-check"] = summary
            (logger.info if summary.get("state") == "ok"
             else logger.warning)(
                "live-check %s: state=%s ops=%s", summary.get("session"),
                summary.get("state"), summary.get("ops"))
        with tel.span("store.save_1"):
            store.save_1(test)
        valid = test["results"].get("valid?")
        (logger.info if valid is True else logger.warning)(
            "Analysis complete: valid? = %s", valid)
    finally:
        if live is not None:
            # save_0/_check raised before finish(): a long-lived fleet
            # worker must not leak the sender thread / in-proc service
            _quietly("live-check close", live.close)
        _stop_logging(log_handler)
    return test


def _quietly(what: str, thunk) -> None:
    try:
        thunk()
    except Exception as e:  # noqa: BLE001
        logger.warning("%s failed: %s", what, e)


def _check(test: dict, hist: Optional[History]) -> dict:
    chk = test.get("checker")
    if chk is None or hist is None:
        return {"valid?": True}
    return checker_api.check_safe(chk, test, hist)


def analyze(test_or_dir, checker=None) -> dict:
    """Re-run analysis on a stored test (reference: load a stored test and
    re-check).  Accepts a loaded test map or a store directory path; the
    lazy history is materialized, the checker re-run, results re-saved."""
    test = store.load(test_or_dir) if isinstance(test_or_dir, str) else test_or_dir
    hist = test.get("history")
    if hist is not None and not isinstance(hist, History):
        hist = hist.materialize()
        test["history"] = hist
    if checker is not None:
        test["checker"] = checker
    chk = test.get("checker")
    if chk is None or not hasattr(chk, "check"):
        # stored tests persist checkers only as "§obj" placeholders
        raise ValueError(
            "no checker: stored tests don't persist checker objects; "
            "pass one to analyze(test, checker)")
    tel = (telemetry.activate() if telemetry.wanted_for(test)
           else telemetry.NOOP)
    if tel.enabled:
        test["telemetry-collector"] = tel
        # keep the original run's telemetry.json/trace.json intact:
        # the re-check writes *-analyze.json artifacts instead
        test["telemetry-artifact-suffix"] = "-analyze"
    try:
        with tel.span("analyze", name=test.get("name")):
            test["results"] = checker_api.check_safe(chk, test, hist)
            with tel.span("store.save_1"):
                store.save_1(test)
    finally:
        if tel.enabled:
            telemetry.deactivate(tel)
    return test


def log_run_failure(test: dict, e: BaseException) -> None:
    """Record a crashed run (what the reference's run! logs before
    rethrowing)."""
    logger.error("Test run failed: %s\n%s", e,
                 "".join(traceback.format_exception(type(e), e, e.__traceback__)))
