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

Left out of the JAX module: the telemetry spans, the flight recorder and
the profiler trace (they wait for the port's telemetry module), and live
checking, which needs the verifier: a test map with ``"live-check"``
raises `ValueError` rather than run without it.
"""

from __future__ import annotations

import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

from . import db as db_proto
from . import net as net_proto
from . import os_setup, store
from .checkers import api as checker_api
from .control import api as control
from .control.core import Remote, Session
from .generator import core as gen_core
from .generator import interpreter
from .history.ops import History

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
    if test.get("live-check"):
        raise ValueError(
            "live-check needs the verifier, which the port does not have "
            "yet (ROADMAP A5); drop the \"live-check\" key")
    test = {**noop_test(), **test}
    if test.get("start-time") is None:
        test["start-time"] = time.time()
    return _run_phases(test)


def _run_phases(test: dict) -> dict:
    """The body of :func:`run`."""
    log_handler = _start_logging(test)
    logger.info("Running test %s on nodes %s", test.get("name"),
                test.get("nodes"))
    sessions: Dict[str, Session] = {}
    nemesis = test.get("nemesis")
    try:
        sessions = _open_sessions(test)
        test["sessions"] = sessions
        try:
            if test.get("nodes") and test.get("remote") is not None:
                os_ = test.get("os") or os_setup.noop
                control.on_nodes(test, os_.setup)
                _db_setup(test)
            if nemesis is not None:
                test["nemesis"] = nemesis = nemesis.setup(test) or nemesis

            logger.info("Starting workload")
            fg = test.get("final-generator")
            if fg is not None:
                # quiesce, then the final phase (reference: run! drives
                # :generator then :final-generator once clients settle)
                test["generator"] = gen_core.phases(
                    test.get("generator"), fg)
            hist = interpreter.run(test)
            test["history"] = hist
            logger.info("Workload complete: %d ops", len(hist))
        except BaseException as e:
            log_run_failure(test, e)
            raise
        finally:
            # Best-effort teardown runs whether the workload completed or
            # died mid-setup: faults must be healed and dbs stopped either
            # way, and node logs are most valuable for crashed runs.
            if nemesis is not None:
                _quietly("nemesis teardown", lambda: nemesis.teardown(test))
            if test.get("nodes") and test.get("remote") is not None:
                _quietly("log download", lambda: _download_logs(test))
                _quietly("db teardown", lambda: _db_teardown(test))
                os_ = test.get("os") or os_setup.noop
                _quietly("os teardown",
                         lambda: control.on_nodes(test, os_.teardown))
    finally:
        _close_sessions(sessions)
        test.pop("sessions", None)

    try:
        store.save_0(test)
        test["results"] = _check(test, test.get("history"))
        store.save_1(test)
        valid = test["results"].get("valid?")
        (logger.info if valid is True else logger.warning)(
            "Analysis complete: valid? = %s", valid)
    finally:
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
    test["results"] = checker_api.check_safe(chk, test, hist)
    store.save_1(test)
    return test


def log_run_failure(test: dict, e: BaseException) -> None:
    """Record a crashed run (what the reference's run! logs before
    rethrowing)."""
    logger.error("Test run failed: %s\n%s", e,
                 "".join(traceback.format_exception(type(e), e, e.__traceback__)))
