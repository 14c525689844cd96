"""The always-on verifier service: sessions over HTTP (the port's copy of
`jepsen_tpu/verifier/service.py`).

Session lifecycle, storage, and observability for a fleet of
:class:`~.session.VerifierSession`\\ s.  In the JAX package ``cli serve
--ingest`` serves it (the web server routes ``POST /ingest/<session>``,
``GET /verdict/<session>``, and the ``/verifier/<session>/<verb>``
lifecycle endpoints here); the port has no web server yet, so its
callers are in process (`client.LiveCheck` with ``{"inproc": true}``).
The sessions' seal checks and the batched sweep run on the service's
`device` (the CUDA card unless the caller names the CPU).

Protocol (all JSON):

- ``POST /ingest/<session>?cursor=N`` — body is op-dict jsonl (the
  ``history.json`` line format).  The longest prefix of complete,
  parseable lines is journaled (fsync'd) and fed to the incremental
  checker; the response acks ``{"cursor": <journal bytes>}``.
  ``cursor`` is the byte offset of the segment's first byte in the
  client's logical stream: a resend after a lost ack overlaps, and the
  server skips the already-journaled prefix (idempotent re-append).  A
  cursor PAST the journal is a gap → 409, nothing accepted.
- ``GET /verdict/<session>`` — the rolling verdict: oracle-shaped
  result + ``new``/``cleared`` anomaly deltas and per-anomaly
  ``first-seen`` timestamps.
- ``POST /verifier/<session>/open|seal|expire`` — lifecycle.  ``open``
  takes an optional config body (``consistency-models``,
  ``anomalies``, ``sweep-deadline-s``, ``sweep-chunk``); ``seal`` runs
  the full batch checker over the concatenated history and asserts
  equality with the incremental verdict; ``expire`` drops the session
  from memory (journal + state stay on disk, reloadable).

Durability: a session is its journal.  On restart (or first touch of
an on-disk session) the journal replays through a fresh
:class:`VerifierSession` and reaches the identical verdict digest —
pinned by the crash tests.

Observability: per-session ``events.jsonl`` (ingest/verdict/seal
events — the web ``/live/verifier/<name>`` page renders it), verifier
gauges/counters on the live registry (scraped by ``/metrics``), and an
atomically-replaced ``session.json`` snapshot per session so read-only
surfaces (web pages without ``--ingest``, warehouse ingest) never need
the service process.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch import backend, resilience, store, telemetry
from jepsen_tpu_torch.resilience import Deadline, DeadlineExceeded
from jepsen_tpu_torch.telemetry import spans as spans_mod
from jepsen_tpu_torch.telemetry.stream import EventStream

from .journal import (
    JOURNAL_FILE,
    META_FILE,
    SessionJournal,
    read_checkpoint,
    read_meta,
    split_segment,
)
from .session import (
    INGEST_SITE,
    SWEEP_CHUNK,
    VerdictMismatch,
    VerifierSession,
    verdict_digest,
)

logger = logging.getLogger("jepsen.verifier")

__all__ = ["VerifierService", "VERIFIER_DIR", "ARCHIVE_DIR",
           "scan_sessions"]

VERIFIER_DIR = "verifier"

#: sealed-session archival target under the verifier root; leading
#: underscore so session scans (and the warehouse ingest) skip it
ARCHIVE_DIR = "_archive"

#: sweep-duration histogram bounds (seconds) — p95 derivable from the
#: cumulative buckets on /metrics
_SWEEP_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0)


def _registry():
    return telemetry.registry()


class _Live:
    """One in-memory session: checker + journal + event stream."""

    def __init__(self, name: str, dirpath: str,
                 config: Dict[str, Any],
                 device: backend.DeviceLike = None):
        self.name = name
        self.dir = dirpath
        self.config = config
        self.lock = threading.RLock()
        # set (under self.lock) when expire() retires this object: a
        # handler that fetched it before the pop must not keep using
        # the zombie — it re-resolves and gets a freshly recovered one
        self.dead = False
        # set at recovery when the compacted prefix is unrecoverable
        # (checkpoint unusable, journal already truncated): the session
        # must refuse to serve normal-looking verdicts over a partial
        # history — ingest/verdict/seal answer 410 instead
        self.recovery_error: Optional[str] = None
        self.journal = SessionJournal(dirpath)
        self.session = VerifierSession(
            name,
            consistency_models=tuple(
                config.get("consistency-models") or ("serializable",)),
            anomalies=tuple(config.get("anomalies") or ()),
            sweep_chunk=int(config.get("sweep-chunk") or 0) or SWEEP_CHUNK,
            max_reported=int(config.get("max-reported") or 8),
            device=device)
        self.opened = round(time.time(), 3)
        self.last_ingest = self.opened
        self.last_verdict_ts = self.opened
        self.last_verdict: Optional[Dict[str, Any]] = None
        self.seal_result: Optional[Dict[str, Any]] = None
        self.stream = EventStream(
            os.path.join(dirpath, "events.jsonl"),
            meta={"name": f"verifier:{name}", "session": name})

    @property
    def state(self) -> str:
        return "sealed" if self.seal_result is not None else "open"

    def deadline(self) -> Optional[Deadline]:
        s = self.config.get("sweep-deadline-s")
        return Deadline(float(s)) if s else None

    def snapshot(self, verdict: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        if verdict is None:
            verdict = self.last_verdict  # keep the last one on disk
        doc = {
            "session": self.name,
            "state": self.state,
            "opened": self.opened,
            "updated": round(time.time(), 3),
            "cursor": self.journal.cursor,
            "ops": self.session.n_events,
            "txns": self.session.n_txns,
            "segments": self.session.segments,
            "config": self.config,
        }
        if self.recovery_error:
            doc["recovery-error"] = self.recovery_error
        if verdict is not None:
            doc["verdict"] = {
                k: verdict.get(k) for k in
                ("valid?", "anomaly-types", "error", "edge-counts",
                 "first-seen", "not", "also-not")}
            doc["digest"] = verdict_digest(verdict)
        if self.seal_result is not None:
            doc["seal"] = {
                "equal": self.seal_result.get("equal"),
                "digest": self.seal_result.get("digest"),
                "valid?": (self.seal_result.get("verdict") or {}).get(
                    "valid?"),
                "anomaly-types": (self.seal_result.get("verdict") or {}
                                  ).get("anomaly-types"),
            }
        return doc

    def persist(self, verdict: Optional[Dict[str, Any]] = None) -> None:
        if verdict is not None:
            self.last_verdict = verdict
        self.journal.write_meta(self.snapshot(verdict))

    def idle_s(self, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        return max(0.0, now - max(self.last_ingest,
                                  self.last_verdict_ts))

    def compact(self) -> Dict[str, Any]:
        """Checkpoint-then-truncate (caller holds self.lock): persist
        the packed prefix as ``checkpoint.npz``, then rewrite the
        journal down to the un-checkpointed suffix.  Ordering is the
        crash discipline — a kill between the two writes leaves the
        full journal AND a checkpoint; recovery replays only the
        suffix past the checkpoint's cursor, so nothing doubles."""
        before = self.journal.disk_bytes()
        cursor = self.journal.cursor
        cols, meta = self.session.checkpoint_state()
        meta["cursor"] = cursor
        self.journal.write_checkpoint(cols, meta)
        self.journal.compact(cursor)
        out = {"session": self.name, "cursor": cursor,
               "journal-bytes-before": before,
               "journal-bytes-after": self.journal.disk_bytes()}
        self.stream.emit("compact", **{k: v for k, v in out.items()
                                       if k != "session"})
        _registry().counter("verifier-compactions").inc()
        return out

    def close(self, reason: str) -> None:
        self.stream.close(reason=reason)
        self.journal.close()


class VerifierService:
    """Session manager behind the ingest endpoints.  Thread-safe: the
    web server's handler threads call straight in."""

    def __init__(self, base: Optional[str] = None,
                 default_config: Optional[Dict[str, Any]] = None,
                 device: backend.DeviceLike = None):
        self.base = base or store.BASE
        self.device = device
        self.root = os.path.join(self.base, VERIFIER_DIR)
        self.default_config = dict(default_config or {})
        # reentrant: _get holds it while _update_gauges re-acquires.
        # Held only for DICT bookkeeping — construction + journal
        # replay of a session happen under its per-name lock, so
        # recovering one big session never stalls the whole service
        self._lock = threading.RLock()
        self._live: Dict[str, _Live] = {}
        self._name_locks: Dict[str, threading.RLock] = {}
        self._maint: Optional[threading.Thread] = None
        self._maint_stop = threading.Event()

    # -- lookup / lifecycle -------------------------------------------------

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    @staticmethod
    def valid_name(name: str) -> bool:
        # leading "_" / "." are infrastructure namespaces (``_archive/``
        # retention, dot-prefixed staging) that the session and store
        # scans skip — a session there would journal into the retention
        # subtree or be invisible to listings and gc
        return bool(name) and store.sanitize(name) == name \
            and not name.startswith(("_", "."))

    def _nlock(self, name: str) -> threading.RLock:
        with self._lock:
            return self._name_locks.setdefault(name, threading.RLock())

    def _get(self, name: str, create: bool = False,
             config: Optional[Dict[str, Any]] = None) -> Optional[_Live]:
        if not self.valid_name(name):
            raise ValueError(f"bad session name {name!r}")
        with self._lock:
            live = self._live.get(name)
            if live is not None:
                return live
        nlock = self._nlock(name)
        with nlock:
            with self._lock:
                live = self._live.get(name)  # a racer built it first
                if live is not None:
                    return live
            d = self._dir(name)
            on_disk = os.path.exists(os.path.join(d, JOURNAL_FILE)) or \
                os.path.exists(os.path.join(d, META_FILE))
            if not on_disk and not create:
                return None
            cfg = dict(self.default_config)
            meta = read_meta(d) if on_disk else None
            if meta and isinstance(meta.get("config"), dict):
                cfg.update(meta["config"])
            if config:
                cfg.update(config)
            # construction + journal replay OUTSIDE the service lock:
            # only this name's lock is held, other sessions keep moving
            live = _Live(name, d, cfg, self.device)
            if on_disk:
                self._recover(live, meta)
            with self._lock:
                self._live[name] = live
            self._update_gauges()
            live.persist()
            return live

    def _recover(self, live: _Live, meta: Optional[Dict[str, Any]]
                 ) -> None:
        """Replay the journal into the fresh session — the restart
        path.  With a checkpoint on disk (a compacted session) the
        packed prefix restores vectorized and only the journal suffix
        past the checkpoint cursor replays line by line; the reached
        verdict digest is identical either way.  A sealed session
        keeps its recorded seal block instead of re-running the batch
        checker."""
        n = 0
        t0 = time.time()
        start = None
        ckpt = read_checkpoint(live.dir)
        if ckpt is None and live.journal.base > 0:
            # compaction truncated the journal but its checkpoint is
            # missing/unreadable: the prefix cannot be rebuilt.
            # Quarantine rather than serve valid?-looking verdicts
            # over a suffix-only replay
            live.recovery_error = ("checkpoint missing or unreadable "
                                   "and the journal prefix was "
                                   "compacted away")
            logger.error("verifier: session %s unrecoverable: %s",
                         live.name, live.recovery_error)
            return
        if ckpt is not None:
            cols, cmeta = ckpt
            try:
                live.session.load_checkpoint(cols, cmeta)
                start = int(cmeta["cursor"])
            except Exception as e:  # noqa: BLE001 — external corruption
                if live.journal.base > 0:
                    # the journal prefix was compacted away: without
                    # the checkpoint the history cannot be rebuilt.
                    # Quarantine rather than serve valid?-looking
                    # verdicts over a truncated replay
                    live.recovery_error = (
                        f"checkpoint unusable ({e}) and the journal "
                        "prefix was compacted away")
                    logger.error("verifier: session %s unrecoverable: "
                                 "%s", live.name, live.recovery_error)
                    return
                logger.warning(
                    "verifier: checkpoint for %s unusable (%s); "
                    "replaying the journal", live.name, e)
                live.session = VerifierSession(
                    live.name,
                    consistency_models=live.session.consistency_models,
                    anomalies=live.session.extra_anomalies,
                    sweep_chunk=live.session.sweep_chunk,
                    max_reported=live.session.max_reported,
                    device=self.device)
                start = None
        for chunk in live.journal.read_ops(from_cursor=start):
            live.session.append_ops(chunk)
            n += len(chunk)
        v = (meta.get("verdict") or {}) if meta else {}
        live.session.restore_rolling(v.get("first-seen"),
                                     v.get("anomaly-types"))
        if meta and meta.get("state") == "sealed" and \
                isinstance(meta.get("seal"), dict):
            live.seal_result = {"equal": meta["seal"].get("equal"),
                                "digest": meta["seal"].get("digest"),
                                "verdict": dict(meta["seal"]),
                                "recovered": True}
        live.stream.emit("recover", ops=n,
                         wall_s=round(time.time() - t0, 3))
        logger.info("verifier: recovered session %s (%d journaled ops)",
                    live.name, n)

    @staticmethod
    def _adopt_trace(live: _Live) -> None:
        """Stitch the session onto its run's distributed trace : the first request arriving with a trace — open config
        carrying ``trace-id``, or a ``Jepsen-Trace`` header the web
        layer installed on this handler thread — pins the session's
        trace id into its config (persisted in session.json, the
        journal session metadata) and the event stream."""
        if live.config.get("trace-id"):
            return
        ctx = spans_mod.current_trace()
        if ctx is not None:
            live.config["trace-id"] = ctx.trace_id
            live.stream.emit("trace", trace=ctx.trace_id)

    def open(self, name: str, config: Optional[Dict[str, Any]] = None
             ) -> Tuple[int, Dict[str, Any]]:
        try:
            live = self._get(name, create=True, config=config)
        except ValueError as e:
            return 400, {"error": str(e)}
        with live.lock:
            self._adopt_trace(live)
            live.persist()
            return 200, live.snapshot()

    def ingest(self, name: str, body: bytes,
               cursor: Optional[int] = None
               ) -> Tuple[int, Dict[str, Any]]:
        """Accept one streamed segment; journal-then-ack.  Runs under
        the resilience guard (fault site ``verifier.ingest``) so chaos
        tooling can hit the ingest path; the guarded unit is idempotent
        — the overlap skip recomputes from the journal cursor, so a
        retried attempt never double-appends."""
        for _ in range(2):  # once more if expire() retired our handle
            try:
                live = self._get(name, create=True)
            except ValueError as e:
                return 400, {"error": str(e)}
            with live.lock:
                if live.dead:
                    continue  # re-resolve: a fresh recovery replaces it
                if live.recovery_error:
                    return 410, {"error": "session unrecoverable: "
                                 + live.recovery_error}
                if live.state == "sealed":
                    return 409, {"error": "session sealed",
                                 "cursor": live.journal.cursor}
                try:
                    return resilience.device_call(
                        INGEST_SITE, self._ingest_locked, live, body,
                        cursor)
                except DeadlineExceeded:
                    raise
                except Exception as e:  # noqa: BLE001 — persistent
                    logger.warning("verifier ingest failed for %s: %s",
                                   name, e)
                    return 503, {"error": f"{type(e).__name__}: {e}",
                                 "cursor": live.journal.cursor}
        return 503, {"error": "session expired mid-request; retry"}

    def _ingest_locked(self, live: _Live, body: bytes,
                       cursor: Optional[int]) -> Tuple[int, Dict[str, Any]]:
        self._adopt_trace(live)
        jr = live.journal
        if cursor is not None:
            cursor = int(cursor)
            if cursor > jr.cursor:
                return 409, {"error": "cursor gap", "cursor": jr.cursor,
                             "client-cursor": cursor}
            skip = jr.cursor - cursor
            if skip >= len(body):
                # pure replay of already-acked bytes: idempotent no-op
                return 200, {"cursor": jr.cursor, "ops": 0,
                             "txns": live.session.n_txns,
                             "replayed": True}
            body = body[skip:]
        accepted, n_lines, ops = split_segment(body)
        if not accepted:
            return 200, {"cursor": jr.cursor, "ops": 0,
                         "txns": live.session.n_txns}
        jr.append(accepted)  # fsync BEFORE the ack or any checking
        txns = live.session.append_ops(ops) if ops else 0
        live.last_ingest = time.time()
        reg = _registry()
        reg.counter("verifier-ops-ingested").inc(n_lines)
        reg.gauge("verifier-verdict-freshness-s",
                  session=live.name).set(
            round(live.last_ingest - live.last_verdict_ts, 3))
        live.stream.emit("ingest", ops=n_lines, txns=txns,
                         cursor=jr.cursor)
        # auto-compaction: once the on-disk journal outgrows
        # the configured budget, checkpoint + truncate inline — the
        # cost amortizes over the bytes that grew it, and a month-long
        # session's journal stays bounded instead of monotone
        cb = live.config.get("compact-bytes")
        try:
            cb = int(cb) if cb else 0
        except (TypeError, ValueError):
            cb = 0
        if cb and jr.disk_bytes() >= cb:
            try:
                live.compact()
            except Exception as e:  # noqa: BLE001 — compaction is an
                # optimization; a failed one leaves the journal whole
                logger.warning("verifier: auto-compact of %s failed: "
                               "%s", live.name, e)
        live.persist()
        return 200, {"cursor": jr.cursor, "ops": n_lines, "txns": txns}

    def verdict(self, name: str) -> Tuple[int, Dict[str, Any]]:
        for _ in range(2):
            try:
                live = self._get(name)
            except ValueError as e:
                return 400, {"error": str(e)}
            if live is None:
                return 404, {"error": f"no such session {name!r}"}
            with live.lock:
                if live.dead:
                    continue
                return self._verdict_locked(live)
        return 503, {"error": "session expired mid-request; retry"}

    def _verdict_locked(self, live: _Live) -> Tuple[int, Dict[str, Any]]:
        if live.recovery_error:
            return 410, {"error": "session unrecoverable: "
                         + live.recovery_error}
        t0 = time.perf_counter()
        try:
            res = live.session.verdict(deadline=live.deadline())
        except Exception as e:  # noqa: BLE001 — injected persistent
            return 503, {"error": f"{type(e).__name__}: {e}"}
        dt = time.perf_counter() - t0
        reg = _registry()
        reg.histogram("verifier-sweep-s", _SWEEP_BUCKETS).observe(dt)
        live.last_verdict_ts = time.time()
        reg.gauge("verifier-verdict-freshness-s",
                  session=live.name).set(0.0)
        live.stream.emit("verdict", valid=res.get("valid?"),
                         anomalies=res.get("anomaly-types"),
                         new=res.get("new"), dur_s=round(dt, 6))
        res["digest"] = verdict_digest(res)
        live.persist(res)
        return 200, res

    def seal(self, name: str) -> Tuple[int, Dict[str, Any]]:
        for _ in range(2):
            try:
                live = self._get(name)
            except ValueError as e:
                return 400, {"error": str(e)}
            if live is None:
                return 404, {"error": f"no such session {name!r}"}
            with live.lock:
                if live.dead:
                    continue
                return self._seal_locked(live)
        return 503, {"error": "session expired mid-request; retry"}

    def _seal_locked(self, live: _Live) -> Tuple[int, Dict[str, Any]]:
        if live.recovery_error:
            return 410, {"error": "session unrecoverable: "
                         + live.recovery_error}
        if live.state == "sealed":
            return 200, live.seal_result
        try:
            sealed = live.session.seal(deadline=live.deadline())
        except VerdictMismatch as e:
            live.stream.emit("seal-mismatch", error=str(e))
            return 500, {"error": "verdict mismatch",
                         "incremental": e.incremental,
                         "batch": e.batch}
        except Exception as e:  # noqa: BLE001
            return 503, {"error": f"{type(e).__name__}: {e}"}
        live.seal_result = sealed
        live.stream.emit("seal", equal=sealed["equal"],
                         digest=sealed["digest"],
                         valid=sealed["verdict"].get("valid?"))
        live.persist(sealed.get("incremental"))
        self._drop_session_series(live.name)
        self._update_gauges()
        return 200, sealed

    def compact(self, name: str) -> Tuple[int, Dict[str, Any]]:
        """Explicit journal compaction for one live session (the
        ``POST /verifier/<s>/compact`` verb); auto-compaction via the
        ``compact-bytes`` config key covers the steady state."""
        for _ in range(2):
            try:
                live = self._get(name)
            except ValueError as e:
                return 400, {"error": str(e)}
            if live is None:
                return 404, {"error": f"no such session {name!r}"}
            with live.lock:
                if live.dead:
                    continue
                if live.recovery_error:
                    return 410, {"error": "session unrecoverable: "
                                 + live.recovery_error}
                try:
                    out = live.compact()
                except Exception as e:  # noqa: BLE001
                    return 503, {"error": f"{type(e).__name__}: {e}"}
                live.persist()
                return 200, out
        return 503, {"error": "session expired mid-request; retry"}

    def expire(self, name: str) -> Tuple[int, Dict[str, Any]]:
        """Drop a session from memory; journal + session.json stay on
        disk (a later touch recovers it by replay).  The retired
        object is marked dead under its own lock, so a handler that
        fetched it pre-pop re-resolves instead of writing through a
        zombie journal handle alongside the recovered replacement."""
        with self._lock:
            live = self._live.pop(name, None)
        if live is None:
            return 404, {"error": f"no such live session {name!r}"}
        with live.lock:
            live.dead = True
            live.persist()
            live.close("expired")
        self._drop_session_series(name)
        self._update_gauges()
        return 200, {"expired": name}

    # -- retention / maintenance ---------------------------------

    def _archive(self, name: str) -> bool:
        """Move a sealed session's dir under ``<root>/_archive/`` —
        journal + checkpoint + snapshot intact, but out of the session
        scans, the warehouse ingest, and the /metrics surfaces."""
        src = self._dir(name)
        if not os.path.isdir(src):
            return False
        adir = os.path.join(self.root, ARCHIVE_DIR)
        os.makedirs(adir, exist_ok=True)
        dst = os.path.join(adir, name)
        if os.path.exists(dst):
            dst = f"{dst}.{int(time.time() * 1000)}"
        try:
            os.replace(src, dst)
        except OSError as e:
            logger.warning("verifier: archive of %s failed: %s",
                           name, e)
            return False
        return True

    def gc(self, now: Optional[float] = None) -> Dict[str, int]:
        """Retention pass: expire open sessions idle past
        ``gc-idle-s`` (journal stays, a later touch recovers them) and
        archive sealed sessions idle past ``archive-sealed-s`` —
        including on-disk sealed sessions from before a restart.  Both
        knobs come from the service default config (or per-session
        config); unset means that policy is off.  Keeps the long-lived
        daemon's RSS and /metrics cardinality bounded: expired/archived
        sessions' per-session gauges are retired with them."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "archived": 0}
        idle_s = _as_float(self.default_config.get("gc-idle-s"))
        arch_s = _as_float(self.default_config.get("archive-sealed-s"))
        # no early-out on unset defaults: the per-session loop still
        # runs, so a session that carried its own gc-idle-s /
        # archive-sealed-s in its open config gets retention too
        with self._lock:
            items = list(self._live.items())
        for name, live in items:
            with live.lock:
                if live.dead:
                    continue
                cfg_idle = _as_float(live.config.get("gc-idle-s"),
                                     idle_s)
                cfg_arch = _as_float(
                    live.config.get("archive-sealed-s"), arch_s)
                sealed = live.state == "sealed"
                idle = live.idle_s(now)
            if sealed and cfg_arch is not None and idle > cfg_arch:
                # per-name lock across expire→archive: a concurrent
                # touch can't recover the session from disk between
                # the two steps and be left writing through a dir the
                # rename just moved under _archive/
                with self._nlock(name):
                    self.expire(name)
                    if self._archive(name):
                        stats["archived"] += 1
            elif not sealed and cfg_idle is not None \
                    and idle > cfg_idle:
                self.expire(name)
                stats["expired"] += 1
        # sealed sessions left on disk by an earlier process life.
        # Not gated on the DEFAULT arch knob: a session that carried
        # its own archive-sealed-s in its open config must still
        # archive after a restart, when only its persisted meta knows
        # the knob
        with self._lock:
            live_names = set(self._live)
        for name, meta in scan_sessions(self.base):
            if name in live_names:
                continue
            upd = meta.get("updated")
            mcfg = meta.get("config") if isinstance(
                meta.get("config"), dict) else {}
            m_arch = _as_float(mcfg.get("archive-sealed-s"), arch_s)
            if meta.get("state") == "sealed" \
                    and isinstance(upd, (int, float)) \
                    and m_arch is not None \
                    and now - upd > m_arch:
                with self._nlock(name):
                    with self._lock:
                        if name in self._live:  # recovered since
                            continue            # the scan
                    if self._archive(name):
                        stats["archived"] += 1
        self._journal_gauge()
        return stats

    def sweep_dirty(self) -> Dict[str, int]:
        """One multi-tenant batched sweep over every dirty live
        session (docs/VERIFIER.md): many sessions' dirty regions, ONE
        ``ops.cycle_sweep`` dispatch — the per-session host sweep stops
        being the scaling wall."""
        from . import sweep as sweep_mod

        with self._lock:
            lives = list(self._live.values())
        return sweep_mod.batched_sweep(lives, device=self.device)

    def maintain(self) -> Dict[str, Any]:
        """One maintenance tick: batched sweep + GC + gauge refresh.
        Every part is best-effort — a failing tick never takes the
        service down."""
        out: Dict[str, Any] = {}
        try:
            out["sweep"] = self.sweep_dirty()
        except Exception as e:  # noqa: BLE001
            logger.warning("verifier maintenance sweep failed: %s", e)
            out["sweep-error"] = str(e)
        try:
            out["gc"] = self.gc()
        except Exception as e:  # noqa: BLE001
            logger.warning("verifier maintenance gc failed: %s", e)
            out["gc-error"] = str(e)
        return out

    def start_maintenance(self, interval_s: float = 5.0) -> None:
        """Run :meth:`maintain` on a daemon thread every
        ``interval_s`` — the production-service mode (``cli serve
        --ingest`` in the JAX package).  :meth:`close` stops and joins
        it."""
        if self._maint is not None:
            return
        self._maint_stop.clear()

        def loop() -> None:
            while not self._maint_stop.wait(interval_s):
                self.maintain()

        self._maint = threading.Thread(
            target=loop, daemon=True, name="verifier-maintenance")
        self._maint.start()

    def _journal_gauge(self) -> None:
        """Aggregate on-disk journal bytes across live sessions — the
        quantity compaction bounds (bounded, not monotone)."""
        with self._lock:
            lives = list(self._live.values())
        total = 0
        for live in lives:
            total += live.journal.disk_bytes()
        _registry().gauge("verifier-journal-bytes").set(total)

    # -- listings / metrics -------------------------------------------------

    def sessions(self) -> List[Dict[str, Any]]:
        """Every session, live ones first-hand, on-disk ones from
        their ``session.json`` snapshots."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, meta in scan_sessions(self.base):
            out[name] = dict(meta, live=False)
        with self._lock:
            lives = list(self._live.values())
        for live in lives:
            with live.lock:
                out[live.name] = dict(live.snapshot(), live=True)
        return [out[k] for k in sorted(out)]

    @staticmethod
    def _drop_session_series(name: str) -> None:
        """Retire a finished session's per-session labeled series — a
        long-lived daemon handling many short sessions must not grow
        /metrics (and registry memory) monotonically."""
        try:
            _registry().remove("verifier-verdict-freshness-s",
                               session=name)
        except Exception:  # noqa: BLE001 — observability cleanup only
            pass

    def host_freshness(self) -> Dict[str, Dict[str, Any]]:
        """Per-host verdict freshness over OPEN live sessions whose
        config names the executing host (fleet cells stamp it via
        their ``fleet-host``) — the /fleet dashboard's ingest-lag
        column.  Freshness is measured entirely
        on this service's clock (last ingest vs last verdict), so it
        needs no worker clock correction."""
        with self._lock:
            lives = list(self._live.values())
        out: Dict[str, Dict[str, Any]] = {}
        for live in lives:
            with live.lock:
                if live.dead or live.seal_result is not None:
                    continue
                host = live.config.get("host")
                if not host:
                    continue
                fresh = round(max(0.0, live.last_ingest
                                  - live.last_verdict_ts), 3)
            cur = out.setdefault(str(host),
                                 {"freshness-s": 0.0, "sessions": 0})
            cur["sessions"] += 1
            cur["freshness-s"] = max(cur["freshness-s"], fresh)
        return out

    def _update_gauges(self) -> None:
        with self._lock:
            active = sum(1 for v in self._live.values()
                         if v.seal_result is None)
        _registry().gauge("verifier-sessions-active").set(active)

    def close(self) -> None:
        """Stop and join the maintenance thread (it finishes its current
        tick), then close every live session's journal and stream."""
        if self._maint is not None:
            self._maint_stop.set()
            self._maint.join()
            self._maint = None
        with self._lock:
            lives = list(self._live.values())
            self._live.clear()
        for live in lives:
            with live.lock:
                live.dead = True
                live.persist()
                live.close("service-stop")


def _as_float(v: Any, default: Optional[float] = None
              ) -> Optional[float]:
    if v is None:
        return default
    try:
        f = float(v)
    except (TypeError, ValueError):
        return default
    return f if f > 0 else default


def scan_sessions(base: str) -> List[Tuple[str, Dict[str, Any]]]:
    """On-disk session snapshots under ``<store>/verifier/`` — the
    read-only listing the web pages use when no service is attached.
    Skips the ``_archive/`` retention subtree (and anything else
    ``_``/``.``-prefixed — not session dirs)."""
    root = os.path.join(base, VERIFIER_DIR)
    out: List[Tuple[str, Dict[str, Any]]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for n in names:
        d = os.path.join(root, n)
        if not os.path.isdir(d) or n.startswith(("_", ".")):
            continue
        meta = read_meta(d)
        if meta is None:
            meta = {"session": n, "state": "?"}
        out.append((n, meta))
    return out
