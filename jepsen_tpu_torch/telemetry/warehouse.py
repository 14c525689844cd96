"""The observatory: a zero-dep sqlite telemetry warehouse (the port's
copy of `jepsen_tpu/telemetry/warehouse.py`).

Every run *emits* rich telemetry (``telemetry.json`` span forests,
``events.jsonl`` streams, campaign jsonl ledgers), but *querying* it
without an index means re-parsing every file per request — the jsonl
scan cost that bites ``Index.flips()`` / ``span_trend()`` at fleet
scale.  This module ingests all of it into one indexed sqlite file,
``<store>/warehouse.sqlite``, and pushes the hot campaign queries down
to SQL.

Contracts:

- **The jsonl ledgers stay the source of truth.**  The warehouse is a
  derived index: ``rebuild()`` (``cli obs rebuild``) reconstructs it
  from scratch at any time, and every query surface keeps a jsonl
  fallback for stores that never built one.
- **Ingest is incremental.**  Campaign ledgers are keyed by a byte
  cursor (only appended records are parsed on re-ingest), run dirs by a
  stat digest of their artifacts (an unchanged run is a no-op), event
  streams by the live file's byte cursor plus a rotated-segment
  signature.  Re-ingesting an unchanged store touches nothing.
- **Crash-consistent.**  Each ingest unit (one ledger, one run dir,
  one dir's event stream) commits atomically; a crash mid-ingest rolls
  the in-flight unit back and the next ingest simply redoes it.
- **Exact.**  The SQL-backed queries return byte-identical results to
  the jsonl scans (asserted in tests): same ordering, same percentile
  formula, same rounding.

Tables (see ``docs/TELEMETRY.md`` for the query cookbook):

- ``campaign_records`` + ``record_spans`` — one row per ledger record,
  span durations exploded for indexed trend queries.
- ``runs`` / ``run_spans`` / ``run_metrics`` — per run dir: verdict +
  attribution flags, per-span total/count, counter & gauge snapshot;
  runs retired to ``_archive/`` by ``obs gc`` keep their rows with
  ``archived = 1`` (schema v6) so the history stays queryable.
- ``witnesses`` — minimal-witness summaries (``witness.json``).
- ``events`` — streamed flight-recorder events (``cli tail --since``).
- ``bench`` — BENCH payloads (``cli obs ingest --bench
  BENCH_r0*.json`` loads a benchmark trajectory; the port has no
  benchmark of its own that self-ingests yet).
- ``ledgers`` / ``event_cursors`` — the incremental-ingest bookkeeping.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("jepsen.warehouse")

__all__ = ["Warehouse", "warehouse_path", "open_if_exists", "for_ledger",
           "WAREHOUSE_FILE", "SCHEMA_VERSION"]

WAREHOUSE_FILE = "warehouse.sqlite"
SCHEMA_VERSION = 7

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta(
    key TEXT PRIMARY KEY, value TEXT);
CREATE TABLE IF NOT EXISTS ledgers(
    path TEXT PRIMARY KEY,          -- store-relative ledger path
    cursor INTEGER NOT NULL DEFAULT 0);
CREATE TABLE IF NOT EXISTS campaign_records(
    id INTEGER PRIMARY KEY,
    ledger TEXT NOT NULL,
    campaign TEXT, run TEXT, key TEXT,
    workload TEXT, fault TEXT, seed TEXT,  -- seed JSON-encoded
    valid TEXT,                     -- JSON-encoded verdict; NULL=absent
    error TEXT, degraded TEXT, deadline INTEGER,
    dir TEXT, ops INTEGER, wall_s REAL,
    gen TEXT, spec TEXT, ts TEXT,
    witness TEXT,                   -- JSON witness summary, or NULL
    trace TEXT,                     -- distributed trace id
    phases TEXT,                    -- {span: {bucket: s}} JSON
    counters TEXT);                 -- forensic counter totals, JSON
CREATE INDEX IF NOT EXISTS cr_ledger_key ON campaign_records(ledger, key, id);
CREATE INDEX IF NOT EXISTS cr_ledger_run ON campaign_records(ledger, run, id);
CREATE TABLE IF NOT EXISTS record_spans(
    record_id INTEGER NOT NULL,
    ledger TEXT NOT NULL,
    name TEXT NOT NULL,
    dur_s REAL NOT NULL);
CREATE INDEX IF NOT EXISTS rs_ledger_name ON record_spans(ledger, name, record_id);
CREATE INDEX IF NOT EXISTS rs_record ON record_spans(record_id);
-- materialized at ingest time (the hot queries are O(result), not
-- O(records)): verdict flips per regression key, and per-span-name
-- duration rollups (whole-ledger stats + per-generation p95)
CREATE TABLE IF NOT EXISTS flip_rollup(
    record_id INTEGER NOT NULL,     -- the id of the LATER record
    ledger TEXT NOT NULL,
    key TEXT NOT NULL, run TEXT,
    from_valid TEXT NOT NULL, to_valid TEXT NOT NULL,
    regression INTEGER NOT NULL, ts TEXT, gen TEXT);
CREATE INDEX IF NOT EXISTS flr_ledger ON flip_rollup(ledger, key, record_id);
CREATE TABLE IF NOT EXISTS span_rollup(
    ledger TEXT NOT NULL, name TEXT NOT NULL,
    count INTEGER NOT NULL, min REAL, p50 REAL, p95 REAL, max REAL,
    PRIMARY KEY(ledger, name));
CREATE TABLE IF NOT EXISTS span_gen_rollup(
    ledger TEXT NOT NULL, name TEXT NOT NULL,
    gen TEXT NOT NULL,              -- str(gen or "?"), the trend label
    first_id INTEGER NOT NULL,      -- first sample's record id: order
    p95 REAL,
    PRIMARY KEY(ledger, name, gen));
CREATE TABLE IF NOT EXISTS runs(
    dir TEXT PRIMARY KEY,           -- store-relative run dir
    name TEXT, ts TEXT,
    digest TEXT NOT NULL,
    valid TEXT, error TEXT, degraded TEXT, deadline INTEGER,
    status TEXT NOT NULL DEFAULT 'done',  -- 'running' until results.json
    archived INTEGER NOT NULL DEFAULT 0,  -- 1: retired to _archive/
    ingested_at REAL);
CREATE TABLE IF NOT EXISTS verifier_sessions(
    name TEXT PRIMARY KEY,          -- session dir name
    state TEXT, valid TEXT, anomalies TEXT,
    txns INTEGER, ops INTEGER, segments INTEGER,
    digest TEXT, seal_equal INTEGER, updated REAL);
CREATE TABLE IF NOT EXISTS run_spans(
    dir TEXT NOT NULL, name TEXT NOT NULL,
    total_s REAL NOT NULL, count INTEGER NOT NULL);
CREATE INDEX IF NOT EXISTS runsp_dir ON run_spans(dir);
CREATE INDEX IF NOT EXISTS runsp_name ON run_spans(name);
CREATE TABLE IF NOT EXISTS run_metrics(
    dir TEXT NOT NULL, kind TEXT NOT NULL,
    name TEXT NOT NULL, labels TEXT NOT NULL, value REAL);
CREATE INDEX IF NOT EXISTS runm_dir ON run_metrics(dir);
CREATE TABLE IF NOT EXISTS witnesses(
    dir TEXT PRIMARY KEY,
    ops INTEGER, source_ops INTEGER, digest TEXT,
    anomalies TEXT, probes INTEGER);
CREATE TABLE IF NOT EXISTS events(
    id INTEGER PRIMARY KEY,
    dir TEXT NOT NULL, t REAL, ev TEXT, doc TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS ev_dir_t ON events(dir, t, id);
CREATE TABLE IF NOT EXISTS event_cursors(
    dir TEXT PRIMARY KEY,
    cursor INTEGER NOT NULL,        -- byte cursor into the LIVE file
    sig TEXT NOT NULL,              -- rotated-segment signature (JSON)
    head TEXT NOT NULL DEFAULT ''); -- live file's first line (session id)
CREATE TABLE IF NOT EXISTS fleet_events(
    id INTEGER PRIMARY KEY,
    ledger TEXT NOT NULL,           -- store-relative fleet ledger path
    ev TEXT, run TEXT, worker TEXT, reason TEXT, ts REAL,
    deadline REAL,
    spans TEXT);                    -- complete events: the record's
                                    -- fleet:* segment durations (JSON)
CREATE INDEX IF NOT EXISTS fe_ledger_ev ON fleet_events(ledger, ev, id);
CREATE INDEX IF NOT EXISTS fe_worker ON fleet_events(ledger, worker, id);
-- materialized per-worker rollup (the "which host's cells requeue
-- most" query): recomputed per ingest batch from fleet_events
CREATE TABLE IF NOT EXISTS fleet_worker_rollup(
    ledger TEXT NOT NULL, worker TEXT NOT NULL,
    claims INTEGER NOT NULL DEFAULT 0,
    renews INTEGER NOT NULL DEFAULT 0,
    completes INTEGER NOT NULL DEFAULT 0,
    requeues INTEGER NOT NULL DEFAULT 0,
    duplicates INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY(ledger, worker));
CREATE TABLE IF NOT EXISTS bench(
    source TEXT PRIMARY KEY,
    ingested_at REAL,
    metric TEXT, value REAL, unit TEXT, vs_baseline REAL,
    n_txns INTEGER, backend TEXT, wall_s REAL,
    compile_or_warmup_s REAL, doc TEXT NOT NULL);
-- cross-host timeline stitching (schema v4): one row per
-- host-attributed trace segment, stitched from fleet ledgers (enqueue
-- wait / attempts / execute), landed run dirs (telemetry.json phase
-- spans on absolute time), and verifier session snapshots (live
-- sessions).  trace_id is a pure function of the run id, so segments
-- from artifacts that never traveled together join on it.
CREATE TABLE IF NOT EXISTS trace_spans(
    id INTEGER PRIMARY KEY,
    trace_id TEXT NOT NULL,
    origin TEXT NOT NULL,          -- ingest unit, for per-unit wipes
    source TEXT NOT NULL,          -- fleet | run | verifier
    run TEXT, host TEXT,
    name TEXT NOT NULL,
    t0 REAL, t1 REAL, dur_s REAL);
CREATE INDEX IF NOT EXISTS tsp_trace ON trace_spans(trace_id, t0, id);
CREATE INDEX IF NOT EXISTS tsp_run ON trace_spans(run);
CREATE INDEX IF NOT EXISTS tsp_origin ON trace_spans(origin);
-- per-(site, shape-class) device-call profile (schema v5):
-- one row per run dir per shape class, exploded from the span attrs
-- `resilience.guard._stamp_device_time` accumulates — the `cli obs
-- profile` treemap's raw material, host-attributed for fleet stitching
CREATE TABLE IF NOT EXISTS span_profile(
    dir TEXT NOT NULL,             -- origin run dir, for per-unit wipes
    host TEXT,
    site TEXT NOT NULL,
    shape TEXT NOT NULL,
    calls INTEGER NOT NULL DEFAULT 0,
    compile_s REAL NOT NULL DEFAULT 0,
    execute_s REAL NOT NULL DEFAULT 0,
    device_dispatch_s REAL NOT NULL DEFAULT 0);
CREATE INDEX IF NOT EXISTS spf_dir ON span_profile(dir);
CREATE INDEX IF NOT EXISTS spf_site ON span_profile(site, shape);
-- generation-horizon compaction (schema v7): past a kept
-- horizon, a campaign ledger's raw per-record rows fold into bounded
-- per-generation summaries and are DROPPED (witness-bearing rows
-- survive so witness queries stay exact).  flip_rollup and
-- span_gen_rollup rows are never dropped — the compact-safe queries
-- (flips / span_trend / witness_diffs / the alert tick) union
-- compacted + live transparently, everything else falls back to the
-- jsonl scan once a ledger is compacted.
CREATE TABLE IF NOT EXISTS gen_compact(
    ledger TEXT NOT NULL, gen TEXT NOT NULL,
    first_id INTEGER NOT NULL,      -- first record id: trend order
    records INTEGER NOT NULL,
    verdicts TEXT NOT NULL,         -- {"true": n, "false": n, ...}
    PRIMARY KEY(ledger, gen));
CREATE TABLE IF NOT EXISTS key_compact(
    ledger TEXT NOT NULL, key TEXT NOT NULL,
    last_valid TEXT,                -- last folded verdict (JSON)
    last_id INTEGER NOT NULL,       -- its record id
    PRIMARY KEY(ledger, key));
"""

#: every row-holding table, in wipe order (rebuild / per-unit deletes)
_DATA_TABLES = ("record_spans", "flip_rollup", "span_rollup",
                "span_gen_rollup", "gen_compact", "key_compact",
                "campaign_records", "ledgers",
                "run_spans", "run_metrics", "span_profile",
                "witnesses", "runs",
                "events", "event_cursors", "verifier_sessions",
                "fleet_events", "fleet_worker_rollup", "trace_spans",
                "bench")


def warehouse_path(base: str) -> str:
    """The store's warehouse file: ``<store>/warehouse.sqlite``."""
    return os.path.join(base, WAREHOUSE_FILE)


def _percentile(xs: List[float], q: float) -> float:
    """THE ledger span percentile (round nearest-rank) — imported from
    the jsonl path so the two backends can't disagree."""
    from jepsen_tpu_torch.campaign.index import _percentile as p

    return p(xs, q)


_JSON_SIMPLE = {"true": True, "false": False, "null": None}
_MISS = object()


def _loads(s: str) -> Any:
    """json.loads with a fast path for the three verdict literals —
    the flips/latest decode loop is on the web request path."""
    v = _JSON_SIMPLE.get(s, _MISS)
    return json.loads(s) if v is _MISS else v


class Warehouse:
    """One sqlite warehouse.  Thread-safe: a single connection guarded
    by a lock (handlers on the threaded web server share a cached
    instance via :func:`for_ledger`)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.RLock()
        self._batch_depth = 0
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA synchronous=NORMAL")
        with self._lock, self.db:
            self.db.executescript(_SCHEMA)
            # v1 -> v2 migration: the runs.status column (in-progress
            # runs land as status='running' instead of being
            # indistinguishable from done-but-resultless ones)
            cols = {r[1] for r in self.db.execute(
                "PRAGMA table_info(runs)").fetchall()}
            if "status" not in cols:
                self.db.execute("ALTER TABLE runs ADD COLUMN status "
                                "TEXT NOT NULL DEFAULT 'done'")
            # v3 -> v4 migration: fleet_events.spans (the worker's
            # fleet:* segment durations ride the complete event into
            # the trace_spans view) and campaign_records.trace
            fcols = {r[1] for r in self.db.execute(
                "PRAGMA table_info(fleet_events)").fetchall()}
            if "spans" not in fcols:
                self.db.execute(
                    "ALTER TABLE fleet_events ADD COLUMN spans TEXT")
            ccols = {r[1] for r in self.db.execute(
                "PRAGMA table_info(campaign_records)").fetchall()}
            if "trace" not in ccols:
                self.db.execute("ALTER TABLE campaign_records "
                                "ADD COLUMN trace TEXT")
            # v4 -> v5 migration: campaign_records grows the
            # phase-bucket and forensic-counter JSON columns; the new
            # span_profile table itself is covered by the CREATE IF NOT
            # EXISTS above.  ALTER-only: existing rows keep NULL until
            # their ledger is re-ingested (obs rebuild).
            for col in ("phases", "counters"):
                if col not in ccols:
                    self.db.execute("ALTER TABLE campaign_records "
                                    f"ADD COLUMN {col} TEXT")
            # v6 -> v7 migration: the gen_compact /
            # key_compact tables are covered by the CREATE IF NOT
            # EXISTS above — no ALTERs; an existing warehouse upgrades
            # in place and stays uncompacted until compact_ledger runs.
            # v5 -> v6 migration: runs.archived —
            # runs retired to _archive/ by `obs gc` stay queryable
            # (``obs sql``) with the dimension to tell them apart from
            # the live store.  ALTER-only, default 0.
            if "archived" not in cols:
                self.db.execute("ALTER TABLE runs ADD COLUMN archived "
                                "INTEGER NOT NULL DEFAULT 0")
            self.db.execute(
                "INSERT OR REPLACE INTO meta(key, value) VALUES "
                "('schema_version', ?)", (str(SCHEMA_VERSION),))
        # on-disk identity at open: lets the handle cache detect a
        # deleted/replaced file (rm + rebuild in another process) and
        # re-open instead of serving an unlinked inode forever
        st = os.stat(path)
        self._file_id = (st.st_ino, st.st_dev)

    def file_unchanged(self) -> bool:
        """True while ``self.path`` still names the inode this handle
        opened — False once the file was deleted or replaced."""
        try:
            st = os.stat(self.path)
        except OSError:
            return False
        return (st.st_ino, st.st_dev) == self._file_id

    def close(self) -> None:
        with self._lock:
            try:
                self.db.close()
            except sqlite3.Error:
                pass

    def __enter__(self) -> "Warehouse":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- ingest batching -----------------------------

    @contextmanager
    def _txn(self) -> Any:
        """One ingest unit's transaction boundary.  Standalone, this
        is exactly the old ``with self.db:`` (commit on success, roll
        the unit back on error).  Inside :meth:`batch` it is a no-op
        participant — a nested ``with self.db:`` would COMMIT the
        enclosing batch's work-in-progress on its own exit, which is
        the sqlite footgun the depth counter exists to dodge."""
        with self._lock:
            if self._batch_depth > 0:
                yield
            else:
                with self.db:
                    yield

    @contextmanager
    def batch(self) -> Any:
        """Group many ingest units into ONE transaction (one fsync,
        one cursor flush) — the 100k-run ingest path.  Crash semantics
        coarsen from per-unit to per-batch: a crash mid-batch rolls
        the whole batch back and the next ingest redoes it, which the
        byte cursors make idempotent.  Reentrant: a batch inside a
        batch joins the outer transaction."""
        with self._lock:
            self._batch_depth += 1
            try:
                if self._batch_depth == 1:
                    with self.db:
                        yield
                else:
                    yield
            finally:
                self._batch_depth -= 1

    # -- ingest: byte-cursor jsonl core (campaign + fleet ledgers) -----------

    def _ingest_jsonl(self, path: str, base: str, *,
                      wipe: Any, insert: Any, flush: Any = None) -> int:
        """THE byte-cursor jsonl ingest discipline, shared by every
        ledger family so the subtle invariants can't drift between
        copies: only lines appended since the last ingest are parsed;
        a torn/unparsable tail line is left unconsumed (the writer's
        heal truncates it, after which cursor == size again); a file
        shrunk below the cursor was healed/rewritten — ``wipe(rel)``
        drops its derived rows and ingest restarts from byte 0.  One
        transaction per batch: ``insert(rel, rec)`` rows, the
        ``flush(rel)`` rollup refresh, and the cursor land atomically,
        so a crash mid-ingest rolls the whole unit back and the next
        ingest simply redoes it.  Returns the number of new records."""
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(base))
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        with self._lock:
            row = self.db.execute(
                "SELECT cursor FROM ledgers WHERE path = ?",
                (rel,)).fetchone()
            cursor = row[0] if row else 0
            if size < cursor:
                with self._txn():
                    wipe(rel)
                cursor = 0
            if size == cursor:
                return 0
            new = 0
            with self._txn(), open(path, "rb") as f:
                f.seek(cursor)
                for line in f:
                    if not line.endswith(b"\n"):
                        break  # torn tail: an append is in flight
                    if not line.strip():
                        cursor += len(line)
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break  # crash debris: healed by the next writer
                    if isinstance(rec, dict):
                        insert(rel, rec)
                        new += 1
                    cursor += len(line)
                if new and flush is not None:
                    flush(rel)
                self.db.execute(
                    "INSERT INTO ledgers(path, cursor) VALUES (?, ?) "
                    "ON CONFLICT(path) DO UPDATE SET cursor = ?",
                    (rel, cursor, cursor))
            return new

    # -- ingest: campaign ledgers -------------------------------------------

    def ingest_ledger(self, path: str, base: str) -> int:
        """Incrementally ingest one campaign jsonl ledger; returns the
        number of new records (cursor/torn/shrink semantics:
        :meth:`_ingest_jsonl`)."""
        last_valid: Dict[str, Any] = {}  # key -> last verdict seen
        touched_spans: set = set()

        def insert(rel: str, rec: Dict[str, Any]) -> None:
            rid = self._insert_record(rel, rec)
            self._update_flips(rel, rid, rec, last_valid)
            spans = rec.get("spans")
            if isinstance(spans, dict):
                touched_spans.update(spans)

        def flush(rel: str) -> None:
            if touched_spans:
                self._refresh_span_rollups(rel, touched_spans)

        return self._ingest_jsonl(path, base, wipe=self._wipe_ledger,
                                  insert=insert, flush=flush)

    def _update_flips(self, ledger: str, rid: int, rec: Dict[str, Any],
                      last_valid: Dict[str, Any]) -> None:
        """Incrementally maintain the flip rollup: pair this record's
        verdict with the previous verdict-bearing record for the same
        key (seeded from SQL on the key's first sighting in a batch,
        then carried in ``last_valid``).  Comparison is on the DECODED
        Python values — exactly the jsonl scan's ``!=``."""
        key = rec.get("key")
        if "valid?" not in rec or not key:
            return
        cur = rec["valid?"]
        prev = last_valid.get(key, _MISS)
        if prev is _MISS:
            row = self.db.execute(
                "SELECT id, valid FROM campaign_records WHERE ledger = ? "
                "AND key = ? AND valid IS NOT NULL AND id < ? "
                "ORDER BY id DESC LIMIT 1", (ledger, key, rid)).fetchone()
            # compaction may have folded the key's raw history away
            # (leaving at most witness-bearing rows): the folded last
            # verdict lives in key_compact — prefer whichever is later
            krow = self.db.execute(
                "SELECT last_id, last_valid FROM key_compact "
                "WHERE ledger = ? AND key = ?", (ledger, key)).fetchone()
            if krow is not None and krow[1] is not None and \
                    (row is None or krow[0] > row[0]):
                prev = _loads(krow[1])
            elif row is not None:
                prev = _loads(row[1])
        if prev is not _MISS and prev != cur:
            self.db.execute(
                "INSERT INTO flip_rollup(record_id, ledger, key, run, "
                "from_valid, to_valid, regression, ts, gen) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (rid, ledger, key, rec.get("run"), json.dumps(prev),
                 json.dumps(cur), 1 if prev is True else 0,
                 rec.get("ts"), rec.get("gen")))
        last_valid[key] = cur

    def _refresh_span_rollups(self, ledger: str, names: Any) -> None:
        """Recompute the span rollups for the names a batch touched —
        the percentiles can't be maintained incrementally, so ingest
        re-derives them from ``record_spans`` (already in SQL) and the
        queries become single indexed lookups."""
        # compacted generations' per-gen rollups are FROZEN — their
        # raw record_spans are gone, so a recompute would lose them;
        # the refresh only replaces the live gens' rows
        compacted = {g for (g,) in self.db.execute(
            "SELECT gen FROM gen_compact WHERE ledger = ?",
            (ledger,)).fetchall()}
        for name in sorted(names):
            rows = self.db.execute(
                "SELECT s.record_id, s.dur_s, r.gen FROM record_spans s "
                "JOIN campaign_records r ON r.id = s.record_id "
                "WHERE s.ledger = ? AND s.name = ? ORDER BY s.record_id",
                (ledger, name)).fetchall()
            self.db.execute(
                "DELETE FROM span_rollup WHERE ledger = ? AND name = ?",
                (ledger, name))
            if compacted:
                self.db.execute(
                    "DELETE FROM span_gen_rollup WHERE ledger = ? "
                    "AND name = ? AND gen NOT IN (SELECT gen FROM "
                    "gen_compact WHERE ledger = ?)",
                    (ledger, name, ledger))
            else:
                self.db.execute(
                    "DELETE FROM span_gen_rollup WHERE ledger = ? "
                    "AND name = ?", (ledger, name))
            if not rows:
                continue
            vals = [dur for _, dur, _ in rows]
            self.db.execute(
                "INSERT INTO span_rollup(ledger, name, count, min, p50, "
                "p95, max) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (ledger, name, len(vals), round(min(vals), 6),
                 round(_percentile(vals, 50), 6),
                 round(_percentile(vals, 95), 6), round(max(vals), 6)))
            by_gen: Dict[str, List[float]] = {}
            first: Dict[str, int] = {}
            for rid, dur, gen in rows:
                g = str(gen or "?")
                if g not in by_gen:
                    first[g] = rid
                by_gen.setdefault(g, []).append(dur)
            self.db.executemany(
                "INSERT INTO span_gen_rollup(ledger, name, gen, "
                "first_id, p95) VALUES (?, ?, ?, ?, ?)",
                [(ledger, name, g, first[g],
                  round(_percentile(vs, 95), 6))
                 for g, vs in by_gen.items() if g not in compacted])

    def _wipe_ledger(self, rel: str) -> None:
        for tbl in ("record_spans", "flip_rollup", "span_rollup",
                    "span_gen_rollup", "gen_compact", "key_compact"):
            self.db.execute(f"DELETE FROM {tbl} WHERE ledger = ?", (rel,))
        self.db.execute("DELETE FROM campaign_records WHERE ledger = ?",
                        (rel,))
        self.db.execute("DELETE FROM ledgers WHERE path = ?", (rel,))

    def _insert_record(self, ledger: str, rec: Dict[str, Any]) -> int:
        # the id is allocated IN the insert, never below the persisted
        # record_id_floor: sqlite's implicit rowid restarts at
        # MAX(rowid)+1 of the rows *currently present*, so after
        # compact_ledger drops a ledger's raw rows a fresh ingest
        # would otherwise be handed ids BELOW the record_ids that
        # flip_rollup / key_compact still reference — inverting
        # ``ORDER BY key, record_id`` relative to jsonl append order
        w = rec.get("witness")
        phases = rec.get("phases")
        counters = rec.get("counters")
        cur = self.db.execute(
            "INSERT INTO campaign_records(id, ledger, campaign, run, "
            "key, workload, fault, seed, valid, error, degraded, "
            "deadline, dir, ops, wall_s, gen, spec, ts, witness, trace, "
            "phases, counters) "
            "VALUES (MAX((SELECT COALESCE(MAX(id), 0) "
            "             FROM campaign_records), "
            "            (SELECT COALESCE(CAST(value AS INTEGER), 0) "
            "             FROM meta WHERE key = 'record_id_floor')) "
            "        + 1, "
            "?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, "
            "?, ?, ?)",
            (ledger, rec.get("campaign"), rec.get("run"),
             rec.get("key"),
             rec.get("workload"), rec.get("fault"),
             json.dumps(rec.get("seed")),
             json.dumps(rec["valid?"]) if "valid?" in rec else None,
             rec.get("error"), rec.get("degraded"),
             1 if rec.get("deadline") else 0,
             rec.get("dir"), rec.get("ops"), rec.get("wall_s"),
             rec.get("gen"), rec.get("spec"), rec.get("ts"),
             json.dumps(w) if isinstance(w, dict) else None,
             rec.get("trace"),
             json.dumps(phases) if isinstance(phases, dict) else None,
             json.dumps(counters) if isinstance(counters, dict)
             else None))
        rid = cur.lastrowid
        spans = rec.get("spans") or {}
        if isinstance(spans, dict):
            rows = [(rid, ledger, name, float(dur))
                    for name, dur in spans.items()
                    if isinstance(dur, (int, float))]
            if rows:
                self.db.executemany(
                    "INSERT INTO record_spans(record_id, ledger, name, "
                    "dur_s) VALUES (?, ?, ?, ?)", rows)
        return rid

    def ledger_fresh(self, path: str, base: str) -> bool:
        """True iff this ledger is fully ingested (cursor == file size)
        — the gate for the SQL fast path.  A missing file with no
        cursor row counts as fresh (both sides empty)."""
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(base))
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        with self._lock:
            row = self.db.execute(
                "SELECT cursor FROM ledgers WHERE path = ?",
                (rel,)).fetchone()
        return (row[0] if row else 0) == size

    # -- ingest: run dirs ----------------------------------------------------

    @staticmethod
    def _run_digest(d: str) -> str:
        parts = []
        for fn in ("results.json", "telemetry.json", "witness.json"):
            try:
                st = os.stat(os.path.join(d, fn))
                parts.append(f"{fn}:{st.st_size}:{st.st_mtime_ns}")
            except OSError:
                parts.append(f"{fn}:-")
        return "|".join(parts)

    def ingest_run_dir(self, d: str, base: str,
                       archived: bool = False) -> bool:
        """Ingest one run dir (verdict + spans + metric snapshot +
        witness); returns True if anything changed.  Keyed by a stat
        digest of the artifacts — an unchanged run is a no-op.  Missing
        or unreadable artifacts are tolerated: a run with no
        telemetry.json still gets its verdict row, and a run with no
        ``results.json`` *yet* (still executing, or crashed before
        analysis) is recorded as ``status = 'running'`` instead of
        being skipped — so fleet views and the verifier's session list
        include live work.  When results appear the
        stat digest changes and the row flips to ``'done'``.

        `archived`: the run lives under
        ``_archive/`` (``obs gc`` retention) — its row carries
        ``archived = 1``, and the stale live-path rows the run left
        behind when it was retired are wiped so rollups don't count it
        twice."""
        rel = os.path.relpath(os.path.abspath(d), os.path.abspath(base))
        digest = self._run_digest(d)
        with self._lock:
            row = self.db.execute(
                "SELECT digest FROM runs WHERE dir = ?", (rel,)).fetchone()
            if row and row[0] == digest:
                return False
            valid, flags = self._run_results(d)
            status = "running" if valid is _ABSENT else "done"
            spans, metrics, profile, host = self._run_telemetry(d)
            traces = self._run_trace_rows(d, rel)
            wit = self._run_witness(d)
            # the dir this run occupied before gc moved it (rel is
            # "_archive/<name>/<ts>"; the basename may carry a
            # collision suffix the live dir never had — strip nothing,
            # the live rel is exactly the path minus the prefix)
            stale = (os.path.relpath(rel, "_archive")
                     if archived else None)
            with self._txn():
                for tbl in ("runs", "run_spans", "run_metrics",
                            "witnesses", "span_profile"):
                    self.db.execute(
                        f"DELETE FROM {tbl} WHERE dir = ?", (rel,))
                    if stale:
                        self.db.execute(
                            f"DELETE FROM {tbl} WHERE dir = ?", (stale,))
                self.db.execute(
                    "DELETE FROM trace_spans WHERE origin = ?", (rel,))
                if stale:
                    self.db.execute(
                        "DELETE FROM trace_spans WHERE origin = ?",
                        (stale,))
                if traces:
                    self.db.executemany(
                        "INSERT INTO trace_spans(trace_id, origin, "
                        "source, run, host, name, t0, t1, dur_s) "
                        "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)", traces)
                self.db.execute(
                    "INSERT INTO runs(dir, name, ts, digest, valid, "
                    "error, degraded, deadline, status, archived, "
                    "ingested_at) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    (rel, os.path.basename(os.path.dirname(rel)) or None,
                     os.path.basename(rel), digest,
                     json.dumps(valid) if valid is not _ABSENT else None,
                     flags.get("error"), flags.get("degraded"),
                     1 if flags.get("deadline") else 0, status,
                     1 if archived else 0, time.time()))
                if spans:
                    self.db.executemany(
                        "INSERT INTO run_spans(dir, name, total_s, count) "
                        "VALUES (?, ?, ?, ?)",
                        [(rel, n, t, c) for n, (t, c) in
                         sorted(spans.items())])
                if metrics:
                    self.db.executemany(
                        "INSERT INTO run_metrics(dir, kind, name, labels, "
                        "value) VALUES (?, ?, ?, ?, ?)",
                        [(rel,) + m for m in metrics])
                if profile:
                    self.db.executemany(
                        "INSERT INTO span_profile(dir, host, site, "
                        "shape, calls, compile_s, execute_s, "
                        "device_dispatch_s) "
                        "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                        [(rel, host, site, shape, c["calls"],
                          round(c["compile_s"], 6),
                          round(c["execute_s"], 6),
                          round(c["device_dispatch_s"], 6))
                         for (site, shape), c in sorted(profile.items())])
                if wit is not None:
                    self.db.execute(
                        "INSERT INTO witnesses(dir, ops, source_ops, "
                        "digest, anomalies, probes) "
                        "VALUES (?, ?, ?, ?, ?, ?)",
                        (rel, wit.get("ops"), wit.get("source-ops"),
                         wit.get("digest"),
                         json.dumps(wit.get("anomaly-types") or []),
                         wit.get("probes")))
            return True

    def run_spans(self, d: str, base: Optional[str] = None
                  ) -> List[Tuple[str, float, int]]:
        """One ingested run's (span name, total seconds, count) rows,
        largest total first — the web run page's span profile.  ``d``
        may be store-relative already (pass ``base=None``)."""
        rel = (d if base is None else
               os.path.relpath(os.path.abspath(d), os.path.abspath(base)))
        with self._lock:
            return self.db.execute(
                "SELECT name, total_s, count FROM run_spans "
                "WHERE dir = ? ORDER BY total_s DESC, name",
                (rel,)).fetchall()

    @staticmethod
    def _run_results(d: str) -> Tuple[Any, Dict[str, Any]]:
        from jepsen_tpu_torch.campaign.core import result_flags

        try:
            with open(os.path.join(d, "results.json")) as f:
                res = json.load(f)
        except (OSError, ValueError):
            return _ABSENT, {}
        if not isinstance(res, dict):
            return _ABSENT, {}
        return res.get("valid?", _ABSENT), result_flags(res)

    @staticmethod
    def _run_telemetry(d: str) -> Tuple[Dict[str, Tuple[float, int]],
                                        List[Tuple],
                                        Dict[Tuple[str, str],
                                             Dict[str, Any]],
                                        Optional[str]]:
        """(spans, metric rows, profile, host) from telemetry.json:
        per-span-name (total seconds, count), counter/gauge/histogram
        snapshot rows for run_metrics, and the run's per-(site,
        shape-class) device-call profile summed over span
        ``profile`` attrs — ONE shared extraction
        (`forensics.profile_from_doc`), so the jsonl fallback and this
        ingest can't drift."""
        try:
            with open(os.path.join(d, "telemetry.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}, [], {}, None
        if not isinstance(doc, dict):
            return {}, [], {}, None
        spans: Dict[str, Tuple[float, int]] = {}

        def walk(sp: Dict[str, Any]) -> None:
            dur = sp.get("dur_ns")
            if isinstance(dur, (int, float)):
                t, c = spans.get(sp["name"], (0.0, 0))
                spans[sp["name"]] = (t + dur / 1e9, c + 1)
            for ch in sp.get("children") or []:
                walk(ch)

        for r in doc.get("spans", []) if isinstance(doc, dict) else []:
            walk(r)
        spans = {n: (round(t, 6), c) for n, (t, c) in spans.items()}
        from .forensics import profile_from_doc

        profile = profile_from_doc(doc)
        meta = doc.get("meta") or {}
        host = meta.get("host") if isinstance(meta, dict) else None
        m = doc.get("metrics") or {} if isinstance(doc, dict) else {}

        def lbl(entry: Dict[str, Any]) -> str:
            return json.dumps(entry.get("labels") or {}, sort_keys=True)

        rows: List[Tuple] = []
        for c in m.get("counters", []):
            if isinstance(c.get("value"), (int, float)):
                rows.append(("counter", c["name"], lbl(c),
                             float(c["value"])))
        for g in m.get("gauges", []):
            if isinstance(g.get("value"), (int, float)):
                rows.append(("gauge", g["name"], lbl(g),
                             float(g["value"])))
        for h in m.get("histograms", []):
            if isinstance(h.get("count"), (int, float)):
                rows.append(("histogram-count", h["name"], lbl(h),
                             float(h["count"])))
            if isinstance(h.get("sum"), (int, float)):
                rows.append(("histogram-sum", h["name"], lbl(h),
                             float(h["sum"])))
        return spans, rows, profile, host

    @staticmethod
    def _run_trace_rows(d: str, rel: str) -> List[Tuple]:
        """Host-attributed trace segments from a run dir's
        telemetry.json: the run root plus its direct phase
        children (workload, check:*, live-check.finish, store.save_1
        ...), placed on ABSOLUTE time via the collector's wall-clock
        anchor — so they interleave correctly with the fleet ledger's
        control-plane segments on one timeline.  Runs without a trace
        block (pre-v14 artifacts, non-traced runs) contribute
        nothing."""
        try:
            with open(os.path.join(d, "telemetry.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return []
        if not isinstance(doc, dict):
            return []
        trace = doc.get("trace") or {}
        tid = trace.get("trace-id")
        epoch = doc.get("epoch_ns")
        perf0 = doc.get("perf0_ns")
        if not tid or not isinstance(epoch, (int, float)) \
                or not isinstance(perf0, (int, float)):
            return []
        meta = doc.get("meta") or {}
        host = meta.get("host")
        run = meta.get("run-id")
        rows: List[Tuple] = []

        def abs_s(t_ns: Any) -> Optional[float]:
            if not isinstance(t_ns, (int, float)):
                return None
            return round((epoch + (t_ns - perf0)) / 1e9, 6)

        def add(sp: Dict[str, Any], depth: int) -> None:
            t0 = abs_s(sp.get("t0_ns"))
            dur = sp.get("dur_ns")
            name = str(sp.get("name"))
            if t0 is not None and isinstance(dur, (int, float)):
                rows.append((tid, rel, "run", run, host,
                             name if depth == 0 else f"run:{name}",
                             t0, round(t0 + dur / 1e9, 6),
                             round(dur / 1e9, 6)))
            if depth < 1:
                for c in sp.get("children") or []:
                    add(c, depth + 1)

        for r in doc.get("spans") or []:
            add(r, 0)
        return rows[:64]  # phase-level rows only; leaves stay in
        # telemetry.json (the timeline answers "where did the 40 s
        # go", not "render the whole span forest")

    @staticmethod
    def _run_witness(d: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(d, "witness.json")) as f:
                w = json.load(f)
        except (OSError, ValueError):
            return None
        return w if isinstance(w, dict) else None

    # -- ingest: event streams ----------------------------------------------

    def ingest_events(self, d: str, base: str) -> int:
        """Ingest a run dir's streamed ``events.jsonl`` (rotated
        segments included); returns new-event count.  Fast path: when
        the rotated-segment signature AND the live file's first line
        (the session id — a truncate-and-regrow new session can pass a
        pure size check) are unchanged, only bytes appended to the
        live file since the cursor are parsed.  Rotation or a new
        session wipes the dir's events and re-ingests the whole
        segment chain — the stream stays the source of truth — with
        the wipe, re-insert, and cursor in ONE transaction, so a crash
        mid-re-ingest rolls the unit back whole."""
        from .stream import EVENTS_FILE, read_events, segment_files

        rel = os.path.relpath(os.path.abspath(d), os.path.abspath(base))
        live = os.path.join(d, EVENTS_FILE)
        segs = [p for p in segment_files(live) if p != live]
        sig = json.dumps([[os.path.basename(p), self._size(p)]
                          for p in segs])
        head = self._head(live)
        live_size = self._size(live)
        if live_size is None and not segs:
            return 0
        with self._lock:
            row = self.db.execute(
                "SELECT cursor, sig, head FROM event_cursors "
                "WHERE dir = ?", (rel,)).fetchone()
            cursor, old_sig, old_head = row if row else (0, "[]", "")
            incremental = bool(row) and old_sig == sig \
                and old_head == head and (live_size or 0) >= cursor
            if incremental:
                evs, new_cursor = self._read_incremental(live, cursor)
                if not evs and new_cursor == cursor:
                    return 0
            else:
                # rotation / new session / first sight: full re-ingest
                evs = []
                for p in segs:
                    evs.extend(read_events(p, spanning=False))
                live_evs, new_cursor = self._read_incremental(live, 0)
                evs.extend(live_evs)
            with self._txn():
                if not incremental:
                    self.db.execute("DELETE FROM events WHERE dir = ?",
                                    (rel,))
                self.db.executemany(
                    "INSERT INTO events(dir, t, ev, doc) "
                    "VALUES (?, ?, ?, ?)",
                    [(rel, e.get("t"), e.get("ev"),
                      json.dumps(e, separators=(",", ":")))
                     for e in evs])
                self.db.execute(
                    "INSERT INTO event_cursors(dir, cursor, sig, head) "
                    "VALUES (?, ?, ?, ?) ON CONFLICT(dir) DO UPDATE "
                    "SET cursor = ?, sig = ?, head = ?",
                    (rel, new_cursor, sig, head,
                     new_cursor, sig, head))
            return len(evs)

    @staticmethod
    def _head(path: str) -> str:
        """The live file's first complete line, as the session
        identity — ONE implementation shared with the follow_events
        cursor (stream._first_line), so the ingest and the follower
        can't disagree about what counts as the same session."""
        from .stream import _first_line

        return _first_line(path)

    @staticmethod
    def _size(path: str) -> Optional[int]:
        try:
            return os.path.getsize(path)
        except OSError:
            return None

    @staticmethod
    def _read_incremental(path: str, cursor: int
                          ) -> Tuple[List[Dict[str, Any]], int]:
        from .stream import read_events_incremental

        # stop_at_corrupt: index exactly the prefix the read_events
        # scan delivers, so `tail --since` renders identically from
        # either backend (a corrupt line also pins cursor < size,
        # gating events_fresh off — the scan then answers)
        return read_events_incremental(path, cursor, follow_rotation=False,
                                       stop_at_corrupt=True)

    def events_fresh(self, d: str, base: str) -> bool:
        """True iff the dir's event stream is fully ingested — the gate
        for the ``cli tail --since`` warehouse path."""
        from .stream import EVENTS_FILE, segment_files

        rel = os.path.relpath(os.path.abspath(d), os.path.abspath(base))
        live = os.path.join(d, EVENTS_FILE)
        segs = [p for p in segment_files(live) if p != live]
        sig = json.dumps([[os.path.basename(p), self._size(p)]
                          for p in segs])
        size = self._size(live)
        if size is None and not segs:
            return False
        with self._lock:
            row = self.db.execute(
                "SELECT cursor, sig, head FROM event_cursors "
                "WHERE dir = ?", (rel,)).fetchone()
        return bool(row) and row[1] == sig and row[0] == (size or 0) \
            and row[2] == self._head(live)

    def events_since(self, d: str, base: str,
                     since: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
        rel = os.path.relpath(os.path.abspath(d), os.path.abspath(base))
        q = "SELECT doc FROM events WHERE dir = ?"
        args: List[Any] = [rel]
        if since is not None:
            q += " AND t >= ?"
            args.append(float(since))
        q += " ORDER BY id"
        with self._lock:
            rows = self.db.execute(q, args).fetchall()
        return [json.loads(r[0]) for r in rows]

    # -- ingest: verifier sessions -------------------------------------------

    def ingest_verifier_sessions(self, base: str) -> int:
        """Ingest the verifier's ``session.json`` snapshots
        (``<store>/verifier/<name>/``): one upserted row per
        session so fleet queries cover the always-on checker's live
        and sealed work.  Returns sessions seen."""
        from jepsen_tpu_torch.verifier import scan_sessions

        rows = []
        traces: List[Tuple[str, List[Tuple]]] = []
        for name, meta in scan_sessions(base):
            v = meta.get("verdict") or {}
            seal = meta.get("seal") or {}
            rows.append((
                name, meta.get("state"),
                json.dumps(v["valid?"]) if "valid?" in v else None,
                json.dumps(v.get("anomaly-types") or []),
                meta.get("txns"), meta.get("ops"), meta.get("segments"),
                meta.get("digest"),
                (1 if seal.get("equal") else 0) if seal else None,
                meta.get("updated")))
            # timeline stitching: a session whose config
            # carries its run's trace id contributes one live-session
            # segment (opened → last update, i.e. the window the live
            # sweeps overlapped the workload)
            cfg = meta.get("config") if isinstance(meta.get("config"),
                                                   dict) else {}
            tid = cfg.get("trace-id")
            opened, upd = meta.get("opened"), meta.get("updated")
            origin = "verifier/" + name
            seg: List[Tuple] = []
            if tid and isinstance(opened, (int, float)) \
                    and isinstance(upd, (int, float)) and upd >= opened:
                seg.append((str(tid), origin, "verifier", None,
                            cfg.get("host"),
                            "verifier:live-session", round(opened, 6),
                            round(upd, 6), round(upd - opened, 6)))
            traces.append((origin, seg))
        if not rows:
            return 0
        with self._lock, self._txn():
            self.db.executemany(
                "INSERT OR REPLACE INTO verifier_sessions(name, state, "
                "valid, anomalies, txns, ops, segments, digest, "
                "seal_equal, updated) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)", rows)
            for origin, seg in traces:
                self.db.execute(
                    "DELETE FROM trace_spans WHERE origin = ?",
                    (origin,))
                if seg:
                    self.db.executemany(
                        "INSERT INTO trace_spans(trace_id, origin, "
                        "source, run, host, name, t0, t1, dur_s) "
                        "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)", seg)
        return len(rows)

    def verifier_sessions(self) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self.db.execute(
                "SELECT name, state, valid, anomalies, txns, ops, "
                "segments, digest, seal_equal, updated "
                "FROM verifier_sessions ORDER BY name").fetchall()
        cols = ("name", "state", "valid", "anomalies", "txns", "ops",
                "segments", "digest", "seal_equal", "updated")
        out = []
        for r in rows:
            d = dict(zip(cols, r))
            d["valid"] = _loads(d["valid"]) if d["valid"] else None
            d["anomalies"] = json.loads(d["anomalies"] or "[]")
            out.append(d)
        return out

    # -- ingest: fleet ledgers -------------------------------------

    def ingest_fleet_ledger(self, path: str, base: str) -> int:
        """Incrementally ingest one fleet work-queue ledger
        (``<store>/fleet/<name>.jsonl``, docs/FLEET.md) into
        ``fleet_events`` + the per-worker rollup; returns new events.
        Shares :meth:`_ingest_jsonl`'s cursor/torn/shrink discipline
        (the ``ledgers`` table keys on the store-relative path, which
        is disjoint from campaign ledgers' ``campaigns/...``)."""
        def insert(rel: str, ev: Dict[str, Any]) -> None:
            extra = None
            if ev.get("ev") == "complete" and \
                    isinstance(ev.get("record"), dict):
                sp = ev["record"].get("spans")
                keep = {k: v for k, v in sp.items()
                        if str(k).startswith("fleet:")
                        and isinstance(v, (int, float))} \
                    if isinstance(sp, dict) else {}
                if keep:
                    extra = json.dumps(keep)
            self.db.execute(
                "INSERT INTO fleet_events(ledger, ev, run, worker, "
                "reason, ts, deadline, spans) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                (rel, ev.get("ev"), ev.get("run"), ev.get("worker"),
                 ev.get("reason"), ev.get("ts"), ev.get("deadline"),
                 extra))

        def flush(rel: str) -> None:
            self._refresh_fleet_rollup(rel)
            self._refresh_fleet_traces(rel)

        return self._ingest_jsonl(path, base,
                                  wipe=self._wipe_fleet_ledger,
                                  insert=insert,
                                  flush=flush)

    def _refresh_fleet_traces(self, rel: str) -> None:
        """Rebuild the ledger's control-plane trace segments: per
        run, ``fleet:enqueue-wait`` (enqueue → first claim,
        the coordinator's segment), one ``fleet:attempt`` per claim
        that lapsed/released (claim → requeue, attributed to the
        claiming worker), and ``fleet:execute`` (final claim →
        complete, attributed to the completing worker).  Recomputed
        wholesale per ingest batch — the pairing needs the whole event
        sequence, and the rows are few (a handful per cell)."""
        from .spans import trace_id_for

        self.db.execute(
            "DELETE FROM trace_spans WHERE origin = ?", (rel,))
        rows = self.db.execute(
            "SELECT ev, run, worker, ts, spans FROM fleet_events "
            "WHERE ledger = ? AND run IS NOT NULL ORDER BY id",
            (rel,)).fetchall()
        out: List[Tuple] = []
        state: Dict[str, Dict[str, Any]] = {}
        for ev, run, worker, ts, extra in rows:
            if not isinstance(ts, (int, float)):
                continue
            st = state.setdefault(run, {"enqueued": None, "claim": None,
                                        "first_claim": None})
            tid = trace_id_for(run)
            if ev == "enqueue" and st["enqueued"] is None:
                st["enqueued"] = ts
            elif ev == "claim":
                st["claim"] = (ts, worker)
                if st["first_claim"] is None:
                    st["first_claim"] = ts
                    if isinstance(st["enqueued"], (int, float)) \
                            and ts >= st["enqueued"]:
                        out.append((tid, rel, "fleet", run, None,
                                    "fleet:enqueue-wait",
                                    st["enqueued"], ts,
                                    round(ts - st["enqueued"], 6)))
            elif ev == "requeue" and st["claim"] is not None:
                c_ts, c_w = st["claim"]
                st["claim"] = None
                if ts >= c_ts:
                    out.append((tid, rel, "fleet", run, c_w,
                                "fleet:attempt", c_ts, ts,
                                round(ts - c_ts, 6)))
            elif ev == "complete" and st["claim"] is not None:
                c_ts, _c_w = st["claim"]
                st["claim"] = None
                if ts >= c_ts:
                    out.append((tid, rel, "fleet", run, worker,
                                "fleet:execute", c_ts, ts,
                                round(ts - c_ts, 6)))
                    # the worker-measured segments ride the complete
                    # event's record: claim-to-start anchors forward
                    # from the claim, upload backward from the
                    # completion — absolute placement from the
                    # coordinator's ledger clock, durations from the
                    # worker's monotonic clock
                    try:
                        durs = json.loads(extra) if extra else {}
                    except ValueError:
                        durs = {}
                    d = durs.get("fleet:claim-to-start")
                    if isinstance(d, (int, float)) and 0 <= d \
                            and c_ts + d <= ts:
                        out.append((tid, rel, "fleet", run, worker,
                                    "fleet:claim-to-start", c_ts,
                                    round(c_ts + d, 6), round(d, 6)))
                    d = durs.get("fleet:upload")
                    if isinstance(d, (int, float)) and 0 <= d \
                            and ts - d >= c_ts:
                        out.append((tid, rel, "fleet", run, worker,
                                    "fleet:upload", round(ts - d, 6),
                                    ts, round(d, 6)))
        if out:
            self.db.executemany(
                "INSERT INTO trace_spans(trace_id, origin, source, "
                "run, host, name, t0, t1, dur_s) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)", out)

    def _refresh_fleet_rollup(self, rel: str) -> None:
        self.db.execute(
            "DELETE FROM fleet_worker_rollup WHERE ledger = ?", (rel,))
        self.db.execute(
            "INSERT INTO fleet_worker_rollup(ledger, worker, claims, "
            "renews, completes, requeues, duplicates) "
            "SELECT ledger, worker, "
            "SUM(ev = 'claim'), SUM(ev = 'renew'), "
            "SUM(ev = 'complete'), SUM(ev = 'requeue'), "
            "SUM(ev = 'duplicate') "
            "FROM fleet_events WHERE ledger = ? AND worker IS NOT NULL "
            "GROUP BY worker", (rel,))

    def _wipe_fleet_ledger(self, rel: str) -> None:
        self.db.execute("DELETE FROM fleet_events WHERE ledger = ?",
                        (rel,))
        self.db.execute(
            "DELETE FROM fleet_worker_rollup WHERE ledger = ?", (rel,))
        self.db.execute("DELETE FROM trace_spans WHERE origin = ?",
                        (rel,))
        self.db.execute("DELETE FROM ledgers WHERE path = ?", (rel,))

    def fleet_worker_rollup(self, ledger_rel: str
                            ) -> List[Dict[str, Any]]:
        """Per-worker control-plane tallies for one fleet ledger,
        requeue-heaviest first — "which host's cells requeue most"."""
        with self._lock:
            rows = self.db.execute(
                "SELECT worker, claims, renews, completes, requeues, "
                "duplicates FROM fleet_worker_rollup WHERE ledger = ? "
                "ORDER BY requeues DESC, worker", (ledger_rel,)).fetchall()
        cols = ("worker", "claims", "renews", "completes", "requeues",
                "duplicates")
        return [dict(zip(cols, r)) for r in rows]

    # -- ingest: bench -------------------------------------------------------

    def ingest_bench(self, payload: Dict[str, Any], source: str) -> None:
        """Upsert one BENCH payload keyed by ``source`` (a file name
        for committed BENCH_r0*.json, a timestamped tag for bench.py
        self-ingest) — the r03→r05 throughput trajectory becomes a
        queryable series instead of loose files."""
        with self._lock, self.db:
            self.db.execute(
                "INSERT OR REPLACE INTO bench(source, ingested_at, "
                "metric, value, unit, vs_baseline, n_txns, backend, "
                "wall_s, compile_or_warmup_s, doc) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (source, time.time(), payload.get("metric"),
                 payload.get("value"), payload.get("unit"),
                 payload.get("vs_baseline"), payload.get("n_txns"),
                 payload.get("backend"), payload.get("wall_s"),
                 payload.get("compile_or_warmup_s"),
                 json.dumps(payload)))

    def ingest_bench_file(self, path: str) -> bool:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("bench ingest skipped %s: %s", path, e)
            return False
        if not isinstance(payload, dict):
            return False
        # the committed BENCH_r0*.json wrap the bench's JSON line in
        # {n, cmd, rc, tail, parsed} — unwrap
        if "metric" not in payload and \
                isinstance(payload.get("parsed"), dict):
            payload = payload["parsed"]
        if "metric" not in payload:
            logger.warning("bench ingest skipped %s: no metric", path)
            return False
        self.ingest_bench(payload, os.path.basename(path))
        return True

    def bench_series(self) -> List[Dict[str, Any]]:
        """The bench trajectory, ordered by source name (BENCH_r03 <
        BENCH_r04 < ...)."""
        with self._lock:
            rows = self.db.execute(
                "SELECT source, metric, value, unit, vs_baseline, "
                "n_txns, backend, wall_s, compile_or_warmup_s "
                "FROM bench ORDER BY source").fetchall()
        cols = ("source", "metric", "value", "unit", "vs_baseline",
                "n_txns", "backend", "wall_s", "compile_or_warmup_s")
        return [dict(zip(cols, r)) for r in rows]

    # -- ingest: whole store -------------------------------------------------

    def ingest_store(self, base: str, events: bool = True,
                     batch_units: int = 64) -> Dict[str, int]:
        """Incrementally ingest everything under a store dir: campaign
        ledgers, run dirs, and (optionally) event streams.  Re-running
        on an unchanged store is a no-op.

        Units commit in batches of ``batch_units`` (one
        transaction — one fsync, one cursor flush — per N ledgers/run
        dirs instead of per unit), which is where the 100k-run ingest
        speedup comes from; ``batch_units=1`` restores the old
        per-unit commit behavior exactly."""
        from jepsen_tpu_torch import store as store_mod

        stats = {"ledgers": 0, "records": 0, "runs": 0, "events": 0,
                 "sessions": 0, "fleet-events": 0, "archived": 0}
        units: List[Any] = []

        def ledger_unit(p: str) -> None:
            stats["ledgers"] += 1
            stats["records"] += self.ingest_ledger(p, base)

        def fleet_unit(p: str) -> None:
            stats["fleet-events"] += self.ingest_fleet_ledger(p, base)

        def run_unit(d: str) -> None:
            if self.ingest_run_dir(d, base):
                stats["runs"] += 1
            if events:
                stats["events"] += self.ingest_events(d, base)

        def archived_unit(d: str) -> None:
            if self.ingest_run_dir(d, base, archived=True):
                stats["archived"] += 1

        cdir = os.path.join(base, "campaigns")
        if os.path.isdir(cdir):
            for fn in sorted(os.listdir(cdir)):
                if fn.endswith(".jsonl"):
                    units.append((ledger_unit, os.path.join(cdir, fn)))
        fdir = os.path.join(base, "fleet")
        if os.path.isdir(fdir):
            for fn in sorted(os.listdir(fdir)):
                if fn.endswith(".jsonl"):
                    units.append((fleet_unit, os.path.join(fdir, fn)))
        for d in store_mod.tests(base=base):
            units.append((run_unit, d))
        # runs retired by `obs gc`: _archive/ has
        # the same <name>/<ts> layout, so the run-dir scan applies
        # as-is; rows land with archived = 1 (no event streams — those
        # were ingested while the run was live)
        adir = store_mod.archive_dir(base)
        if os.path.isdir(adir):
            for d in store_mod.tests(base=adir):
                units.append((archived_unit, d))
        step = max(1, int(batch_units))
        for i in range(0, len(units), step):
            group = units[i:i + step]
            if len(group) == 1:
                group[0][0](group[0][1])
            else:
                with self.batch():
                    for fn, arg in group:
                        fn(arg)
        stats["sessions"] = self.ingest_verifier_sessions(base)
        return stats

    def rebuild(self, base: str) -> Dict[str, int]:
        """Reconstruct from scratch: wipe every derived row, then
        re-ingest the whole store.  The jsonl ledgers are the source of
        truth; this is always safe.  The ``bench`` table survives — its
        payloads come from OUTSIDE the store (BENCH_*.json files,
        bench.py self-ingest) and can't be rederived from it."""
        with self._lock, self.db:
            for tbl in _DATA_TABLES:
                if tbl != "bench":
                    self.db.execute(f"DELETE FROM {tbl}")
        return self.ingest_store(base)

    def counts(self) -> Dict[str, int]:
        out = {}
        with self._lock:
            for tbl in _DATA_TABLES:
                out[tbl] = self.db.execute(
                    f"SELECT COUNT(*) FROM {tbl}").fetchone()[0]
        return out

    # -- rollup compaction ---------------------------

    def compact_ledger(self, path: str, base: str,
                       keep_gens: int = 2) -> Dict[str, int]:
        """Fold a campaign ledger's raw rows past the generation
        horizon into bounded summary rows and DROP them.

        Everything the compact-safe queries need survives exactly:
        ``flip_rollup`` and ``span_gen_rollup`` rows are never touched
        (flips / span_trend answer identically), witness-bearing
        records are kept (witness_diffs answers identically), and
        ``key_compact`` carries each key's last folded verdict so
        future flip detection pairs across the horizon.  Everything
        else (span_stats, latest_by_run, forensics, profile) loses its
        raw rows — the Index falls back to the jsonl scan for those
        once :meth:`ledger_compacted` is true.  The byte cursor is
        untouched: re-ingesting a compacted, unchanged ledger stays a
        no-op."""
        rel = os.path.relpath(os.path.abspath(path),
                              os.path.abspath(base))
        stats = {"gens-compacted": 0, "dropped-records": 0,
                 "dropped-spans": 0, "kept-witnesses": 0}
        with self._lock, self._txn():
            gens = self.db.execute(
                "SELECT COALESCE(gen, '?'), MIN(id) "
                "FROM campaign_records WHERE ledger = ? "
                "GROUP BY COALESCE(gen, '?') ORDER BY MIN(id)",
                (rel,)).fetchall()
            if len(gens) <= max(0, int(keep_gens)):
                return stats
            kept = gens[len(gens) - int(keep_gens):] \
                if keep_gens > 0 else []
            cutoff = min(fid for _, fid in kept) if kept else \
                self.db.execute(
                    "SELECT COALESCE(MAX(id), 0) + 1 "
                    "FROM campaign_records WHERE ledger = ?",
                    (rel,)).fetchone()[0]
            fold = [(g, fid) for g, fid in gens if fid < cutoff]
            for g, fid in fold:
                rows = self.db.execute(
                    "SELECT valid, COUNT(*) FROM campaign_records "
                    "WHERE ledger = ? AND COALESCE(gen, '?') = ? "
                    "AND id < ? GROUP BY valid",
                    (rel, g, cutoff)).fetchall()
                verd: Dict[str, int] = {}
                n_rec = 0
                for valid, n in rows:
                    n_rec += n
                    if valid is None:
                        k = "none"
                    else:
                        v = _loads(valid)
                        k = ("true" if v is True else
                             "false" if v is False else "unknown")
                    verd[k] = verd.get(k, 0) + n
                if not n_rec:
                    continue
                prior = self.db.execute(
                    "SELECT first_id, records, verdicts FROM gen_compact "
                    "WHERE ledger = ? AND gen = ?", (rel, g)).fetchone()
                if prior is not None:
                    old = json.loads(prior[2])
                    for k, n in old.items():
                        verd[k] = verd.get(k, 0) + n
                    fid = min(fid, prior[0])
                    n_rec += prior[1]
                self.db.execute(
                    "INSERT OR REPLACE INTO gen_compact(ledger, gen, "
                    "first_id, records, verdicts) VALUES (?, ?, ?, ?, ?)",
                    (rel, g, fid, n_rec, json.dumps(verd,
                                                    sort_keys=True)))
                stats["gens-compacted"] += 1
            # each key's last folded verdict: the flip seed across the
            # horizon (merged with any earlier compaction's entry —
            # the new fold is always later)
            krows = self.db.execute(
                "SELECT r.key, r.valid, r.id FROM campaign_records r "
                "JOIN (SELECT key, MAX(id) AS mid FROM campaign_records "
                "      WHERE ledger = ? AND id < ? AND valid IS NOT "
                "      NULL AND key IS NOT NULL AND key != '' "
                "      GROUP BY key) t ON r.id = t.mid",
                (rel, cutoff)).fetchall()
            self.db.executemany(
                "INSERT INTO key_compact(ledger, key, last_valid, "
                "last_id) VALUES (?, ?, ?, ?) ON CONFLICT(ledger, key) "
                "DO UPDATE SET last_valid = excluded.last_valid, "
                "last_id = excluded.last_id",
                [(rel, k, v, i) for k, v, i in krows])
            stats["dropped-spans"] = self.db.execute(
                "SELECT COUNT(*) FROM record_spans WHERE ledger = ? "
                "AND record_id < ?", (rel, cutoff)).fetchone()[0]
            self.db.execute(
                "DELETE FROM record_spans WHERE ledger = ? "
                "AND record_id < ?", (rel, cutoff))
            stats["kept-witnesses"] = self.db.execute(
                "SELECT COUNT(*) FROM campaign_records WHERE ledger = ? "
                "AND id < ? AND witness IS NOT NULL",
                (rel, cutoff)).fetchone()[0]
            # pin the id floor BEFORE dropping rows: sqlite would
            # otherwise hand the next ingest rowids below the
            # record_ids flip_rollup / key_compact still reference
            # (see _alloc_record_id)
            top = self.db.execute(
                "SELECT COALESCE(MAX(id), 0) FROM campaign_records"
            ).fetchone()[0]
            row = self.db.execute(
                "SELECT value FROM meta WHERE key = 'record_id_floor'"
            ).fetchone()
            floor = max(top, int(row[0]) if row else 0)
            self.db.execute(
                "INSERT OR REPLACE INTO meta(key, value) VALUES "
                "('record_id_floor', ?)", (str(floor),))
            cur = self.db.execute(
                "DELETE FROM campaign_records WHERE ledger = ? "
                "AND id < ? AND witness IS NULL", (rel, cutoff))
            stats["dropped-records"] = cur.rowcount
        return stats

    def ledger_compacted(self, rel: str) -> bool:
        """True once :meth:`compact_ledger` folded anything for this
        ledger — the per-query Index gate (compact-safe queries keep
        the SQL fast path, the rest fall back to the jsonl scan)."""
        with self._lock:
            return self.db.execute(
                "SELECT 1 FROM gen_compact WHERE ledger = ? LIMIT 1",
                (rel,)).fetchone() is not None

    def alert_signals(self) -> Dict[str, float]:
        """The alert tick's warehouse leg: aggregates over ROLLUP
        tables only (flip_rollup / span_gen_rollup / gen_compact) —
        NEVER campaign_records or record_spans, so the tick costs the
        same on a 100k-run store as on a 100-run one (the O(rollup
        rows) acceptance pin, trace-asserted in tests)."""
        out: Dict[str, float] = {}
        with self._lock:
            n, reg = self.db.execute(
                "SELECT COUNT(*), COALESCE(SUM(regression), 0) "
                "FROM flip_rollup").fetchone()
            out["flips"] = float(n)
            out["flip-regressions"] = float(reg)
            out["compacted-gens"] = float(self.db.execute(
                "SELECT COUNT(*) FROM gen_compact").fetchone()[0])
            rows = self.db.execute(
                "SELECT s.name, s.p95 FROM span_gen_rollup s JOIN ("
                "  SELECT ledger, name, MAX(first_id) AS mf "
                "  FROM span_gen_rollup GROUP BY ledger, name) t "
                "ON s.ledger = t.ledger AND s.name = t.name "
                "AND s.first_id = t.mf").fetchall()
        for name, p95 in rows:
            if isinstance(p95, (int, float)):
                key = f"span-p95-s:{name}"
                out[key] = max(out.get(key, 0.0), float(p95))
        return out

    # -- SQL-backed campaign queries (Index fast paths) ----------------------
    #
    # Each returns EXACTLY what the jsonl scan returns (same ordering,
    # same percentile formula, same rounding) — tests assert equality.

    def flips(self, ledger_rel: str) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self.db.execute(
                "SELECT key, run, from_valid, to_valid, regression, "
                "ts, gen FROM flip_rollup WHERE ledger = ? "
                "ORDER BY key, record_id", (ledger_rel,)).fetchall()
        return [{"key": key, "run": run, "from": _loads(pv),
                 "to": _loads(cv), "regression": bool(reg), "when": ts,
                 "gen": gen}
                for key, run, pv, cv, reg, ts, gen in rows]

    def span_values(self, ledger_rel: str) -> Dict[str, List[float]]:
        with self._lock:
            rows = self.db.execute(
                "SELECT name, dur_s FROM record_spans WHERE ledger = ? "
                "ORDER BY record_id", (ledger_rel,)).fetchall()
        out: Dict[str, List[float]] = {}
        for name, dur in rows:
            out.setdefault(name, []).append(dur)
        return out

    def span_stats(self, ledger_rel: str) -> Dict[str, Dict[str, float]]:
        with self._lock:
            rows = self.db.execute(
                "SELECT name, count, min, p50, p95, max FROM span_rollup "
                "WHERE ledger = ?", (ledger_rel,)).fetchall()
        return {name: {"count": count, "min": mn, "p50": p50,
                       "p95": p95, "max": mx}
                for name, count, mn, p50, p95, mx in
                sorted(rows, key=lambda r: r[0])}

    def span_samples(self, ledger_rel: str, name: str
                     ) -> List[Tuple[Optional[str], float]]:
        """(gen, duration) pairs for one span name, in append order —
        the material for span_trend and the regression gate."""
        with self._lock:
            rows = self.db.execute(
                "SELECT r.gen, s.dur_s FROM record_spans s "
                "JOIN campaign_records r ON r.id = s.record_id "
                "WHERE s.ledger = ? AND s.name = ? ORDER BY s.record_id",
                (ledger_rel, name)).fetchall()
        return [(gen, dur) for gen, dur in rows]

    def span_trend(self, ledger_rel: str, name: str
                   ) -> List[Tuple[str, float]]:
        with self._lock:
            rows = self.db.execute(
                "SELECT gen, p95 FROM span_gen_rollup WHERE ledger = ? "
                "AND name = ? ORDER BY first_id",
                (ledger_rel, name)).fetchall()
        return [(gen, p95) for gen, p95 in rows]

    def forensic_records(self, ledger_rel: str
                         ) -> List[Tuple[Optional[str],
                                         Dict[str, float],
                                         Dict[str, Any],
                                         Dict[str, float]]]:
        """(gen, spans, phases, counters) per ledger record in append
        order — the ONE input shape `telemetry.forensics` attributes
        regressions from; `Index.forensic_records` returns the
        identical shape off the raw jsonl (parity asserted in tests)."""
        with self._lock:
            recs = self.db.execute(
                "SELECT id, gen, phases, counters FROM campaign_records "
                "WHERE ledger = ? ORDER BY id", (ledger_rel,)).fetchall()
            span_rows = self.db.execute(
                "SELECT record_id, name, dur_s FROM record_spans "
                "WHERE ledger = ? ORDER BY record_id",
                (ledger_rel,)).fetchall()
        spans_by_rid: Dict[int, Dict[str, float]] = {}
        for rid, name, dur in span_rows:
            spans_by_rid.setdefault(rid, {})[name] = dur
        out = []
        for rid, gen, phases, counters in recs:
            out.append((gen, spans_by_rid.get(rid, {}),
                        json.loads(phases) if phases else {},
                        json.loads(counters) if counters else {}))
        return out

    def campaign_profile(self, ledger_rel: str) -> List[Dict[str, Any]]:
        """The campaign's fleet-wide device-call profile: per (site,
        shape-class, host) call counts and phase self-times summed over
        every run dir its records landed in — the ``cli obs profile``
        treemap rows, biggest total first."""
        with self._lock:
            rows = self.db.execute(
                "SELECT p.site, p.shape, p.host, SUM(p.calls), "
                "SUM(p.compile_s), SUM(p.execute_s), "
                "SUM(p.device_dispatch_s) FROM span_profile p "
                "JOIN (SELECT DISTINCT dir FROM campaign_records "
                "      WHERE ledger = ? AND dir IS NOT NULL) r "
                "ON p.dir = r.dir "
                "GROUP BY p.site, p.shape, p.host",
                (ledger_rel,)).fetchall()
        out = [{"site": site, "shape": shape, "host": host,
                "calls": int(calls or 0),
                "compile_s": round(comp or 0.0, 6),
                "execute_s": round(exe or 0.0, 6),
                "device_dispatch_s": round(disp or 0.0, 6)}
               for site, shape, host, calls, comp, exe, disp in rows]
        out.sort(key=lambda r: -(r["compile_s"] + r["execute_s"]))
        return out

    def latest_by_run(self, ledger_rel: str) -> Dict[str, Dict[str, Any]]:
        """The LATEST verdict-bearing record per run id, reconstructed
        to the shape the web grid and verdict_counts consume."""
        with self._lock:
            rows = self.db.execute(
                "SELECT r.run, r.key, r.workload, r.fault, r.seed, "
                "r.valid, r.error, r.degraded, r.deadline, r.dir, "
                "r.ops, r.wall_s, r.gen, r.ts, r.witness, r.trace "
                "FROM campaign_records r JOIN ("
                "  SELECT run, MAX(id) AS mid FROM campaign_records"
                "  WHERE ledger = ? AND valid IS NOT NULL"
                "    AND run IS NOT NULL AND run != '' GROUP BY run) t "
                "ON r.id = t.mid", (ledger_rel,)).fetchall()
        out: Dict[str, Dict[str, Any]] = {}
        for (run, key, wl, fl, seed, valid, error, degraded, deadline,
             d, ops, wall_s, gen, ts, wit, trace) in rows:
            out[run] = {
                "run": run, "key": key, "workload": wl, "fault": fl,
                "seed": _loads(seed) if seed is not None else None,
                "valid?": _loads(valid),
                "error": error, "degraded": degraded,
                "deadline": bool(deadline), "dir": d, "ops": ops,
                "wall_s": wall_s, "gen": gen, "ts": ts,
                "witness": json.loads(wit) if wit else None,
                "trace": trace,
            }
        return out

    def verdict_counts(self, ledger_rel: str,
                       runs: Optional[Any] = None) -> Dict[str, int]:
        from jepsen_tpu_torch.campaign.index import verdict_counts_over

        latest = self.latest_by_run(ledger_rel)
        if runs is not None:
            wanted = set(runs)
            latest = {k: v for k, v in latest.items() if k in wanted}
        return verdict_counts_over(latest.values())

    def witness_records(self, ledger_rel: str
                        ) -> Dict[str, List[Dict[str, Any]]]:
        """Witness-bearing records grouped by key, in append order —
        the input shape `index.witness_pair_diffs` consumes."""
        with self._lock:
            rows = self.db.execute(
                "SELECT key, gen, witness FROM campaign_records "
                "WHERE ledger = ? AND witness IS NOT NULL "
                "AND key IS NOT NULL AND key != '' ORDER BY id",
                (ledger_rel,)).fetchall()
        out: Dict[str, List[Dict[str, Any]]] = {}
        for key, gen, wit in rows:
            w = json.loads(wit)
            if isinstance(w, dict) and w.get("ops"):
                out.setdefault(key, []).append({"gen": gen, "witness": w})
        return out

    # -- cross-host timelines --------------------------

    def trace_timeline(self, run_or_trace: str) -> Dict[str, Any]:
        """One run's stitched cross-host timeline.  Accepts a run id
        (the trace id derives from it) or a 32-hex trace id.  Returns
        ``{"trace-id", "run", "spans": [...], "orphans": [...]}`` —
        spans ordered by absolute start time, each host-attributed;
        ``orphans`` are rows recorded against this RUN under a
        DIFFERENT trace id (the acceptance's zero-orphans check: a
        relanded/replayed run must stitch to ONE trace)."""
        from .spans import trace_id_for

        key = str(run_or_trace)
        is_tid = len(key) == 32 and all(
            c in "0123456789abcdef" for c in key)
        tid = key if is_tid else trace_id_for(key)
        with self._lock:
            rows = self.db.execute(
                "SELECT trace_id, source, run, host, name, t0, t1, "
                "dur_s FROM trace_spans WHERE trace_id = ? OR run = ? "
                "ORDER BY t0, id", (tid, key)).fetchall()
        cols = ("trace_id", "source", "run", "host", "name", "t0",
                "t1", "dur_s")
        spans, orphans = [], []
        run = None if is_tid else key
        for r in rows:
            d = dict(zip(cols, r))
            if run is None and d.get("run"):
                run = d["run"]
            (spans if d["trace_id"] == tid else orphans).append(d)
        return {"trace-id": tid, "run": run, "spans": spans,
                "orphans": orphans}

    @staticmethod
    def timeline_layout(tl: Dict[str, Any]) -> Dict[str, Any]:
        """Waterfall geometry for one :meth:`trace_timeline` result —
        THE shared layout both renderers (cli ``obs timeline`` and the
        web ``/timeline`` page) consume, so bar math can't drift
        between them.  Empty-safe: a timeline with only orphan rows
        (every artifact disagreed with the derived trace id) lays out
        zero spans but still reports hosts/wall defaults, so the
        renderers can show the orphan diagnostic instead of crashing."""
        spans = tl.get("spans") or []
        t0s = [s["t0"] for s in spans
               if isinstance(s.get("t0"), (int, float))]
        t1s = [s["t1"] for s in spans
               if isinstance(s.get("t1"), (int, float))]
        t_min = min(t0s) if t0s else 0.0
        wall = max((max(t1s) - t_min) if t1s else 0.0, 1e-9)
        rows = []
        for s in spans:
            t0 = s.get("t0")
            off = (t0 - t_min) if isinstance(t0, (int, float)) else 0.0
            dur = s.get("dur_s") or 0.0
            rows.append(dict(s, off=round(off, 6),
                             frac_left=min(max(off / wall, 0.0), 1.0),
                             frac_width=min(max(dur / wall, 0.0), 1.0)))
        return {
            "t_min": t_min, "wall": wall, "spans": rows,
            "hosts": sorted({str(s.get("host")) for s in spans
                             if s.get("host")}),
        }

    def traces(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Recent stitched traces, newest first: one row per trace id
        with its run, span count, distinct hosts, and wall span."""
        with self._lock:
            rows = self.db.execute(
                "SELECT trace_id, MAX(run), COUNT(*), "
                "COUNT(DISTINCT host), MIN(t0), MAX(t1) "
                "FROM trace_spans GROUP BY trace_id "
                "ORDER BY MIN(t0) DESC LIMIT ?", (int(limit),)).fetchall()
        return [{"trace-id": tid, "run": run, "spans": n,
                 "hosts": hosts, "t0": t0, "t1": t1}
                for tid, run, n, hosts, t0, t1 in rows]

    # -- rollups (the /metrics exposition) -----------------------------------

    def rollups(self) -> Dict[str, Any]:
        """Warehouse-wide gauges for the Prometheus exposition: runs by
        verdict (in-progress runs roll up as ``running``),
        per-campaign latest verdict counts, verifier session states,
        latest bench throughput.  Archived runs are excluded — the gauges describe the LIVE store, so `obs gc`
        retiring old runs doesn't move them (the history stays
        queryable via ``obs sql ... WHERE archived = 1``)."""
        with self._lock:
            run_rows = self.db.execute(
                "SELECT valid, status, COUNT(*) FROM runs "
                "WHERE archived = 0 GROUP BY valid, status").fetchall()
            ledgers = [r[0] for r in self.db.execute(
                "SELECT DISTINCT ledger FROM campaign_records").fetchall()]
            vf_rows = self.db.execute(
                "SELECT state, COUNT(*) FROM verifier_sessions "
                "GROUP BY state").fetchall()
        runs_by_verdict: Dict[str, int] = {}
        for valid, status, n in run_rows:
            if valid is None:
                k = "running" if status == "running" else "none"
            else:
                v = json.loads(valid)
                k = ("true" if v is True else
                     "false" if v is False else "unknown")
            runs_by_verdict[k] = runs_by_verdict.get(k, 0) + n
        campaigns = {}
        for led in ledgers:
            name = os.path.basename(led)
            if name.endswith(".jsonl"):
                name = name[:-len(".jsonl")]
            campaigns[name] = self.verdict_counts(led)
        return {"runs_by_verdict": runs_by_verdict,
                "campaigns": campaigns,
                "verifier_by_state": {str(s or "?"): n
                                      for s, n in vf_rows},
                "bench": self.bench_series()}

    # -- raw SQL (cli obs sql; read-only) ------------------------------------

    def query(self, sql: str) -> Tuple[List[str], List[Tuple]]:
        """Run one read-only statement (the ``cli obs sql`` cookbook
        hook).  Writes are refused — enforced at the ENGINE level via a
        throwaway ``mode=ro`` connection, not just the keyword check:
        sqlite accepts CTE-prefixed writes (``WITH x AS (SELECT 1)
        DELETE FROM ...``) that a prefix regex would wave through."""
        if not re.match(r"\s*(SELECT|WITH|EXPLAIN|PRAGMA)\b", sql,
                        re.IGNORECASE):
            raise ValueError("obs sql is read-only (SELECT/WITH only)")
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        try:
            cur = con.execute(sql)
            cols = [c[0] for c in cur.description or []]
            return cols, cur.fetchall()
        finally:
            con.close()


class _Absent:
    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<absent>"


_ABSENT = _Absent()


# ---------------------------------------------------------------------------
# Shared handles: the web server and Index fast paths reuse one
# connection per warehouse file instead of re-opening sqlite per request.
# ---------------------------------------------------------------------------

_CACHE: Dict[str, Warehouse] = {}
_CACHE_LOCK = threading.Lock()


def _cached(path: str) -> Warehouse:
    key = os.path.abspath(path)
    with _CACHE_LOCK:
        wh = _CACHE.get(key)
        if wh is not None and not wh.file_unchanged():
            # the file was deleted or replaced under the cache (rm +
            # `obs rebuild` in another process): drop the handle bound
            # to the old inode and re-open the path
            wh.close()
            del _CACHE[key]
            wh = None
        if wh is None:
            wh = _CACHE[key] = Warehouse(path)
        return wh


def open_or_create(base: str) -> Warehouse:
    """The store's warehouse, creating the file on first use (``cli
    obs ingest`` / bench self-ingest)."""
    return _cached(warehouse_path(base))


def open_if_exists(base: str) -> Optional[Warehouse]:
    """The store's warehouse ONLY if someone already built one — the
    read surfaces (web, Index fast paths) never create it implicitly.
    A cached handle is only trusted while the file still names the
    inode it opened (a deleted warehouse returns None again; a
    replaced one — rm + rebuild in another process — is re-opened)."""
    p = warehouse_path(base)
    with _CACHE_LOCK:
        wh = _CACHE.get(os.path.abspath(p))
        if wh is not None:
            if wh.file_unchanged():
                return wh
            wh.close()
            del _CACHE[os.path.abspath(p)]
    if not os.path.exists(p):
        return None
    return _cached(p)


def for_ledger(ledger_path: str) -> Optional[Tuple[Warehouse, str]]:
    """(warehouse, ledger-rel-path) when a warehouse exists next to
    this campaign ledger AND fully covers it (cursor == size) — the
    Index fast-path gate.  None means: use the jsonl scan."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(ledger_path)))
    try:
        wh = open_if_exists(base)
        if wh is None:
            return None
        if not wh.ledger_fresh(ledger_path, base):
            return None
        rel = os.path.relpath(os.path.abspath(ledger_path), base)
        return wh, rel
    except sqlite3.Error as e:  # corrupt warehouse: fall back to jsonl
        logger.warning("warehouse unavailable for %s: %s", ledger_path, e)
        return None
