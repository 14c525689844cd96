"""SQLite test suite — a real ACID database, testable with no cluster (the
port's copy of `jepsen_tpu/dbs/sqlite.py`).

Equivalent in shape to the reference's per-DB suites (SURVEY.md §2.6:
each suite = DB setup + Client over the shared workloads, e.g. the etcd
tutorial suite wiring `jepsen.tests.cycle.append` over an etcd client).
SQLite is the one real database every environment has: a single shared
file, WAL or rollback journaling, SERIALIZABLE by default, plus a
deliberately unsafe `read_uncommitted` knob — so the suite exercises
both "checker proves it valid" and "checker catches the misconfig".

Workloads: list-append (`la` table, one row per appended element) and
rw-register (`kv` table), both through real transactions:

  BEGIN IMMEDIATE; ... ; COMMIT          (write txns take the write lock
                                          up front — SQLITE_BUSY surfaces
                                          at BEGIN, a clean :fail)

Completion semantics (the part per-DB suites must get right):
  - BUSY/locked at BEGIN or mid-txn -> rollback -> :fail (not applied)
  - error during COMMIT itself       -> :info (indeterminate — the
    commit may have landed; checkers treat the op as forever-concurrent)

The workloads' checkers run on the CUDA card, or on the CPU when the
options hold ``"cpu"`` (``python -m jepsen_tpu_torch.dbs.sqlite --cpu
test-all``).
"""

from __future__ import annotations

import os
import sqlite3
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import db as db_proto
from jepsen_tpu_torch.client import Client


class SqliteDB(db_proto.DB, db_proto.LogFiles):
    """The "cluster": one SQLite database file shared by every node.

    setup creates the schema; teardown removes the file (unless the test
    sets `leave-db-running`).
    """

    def __init__(self, path: Optional[str] = None, *, wal: bool = True):
        self.path = path
        self.wal = wal

    def _db_path(self, test: dict) -> str:
        if self.path:
            return self.path
        from jepsen_tpu_torch import store

        return os.path.join(store.test_dir(test), "sqlite.db")

    def setup(self, test, node):
        # one-time schema; racing nodes are harmless (IF NOT EXISTS)
        conn = sqlite3.connect(self._db_path(test), timeout=5.0)
        try:
            if self.wal:
                conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("CREATE TABLE IF NOT EXISTS la ("
                         "k INTEGER, pos INTEGER, v INTEGER, "
                         "PRIMARY KEY (k, pos))")
            conn.execute("CREATE TABLE IF NOT EXISTS kv ("
                         "k INTEGER PRIMARY KEY, v INTEGER)")
            conn.commit()
        finally:
            conn.close()

    def teardown(self, test, node):
        if test.get("leave-db-running"):
            return
        p = self._db_path(test)
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(p + suffix)
            except FileNotFoundError:
                pass

    def log_files(self, test, node):
        return []


class SqliteClient(Client):
    """One connection per process over the shared database file.

    `isolation`: "serializable" (default; SQLite's normal behavior) or
    "read_uncommitted" (shared-cache dirty reads — the misconfig the
    checker must catch).  `txn_kind` picks how "r" mops resolve: the
    list-append table or the kv register table (same convention as
    `workloads.mem.MemClient`).
    """

    def __init__(self, db: SqliteDB, *, isolation: str = "serializable",
                 busy_timeout_ms: int = 200,
                 txn_kind: str = "list-append"):
        self.db = db
        self.isolation = isolation
        self.busy_timeout_ms = busy_timeout_ms
        self.txn_kind = txn_kind
        self.conn: Optional[sqlite3.Connection] = None
        self._path: Optional[str] = None

    def open(self, test, node):
        c = SqliteClient(self.db, isolation=self.isolation,
                         busy_timeout_ms=self.busy_timeout_ms,
                         txn_kind=self.txn_kind)
        c._path = self.db._db_path(test)
        uri = f"file:{c._path}"
        if self.isolation == "read_uncommitted":
            uri += "?cache=shared"
        c.conn = sqlite3.connect(uri, uri=True,
                                 timeout=self.busy_timeout_ms / 1000.0,
                                 isolation_level=None,  # explicit BEGIN
                                 check_same_thread=False)
        if self.isolation == "read_uncommitted":
            c.conn.execute("PRAGMA read_uncommitted=1")
        return c

    def invoke(self, test, op):
        mops: List[List[Any]] = op["value"]
        conn = self.conn
        writes = any(m[0] in ("append", "w") for m in mops)
        try:
            conn.execute("BEGIN IMMEDIATE" if writes else "BEGIN DEFERRED")
        except sqlite3.OperationalError:
            return dict(op, type="fail", error="busy")  # never started
        done: List[List[Any]] = []
        try:
            for f, k, v in mops:
                if f == "append":
                    conn.execute(
                        "INSERT INTO la (k, pos, v) VALUES (?, "
                        "1 + COALESCE((SELECT MAX(pos) FROM la WHERE k=?),"
                        " 0), ?)", (k, k, v))
                    done.append([f, k, v])
                elif f == "r" and self.txn_kind == "list-append":
                    rows = conn.execute(
                        "SELECT v FROM la WHERE k=? ORDER BY pos",
                        (k,)).fetchall()
                    done.append([f, k, [r[0] for r in rows]])
                elif f == "r":  # rw-register read
                    row = conn.execute("SELECT v FROM kv WHERE k=?",
                                       (k,)).fetchone()
                    done.append([f, k, row[0] if row else None])
                elif f == "w":
                    conn.execute(
                        "INSERT INTO kv (k, v) VALUES (?, ?) "
                        "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (k, v))
                    done.append([f, k, v])
                else:
                    raise ValueError(f"unknown mop {f!r}")
        except sqlite3.Error as e:
            # mid-txn failure (busy, integrity, …): nothing committed —
            # clean abort so the reused connection is left outside a txn
            try:
                conn.execute("ROLLBACK")
            except sqlite3.Error:
                pass
            return dict(op, type="fail", error=str(e))
        except BaseException:
            # non-SQLite error (e.g. unknown mop): the txn is still open
            # on the reused connection — roll back before propagating or
            # every later BEGIN fails with "within a transaction"
            try:
                conn.execute("ROLLBACK")
            except sqlite3.Error:
                pass
            raise
        try:
            conn.execute("COMMIT")
        except sqlite3.OperationalError as e:
            # COMMIT itself failed: SQLite leaves the txn open on BUSY —
            # roll back and report :fail only if rollback succeeds;
            # anything murkier is indeterminate
            try:
                conn.execute("ROLLBACK")
                return dict(op, type="fail", error=f"commit-busy: {e}")
            except sqlite3.OperationalError:
                return dict(op, type="info", error=f"commit: {e}")
        return dict(op, type="ok", value=done)

    def close(self, test):
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def _make_test(opts: Dict[str, Any], name: str, wl: Dict[str, Any],
               txn_kind: str) -> Dict[str, Any]:
    from jepsen_tpu_torch.generator import core as g

    database = SqliteDB()
    test = dict(opts)
    if test.get("remote") is None:
        from jepsen_tpu_torch.control.local import LoopbackRemote

        # a real remote so the full spine (OS/DB setup, teardown, log
        # download) engages — the "nodes" are local for SQLite
        test["remote"] = LoopbackRemote()
    test.update({
        "name": name,
        "nodes": opts.get("nodes") or ["local"],
        "db": database,
        "client": SqliteClient(database, txn_kind=txn_kind),
        "generator": g.clients(wl["generator"]),
        "checker": wl["checker"],
    })
    return test


def append_test(opts: Dict[str, Any]) -> Dict[str, Any]:
    """List-append over SQLite (the elle flagship on a real DB)."""
    from jepsen_tpu_torch.workloads import append

    return _make_test(opts, "sqlite-append",
                      append.workload(device=_device(opts)), "list-append")


def wr_test(opts: Dict[str, Any]) -> Dict[str, Any]:
    """rw-register over SQLite."""
    from jepsen_tpu_torch.workloads import wr

    return _make_test(opts, "sqlite-wr", wr.workload(device=_device(opts)),
                      "rw-register")


def _device(opts: Dict[str, Any]) -> Optional[str]:
    """The checkers' device: the CPU under ``--cpu``, else the card."""
    return "cpu" if opts.get("cpu") else None


def suite():
    """The suite's command line, (parser, dispatch) for `cli.run`:
    `test-all` runs `append` and `wr`."""
    from jepsen_tpu_torch import cli

    return cli.test_all_cmd({"append": append_test, "wr": wr_test},
                            prog="python -m jepsen_tpu_torch.dbs.sqlite")


if __name__ == "__main__":
    from jepsen_tpu_torch import cli

    cli.main(suite())
