"""regd per-DB suite: real OS processes under the full control plane (the
port's copy of `jepsen_tpu/dbs/regd_suite.py`).

The suite that drives the control plane against real OS processes.
Every lifecycle step goes through `jepsen_tpu_torch.control` exactly the
way the reference's suites go through `jepsen.control`:

  install   — the daemon source is `c.upload`-ed into a per-node dir
  start     — `control/util.start_daemon` (setsid + nohup + pidfile)
  kill      — `control/util.grepkill` (SIGKILL by pattern: the crash)
  restart   — start_daemon again; the WAL replay proves durability
  teardown  — `control/util.stop_daemon`
  logs      — `DB.log_files` -> core.run's log download into the store

The client talks real TCP to the node's daemon.  Completion semantics
(the part per-DB suites must get right): connection refused / reply
before commit -> :fail; socket death after the request is on the wire
-> :info (indeterminate); `indeterminate` proxy replies -> :info.

Reference analogues: `jepsen/db.clj` + `control/util.clj` +
any monorepo suite (e.g. the etcd tutorial's `db/setup!` +
`start-daemon!`).

The daemon uploaded is the port's own `regd.py`, and the kill pattern
names the uploaded copy's path, so that a suite never kills another
suite's daemons on the same port.  The list-append checker runs on the
CUDA card, or on the CPU when the options hold ``"cpu"`` (``python -m
jepsen_tpu_torch.dbs.regd_suite --cpu test-all``).  The daemons listen
on ports from ``"base-port"`` (``--base-port``, default 7610).
"""

from __future__ import annotations

import json
import os
import socket
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import db as db_proto
from jepsen_tpu_torch.client import Client
from jepsen_tpu_torch.control import api as c
from jepsen_tpu_torch.control import util as cu

DAEMON_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "regd.py")


class RegDB(db_proto.DB, db_proto.Process, db_proto.Primary,
            db_proto.LogFiles):
    """Deploys one regd daemon per node through the control plane."""

    def __init__(self, base_port: int = 7610, stale_reads: bool = False):
        self.base_port = base_port
        self.stale_reads = stale_reads

    # ---- layout ---------------------------------------------------------
    def port(self, test: dict, node: str) -> int:
        return self.base_port + test["nodes"].index(node)

    def node_dir(self, test: dict, node: str) -> str:
        from jepsen_tpu_torch import store

        return os.path.join(store.test_dir(test), "regd", node)

    def _paths(self, test, node):
        d = self.node_dir(test, node)
        return {
            "dir": d,
            "bin": os.path.join(d, "regd.py"),
            "wal": os.path.join(d, "wal.jsonl"),
            "log": os.path.join(d, "regd.log"),
            "pid": os.path.join(d, "regd.pid"),
        }

    def _pattern(self, test, node) -> str:
        """grepkill pattern: unique per node AND per suite instance (the
        uploaded daemon's path lies in this run's store dir, and the
        port is this node's), so that no suite kills another's daemons,
        on another port or on this one."""
        return (f"{self._paths(test, node)['bin']} --name {node} "
                f"--port {self.port(test, node)} ")

    # ---- DB protocol ----------------------------------------------------
    def setup(self, test, node):
        p = self._paths(test, node)
        c.exec_("mkdir", "-p", p["dir"])
        # install: ship the daemon source through the control plane
        c.upload([DAEMON_SRC], p["bin"])
        self.start_and_await(test, node)

    def teardown(self, test, node):
        p = self._paths(test, node)
        cu.stop_daemon(p["pid"])
        cu.grepkill(self._pattern(test, node))

    def start(self, test, node):
        import sys

        p = self._paths(test, node)
        peers = [f"--peer={n}:{self.port(test, n)}"
                 for n in test["nodes"] if n != node]
        args = [p["bin"], "--name", node, "--port",
                str(self.port(test, node)), "--primary",
                test["nodes"][0], "--wal", p["wal"], *peers]
        if self.stale_reads:
            args.append("--stale-reads")
        cu.start_daemon(sys.executable, *args,
                        logfile=p["log"], pidfile=p["pid"])

    def start_and_await(self, test, node):
        """Start the daemon and block until it answers pings — the
        sequence both setup and restart nemeses need (readiness policy
        lives in exactly one place)."""
        self.start(test, node)
        self._await_ready(test, node)

    def kill(self, test, node):
        # the crash path: SIGKILL by pattern, no graceful anything
        cu.grepkill(self._pattern(test, node))

    def running(self, test, node) -> bool:
        return cu.daemon_running(self._paths(test, node)["pid"])

    def primaries(self, test) -> List[str]:
        return [test["nodes"][0]]

    def setup_primary(self, test, node):
        pass

    def log_files(self, test, node):
        p = self._paths(test, node)
        return [p["log"], p["wal"]]

    # ---- helpers --------------------------------------------------------
    def _await_ready(self, test, node, timeout_s: float = 60.0):
        # generous: a bare python startup takes seconds on a host whose
        # cores are busy
        import time

        deadline = time.monotonic() + timeout_s
        last = None
        while time.monotonic() < deadline:
            try:
                r = request(self.port(test, node), {"op": "ping"},
                            timeout_s=1.0)
                if r.get("ok"):
                    return
                last = r
            except OSError as e:
                last = e
            time.sleep(0.1)
        raise RuntimeError(f"regd on {node} not ready: {last}")


def request(port: int, req: dict, timeout_s: float = 5.0) -> dict:
    """One JSON-lines request/reply over a fresh TCP connection."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as s:
        s.sendall(json.dumps(req).encode() + b"\n")
        line = s.makefile().readline()
    if not line:
        raise ConnectionError("empty reply")
    return json.loads(line)


class RegClient(Client):
    """Real-TCP client bound to one node's daemon."""

    FAIL_ERRORS = ("not-primary", "primary-unreachable", "blocked")

    def __init__(self, db: RegDB):
        self.db = db
        self.node: Optional[str] = None
        self.port: Optional[int] = None

    def open(self, test, node):
        c = RegClient(self.db)
        c.node = node
        c.port = self.db.port(test, node)
        return c

    def invoke(self, test, op):
        mops: List[List[Any]] = op["value"]
        writes = any(m[0] == "append" for m in mops)
        try:
            resp = request(self.port, {"op": "txn", "txn": mops})
        except ConnectionRefusedError:
            return dict(op, type="fail", error="connection refused")
        except OSError as e:
            # the request may have reached a daemon that then died:
            # writes are indeterminate, reads never changed anything
            t = "info" if writes else "fail"
            return dict(op, type=t, error=f"socket: {e}")
        if resp.get("ok"):
            return dict(op, type="ok", value=resp["txn"])
        err = resp.get("error", "?")
        if err == "indeterminate":
            return dict(op, type="info", error=err)
        return dict(op, type="fail", error=err)

    def close(self, test):
        pass


def _make_test(opts: Dict[str, Any], name: str, stale_reads: bool
               ) -> Dict[str, Any]:
    from jepsen_tpu_torch.control.local import LoopbackRemote
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.workloads import append

    # thread the requested models into the checker: backup staleness is
    # LEGAL under plain serializable (reads serialize early); only a
    # realtime-aware model makes the stale-read hole visible
    models = tuple(opts.get("consistency-models",
                            ("strict-serializable",)))
    wl = append.workload(consistency_models=models,
                         device="cpu" if opts.get("cpu") else None)
    database = RegDB(base_port=int(opts.get("base-port", 7610)),
                     stale_reads=stale_reads)
    test = dict(opts)
    if test.get("remote") is None:
        test["remote"] = LoopbackRemote()
    test.update({
        "name": name,
        "nodes": opts.get("nodes") or ["n1", "n2", "n3"],
        "db": database,
        "client": RegClient(database),
        "generator": g.stagger(0.003, wl["generator"]),
        "checker": wl["checker"],
    })
    test.setdefault("consistency-models", ("strict-serializable",))
    return test


def append_test(opts: Dict[str, Any], stale_reads: bool = False
                ) -> Dict[str, Any]:
    """List-append over a real multi-process regd cluster."""
    return _make_test(opts, "regd-append", stale_reads)


def suite():
    """The suite's command line, (parser, dispatch) for `cli.run`:
    `test-all` runs `append`.  `--base-port P` puts the daemons on ports
    P, P+1, ... (default 7610), so that two runs on one machine need not
    share them."""
    import argparse

    from jepsen_tpu_torch import cli

    p, dispatch = cli.test_all_cmd(
        {"append": append_test},
        prog="python -m jepsen_tpu_torch.dbs.regd_suite")
    sub = next(a for a in p._actions
               if isinstance(a, argparse._SubParsersAction))
    for name in ("test", "test-all"):
        sub.choices[name].add_argument(
            "--base-port", dest="base-port", type=int, default=7610,
            help="port of the first node's daemon; node i listens on "
                 "the base port + i")
    return p, dispatch


if __name__ == "__main__":
    from jepsen_tpu_torch import cli

    cli.main(suite())
