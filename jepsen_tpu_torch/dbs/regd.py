"""regd — a real, standalone list-append store daemon for control-plane
integration testing (the port's copy of `jepsen_tpu/dbs/regd.py`, the
same code; `dbs.regd_suite` uploads this file).  Every reference per-DB
suite drives `jepsen.control` against real OS processes.

One `python -m jepsen_tpu_torch.dbs.regd` process per node:

- JSON-lines protocol over TCP (one request object per line).
- Durable write-ahead log: every applied txn is appended + fsync'd
  before the reply, and replayed on restart — so `kill -9` + restart
  keeps the history linearizable (the integration suite kills nodes
  mid-run and the checker verifies exactly this).
- Primary/backup replication: the configured primary applies txns and
  synchronously forwards them to every reachable backup; backups serve
  local reads (stale under partition — a deliberate, checkable
  consistency hole when the suite requests strong models).
- Socket-level fault injection: the admin `block`/`heal` commands make
  a node drop replication connections from named peers — the same Net
  protocol surface as iptables (`net.py`), available where the test
  runner lacks root.  Reference analogue: `jepsen.nemesis` partitions
  via iptables; the *protocol* is what the harness exercises.

The daemon is deliberately dependency-free (stdlib only): it must start
via `control/util.start_daemon` from a bare install dir.

Protocol requests (one JSON object per line):
  {"op": "txn", "txn": [["append", k, v], ["r", k, null]]}
      -> {"ok": true, "txn": [...completed mops...]}
  {"op": "block", "peers": [...]} / {"op": "heal"} -> {"ok": true}
  {"op": "ping"} -> {"ok": true, "role": "primary"|"backup",
                     "applied": N}
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import sys
import threading


class Store:
    """Durable list-append store: dict key -> list, WAL-backed."""

    def __init__(self, wal_path: str):
        self.wal_path = wal_path
        self.data = {}
        self.applied = 0
        self.lock = threading.Lock()
        good_end = self._replay()
        if good_end is not None:
            # truncate a torn tail before appending: a new record
            # concatenated onto a partial line would make the NEXT
            # replay drop it and everything after it — silently losing
            # fsync-acknowledged commits
            with open(self.wal_path, "rb+") as f:
                f.truncate(good_end)
        self.wal = open(wal_path, "ab")

    def _replay(self):
        """Replay the WAL; returns the byte offset after the last
        parseable record (None if the file doesn't exist)."""
        if not os.path.exists(self.wal_path):
            return None
        pos = 0
        with open(self.wal_path, "rb") as f:
            for line in f:
                stripped = line.strip()
                if stripped:
                    try:
                        rec = json.loads(stripped)
                    except ValueError:
                        break  # torn tail: fsync'd prefix is safe
                    self._apply(rec["txn"], results=False)
                    self.applied += 1
                pos += len(line)
        return pos

    def _apply(self, txn, results=True):
        out = []
        for f, k, v in txn:
            if f == "append":
                self.data.setdefault(k, []).append(v)
                out.append([f, k, v])
            elif f == "r":
                out.append([f, k, list(self.data.get(k, []))])
            else:
                raise ValueError(f"unknown mop {f!r}")
        return out if results else None

    def commit(self, txn):
        """Apply + durably log (fsync before returning)."""
        with self.lock:
            out = self._apply(txn)
            self.wal.write(json.dumps({"txn": txn}).encode() + b"\n")
            self.wal.flush()
            os.fsync(self.wal.fileno())
            self.applied += 1
            return out

    def read_only(self, txn):
        with self.lock:
            return self._apply(txn)


class Node:
    def __init__(self, name, port, peers, primary, wal_path,
                 stale_reads=False):
        self.name = name
        self.port = port
        self.peers = peers          # {name: port} of OTHER nodes
        self.primary = primary      # name of the configured primary
        self.store = Store(wal_path)
        self.stale_reads = stale_reads
        self.blocked = set()
        self.lock = threading.Lock()
        # serializes commit+forward so backups apply txns in the
        # primary's WAL order (without it, two handler threads can
        # forward in the opposite order and a backup diverges
        # PERMANENTLY — order corruption, not the documented staleness)
        self.write_lock = threading.Lock()

    @property
    def is_primary(self):
        return self.name == self.primary

    def forward(self, txn):
        """Primary -> backups: synchronous best-effort replication.
        Unreachable/blocked backups are skipped (they fall behind; with
        --stale-reads their local reads expose it — the checkable
        hole)."""
        with self.lock:
            blocked = set(self.blocked)
        for peer, port in self.peers.items():
            if peer in blocked:
                continue
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=2.0) as s:
                    s.sendall(json.dumps(
                        {"op": "replicate", "from": self.name,
                         "txn": txn}).encode() + b"\n")
                    s.makefile().readline()
            except OSError:
                pass

    def proxy_to_primary(self, req, writes):
        with self.lock:
            blocked = self.primary in self.blocked
        port = self.peers.get(self.primary)
        if blocked or port is None:
            return {"ok": False, "error": "primary-unreachable"}
        sent = False
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=2.0) as s:
                s.sendall(json.dumps(req).encode() + b"\n")
                sent = True
                line = s.makefile().readline()
        except OSError:
            line = None
        if line:
            try:
                return json.loads(line)
            except ValueError:
                pass
        # a write that reached the wire but got no reply may have landed
        return {"ok": False, "error":
                "indeterminate" if (sent and writes)
                else "primary-unreachable"}

    def handle(self, req):
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "role":
                    "primary" if self.is_primary else "backup",
                    "applied": self.store.applied}
        if op == "block":
            with self.lock:
                self.blocked |= set(req.get("peers", []))
            return {"ok": True}
        if op == "heal":
            with self.lock:
                self.blocked.clear()
            return {"ok": True}
        if op == "replicate":
            with self.lock:
                if req.get("from") in self.blocked:
                    return {"ok": False, "error": "blocked"}
            return {"ok": True,
                    "txn": self.store.commit(req["txn"])}
        if op == "txn":
            txn = req["txn"]
            writes = any(f == "append" for f, _, _ in txn)
            if self.is_primary:
                if writes:
                    with self.write_lock:
                        out = self.store.commit(txn)
                        self.forward(txn)
                else:
                    out = self.store.read_only(txn)
                return {"ok": True, "txn": out}
            if not writes and self.stale_reads:
                # local reads on a backup: stale under lag/partition —
                # the deliberate consistency hole the checker must catch
                return {"ok": True, "txn": self.store.read_only(txn)}
            return self.proxy_to_primary(req, writes)
        return {"ok": False, "error": f"unknown op {op!r}"}


def serve(node: Node):
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    resp = node.handle(json.loads(line))
                except Exception as e:  # noqa: BLE001 — protocol error reply
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                self.wfile.write(json.dumps(resp).encode() + b"\n")
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server(("127.0.0.1", node.port), Handler) as srv:
        print(f"regd {node.name} listening on {node.port} "
              f"(primary={node.primary})", flush=True)
        srv.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--primary", required=True)
    ap.add_argument("--peer", action="append", default=[],
                    help="name:port of another node (repeatable)")
    ap.add_argument("--wal", required=True)
    ap.add_argument("--stale-reads", action="store_true")
    a = ap.parse_args(argv)
    peers = {}
    for p in a.peer:
        name, port = p.rsplit(":", 1)
        peers[name] = int(port)
    serve(Node(a.name, a.port, peers, a.primary, a.wal,
               stale_reads=a.stale_reads))


if __name__ == "__main__":
    main()
