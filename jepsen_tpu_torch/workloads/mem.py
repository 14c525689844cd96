"""In-process simulated cluster (the port's copy of
`jepsen_tpu/workloads/mem.py`).

The reference tests `core/run!` without SSH via noop dbs and docker
(SURVEY.md §4); this module is the equivalent pure-Python strategy: a
shared in-memory store with a `Client` implementation covering the standard
workload op shapes, plus optional fault knobs (latency, crash probability)
so interpreter/core tests can exercise :info paths deterministically.

Supported op :f shapes (matching the workloads in jepsen_tpu_torch.workloads):
  read / write / cas        — single register ops (linearizable-register)
  txn                       — list of mops [["append",k,v] | ["r",k,None] |
                              ["w",k,v]] executed atomically (elle
                              workloads)
  add / read                — set workload (add element, read all)
  enqueue / dequeue         — queue workload
  transfer / read           — bank workload (value {from,to,amount} /
                              account->balance map)
"""

from __future__ import annotations

import copy
import random
import threading
import time
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.client import Client


class MemStore:
    """The 'cluster': a lock-protected shared state.

    Fault surfaces (driven by the sim nemeses in `nemesis/sim.py`):

    - **clock skew** (`start_skew` / `stop_skew`): while skewed, reads
      observe a *torn* state — a seeded per-key/account mix of a
      snapshot taken at skew start and the live state, which is what a
      snapshot read assembled from nodes with disagreeing clocks looks
      like.  Writes always apply to the live state, so bank totals stop
      summing and register reads go stale — real, checker-visible
      anomalies.
    - **membership** (`members` set): when tracked (non-None), clients
      bound to a node outside the set fail ops cleanly."""

    def __init__(self):
        self.lock = threading.Lock()
        self.kv: Dict[Any, Any] = {}
        self.lists: Dict[Any, List[Any]] = {}
        self.set_elems: set = set()
        self.queue: List[Any] = []
        self.accounts: Dict[Any, int] = {}
        self.members: Optional[set] = None  # None = not tracked
        self._skew: Optional[dict] = None   # snapshot state while skewed

    # ---- clock-skew surface ---------------------------------------------
    def start_skew(self, salt: float = 0.0) -> None:
        """Snapshot the state and enter skewed-read mode.  `salt` seeds
        which half of each read comes from the past."""
        with self.lock:
            self._skew = {
                "kv": dict(self.kv),
                "lists": {k: list(v) for k, v in self.lists.items()},
                "accounts": dict(self.accounts),
                "rng": random.Random(salt),
            }

    def stop_skew(self) -> None:
        with self.lock:
            self._skew = None

    def _torn(self, live: Dict[Any, Any], snap: Dict[Any, Any]
              ) -> Dict[Any, Any]:
        """A read mixing snapshot and live values per key (call with
        the lock held).  Seeded per call: roughly half of the keys come
        from the past."""
        rng = self._skew["rng"]
        keys = sorted(set(live) | set(snap), key=repr)
        out = {}
        for k in keys:
            src = snap if rng.random() < 0.5 else live
            if k in src:
                out[k] = src[k]
            elif k in live:
                out[k] = live[k]
        return out


class MemClient(Client):
    """Client over a MemStore.

    `latency` sleeps that long per op (seconds); `crash_p` completes ops as
    :info with that probability *after* applying them (indeterminate but
    actually-applied — the hard case checkers must handle); `fail_p`
    completes as :fail *without* applying (clean abort)."""

    def __init__(self, store: Optional[MemStore] = None, *,
                 latency: float = 0.0, crash_p: float = 0.0,
                 fail_p: float = 0.0, rng: Optional[random.Random] = None,
                 txn_kind: str = "list-append",
                 dup_enqueue_p: float = 0.0, lose_enqueue_p: float = 0.0,
                 reorder_dequeue_p: float = 0.0):
        self.store = store or MemStore()
        self.latency = latency
        self.crash_p = crash_p
        self.fail_p = fail_p
        self.rng = rng or random.Random(0)
        self.txn_kind = txn_kind  # "list-append" | "rw-register"
        # queue adversarial shapes: duplicate-request retry
        # (applied twice, acked once -> queue-phantom), ack-without-apply
        # (-> queue-lost), tail-pop reorder (-> queue-fifo-violation)
        self.dup_enqueue_p = dup_enqueue_p
        self.lose_enqueue_p = lose_enqueue_p
        self.reorder_dequeue_p = reorder_dequeue_p

    def _inj(self, shape: str) -> None:
        from .. import telemetry

        telemetry.registry().counter(
            "queue-adversarial-injections", shape=shape).inc()

    def open(self, test, node):
        # connectionless — all "nodes" share the store — but each
        # worker's handle remembers its node so membership changes can
        # reject ops routed to a removed node
        c = copy.copy(self)
        c.node = node
        return c

    def invoke(self, test, op):
        if self.latency:
            time.sleep(self.latency)
        if self.fail_p and self.rng.random() < self.fail_p:
            return dict(op, type="fail", error="simulated-abort")
        s = self.store
        members = s.members
        if members is not None and getattr(self, "node", None) is not None \
                and self.node not in members:
            return dict(op, type="fail", error="node-removed")
        f = op["f"]
        v = op.get("value")
        with s.lock:
            if f == "read" and not isinstance(v, dict):
                out = dict(op, type="ok", value=self._read_value(test))
            elif f == "write":
                s.kv["x"] = v
                out = dict(op, type="ok")
            elif f == "cas":
                old, new = v
                if s.kv.get("x") == old:
                    s.kv["x"] = new
                    out = dict(op, type="ok")
                else:
                    out = dict(op, type="fail")
            elif f == "txn":
                out = dict(op, type="ok", value=self._apply_txn(v))
            elif f == "add":
                s.set_elems.add(v)
                out = dict(op, type="ok")
            elif f == "enqueue":
                if self.lose_enqueue_p and \
                        self.rng.random() < self.lose_enqueue_p:
                    self._inj("lose-enqueue")   # acked, never applied
                else:
                    s.queue.append(v)
                    if self.dup_enqueue_p and \
                            self.rng.random() < self.dup_enqueue_p:
                        s.queue.append(v)       # retry applied twice
                        self._inj("dup-enqueue")
                out = dict(op, type="ok")
            elif f == "dequeue":
                if s.queue:
                    i = 0
                    if len(s.queue) >= 2 and self.reorder_dequeue_p and \
                            self.rng.random() < self.reorder_dequeue_p:
                        i = -1                  # tail pop: FIFO broken
                        self._inj("reorder-dequeue")
                    out = dict(op, type="ok", value=s.queue.pop(i))
                else:
                    out = dict(op, type="fail", error="empty")
            elif f == "transfer":
                frm, to, amt = v["from"], v["to"], v["amount"]
                if s.accounts.get(frm, 0) < amt:
                    out = dict(op, type="fail", error="insufficient")
                else:
                    s.accounts[frm] -= amt
                    s.accounts[to] = s.accounts.get(to, 0) + amt
                    out = dict(op, type="ok")
            else:
                raise ValueError(f"unknown op f {f!r}")
        if out["type"] == "ok" and self.crash_p \
                and self.rng.random() < self.crash_p:
            return dict(op, type="info", error="simulated-crash")
        return out

    def _read_value(self, test):
        s = self.store
        workload = (test or {}).get("workload-kind", "register")
        if workload == "set":
            return sorted(s.set_elems)
        if workload == "bank":
            if s._skew is not None:
                # a "snapshot" read assembled under skewed clocks:
                # part past, part present — totals stop conserving
                return s._torn(s.accounts, s._skew["accounts"])
            return dict(s.accounts)
        if s._skew is not None and s._skew["rng"].random() < 0.5:
            return s._skew["kv"].get("x")
        return s.kv.get("x")

    def _apply_txn(self, mops):
        s = self.store
        skew = s._skew
        out = []
        for mop in mops:
            kind, k, v = mop[0], mop[1], mop[2] if len(mop) > 2 else None
            if kind == "append":
                s.lists.setdefault(k, []).append(v)
                out.append(["append", k, v])
            elif kind == "r":
                stale = skew is not None and skew["rng"].random() < 0.5
                if self.txn_kind == "rw-register":
                    src = skew["kv"] if stale else s.kv
                    out.append(["r", k, src.get(k)])
                else:
                    src = skew["lists"] if stale else s.lists
                    out.append(["r", k, list(src.get(k, []))])
            elif kind == "w":
                s.kv[k] = v
                out.append(["w", k, v])
            else:
                raise ValueError(f"unknown mop kind {kind!r}")
        return out


def bank_store(n_accounts: int = 8, balance: int = 10) -> MemStore:
    s = MemStore()
    s.accounts = {i: balance for i in range(n_accounts)}
    return s
