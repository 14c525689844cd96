"""Toy Raft: an in-process replicated list-append store with real
membership, leader election, and partition sensitivity (the port's copy
of `jepsen_tpu/dbs/toyraft.py`).

The second per-DB suite (reference monorepo pattern: each database gets a
suite wiring DB + Client + workloads + nemeses; SURVEY.md §2.6).  SQLite
exercised the single-node ACID path; this engine exercises the parts
sqlite cannot: the `Primary` facet, the membership nemesis's staged
view/resolution machinery, and partition nemeses whose grudges must
actually change quorum outcomes.

Protocol (deliberately small, but honest about the safety-relevant
parts of Raft):
- **Election**: on demand.  A node can lead iff it is alive, in the
  current config, and can round-trip to a majority of the config; among
  the eligible, the vote rule applies — its (last-term, last-index) must
  be >= that of every node in some reachable majority.  New leader gets
  a fresh term.
- **Replication**: the leader ships its full log to reachable members;
  a follower accepts iff the leader's term >= its own (full-log replace
  — log matching is trivial, and the vote rule keeps committed prefixes
  safe).  An entry commits when a majority of the config holds it;
  committed entries apply in order to the key -> list state machine.
- **Transactions**: every client txn (even read-only) is ONE log entry;
  reads are evaluated at apply time on the leader, so a committed txn is
  atomic and linearizable.  A txn that reaches some followers but not a
  majority completes **info** — it genuinely may commit after a heal.
- **Membership**: a config-change entry; commits under a majority of
  the UNION of old and new configs (conservative joint consensus).
  Removed nodes stop counting for quorum and stop receiving entries.
- **Faults**: `ToyRaftNet` implements the standard `Net` protocol over a
  directed blocked-links set (the partitioner nemesis drives it
  unchanged); `ToyRaftDB` implements `Process` kill/start (volatile
  state lost, log+term durable) and `Primary`.

A `stale_reads=True` mode answers read-only txns from the local node's
applied state without a quorum — a real consistency bug the elle
checker must catch under partitions (used by the test suite to prove
end-to-end bug-finding, the reference's "known-bug" suite pattern).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from jepsen_tpu_torch import db as db_proto
from jepsen_tpu_torch.client import Client
from jepsen_tpu_torch.net import Net
from jepsen_tpu_torch.nemesis.membership import MembershipState


class _Entry:
    __slots__ = ("term", "kind", "txn", "members", "eid")

    def __init__(self, term: int, kind: str, txn=None, members=None,
                 eid: int = -1):
        self.term = term
        self.kind = kind          # "txn" | "config"
        self.txn = txn            # list of mops for kind="txn"
        self.members = members    # list of nodes for kind="config"
        self.eid = eid            # unique entry id (result lookup)


class _Node:
    def __init__(self, name: str, members: Sequence[str]):
        self.name = name
        self.alive = True
        # durable
        self.term = 0
        self.log: List[_Entry] = [_Entry(0, "config",
                                         members=list(members), eid=0)]
        # volatile (rebuilt from log)
        self.commit_index = 0
        self.applied_index = -1
        self.state: Dict[Any, list] = {}
        self.members: List[str] = list(members)

    def last(self) -> Tuple[int, int]:
        return (self.log[-1].term, len(self.log) - 1)

    def rebuild(self):
        """Reapply the committed prefix after a restart."""
        self.state = {}
        self.members = list(self.log[0].members)
        self.applied_index = -1
        for i in range(self.commit_index + 1):
            self._apply(i, results=None)

    def _apply(self, i: int, results: Optional[dict]):
        e = self.log[i]
        if e.kind == "config":
            self.members = list(e.members)
        else:
            out = []
            for f, k, v in e.txn:
                if f == "append":
                    self.state.setdefault(k, []).append(v)
                    out.append([f, k, v])
                else:
                    out.append([f, k, list(self.state.get(k, []))])
            if results is not None:
                results[e.eid] = out
        self.applied_index = i


class ToyRaftCluster:
    """The cluster: nodes + directed blocked links + the raft rules."""

    def __init__(self, nodes: Sequence[str], stale_reads: bool = False):
        self.lock = threading.RLock()
        self.nodes: Dict[str, _Node] = {n: _Node(n, nodes) for n in nodes}
        self.blocked: Set[Tuple[str, str]] = set()  # (src, dst)
        self.leader: Optional[str] = None
        self.stale_reads = stale_reads
        self.next_eid = 1
        self.results: Dict[int, list] = {}  # eid -> read results at apply

    # ---- connectivity ----------------------------------------------------
    def _can_rt(self, a: str, b: str) -> bool:
        """Round trip a->b->a with both ends alive."""
        if a == b:
            return self.nodes[a].alive
        return (self.nodes[a].alive and self.nodes[b].alive and
                (a, b) not in self.blocked and (b, a) not in self.blocked)

    def _majority_reachable(self, a: str, config: Sequence[str]
                            ) -> Optional[List[str]]:
        reach = [n for n in config if self._can_rt(a, n)]
        return reach if len(reach) > len(config) // 2 else None

    # ---- election --------------------------------------------------------
    def _config_of(self, n: "_Node") -> List[str]:
        return n.members

    def ensure_leader(self) -> Optional[str]:
        """Return a usable leader, electing one if needed."""
        with self.lock:
            if self.leader is not None:
                ld = self.nodes[self.leader]
                cfg = self._config_of(ld)
                if ld.alive and self.leader in cfg and \
                        self._majority_reachable(self.leader, cfg):
                    return self.leader
                self.leader = None
            # election: deterministic order for reproducibility
            for name in sorted(self.nodes):
                cand = self.nodes[name]
                if not cand.alive:
                    continue
                cfg = self._config_of(cand)
                if name not in cfg:
                    continue
                voters = self._majority_reachable(name, cfg)
                if voters is None:
                    continue
                # vote rule: candidate log must be >= every voter's
                if any(self.nodes[v].last() > cand.last() for v in voters):
                    continue
                cand.term = max(self.nodes[v].term for v in voters) + 1
                self.leader = name
                self._replicate(name)  # assert leadership / sync logs
                return name
            return None

    # ---- replication -----------------------------------------------------
    def _replicate(self, leader: str) -> int:
        """Ship the leader's log to reachable members; recompute commit.
        Returns the count of members holding the leader's full log."""
        ld = self.nodes[leader]
        cfg = self._config_of(ld)
        # conservative joint consensus: an uncommitted config entry must
        # be acked by a majority of old AND new configs
        union_cfg = set(cfg)
        for e in ld.log[ld.commit_index + 1:]:
            if e.kind == "config":
                union_cfg |= set(e.members)
        holders = []
        for n in sorted(union_cfg):
            if n == leader:
                holders.append(n)
                continue
            if n not in self.nodes or not self._can_rt(leader, n):
                continue
            fl = self.nodes[n]
            if fl.term > ld.term:
                continue  # stale leader: cannot replicate here
            new_log = list(ld.log)
            prefix_ok = len(new_log) > fl.applied_index and all(
                new_log[i].eid == fl.log[i].eid
                for i in range(fl.applied_index + 1))
            fl.term = ld.term
            fl.log = new_log
            fl.commit_index = min(fl.commit_index, len(new_log) - 1)
            if not prefix_ok:
                fl.rebuild()  # applied prefix diverged: replay the log
            holders.append(n)
        # commit: majority of current config (and of the union when a
        # config entry is in flight) hold the full log
        need = {frozenset(cfg)}
        if union_cfg != set(cfg):
            need.add(frozenset(union_cfg))
        committed = all(
            sum(1 for n in grp if n in holders) > len(grp) // 2
            for grp in need)
        if committed:
            new_commit = len(ld.log) - 1
            if new_commit > ld.commit_index:
                for i in range(ld.commit_index + 1, new_commit + 1):
                    if ld.applied_index < i:
                        ld._apply(i, self.results)
                ld.commit_index = new_commit
                for n in holders:
                    if n != leader:
                        fl = self.nodes[n]
                        for i in range(fl.commit_index + 1, new_commit + 1):
                            if fl.applied_index < i:
                                fl._apply(i, None)
                        fl.commit_index = new_commit
        return len(holders)

    # ---- client surface --------------------------------------------------
    def submit_txn(self, txn: List[list]) -> Tuple[str, Any]:
        """Returns (status, payload): ("ok", results) | ("fail", why) |
        ("info", why)."""
        with self.lock:
            leader = self.ensure_leader()
            if leader is None:
                return "fail", "no-quorum"  # nothing entered any log
            ld = self.nodes[leader]
            eid = self.next_eid
            self.next_eid += 1
            ld.log.append(_Entry(ld.term, "txn", txn=txn, eid=eid))
            self._replicate(leader)
            if eid in self.results:
                return "ok", self.results.pop(eid)
            # entered ≥1 log but did not commit: genuinely indeterminate
            return "info", "no-commit-quorum"

    def read_local(self, node: str, txn: List[list]
                   ) -> Tuple[str, Any]:
        """The stale_reads bug: serve reads from local applied state."""
        with self.lock:
            nd = self.nodes[node]
            if not nd.alive:
                return "fail", "down"
            out = [[f, k, list(nd.state.get(k, []))] for f, k, _ in txn]
            return "ok", out

    # ---- membership surface ---------------------------------------------
    def submit_config(self, members: List[str]) -> Tuple[str, Any]:
        with self.lock:
            leader = self.ensure_leader()
            if leader is None:
                return "fail", "no-quorum"
            ld = self.nodes[leader]
            ld.log.append(_Entry(ld.term, "config", members=list(members),
                                 eid=self.next_eid))
            self.next_eid += 1
            self._replicate(leader)
            ok = ld.commit_index == len(ld.log) - 1
            return ("ok", members) if ok else ("info", "no-commit-quorum")

    def committed_members(self, node: str) -> Optional[List[str]]:
        with self.lock:
            nd = self.nodes[node]
            if not nd.alive:
                return None
            return list(nd.members)

    # ---- fault surface ---------------------------------------------------
    def kill(self, node: str):
        with self.lock:
            self.nodes[node].alive = False
            if self.leader == node:
                self.leader = None

    def start(self, node: str):
        with self.lock:
            nd = self.nodes[node]
            if not nd.alive:
                nd.alive = True
                nd.rebuild()

    def block(self, src: str, dst: str):
        with self.lock:
            self.blocked.add((src, dst))
            self.leader = None  # force re-validation of quorum

    def heal(self):
        with self.lock:
            self.blocked.clear()


class ToyRaftNet(Net):
    """Standard Net protocol over the cluster's blocked-links set, so the
    stock partitioner nemesis (grudges via drop_all) works unchanged.
    Accepts the DB (cluster resolved lazily — it exists after db.setup,
    and nemesis setup runs after DB setup in the core spine) or a
    cluster directly."""

    def __init__(self, target):
        self._target = target

    @property
    def cluster(self) -> ToyRaftCluster:
        c = getattr(self._target, "cluster", self._target)
        if c is None:
            raise RuntimeError("ToyRaftNet used before db.setup")
        return c

    def drop_(self, test, src, dst):
        self.cluster.block(src, dst)

    def drop_all(self, test, grudge: Dict[str, Sequence[str]]):
        for dst, srcs in grudge.items():
            for src in srcs:
                self.cluster.block(src, dst)

    def heal(self, test):
        self.cluster.heal()

    def slow(self, test, **kw):
        pass  # no timing model in the synchronous toy

    def flaky(self, test, **kw):
        pass

    def fast(self, test):
        pass

    def shape(self, test, behaviors):
        pass


class ToyRaftDB(db_proto.DB, db_proto.Primary, db_proto.Process):
    """DB facets over the cluster (Primary + Process kill/start)."""

    def __init__(self, stale_reads: bool = False):
        self.stale_reads = stale_reads
        self.cluster: Optional[ToyRaftCluster] = None
        self._setup_lock = threading.Lock()

    def setup(self, test, node):
        # one shared in-process cluster; created on the first node's setup
        # (on_nodes may fan setup out concurrently)
        with self._setup_lock:
            if self.cluster is None:
                self.cluster = ToyRaftCluster(test["nodes"],
                                              stale_reads=self.stale_reads)

    def teardown(self, test, node):
        pass

    def primaries(self, test):
        if self.cluster is None:
            return []
        with self.cluster.lock:
            ld = self.cluster.ensure_leader()
        return [ld] if ld else []

    def start(self, test, node):
        self.cluster.start(node)

    def kill(self, test, node):
        self.cluster.kill(node)


class ToyRaftClient(Client):
    """Client bound to one node; txns go through the raft log."""

    def __init__(self, database: ToyRaftDB):
        self.database = database
        self.node: Optional[str] = None

    def open(self, test, node):
        c = ToyRaftClient(self.database)
        c.node = node
        return c

    def invoke(self, test, op):
        cluster = self.database.cluster
        txn = op["value"]
        read_only = all(f == "r" for f, _, _ in txn)
        if self.database.stale_reads and read_only:
            status, payload = cluster.read_local(self.node, txn)
        else:
            status, payload = cluster.submit_txn(txn)
        if status == "ok":
            return dict(op, type="ok", value=payload)
        if status == "fail":
            return dict(op, type="fail", error=payload)
        return dict(op, type="info", error=payload)


class ToyRaftMembers(MembershipState):
    """Staged membership protocol over committed config views."""

    def __init__(self, database: ToyRaftDB, min_size: int = 3):
        self.database = database
        self.min_size = min_size

    # views -----------------------------------------------------------------
    def node_view(self, test, node):
        return self.database.cluster.committed_members(node)

    def merge_views(self, test, views):
        # the longest-log node wins in real systems; committed configs
        # only differ by lag, so take the most common non-None view
        best, best_n = None, -1
        counts: Dict[tuple, int] = {}
        for v in views:
            if v is None:
                continue
            key = tuple(v)
            counts[key] = counts.get(key, 0) + 1
            if counts[key] > best_n:
                best, best_n = v, counts[key]
        return best

    # ops --------------------------------------------------------------------
    def possible_ops(self, test, view):
        if not view:
            return []
        ops = []
        all_nodes = list(test["nodes"])
        absent = [n for n in all_nodes if n not in view]
        if absent:
            ops.append({"type": "invoke", "f": "join-node",
                        "value": absent[0]})
        if len(view) > self.min_size:
            ops.append({"type": "invoke", "f": "leave-node",
                        "value": sorted(view)[-1]})
        return ops

    def apply_op(self, test, op):
        from jepsen_tpu_torch.nemesis.membership import merged_view

        cluster = self.database.cluster
        view = merged_view(self, test)
        if not view:
            return {"status": "fail", "members": None}
        if op["f"] == "leave-node":
            members = [n for n in view if n != op["value"]]
        else:
            members = sorted(set(view) | {op["value"]})
        status, payload = cluster.submit_config(members)
        return {"status": status, "members": members}

    def resolve_op(self, test, op, result, view):
        if view is None:
            return False
        if op["f"] == "leave-node":
            return op["value"] not in view
        return op["value"] in view


def append_test(opts: Dict[str, Any], *, stale_reads: bool = False
                ) -> Dict[str, Any]:
    """A list-append test map over the toy raft (mirror of
    `dbs/sqlite.append_test`)."""
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.workloads import append as append_wl

    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    database = ToyRaftDB(stale_reads=stale_reads)
    wl = append_wl.workload(
        consistency_models=opts.get("consistency-models",
                                    ("strict-serializable",)))
    test = dict(opts)
    if test.get("remote") is None:
        from jepsen_tpu_torch.control.sim import SimRemote

        test["remote"] = SimRemote()
    test.update({
        "name": opts.get("name", "toyraft-append"),
        "nodes": nodes,
        "db": database,
        "net": ToyRaftNet(database),
        "client": ToyRaftClient(database),
        "generator": g.clients(wl["generator"]),
        "checker": wl["checker"],
    })
    return test
