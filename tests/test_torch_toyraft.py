"""Port parity for the toy Raft suite (`jepsen_tpu_torch/dbs/toyraft.py`):
replication, elections, partitions, kills and membership in process,
and Jepsen tests over it under the fault packages.

The spec is `tests/test_toyraft.py`, each test run here on the port
with its checker swapped for the append workload's on the CPU
(`on_cpu`; `append_test` checks on the card).  Beside them:
a seeded sequence of client, fault and membership calls gives the same
answers and committed views on both packages' clusters (the cluster is
synchronous, so that is exact); and a run under the package of
`chip_smoke.py`'s phase 17a (partitions, kills and membership changes)
and a stale-read run are stored, loaded by each package's store and
checked by the JAX `list_append` checker and by the port's on the CPU,
which must give the run's own dict.  A run's interleaving depends on
its threads, so the runs are compared through their stored histories,
not op for op.  The stale-read test map and the wiring of a package
into a test are `chip_smoke.py`'s (`raft_stale_test`, `with_package`).
"""

import dataclasses
import random

import pytest

from chip_smoke import raft_stale_test, with_package
from jepsen_tpu import store as jstore
from jepsen_tpu.dbs import toyraft as jtr
from jepsen_tpu.history import ops as jops
from jepsen_tpu.workloads import append as jappend
from jepsen_tpu_torch import core
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.dbs import toyraft as tr
from jepsen_tpu_torch.generator import core as g
from jepsen_tpu_torch.nemesis import combined
from jepsen_tpu_torch.nemesis import core as nem
from jepsen_tpu_torch.nemesis import membership as mem
from jepsen_tpu_torch.workloads import append as tappend

NODES = ["n1", "n2", "n3", "n4", "n5"]


def mk_cluster(**kw):
    return tr.ToyRaftCluster(NODES, **kw)


# ------------------------------------------------------------ cluster unit

def test_replication_and_read():
    c = mk_cluster()
    st, out = c.submit_txn([["append", "x", 1]])
    assert st == "ok"
    st, out = c.submit_txn([["append", "x", 2], ["r", "x", None]])
    assert st == "ok"
    assert out[1] == ["r", "x", [1, 2]]


def test_no_quorum_fails_clean():
    c = mk_cluster()
    # 2/2/1 split: nobody has a majority
    for a in ("n1", "n2"):
        for b in ("n3", "n4", "n5"):
            c.block(a, b)
    for a in ("n3", "n4"):
        for b in ("n5",):
            c.block(a, b)
    st, why = c.submit_txn([["append", "x", 1]])
    assert st == "fail" and why == "no-quorum"


def test_partial_replication_is_info_then_commits_after_heal():
    c = mk_cluster()
    st, _ = c.submit_txn([["append", "x", 1]])
    assert st == "ok"
    leader = c.leader
    # cut the leader off from everyone: entry lands only in its own log
    for b in NODES:
        if b != leader:
            c.block(leader, b)
    st, why = c.submit_txn([["append", "x", 2]])
    # the old leader can't commit; a new quorum elects a leader without
    # the entry, or routing finds no quorum path through the old leader
    assert st in ("info", "ok", "fail")
    c.heal()
    st2, out = c.submit_txn([["r", "x", None]])
    assert st2 == "ok"
    lst = out[0][2]
    # committed history must be a consistent prefix: 1 always present
    assert lst[0] == 1


def test_leader_kill_failover_and_restart_catchup():
    c = mk_cluster()
    c.submit_txn([["append", "x", 1]])
    dead = c.leader
    c.kill(dead)
    st, out = c.submit_txn([["append", "x", 2], ["r", "x", None]])
    assert st == "ok"
    assert out[1][2] == [1, 2]
    assert c.leader != dead
    c.start(dead)
    c.submit_txn([["append", "x", 3]])
    # the restarted node catches up through replication
    st, out = c.submit_txn([["r", "x", None]])
    assert out[0][2] == [1, 2, 3]
    assert c.nodes[dead].state.get("x") == [1, 2, 3]


def test_membership_change_and_quorum_shift():
    c = mk_cluster()
    st, _ = c.submit_config(["n1", "n2", "n3"])
    assert st == "ok"
    # with a 3-node config, n4/n5 don't count: partition them away and
    # the cluster still commits
    for a in ("n4", "n5"):
        for b in ("n1", "n2", "n3"):
            c.block(a, b)
    st, out = c.submit_txn([["append", "x", 9], ["r", "x", None]])
    assert st == "ok"
    assert out[1][2] == [9]


def _step(rng, c):
    """One seeded call on cluster `c`: (what was called, its answer)."""
    kind = rng.choice(["txn", "txn", "txn", "txn", "block", "heal", "kill",
                       "start", "config", "read"])
    a, b = rng.sample(NODES, 2)
    if kind == "txn":
        txn = [[rng.choice(["append", "r"]), rng.randrange(4),
                rng.randrange(1000)] for _ in range(rng.randint(1, 4))]
        txn = [[f, k, v if f == "append" else None] for f, k, v in txn]
        return kind, txn, c.submit_txn(txn)
    if kind == "block":
        return kind, (a, b), c.block(a, b)
    if kind == "heal":
        return kind, None, c.heal()
    if kind == "kill":
        return kind, a, c.kill(a)
    if kind == "start":
        return kind, a, c.start(a)
    if kind == "config":
        members = sorted(rng.sample(NODES, rng.randint(3, 5)))
        return kind, members, c.submit_config(members)
    return kind, a, c.read_local(a, [["r", k, None] for k in range(3)])


@pytest.mark.parametrize("stale_reads", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_sequence_equal_to_jax(seed, stale_reads):
    """400 seeded `submit_txn` / `block` / `heal` / `kill` / `start` /
    `submit_config` / `read_local` calls: the same answers, leaders,
    terms, commit indexes and `committed_members` on both packages'
    clusters after every call."""
    out = []
    for mod in (jtr, tr):
        rng = random.Random(seed)
        c = mod.ToyRaftCluster(NODES, stale_reads=stale_reads)
        seen = []
        for _ in range(400):
            seen.append(_step(rng, c))
            seen.append((c.leader,
                         [(n.term, n.commit_index, n.alive)
                          for n in c.nodes.values()],
                         [c.committed_members(n) for n in NODES]))
        seen.append({n: c.nodes[n].state for n in NODES})
        out.append(seen)
    assert out[0] == out[1]
    answers = [s[2][0] for s in out[1][:-1:2] if s[0] == "txn"]
    assert {"ok", "fail"} <= set(answers), answers


# ------------------------------------------------- membership nemesis unit

def sim_test(db):
    from jepsen_tpu_torch.control.sim import SimRemote

    return {"nodes": NODES, "remote": SimRemote(), "db": db}


def test_membership_nemesis_ok_completion_and_view_log():
    db = tr.ToyRaftDB()
    t = sim_test(db)
    db.setup(t, "n1")
    state = tr.ToyRaftMembers(db)
    n = mem.MembershipNemesis(state, converge_timeout_s=5,
                              poll_interval_s=0.01).setup(t)
    comp = n.invoke(t, {"type": "invoke", "f": "leave-node", "value": "n5"})
    assert comp["type"] == "ok"          # resolved against the view: ok
    assert comp["value"]["converged"] is True
    assert comp["value"]["view-index"] >= 1
    assert n.view == ["n1", "n2", "n3", "n4"]
    comp = n.invoke(t, {"type": "invoke", "f": "join-node", "value": "n5"})
    assert comp["type"] == "ok"
    assert n.view == NODES
    # the view log recorded each distinct view in order
    views = [e["view"] for e in n.view_log]
    assert views == [NODES, ["n1", "n2", "n3", "n4"], NODES]


def test_membership_nemesis_no_quorum_is_clean_fail():
    db = tr.ToyRaftDB()
    t = sim_test(db)
    db.setup(t, "n1")
    state = tr.ToyRaftMembers(db)
    n = mem.MembershipNemesis(state, converge_timeout_s=0.05,
                              poll_interval_s=0.01).setup(t)
    # total partition: no quorum -> the change definitely never started,
    # so the completion is fail and nothing joins the pending set
    cluster = db.cluster
    for a in NODES:
        for b in NODES:
            if a != b:
                cluster.block(a, b)
    comp = n.invoke(t, {"type": "invoke", "f": "leave-node", "value": "n5"})
    assert comp["type"] == "fail"
    assert n.pending == []
    cluster.heal()
    comp2 = n.invoke(t, {"type": "invoke", "f": "join-node",
                         "value": "n5"})
    # n5 never left, so the join resolves against the unchanged view
    assert comp2["type"] == "ok"


def test_membership_nemesis_pending_resolves_later():
    """An applied-but-unresolved change times out as info, stays
    pending, and is reported in also-resolved by a later invocation."""

    class SlowState(mem.MembershipState):
        def __init__(self):
            self.resolved = False

        def node_view(self, test, node):
            return ["n1", "n2"] if self.resolved else ["n1"]

        def possible_ops(self, test, view):
            return []

        def apply_op(self, test, op):
            return {"status": "applied"}

        def resolve_op(self, test, op, result, view):
            return view == ["n1", "n2"]

    st = SlowState()
    t = {"nodes": ["n1"]}
    n = mem.MembershipNemesis(st, converge_timeout_s=0.05,
                              poll_interval_s=0.01).setup(t)
    comp = n.invoke(t, {"type": "invoke", "f": "join-node", "value": "n2"})
    assert comp["type"] == "info"
    assert comp["value"]["pending"] is True
    assert len(n.pending) == 1
    st.resolved = True
    comp2 = n.invoke(t, {"type": "invoke", "f": "join-node", "value": "n2"})
    assert comp2["type"] == "ok"
    # the earlier, timed-out op resolved during this invocation
    assert comp2["value"]["also-resolved"], comp2
    assert n.pending == []


def test_toyraft_members_equal_to_jax():
    """`ToyRaftMembers` through `MembershipNemesis` on both packages'
    dbs: the same completions (times aside), views and view logs over
    a seeded walk of `possible_op`, with a partition and a kill between
    changes."""
    out = []
    for mod, mem_mod in ((jtr, None), (tr, mem)):
        if mem_mod is None:
            from jepsen_tpu.nemesis import membership as mem_mod
        db = mod.ToyRaftDB()
        t = {"nodes": list(NODES), "db": db}
        db.setup(t, "n1")
        state = mod.ToyRaftMembers(db)
        n = mem_mod.MembershipNemesis(state, converge_timeout_s=0.05,
                                      poll_interval_s=0.001).setup(t)
        seen = []
        for i in range(8):
            if i == 3:
                db.cluster.block("n1", "n2")
            if i == 5:
                db.kill(t, "n3")
            op = mem_mod.possible_op(state, t)
            comp = n.invoke(t, op)
            seen.append({k: v for k, v in comp.items() if k != "time"})
        out.append((seen, n.view, [e["view"] for e in n.view_log],
                    [p["op"] for p in n.pending]))
    assert out[0] == out[1]
    assert any(c["type"] == "ok" for c in out[1][0])


# ----------------------------------------------------------- e2e spine

def _opts(tmp_path):
    return {"store-dir": str(tmp_path / "store"), "concurrency": 5,
            "nodes": NODES}


def on_cpu(t):
    """Test map `t` with the append workload's checker on the CPU, under
    the consistency models `append_test` read from its options."""
    t["checker"] = tappend.workload(
        consistency_models=t.get("consistency-models",
                                 ("strict-serializable",)),
        device="cpu")["checker"]
    return t


def test_toyraft_append_valid(tmp_path):
    t = on_cpu(tr.append_test(_opts(tmp_path)))
    t["generator"] = g.limit(150, t["generator"])
    done = core.run(t)
    res = done["results"]
    assert res["valid?"] is True, res
    oks = [op for op in done["history"] if op.type == "ok" and
           op.f == "txn"]
    assert len(oks) >= 100


def test_toyraft_leave_rejoin_under_partition_exact(tmp_path):
    """A node leaves and rejoins while a partition is up; the checker
    verdict stays exact and valid."""
    t = on_cpu(tr.append_test(_opts(tmp_path)))
    db = t["db"]
    members = tr.ToyRaftMembers(db)
    t["nemesis"] = nem.compose({
        frozenset({"start-partition", "stop-partition"}): nem.partitioner(),
        frozenset({"leave-node", "join-node"}):
            mem.MembershipNemesis(members, converge_timeout_s=5,
                                  poll_interval_s=0.01),
    })
    grudge = nem.complete_grudge([["n1", "n2", "n3"], ["n4", "n5"]])
    nem_seq = [
        g.sleep(0.05),
        {"type": "invoke", "f": "start-partition", "value": grudge},
        g.sleep(0.1),
        {"type": "invoke", "f": "leave-node", "value": "n5"},
        g.sleep(0.1),
        {"type": "invoke", "f": "stop-partition"},
        g.sleep(0.05),
        {"type": "invoke", "f": "join-node", "value": "n5"},
        g.sleep(0.05),
    ]
    t["generator"] = g.any_gen(g.limit(250, t["generator"]),
                               g.nemesis(nem_seq))
    done = core.run(t)
    res = done["results"]
    assert res["valid?"] is True, res
    # the membership ops really ran and resolved
    mem_ops = [op for op in done["history"]
               if op.f in ("leave-node", "join-node")]
    assert any(op.type == "ok" for op in mem_ops), \
        [(op.f, op.type) for op in mem_ops]
    # real client commits happened on both sides of the churn
    oks = [op for op in done["history"] if op.type == "ok" and
           op.f == "txn"]
    assert len(oks) >= 100


def test_toyraft_stale_reads_caught(tmp_path):
    """stale_reads mode: reads served from a partitioned replica without
    quorum — the checker must find realtime anomalies."""
    done = core.run(on_cpu(raft_stale_test(_opts(tmp_path))))
    res = done["results"]
    # reads from the isolated replica violate realtime: must NOT be valid
    assert res["valid?"] is False, res


def faulted_test(opts, n_ops, seconds, interval):
    """The test map of `chip_smoke.py`'s phase 17a at a size of its own:
    the toy raft under `nemesis_package`'s partition, kill and
    membership packages, at most `n_ops` client txns beside the fault
    schedule for `seconds`, then the package's final heal ops."""
    t = on_cpu(tr.append_test(opts))
    db = t["db"]
    pkg = combined.nemesis_package({
        "faults": {"partition", "kill", "membership"}, "db": db,
        "membership_state": tr.ToyRaftMembers(db), "interval": interval,
        "membership_timeout_s": 0.5, "rng": random.Random(0)})
    return with_package(t, pkg, g.stagger(0.005, g.limit(n_ops,
                                                          t["generator"])),
                        seconds)


def stored_dicts(done, models):
    """The run's stored history, loaded by each package's store and
    checked by each package's append checker (the port's on the CPU)."""
    d = tstore.test_dir(done)
    h_jax = jstore.load(d)["history"].materialize()
    h_port = tstore.load(d)["history"].materialize()
    assert [dataclasses.asdict(op) for op in h_port] == \
        [dataclasses.asdict(op) for op in done["history"]]
    want = jappend.workload(consistency_models=models)["checker"].check(
        {}, jops.history([dataclasses.asdict(op) for op in h_jax]))
    got = tappend.workload(consistency_models=models, device="cpu"
                           )["checker"].check({}, h_port)
    return want, got


def test_faulted_run_stored_and_checked_as_jax(tmp_path):
    """17a's package at 240 txns: partitions, kills and membership
    changes complete, the run is valid, and its stored history gives
    the run's dict through both packages' checkers."""
    done = core.run(faulted_test(_opts(tmp_path), 240, 2.0, 0.05))
    res = done["results"]
    assert res["valid?"] is True, res
    h = done["history"]
    fs = {op.f for op in h if op.process == "nemesis" and op.type != "invoke"}
    assert {"start-partition", "kill"} <= fs, fs
    assert fs & {"leave-node", "join-node"}, fs
    want, got = stored_dicts(done, ("strict-serializable",))
    assert got == res
    assert want == res


def test_stale_run_stored_and_checked_as_jax(tmp_path):
    """The stale-read run's stored history gives the run's dict through
    both packages' checkers, but for the SVG paths the run's check wrote
    into its store (a check with no store writes none).  It is checked
    under strong snapshot isolation: under strict serializability the
    host's budgeted G-nonadjacent search takes 0.5 s or, when the
    interleaving has no such cycle, the whole budget (tens of seconds in
    the port, minutes in the JAX package)."""
    models = ("strong-snapshot-isolation",)
    done = core.run(on_cpu(raft_stale_test(
        dict(_opts(tmp_path), **{"consistency-models": models}))))
    res = dict(done["results"])
    assert res["valid?"] is False, res
    assert "G-single-realtime" in res["anomaly-types"], res
    assert all(f.startswith(tstore.test_dir(done))
               for f in res.pop("viz-files"))
    want, got = stored_dicts(done, models)
    assert got == res
    assert want == res
