"""Port parity for the run spine: `jepsen_tpu_torch/core.py` (`run`,
`analyze`, `noop_test`), the interpreter (`generator/interpreter.py`),
`client.py`, `control/` on `SimRemote`, `db.py`, `net.py`,
`os_setup.py`, `nemesis/core.py`, the txn half of `workloads/mem.py`,
the append and wr workloads with their Checker adapters, and
`checkers/elle/viz.py`.

Tolerances: at concurrency 1 the two packages' histories are equal op
for op with `time` left aside (the only field read off the wall clock),
and every result dict is equal; the port checks on the CPU
(`device="cpu"`), the JAX package as its own tests run it.  The
commands a run sends to the simulated nodes are equal in order per node,
and the anomaly SVGs are byte-equal.
"""

import dataclasses
import os
import random

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import db as jdb  # noqa: E402
from jepsen_tpu import net as jnet  # noqa: E402
from jepsen_tpu import os_setup as jos  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.checkers.elle import viz as jviz  # noqa: E402
from jepsen_tpu.control import api as jcontrol  # noqa: E402
from jepsen_tpu.control.sim import SimRemote as JSimRemote  # noqa: E402
from jepsen_tpu.generator import core as jg  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.nemesis import core as jnem  # noqa: E402
from jepsen_tpu.workloads import append as jappend  # noqa: E402
from jepsen_tpu.workloads import mem as jmem  # noqa: E402
from jepsen_tpu.workloads import wr as jwr  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import db as tdb  # noqa: E402
from jepsen_tpu_torch import net as tnet  # noqa: E402
from jepsen_tpu_torch import os_setup as tos  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import viz as tviz  # noqa: E402
from jepsen_tpu_torch.control import api as tcontrol  # noqa: E402
from jepsen_tpu_torch.control.sim import SimRemote as TSimRemote  # noqa: E402
from jepsen_tpu_torch.generator import core as tg  # noqa: E402
from jepsen_tpu_torch.nemesis import core as tnem  # noqa: E402
from jepsen_tpu_torch.workloads import append as tappend  # noqa: E402
from jepsen_tpu_torch.workloads import mem as tmem  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from jepsen_tpu_torch.workloads import wr as twr  # noqa: E402

N_OPS = 300

#: the two packages' modules, side by side
JAX = dict(core=jcore, g=jg, append=jappend, wr=jwr, mem=jmem, store=jstore,
           kw={})
PORT = dict(core=tcore, g=tg, append=tappend, wr=twr, mem=tmem,
            store=tstore, kw={"device": "cpu"})

#: name -> (workload, seed, MemClient knobs, extra test-map keys)
RUNS = {
    "append": ("append", 1, {}, {}),
    "wr": ("wr", 2, {"txn_kind": "rw-register"}, {}),
    "append-crash-fail": ("append", 3, {"crash_p": 0.05, "fail_p": 0.05},
                          {}),
    "wr-crash-fail": ("wr", 4, {"txn_kind": "rw-register", "crash_p": 0.05,
                                "fail_p": 0.05}, {}),
    # the interpreter's client-side fault seam, resolved by plan_for from
    # the test map: crash-kind faults become info completions
    "append-interpreter-faults": ("append", 5, {}, {"faults": {
        "seed": 7, "p": 0.05, "kinds": "oom", "sites": ["interpreter"]}}),
}


def _test_map(pkg, name, base, concurrency=1, n_ops=N_OPS):
    wl_name, seed, knobs, extra = RUNS[name]
    wl = pkg[wl_name].workload(rng=random.Random(seed), **pkg["kw"])
    client = pkg["mem"].MemClient(rng=random.Random(seed), **knobs)
    g = pkg["g"]
    return {"name": f"run-{name}", "nodes": ["n1", "n2"],
            "concurrency": concurrency, "client": client,
            "generator": g.clients(g.limit(n_ops, wl["generator"])),
            "checker": wl["checker"], "store-dir": base,
            **{k: (dict(v) if isinstance(v, dict) else v)
               for k, v in extra.items()}}


def _ops(h):
    """An op history without its wall-clock times."""
    return [dict(dataclasses.asdict(op), time=None) for op in h]


def _jax_history(h):
    """The JAX package's copy of a port op history."""
    return jops.history(h.to_dicts())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (JAX test map, port test map), each package's `core.run`
    of the same seeded test at concurrency 1, stored apart."""
    out = {}
    for name in RUNS:
        base = tmp_path_factory.mktemp(name)
        out[name] = tuple(
            pkg["core"].run(_test_map(pkg, name, str(base / tag)))
            for tag, pkg in (("jax", JAX), ("port", PORT)))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_concurrency_1_equal_op_for_op(runs, name):
    want, got = runs[name]
    assert len(got["history"]) == len(want["history"]) >= 2 * N_OPS
    assert _ops(got["history"]) == _ops(want["history"])
    assert got["results"] == want["results"]
    assert got["results"]["valid?"] is True
    if "crash" in name or "faults" in name:
        assert any(op.type == "info" for op in got["history"])
    for t in (want, got):
        d = t["store-dir"]
        assert os.path.exists(os.path.join(jstore.test_dir(t),
                                           "jepsen.log")), d


@pytest.mark.parametrize("name", ["append", "wr-crash-fail"])
def test_stored_runs_cross_analyse(runs, name):
    want, got = runs[name]
    wl = RUNS[name][0]
    jdir, tdir = jstore.test_dir(want), tstore.test_dir(got)
    # a JAX run analysed by the port, and a port run by the JAX package
    by_port = tcore.analyze(
        jdir, checker=PORT[wl].workload(device="cpu")["checker"])
    by_jax = jcore.analyze(tdir, checker=JAX[wl].workload()["checker"])
    assert by_port["results"] == want["results"]
    assert by_jax["results"] == got["results"]
    assert tstore.load(jdir)["results"] == want["results"]


@pytest.mark.parametrize("wl", ["append", "wr"])
def test_concurrency_8_equal_to_jax_checker(tmp_path, wl):
    done = tcore.run(_test_map(PORT, wl, str(tmp_path), concurrency=8))
    h = done["history"]
    assert {op.process for op in h} >= set(range(8))
    want = JAX[wl].workload()["checker"].check({}, _jax_history(h))
    assert done["results"] == want and want["valid?"] is True


# -- lifecycle, after tests/test_core.py -------------------------------------


def _recording_db(db_mod, control):
    class RecordingDB(db_mod.DB, db_mod.LogFiles):
        """Records lifecycle calls and runs a setup command."""

        def __init__(self):
            self.calls = []

        def setup(self, test, node):
            self.calls.append(("setup", node))
            control.exec_("install-db", "--version", "1")

        def teardown(self, test, node):
            self.calls.append(("teardown", node))
            control.exec_("rm", "-rf", "/opt/db")

        def log_files(self, test, node):
            return ["/opt/db/db.log"]

    return RecordingDB()


SIDES = {
    "jax": dict(core=jcore, db=jdb, net=jnet, os=jos, api=japi,
                control=jcontrol, sim=JSimRemote, g=jg, nem=jnem, mem=jmem,
                store=jstore),
    "port": dict(core=tcore, db=tdb, net=tnet, os=tos, api=tapi,
                 control=tcontrol, sim=TSimRemote, g=tg, nem=tnem,
                 mem=tmem, store=tstore),
}


def _base_test(m, base, **kw):
    remote = m["sim"]()
    for n in ("n1", "n2", "n3"):
        remote.node(n).respond("*", "")
    g = m["g"]
    t = dict(name="core-test", nodes=["n1", "n2", "n3"], remote=remote,
             db=_recording_db(m["db"], m["control"]),
             client=m["mem"].MemClient(), concurrency=3,
             generator=g.clients(g.limit(
                 12, lambda t, c: {"f": "read", "value": None})),
             checker=m["api"].Stats(), **{"store-dir": base})
    t.update(kw)
    return t


def _cmds(t):
    return {n: t["remote"].node(n).cmds() for n in t["nodes"]}


def test_full_lifecycle_on_sim_remote_equal(tmp_path):
    out = {}
    for side, m in SIDES.items():
        g = m["g"]
        gen = g.phases(
            g.clients(g.limit(12, lambda t, c: {"f": "read", "value": None})),
            g.nemesis(g.limit(1, {"f": "start-partition",
                                  "value": {"n1": ["n2", "n3"]}})),
            g.nemesis(g.limit(1, {"f": "stop-partition", "value": None})))
        t = _base_test(m, str(tmp_path / side), generator=gen,
                       os=m["os"].Debian(packages=["iptables"]),
                       net=m["net"].IptablesNet(),
                       nemesis=m["nem"].partitioner())
        done = m["core"].run(t)
        out[side] = (done, _cmds(t), t["db"].calls,
                     {n: t["remote"].node(n).downloads for n in t["nodes"]})
    (want, wcmds, wcalls, wdl), (got, gcmds, gcalls, gdl) = out["jax"], \
        out["port"]
    assert gcmds == wcmds
    assert any("install-db" in c for c in gcmds["n1"])
    assert any("iptables -A INPUT -s n2 -j DROP" in c for c in gcmds["n1"])
    assert sorted(gcalls) == sorted(wcalls)
    assert {("teardown", n) for n in got["nodes"]} <= set(gcalls)
    assert [(op.process, op.f, op.value) for op in got["history"]
            if op.process == "nemesis"] == \
        [(op.process, op.f, op.value) for op in want["history"]
         if op.process == "nemesis"]
    assert [len(v) for v in gdl.values()] == [len(v) for v in wdl.values()]
    assert got["results"] == want["results"]
    assert got["results"]["count"] == 12 and "sessions" not in got
    d = tstore.test_dir(got)
    for f in ("test.jepsen", "history.json", "results.json", "jepsen.log"):
        assert os.path.exists(os.path.join(d, f)), f


def test_noop_run_and_noop_nemesis(tmp_path):
    for side, m in SIDES.items():
        done = m["core"].run({"name": "noop",
                              "store-dir": str(tmp_path / side)})
        assert done["results"] == {"valid?": True}
        assert len(done["history"]) == 0
    events = {}
    for side, m in SIDES.items():
        seen = events[side] = []

        class Tracking(m["nem"].Noop):
            def setup(self, test):
                seen.append("setup")
                return self

            def teardown(self, test):
                seen.append("teardown")

        g = m["g"]
        gen = g.any_gen(
            g.clients(g.limit(4, lambda t, c: {"f": "read", "value": None})),
            g.nemesis(g.limit(1, {"f": "start", "value": None})))
        done = m["core"].run(_base_test(m, str(tmp_path / f"n-{side}"),
                                        nemesis=Tracking(), generator=gen))
        nem = [(op.type, op.f) for op in done["history"]
               if op.process == "nemesis"]
        assert nem == [("invoke", "start"), ("info", "start")], nem
    assert events["port"] == events["jax"] == ["setup", "teardown"]


def test_crashing_checker_captured(tmp_path):
    class Exploder(tapi.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("kaboom")

    done = tcore.run(_base_test(SIDES["port"], str(tmp_path),
                                checker=Exploder()))
    assert done["results"]["valid?"] == "unknown"
    assert "kaboom" in done["results"]["error"]
    assert os.path.exists(os.path.join(tstore.test_dir(done),
                                       "history.json"))


def test_analyze_needs_a_checker_and_resaves(tmp_path):
    done = tcore.run(_base_test(SIDES["port"], str(tmp_path)))
    d = tstore.test_dir(done)
    with pytest.raises(ValueError, match="no checker"):
        tcore.analyze(d)
    again = tcore.analyze(d, checker=tapi.Stats())
    assert again["results"] == done["results"]
    assert tstore.load(d)["results"]["count"] == 12


def test_leave_db_running(tmp_path):
    t = _base_test(SIDES["port"], str(tmp_path),
                   **{"leave-db-running": True})
    tcore.run(t)
    assert not any(c[0] == "teardown" for c in t["db"].calls)


@pytest.mark.parametrize("where", ["db-setup", "generator"])
def test_teardown_runs_when_the_workload_crashes(tmp_path, where):
    got = {}
    for side, m in SIDES.items():
        t = _base_test(m, str(tmp_path / side))
        rdb = t["db"]
        if where == "db-setup":
            orig = rdb.setup

            def bad_setup(test, node, orig=orig):
                orig(test, node)
                if node == "n2":
                    raise RuntimeError("node 2 is on fire")

            rdb.setup = bad_setup
        else:
            n = {"ops": 0}

            def bad_gen(test, ctx):
                n["ops"] += 1
                if n["ops"] > 5:
                    raise RuntimeError("the generator is on fire")
                return {"f": "read", "value": None}

            t["generator"] = m["g"].clients(bad_gen)
        with pytest.raises(Exception, match="on fire"):
            m["core"].run(t)
        assert {("teardown", n) for n in t["nodes"]} <= set(rdb.calls)
        got[side] = (_cmds(t), sorted(rdb.calls))
    assert got["port"] == got["jax"]


def test_live_check_raises(tmp_path):
    # a URL target needs the web server's /ingest and /verdict routes
    # (ROADMAP A4); the port refuses it before anything runs
    for target in ("http://127.0.0.1:1", {"url": "http://127.0.0.1:1"}):
        with pytest.raises(ValueError, match="ROADMAP A4"):
            tcore.run({"name": "live", "store-dir": str(tmp_path),
                       "live-check": target})
    assert not os.path.exists(os.path.join(str(tmp_path), "live"))


def test_live_check_true_seals_equal_to_the_stored_check(tmp_path):
    t = _test_map(PORT, "append", str(tmp_path), concurrency=3)
    t.update({"live-check": True, "cpu": True})
    done = tcore.run(t)
    res = done["results"]
    live = res["live-check"]
    assert live["state"] == "ok", live
    assert live["ops"] == len(done["history"])
    assert live["valid?"] == res["valid?"] is True
    assert live["anomaly-types"] == res["anomaly-types"] == []
    assert live["seal"] == {"equal": True, "digest": live["digest"]}


def test_no_card_records_unknown_and_the_cli_fails(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _test_map(PORT, "append", str(tmp_path), n_ops=20)
    t["checker"] = tappend.workload()["checker"]      # the default device
    done = tcore.run(t)
    assert done["results"]["valid?"] == "unknown"
    assert "NoDeviceError" in done["results"]["error"]
    assert done["results"]["checker"] == "list-append"
    from jepsen_tpu_torch.__main__ import DEMOS

    # an Elle demo, an invariants demo and a queue demo
    only = ("wr", "bank", "queue")
    base = str(tmp_path / "cli")
    rc = tcli.run(tcli.test_all_cmd(DEMOS),
                  ["--store-dir", base, "test-all",
                   *(a for n in only for a in ("--only", n)), "--ops", "20"])
    assert rc == 1
    assert capsys.readouterr().out.count("valid? = unknown") == len(only)
    for n in only:
        r = tstore.load(tstore.latest(f"demo-{n}", base=base))["results"]
        assert r["valid?"] == "unknown" and "NoDeviceError" in r["error"], r
    with pytest.raises(backend.NoDeviceError):
        backend.resolve(None)


# -- MemClient, viz --------------------------------------------------------

MEM_OPS = [
    {"f": "txn", "value": [["append", 1, 1], ["r", 1, None],
                           ["append", 2, 1]]},
    {"f": "txn", "value": [["r", 2, None], ["w", 3, 7], ["r", 3, None]]},
    {"f": "write", "value": 4}, {"f": "read", "value": None},
    {"f": "cas", "value": [4, 5]}, {"f": "cas", "value": [4, 6]},
    {"f": "add", "value": 9}, {"f": "enqueue", "value": 1},
    {"f": "dequeue", "value": None}, {"f": "dequeue", "value": None},
    {"f": "transfer", "value": {"from": 0, "to": 1, "amount": 3}},
    {"f": "transfer", "value": {"from": 2, "to": 1, "amount": 30}},
]


@pytest.mark.parametrize("knobs", [
    {}, {"crash_p": 0.3}, {"fail_p": 0.3}, {"crash_p": 0.2, "fail_p": 0.2},
    {"txn_kind": "rw-register", "crash_p": 0.1},
], ids=["plain", "crash", "fail", "crash+fail", "rw-register"])
def test_mem_client_completions_equal(knobs):
    def run(m):
        store = m.bank_store(n_accounts=3, balance=10)
        c = m.MemClient(store, rng=random.Random(5), **knobs).open({}, "n1")
        out = [c.invoke({}, dict(op, process=i % 3))
               for i, op in enumerate(MEM_OPS * 4)]
        s = c.store
        return out, s.kv, s.lists, s.set_elems, s.queue, s.accounts

    assert run(tmem) == run(jmem)
    with pytest.raises(ValueError, match="unknown op f"):
        tmem.MemClient().invoke({}, {"f": "frobnicate", "value": None})


def test_mem_store_skew_and_membership_equal():
    def run(m):
        s = m.bank_store(n_accounts=4, balance=10)
        c = m.MemClient(s, rng=random.Random(1)).open({}, "n3")
        out = [c.invoke({}, {"f": "txn", "process": 0,
                             "value": [["append", "k", 1]]})]
        s.start_skew(salt=3.0)
        for i in range(6):
            c.invoke({}, {"f": "txn", "process": 0,
                          "value": [["append", "k", i + 2]]})
            out.append(c.invoke({}, {"f": "txn", "process": 0,
                                     "value": [["r", "k", None]]}))
            out.append(c.invoke({"workload-kind": "bank"},
                                {"f": "read", "process": 0, "value": None}))
        s.stop_skew()
        s.members = {"n1", "n2"}
        out.append(c.invoke({}, {"f": "read", "process": 0, "value": None}))
        return out

    assert run(tmem) == run(jmem)


def test_viz_svgs_byte_equal(tmp_path):
    done = tcore.run(dict(_test_map(PORT, "append", str(tmp_path / "run"),
                                    n_ops=80), checker=None))
    h = done["history"]
    assert tsynth.inject_wr_cycle(h)
    res_t = tappend.AppendChecker(device="cpu").check({}, h)
    res_j = jappend.AppendChecker().check({}, _jax_history(h))
    assert res_t == res_j and res_t["valid?"] is False
    assert "G1c" in res_t["anomaly-types"]
    paths = {}
    for side, viz, hist, res in (("jax", jviz, _jax_history(h), res_j),
                                 ("port", tviz, h, res_t)):
        test = {"name": "viz", "store-dir": str(tmp_path / side),
                "start-time": 0.0}
        paths[side] = viz.viz_for_test(res, test, hist)
    assert [os.path.basename(p) for p in paths["port"]] == \
        [os.path.basename(p) for p in paths["jax"]]
    assert paths["port"] and all("/elle/" in p for p in paths["port"])
    for a, b in zip(paths["jax"], paths["port"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fb.read() == fa.read(), b
    # a valid result writes nothing
    assert tviz.viz_for_test({"valid?": True}, {"store-dir": str(tmp_path)},
                             h) == []


def _drive_cluster(m, cu):
    """One script over both packages' control plane on a `SimRemote`:
    control.util, a `ProcessDB` and a `TcpdumpDB`, the iptables net's
    shaping, the grudges and the partition, hammer-time and traffic
    nemeses.  Returns what it saw and each node's commands."""
    remote = m["sim"]()
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    for n in nodes:
        remote.node(n).respond("*", "")
        remote.node(n).respond("*ls*", "a\nb\n")
    t = {"nodes": nodes, "remote": remote, "net": m["net"].IptablesNet()}
    sessions = {n: remote.connect(n) for n in nodes}
    t["sessions"] = sessions
    seen = []
    db = m["db"].TcpdumpDB(m["db"].ProcessDB(
        "/opt/db/bin/db", ["--port", 7], dir="/opt/db", env={"A": "1"}),
        ports=[7, 8])

    def on_node(test, node):
        c = m["control"]
        out = [cu.exists("/tmp/x"), cu.ls("/opt"), cu.tmp_dir()]
        with c.cd("/opt/db"), c.with_env(X="y z"), c.sudo("db"):
            out.append(c.exec_("echo", "it's", m["control"].lit("$HOME")))
        cu.install_archive("https://example.invalid/db.tar.gz", "/opt/db")
        cu.signal_process("dbd", "HUP")
        db.setup(test, node)
        m["db"].cycle_db(db, test, node)
        db.teardown(test, node)
        out.append(db.log_files(test, node))
        return out

    seen.append(m["control"].on_nodes(t, on_node))
    net = t["net"]
    net.slow(t, mean_ms=20.0)
    net.flaky(t)
    net.fast(t)
    nem = m["nem"]
    rng = random.Random(3)
    seen.append([sorted((k, sorted(v)) for k, v in g.items()) for g in (
        nem.complete_grudge([["n1", "n2"], ["n3", "n4", "n5"]]),
        nem.bridge(nodes), nem.majorities_ring(nodes, rng),
        nem.partition_halves(nodes), nem.partition_random_halves(nodes, rng),
        nem.partition_random_node(nodes, rng),
        nem.partition_majorities_ring(nodes, rng))])
    seen.append(nem.split_one(nodes, rng=rng))
    for n_ in (nem.partitioner(nem.partition_halves),
               nem.hammer_time("dbd", lambda test, ns: ns[:2]),
               nem.traffic_shaper()):
        n_ = n_.setup(t) or n_
        for f in ("start-partition", "stop-partition", "start", "stop",
                  "slow", "fast"):
            try:
                seen.append(n_.invoke(t, {"f": f, "value": None,
                                          "process": "nemesis"}))
            except ValueError as e:
                seen.append(str(e))
        n_.teardown(t)
    return seen, {n: remote.node(n).cmds() for n in nodes}


def test_control_db_net_nemesis_commands_equal():
    from jepsen_tpu.control import util as jcu
    from jepsen_tpu_torch.control import util as tcu

    want = _drive_cluster(SIDES["jax"], jcu)
    got = _drive_cluster(SIDES["port"], tcu)
    assert got == want
    assert any("iptables" in c for c in got[1]["n1"])
    assert any("start-stop-daemon" in c or "nohup" in c or "db.pid" in c
               for c in got[1]["n1"])


@pytest.mark.parametrize("side", ["jax", "port"])
def test_client_wrappers(side):
    import time as _time

    from jepsen_tpu import client as jclient
    from jepsen_tpu_torch import client as tclient

    cl = {"jax": jclient, "port": tclient}[side]

    class Slow(cl.Client):
        def invoke(self, test, op):
            if op["f"] == "sleep":
                _time.sleep(1.0)
            if op["f"] == "bad-type":
                return dict(op, type="invoke")
            if op["f"] == "bad-process":
                return dict(op, type="ok", process=99)
            if op["f"] == "boom":
                raise RuntimeError("boom")
            return dict(op, type="ok")

    c = cl.WithTimeout(cl.Validate(Slow()), 0.05).open({}, "n1")
    assert cl.closable(c)
    out = [c.invoke({}, {"f": "sleep", "process": 0}),
           c.invoke({}, {"f": "ok", "process": 0})]
    for f in ("bad-type", "bad-process"):
        with pytest.raises(ValueError):
            c.invoke({}, {"f": f, "process": 0})
    comp = cl.invoke_with_errors(c, {}, {"f": "boom", "process": 1})
    assert comp["type"] == "info" and comp["error"] == "RuntimeError: boom"
    assert "Traceback" in comp["ext"]["traceback"]
    assert out == [{"f": "sleep", "process": 0, "type": "info",
                    "error": "timeout"},
                   {"f": "ok", "process": 0, "type": "ok"}]
