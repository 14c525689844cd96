"""Port parity for the first real-process suites: the loopback remote
(`jepsen_tpu_torch/control/local.py`), the `regd` daemon and its suite
(`dbs/regd.py`, `dbs/regd_suite.py`) and the SQLite suite
(`dbs/sqlite.py`).

These runs talk to real OS processes and a real database file, so their
interleavings are not deterministic.  At concurrency 1, with the same
seeded workload, the two packages' histories are equal op for op (times
aside) and so are their results.  At higher concurrency the port's run
must hold its suite's own claims (the JAX tests' load-tolerant counts),
and the history it wrote is checked again by the JAX package's checker,
which must give the port's dict.  The port checks on the CPU.

Every run takes ports that the OS reports free, never a JAX test's
fixed 7620-7642; the `python -m` run passes them as `--base-port`.  Each
run has a time limit of its own (`within`), so that a daemon that never
listens fails its test instead of holding the suite.  The spec is
`tests/test_control.py`, `tests/test_regd_suite.py` and
`tests/test_sqlite_db.py`.
"""

import ast
import contextlib
import dataclasses
import os
import random
import signal
import sqlite3
import subprocess
import sys

import pytest

from chip_smoke import free_base, regd_stale_test
from jepsen_tpu import control as jcontrol
from jepsen_tpu import core as jcore
from jepsen_tpu import db as jdb
from jepsen_tpu.control import local as jlocal
from jepsen_tpu.control import util as jcu
from jepsen_tpu.dbs import regd as jregd
from jepsen_tpu.dbs import regd_suite as jrs
from jepsen_tpu.dbs import sqlite as jsq
from jepsen_tpu.generator import core as jg
from jepsen_tpu.history import ops as jops
from jepsen_tpu.workloads import append as jappend
from jepsen_tpu.workloads import wr as jwr
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.control import local as tlocal
from jepsen_tpu_torch.control import util as tcu
from jepsen_tpu_torch.dbs import regd as tregd
from jepsen_tpu_torch.dbs import regd_suite as trs
from jepsen_tpu_torch.dbs import sqlite as tsq
from jepsen_tpu_torch.generator import core as tg
from jepsen_tpu_torch.nemesis import core as tnem
from jepsen_tpu_torch.workloads import append as tappend
from jepsen_tpu_torch.workloads import wr as twr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = dict(control=jcontrol, local=jlocal, cu=jcu, core=jcore, g=jg,
           append=jappend, wr=jwr, sq=jsq, rs=jrs, kw={})
PORT = dict(control=tcontrol, local=tlocal, cu=tcu, core=tcore, g=tg,
            append=tappend, wr=twr, sq=tsq, rs=trs, kw={"device": "cpu"})


@contextlib.contextmanager
def within(seconds: int):
    """Fail the block with TimeoutError past `seconds` (a run's own
    limit; `core.run` tears its daemons down on the way out)."""
    def fire(signum, frame):
        raise TimeoutError(f"over its limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def ops_of(h):
    """An op history without its wall-clock times."""
    return [dict(dataclasses.asdict(op), time=None) for op in h]


def jax_history(h):
    return jops.history([dataclasses.asdict(op) for op in h])


def txn_oks(h):
    return [op for op in h if op.type == "ok" and op.f == "txn"]


# ---- control/local ---------------------------------------------------------


def loopback_scenario(pkg, base):
    control, remote, cu = pkg["control"], pkg["local"].LoopbackRemote, \
        pkg["cu"]
    out = []
    r = remote(base_dir=base)
    with control.with_session("n1", r.connect("n1")):
        out.append(control.exec_("echo", "hello world"))
        out.append(control.exec_result("bash", "-c", "exit 3").exit_status)
        try:
            control.exec_("false")
            out.append("no error")
        except control.RemoteError as e:
            out.append(type(e).__name__)
        control.exec_("mkdir", "-p", "sub")
        with control.cd("sub"):
            control.exec_("touch", "inner.txt")
        out.append(control.exec_("ls", "sub"))
        with control.with_env(MYVAR="42"):
            out.append(control.exec_("bash", "-c", "echo $MYVAR"))
        control.write_file("conf/app.cfg", "key=value\n")
        out.append(control.file_contents("conf/app.cfg"))
        out += [cu.exists("nope"), cu.exists("conf/app.cfg"),
                "app.cfg" in cu.ls("conf")]
        src = os.path.join(base, "src.txt")
        with open(src, "w") as f:
            f.write("payload")
        control.upload(src, "data/up.txt")
        out.append(control.exec_("cat", "data/up.txt"))
        control.download("data/up.txt", os.path.join(base, "dl"))
        with open(os.path.join(base, "dl", "up.txt")) as f:
            out.append(f.read())
        cu.start_daemon("sleep", "30", logfile="d.log", pidfile="d.pid")
        out.append(cu.daemon_running("d.pid"))
        cu.stop_daemon("d.pid", wait_s=1.0)
        out += [cu.daemon_running("d.pid"), cu.exists("d.pid")]
    for node in ("n2", "n3"):
        with control.with_session(node, r.connect(node)):
            control.exec_("bash", "-c", f"echo {node} > who.txt")
    for node in ("n2", "n3"):
        with control.with_session(node, r.connect(node)):
            out.append(control.exec_("cat", "who.txt"))
    test = {"nodes": ["n1", "n2", "n3"], "remote": r}
    out.append(control.on_nodes(
        test, lambda t, n: control.exec_("bash", "-c", "echo $JEPSEN_NODE")))
    out.append(control.on_nodes(test, lambda t, n: control.host(),
                                nodes=["n2"]))
    return out


def test_loopback_remote_equal_to_jax(tmp_path):
    want = loopback_scenario(JAX, str(tmp_path / "jax"))
    got = loopback_scenario(PORT, str(tmp_path / "port"))
    assert got == want
    assert want[:3] == ["hello world", 3, "RemoteError"]


def test_loopback_timeout_raises_connection_error(tmp_path):
    for pkg in (JAX, PORT):
        r = pkg["local"].LoopbackRemote(base_dir=str(tmp_path),
                                        timeout_s=0.2)
        with pkg["control"].with_session("n1", r.connect("n1")):
            with pytest.raises(pkg["control"].RemoteError,
                               match="timed out"):
                pkg["control"].exec_("sleep", "5")


# ---- regd: the daemon ------------------------------------------------------


def _code(path):
    """A module's source after its docstring."""
    with open(path) as f:
        src = f.read()
    end = ast.parse(src).body[0].end_lineno
    return src.splitlines()[end:]


def test_regd_daemon_is_the_jax_file_but_for_its_docstring():
    assert _code(tregd.__file__) == _code(jregd.__file__)
    assert trs.DAEMON_SRC == tregd.__file__
    assert os.path.dirname(trs.DAEMON_SRC).endswith(
        os.path.join("jepsen_tpu_torch", "dbs"))


def test_regd_wal_torn_tail_recovery_equal_to_jax(tmp_path):
    got = []
    for mod in (jregd, tregd):
        wal = str(tmp_path / f"{mod.__name__}.jsonl")
        s1 = mod.Store(wal)
        s1.commit([["append", "x", 1]])
        s1.commit([["append", "x", 2], ["r", "x", None]])
        with open(wal, "ab") as f:
            f.write(b'{"txn": [["append", "x", 3')
        s2 = mod.Store(wal)
        first = dict(s2.data)
        s2.commit([["append", "x", 4]])
        s2.commit([["append", "x", 5]])
        s3 = mod.Store(wal)
        with open(wal, "rb") as f:
            got.append((first, s3.data, s3.applied, f.read()))
    assert got[1] == got[0]
    assert got[0][1]["x"] == [1, 2, 4, 5]


def test_regdb_supports_expected_facets():
    for dbm, rs in ((jdb, jrs), (tdb, trs)):
        db = rs.RegDB()
        assert dbm.supports(db, dbm.Process)
        assert dbm.supports(db, dbm.Primary)
        assert dbm.supports(db, dbm.LogFiles)
        assert not dbm.supports(db, dbm.Pause)


def test_kill_pattern_spares_other_daemons_on_the_same_port(tmp_path):
    # a process whose command line the JAX suite's pattern matches (the
    # same node and port) but that is not this run's uploaded daemon
    port = free_base(1)
    test = {"name": "regd-append", "nodes": ["n1"],
            "store-dir": str(tmp_path), "start-time": 1_700_000_000.0}
    db = trs.RegDB(base_port=port)
    decoy = subprocess.Popen(
        ["bash", "-c", "sleep 30", "regd.py", "--name", "n1", "--port",
         str(port), "--primary", "n1"])
    try:
        assert jrs.RegDB(base_port=port)._pattern(test, "n1") in \
            " ".join(decoy.args[2:]) + " "
        r = tlocal.LoopbackRemote()
        with tcontrol.with_session("n1", r.connect("n1")):
            db.kill(test, "n1")
        assert decoy.poll() is None
        assert db._pattern(test, "n1").startswith(
            db._paths(test, "n1")["bin"])
    finally:
        decoy.kill()
        decoy.wait()


# ---- regd: runs against real daemons ---------------------------------------


def regd_opts(tmp_path, name, **kw):
    return {"store-dir": str(tmp_path / name), "concurrency": 4,
            "base-port": free_base(), "cpu": True, **kw}


def limited(pkg, test, n):
    test["generator"] = pkg["g"].limit(n, test["generator"])
    return test


def test_regd_append_valid_real_processes(tmp_path):
    t = limited(PORT, trs.append_test(regd_opts(tmp_path, "valid")), 120)
    with within(120):
        done = tcore.run(t)
    res = done["results"]
    assert res["valid?"] is True, res
    # the JAX test's load-tolerant claim: real TCP commits happened
    assert len(txn_oks(done["history"])) >= 3
    db = done["db"]
    for node in done["nodes"]:
        paths = db._paths(done, node)
        with open(paths["log"]) as f:
            assert "listening" in f.read()
        assert paths["bin"].startswith(tstore.test_dir(done))
        d = tstore.path(done, node)
        assert os.path.exists(os.path.join(d, "regd.log")), d
    # the JAX checker on the port's history gives the port's dict
    want = jappend.workload(consistency_models=("strict-serializable",)
                            )["checker"].check({}, jax_history(
                                done["history"]))
    assert res == want


def test_regd_concurrency_1_equal_op_for_op(tmp_path, monkeypatch):
    runs = []
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        wl = pkg["append"].workload
        monkeypatch.setattr(
            pkg["append"], "workload",
            lambda wl=wl, **kw: wl(rng=random.Random(3), **kw))
        opts = regd_opts(tmp_path, tag, concurrency=1)
        t = pkg["rs"].append_test(opts)
        # clients only: the suite's generator would hand an op to the
        # idle nemesis thread now and then, as the wall clock decides
        t["generator"] = pkg["g"].clients(pkg["g"].limit(60, t["generator"]))
        with within(120):
            runs.append(pkg["core"].run(t))
    want, got = runs
    assert ops_of(got["history"]) == ops_of(want["history"])
    assert got["results"] == want["results"]
    assert got["results"]["valid?"] is True
    assert len(txn_oks(got["history"])) >= 3


def test_regd_primary_crash_recovery(tmp_path):
    t = trs.append_test(regd_opts(tmp_path, "crash"))
    db = t["db"]
    t["nemesis"] = tnem.node_start_stopper(
        lambda test, nodes: [nodes[0]],
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start_and_await(test, node),
        start_f="kill-primary", stop_f="restart-primary")
    wl = t["generator"]
    t["generator"] = tg.then(
        tg.clients(tg.limit(60, wl)),
        tg.then(
            tg.synchronize(
                tg.nemesis([{"type": "invoke", "f": "kill-primary"}])),
            tg.then(
                tg.clients(tg.limit(60, wl)),
                tg.then(
                    tg.synchronize(tg.nemesis(
                        [{"type": "invoke", "f": "restart-primary"}])),
                    tg.synchronize(tg.clients(tg.limit(60, wl)))))))
    with within(180):
        done = tcore.run(t)
    res = done["results"]
    assert res["valid?"] is True, res
    hist = done["history"]
    oks = txn_oks(hist)
    restart = next(op.index for op in hist if op.f == "restart-primary")
    assert any(op.index < restart for op in oks), "no pre-crash oks"
    assert any(op.index > restart for op in oks), "no post-restart oks"
    assert [op for op in hist
            if op.type in ("fail", "info") and op.f == "txn"]
    assert any(op.f == "kill-primary" for op in hist)
    want = jappend.workload(consistency_models=("strict-serializable",)
                            )["checker"].check({}, jax_history(hist))
    assert res == want


def test_regd_stale_reads_caught(tmp_path):
    t = regd_stale_test(regd_opts(tmp_path, "stale"), 80)
    with within(180):
        done = tcore.run(t)
    res = done["results"]
    assert res["valid?"] is False, res
    assert "G-single-realtime" in res["anomaly-types"], res
    want = jappend.workload(consistency_models=("strict-serializable",)
                            )["checker"].check({}, jax_history(
                                done["history"]))
    assert res["valid?"] == want["valid?"]
    assert res["anomaly-types"] == want["anomaly-types"]


# ---- sqlite ----------------------------------------------------------------


def sqlite_test(pkg, base, wl_name, seed, concurrency):
    wl = pkg[wl_name].workload(rng=random.Random(seed), **pkg["kw"])
    kind = "list-append" if wl_name == "append" else "rw-register"
    opts = {"store-dir": base, "concurrency": concurrency}
    return pkg["sq"]._make_test(opts, f"sqlite-{wl_name}", wl, kind)


@pytest.mark.parametrize("wl_name", ["append", "wr"])
def test_sqlite_concurrency_1_equal_op_for_op(wl_name, tmp_path):
    runs = []
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        t = limited(pkg, sqlite_test(pkg, str(tmp_path / tag), wl_name, 5,
                                     1), 150)
        with within(120):
            runs.append(pkg["core"].run(t))
    want, got = runs
    assert len(got["history"]) == len(want["history"]) == 300
    assert ops_of(got["history"]) == ops_of(want["history"])
    assert got["results"] == want["results"]
    assert got["results"]["valid?"] is True


@pytest.mark.parametrize("wl_name", ["append", "wr"])
def test_sqlite_concurrent_run_valid_and_checked_as_jax(wl_name, tmp_path):
    t = limited(PORT, (tsq.append_test if wl_name == "append"
                       else tsq.wr_test)({"store-dir": str(tmp_path),
                                          "concurrency": 5, "cpu": True}),
                120)
    with within(120):
        done = tcore.run(t)
    res = done["results"]
    assert res["valid?"] is True, res
    if wl_name == "append":
        assert len(txn_oks(done["history"])) >= 40
        saw = any(m[0] == "r" and m[2] for op in txn_oks(done["history"])
                  for m in op.value)
        assert saw, "no read observed an append"
    jwl = jappend if wl_name == "append" else jwr
    want = jwl.workload()["checker"].check({}, jax_history(done["history"]))
    assert res == want


def test_sqlite_busy_completes_as_fail(tmp_path):
    got = []
    for sq in (jsq, tsq):
        path = str(tmp_path / f"{sq.__name__}.db")
        db = sq.SqliteDB(path, wal=False)
        test = {"leave-db-running": True}
        db.setup(test, "local")
        blocker = sqlite3.connect(path, isolation_level=None)
        blocker.execute("BEGIN IMMEDIATE")
        blocker.execute("INSERT INTO la (k, pos, v) VALUES (0, 1, 1)")
        try:
            c = sq.SqliteClient(db, busy_timeout_ms=50).open(test, "local")
            got.append(c.invoke(test, {"f": "txn", "process": 0,
                                       "value": [["append", 0, 99]]}))
            c.close(test)
        finally:
            blocker.execute("ROLLBACK")
            blocker.close()
    assert got[1] == got[0]
    assert got[0]["type"] == "fail" and got[0]["error"] == "busy"


def test_sqlite_checker_catches_injected_corruption(tmp_path, monkeypatch):
    """`tests/test_sqlite_db.py`'s negative control on the port: an
    element duplicated in the `la` table behind the client's back, once
    some read observes it, makes the check invalid."""
    orig_open, orig_invoke = tsq.SqliteClient.open, tsq.SqliteClient.invoke
    for attempt in range(4):
        t = tsq.append_test({"store-dir": str(tmp_path / f"a{attempt}"),
                             "concurrency": 5, "cpu": True})
        state = {"done": False, "k": None, "path": None}

        def opened(self, test, node):
            c = orig_open(self, test, node)
            state["path"] = c._path
            return c

        def invoked(self, test, op):
            if state["done"] and op.get("f") == "txn":
                op = dict(op, value=list(op["value"]) +
                          [["r", state["k"], None]])
            out = orig_invoke(self, test, op)
            if not state["done"] and out["type"] == "ok":
                apps = [m for m in out["value"] if m[0] == "append"]
                if apps:
                    state["done"], state["k"] = True, apps[0][1]
                    k, v = apps[0][1], apps[0][2]
                    dup = sqlite3.connect(state["path"])
                    dup.execute(
                        "INSERT INTO la (k, pos, v) VALUES (?, 1 + "
                        "(SELECT MAX(pos) FROM la WHERE k=?), ?)", (k, k, v))
                    dup.commit()
                    dup.close()
            return out

        monkeypatch.setattr(tsq.SqliteClient, "open", opened)
        monkeypatch.setattr(tsq.SqliteClient, "invoke", invoked)
        with within(120):
            done = tcore.run(limited(PORT, t, 80))
        assert state["done"], "corruption was never injected"
        seen = any(m[0] == "r" and m[1] == state["k"]
                   and isinstance(m[2], list) and len(set(m[2])) < len(m[2])
                   for op in txn_oks(done["history"]) for m in op.value)
        if seen:
            break
    else:
        raise AssertionError("duplicate never observable in 4 runs")
    assert done["results"]["valid?"] is not True, done["results"]


# ---- the entry points ------------------------------------------------------


@pytest.mark.parametrize("cmd", ["test", "test-all"])
def test_regd_suite_base_port_flag_reaches_the_daemons(cmd):
    p, _ = trs.suite()
    nodes = ["-n", "n1", "-n", "n2"]
    default = tcli.opts_to_test_map(p.parse_args([cmd, *nodes]))
    opts = tcli.opts_to_test_map(
        p.parse_args([cmd, *nodes, "--base-port", "9100"]))
    assert trs.append_test(default)["db"].base_port == 7610
    t = trs.append_test(opts)
    assert [t["db"].port(t, n) for n in t["nodes"]] == [9100, 9101]


@pytest.mark.parametrize("module,argv", [
    ("jepsen_tpu_torch.dbs.sqlite", ["--only", "append", "--only", "wr",
                                     "--ops", "60", "-c", "3"]),
    ("jepsen_tpu_torch.dbs.regd_suite", ["--only", "append", "-n", "n1",
                                         "-n", "n2", "-n", "n3", "--ops",
                                         "40", "-c", "1n"]),
])
def test_python_m_test_all_on_the_cpu(module, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    if module.endswith("regd_suite"):
        argv = [*argv, "--base-port", str(free_base())]
    res = subprocess.run(
        [sys.executable, "-m", module, "--cpu", "--store-dir",
         str(tmp_path), "test-all", *argv], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert res.stdout.count("valid? = True") == argv.count("--only")
