"""Port parity for the fault packages: the membership, clock and file
nemeses (`jepsen_tpu_torch/nemesis/membership.py`, `time.py`, `file.py`),
their in-process twins for the sim cluster (`nemesis/sim.py`) and the
composable packages with their windowed schedule (`nemesis/combined.py`),
with the helper source `jepsen_tpu_torch/resources/bump_time.c`.

The spec is `tests/test_nemesis_packages.py` and the two sim-nemesis
tests of `tests/test_invariants.py`, each run here on the port.  Beside
them the two packages run side by side: their generators' event lists
under `generator.sim.simulate` (virtual time, so the schedules are
compared without a clock) and the commands their nemeses send to a
`SimRemote`.  The grudges draw from the global `random`, so each side's
run starts from the same seed.

A nemesis that changes the machine (the clock, traffic shaping,
iptables, pausing foreign processes) runs only against `SimRemote`
here; the file nemesis runs on files under `tmp_path` alone.
"""

import filecmp
import random
import subprocess
import time

import pytest

from jepsen_tpu import db as jdb
from jepsen_tpu import generator as jgen
from jepsen_tpu import net as jnet
from jepsen_tpu.control.sim import SimRemote as JSimRemote
from jepsen_tpu.generator.sim import simulate as jsimulate
from jepsen_tpu.nemesis import combined as jcombined
from jepsen_tpu.nemesis import file as jfile
from jepsen_tpu.nemesis import membership as jmembership
from jepsen_tpu.nemesis import sim as jsim
from jepsen_tpu.nemesis import time as jtime
from jepsen_tpu.workloads import mem as jmem
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import net as tnet
from jepsen_tpu_torch.control.local import LoopbackRemote
from jepsen_tpu_torch.control.sim import SimRemote
from jepsen_tpu_torch.generator.sim import simulate
from jepsen_tpu_torch.nemesis import combined, membership
from jepsen_tpu_torch.nemesis import file as tfile
from jepsen_tpu_torch.nemesis import sim as tsim
from jepsen_tpu_torch.nemesis import time as ttime
from jepsen_tpu_torch.nemesis.file import FileCorruptionNemesis
from jepsen_tpu_torch.nemesis.time import HELPER_SRC, ClockNemesis
from jepsen_tpu_torch.workloads import mem as tmem

NODES = ["n1", "n2", "n3"]
JAX = dict(db=jdb, gen=jgen, net=jnet, remote=JSimRemote,
           simulate=jsimulate, combined=jcombined, file=jfile,
           membership=jmembership, sim=jsim, time=jtime, mem=jmem)
PORT = dict(db=tdb, gen=tgen, net=tnet, remote=SimRemote,
            simulate=simulate, combined=combined, file=tfile,
            membership=membership, sim=tsim, time=ttime, mem=tmem)
SIDES = (JAX, PORT)


def sim_test(**extra):
    t = {"nodes": list(NODES), "remote": SimRemote(), "net": tnet.SimNet()}
    t.update(extra)
    return t


# ---------------------------------------------------------------- clock

def test_bump_time_c_compiles(tmp_path):
    out = tmp_path / "bump_time"
    subprocess.run(["cc", "-O2", "-o", str(out), HELPER_SRC], check=True)
    r = subprocess.run([str(out)], capture_output=True)
    assert r.returncode == 2  # usage
    assert b"usage" in r.stderr


def test_bump_time_c_byte_equal():
    assert HELPER_SRC != jtime.HELPER_SRC
    assert filecmp.cmp(HELPER_SRC, jtime.HELPER_SRC, shallow=False)


def test_clock_nemesis_cmds():
    t = sim_test()
    nem = ClockNemesis().setup(t)
    # setup uploaded + compiled on every node
    for n in NODES:
        node = t["remote"].node(n)
        assert node.uploads, f"no upload on {n}"
        assert any("cc -O2" in c for c in node.cmds())
    comp = nem.invoke(t, {"f": "bump-clock", "value": {"n2": 5000},
                          "type": "invoke"})
    assert comp["type"] == "info"
    assert any("bump_time bump 5000" in c
               for c in t["remote"].node("n2").cmds())
    nem.invoke(t, {"f": "strobe-clock",
                   "value": {"delta_ms": 100, "period_ms": 5,
                             "duration_ms": 50, "nodes": ["n1"]},
                   "type": "invoke"})
    assert any("strobe 100 5 50" in c for c in t["remote"].node("n1").cmds())
    t["remote"].node("n3").respond("date*", "0")
    nem.invoke(t, {"f": "reset-clock", "value": None, "type": "invoke"})
    assert any(c.startswith("date -u -s")
               for c in t["remote"].node("n3").cmds())


CLOCK_OPS = (
    {"f": "bump-clock", "value": {"n2": 5000}},
    {"f": "bump-clock", "value": -250},
    {"f": "strobe-clock", "value": {"delta_ms": 100, "period_ms": 5,
                                    "duration_ms": 50, "nodes": ["n1"]}},
    {"f": "strobe-clock", "value": None},
    {"f": "reset-clock", "value": None},
    {"f": "reset-clock", "value": ["n3"]},
    {"f": "check-clock-offsets", "value": None},
)


def _commands(remote):
    return {n: remote.node(n).cmds() for n in NODES}


def test_clock_nemesis_commands_equal(monkeypatch):
    """Every op of `ClockNemesis`, then its teardown, sends the same
    commands to a `SimRemote` in both packages (the control host's clock
    held still, since `reset-clock` writes it into the command), and
    returns the same completions; the uploads are the two packages'
    byte-equal helpers to the same remote path."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    out = []
    for side in SIDES:
        remote = side["remote"]()
        for n in NODES:
            remote.node(n).respond("date +%s.%N", "1700000000.5")
        t = {"nodes": list(NODES), "remote": remote}
        nem = side["time"].ClockNemesis().setup(t)
        comps = [nem.invoke(t, dict(op, type="invoke")) for op in CLOCK_OPS]
        nem.teardown(t)
        uploads = {n: [(dst, open(src, "rb").read())
                       for src, dst in remote.node(n).uploads]
                   for n in NODES}
        out.append((_commands(remote), comps, uploads))
    assert out[0] == out[1]
    assert all(out[1][0][n] for n in NODES)


# ---------------------------------------------------------------- file

def test_file_corruption_loopback(tmp_path, monkeypatch):
    # SNAP_DIR is absolute, and the loopback session roots only relative
    # paths under base_dir: point it into tmp_path as well.
    snaps = tmp_path / "snapshots"
    monkeypatch.setattr(tfile, "SNAP_DIR", str(snaps))
    t = {"nodes": ["n1"], "remote": LoopbackRemote(base_dir=str(tmp_path))}
    target = "data/db.bin"
    with control.with_session("n1", t["remote"].connect("n1")):
        control.exec_("mkdir", "-p", "data")
        control.exec_("bash", "-c",
                      f"head -c 4096 /dev/zero > {target}")
    nem = FileCorruptionNemesis(target)
    original = (tmp_path / "n1" / target).read_bytes()

    nem.invoke(t, {"f": "snapshot-file", "value": None, "type": "invoke"})
    assert (snaps / "data_db.bin").read_bytes() == original
    comp = nem.invoke(t, {"f": "bitflip-file", "value": None,
                          "type": "invoke"})
    assert comp["type"] == "info"
    corrupted = (tmp_path / "n1" / target).read_bytes()
    assert corrupted != original, "bitflip changed nothing"
    assert len(corrupted) == len(original)

    nem.invoke(t, {"f": "truncate-file", "value": {"bytes": 100},
                   "type": "invoke"})
    assert (tmp_path / "n1" / target).stat().st_size == 4096 - 100

    nem.invoke(t, {"f": "restore-file", "value": None, "type": "invoke"})
    assert (tmp_path / "n1" / target).read_bytes() == original


FILE_OPS = (
    {"f": "snapshot-file", "value": None},
    {"f": "bitflip-file", "value": {"nodes": ["n2"]}},
    {"f": "truncate-file", "value": {"bytes": 100}},
    {"f": "truncate-file", "value": {"file": "/var/lib/x y.db",
                                     "nodes": ["n3"]}},
    {"f": "restore-file", "value": None},
)


def test_file_nemesis_commands_equal():
    """`FileCorruptionNemesis`'s four ops send the same commands (paths
    with spaces escaped alike) and complete alike in both packages."""
    out = []
    for side in SIDES:
        remote = side["remote"]()
        t = {"nodes": list(NODES), "remote": remote}
        nem = side["file"].FileCorruptionNemesis("/var/lib/db/data.bin")
        comps = [nem.invoke(t, dict(op, type="invoke")) for op in FILE_OPS]
        out.append((_commands(remote), comps))
    assert out[0] == out[1]
    assert any("dd if=/dev/urandom" in c for c in out[1][0]["n2"])
    with pytest.raises(ValueError):
        tfile.FileCorruptionNemesis().invoke(
            {"nodes": NODES, "remote": SimRemote()},
            {"f": "bitflip-file", "value": None})


@pytest.mark.parametrize("seed", [0, 1])
def test_file_package_commands_equal(seed):
    """The file package: its generator's ops (node and fault drawn from
    a seeded rng) under `simulate`, then each op through its nemesis on
    a `SimRemote`: the same events and the same commands."""
    out = []
    for side in SIDES:
        pkg = side["combined"].nemesis_package({
            "faults": {"file"}, "file": "/var/lib/db/data.bin",
            "interval": 1.0, "rng": random.Random(seed)})
        evs = side["simulate"](
            side["gen"].time_limit(6.0, pkg["generator"]),
            {"concurrency": 1, "nodes": list(NODES)})
        remote = side["remote"]()
        t = {"nodes": list(NODES), "remote": remote}
        nem = pkg["nemesis"].setup(t)
        comps = [nem.invoke(t, e) for e in evs if e["type"] == "invoke"]
        out.append((evs, comps, _commands(remote), pkg["perf"],
                    pkg["final_generator"]))
    assert out[0] == out[1]
    assert len(out[1][1]) >= 4


# ------------------------------------------------------------ membership

class FakeMembers(membership.MembershipState):
    def __init__(self, nodes):
        self.members = set(nodes)
        self._pending = None

    def view(self, test):
        # converge one poll after apply
        if self._pending:
            op, steps = self._pending
            if steps <= 0:
                if op["f"] == "leave-node":
                    self.members.discard(op["value"])
                else:
                    self.members.add(op["value"])
                self._pending = None
            else:
                self._pending = (op, steps - 1)
        return set(self.members)

    def possible_ops(self, test, view):
        if len(view) > 1:
            return [{"f": "leave-node", "value": sorted(view)[-1],
                     "type": "invoke"}]
        return []

    def apply_op(self, test, op):
        self._pending = (op, 1)
        return "requested"

    def converged(self, test, view, op):
        if op["f"] == "leave-node":
            return op["value"] not in view
        return op["value"] in view


def test_membership_nemesis_converges():
    t = sim_test()
    st = FakeMembers(NODES)
    nem = membership.MembershipNemesis(st, converge_timeout_s=5,
                                       poll_interval_s=0.01).setup(t)
    ops = membership.possible_op(st, t)
    comp = nem.invoke(t, ops)
    assert comp["value"]["converged"] is True
    assert st.members == {"n1", "n2"}


def test_membership_nemesis_sim_state_equal():
    """`MembershipNemesis` over `SimMembershipState` on a `MemStore`: the
    same completions (times aside), views, view log and member sets in
    both packages through a leave, a change refused while one is in
    flight, a join and a view op."""
    out = []
    for side in SIDES:
        store = side["mem"].MemStore()
        client = side["mem"].MemClient(store).open({}, "n1")
        t = {"nodes": list(NODES), "client": client}
        state = side["sim"].SimMembershipState(NODES, converge_polls=2)
        nem = side["membership"].MembershipNemesis(
            state, converge_timeout_s=2.0, poll_interval_s=0.001).setup(t)
        seen = []
        for _ in range(3):
            op = side["membership"].possible_op(state, t)
            seen.append(nem.invoke(t, op))
        state._pending = ({"f": "join-node", "value": "n3"}, 5)
        seen.append(nem.invoke(t, {"f": "leave-node", "value": "n2",
                                   "type": "invoke"}))
        state._pending = None
        seen.append(nem.invoke(t, {"f": "membership-view", "value": None,
                                   "type": "invoke"}))
        log = [{k: v for k, v in e.items() if k != "time"}
               for e in nem.view_log]
        out.append((seen, log, nem.view, sorted(store.members),
                    [p["op"] for p in nem.pending]))
    assert out[0] == out[1]
    assert [c["type"] for c in out[1][0]] == ["ok", "ok", "ok", "fail",
                                              "info"]


def test_sim_skew_nemesis_tears_bank_reads():
    from jepsen_tpu_torch.nemesis.sim import SimClockSkewNemesis
    from jepsen_tpu_torch.workloads.mem import MemClient, MemStore

    s = MemStore()
    s.accounts = {0: 10, 1: 10}
    c = MemClient(s).open({"nodes": ["n1"]}, "n1")
    t = {"client": c, "workload-kind": "bank", "nodes": ["n1"]}
    nem = SimClockSkewNemesis(random.Random(0))
    comp = nem.invoke(t, {"f": "start-skew", "value": None,
                          "type": "invoke"})
    assert comp["type"] == "info"
    assert "faketime" in comp["value"]  # FAKETIME-spec'd offset
    # move money, then read under skew: some reads tear
    for i in range(6):
        c.invoke(t, {"f": "transfer",
                     "value": {"from": 0, "to": 1, "amount": 2}})
    sums = {sum(c.invoke(t, {"f": "read", "value": None})["value"]
                .values()) for _ in range(16)}
    assert any(x != 20 for x in sums), sums
    nem.invoke(t, {"f": "stop-skew", "value": None, "type": "invoke"})
    assert sum(c.invoke(t, {"f": "read", "value": None})["value"]
               .values()) == 20


def test_sim_membership_removed_node_fails_cleanly():
    from jepsen_tpu_torch.nemesis.membership import MembershipNemesis
    from jepsen_tpu_torch.nemesis.sim import SimMembershipState
    from jepsen_tpu_torch.workloads.mem import MemClient, MemStore

    s = MemStore()
    nodes = ["n1", "n2"]
    c1 = MemClient(s).open({}, "n1")
    c2 = MemClient(s).open({}, "n2")
    t = {"client": c1, "nodes": nodes}
    nem = MembershipNemesis(SimMembershipState(nodes),
                            converge_timeout_s=2.0,
                            poll_interval_s=0.01).setup(t)
    comp = nem.invoke(t, {"f": "leave-node", "value": "n2",
                          "type": "invoke"})
    assert comp["type"] == "ok" and comp["value"]["converged"]
    r = c2.invoke(t, {"f": "txn", "value": [["r", 0, None]]})
    assert r["type"] == "fail" and r["error"] == "node-removed"
    assert c1.invoke(t, {"f": "txn",
                         "value": [["r", 0, None]]})["type"] == "ok"
    # rejoin heals
    comp = nem.invoke(t, {"f": "join-node", "value": "n2",
                          "type": "invoke"})
    assert comp["type"] == "ok"
    assert c2.invoke(t, {"f": "txn",
                         "value": [["r", 0, None]]})["type"] == "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_skew_reads_equal(seed):
    """Under `SimClockSkewNemesis` from one seed, the same list-append
    txns on both packages' `MemStore` read the same torn values, and the
    skew ops complete with the same offsets, rates and FAKETIME specs."""
    out = []
    for side in SIDES:
        rng = random.Random(seed)
        store = side["mem"].MemStore()
        c = side["mem"].MemClient(store).open({"nodes": NODES}, "n1")
        t = {"client": c, "nodes": NODES}
        nem = side["sim"].SimClockSkewNemesis(random.Random(seed))
        seen = []
        for i in range(60):
            if i % 20 == 5:
                seen.append(nem.invoke(t, {"f": "start-skew", "value": None,
                                           "type": "invoke"}))
            if i % 20 == 15:
                seen.append(nem.invoke(t, {"f": "stop-skew", "value": None,
                                           "type": "invoke"}))
            k = rng.randrange(3)
            txn = [["append", k, i], ["r", k, None],
                   ["r", (k + 1) % 3, None]]
            seen.append(c.invoke(t, {"f": "txn", "value": txn}))
        nem.teardown(t)
        out.append(seen)
    assert out[0] == out[1]
    assert sum(op.get("f") == "start-skew" for op in out[1]) == 3


# ---------------------------------------------------------------- combined

def fake_proc_db(db_mod):
    class FakeProcDB(db_mod.DB, db_mod.Process, db_mod.Pause):
        def __init__(self):
            self.state = {}

        def start(self, test, node):
            self.state[node] = "up"

        def kill(self, test, node):
            self.state[node] = "down"

        def pause(self, test, node):
            self.state[node] = "paused"

        def resume(self, test, node):
            self.state[node] = "up"

    return FakeProcDB()


def test_nemesis_package_composition():
    rng = random.Random(0)
    pkg = combined.nemesis_package({
        "faults": {"partition", "kill", "pause"},
        "db": fake_proc_db(tdb), "interval": 1.0, "rng": rng})
    assert pkg["nemesis"] is not None
    assert pkg["generator"] is not None
    assert len(pkg["perf"]) == 3
    assert pkg["final_generator"]


def test_nemesis_package_generator_schedule():
    rng = random.Random(0)
    pkg = combined.nemesis_package({
        "faults": {"kill"}, "db": fake_proc_db(tdb), "interval": 1.0,
        "rng": rng})
    evs = simulate(tgen.time_limit(5.0, pkg["generator"]),
                   {"concurrency": 1})
    fs = [e["f"] for e in evs if e["type"] == "invoke"]
    # 5s at interval 1 -> kill@1, start@2, kill@3, start@4
    assert fs[:4] == ["kill", "start", "kill", "start"]


def test_kill_package_invokes_db():
    rng = random.Random(0)
    d = fake_proc_db(tdb)
    t = sim_test()
    pkg = combined.nemesis_package({"faults": {"kill"}, "db": d,
                                    "rng": rng})
    nem = pkg["nemesis"].setup(t)
    comp = nem.invoke(t, {"f": "kill", "value": None, "type": "invoke"})
    killed = comp["value"]
    assert len(killed) == 1 and d.state[killed[0]] == "down"
    nem.invoke(t, {"f": "start", "value": None, "type": "invoke"})
    assert d.state[killed[0]] == "up"


def test_partition_package_full_cycle():
    rng = random.Random(3)
    t = sim_test()
    pkg = combined.nemesis_package({"faults": {"partition"},
                                    "interval": 1.0, "rng": rng})
    nem = pkg["nemesis"].setup(t)
    # drive the generator for one start op (fn-valued, needs test map)
    evs = simulate(tgen.time_limit(2.5, pkg["generator"]),
                   {"concurrency": 1, "nodes": list(NODES)})
    starts = [e for e in evs
              if e["type"] == "invoke" and e["f"] == "start-partition"]
    assert starts and starts[0]["value"], "grudge chosen by generator"
    nem.invoke(t, starts[0])
    assert t["net"].blocked
    nem.invoke(t, {"f": "stop-partition", "value": None, "type": "invoke"})
    assert not t["net"].blocked


def _opts(side, fault, seed, **extra):
    """A package's options for `fault` on `side`, with every facet it
    needs (a db with the Process and Pause facets, a file, a membership
    state) and a seeded rng."""
    return dict({"faults": {fault}, "interval": 1.0,
                 "db": fake_proc_db(side["db"]), "file": "/var/lib/db.bin",
                 "nodes": list(NODES), "rng": random.Random(seed)}, **extra)


def _simulated(side, pkg, seconds, seed):
    random.seed(seed)   # the grudges draw from the global random
    return side["simulate"](side["gen"].time_limit(seconds,
                                                   pkg["generator"]),
                            {"concurrency": 1, "nodes": list(NODES)})


@pytest.mark.parametrize("fault", sorted(jcombined.WINDOW_FAULTS))
def test_window_fault_package_schedules_equal(fault):
    """Each family of `WINDOW_FAULTS`: the port has the same families,
    and its interval package gives the same simulated events (ops,
    values and virtual times), final generator and perf metadata."""
    assert sorted(combined.WINDOW_FAULTS) == sorted(jcombined.WINDOW_FAULTS)
    out = []
    for side in SIDES:
        pkg = side["combined"].WINDOW_FAULTS[fault](_opts(side, fault, 7))
        assert pkg is not None, fault
        out.append((_simulated(side, pkg, 9.5, 7), pkg["final_generator"],
                    pkg["perf"]))
    assert out[0] == out[1]
    assert sum(e["type"] == "invoke" for e in out[1][0]) >= 4


def _windows(seed):
    """Window descriptors as a campaign writes them: a seeded mix of
    every family, offsets and durations in seconds, one unknown family
    (skipped by both)."""
    rng = random.Random(seed)
    fams = sorted(jcombined.WINDOW_FAULTS) + ["no-such-fault"]
    out = []
    for pos in range(10):
        out.append({"pos": pos, "fault": rng.choice(fams),
                    "at_s": round(rng.uniform(0.0, 8.0), 3),
                    "dur_s": round(rng.uniform(0.2, 2.0), 3),
                    "digest": f"{rng.getrandbits(32):08x}"})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedule_package_events_equal(seed):
    """`schedule_package` from the same windows: the same simulated
    events, every op stamped with its window, and the same perf
    metadata and final generators; with a db without the Process facet
    the kill windows drop out of both."""
    for db_facets in (True, False):
        out = []
        for side in SIDES:
            opts = _opts(side, None, seed, windows=_windows(seed),
                         host="h1")
            del opts["faults"]
            if not db_facets:
                opts["db"] = side["db"].Noop()
            pkg = side["combined"].schedule_package(opts)
            evs = _simulated(side, pkg, 20.0, seed) \
                if pkg["generator"] else []
            out.append((evs, pkg["final_generator"], pkg["perf"]))
        assert out[0] == out[1], (seed, db_facets)
        invokes = [e for e in out[1][0] if e["type"] == "invoke"]
        assert invokes and all(e["window"]["host"] == "h1"
                               for e in invokes)
        if not db_facets:
            assert not any(e["f"] in ("kill", "pause") for e in invokes)


def test_nemesis_package_all_faults_equal():
    """Every family at once through `nemesis_package` (with an extra
    package), then composed again with a schedule: the same events,
    perf lists and final generators, and the composed nemesis routes
    each start op of the sim families alike (the db's states after)."""
    out = []
    for side in SIDES:
        c = side["combined"]
        extra = {"nemesis": c.nc.Noop(), "generator": None,
                 "final_generator": None,
                 "perf": {"name": "custom", "start": {"custom-start"},
                          "stop": set(), "fs": set()}}
        opts = _opts(side, None, 11, extra_packages=[extra])
        opts["faults"] = set(c.WINDOW_FAULTS)
        pkg = c.nemesis_package(opts)
        again = c.compose_packages(
            [pkg, c.schedule_package(dict(opts, windows=_windows(11)))])
        d = opts["db"]
        t = {"nodes": list(NODES), "remote": side["remote"](),
             "net": side["net"].SimNet(), "db": d,
             "client": side["mem"].MemClient(side["mem"].MemStore())}
        nem = pkg["nemesis"].setup(t)
        comps = [nem.invoke(t, {"f": f, "value": None, "type": "invoke"})
                 for f in ("kill", "start", "pause", "resume")]
        out.append((_simulated(side, pkg, 6.0, 11), pkg["perf"],
                    pkg["final_generator"], again["perf"],
                    again["final_generator"], comps, d.state))
    assert out[0] == out[1]
    assert len(out[1][1]) == len(jcombined.WINDOW_FAULTS) + 1
