"""Port parity for the fleet's autopilot: `jepsen_tpu_torch/fleet/
autopilot.py` against the JAX package's on the CPU.

The spec is the JAX package's `tests/test_autopilot.py`, all but its
soak, with the spec's synthetic drainer (every cell claimed and
completed in process with a shaped record, no execution) and
`minimize.shrink` patched as there.  Each scenario runs once with each
package's modules in a store of its own under a fixed wall clock
(`time.time` and `time.gmtime` patched alike), asserts the spec's
contract, and the two observations must be equal: the journal's bytes
and `digest()` (equal event scripts give equal digests), the gate's
verdicts, the quarantine and parole state, the witness records, the
plans by generation.  Also here: the tests the observatory's spec
(`tests/test_alerts.py`, `tests/test_observability.py`) keeps for the
autopilot — `_autopilot_signals` on a real `AutopilotJournal` and the
five twin-pass parole tests — and `scenario_rotation`, `obs gc`'s
archival and the host-info series.  The chaos scenario runs the port
alone (its injections follow the loop's timing) and asserts the
contract.
"""

import json
import os
import re
import shutil
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import minimize as jmin  # noqa: E402
from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu.fleet import autopilot as jap  # noqa: E402
from jepsen_tpu.minimize import witness as jwit  # noqa: E402
from jepsen_tpu.telemetry import alerts as jalerts  # noqa: E402
from jepsen_tpu.telemetry import prometheus as jprom  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import minimize as tmin  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch import telemetry as ttel  # noqa: E402
from jepsen_tpu_torch.fleet import autopilot as tap  # noqa: E402
from jepsen_tpu_torch.minimize import witness as twit  # noqa: E402
from jepsen_tpu_torch.telemetry import alerts as talerts  # noqa: E402
from jepsen_tpu_torch.telemetry import prometheus as tprom  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(AP=jap, minimize=jmin, res=jres,
                                 store=jstore, tel=jtel, wit=jwit,
                                 alerts=jalerts, prom=jprom, synth=jsynth),
    "torch": types.SimpleNamespace(AP=tap, minimize=tmin, res=tres,
                                   store=tstore, tel=ttel, wit=twit,
                                   alerts=talerts, prom=tprom,
                                   synth=tsynth),
}

SPEC = {"name": "ap", "workloads": ["bank"], "seeds": [0, 1, 2],
        "opts": {"time-limit": 0.2}}
KEY = "bank|nofault|s2"


@pytest.fixture()
def clock(monkeypatch):
    c = types.SimpleNamespace(now=1_700_000_000.0)
    real_gmtime = time.gmtime
    monkeypatch.setattr(time, "time", lambda: c.now)
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real_gmtime(*(a or (c.now,))))
    return c


def both(tmp_path, scenario, clock=None):
    """Run `scenario(P, base)` with each package in turn in the same
    store path, emptied between the two (a gate's reason names its
    index path, and the journal digests it), the clock reset to the
    same start; the two observations must be equal.  Returns the
    port's."""
    out = {}
    start = clock.now if clock is not None else None
    base = tmp_path / "base"
    for name, P in PKGS.items():
        if clock is not None:
            clock.now = start
        shutil.rmtree(base, ignore_errors=True)
        base.mkdir()
        out[name] = scenario(P, str(base))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _drainer(ap, spans_for=None):
    """The spec's synthetic fleet: claim and complete every cell with a
    verdict record (no execution); `spans_for(spec)` shapes what the
    gate sees."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            code, out = ap.coordinator.claim({"worker": "syn"})
            if code != 200 or not out.get("spec"):
                stop.wait(0.01)
                continue
            sp = out["spec"]
            # the spec's drainer may complete a generation-0 cell before
            # `step` has admitted it under its label (the coordinator
            # enqueues generation 0 unlabelled when it is built), and
            # the record then carries the coordinator's own stamp: wait
            # for the label, so that every run sees the same records
            t_end = time.monotonic() + 10.0
            while sp["run_id"] not in ap.coordinator._gen_by_run and \
                    time.monotonic() < t_end and not stop.is_set():
                stop.wait(0.005)
            key = (f'{sp["workload_label"]}|{sp["fault_label"]}'
                   f'|s{sp["seed"]}')
            rec = {"run": sp["run_id"], "key": key,
                   "workload": sp["workload_label"],
                   "fault": sp["fault_label"], "seed": sp["seed"],
                   "valid?": True, "dir": None}
            if spans_for is not None:
                extra = spans_for(sp)
                if extra:
                    rec.update(extra)
            ap.coordinator.complete({"worker": "syn", "run": sp["run_id"],
                                     "record": rec})

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return stop, t


def _run(ap, spans_for=None):
    stop, t = _drainer(ap, spans_for)
    try:
        return ap.run()
    finally:
        ap.stop.set()
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        ap.coordinator.close()


def _journal(ap):
    with open(ap.journal.path, "rb") as f:
        return f.read()


def _records(ap):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in ap.coordinator.idx.records]


# ---------------------------------------------------------- journal

def _journal_replay(P, base):
    p = os.path.join(base, "a.autopilot.jsonl")
    j = P.AP.AutopilotJournal(p)
    j.open_gen("g0000", seeds=[0, 1], runs=2)
    j.close_gen("g0000", [{"span": None, "status": "insufficient-data",
                           "rc": 2}])
    j.quarantine("bank|nofault|s1", gen="g0001", span="workload",
                 rel_delta=0.6)
    j.shrink("bank|nofault|s1", gen="g0001", outcome={"ops": 3})
    j.scale("spawn", worker="w1", version="v1")
    d = j.digest()
    r = P.AP.AutopilotJournal(p)
    assert r.digest() == d and r.scale_events == 1
    assert r.closed_labels() == ["g0000"]
    with open(p, "ab") as f:
        f.write(b'{"ev": "quarantine", "key": "to')
    torn = P.AP.AutopilotJournal(p)
    assert torn.digest() == d
    with open(p, "rb") as f:
        assert f.read().endswith(b'"to')
    torn.scale("drain", worker="w1")
    with open(p, "rb") as f:
        data = f.read()
    for line in data.splitlines():
        json.loads(line)
    assert P.AP.AutopilotJournal(p).digest() == d
    return d, data, r.quarantined, r.shrinks, r.gens


def test_journal_replay_and_torn_tail(tmp_path, clock):
    both(tmp_path, _journal_replay, clock)


def _parole_replay(P, base):
    path = os.path.join(base, "ap.jsonl")
    j = P.AP.AutopilotJournal(path)
    j.open_gen("g0000", runs=1)
    j.close_gen("g0000", [])
    j.quarantine("k", gen="g0000", span="workload")
    j.parole("k", gen="g0000", twin={"digest": "abc", "valid?": True})
    j.quarantine("k", gen="g0002", span="workload")
    with open(path) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    assert any(e.get("ev") == "parole" and e.get("twin") for e in evs)
    stripped = os.path.join(base, "stripped.jsonl")
    with open(stripped, "w") as f:
        for e in evs:
            e.pop("twin", None)
            f.write(json.dumps(e, sort_keys=True) + "\n")
    d = P.AP.AutopilotJournal(path).digest()
    assert P.AP.AutopilotJournal(stripped).digest() == d
    return d, evs, P.AP.AutopilotJournal(path).quarantined


def test_parole_event_with_twin_field_is_replay_stable(tmp_path, clock):
    q = both(tmp_path, _parole_replay, clock)[2]
    assert q["k"]["history"] == [{"gen": "g0000", "paroled-gen": "g0000"}]


# ------------------------------------------------------ crash window

def _crash_window(P, base):
    base = os.path.join(base, "store")
    ap1 = P.AP.Autopilot(SPEC, base, generations=1, poll_s=0.02)
    out = [_run(ap1, lambda sp: {"spans": {"workload": 0.1}})]
    assert out[0]["generations"] == 1
    ap1.journal.open_gen("g0001", seeds=[1, 2, 0], runs=3)
    d = P.AP.AutopilotJournal(P.AP.autopilot_path("ap", base)).digest()
    for _ in range(2):  # a restart, then a second one that changes nothing
        ap = P.AP.Autopilot(SPEC, base, poll_s=0.02)
        c = ap.coordinator.queue.counts()
        assert c["duplicates"] == 0 and c["done"] == 3 and c["queued"] == 3
        assert c["cells"] == 6 and ap.journal.digest() == d
        out.append((c, ap.coordinator.queue.digest(), _journal(ap)))
        ap.coordinator.close()
    return out


def test_crash_between_gen_open_and_enqueue_resumes_zero_dupes(tmp_path,
                                                                clock):
    both(tmp_path, _crash_window, clock)


# -------------------------------------------------- gate rc 2 streak

def _rc2_streak(P, base):
    ap = P.AP.Autopilot(SPEC, os.path.join(base, "store"), generations=3,
                        poll_s=0.02)
    out = _run(ap, None)
    assert out["generations"] == 3 and out["quarantined"] == []
    for label in ap.journal.closed_labels():
        for v in ap.journal.gens[label]["verdicts"]:
            assert v["rc"] == 2
            assert v["status"] in ("insufficient-data", "gate-error")
    return out, _journal(ap), _records(ap)


def test_rc2_streak_closes_generations_never_quarantines(tmp_path, clock):
    both(tmp_path, _rc2_streak, clock)


# ------------------------------------- regression -> quarantine+shrink

def _regressing_spans(sp):
    gen = (sp.get("opts") or {}).get("autopilot-gen")
    s = int(sp["seed"])
    dur = (0.3 + 0.01 * s) if gen == "g0001" else (0.1 + 0.001 * s)
    return {"spans": {"workload": dur}, "valid?": gen != "g0001",
            "dir": f"runs/{sp['run_id']}"}


def _fake_shrink(shrunk):
    def shrink(run_dir, **kw):
        shrunk.append((os.path.basename(run_dir), sorted(kw.items())))
        return {"ops": 3, "source-ops": 12, "digest": "abc123",
                "anomaly-types": ["G-single"], "probes": 5, "cached": 1,
                "fault-windows": []}

    return shrink


def _regression(monkeypatch):
    def scenario(P, base):
        shrunk = []
        monkeypatch.setattr(P.minimize, "shrink", _fake_shrink(shrunk))
        base = os.path.join(base, "store")
        ap = P.AP.Autopilot(SPEC, base, generations=2, spans=("workload",),
                            poll_s=0.02)
        out = _run(ap, _regressing_spans)
        assert out["quarantined"] == [KEY]
        v = ap.journal.gens["g0001"]["verdicts"][0]
        assert v["status"] == "regression" and v["rc"] == 1
        assert v["key"] == KEY and v["key-rel-delta"] > 2.0
        wit = [r for r in ap.coordinator.idx.records if r.get("witness")]
        assert len(wit) == 1 and wit[0]["key"] == KEY
        art = wit[0]["autopilot"]["forensics"]
        assert art and os.path.exists(os.path.join(base, art))
        g = {m["name"]: m["value"]
             for m in P.tel.registry().snapshot()["gauges"]}
        assert g["fleet-quarantined-cells"] == 1
        plans = [[rs.key for rs in ap._plan(i)] for i in range(3)]
        assert plans[2] == ["bank|nofault|s0", "bank|nofault|s1"]
        assert KEY in plans[1]
        st = ap.coordinator._status()[1]
        assert st["autopilot"]["quarantined"][KEY]["span"] == "workload"
        assert st["autopilot"]["journal-digest"] == ap.journal.digest()
        ap_doc = {k: v for k, v in st["autopilot"].items()
                  if k != "alerts"}
        return (out, _journal(ap), _records(ap), shrunk, plans, ap_doc,
                ap.journal.shrinks)

    return scenario


def test_regression_quarantined_and_autoshrunk(tmp_path, clock,
                                               monkeypatch):
    both(tmp_path, _regression(monkeypatch), clock)


def _fixed_then_reoffending_spans(sp):
    gen = (sp.get("opts") or {}).get("autopilot-gen")
    s = int(sp["seed"])
    bad = gen in ("g0001", "g0005")
    dur = (0.3 + 0.01 * s) if bad else (0.1 + 0.001 * s)
    return {"spans": {"workload": dur}, "valid?": not bad,
            "dir": f"runs/{sp['run_id']}"}


def _parole(monkeypatch):
    def scenario(P, base):
        monkeypatch.setattr(P.minimize, "shrink", _fake_shrink([]))
        monkeypatch.setattr(
            P.AP.Autopilot, "_twin_recheck",
            lambda self, key, digest: (True, {"digest": digest,
                                              "checker": "stub",
                                              "valid?": True}))
        ap = P.AP.Autopilot(SPEC, os.path.join(base, "store"),
                            generations=6, spans=("workload",),
                            poll_s=0.02, parole_after=2)
        out = _run(ap, _fixed_then_reoffending_spans)
        assert out["generations"] == 6
        v = ap.journal.quarantined[KEY]
        assert v["history"] == [{"gen": "g0001", "paroled-gen": "g0003"}]
        assert [ap.journal.gens[label]["runs"] for label in
                ("g0000", "g0001", "g0002", "g0003", "g0004")] == \
            [3, 3, 2, 2, 3]
        assert v["gen"] == "g0005" and "paroled-gen" not in v
        plans = {i: [rs.key for rs in ap._plan(i)] for i in range(7)}
        assert KEY in plans[1] and KEY not in plans[2]
        assert KEY in plans[4] and KEY not in plans[6]
        assert P.AP.AutopilotJournal(ap.journal.path).digest() == \
            ap.journal.digest()
        return out, _journal(ap), plans, _records(ap)

    return scenario


def test_quarantine_parole_readmits_then_requarantines(tmp_path, clock,
                                                       monkeypatch):
    both(tmp_path, _parole(monkeypatch), clock)


def test_chaos_on_every_seam_never_wedges(tmp_path):
    plan = tres.FaultPlan(
        seed=7, p=0.35, kinds=("oom", "stall"), stall_s=0.005,
        sites="autopilot.enqueue|autopilot.gate|autopilot.shrink"
              "|autopilot.scale")
    ap = tap.Autopilot(SPEC, str(tmp_path / "store"), generations=2,
                       spans=("workload",), poll_s=0.02)
    with tres.use(plan):
        out = _run(ap, lambda sp: {"spans": {"workload": 0.1}})
    assert out["generations"] == 2
    for label in ap.journal.closed_labels():
        for v in ap.journal.gens[label]["verdicts"]:
            assert v["to-gen"] == label and v["rc"] in (0, 1, 2)
    assert plan.injected or plan.p == 0.0


# ------------------------------------------------- planning and rotation

ROT_TEMPLATE = {"name": "rot", "workloads": [
    {"name": "bank", "label": "pivot"}, "set", "noop",
    {"name": "append", "label": "la"}, "wr"], "seeds": [0, 1]}


@pytest.mark.parametrize("pivot,slots", [((), 1), (("pivot",), 2),
                                         (("set", "la"), 1), ((), 9)])
def test_scenario_rotation_equal(pivot, slots):
    mt = tap.scenario_rotation(pivot=pivot, slots=slots)
    mj = jap.scenario_rotation(pivot=pivot, slots=slots)
    for i in range(7):
        a = mt(i, json.loads(json.dumps(ROT_TEMPLATE)))
        b = mj(i, json.loads(json.dumps(ROT_TEMPLATE)))
        assert a == b, i
    one = {"name": "x", "workloads": ["bank"]}
    assert mt(3, dict(one)) == mj(3, dict(one))


def _plans(P, base):
    ap = P.AP.Autopilot(ROT_TEMPLATE, base, poll_s=0.02,
                        mutate=P.AP.scenario_rotation(pivot=("pivot",)))
    try:
        out = [(ap._gen_spec(i), [(rs.run_id, rs.key) for rs in
                                  ap._plan(i)]) for i in range(5)]
        out.append((ap._label(12), ap._gen_index("g0012"),
                    ap._gen_index("bad"), ap._next_index()))
        out.append(P.AP.autopilot_path("rot", base)[len(base):])
        return out
    finally:
        ap.close()


def test_generation_specs_and_plans_equal(tmp_path, clock):
    both(tmp_path, _plans, clock)


# ----------------------------------------- observatory's autopilot tests

def _gate_signals(P, base):
    j = P.AP.AutopilotJournal(os.path.join(base, "ap.jsonl"))
    j.open_gen("g0000", runs=3)
    j.close_gen("g0000", [{"span": "workload", "rc": 2}])
    j.open_gen("g0001", runs=3)
    j.close_gen("g0001", [{"span": "workload", "rc": 1,
                           "key": "k", "status": "regression"}])
    out = {}
    P.alerts._autopilot_signals(out, j)
    assert out["autopilot:gate-regression"] == 1.0
    assert out["autopilot:gate-rc2-streak"] == 0.0
    assert out["autopilot:quarantined-active"] == 0.0
    j.quarantine("k", gen="g0001", span="workload")
    j.open_gen("g0002", runs=3)
    j.close_gen("g0002", [{"span": "workload", "rc": 2}])
    again = {}
    P.alerts._autopilot_signals(again, j)
    return out, again


def test_autopilot_gate_signals(tmp_path, clock):
    _, again = both(tmp_path, _gate_signals, clock)
    assert again["autopilot:quarantined-active"] == 1.0


TWIN_SPEC = {"name": "twin", "workloads": ["bank"], "seeds": [0],
             "opts": {"time-limit": 0.2}}
TWIN_KEY = "bank|nofault|s0"


def _quarantined_ap(P, base, digest):
    ap = P.AP.Autopilot(TWIN_SPEC, os.path.join(base, "store"),
                        generations=1, poll_s=0.02)
    ap.journal.open_gen("g0000", runs=1)
    ap.journal.close_gen("g0000", [])
    ap.journal.quarantine(TWIN_KEY, gen="g0000", span="workload")
    outcome = {"run": "r0"}
    if digest is not None:
        outcome["digest"] = digest
    ap.journal.shrink(TWIN_KEY, gen="g0000", outcome=outcome)
    return ap


def _witnessed_run(P, ap, base, history):
    run_dir = os.path.join(base, "store", "runs", "r0")
    digest = P.wit.history_digest(history)[:16]
    P.wit.save_witness(run_dir, history, {"target": "any"})
    with ap.coordinator._lock:
        ap.coordinator.idx.append(
            {"run": "r0", "key": TWIN_KEY, "dir": "runs/r0",
             "witness": {"digest": digest, "ops": len(history)}})
    return digest


def _twin(seed, inject, digest=None, witness=True):
    def scenario(P, base):
        ap = _quarantined_ap(P, base, digest)
        try:
            if witness:
                h = P.synth.la_history(n_txns=15, n_keys=3, concurrency=3,
                                       seed=seed)
                if inject:
                    assert P.synth.inject_wr_cycle(h)
                d = _witnessed_run(P, ap, base, h)
                ap.journal.shrink(TWIN_KEY, gen="g0000",
                                  outcome={"digest": d})
            first = ap._witness_twin_check(TWIN_KEY)
            assert ap._witness_twin_check(TWIN_KEY) == first  # cached
            allowed, twin = first
            if twin and "checker" in twin:
                # the JAX module names the twin by `str` of its bound
                # `name` method: the package and the address differ
                twin = dict(twin, checker=re.sub(
                    r"jepsen_tpu(_torch)?\.| at 0x[0-9a-f]+", "",
                    twin["checker"]))
            return allowed, twin
        finally:
            ap.close()

    return scenario


def test_twin_pass_allows_parole_on_valid_witness(tmp_path):
    allowed, twin = both(tmp_path, _twin(1, inject=False))
    assert allowed is True and twin["valid?"] is True


def test_twin_fail_denies_parole_on_real_anomaly(tmp_path):
    allowed, twin = both(tmp_path, _twin(2, inject=True))
    assert allowed is False and twin["valid?"] is False


def test_twin_missing_witness_denies_conservatively(tmp_path):
    allowed, twin = both(tmp_path, _twin(0, False, digest="feedbeefcafe0000",
                                         witness=False))
    assert allowed is False and "error" in twin


def test_no_witness_digest_keeps_plain_criterion(tmp_path):
    assert both(tmp_path, _twin(0, False, witness=False)) == (True, None)


# -------------------------------------------------------- satellites

def _obs_gc(P, base):
    base = os.path.join(base, "store")
    now = 1_700_000_000.0

    def mk(name, age_s, landed):
        d = os.path.join(base, name, P.store.timestamp(now - age_s))
        os.makedirs(d)
        if landed:
            with open(os.path.join(d, "results.json"), "w") as f:
                f.write("{}")
        return d

    old = mk("t", 5000, landed=True)
    fresh = mk("t", 10, landed=True)
    crashed = mk("u", 5000, landed=False)
    stats = P.store.gc_runs(base, retention_s=3600, now=now)
    assert stats == {"archived": 1, "kept": 1, "skipped": 1}
    assert not os.path.exists(old) and os.path.exists(crashed)
    live = P.store.tests(base=base)
    assert fresh in live and old not in live
    again = P.store.gc_runs(base, retention_s=3600, now=now)
    return stats, again, [os.path.relpath(d, base) for d in live]


def test_obs_gc_archives_landed_runs_only(tmp_path):
    both(tmp_path, _obs_gc)


def test_host_info_series_pinned_to_alive_versioned_workers():
    class Fleet:
        name = "f"

        def federated_metrics(self):
            return {"w2": {"version": "v2", "rows": []},
                    "w1": {"version": "v1", "rows": []},
                    "old": {"rows": []}}

    lines = tprom.render_fleet(Fleet())
    assert lines == jprom.render_fleet(Fleet())
    info = [ln for ln in lines if "jepsen_fleet_host_info" in ln
            and not ln.startswith("#")]
    assert info == [
        'jepsen_fleet_host_info{host="w1",version="v1"} 1',
        'jepsen_fleet_host_info{host="w2",version="v2"} 1']


def test_spawned_worker_command_is_the_ports(tmp_path, monkeypatch):
    """`_spawn_worker` starts ``python -m jepsen_tpu_torch ... fleet
    work`` with this process's environment (and the target version);
    the JAX one names its own package."""
    import subprocess

    seen = []

    class Proc:
        pid = 4242

        def poll(self):
            return None

    def popen(cmd, env=None, **kw):
        seen.append((cmd, env))
        return Proc()

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setenv("JT_SPAWN_MARK", "yes")
    for P in (tap, jap):
        ap = P.Autopilot(SPEC, str(tmp_path / P.__name__), poll_s=0.02,
                         coordinator_url="http://127.0.0.1:1",
                         worker_version="v7", worker_extra=("--cpu",))
        try:
            assert ap._spawn_worker() == f"ap-{os.getpid()}-1"
            assert ap.status_doc()["workers"][f"ap-{os.getpid()}-1"][
                "pid"] == 4242
        finally:
            ap.workers.clear()
            ap.close()
    (cmd_t, env_t), (cmd_j, env_j) = seen
    assert cmd_t[2] == "jepsen_tpu_torch" and cmd_j[2] == "jepsen_tpu"
    assert cmd_t[5:] == cmd_j[5:] and cmd_t[-1] == "--cpu"
    assert cmd_t[5:7] == ["fleet", "work"]
    assert env_t["JT_SPAWN_MARK"] == "yes"
    assert env_t["JEPSEN_WORKER_VERSION"] == "v7"
