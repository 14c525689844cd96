"""Port parity for the campaign layer: `jepsen_tpu_torch/campaign/`,
`telemetry/forensics.py` and `telemetry/gate.py` against the JAX
package's on the CPU.

The spec is the JAX package's `tests/test_campaign.py`.  `expand` of
both shipped specs and of `docs/CAMPAIGN.md`'s example gives equal run
ids, keys, device flags and cell opts in both packages, and the port's
``--cpu`` (set after `expand`) changes no run id; `load_spec` raises on
the same bad specs; the `Index` queries of one ledger are equal, the
torn-line heal included; the port's `Scheduler` serialises device runs,
keeps host runs flowing, and records crashes and retries as the JAX one
does; and the subprocess executor's deadline ends the runner's whole
process group, the daemons it started included.  The models-matrix
campaign through both CLIs, forensics and the gate are in
`test_torch_campaign_matrix.py` (a file of its own, so that `--dist
loadfile` spreads the two).
"""

import json
import os
import threading
import time
import uuid

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from jepsen_tpu.campaign import plan as jplan  # noqa: E402
from jepsen_tpu.campaign import scheduler as jsched  # noqa: E402
from jepsen_tpu.campaign.index import Index as JIndex  # noqa: E402
from jepsen_tpu_torch import campaign as tcamp  # noqa: E402
from jepsen_tpu_torch.campaign import plan as tplan  # noqa: E402
from jepsen_tpu_torch.campaign import scheduler as tsched  # noqa: E402
from jepsen_tpu_torch.campaign.index import Index as TIndex  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(REPO, "specs")


def _docs_example() -> dict:
    """The spec in `docs/CAMPAIGN.md`'s "Spec format" section."""
    with open(os.path.join(REPO, "docs", "CAMPAIGN.md")) as f:
        text = f.read()
    start = text.index("```json\n") + len("```json\n")
    return json.loads(text[start:text.index("```", start)])


SPEC_CASES = {
    "production-traffic": lambda: os.path.join(SPECS,
                                               "production-traffic.json"),
    "models-matrix": lambda: os.path.join(SPECS, "models-matrix.json"),
    "docs example": _docs_example,
    "test_campaign SPEC": lambda: {
        "name": "t", "workloads": ["noop", "set"],
        "faults": [None, {"seed": 3, "p": 0.5, "kinds": "oom|xla"}],
        "seeds": [0, 1, 2], "opts": {"time-limit": 0.2, "concurrency": 2}},
}


def _cells(specs):
    return [(r.run_id, r.key, r.device, r.workload, r.seed, r.fault,
             r.fault_label, r.workload_label, r.opts) for r in specs]


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_expand_equal(case):
    spec = SPEC_CASES[case]()
    assert _cells(tplan.expand(spec)) == _cells(jplan.expand(spec))
    assert tplan.spec_digest(spec) == jplan.spec_digest(spec)
    assert tplan.load_spec(spec) == jplan.load_spec(spec)
    loaded = jplan.load_spec(spec)
    if loaded.get("nemesis-schedule"):
        for g in loaded["seeds"]:
            assert tplan.schedule_windows(spec, g) == \
                jplan.schedule_windows(spec, g)


@pytest.mark.parametrize("cpu", [False, True])
@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_cpu_choice_keeps_run_ids(case, cpu, tmp_path, monkeypatch):
    """`run_campaign(cpu=...)` schedules the JAX package's run ids; the
    CPU choice rides in the cells' opts."""
    spec = SPEC_CASES[case]()
    seen = []

    def capture(self, specs, execute, on_result=None):
        seen.extend(specs)
        return []

    monkeypatch.setattr(tsched.Scheduler, "run", capture)
    tcamp.run_campaign(spec, str(tmp_path), cpu=cpu)
    want = jplan.expand(spec)
    assert [r.run_id for r in seen] == [r.run_id for r in want]
    assert [r.key for r in seen] == [r.key for r in want]
    assert [r.device for r in seen] == [r.device for r in want]
    assert all(bool(r.opts.get("cpu")) is cpu for r in seen)
    t = tplan.build_test(seen[0], str(tmp_path))
    assert bool(t.get("cpu")) is cpu


BAD_SPECS = {
    "no workloads": {"name": "x"},
    "nameless workload": {"workloads": [{"opts": {}}]},
    "unknown fault kind": {"workloads": ["noop"],
                           "faults": [{"kinds": "frobnicate"}]},
    "not a dict": ["noop"],
    "bad schedule": {"workloads": ["noop"],
                     "nemesis-schedule": {"faults": ["nope"]}},
    "negative duration": {"workloads": ["noop"], "nemesis-schedule": {
        "faults": ["skew"], "duration": -1}},
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_load_spec_errors_equal(case):
    spec = BAD_SPECS[case]
    with pytest.raises(ValueError) as je:
        jplan.load_spec(spec)
    with pytest.raises(ValueError) as te:
        tplan.load_spec(spec)
    assert str(te.value) == str(je.value)


def test_unknown_workload_lists_the_same_names():
    spec = {"name": "u", "workloads": ["frobnicate"]}
    with pytest.raises(ValueError) as je:
        jplan.expand(spec)
    with pytest.raises(ValueError) as te:
        tplan.expand(spec)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------- index

def _ledger(path):
    """One ledger with flips both ways, witness drift, spans, phases and
    counters over three generations."""
    recs = []
    for gen, (v1, v2, dur) in (("g1", (True, "unknown", 1.0)),
                               ("g2", (False, True, 2.0)),
                               ("g3", (False, True, 4.0))):
        recs.append({"run": "r1", "key": "append|nofault|s2", "valid?": v1,
                     "gen": gen, "dir": f"d-{gen}-1",
                     "spans": {"check:list-append": dur, "run": dur * 2},
                     "phases": {"check:list-append": {
                         "execute_s": dur / 2, "compile_s": dur / 4}},
                     "counters": {"resilience-retries": dur},
                     "witness": ({"ops": int(dur * 3), "digest": gen,
                                  "anomaly-types": ["G1c", gen]}
                                 if v1 is False else None)})
        recs.append({"run": "r2", "key": "append|nofault|s3", "valid?": v2,
                     "gen": gen, "dir": f"d-{gen}-2", "degraded":
                     "host-fallback" if gen == "g2" else None,
                     "deadline": gen == "g3",
                     "spans": {"check:list-append": dur * 1.5}})
    idx = TIndex(path)
    for r in recs:
        idx.append(r)
    return recs


def test_index_queries_equal(tmp_path):
    p = str(tmp_path / "c.jsonl")
    _ledger(p)
    j, t = JIndex(p, use_warehouse=False), TIndex(p)
    for q in ("flips", "regressions", "witness_diffs", "span_stats",
              "forensic_records", "latest_by_run", "verdict_counts",
              "completed_ids", "by_key"):
        assert getattr(t, q)() == getattr(j, q)(), q
    for span in ("check:list-append", "run", "absent"):
        assert t.span_samples(span) == j.span_samples(span)
        assert t.span_trend(span) == j.span_trend(span)
    assert t.latest("r2") == j.latest("r2")
    assert t.verdict_counts(runs=["r1"]) == j.verdict_counts(runs=["r1"])


def test_index_torn_line_heals(tmp_path):
    p = str(tmp_path / "c.jsonl")
    idx = TIndex(p)
    idx.append({"run": "a", "key": "k", "valid?": True})
    idx.append({"run": "b", "key": "k2", "valid?": False})
    with open(p, "ab") as f:
        f.write(b'{"run": "c", "valid?"')
    size_torn = os.path.getsize(p)
    idx2 = TIndex(p)
    assert idx2.completed_ids() == {"a", "b"} == \
        JIndex(p, use_warehouse=False).completed_ids()
    assert os.path.getsize(p) == size_torn  # a read never truncates
    idx2.append({"run": "c", "key": "k3", "valid?": True})
    assert TIndex(p).completed_ids() == {"a", "b", "c"} == \
        JIndex(p, use_warehouse=False).completed_ids()
    # a clean load never arms the heal: a concurrent append survives
    idx3 = TIndex(p)
    assert idx3.records and idx3._good_bytes is None
    idx.append({"run": "d", "key": "k4", "valid?": True})
    idx3.append({"run": "e", "key": "k5", "valid?": True})
    assert TIndex(p).completed_ids() == {"a", "b", "c", "d", "e"}


# ------------------------------------------------------------ scheduler

def _rs(i, device=False, **opts):
    return tplan.RunSpec(run_id=f"r{i}", campaign="c", workload="w",
                         seed=i, workload_label="w", device=device,
                         opts=opts)


@pytest.mark.parametrize("telemetric", [False, True])
def test_device_and_telemetric_runs_serialised(telemetric):
    active, worst, lk = [], [], threading.Lock()

    def execute(rs):
        with lk:
            active.append(rs.run_id)
            worst.append(len(active))
        time.sleep(0.03)
        with lk:
            active.remove(rs.run_id)
        return {"run": rs.run_id, "key": rs.key, "valid?": True}

    specs = [_rs(i, device=not telemetric, telemetry=telemetric)
             for i in range(4)]
    recs = tsched.Scheduler(3).run(specs, execute)
    assert len(recs) == 4 and max(worst) == 1
    if not telemetric:
        assert {r["device-slot"] for r in recs} == {0}


def test_device_slots_serialize():
    slots = tsched.DeviceSlots(1)
    active, worst = [], []

    def job():
        s = slots.acquire()
        active.append(s)
        worst.append(len(active))
        time.sleep(0.02)
        active.remove(s)
        slots.release(s)

    ts = [threading.Thread(target=job) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in ts)
    assert max(worst) == 1
    two = tsched.DeviceSlots(2)
    assert [two.try_acquire(), two.try_acquire(), two.try_acquire()] == \
        [0, 1, None]


def test_host_runs_not_starved_by_device_queue():
    release = threading.Event()
    done_at = {}

    def execute(rs):
        if rs.device:
            release.wait(5)
        done_at[rs.run_id] = time.monotonic()
        return {"run": rs.run_id, "key": rs.key, "valid?": True}

    specs = [_rs(0, True), _rs(1, True), _rs(2), _rs(3)]
    sched = tsched.Scheduler(2, device_slots=1)
    t = threading.Thread(target=lambda: sched.run(specs, execute))
    t.start()
    t_end = time.monotonic() + 3
    while time.monotonic() < t_end and not {"r2", "r3"} <= set(done_at):
        time.sleep(0.01)
    assert {"r2", "r3"} <= set(done_at), done_at
    assert "r0" not in done_at and "r1" not in done_at
    release.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert set(done_at) == {"r0", "r1", "r2", "r3"}


def _drop(rec, *keys):
    return {k: v for k, v in rec.items() if k not in keys}


def test_crash_and_retry_records_equal():
    rs_t = tplan.expand({"name": "c", "workloads": ["noop"],
                         "seeds": [0]})[0]
    rs_j = jplan.expand({"name": "c", "workloads": ["noop"],
                         "seeds": [0]})[0]
    assert tsched.crash_record(rs_t, "e", 2, 1.5) == \
        jsched.crash_record(rs_j, "e", 2, 1.5)

    def boom(_):
        raise RuntimeError("kaboom")

    rt = tsched.Scheduler(1).run([rs_t], boom)[0]
    rj = jsched.Scheduler(1).run([rs_j], boom)[0]
    assert rt["valid?"] == "unknown" and "kaboom" in rt["error"]
    assert rt["attempt"] == rj["attempt"] == 2
    assert _drop(rt, "error", "wall_s") == _drop(rj, "error", "wall_s")
    calls = []

    def flaky(r):
        calls.append(1)
        if len(calls) % 2:
            raise RuntimeError("transient")
        return {"run": r.run_id, "key": r.key, "valid?": True}

    rt = tsched.Scheduler(1).run([rs_t], flaky)[0]
    rj = jsched.Scheduler(1).run([rs_j], flaky)[0]
    assert rt == rj and rt["attempt"] == 2


def test_crashing_builder_indexed_unknown(tmp_path):
    def bad_builder(opts):
        raise RuntimeError("builder exploded")

    tplan.register_workload("exploder", bad_builder)
    try:
        s = tcamp.run_campaign({"name": "x", "workloads": ["exploder"],
                                "seeds": [0]}, str(tmp_path), workers=1)
    finally:
        tplan._EXTRA_WORKLOADS.pop("exploder", None)
    assert s["counts"]["unknown"] == 1
    rec = TIndex(s["index"]).records[0]
    assert "builder exploded" in rec["error"] and rec["attempt"] == 2


def test_registered_hands_over_importable_builders():
    tplan.register_workload("regd-block-t", cs.regd_block_test)
    tplan.register_workload("lambda-t", lambda o: o, device=True)
    try:
        entries = {e["name"]: e for e in tplan.registered()}
        assert entries["regd-block-t"] == {
            "name": "regd-block-t",
            "builder": "chip_smoke:regd_block_test", "device": False}
        assert "lambda-t" not in entries
        tplan._EXTRA_WORKLOADS.pop("regd-block-t")
        tplan.register_imported([entries["regd-block-t"]])
        assert tplan._EXTRA_WORKLOADS["regd-block-t"] is \
            cs.regd_block_test
    finally:
        for n in ("regd-block-t", "lambda-t"):
            tplan._EXTRA_WORKLOADS.pop(n, None)


# -------------------------------------------- subprocess deadline kill

def test_subprocess_deadline_kills_the_runners_group(tmp_path, monkeypatch):
    """A cell that blocks past the run deadline (three regd daemons
    under an unbounded workload) is indexed as run-deadline-exceeded,
    and nothing of its process group, its daemons included, is left;
    the valid device cell beside it runs in a runner of its own."""
    tag = f"test-campaign-{uuid.uuid4().hex}"
    monkeypatch.setenv(cs.TAG_VAR, tag)
    monkeypatch.chdir(REPO)  # the runner imports chip_smoke by name
    tplan.register_workload("regd-block", cs.regd_block_test)
    spec = {"name": "sub", "seeds": [0],
            "workloads": ["regd-block",
                          {"name": "append", "label": "append", "opts": {
                              "ops": 60, "time-limit": None}}],
            "opts": {"concurrency": 2}}
    try:
        t0 = time.monotonic()
        s = tcamp.run_campaign(spec, str(tmp_path), workers=2,
                               executor="subprocess", run_deadline_s=12,
                               cpu=True)
        took = time.monotonic() - t0
    finally:
        tplan._EXTRA_WORKLOADS.pop("regd-block", None)
    recs = {r["workload"]: r for r in TIndex(s["index"]).records}
    block = recs["regd-block"]
    assert block["valid?"] == "unknown" and block["deadline"] is True
    assert "run-deadline-exceeded" in block["error"]
    ok = recs["append"]
    assert ok["valid?"] is True and ok["device-slot"] == 0, ok
    assert took < 12 + tsched.TERM_GRACE_S + 10, took
    t_end = time.monotonic() + 5
    while cs.marked_pids(tag) and time.monotonic() < t_end:
        time.sleep(0.05)
    assert cs.marked_pids(tag) == [], \
        [cs._cmdline(p) for p in cs.marked_pids(tag)]


# ------------------------------------------------ no card, no --cpu

def test_no_card_campaign_and_shrink_exit_naming_it(tmp_path, capsys):
    """Without a card and without ``--cpu`` a device cell is indexed as
    an unknown naming `NoDeviceError`, `campaign run` exits 1 naming it,
    and `shrink` of the stored run exits 1 naming it; with ``--cpu`` the
    same commands check on the CPU."""
    from jepsen_tpu_torch import __main__ as tmain
    from jepsen_tpu_torch import cli as tcli
    from jepsen_tpu_torch import store as tstore
    from jepsen_tpu_torch.minimize.probe import device_error

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    spec = str(tmp_path / "nc.json")
    with open(spec, "w") as f:
        json.dump({"name": "nc", "seeds": [0], "opts": {"concurrency": 2},
                   "workloads": [{"name": "append", "label": "append",
                                  "opts": {"ops": 40, "time-limit": None}},
                                 "noop"]}, f)
    base = str(tmp_path / "s")
    argv = ["--store-dir", base, "campaign", "run", spec]
    assert tcli.run(tmain.suite(), argv) == 1
    assert "NoDeviceError" in capsys.readouterr().err
    recs = {r["workload"]: r for r in TIndex(
        os.path.join(base, "campaigns", "nc.jsonl")).records}
    assert recs["append"]["valid?"] == "unknown"
    assert "NoDeviceError" in device_error(recs["append"])
    assert recs["noop"]["valid?"] is True
    d = tstore.latest(tstore.load(os.path.join(
        base, recs["append"]["dir"]))["name"], base=base)
    assert tcli.run(tmain.suite(), ["shrink", d]) == 1
    assert "NoDeviceError" in capsys.readouterr().err
    base2 = str(tmp_path / "s2")
    assert tcli.run(tmain.suite(), ["--cpu"] + argv[:1] + [base2]
                    + argv[2:]) == 0
