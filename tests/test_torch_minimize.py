"""Port parity for the shrinker: `jepsen_tpu_torch/minimize/` against
`jepsen_tpu/minimize/` on the CPU.

The spec is the JAX package's `tests/test_minimize.py` and the
fault-window tests of `tests/test_invariants.py`: the same seeded
histories go through both packages.  Units, re-closed candidates, key
projections, fault windows and history digests are equal field for
field; the golden G1c witness (`tests/data/witness-g1c-golden.json`)
comes out of the JAX host oracle's shrink and out of the port's shrink
through `list_append.check` on the CPU with the same digest and ops;
shrinks of the same stored run give equal witness digests, fault
windows, anomaly sets and telemetry round spans (by name and count) in
both.  Port-only rules: a resolved checker is the port's class and
carries the run's device, and a probe whose error names `KernelError`
or `NoDeviceError` makes the port's `shrink` raise (a synthetic
`FaultInjected` keeps the JAX behaviour: the candidate does not
reproduce).
"""

import collections
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import minimize as jmin  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.checkers.api import FnChecker as JFnChecker  # noqa: E402
from jepsen_tpu.checkers.elle import oracle as joracle  # noqa: E402
from jepsen_tpu.history.ops import INFO, INVOKE, OK  # noqa: E402
from jepsen_tpu.history.ops import History as JHistory  # noqa: E402
from jepsen_tpu.history.ops import Op as JOp  # noqa: E402
from jepsen_tpu.minimize import probe as jprobe  # noqa: E402
from jepsen_tpu.minimize import reduce as jreduce  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import minimize as tmin  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.backend import NoDeviceError  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.history import history as thistory  # noqa: E402
from jepsen_tpu_torch.minimize import probe as tprobe  # noqa: E402
from jepsen_tpu_torch.minimize import reduce as treduce  # noqa: E402
from jepsen_tpu_torch.ops.kernels import KernelError  # noqa: E402
from jepsen_tpu_torch.resilience import FaultInjected  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "witness-g1c-golden.json")


def to_port(h):
    """A JAX history's ops, field for field, as a port history."""
    return thistory([dataclasses.asdict(o) for o in h], reindex=False)


def dicts(ops):
    return [o.to_dict() for o in ops]


def g1c_history(n_txns=250, seed=11):
    """`tests/test_minimize.py`'s corpus: a strict-serializable sim with
    an injected wr cycle."""
    h = jsynth.la_history(n_txns=n_txns, n_keys=6, concurrency=5,
                          seed=seed)
    assert jsynth.inject_wr_cycle(h)
    return h


def save_run(base, h, name="inv"):
    """Store `h` with its (invalid) oracle results through the JAX
    store (the port reads the same files); returns the run dir."""
    test = jcore.noop_test(name=name)
    test["store-dir"] = str(base)
    test["history"] = h
    jstore.save_0(test)
    test["results"] = joracle.check(h, ["serializable"])
    jstore.save_1(test)
    return jstore.test_dir(test)


def shrink_both(tmp_path, h, jkw, tkw, name="inv"):
    """Shrink the same stored history in both packages (two copies of
    the run, so neither sees the other's witness)."""
    dj = save_run(tmp_path / "j", h, name)
    dt = save_run(tmp_path / "t", h, name)
    return jmin.shrink(dj, **jkw), tmin.shrink(dt, **tkw), dj, dt


# ---------------------------------------------------------------- units

@pytest.mark.parametrize("seed", [3, 4, 5, 11])
def test_units_and_build_history_equal(seed):
    h = g1c_history(n_txns=40, seed=seed)
    ju, tu = jreduce.units_of(h), treduce.units_of(to_port(h))
    assert [(u.order, dicts(u.ops)) for u in ju] == \
        [(u.order, dicts(u.ops)) for u in tu]
    for lo, hi in ((0, 7), (3, 11), (5, len(ju)), (0, len(ju))):
        assert dicts(jreduce.build_history(ju[lo:hi])) == \
            dicts(treduce.build_history(tu[lo:hi]))


@pytest.mark.parametrize("seed", [3, 5, 7])
def test_drop_key_equal(seed):
    h = g1c_history(n_txns=40, seed=seed)
    ju, tu = jreduce.units_of(h), treduce.units_of(to_port(h))
    keys = sorted({k for u in ju for k in jreduce.unit_keys(u)})
    assert keys == sorted({k for u in tu for k in treduce.unit_keys(u)})
    for k in keys:
        jd, td = jreduce.drop_key(ju, k), treduce.drop_key(tu, k)
        assert [(u.order, dicts(u.ops)) for u in jd] == \
            [(u.order, dicts(u.ops)) for u in td]


def _nem(f):
    return [JOp(type=INVOKE, process="nemesis", f=f, value=None),
            JOp(type=INFO, process="nemesis", f=f, value=None)]


def _windowed_bank_history():
    """`tests/test_invariants.py`'s: three skew windows, the bad read
    inside the second."""
    ops = []

    def read(p, v):
        ops.append(JOp(type=INVOKE, process=p, f="read", value=None))
        ops.append(JOp(type=OK, process=p, f="read", value=dict(v)))

    good = {0: 10, 1: 10}
    ops += _nem("start-skew") + _nem("stop-skew")
    read(0, good)
    ops += _nem("start-skew")
    read(1, {0: 10, 1: 7})
    ops += _nem("stop-skew")
    read(0, good)
    ops += _nem("start-skew") + _nem("stop-skew")
    read(2, good)
    return JHistory(ops)


WINDOW_CORPORA = {
    "three skew windows": _windowed_bank_history,
    "one-shot faults": lambda: JHistory(
        _nem("leave-node") + _nem("join-node") + _nem("start-skew")
        + _nem("bump-clock") + _nem("stop-skew") + _nem("leave-node")),
    "interleaved packages": lambda: JHistory(
        _nem("start-skew") + _nem("start-partition") + _nem("stop-skew")
        + _nem("stop-partition")),
    "bare stop": lambda: JHistory(_nem("start-skew") + _nem("fast")),
    "cross-host stamped": lambda: jsynth.cross_host_window_history(
        "hostA", "hostB"),
    "stamped and unstamped": lambda: JHistory(
        list(jsynth.cross_host_window_history("hostA", "hostB"))
        + _nem("bump-clock")),
}


@pytest.mark.parametrize("corpus", sorted(WINDOW_CORPORA))
def test_fault_windows_equal(corpus):
    h = WINDOW_CORPORA[corpus]()
    jn = [u for u in jreduce.units_of(h) if jreduce.is_nemesis_unit(u)]
    tn = [u for u in treduce.units_of(to_port(h))
          if treduce.is_nemesis_unit(u)]
    jw, tw = jreduce.fault_windows(jn), treduce.fault_windows(tn)
    assert jw == tw and jw
    kept = ["necessary", "overlap", "interaction"] * len(jw)
    assert jreduce.window_descriptors(jn, jw, kept[:len(jw)]) == \
        treduce.window_descriptors(tn, tw, kept[:len(tw)])


@pytest.mark.parametrize("corpus", ["g1c-11", "g1c-3", "windows",
                                    "cross-host"])
def test_history_digest_equal(corpus):
    h = {"g1c-11": lambda: g1c_history(),
         "g1c-3": lambda: g1c_history(n_txns=30, seed=3),
         "windows": _windowed_bank_history,
         "cross-host": lambda: jsynth.cross_host_window_history()}[corpus]()
    assert jmin.history_digest(h) == tmin.history_digest(to_port(h))
    assert jmin.history_digest(h, 32) == tmin.history_digest(to_port(h), 32)


def test_witness_files_cross_load(tmp_path):
    """A witness saved by either package loads in the other with the
    same digest and ops."""
    h = g1c_history(n_txns=30, seed=3)
    meta = {"source-digest": "s", "valid?": False, "anomaly-types": ["G1c"]}
    jmin.save_witness(str(tmp_path / "j"), h, meta)
    tmin.save_witness(str(tmp_path / "t"), to_port(h), meta)
    for d in ("j", "t"):
        jw = jmin.load_witness(str(tmp_path / d))
        tw = tmin.load_witness(str(tmp_path / d))
        assert jw["digest"] == tw["digest"] == jmin.history_digest(h)
        assert dicts(jw["history"]) == dicts(tw["history"])
    assert open(tmp_path / "j" / "witness.json").read() == \
        open(tmp_path / "t" / "witness.json").read()


# ---------------------------------------------------------------- golden

def test_golden_g1c_witness_in_both(tmp_path):
    """The JAX host oracle's shrink and the port's shrink through
    `list_append.check` on the CPU (no host oracle) give the golden
    witness."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    h = g1c_history(n_txns=golden["generator"]["n_txns"],
                    seed=golden["generator"]["seed"])
    sj, st, _, _ = shrink_both(
        tmp_path, h, dict(host_oracle=True, anomalies="G1c"),
        dict(anomalies="G1c", device="cpu"))
    assert st["probe-checker"] == "list-append"
    assert sj["probe-checker"] == "list-append-host"
    for s in (sj, st):
        assert s["digest"] == golden["digest"]
        assert [[op.type, op.process, op.f, op.value]
                for op in s["witness-history"]] == golden["ops"]
        assert "G1c" in s["anomaly-types"] and s["valid?"] is False
    assert sj["source-digest"] == st["source-digest"]
    # the confirm ran the device pipeline in both: explained edges
    cyc = st["anomalies"]["G1c"][0]["cycle"]
    assert all(e.get("why") for e in cyc)
    assert st["anomalies"] == sj["anomalies"]


@pytest.mark.parametrize("seed", [7, 9])
def test_host_oracle_shrinks_equal(tmp_path, seed):
    h = g1c_history(n_txns=60, seed=seed)
    kw = dict(host_oracle=True, workers=3)
    sj, st, _, _ = shrink_both(tmp_path, h, kw, dict(kw, device="cpu"))
    for k in ("digest", "ops", "source-ops", "anomaly-types", "rounds",
              "probes", "phases", "target", "checker", "probe-checker",
              "fault-windows"):
        assert sj[k] == st[k], k


def test_cached_reshrink_and_anomaly_pin(tmp_path):
    h = g1c_history(n_txns=40, seed=26)
    dj = save_run(tmp_path / "j", h)
    dt = save_run(tmp_path / "t", h)
    base = set(joracle.check(h, ["serializable"])["anomaly-types"])
    other = sorted(base - {"G1c"})[0]
    seq = [("G1c", False), ([other], False), ([other], True)]
    for pin, cached in seq:
        sj = jmin.shrink(dj, host_oracle=True, anomalies=pin)
        st = tmin.shrink(dt, host_oracle=True, anomalies=pin, device="cpu")
        assert st["cached"] is sj["cached"] is cached
        assert st["digest"] == sj["digest"]
        assert st["anomaly-types"] == sj["anomaly-types"]
        if cached:
            assert st["probes"] == 0
    # the port's witness files are a cache hit for the JAX shrink too
    assert jmin.shrink(dt, host_oracle=True, anomalies=[other])["cached"]


def rw_g1c_history():
    """`tests/test_minimize.py`'s: a pure wr-edge cycle (G1c) between
    two rw-register txns, plus droppable filler."""
    ops = []

    def txn(p, inv, ok):
        ops.extend([JOp(type=INVOKE, process=p, f="txn", value=inv),
                    JOp(type=OK, process=p, f="txn", value=ok)])

    for i, p in enumerate((2, 3, 4)):
        v = 500 + i
        txn(p, [["w", 2 + (i % 2), v]], [["w", 2 + (i % 2), v]])
    txn(0, [["w", 0, 100], ["r", 1, None]], [["w", 0, 100], ["r", 1, 200]])
    txn(1, [["w", 1, 200], ["r", 0, None]], [["w", 1, 200], ["r", 0, 100]])
    return JHistory(ops)


def test_rw_host_twin_and_shrink(tmp_path):
    from jepsen_tpu.workloads.wr import WrChecker as JWr
    from jepsen_tpu_torch.workloads.wr import WrChecker as TWr

    tw = tprobe.host_equivalent(TWr(device="cpu"))
    jw = jprobe.host_equivalent(JWr())
    assert tw.name() == jw.name() == "rw-register-host"
    for h in (jsynth.rw_history(n_txns=30, seed=2), rw_g1c_history()):
        rj = jw.check({}, h, {})
        rt = tw.check({}, to_port(h), {})
        dev = TWr(device="cpu").check({}, to_port(h), {})
        assert rt["valid?"] == rj["valid?"] == dev["valid?"]
        assert sorted(rt.get("anomaly-types") or []) == \
            sorted(rj.get("anomaly-types") or []) == \
            sorted(dev.get("anomaly-types") or [])
    h = rw_g1c_history()
    sj = jmin.shrink({"name": "rw", "store-dir": str(tmp_path / "j"),
                      "history": h}, checker=JWr(), host_oracle=True)
    st = tmin.shrink({"name": "rw", "store-dir": str(tmp_path / "t"),
                      "history": to_port(h)},
                     checker=TWr(device="cpu"), host_oracle=True)
    assert st["ops"] == sj["ops"] == 4
    assert st["digest"] == sj["digest"]
    assert st["checker"] == "rw-register"
    assert st["probe-checker"] == "rw-register-host"


@pytest.mark.parametrize("workers", [1, 3])
def test_bank_under_skew_fault_window_witness(tmp_path, workers):
    from jepsen_tpu.workloads.bank import BankChecker as JBank
    from jepsen_tpu_torch.workloads.bank import BankChecker as TBank

    h = _windowed_bank_history()

    def test(d, hist, chk):
        return {"name": "win", "store-dir": str(tmp_path / d),
                "history": hist, "checker": chk, "total-amount": 20,
                "workload-kind": "bank"}

    sj = jmin.shrink(test("j", h, JBank()), workers=workers, force=True)
    st = tmin.shrink(test("t", to_port(h), TBank(device="cpu")),
                     workers=workers, force=True)
    assert st["valid?"] is False
    assert st["fault-windows"] == sj["fault-windows"]
    assert len(st["fault-windows"]) == 1
    assert st["digest"] == sj["digest"]
    assert dicts(st["witness-history"]) == dicts(sj["witness-history"])


def test_cross_host_necessary_window(tmp_path):
    h = jsynth.cross_host_window_history()
    fn = jsynth.cross_host_sensitive_check("hostA")
    sj = jmin.shrink({"name": "x", "store-dir": str(tmp_path / "j"),
                      "history": h},
                     checker=JFnChecker(fn, "x-host"),
                     workers=1, force=True)
    st = tmin.shrink({"name": "x", "store-dir": str(tmp_path / "t"),
                      "history": to_port(h)},
                     checker=tapi.FnChecker(fn, "x-host"), workers=3,
                     force=True)
    assert st["fault-windows"] == sj["fault-windows"]
    assert [(w["host"], w["kept"]) for w in st["fault-windows"]] == \
        [("hostA", "necessary")]
    assert st["digest"] == sj["digest"]


def _span_names(coll):
    names = collections.Counter()

    def walk(sp):
        names[sp.name] += 1
        for c in sp.children:
            walk(c)

    for r in coll.roots:
        walk(r)
    return names


def test_telemetry_round_spans_equal(tmp_path):
    from jepsen_tpu import telemetry as jtel
    from jepsen_tpu_torch import telemetry as ttel

    h = g1c_history(n_txns=40, seed=19)
    dj = save_run(tmp_path / "j", h)
    dt = save_run(tmp_path / "t", h)
    cj = jtel.activate()
    try:
        jmin.shrink(dj, host_oracle=True)
    finally:
        jtel.deactivate(cj)
    ct = ttel.activate()
    try:
        tmin.shrink(dt, host_oracle=True, device="cpu")
    finally:
        ttel.deactivate(ct)
    nj, nt = _span_names(cj), _span_names(ct)
    shrink_spans = {n for n in nj if n.startswith("shrink")}
    assert {"shrink", "shrink.baseline", "shrink.round",
            "shrink.confirm"} <= shrink_spans
    assert {n: nt[n] for n in shrink_spans} == \
        {n: nj[n] for n in shrink_spans}
    assert nt["shrink.round"] >= 3

    def rounds(coll):
        root = next(r for r in coll.roots if r.name == "shrink")
        out = []

        def walk(sp):
            if sp.name == "shrink.round":
                out.append({k: sp.attrs.get(k) for k in
                            ("phase", "candidates", "ops_remaining",
                             "improved")})
            for c in sp.children:
                walk(c)

        walk(root)
        return out

    assert rounds(ct) == rounds(cj)
    hist = [x for x in ct.registry.snapshot()["histograms"]
            if x["name"] == "shrink-probe-duration-s"]
    assert hist and hist[0]["count"] > 0


# ------------------------------------------------------- resolve_checker

def _txn_op(mops):
    return [JOp(type=INVOKE, process=0, f="txn", value=mops),
            JOp(type=OK, process=0, f="txn", value=mops)]


RESOLVE_CASES = {
    "kind bank": ({"workload-kind": "bank"}, []),
    "kind long-fork": ({"workload-kind": "long-fork"}, []),
    "kind write-skew": ({"workload-kind": "write-skew"}, []),
    "kind session": ({"workload-kind": "session"}, []),
    "kind kafka": ({"workload-kind": "kafka"}, []),
    "kind queue": ({"workload-kind": "queue"}, []),
    "transfer": ({}, [JOp(type=INVOKE, process=0, f="transfer",
                          value={"from": 0, "to": 1, "amount": 1})]),
    "dict read": ({}, [JOp(type=INVOKE, process=0, f="read", value=None),
                       JOp(type=OK, process=0, f="read",
                           value={0: 1, 1: 2})]),
    "send": ({}, [JOp(type=INVOKE, process=0, f="send", value=[0, 1])]),
    "enqueue": ({}, [JOp(type=INVOKE, process=0, f="enqueue", value=1)]),
    "txn append": ({}, _txn_op([["append", 1, 2]])),
    "txn w": ({}, _txn_op([["w", 1, 2]])),
    "txn poll": ({}, _txn_op([["poll", None]])),
    "cas": ({}, [JOp(type=INVOKE, process=0, f="cas", value=[1, 2])]),
    "register read": ({}, [JOp(type=INVOKE, process=0, f="read",
                               value=None)]),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
@pytest.mark.parametrize("cpu", [False, True])
def test_resolve_checker_port_class(case, cpu):
    test, ops = RESOLVE_CASES[case]
    h = JHistory(ops)
    jc = jprobe.resolve_checker(dict(test), h)
    tc = tprobe.resolve_checker(dict(test, cpu=True) if cpu else dict(test),
                                to_port(h))
    assert type(tc).__name__ == type(jc).__name__
    assert type(tc).__module__.startswith("jepsen_tpu_torch."), tc
    assert tc.name() == jc.name()
    assert tprobe.is_device_checker(tc) == jprobe.is_device_checker(jc)
    assert tc.device == ("cpu" if cpu else None)
    # an explicit device wins over the test map
    assert tprobe.resolve_checker(dict(test), to_port(h),
                                  "cpu").device == "cpu"


def test_resolve_checker_unknown_shape_raises():
    with pytest.raises(ValueError, match="cannot infer"):
        tprobe.resolve_checker({}, thistory([]))


# ------------------------------------------------- device errors raise

class _Raising(tapi.Checker):
    """The CPU list-append checker, but every check of fewer than
    `below` ops raises `exc` (the baseline of the full history runs)."""

    def __init__(self, exc, below):
        self.exc, self.below = exc, below

    def name(self):
        return "list-append"

    def check(self, test, history, opts=None):
        if len(history) < self.below:
            raise self.exc("synthetic")
        return tla.check(history, ["serializable"], device="cpu",
                         deadline=(opts or {}).get("deadline"))


@pytest.mark.parametrize("exc", [KernelError, NoDeviceError])
def test_probe_device_error_raises(tmp_path, exc):
    h = g1c_history(n_txns=40, seed=13)
    d = save_run(tmp_path, h)
    with pytest.raises(exc, match="synthetic"):
        tmin.shrink(d, checker=_Raising(exc, len(h)))
    assert tmin.load_witness(d) is None


def test_no_card_baseline_raises(tmp_path):
    """With no card and no CPU asked for, the baseline's `NoDeviceError`
    ends the shrink (the JAX package would answer not-invalid)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    h = g1c_history(n_txns=30, seed=3)
    d = save_run(tmp_path, h)
    with pytest.raises(NoDeviceError):
        tmin.shrink(d)
    s = tmin.shrink(d, device="cpu")
    assert s["valid?"] is False and s["probe-checker"] == "list-append"


def test_fault_injected_probe_keeps_jax_rule(tmp_path):
    """A synthetic `FaultInjected` in every probe counts as "does not
    reproduce": the witness is the whole history, as in JAX."""
    h = g1c_history(n_txns=30, seed=27)
    d = save_run(tmp_path, h)
    s = tmin.shrink(d, checker=_Raising(
        lambda m: FaultInjected("device-lost", "probe", 0, False), len(h)))
    assert s["valid?"] is False and s["ops"] == len(h)


def test_campaign_auto_shrink_reraises_device_error(tmp_path, monkeypatch):
    """The campaign hook re-raises a card that cannot check, so the
    scheduler indexes an unknown naming it."""
    from jepsen_tpu_torch.campaign import core as tcc
    from jepsen_tpu_torch.campaign.plan import RunSpec

    def boom(*a, **kw):
        raise KernelError("synthetic kernel failure")

    monkeypatch.setattr(tmin, "shrink", boom)
    rs = RunSpec(run_id="r", campaign="c", workload="append", seed=0,
                 opts={"shrink": True})
    with pytest.raises(KernelError):
        tcc._auto_shrink(rs, {"history": []}, str(tmp_path))
    monkeypatch.setattr(tmin, "shrink",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            RuntimeError("other")))
    assert tcc._auto_shrink(rs, {"history": []}, str(tmp_path)) == \
        {"error": "RuntimeError: other"}


def test_port_reads_jax_stored_run(tmp_path):
    """`shrink` of a run stored by the JAX package: the port loads it
    through its own store."""
    h = g1c_history(n_txns=30, seed=3)
    d = save_run(tmp_path, h)
    t = tstore.load(d)
    assert tmin.history_digest(t["history"].materialize()) == \
        jmin.history_digest(h)
