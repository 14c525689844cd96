"""Port parity for the rw-register checker
(`jepsen_tpu_torch/checkers/elle/device_rw.py`, `rw_register.py`,
`txn_cycles.cycle_anomalies`, `explain.rw_explainer`, and the rw parts of
`workloads/synth.py`).

Each case builds its input once (numpy or the JAX package's generators)
and runs the JAX function and the port's, on the CPU, on it:

- `infer_rw`: every returned array, bit for bit (dtype and shape too);
- `rw_core_check`: `(bits, overflowed, rw_overflow)`, also with a tiny
  `rw_cap` and `max_k=1` that force `device_rw.check`'s grow loop;
- `device_rw.check` and `rw_register.check`: equal dicts, the latter on
  the host path (`use_device=False`), with the device sweep, and through
  the fused path (`FUSED_MIN_TXNS` lowered in both packages).

The port's fallback rule is pinned too: an error of the device path is
raised, and only a synthetic fault of a `FaultPlan` degrades, with the
JAX package's stamps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.checkers.elle import device_rw as jdrw  # noqa: E402
from jepsen_tpu.checkers.elle import explain as jexplain  # noqa: E402
from jepsen_tpu.checkers.elle import graph as jgraph  # noqa: E402
from jepsen_tpu.checkers.elle import rw_register as jrw  # noqa: E402
from jepsen_tpu.checkers.elle import txn_cycles as jtc  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_rw as tdrw  # noqa: E402
from jepsen_tpu_torch.checkers.elle import explain as texplain  # noqa: E402
from jepsen_tpu_torch.checkers.elle import graph as tgraph  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.checkers.elle import rw_register as trw  # noqa: E402
from jepsen_tpu_torch.checkers.elle import txn_cycles as ttc  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from jepsen_tpu_torch.ops import cycle_sweep, kernels  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402

MODELS = ["strict-serializable"]


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def concurrent(*txns):
    """All txns invoked, then all completed (tests/test_rw_register.py's
    `concurrent_history`)."""
    inv, comp = [], []
    for i, (mops_inv, mops_ok) in enumerate(txns):
        inv.append(jops.invoke(i, "txn", mops_inv))
        if mops_ok == "fail":
            comp.append(jops.fail(i, "txn", mops_inv))
        else:
            comp.append(jops.ok(i, "txn", mops_ok))
    return jops.history(inv + comp)


#: op histories: the six of `test_device_rw_differential_anomalies`, the
#: realtime cycle, the aborted duplicate and G1b of
#: tests/test_rw_register.py, a cyclic version order, and synth histories
HISTORIES = {
    "g1c-wr-cycle": lambda: concurrent(
        ([["w", "x", 1], ["r", "y", None]], [["w", "x", 1], ["r", "y", 9]]),
        ([["w", "y", 9], ["r", "x", None]], [["w", "y", 9], ["r", "x", 1]])),
    "write-skew": lambda: concurrent(
        ([["r", "x", None], ["w", "y", 10]],
         [["r", "x", None], ["w", "y", 10]]),
        ([["r", "y", None], ["w", "x", 1]],
         [["r", "y", None], ["w", "x", 1]])),
    "g1a": lambda: concurrent(
        ([["w", "x", 5]], "fail"),
        ([["r", "x", None]], [["r", "x", 5]])),
    "internal": lambda: concurrent(
        ([["w", "x", 7], ["r", "x", None]], [["w", "x", 7], ["r", "x", 3]]),
        ([["w", "x", 3]], [["w", "x", 3]])),
    "lost-update": lambda: concurrent(
        ([["r", "x", None], ["w", "x", 1]],
         [["r", "x", None], ["w", "x", 1]]),
        ([["r", "x", None], ["w", "x", 2]],
         [["r", "x", None], ["w", "x", 2]])),
    "duplicate-writes": lambda: concurrent(
        ([["w", "x", 1]], [["w", "x", 1]]),
        ([["w", "x", 1]], [["w", "x", 1]])),
    "realtime-cycle": lambda: jops.history([
        jops.invoke(0, "txn", [["r", "x", None]]),
        jops.ok(0, "txn", [["r", "x", 1]]),
        jops.invoke(1, "txn", [["w", "x", 1]]),
        jops.ok(1, "txn", [["w", "x", 1]])]),
    "aborted-duplicate": lambda: concurrent(
        ([["w", "x", 1]], "fail"),
        ([["w", "x", 1]], [["w", "x", 1]]),
        ([["r", "x", None]], [["r", "x", 1]])),
    "g1b": lambda: concurrent(
        ([["w", "x", 1], ["w", "x", 2]], [["w", "x", 1], ["w", "x", 2]]),
        ([["r", "x", None]], [["r", "x", 1]])),
    "cyclic-versions": lambda: concurrent(
        ([["r", "x", None], ["w", "x", 2]], [["r", "x", 1], ["w", "x", 2]]),
        ([["r", "x", None], ["w", "x", 1]], [["r", "x", 2], ["w", "x", 1]])),
    "synth-fail-info": lambda: jsynth.rw_history(
        n_txns=150, n_keys=6, concurrency=5, fail_prob=0.05,
        info_prob=0.05, seed=1),
}


def stale_rw(p, n_reads, seed):
    """`chip_smoke.stale_reads_rw` on a JAX PackedTxns."""
    from chip_smoke import stale_reads_rw

    return stale_reads_rw(p, n_reads, seed)


#: packed histories (the JAX package's PackedTxns)
PACKED = {
    **{f"packed-seed{s}": (lambda s=s: jsynth.packed_rw_history(
        600, n_keys=75, seed=s)) for s in range(6)},
    "packed-stale": lambda: stale_rw(
        jsynth.packed_rw_history(600, n_keys=75, seed=7), 6, 0),
}


def packed(name):
    """(JAX PackedTxns, port PackedTxns) of a corpus."""
    if name in PACKED:
        p = PACKED[name]()
    else:
        p = jpack(HISTORIES[name](), "rw-register")
    return p, packed_from_arrays(p)


def leaves(a, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from leaves(a[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        for i, x in enumerate(a):
            yield from leaves(x, f"{path}[{i}]")
    else:
        yield path, a


INFER_CASES = ["g1c-wr-cycle", "write-skew", "g1a", "internal",
               "lost-update", "duplicate-writes", "aborted-duplicate",
               "g1b", "cyclic-versions", "synth-fail-info", "packed-seed0",
               "packed-stale"]


@pytest.mark.parametrize("name", INFER_CASES)
@pytest.mark.parametrize("rw_cap", [0, 4], ids=["cap-M", "cap-4"])
def test_infer_rw_equal_to_jax(name, rw_cap):
    p, tp = packed(name)
    want = dict(leaves(jdrw.infer_rw(jdi.pad_packed(p), p.n_keys,
                                     rw_cap=rw_cap)))
    got = dict(leaves(tdrw.infer_rw(tdi.pad_packed(tp, device="cpu"),
                                    tp.n_keys, rw_cap=rw_cap)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        a, b = np.asarray(a), got[path].numpy()
        assert (b.dtype, b.shape) == (a.dtype, a.shape), path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", INFER_CASES)
@pytest.mark.parametrize("budget", [dict(), dict(rw_cap=1, max_k=1),
                                    dict(max_rounds=1)],
                         ids=["default", "rw_cap1-max_k1", "rounds1"])
def test_rw_core_check_equal_to_jax(name, budget):
    p, tp = packed(name)
    want = jdrw.rw_core_check(jdi.pad_packed(p), p.n_keys, **budget)
    got = tdrw.rw_core_check(tdi.pad_packed(tp, device="cpu"), tp.n_keys,
                             device="cpu", **budget)
    assert [t.tolist() for t in got] == \
        [np.asarray(a).tolist() for a in want]


@pytest.mark.parametrize("name", INFER_CASES)
def test_device_rw_check_equal_to_jax(name):
    p, tp = packed(name)
    # a tiny first budget: the grow loop must take the same steps
    kw = dict(max_k=1, max_rounds=1)
    want = jdrw.check(p, **kw)
    got = tdrw.check(tp, device="cpu", **kw)
    assert got == want
    assert got["exact"] is True


def test_device_rw_check_grows_rw_cap(monkeypatch):
    # 40 nil reads and 40 blind writes of one key: 1,600 rw edges against
    # a first rw_cap of M = 128 slots, so the grow loop must double it
    h = concurrent(*([([["r", "x", None]], [["r", "x", None]])] * 40
                     + [([["w", "x", i]], [["w", "x", i]])
                        for i in range(40)]))
    p = jpack(h, "rw-register")
    tp = packed_from_arrays(p)
    caps = []
    real = tdrw.rw_core_check

    def spy(h, n_keys, max_k, max_rounds, rw_cap, device=None):
        caps.append(rw_cap)
        return real(h, n_keys, max_k, max_rounds, rw_cap, device=device)

    monkeypatch.setattr(tdrw, "rw_core_check", spy)
    got = tdrw.check(tp, device="cpu")
    assert got == jdrw.check(p)
    assert got["exact"] is True and got["valid?"] is True
    assert caps == [128, 2048]


MODES = {
    "host": dict(use_device=False),
    "device": dict(use_device=True),
    "fused": dict(use_device=True, fused=True),
}


#: the stale-read corpus is checked as `chip_smoke.py` checks it: strict
#: serializability adds G-nonadjacent, whose budgeted host search holds a
#: check of even 600 txns for tens of seconds in both packages
STALE_MODELS = ["strong-snapshot-isolation"]


def both_checks(monkeypatch, name, mode, models=None):
    """(JAX result, port result) of `rw_register.check` on a corpus."""
    if models is None:
        models = STALE_MODELS if name == "packed-stale" else MODELS
    kw = dict(MODES[mode])
    if kw.pop("fused", False):
        monkeypatch.setattr(jrw, "FUSED_MIN_TXNS", 1)
        monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    if name in PACKED:
        jin, tin = packed(name)
    else:
        jin = HISTORIES[name]()
        tin = carry(jin)
    dev = {"device": "cpu"} if kw["use_device"] else {}
    return (jrw.check(jin, models, **kw), trw.check(tin, models, **kw, **dev))


CHECK_CASES = ["g1c-wr-cycle", "write-skew", "g1a", "internal",
               "lost-update", "duplicate-writes", "realtime-cycle",
               "aborted-duplicate", "g1b", "cyclic-versions",
               "synth-fail-info", "packed-stale"] + \
    [f"packed-seed{s}" for s in range(6)]


#: each packed seed's valid history costs the JAX side a sweep compile per
#: projection in "device" mode, so seeds 2-5 run "host" and "fused" only
CHECK_PARAMS = [(name, mode) for name in CHECK_CASES for mode in sorted(MODES)
                if mode != "device" or name not in
                [f"packed-seed{s}" for s in range(2, 6)]]


@pytest.mark.parametrize("name,mode", CHECK_PARAMS)
def test_rw_register_check_equal_to_jax(monkeypatch, name, mode):
    want, got = both_checks(monkeypatch, name, mode)
    assert got == want
    if name.startswith("packed-seed"):
        assert got["valid?"] is True
        assert got.get("fused-device") is (True if mode == "fused"
                                           else None)
    else:
        assert got["valid?"] is False or name == "synth-fail-info"


@pytest.mark.parametrize("models", [["snapshot-isolation"],
                                    ["read-committed"],
                                    ["serializable"]])
def test_rw_register_models_equal_to_jax(monkeypatch, models):
    for name in ("write-skew", "lost-update", "g1c-wr-cycle"):
        want, got = both_checks(monkeypatch, name, "device", models)
        assert got == want, name


def test_session_request_equal_to_jax(monkeypatch):
    # an op history takes the session checker; a bare packed input
    # degrades a bare session request to unknown
    h = HISTORIES["synth-fail-info"]()
    models = ["monotonic-reads"]
    assert trw.check(carry(h), models, device="cpu") == \
        jrw.check(h, models)
    p = jpack(h, "rw-register")
    got = trw.check(packed_from_arrays(p), models, device="cpu")
    assert got == jrw.check(p, models)
    assert got["valid?"] == "unknown"


def test_cycles_carry_explained_edges(monkeypatch):
    _, got = both_checks(monkeypatch, "write-skew", "device",
                         ["serializable"])
    (report,) = got["anomalies"]["G2-item"]
    for edge in report["cycle"]:
        assert edge["why"] and edge["key"] is not None, edge


@pytest.mark.parametrize("name", ["g1c-wr-cycle", "write-skew",
                                  "realtime-cycle", "cyclic-versions",
                                  "synth-fail-info"])
def test_rw_explainer_equal_to_jax(monkeypatch, name):
    # capture the arguments the JAX checker builds its explainer from,
    # then ask both explainers about every (src, rel, dst) pair
    seen = []
    real = jexplain.rw_explainer

    def capture(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(jexplain, "rw_explainer", capture)
    jrw.check(HISTORIES[name](), MODELS, use_device=False)
    (args, kw), = seen
    p, rest = args[0], args[1:]
    want = real(p, *rest, **kw)
    got = texplain.rw_explainer(packed_from_arrays(p), *rest, **kw)
    # every pair among the first 24 txns and one past the last
    ids = list(range(min(p.n_txns, 24))) + [p.n_txns]
    for a in ids:
        for b in ids:
            for rel in ("ww", "wr", "rw", "process", "realtime", "other"):
                assert got(a, rel, b) == want(a, rel, b), (a, rel, b)


def _edges(mod, src, dst, rel):
    e = mod.EdgeList()
    e.src = np.asarray(src, np.int32)
    e.dst = np.asarray(dst, np.int32)
    e.rel = np.asarray(rel, np.int8)
    return e


@pytest.mark.parametrize("use_device", [True, False])
def test_cycle_anomalies_equal_to_jax(use_device):
    # two txns in a ww/wr cycle, a third in an rw cycle with one of them,
    # a realtime barrier node past n_txns
    g = jgraph
    src, dst = [0, 1, 2, 0, 1, 3], [1, 0, 0, 2, 3, 2]
    rel = [g.REL_WW, g.REL_WR, g.REL_RW, g.REL_WR, g.REL_REALTIME,
           g.REL_REALTIME]
    rank = np.array([0, 2, 4, 6], np.int32)
    want_set = {"G0", "G1c", "G-single", "G2-item", "G1c-realtime",
                "G-single-realtime"}
    kw = dict(use_device=use_device, n_txns=3,
              orig_index=np.array([1, 3, 5], np.int32))
    want = jtc.cycle_anomalies(_edges(jgraph, src, dst, rel), 4, rank,
                               want_set, **kw)
    got = ttc.cycle_anomalies(_edges(tgraph, src, dst, rel), 4, rank,
                              want_set, device="cpu", **kw)
    assert got == want
    assert {"G1c", "G-single"} <= set(got)


def test_packed_rw_history_equal_to_original():
    for seed in range(6):
        for n, nk in ((700, 90), (64, 1)):
            want = jsynth.packed_rw_history(n, n_keys=nk, seed=seed)
            got = tsynth.packed_rw_history(n, n_keys=nk, seed=seed)
            for f in dataclasses.fields(want):
                a, b = getattr(want, f.name), getattr(got, f.name)
                if isinstance(a, np.ndarray):
                    assert b.dtype == a.dtype and np.array_equal(a, b), f.name
                else:
                    assert a == b, f.name


def test_rw_history_equal_to_original():
    for seed in range(3):
        kw = dict(n_txns=60, n_keys=4, concurrency=3, fail_prob=0.1,
                  info_prob=0.1, seed=seed)
        want = [dataclasses.asdict(op) for op in jsynth.rw_history(**kw)]
        got = [dataclasses.asdict(op) for op in tsynth.rw_history(**kw)]
        assert got == want


def test_config3_defaults_equal_to_jax():
    from jepsen_tpu.compilecache import warm

    assert tsynth.RW_KW == warm._RW_KW
    assert [tsynth.rw_keys_for(n) for n in (100, 65_536, 1_000_000)] == \
        [warm._keys_for(n) for n in (100, 65_536, 1_000_000)]


def test_seg_helpers_equal_to_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 400):
        vals = rng.integers(-1, 50, n)
        seg = np.cumsum(rng.random(n) < 0.2)
        for fn in ("_seg_reverse_max", "_seg_inclusive_max",
                   "_seg_exclusive_max"):
            a = getattr(jrw, fn)(vals, seg)
            b = getattr(trw, fn)(vals, seg)
            assert np.array_equal(a, b) and a.dtype == b.dtype, (fn, n)


def test_count_names_and_cap_equal_to_jax():
    assert tdrw.COUNT_NAMES_RW == jdrw.COUNT_NAMES_RW
    assert tdrw.RW_CAP_LIMIT == jdrw.RW_CAP_LIMIT
    assert trw.FUSED_MIN_TXNS == jrw.FUSED_MIN_TXNS


# ---- deadlines, faults, and no silent fallback ----------------------------

def test_deadline_gives_the_same_unknown(monkeypatch):
    monkeypatch.setattr(jrw, "FUSED_MIN_TXNS", 1)
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    h = HISTORIES["write-skew"]()
    want = jrw.check(h, MODELS, deadline=jres.Deadline(0.0))
    got = trw.check(carry(h), MODELS, deadline=tres.Deadline(0.0),
                    device="cpu")
    assert got == want == {"valid?": "unknown",
                           "error": "deadline-exceeded",
                           "checker": "rw-register"}
    with pytest.raises(tres.DeadlineExceeded):
        tdrw.check(packed("write-skew")[1], deadline=tres.Deadline(0.0),
                   device="cpu")


@pytest.mark.parametrize("name", ["write-skew", "packed-seed1"])
def test_persistent_fault_degrades_with_equal_stamps(monkeypatch, name):
    monkeypatch.setattr(jrw, "FUSED_MIN_TXNS", 1)
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    site = ("elle.rw-core-check",)
    fast = dict(base_delay_s=0.001)
    jin, tin = packed(name) if name in PACKED else \
        (HISTORIES[name](), carry(HISTORIES[name]()))
    want = jrw.check(jin, MODELS, plan=jres.FaultPlan(persistent=site),
                     policy=jres.RetryPolicy(**fast))
    got = trw.check(tin, MODELS, plan=tres.FaultPlan(persistent=site),
                    policy=tres.RetryPolicy(**fast), device="cpu")
    assert got == want
    assert got["degraded"] == "host-fallback"
    assert got["device-error"].startswith("FaultInjected: RESOURCE_EXHAUSTED")


def test_transient_fault_retries_to_the_clean_result(monkeypatch):
    monkeypatch.setattr(jrw, "FUSED_MIN_TXNS", 1)
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    jp, tp = packed("packed-seed2")
    want = jrw.check(jp, MODELS,
                     plan=jres.FaultPlan(at={0: "xla"}, max_faults=1))
    plan = tres.FaultPlan(at={0: "xla"}, max_faults=1)
    got = trw.check(tp, MODELS, plan=plan, device="cpu")
    assert got == want and got["fused-device"] is True
    assert plan.injected == [(0, "elle.rw-core-check", "xla")]
    assert "degraded" not in got


@pytest.mark.parametrize("exc", [
    kernels.KernelError("nvcc not found"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    backend.NoDeviceError("no card"),
], ids=["kernel-error", "illegal-address", "persistent-oom", "no-device"])
def test_device_error_on_fused_path_is_raised(monkeypatch, exc):
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)

    def broken(*args, **kw):
        raise exc

    monkeypatch.setattr(tdrw, "rw_core_check", broken)
    with pytest.raises(type(exc)):
        trw.check(packed("packed-seed0")[1], MODELS, device="cpu",
                  policy=tres.RetryPolicy(max_attempts=2, base_delay_s=0.0))


def test_synthetic_fault_on_fused_path_degrades(monkeypatch):
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)

    def broken(*args, **kw):
        raise tres.FaultInjected("device-lost", "elle.rw-core-check", 0,
                                 transient=False)

    monkeypatch.setattr(tdrw, "rw_core_check", broken)
    h = carry(HISTORIES["write-skew"]())
    got = trw.check(h, MODELS, device="cpu")
    assert got["degraded"] == "host-fallback"
    assert got["device-error"] == (
        "FaultInjected: UNAVAILABLE: device lost (injected) "
        "[site=elle.rw-core-check call=0]")
    assert "G2-item" in got["anomaly-types"]


def test_sweep_error_in_cycle_regions_is_raised(monkeypatch):
    # the JAX package swallows it and answers with host Tarjan
    def broken(g, max_k=128, max_rounds=64, deadline=None, device=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(cycle_sweep, "detect_cycles", broken)
    h = HISTORIES["write-skew"]()
    assert "G2-item" in jrw.check(h, MODELS)["anomaly-types"]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trw.check(carry(h), MODELS, device="cpu")
    e = _edges(tgraph, [0, 1], [1, 0], [tgraph.REL_WW, tgraph.REL_WW])
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ttc._cycle_regions(e, 2, np.array([0, 2], np.int32), True, "cpu")
    # without the device, Tarjan alone
    regions = ttc._cycle_regions(e, 2, np.array([0, 2], np.int32), False)
    assert [r.tolist() for r in regions] == [[0, 1]]


def test_unconverged_sweep_in_cycle_regions_raises(monkeypatch):
    def stuck(g, max_k=128, max_rounds=64, deadline=None, device=None):
        return cycle_sweep.SweepResult(
            has_cycle=False, witness_edge_ids=np.zeros(0, np.int64),
            n_backward=9000, converged=False)

    monkeypatch.setattr(cycle_sweep, "detect_cycles", stuck)
    with pytest.raises(tla.SweepNotConverged, match="9000 backward edges"):
        trw.check(carry(HISTORIES["write-skew"]()), MODELS, device="cpu")


def test_no_card_raises_instead_of_degrading(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = carry(HISTORIES["write-skew"]())
    with pytest.raises(backend.NoDeviceError):
        trw.check(h, MODELS)
    with pytest.raises(backend.NoDeviceError):
        tdrw.check(packed("write-skew")[1])
    # the host path needs no card
    assert "G2-item" in trw.check(h, MODELS, use_device=False)[
        "anomaly-types"]
