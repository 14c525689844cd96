"""Port parity for the list-append checker API
(`jepsen_tpu_torch/checkers/elle/list_append.py`).

Each case builds its input once (numpy or the JAX package's generators),
then runs `jepsen_tpu.checkers.elle.list_append.check` and the port's
`check(..., device="cpu")` on it.  The whole result dicts must be equal:
verdicts, anomaly types, rendered cycles with their explanations, the
`not` / `also-not` boundaries, the deadline's unknown, and the stamps of a
degraded run.  Op histories reach the port through its own `history()`
over `dataclasses.asdict` of the JAX ops, packed histories through
`packed_from_arrays`.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from jepsen_tpu_torch.ops import kernels  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN = sorted(glob.glob(os.path.join(DATA, "la-*.json")))
MODELS = ["strict-serializable"]


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def golden(path):
    with open(path) as f:
        d = json.load(f)
    h = jops.history([jops.Op(type=o["type"], process=o["process"], f=o["f"],
                              value=o["value"]) for o in d["history"]])
    return h, d["models"]


def concurrent(*txns):
    """All txns invoked, then all completed (the hand-built shape of
    tests/test_device_la.py)."""
    inv, comp = [], []
    for i, (mops_inv, mops_ok) in enumerate(txns):
        inv.append(jops.invoke(i, "txn", mops_inv))
        if mops_ok == "fail":
            comp.append(jops.fail(i, "txn", mops_inv))
        elif mops_ok == "info":
            comp.append(jops.info(i, "txn", None))
        else:
            comp.append(jops.ok(i, "txn", mops_ok))
    return jops.history(inv + comp)


#: the five hand-built histories of tests/test_device_la.py
HAND_BUILT = {
    "g1c": lambda: concurrent(
        ([["append", "x", 1], ["r", "y", None]],
         [["append", "x", 1], ["r", "y", [9]]]),
        ([["append", "y", 9], ["r", "x", None]],
         [["append", "y", 9], ["r", "x", [1]]])),
    "g-single": lambda: concurrent(
        ([["append", "k", 1], ["append", "j", 10]],
         [["append", "k", 1], ["append", "j", 10]]),
        ([["append", "k", 2], ["r", "j", None]],
         [["append", "k", 2], ["r", "j", []]]),
        ([["r", "k", None], ["r", "j", None]],
         [["r", "k", [1, 2]], ["r", "j", [10]]])),
    "write-skew": lambda: concurrent(
        ([["r", "x", None], ["append", "y", 10]],
         [["r", "x", []], ["append", "y", 10]]),
        ([["r", "y", None], ["append", "x", 1]],
         [["r", "y", []], ["append", "x", 1]]),
        ([["r", "x", None], ["r", "y", None]],
         [["r", "x", [1]], ["r", "y", [10]]])),
    "realtime-cycle": lambda: jops.history([
        jops.invoke(0, "txn", [["r", "x", None]]),
        jops.ok(0, "txn", [["r", "x", [1]]]),
        jops.invoke(1, "txn", [["append", "x", 1]]),
        jops.ok(1, "txn", [["append", "x", 1]])]),
    "noncycle": lambda: concurrent(
        ([["append", "x", 1], ["append", "x", 2]],
         [["append", "x", 1], ["append", "x", 2]]),
        ([["r", "x", None]], [["r", "x", [1]]]),
        ([["append", "y", 7]], "fail"),
        ([["r", "y", None]], [["r", "y", [7]]]),
        ([["append", "z", 5], ["r", "z", None]],
         [["append", "z", 5], ["r", "z", [5, 9]]])),
}

#: the anomaly types tests/test_device_la.py asserts on each
HAND_BUILT_EXPECT = {
    "g1c": {"G1c"}, "g-single": {"G-single"}, "write-skew": {"G2-item"},
    "realtime-cycle": {"G1c-realtime"},
    "noncycle": {"G1a", "G1b", "internal"},
}


def synth_history(seed):
    """The differential histories of tests/test_device_la.py: one of
    four injections per seed."""
    h = synth.la_history(n_txns=120, n_keys=5, concurrency=4,
                         fail_prob=0.05, info_prob=0.05,
                         multi_append_prob=0.2, seed=seed)
    inject = (None, synth.inject_g1a, synth.inject_wr_cycle,
              synth.inject_rw_cycle)[seed % 4]
    if inject is not None:
        inject(h)
    return h


def both(h, models=MODELS, **kw):
    """(JAX result, port result) on the same op history."""
    t = carry(h)
    want = jla.check(h, models, _force_no_fallback=True, **kw)
    got = tla.check(t, models, _force_no_fallback=True, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_golden_equal_to_jax(path):
    h, models = golden(path)
    with open(path) as f:
        expected = json.load(f)["expected"]
    want, got = both(h, models)
    assert got == want
    assert got["valid?"] == expected["valid?"]
    assert got["anomaly-types"] == expected["anomaly-types"]


def test_golden_corpus_has_seven_files():
    assert len(GOLDEN) == 7, GOLDEN


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_hand_built_equal_to_jax(name):
    want, got = both(HAND_BUILT[name]())
    assert got == want
    assert HAND_BUILT_EXPECT[name] <= set(got["anomaly-types"])
    assert got["valid?"] is False


def test_cycles_carry_explained_edges():
    _, got = both(HAND_BUILT["g-single"]())
    (report,) = got["anomalies"]["G-single"]
    for edge in report["cycle"]:
        assert edge["why"] and "key" in edge, edge


@pytest.mark.parametrize("seed", range(8))
def test_synth_equal_to_jax(seed):
    want, got = both(synth_history(seed))
    assert got == want


def test_packed_history_equal_to_jax():
    p = synth.packed_la_history(n_txns=3000, n_keys=24, seed=11)
    want = jla.check(p, MODELS, _force_no_fallback=True)
    got = tla.check(packed_from_arrays(p), MODELS, _force_no_fallback=True,
                    device="cpu")
    assert got == want
    assert got["valid?"] is True


def test_deadline_gives_the_same_unknown():
    h = synth_history(2)
    want = jla.check(h, MODELS, deadline=jres.Deadline(0.0))
    got = tla.check(carry(h), MODELS, deadline=tres.Deadline(0.0),
                    device="cpu")
    assert got == want
    assert got == {"valid?": "unknown", "error": "deadline-exceeded",
                   "checker": "list-append"}


def test_persistent_fault_degrades_with_equal_stamps():
    h = HAND_BUILT["g1c"]()
    fast = dict(base_delay_s=0.001)
    want = jla.check(h, MODELS,
                     plan=jres.FaultPlan(persistent=("elle.infer",)),
                     policy=jres.RetryPolicy(**fast))
    got = tla.check(carry(h), MODELS,
                    plan=tres.FaultPlan(persistent=("elle.infer",)),
                    policy=tres.RetryPolicy(**fast), device="cpu")
    assert got == want
    assert got["degraded"] == "host-fallback"
    assert got["device-error"].startswith("FaultInjected: RESOURCE_EXHAUSTED")
    assert "G1c" in got["anomaly-types"]


def test_transient_fault_retries_to_the_clean_result():
    h = HAND_BUILT["g-single"]()
    clean, _ = both(h)
    want = jla.check(h, MODELS, _force_no_fallback=True,
                     plan=jres.FaultPlan(at={0: "xla"}, max_faults=1))
    plan = tres.FaultPlan(at={0: "xla"}, max_faults=1)
    got = tla.check(carry(h), MODELS, _force_no_fallback=True, plan=plan,
                    device="cpu")
    assert got == want == clean
    assert plan.injected == [(0, "elle.infer", "xla")]
    assert "degraded" not in got


def test_kernel_error_is_raised_not_degraded(monkeypatch):
    def broken(h, n_keys):
        raise kernels.KernelError("nvcc not found")

    monkeypatch.setattr(tla, "infer", broken)
    with pytest.raises(kernels.KernelError):
        tla.check(carry(HAND_BUILT["g1c"]()), MODELS, device="cpu")


def test_other_persistent_error_degrades(monkeypatch):
    # only a synthetic fault that outlives its retries takes the oracle
    # route; it is stamped, and _force_no_fallback raises it instead
    def broken(h, n_keys):
        raise tres.FaultInjected("device-lost", "elle.infer", 0,
                                 transient=False)

    monkeypatch.setattr(tla, "infer", broken)
    h = carry(HAND_BUILT["g1c"]())
    got = tla.check(h, MODELS, device="cpu")
    assert got["degraded"] == "host-fallback"
    assert got["device-error"] == ("FaultInjected: UNAVAILABLE: device lost "
                                   "(injected) [site=elle.infer call=0]")
    assert "G1c" in got["anomaly-types"]
    with pytest.raises(tres.FaultInjected):
        tla.check(h, MODELS, device="cpu", _force_no_fallback=True)


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
], ids=["illegal-address", "persistent-oom"])
def test_real_device_error_is_raised_not_degraded(monkeypatch, exc):
    # a fault inside a kernel surfaces at the next copy as torch's own
    # error, and an out-of-memory outlives its retries: both are raised
    calls = []

    def broken(h, n_keys):
        calls.append(1)
        raise exc

    monkeypatch.setattr(tla, "infer", broken)
    with pytest.raises(type(exc)):
        tla.check(carry(HAND_BUILT["g1c"]()), MODELS, device="cpu",
                  policy=tres.RetryPolicy(max_attempts=2, base_delay_s=0.0))
    assert len(calls) == (2 if tres.is_transient(exc) else 1)


def test_unconverged_sweep_raises_not_degraded(monkeypatch):
    from jepsen_tpu_torch.ops.cycle_sweep import SweepResult

    def stuck(g, deadline=None, device=None, mesh=None):
        return SweepResult(has_cycle=False, witness_edge_ids=np.zeros(0),
                           n_backward=9000, converged=False)

    monkeypatch.setattr(tla, "detect_cycles", stuck)
    with pytest.raises(tla.SweepNotConverged, match="9000 backward edges"):
        tla.check(carry(HAND_BUILT["g1c"]()), MODELS, device="cpu")


def test_no_fault_plan_unless_given(monkeypatch):
    # the JAX package reads JEPSEN_FAULTS; the port injects only a plan
    # that its caller gave or installed
    h = HAND_BUILT["g1c"]()
    want = jla.check(h, MODELS, _force_no_fallback=True)
    monkeypatch.setenv("JEPSEN_FAULTS", "persistent=all")
    got = tla.check(carry(h), MODELS, _force_no_fallback=True, device="cpu")
    assert got == want and "degraded" not in got
    assert tres.active_plan() is None


def test_no_card_raises_instead_of_degrading(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tla.check(carry(HAND_BUILT["g1c"]()), MODELS)
