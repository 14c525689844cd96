"""Port parity for the invariants family (`jepsen_tpu_torch/checkers/
invariants/`: bank, long-fork / write-skew, session) and the IR sections
it reads.

Every clean and injected corpus of `tests/test_invariants.py` goes
through the JAX checker and the port's, and the result dicts must be
equal: the device path (the JAX package on its CPU backend, the port with
``device="cpu"``), the host twin (``use_device=False``) and a
`HistoryIR`.  Below the checkers: `MODELS`, `pack_bank`, every
`RwInference` array, the session masks (whose running max the port gives
to `ops.fill.locf`) bit for bit against `lax.cummax`, and the fork
matrix in float32 against the int32 products.  The fallback rule is the
port's: a `FaultPlan` degrades with the JAX stamp, and a real device
error is raised.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers import invariants as jinv  # noqa: E402
from jepsen_tpu.checkers.invariants import bank as jbank  # noqa: E402
from jepsen_tpu.checkers.invariants import packed as jpacked  # noqa: E402
from jepsen_tpu.checkers.invariants import predicate as jpred  # noqa: E402
from jepsen_tpu.checkers.invariants import session as jsess  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.history.ir import HistoryIR as JIR  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers import invariants as tinv  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import bank as tbank  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import packed as tpacked  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import predicate as tpred  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import session as tsess  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.ir import HistoryIR as TIR  # noqa: E402
from jepsen_tpu_torch.ops import fill, kernels  # noqa: E402
from test_invariants import (  # noqa: E402
    SEEDS,
    bank_history,
    inject_bank_negative,
    inject_bank_wrong_total,
    inject_long_fork,
    inject_session_break,
    inject_write_skew,
    lf_history,
    sess_history,
    ws_history,
)


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def _txn_history(txns):
    """(process, completed mops) rows as a JAX history, as the hand-built
    session cases of tests/test_invariants.py write them."""
    ops = []
    for p, filled in txns:
        ops.append(jops.Op(type=jops.INVOKE, process=p, f="txn",
                           value=[[m[0], m[1],
                                   None if m[0] == "r" else m[2]]
                                  for m in filled]))
        ops.append(jops.Op(type=jops.OK, process=p, f="txn", value=filled))
    return jops.History(ops)


BANK = {}
PRED = {}
SESS = {}
for _s in SEEDS:
    BANK[f"clean-{_s}"] = lambda s=_s: bank_history(seed=s)
    BANK[f"wrong-total-{_s}"] = \
        lambda s=_s: inject_bank_wrong_total(bank_history(seed=s), s)
    BANK[f"negative-{_s}"] = \
        lambda s=_s: inject_bank_negative(bank_history(seed=s), s)
    PRED[f"long-fork-clean-{_s}"] = lambda s=_s: lf_history(seed=s)
    PRED[f"long-fork-{_s}"] = \
        lambda s=_s: inject_long_fork(lf_history(seed=s))
    PRED[f"write-skew-clean-{_s}"] = lambda s=_s: ws_history(seed=s)
    PRED[f"write-skew-{_s}"] = \
        lambda s=_s: inject_write_skew(ws_history(seed=s))
    SESS[f"pinned-clean-{_s}"] = \
        lambda s=_s: sess_history(seed=s, pin_keys=True)
    SESS[f"pinned-break-{_s}"] = lambda s=_s: inject_session_break(
        sess_history(seed=s, pin_keys=True))
    SESS[f"cross-key-clean-{_s}"] = lambda s=_s: sess_history(seed=s)
    SESS[f"cross-key-break-{_s}"] = \
        lambda s=_s: inject_session_break(sess_history(seed=s))
# test_session_cross_key_obligation_only_violation's history
SESS["obligation-only"] = lambda: _txn_history([
    (0, [["r", 1, None], ["w", 1, 1]]),
    (0, [["r", 1, 1], ["w", 1, 2]]),
    (0, [["r", 1, 2], ["w", 2, 10]]),
    (2, [["r", 2, 10]]),
    (2, [["r", 1, 1]])])
# test_session_branched_falls_back_to_walker's history
SESS["branched"] = lambda: _txn_history([
    (0, [["r", 0, None], ["w", 0, 1]]),
    (0, [["w", 0, 2]])])
# a larger pinned corpus, so the masks span more than a few segments
SESS["pinned-large"] = lambda: inject_session_break(
    sess_history(n_keys=5, n_txns=400, seed=4, pin_keys=True))

TXN = {**PRED, **SESS}


def test_models_equal():
    assert tinv.MODELS == jinv.MODELS
    assert tinv.__all__ == jinv.__all__


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            _fields_equal(x, y)
        elif hasattr(x, "src"):  # EdgeList
            for k in ("src", "dst", "rel"):
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k),
                                              err_msg=f"{f.name}.{k}")
                assert getattr(x, k).dtype == getattr(y, k).dtype
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", sorted(BANK))
def test_pack_bank_equal(name):
    h = BANK[name]()
    _fields_equal(tpacked.pack_bank(carry(h)), jpacked.pack_bank(h))
    _fields_equal(tpacked.pack_bank(carry(h), accounts=[3, 1, 0]),
                  jpacked.pack_bank(h, accounts=[3, 1, 0]))


@pytest.mark.parametrize("name", sorted(TXN))
def test_infer_rw_equal(name):
    h = TXN[name]()
    tp, jp = tpacked.pack_rw(carry(h)), jpacked.pack_rw(h)
    _fields_equal(tpacked.infer_rw(tp), jpacked.infer_rw(jp))


@pytest.mark.parametrize("total", ["test-map", "accounts", "modal"])
@pytest.mark.parametrize("name", sorted(BANK))
def test_bank_check_equal(name, total):
    test = {"test-map": {"total-amount": 40},
            "accounts": {"accounts": {i: 10 for i in range(4)}},
            "modal": None}[total]
    h = BANK[name]()
    want = jbank.check(h, test)
    assert tbank.check(carry(h), test, device="cpu") == want
    assert tbank.check(carry(h), test, use_device=False) == \
        jbank.check(h, test, use_device=False)
    assert tbank.check(TIR(carry(h)), test, device="cpu") == \
        jbank.check(JIR(h), test)
    assert tbank.check(carry(h), test, negative_balances_ok=True,
                       device="cpu") == \
        jbank.check(h, test, negative_balances_ok=True)
    if name.startswith("clean"):
        assert want["valid?"] is True
    else:
        assert want["valid?"] is False and want["anomaly-types"]


@pytest.mark.parametrize("name", sorted(PRED))
def test_predicate_check_equal(name):
    h = PRED[name]()
    want = jpred.check(h)
    assert tpred.check(carry(h), device="cpu") == want
    assert tpred.check(carry(h), use_device=False) == \
        jpred.check(h, use_device=False)
    assert tpred.check(TIR(carry(h)), device="cpu") == jpred.check(JIR(h))
    assert tpred.check(tpacked.pack_rw(carry(h)), ["serializable"],
                       device="cpu") == \
        jpred.check(jpacked.pack_rw(h), ["serializable"])
    assert want["valid?"] is ("clean" in name)


@pytest.mark.parametrize("name", sorted(SESS))
def test_session_check_equal(name):
    h = SESS[name]()
    want = jsess.check(h)
    assert tsess.check(carry(h), device="cpu") == want
    assert tsess.check(carry(h), use_device=False) == \
        jsess.check(h, use_device=False)
    assert tsess.check(TIR(carry(h)), device="cpu") == jsess.check(JIR(h))
    # packed input: no op-level view for the walker
    assert tsess.check(tpacked.pack_rw(carry(h)), device="cpu") == \
        jsess.check(jpacked.pack_rw(h))
    g = ["monotonic-reads", "writes-follow-reads"]
    assert tsess.check(carry(h), g, device="cpu") == jsess.check(h, g)
    assert want["valid?"] is ("clean" in name or name == "branched")


def _enc(match):
    """`_viol_masks`'s encoding: the 1-based position of a match, else 0."""
    return np.where(match, np.arange(1, len(match) + 1), 0).astype(np.int32)


CUMMAX = {
    "empty": np.zeros(0, bool),
    "all-miss": np.zeros(37, bool),
    "one-segment": np.ones(37, bool),
    "first-only": np.eye(1, 50, 0, dtype=bool)[0],
    "last-only": np.eye(1, 50, 49, dtype=bool)[0],
    "random": np.random.default_rng(0).random(5000) < 0.3,
    "sparse": np.random.default_rng(1).random(9000) < 0.001,
}


@pytest.mark.parametrize("case", sorted(CUMMAX))
def test_cummax_on_locf_bit_equal_to_lax(case):
    enc = _enc(CUMMAX[case])
    got = tsess._cummax(torch.from_numpy(enc))
    want = np.asarray(lax.cummax(jnp.asarray(enc), axis=0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(SESS))
def test_viol_masks_equal(name):
    h = SESS[name]()
    tp, jp = tpacked.pack_rw(carry(h)), jpacked.pack_rw(h)
    ev = jsess._session_events(jp, jpacked.infer_rw(jp))
    assert (ev is None) == (
        tsess._session_events(tp, tpacked.infer_rw(tp)) is None)
    if ev is None:
        return
    proc, key, is_write, rank, _ = ev
    new = np.concatenate([[True], (proc[1:] != proc[:-1]) |
                          (key[1:] != key[:-1])])
    seg = np.cumsum(new) - 1
    want = [np.asarray(m) for m in jsess._viol_masks(seg, is_write,
                                                     rank)(jnp)]
    run = tsess._viol_masks(seg, is_write, rank)
    for got in (run(torch.device("cpu")), run()):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.bool_
            np.testing.assert_array_equal(g, w)


def test_session_device_path_fills_with_locf(monkeypatch):
    """Two fills per `session.check` on the device path, none on the
    host twin."""
    calls = []
    locf = fill.locf
    monkeypatch.setattr(fill, "locf", lambda x: calls.append(x) or locf(x))
    h = carry(SESS["pinned-break-0"]())
    tsess.check(h, device="cpu")
    assert len(calls) == 2 and all(c.dtype == torch.int32 for c in calls)
    tsess.check(h, use_device=False)
    assert len(calls) == 2


@pytest.mark.parametrize("name", sorted(PRED))
def test_fork_scan_float32_equal_to_int32(name):
    p = jpacked.pack_rw(PRED[name]())
    rt, covered, vals = jpred._group_reads(p)
    _, tcov, tvals = tpred._group_reads(tpacked.pack_rw(carry(
        PRED[name]())))
    np.testing.assert_array_equal(tcov, covered)
    np.testing.assert_array_equal(tvals, vals)
    observed = vals >= 0
    run = jpred._fork_scan(covered, observed)
    want = run(np)
    np.testing.assert_array_equal(np.asarray(run(jnp)), want)
    got = tpred._fork_scan_device(covered, observed, torch.device("cpu"))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpred._fork_scan_host(covered, observed),
                                  want)


@pytest.mark.parametrize("seed", SEEDS)
def test_long_forks_write_skews_and_oracle_equal(seed):
    for h in (lf_history(seed=seed), inject_long_fork(lf_history(seed=seed)),
              inject_write_skew(ws_history(seed=seed))):
        tp, jp = tpacked.pack_rw(carry(h)), jpacked.pack_rw(h)
        assert tpred.long_forks(tp, device="cpu") == jpred.long_forks(jp)
        assert tpred.long_forks(tp, use_device=False) == \
            jpred.long_forks(jp, use_device=False)
        assert tpred.write_skews(tpacked.infer_rw(tp)) == \
            jpred.write_skews(jpacked.infer_rw(jp))
        assert tpred.oracle_long_forks(carry(h)) == \
            jpred.oracle_long_forks(h)


def _plan(mod, site):
    return mod.FaultPlan(seed=3, persistent=(site,), kinds=("oom",))


def _policy(mod):
    return mod.RetryPolicy(max_attempts=2, base_delay_s=0.0, seed=0)


# checker -> (port check, JAX check, corpus)
CHECKERS = {
    "bank": (lambda h, **kw: tbank.check(h, {"total-amount": 40}, **kw),
             lambda h, **kw: jbank.check(h, {"total-amount": 40}, **kw),
             BANK["wrong-total-1"]),
    "predicate": (tpred.check, jpred.check, PRED["long-fork-0"]),
    "session": (tsess.check, jsess.check, SESS["pinned-break-0"]),
}


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_fault_plan_degrades_with_the_jax_stamp(checker):
    tcheck, jcheck, corpus = CHECKERS[checker]
    h = corpus()
    site = {"bank": tbank.SITE, "predicate": tpred.SITE,
            "session": tsess.SITE}[checker]
    want = jcheck(h, plan=_plan(jres, site), policy=_policy(jres))
    got = tcheck(carry(h), plan=_plan(tres, site), policy=_policy(tres),
                 device="cpu")
    assert want["degraded"] == tres.DEGRADED_HOST
    assert got == want
    # and an installed plan, as `resilience.use` installs it
    with tres.use(_plan(tres, site)):
        assert tcheck(carry(h), policy=_policy(tres), device="cpu") == want


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_real_device_error_is_raised(checker, monkeypatch):
    """The JAX package degrades any exception at these sites; the port
    raises everything but a synthetic fault."""
    tcheck, _, corpus = CHECKERS[checker]

    def boom(*a, **kw):
        raise kernels.KernelError("CUDA kernel failed: an illegal address")

    target = {"bank": (tbank, "_reduce_device"),
              "predicate": (tpred, "_fork_scan_device"),
              "session": (fill, "locf")}[checker]
    monkeypatch.setattr(*target, boom)
    with pytest.raises(kernels.KernelError):
        tcheck(carry(corpus()), device="cpu")
    # the host twin does not touch the device
    assert tcheck(carry(corpus()), use_device=False)["valid?"] is False


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_entry_points_need_a_card_unless_told_cpu(checker, monkeypatch):
    tcheck, _, corpus = CHECKERS[checker]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tcheck(carry(corpus()))
    assert tcheck(carry(corpus()), device="cpu")["valid?"] is False
    assert tcheck(carry(corpus()), use_device=False)["valid?"] is False


def test_deadline_results_equal():
    h = inject_long_fork(lf_history(seed=0))
    assert tpred.check(carry(h), deadline=tres.Deadline(0.0),
                       device="cpu") == \
        jpred.check(h, deadline=jres.Deadline(0.0))
    b = BANK["clean-0"]()
    with pytest.raises(tres.DeadlineExceeded):
        tbank.check(carry(b), {"total-amount": 40},
                    deadline=tres.Deadline(0.0), device="cpu")
    with pytest.raises(jres.DeadlineExceeded):
        jbank.check(b, {"total-amount": 40}, deadline=jres.Deadline(0.0))


def test_ir_builds_rw_inference_once(monkeypatch):
    """The predicate and session checkers of one IR share one
    `infer_rw`, booked in `build_s`; the bank section is memoized per
    account set."""
    calls = []
    infer = tpacked.infer_rw
    monkeypatch.setattr(tpacked, "infer_rw",
                        lambda p: calls.append(p) or infer(p))
    h = carry(SESS["cross-key-break-1"]())
    ir = TIR(h)
    s1 = tsess.check(ir, device="cpu")
    p1 = tpred.check(ir, device="cpu")
    assert tsess.check(ir, device="cpu") == s1
    assert len(calls) == 1 and "rw_inference" in ir.build_s
    assert s1 == tsess.check(h, device="cpu")
    assert p1 == tpred.check(h, device="cpu")
    assert ir.rw_inference() is ir.rw_inference()
    bir = TIR(carry(BANK["clean-0"]()))
    assert bir.bank() is bir.bank() and bir.bank([0, 1]) is bir.bank([1, 0])
    assert bir.bank() is not bir.bank([0, 1]) and "bank" in bir.build_s


def _ops(h):
    return [dataclasses.asdict(op) for op in h.ops]


@pytest.mark.parametrize("seed", SEEDS)
def test_chip_smoke_generators_equal(seed):
    """`chip_smoke.py` copies the corpus generators of
    tests/test_invariants.py (it may not import the JAX package)."""
    import chip_smoke as cs

    pairs = [
        (cs.bank_history(seed=seed), bank_history(seed=seed)),
        (cs.inject_bank_wrong_total(cs.bank_history(seed=seed), seed),
         inject_bank_wrong_total(bank_history(seed=seed), seed)),
        (cs.inject_bank_negative(cs.bank_history(seed=seed), seed),
         inject_bank_negative(bank_history(seed=seed), seed)),
        (cs.inject_long_fork(cs.lf_history(seed=seed)),
         inject_long_fork(lf_history(seed=seed))),
        (cs.inject_write_skew(cs.ws_history(seed=seed)),
         inject_write_skew(ws_history(seed=seed))),
        (cs.inject_session_break(cs.sess_history(seed=seed)),
         inject_session_break(sess_history(seed=seed))),
        (cs.sess_history(seed=seed, pin_keys=True),
         sess_history(seed=seed, pin_keys=True)),
    ]
    for got, want in pairs:
        assert _ops(got) == _ops(carry(want))
    # the phase's bank generator: one opening balance per account
    assert _ops(cs.bank_history(n_accounts=4, balance=[10] * 4,
                                seed=seed)) == _ops(carry(bank_history(
                                    seed=seed)))


def test_bank_sums_stay_int64_past_int32():
    """A deliberate difference: the JAX device path sums in int32 (no
    x64) and wraps above 2^31 - 1; the port's sums stay int64 and agree
    with the host twins of both packages."""
    # the first read's sum, 2^32 + 10, wraps to the total in int32
    bal = np.array([[2 ** 31 - 1, 2 ** 31 - 1, 12], [3, 3, 4]], np.int64)
    idx = np.arange(2, dtype=np.int64)
    none = np.zeros(0, np.int64)

    def pb(mod):
        return mod.PackedBank(accounts=[0, 1, 2], balances=bal.copy(),
                              read_op_index=idx, read_process=idx,
                              tr_type=np.zeros(0, np.int8), tr_from=none,
                              tr_to=none, tr_amount=none, tr_op_index=none)

    test = {"total-amount": 10}
    host = jbank.check(pb(jpacked), test, use_device=False)
    assert host["valid?"] is False and host["bad-reads"][0]["total"] == \
        2 ** 32 + 10
    assert tbank.check(pb(tpacked), test, device="cpu") == host
    assert tbank.check(pb(tpacked), test, use_device=False) == host
    assert jbank.check(pb(jpacked), test)["valid?"] is True
