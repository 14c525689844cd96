"""Port parity for `HistoryIR` (`jepsen_tpu_torch/history/ir.py`) and the
checkers that take one.

The cases of tests/test_ir.py that touch the ported sections (round trip
through the IR for list-append and rw-register, sections memoized and
shared, packed-only IRs), each against the JAX package, plus what the port
adds: the padded layout is memoized per (workload, device), and a second
check of one IR pads zero times (`pad_packed` calls are counted).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.checkers.elle import rw_register as jrw  # noqa: E402
from jepsen_tpu.history.ir import HistoryIR as JIR  # noqa: E402
from jepsen_tpu.history.ops import INVOKE, OK, History, Op  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_rw as tdrw  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.checkers.elle import rw_register as trw  # noqa: E402
from jepsen_tpu_torch.history import ir as tir  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.ir import IR_VERSION, HistoryIR  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402

MODELS = ("strict-serializable",)


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def _txn(ops, p, filled):
    ops.append(Op(type=INVOKE, process=p, f="txn",
                  value=[[m[0], m[1], None if m[0] == "r" else m[2]]
                         for m in filled]))
    ops.append(Op(type=OK, process=p, f="txn", value=filled))


def _la_history(invalid=False):
    h = synth.la_history(n_txns=80, n_keys=4, concurrency=5,
                         multi_append_prob=0.2, seed=11)
    if invalid:
        synth.inject_wr_cycle(h)
        synth.inject_g1a(h)
    return h


def _rw_history():
    ops = []
    _txn(ops, 0, [["r", 0, None], ["w", 0, 1]])
    _txn(ops, 1, [["r", 0, 1], ["w", 1, 5]])
    _txn(ops, 0, [["r", 1, 5]])
    return History(ops)


@pytest.fixture
def pads(monkeypatch):
    """Count `pad_packed` calls from every caller of it."""
    calls = []
    real = tdi.pad_packed

    def counted(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    for mod in (tdi, tla, tdrw):
        monkeypatch.setattr(mod, "pad_packed", counted)
    return calls


@pytest.mark.parametrize("invalid", [False, True])
def test_ir_roundtrip_list_append(invalid):
    h = _la_history(invalid)
    want = jla.check(JIR.of(h), MODELS, _force_no_fallback=True)
    raw = tla.check(carry(h), MODELS, _force_no_fallback=True, device="cpu")
    via = tla.check(HistoryIR.of(carry(h)), MODELS, _force_no_fallback=True,
                    device="cpu")
    assert via == raw == want
    assert via["valid?"] is (not invalid)


@pytest.mark.parametrize("fused", [False, True])
def test_ir_roundtrip_rw_register(monkeypatch, fused):
    if fused:
        monkeypatch.setattr(jrw, "FUSED_MIN_TXNS", 1)
        monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    for h in (_rw_history(), synth.rw_history(n_txns=60, n_keys=4, seed=2)):
        want = jrw.check(JIR.of(h))
        raw = trw.check(carry(h), device="cpu")
        via = trw.check(HistoryIR.of(carry(h)), device="cpu")
        assert via == raw == want
        assert via.get("fused-device") is (True if fused else None)


def test_ir_sections_memoized_and_shared():
    h = carry(_rw_history())
    ir = HistoryIR.of(h)
    assert HistoryIR.of(ir) is ir
    assert ir.packed("rw-register") is ir.packed("rw-register")
    # the IR is a History: plain consumers see the same ops
    assert len(ir) == len(h)
    assert list(ir) == list(h.ops)
    assert ir.ops is h.ops and ir._pair is h._pair

    la = HistoryIR.of(carry(_la_history()))
    assert la.padded("list-append", "cpu") is la.padded("list-append", "cpu")
    assert la.padded("list-append", "cpu") is \
        la.padded("list-append", torch.device("cpu"))
    lay = la.layout("cpu")
    assert lay["version"] == IR_VERSION
    assert lay["derived_columns"] is True
    assert sorted(la.build_s) == ["packed:list-append",
                                  "padded:list-append:cpu"]
    assert all(t >= 0 for t in la.build_s.values())


@pytest.mark.parametrize("wl", ["list-append", "rw-register"])
def test_layout_and_packing_equal_to_jax(wl):
    h = _la_history() if wl == "list-append" else _rw_history()
    jir, tir_ = JIR.of(h), HistoryIR.of(carry(h))
    if wl == "list-append":
        assert tir_.layout("cpu") == jir.layout()
    a, b = jir.packed(wl), tir_.packed(wl)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y) and x.dtype == y.dtype, f.name
        elif isinstance(x, int):
            assert x == y, f.name
        else:
            assert list(x) == list(y), f.name


def test_ir_of_op_list_reindexes_like_jax():
    h = _la_history()
    ops = [dataclasses.replace(op, index=-1) for op in carry(h).ops]
    ir = HistoryIR(ops)
    assert [op.index for op in ir] == list(range(len(ops)))
    assert np.array_equal(ir._pair, JIR(list(h))._pair)


def test_one_padded_layout_per_workload_and_device(monkeypatch):
    # writes only: a history that both workloads' packers take
    ops = []
    _txn(ops, 0, [["w", 0, 1]])
    _txn(ops, 1, [["w", 0, 2], ["w", 1, 3]])
    ir = HistoryIR.of(carry(History(ops)))
    la, rw = ir.padded("list-append", "cpu"), ir.padded("rw-register", "cpu")
    assert la is not rw
    assert ir.padded("rw-register", "cpu") is rw
    # a CUDA device without an index, and the default device, name the
    # current card: one key for both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tir._device_key("cuda") == tir._device_key(None) == \
        torch.device("cuda", 0) != tir._device_key("cpu")


def test_packed_only_ir_degrades_like_packed():
    h = _la_history(invalid=True)
    p = jpack(h, "list-append")
    tp = packed_from_arrays(p)
    ir = HistoryIR.of(tp)
    assert ir.packed_only and ir.packed("list-append") is tp
    models = ("strict-serializable", "monotonic-reads")
    want = jla.check(JIR.of(p), models, _force_no_fallback=True)
    got = tla.check(ir, models, _force_no_fallback=True, device="cpu")
    assert got == want == tla.check(tp, models, _force_no_fallback=True,
                                    device="cpu")
    rp = jpack(_rw_history(), "rw-register")
    trp = packed_from_arrays(rp)
    assert trw.check(HistoryIR.of(trp), device="cpu") == \
        jrw.check(JIR.of(rp)) == trw.check(trp, device="cpu")


def test_list_append_check_pads_once_per_ir(pads):
    ir = HistoryIR.of(carry(_la_history(invalid=True)))
    first = tla.check(ir, MODELS, _force_no_fallback=True, device="cpu")
    assert len(pads) == 1
    second = tla.check(ir, MODELS, _force_no_fallback=True, device="cpu")
    assert len(pads) == 1 and second == first
    # a raw history pads on every check
    h = carry(_la_history(invalid=True))
    tla.check(h, MODELS, _force_no_fallback=True, device="cpu")
    tla.check(h, MODELS, _force_no_fallback=True, device="cpu")
    assert len(pads) == 3


def test_rw_register_check_pads_once_per_ir(monkeypatch, pads):
    monkeypatch.setattr(trw, "FUSED_MIN_TXNS", 1)
    p = packed_from_arrays(synth.packed_rw_history(300, n_keys=40, seed=1))
    ir = HistoryIR.of(p)
    first = trw.check(ir, device="cpu")
    assert first["fused-device"] is True and len(pads) == 1
    assert trw.check(ir, device="cpu") == first and len(pads) == 1
    assert tdrw.check(ir, device="cpu")["valid?"] is True
    assert len(pads) == 1
    assert pads[0] is p


def test_transient_retry_does_not_pad_again(pads):
    # the pad runs outside the guarded infer: a retried infer reuses it
    h = carry(_la_history())
    plan = tres.FaultPlan(at={0: "xla"}, max_faults=1)
    got = tla.check(h, MODELS, _force_no_fallback=True, plan=plan,
                    device="cpu")
    assert plan.injected == [(0, "elle.infer", "xla")]
    assert got["valid?"] is True and len(pads) == 1
