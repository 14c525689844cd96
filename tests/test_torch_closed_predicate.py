"""Port parity for the closed-predicate checker (`jepsen_tpu_torch/
checkers/elle/closed_predicate.py`).

The seven micro-histories of `tests/test_closed_predicate.py` are built
in each package, and the result dicts must be equal: with the cycle
sweep on the device (the JAX package on its CPU backend, the port with
``device="cpu"``) and with host Tarjan alone (``use_device=False``).
"""

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import closed_predicate as jcp  # noqa: E402
from jepsen_tpu import history as jhist  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import history as thist  # noqa: E402
from jepsen_tpu_torch.checkers.elle import closed_predicate as tcp  # noqa: E402


def _serial(*events):
    return lambda m: m.history([getattr(m, t)(p, "txn", v)
                                for t, p, v in events])


def _concurrent(*txns):
    """Every txn invoked, then every txn completed (or failed)."""
    def build(m):
        inv, comp = [], []
        for i, (mops_inv, mops_ok) in enumerate(txns):
            inv.append(m.invoke(i, "txn", mops_inv))
            comp.append(m.fail(i, "txn", mops_inv) if mops_ok == "fail"
                        else m.ok(i, "txn", mops_ok))
        return m.history(inv + comp)
    return build


#: name -> (history generator over a package's `history` module, models,
#: expected verdict)
CORPORA = {
    "valid-serial-inserts": (_serial(
        ("invoke", 0, [("insert", "a", 1)]), ("ok", 0, [("insert", "a", 1)]),
        ("invoke", 0, [("insert", "b", 2)]), ("ok", 0, [("insert", "b", 2)]),
        ("invoke", 1, [("rp", "all", None)]),
        ("ok", 1, [("rp", "all", {"a": 1, "b": 2})])),
        ["serializable"], True),
    "phantom-write-skew": (_concurrent(
        ([("rp", "all", None), ("insert", "a", 1)],
         [("rp", "all", {}), ("insert", "a", 1)]),
        ([("rp", "all", None), ("insert", "b", 2)],
         [("rp", "all", {}), ("insert", "b", 2)])),
        ["serializable"], False),
    "read-all-misses-insert": (_serial(
        ("invoke", 0, [("insert", "a", 1)]), ("ok", 0, [("insert", "a", 1)]),
        ("invoke", 1, [("rp", "all", None)]), ("ok", 1, [("rp", "all", {})])),
        ["strict-serializable"], False),
    "equality-predicate": (_serial(
        ("invoke", 0, [("insert", "a", 1)]), ("ok", 0, [("insert", "a", 1)]),
        ("invoke", 0, [("insert", "b", 2)]), ("ok", 0, [("insert", "b", 2)]),
        ("invoke", 1, [("rp", ("=", 1), None)]),
        ("ok", 1, [("rp", ("=", 1), {"a": 1})])),
        ["serializable"], True),
    "delete-then-read-all": (_serial(
        ("invoke", 0, [("insert", "a", 1)]), ("ok", 0, [("insert", "a", 1)]),
        ("invoke", 0, [("delete", "a")]), ("ok", 0, [("delete", "a")]),
        ("invoke", 1, [("rp", "all", None)]), ("ok", 1, [("rp", "all", {})])),
        ["strict-serializable"], True),
    "structural": (_serial(
        ("invoke", 0, [("insert", "a", 1)]), ("ok", 0, [("insert", "a", 1)]),
        ("invoke", 0, [("insert", "a", 9)]), ("ok", 0, [("insert", "a", 9)]),
        ("invoke", 1, [("rp", "all", None)]),
        ("ok", 1, [("rp", "all", {"a": 7})])),
        ["serializable"], False),
    "g1c-predicate-wr-cycle": (_concurrent(
        ([("insert", "a", 1), ("rp", "all", None)],
         [("insert", "a", 1), ("rp", "all", {"a": 1, "b": 2})]),
        ([("insert", "b", 2), ("rp", "all", None)],
         [("insert", "b", 2), ("rp", "all", {"a": 1, "b": 2})])),
        ["read-committed"], False),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_closed_predicate_equal(name):
    build, models, valid = CORPORA[name]
    jh, th = build(jhist), build(thist)
    want = jcp.check(jh, models)
    assert want["valid?"] is valid, want
    assert tcp.check(th, models, device="cpu") == want
    assert tcp.check(th, models, use_device=False) == \
        jcp.check(jh, models, use_device=False)
    # a cycle through a phantom edge carries the -predicate suffix
    if name == "phantom-write-skew":
        assert any(a.endswith("-predicate") for a in want["anomaly-types"])


def test_closed_predicate_needs_a_card_unless_told_cpu(monkeypatch):
    build, models, _ = CORPORA["phantom-write-skew"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tcp.check(build(thist), models)
    assert tcp.check(build(thist), models, use_device=False)["valid?"] \
        is False


def test_unknown_mop_and_predicate_raise_as_in_jax():
    for mops in ([("frob", "a", 1)], [("rp", ("<", 3), {})]):
        events = (("invoke", 0, [("insert", "a", 1)]),
                  ("ok", 0, [("insert", "a", 1)]),
                  ("invoke", 1, mops), ("ok", 1, mops))
        with pytest.raises(ValueError) as want:
            jcp.check(_serial(*events)(jhist))
        with pytest.raises(ValueError) as got:
            tcp.check(_serial(*events)(thist), device="cpu")
        assert str(got.value) == str(want.value)
