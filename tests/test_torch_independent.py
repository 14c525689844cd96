"""Port parity for `jepsen_tpu_torch/independent.py`: every `independent`
case of `tests/test_workloads.py`, run by each package on its own
modules.

Tolerances: the generators' histories are equal op for op with `time`
left aside at concurrency 1; with more threads, which thread of a group
takes an op is the scheduler's, so the ops of each thread group are
compared as sorted lists.  The checkers' result dicts are equal.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import independent as jind  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.generator import core as jg  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.workloads import mem as jmem  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import independent as tind  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.generator import core as tg  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.workloads import mem as tmem  # noqa: E402

SIDES = {
    "jax": dict(core=jcore, ind=jind, api=japi, g=jg, ops=jops, mem=jmem),
    "port": dict(core=tcore, ind=tind, api=tapi, g=tg, ops=tops,
                 mem=tmem),
}


def _ops(h):
    return [dict(dataclasses.asdict(op), time=None) for op in h]


def _sorted(h, procs=None):
    """The (type, f, value) of each op of `procs`, sorted."""
    return sorted(((op.type, op.f, op.value) for op in h
                   if procs is None or op.process in procs), key=repr)


def _reads(m, n):
    g = m["g"]
    return lambda k: g.limit(n, lambda t, c: {"f": "read", "value": None})


def _run(m, base, gen, concurrency):
    return m["core"].run({
        "name": "indep", "client": m["mem"].MemClient(),
        "concurrency": concurrency, "nodes": ["n1"],
        "generator": m["g"].clients(gen), "store-dir": base})


@pytest.mark.parametrize("concurrency", [1, 2])
def test_independent_sequential(tmp_path, concurrency):
    out = {}
    for side, m in SIDES.items():
        gen = m["ind"].sequential_generator(["a", "b"], _reads(m, 4))
        out[side] = _run(m, str(tmp_path / side), gen,
                         concurrency)["history"]
    if concurrency == 1:
        assert _ops(out["port"]) == _ops(out["jax"])
    assert _sorted(out["port"]) == _sorted(out["jax"])
    vals = [op.value for op in out["port"] if op.type == "invoke"]
    assert all(tind.is_tuple(v) for v in vals)
    assert {v[0] for v in vals} == {"a", "b"}


def test_independent_concurrent_groups(tmp_path):
    keys = [0, 1, 2, 3]
    out = {}
    for side, m in SIDES.items():
        gen = m["ind"].concurrent_generator(2, keys, _reads(m, 3))
        out[side] = _run(m, str(tmp_path / side), gen, 4)["history"]
    invs = [op for op in out["port"] if op.type == "invoke"]
    assert len(invs) == 12  # 4 keys x 3 ops
    assert {op.value[0] for op in invs} == set(keys)
    # group 0 (threads 0-1) and group 1 (threads 2-3) touch disjoint keys
    for op in invs:
        group = 0 if op.process % 4 in (0, 1) else 1
        assert op.value[0] in (keys[:2] if group == 0 else keys[2:])
    for group in ((0, 1), (2, 3)):
        assert _sorted(out["port"], group) == _sorted(out["jax"], group)


def test_concurrent_generator_needs_divisible_concurrency(tmp_path):
    for side, m in SIDES.items():
        gen = m["ind"].concurrent_generator(2, [0, 1], _reads(m, 1))
        with pytest.raises(ValueError, match="not divisible by group"):
            _run(m, str(tmp_path / side), gen, 3)


def _history(m, events):
    o = m["ops"]
    return o.history([getattr(o, kind)(p, f, v) for kind, p, f, v in events])


def test_independent_checker_splits_and_merges():
    ev = [("invoke", 0, "read", ("k1", None)), ("ok", 0, "read", ("k1", 1)),
          ("invoke", 1, "read", ("k2", None)), ("ok", 1, "read", ("k2", 2))]
    out = {side: m["ind"].checker(m["api"].Stats).check(
        {}, _history(m, ev)) for side, m in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["valid?"] is True and out["port"]["key-count"] == 2
    subs = {side: m["ind"].subhistories(_history(m, ev))
            for side, m in SIDES.items()}
    assert {k: _ops(h) for k, h in subs["port"].items()} == \
        {k: _ops(h) for k, h in subs["jax"].items()}
    assert [op.index for op in subs["port"]["k2"]] == [0, 1]


def _fail_k2(api):
    class _FailK2(api.Checker):
        def check(self, test, history, opts=None):
            bad = any(op.value == "poison" for op in history)
            return {"valid?": not bad}

    return _FailK2


def test_independent_checker_reports_failing_key():
    ev = [("invoke", 0, "w", ("k1", 1)), ("ok", 0, "w", ("k1", 1)),
          ("invoke", 1, "w", ("k2", "poison")),
          ("ok", 1, "w", ("k2", "poison"))]
    out = {side: m["ind"].checker(_fail_k2(m["api"])).check(
        {}, _history(m, ev)) for side, m in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["valid?"] is False
    assert out["port"]["failures"] == ["k2"]


def test_independent_checker_copies_stateful_instances():
    def stateful(api):
        class Stateful(api.Checker):
            def __init__(self):
                self.seen = []

            def check(self, test, history, opts=None):
                self.seen.extend(op.value for op in history)
                return {"valid?": len(self.seen) <= 2}

        return Stateful()

    ev = [("invoke", 0, "w", ("k1", 1)), ("ok", 0, "w", ("k1", 1)),
          ("invoke", 1, "w", ("k2", 2)), ("ok", 1, "w", ("k2", 2))]
    out = {side: m["ind"].checker(stateful(m["api"])).check(
        {}, _history(m, ev)) for side, m in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["valid?"] is True  # no cross-key contamination


def test_independent_checker_no_tuples_and_crashes():
    """No tuple values: unknown with no keys; a key whose checker raises
    is that key's valid? unknown (`check_safe`), the whole unknown."""
    plain = [("invoke", 0, "w", 1), ("ok", 0, "w", 1)]
    out = {side: m["ind"].checker(m["api"].Stats).check(
        {}, _history(m, plain)) for side, m in SIDES.items()}
    assert out["port"] == out["jax"] == {"valid?": "unknown",
                                         "key-count": 0}

    def boom(api):
        class Boom(api.Checker):
            def check(self, test, history, opts=None):
                raise RuntimeError("boom")

        return Boom

    ev = [("invoke", 0, "w", ("k1", 1)), ("ok", 0, "w", ("k1", 1))]
    out = {side: m["ind"].checker(boom(m["api"])).check(
        {}, _history(m, ev)) for side, m in SIDES.items()}
    for side in out:
        err = out[side]["results"]["'k1'"].pop("error")
        assert "boom" in err
    assert out["port"] == out["jax"]
    assert out["port"]["valid?"] == "unknown"
