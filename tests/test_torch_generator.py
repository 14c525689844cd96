"""Port parity for the generator DSL and its simulator
(`jepsen_tpu_torch/generator/`: `core`, `context`, `sim`) and the
helpers it needs (`jepsen_tpu_torch/utils/core.py`).

Every combinator that `tests/test_generator.py` exercises is built in
both packages from the same seeds and run through each package's
`generator.sim.simulate`.  Tolerance: the two event lists are equal, op
for op, times included (the simulator's clock is virtual).
"""

import importlib
import random

import pytest

from jepsen_tpu import utils as jutils
from jepsen_tpu.generator import core as jg
from jepsen_tpu.generator import sim as jsim
from jepsen_tpu.utils import core as jucore
from jepsen_tpu_torch import utils as tutils
from jepsen_tpu_torch.generator import core as tg
from jepsen_tpu_torch.generator import sim as tsim
from jepsen_tpu_torch.utils import core as tucore

# `generator/__init__.py` binds the name `context` to the function, so
# the modules come from importlib
jctx = importlib.import_module("jepsen_tpu.generator.context")
tctx = importlib.import_module("jepsen_tpu_torch.generator.context")

R = {"f": "r", "value": None}


def _op(f):
    return lambda t, c: {"f": f, "value": None}


def _counter(f="w"):
    n = {"n": 0}

    def go(test, ctx):
        n["n"] += 1
        return {"f": f, "value": n["n"]}
    return go


def _crash_p0(op):
    # process 0's ops crash: its thread reincarnates as 0 + concurrency
    return dict(op, type="info" if op["process"] == 0 else "ok")


#: name -> build(g) returning (generator, test map, completion fn or None);
#: `g` is either package's `generator.core`
CASES = {
    "map": lambda g: ({"f": "read", "value": None}, None, None),
    "seq": lambda g: ([[{"f": "a", "value": 1}],
                       [{"f": "b", "value": 2}, {"f": "c", "value": 3}]],
                      None, None),
    "limit": lambda g: (g.limit(3, _counter()), None, None),
    "repeat": lambda g: (g.repeat(R, 4), None, None),
    "once": lambda g: (g.once(_op("r")), None, None),
    "cycle": lambda g: (g.limit(7, g.cycle([R, {"f": "w", "value": 1}])),
                        None, None),
    "delay": lambda g: (g.delay(1.0, g.repeat(R, 3)), None, None),
    "stagger": lambda g: (g.stagger(0.1, g.repeat(R, 50),
                                    rng=random.Random(0)), None, None),
    "sleep": lambda g: ([g.sleep(5.0), R], None, None),
    "time_limit": lambda g: (g.time_limit(1.0, g.delay(0.3, g.cycle(R))),
                             None, None),
    "then": lambda g: (g.then({"f": "a", "value": None},
                              {"f": "b", "value": None}), None, None),
    "mix": lambda g: (g.limit(60, g.mix([_op("a"), _op("b")],
                                        rng=random.Random(42))), None, None),
    "mix-exhausted": lambda g: (g.mix([{"f": "a", "value": None},
                                       {"f": "b", "value": None}],
                                      rng=random.Random(7)), None, None),
    "any_gen": lambda g: (g.any_gen([g.sleep(5.0), {"f": "slow",
                                                    "value": None}],
                                    {"f": "fast", "value": None}),
                          None, None),
    "any_gen-deadline": lambda g: (g.any_gen(
        [g.sleep(1.0), {"f": "late", "value": None}],
        g.limit(30, g.stagger(0.1, g.cycle({"f": "fast", "value": None}),
                              rng=random.Random(1)))), None, None),
    "flip_flop": lambda g: (g.limit(4, g.flip_flop(
        g.cycle({"f": "a", "value": None}),
        g.cycle({"f": "b", "value": None}))), None, None),
    "filter_gen": lambda g: (g.limit(3, g.filter_gen(
        lambda op: op["value"] % 2 == 0, _counter())), None, None),
    "f_map": lambda g: (g.f_map(lambda op: dict(op, value=99),
                                {"f": "w", "value": 1}), None, None),
    "until_ok": lambda g: (g.until_ok(g.cycle(R)), None, None),
    "until_ok-crashes": lambda g: (g.until_ok(g.cycle(R)),
                                   {"concurrency": 3}, _crash_p0),
    "clients": lambda g: (g.clients(g.limit(6, _op("r"))), None, None),
    "nemesis": lambda g: (g.nemesis(g.limit(2, _op("start"))), None, None),
    "clients+nemesis": lambda g: (g.any_gen(
        g.clients(g.limit(8, _op("r"))),
        g.nemesis(g.limit(2, g.delay(0.005, g.cycle(
            {"f": "start-partition", "value": None}))))),
        {"concurrency": 3}, None),
    "reserve": lambda g: (g.limit(40, g.reserve(
        2, g.cycle({"f": "a", "value": None}),
        g.cycle({"f": "b", "value": None}))), {"concurrency": 4}, None),
    "on_threads": lambda g: (g.on_threads(
        lambda t: t in (1, 2), g.limit(9, _op("r"))),
        {"concurrency": 4}, None),
    "synchronize": lambda g: (g.clients([
        g.limit(5, _op("a")), g.synchronize(g.limit(3, _op("b")))]),
        {"concurrency": 3}, None),
    "phases": lambda g: (g.phases(
        g.clients(g.each_thread({"f": "a", "value": None})),
        g.clients(g.each_thread({"f": "b", "value": None}))),
        {"concurrency": 3}, None),
    "each_thread": lambda g: (g.clients(g.each_thread(
        {"f": "w", "value": 1})), {"concurrency": 3}, None),
    "each_thread-deadline": lambda g: (g.any_gen(
        g.clients(g.each_thread([g.sleep(1.0),
                                 {"f": "late", "value": None}])),
        g.limit(30, g.stagger(0.1, g.cycle({"f": "fast", "value": None}),
                              rng=random.Random(2)))),
        {"concurrency": 3}, None),
    "info-crash": lambda g: (g.limit(6, _op("r")), {"concurrency": 2},
                             _crash_p0),
    "log": lambda g: ([g.log("phase one"), g.limit(2, _op("r"))], None,
                      None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_simulated_events_equal_to_jax(name):
    runs = []
    for g, sim in ((jg, jsim), (tg, tsim)):
        gen, test, complete = CASES[name](g)
        runs.append(sim.simulate(gen, test or {"concurrency": 2},
                                 complete=complete))
    want, got = runs
    assert got == want
    assert tsim.invokes(got) == jsim.invokes(want)
    assert tsim.completions(got) == jsim.completions(want)
    assert got, name


def _context_facts(mod):
    ctx = mod.Context.make(3)
    ctx2 = ctx.busy_thread(0).with_next_process(0, 3)
    sub = ctx.restrict(lambda t: t == "nemesis")
    return (ctx.all_threads(), ctx.some_free_process(),
            ctx2.process_for_thread(0), ctx2.free_processes(),
            sub.all_threads(), sub.free_processes(),
            mod.context({"concurrency": 4}).all_processes())


def test_context_and_helpers_equal_to_jax():
    assert _context_facts(tctx) == _context_facts(jctx)
    assert tutils.__all__ == jutils.__all__
    for n in range(9):
        assert (tucore.majority(n), tucore.minority(n)) == \
            (jucore.majority(n), jucore.minority(n))
    for spec in ({"distribution": "constant", "value": 3},
                 {"distribution": "uniform", "min": 1, "max": 2},
                 {"distribution": "exponential", "mean": 4},
                 {"distribution": "zipf", "n": 9, "skew": 1.5}):
        assert [tucore.rand_distribution(spec, random.Random(s))
                for s in range(5)] == \
            [jucore.rand_distribution(spec, random.Random(s))
             for s in range(5)]
    ops = [type("O", (), {"f": f})() for f in
           ("start", "r", "stop", "kill", "heal", "start")]
    assert [(ops.index(a), b and ops.index(b))
            for a, b in tucore.nemesis_intervals(ops)] == \
        [(ops.index(a), b and ops.index(b))
         for a, b in jucore.nemesis_intervals(ops)]
    assert tucore.timeout(5, lambda: 7) == jucore.timeout(5, lambda: 7)
    assert tucore.timeout(0.01, lambda: __import__("time").sleep(1),
                          on_timeout="late") == "late"
    with pytest.raises(tucore.TimeoutError_):
        tucore.timeout(0.01, lambda: __import__("time").sleep(1))
    assert isinstance(tucore.fcatch(lambda: 1 / 0)(), ZeroDivisionError)
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise ValueError("not yet")
        return len(tries)

    assert tucore.with_retry(flaky, retries=3, backoff=0.0) == 3
