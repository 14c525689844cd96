"""Port parity for the demo workloads of `python -m jepsen_tpu_torch`
(`__main__._wl` / `DEMOS`) and their modules: `workloads/
linearizable_register.py`, `bank.py`, `long_fork.py`, `write_skew.py`,
`session.py`, `causal.py`, `sets.py`, `queue.py` and `kafka.py`'s
`final_gen`, `workload` and `FaultPlan` branch.

Tolerances: each demo's test map, run by each package's `core.run` at
concurrency 1 from the same seed, gives histories equal op for op with
`time` left aside (the only field read off the wall clock) and equal
result dicts; the port checks on the CPU (``--cpu``, so
``device="cpu"``), the JAX package as its own tests run it.  The one
exception is the ``algorithm`` key of ``lin-register``'s dict, which
names the winner of the Knossos race (`algorithm="auto"`); there the
rest of the dict is compared, and the same history through
``algorithm="wgl"`` gives equal whole dicts.  A run stored by one package
and analysed by the other gives the dict of the run.
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import __main__ as jmain  # noqa: E402
from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.generator import core as jg  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.models import cas_register as jcas  # noqa: E402
from jepsen_tpu.workloads import bank as jbank  # noqa: E402
from jepsen_tpu.workloads import kafka as jkafka  # noqa: E402
from jepsen_tpu.workloads import queue as jqueue  # noqa: E402
from jepsen_tpu_torch import __main__ as tmain  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.generator import core as tg  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.models import cas_register as tcas  # noqa: E402
from jepsen_tpu_torch.workloads import bank as tbank  # noqa: E402
from jepsen_tpu_torch.workloads import kafka as tkafka  # noqa: E402
from jepsen_tpu_torch.workloads import queue as tqueue  # noqa: E402

N_OPS = 300

JAX = dict(main=jmain, core=jcore, g=jg, store=jstore, opts={})
PORT = dict(main=tmain, core=tcore, g=tg, store=tstore, opts={"cpu": True})

#: the nine demos PR 9's run tests do not cover, each with its seed
NINE = ("lin-register", "bank", "long-fork", "set", "queue", "kafka",
        "causal", "write-skew", "session")
SEEDS = {name: 11 + i for i, name in enumerate(NINE)}

#: name -> (demo, seed, extra test-map keys): the injected runs
INJECTED = {
    "queue-dup": ("queue", 31, {"queue-adversary": {"dup-enqueue-p": 0.05}}),
    "queue-lose": ("queue", 32,
                   {"queue-adversary": {"lose-enqueue-p": 0.05}}),
    "queue-reorder-fifo": ("queue", 33, {"queue-adversary": {
        "reorder-dequeue-p": 0.2, "fifo": True}}),
    **{f"kafka-{site}": ("kafka", 40 + i, {"faults": {
        "seed": 5, "p": 0.1, "sites": [site]}})
       for i, site in enumerate(sorted(jkafka.ADVERSARY_SITES))},
}


def _test_map(pkg, demo, seed, base, extra=None, n_ops=N_OPS):
    """`DEMOS[demo]` of `pkg` as `test-all` builds it, at concurrency 1
    on one node, its generator cut to `n_ops` ops as ``--ops`` does."""
    opts = {"seed": seed, "nodes": ["n1"], "concurrency": 1,
            "store-dir": base, **pkg["opts"], **(extra or {})}
    t = pkg["main"].DEMOS[demo](opts)
    t["generator"] = pkg["g"].limit(n_ops, t["generator"])
    return t


def _ops(h):
    """An op history without its wall-clock times."""
    return [dict(dataclasses.asdict(op), time=None) for op in h]


def _race_free(demo, results):
    """The dict without the Knossos race's winner (lin-register)."""
    if demo != "lin-register":
        return results
    assert results["algorithm"] in ("wgl", "linear", "device"), results
    return {k: v for k, v in results.items() if k != "algorithm"}


def _run_both(tmp_path_factory, name, demo, seed, extra=None):
    base = tmp_path_factory.mktemp(name)
    return tuple(
        pkg["core"].run(_test_map(pkg, demo, seed, str(base / tag), extra))
        for tag, pkg in (("jax", JAX), ("port", PORT)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """demo -> (JAX run, port run), at concurrency 1 from one seed."""
    return {name: _run_both(tmp_path_factory, name, name, SEEDS[name])
            for name in NINE}


def test_demos_are_the_jax_eleven():
    assert list(tmain.DEMOS) == list(jmain.DEMOS)
    assert set(NINE) | {"append", "wr"} == set(tmain.DEMOS)


@pytest.mark.parametrize("name", NINE)
def test_concurrency_1_equal_op_for_op(runs, name):
    want, got = runs[name]
    assert len(got["history"]) == len(want["history"]) >= 2 * N_OPS
    assert _ops(got["history"]) == _ops(want["history"])
    assert _race_free(name, got["results"]) == \
        _race_free(name, want["results"])
    assert got["results"]["valid?"] is True, got["results"]
    for k in ("accounts", "total-amount", "kafka-key-count",
              "workload-kind"):
        assert got.get(k) == want.get(k), k
    assert os.path.exists(os.path.join(tstore.test_dir(got), "jepsen.log"))


def test_lin_register_wgl_dicts_equal(runs):
    want, got = runs["lin-register"]
    a = japi.Linearizable(jcas(), algorithm="wgl").check(
        want, want["history"])
    b = tapi.Linearizable(tcas(), algorithm="wgl", device="cpu").check(
        got, got["history"])
    assert a == b and b["valid?"] is True


@pytest.mark.parametrize("name", ["bank", "queue", "kafka", "causal",
                                  "session", "long-fork"])
def test_stored_runs_cross_analyse(runs, name):
    want, got = runs[name]
    jdir, tdir = jstore.test_dir(want), tstore.test_dir(got)
    # a JAX run analysed by the port, and a port run by the JAX package
    by_port = tcore.analyze(jdir, checker=tmain.demo_checker(
        want["name"], cpu=True))
    by_jax = jcore.analyze(tdir, checker=jmain._wl(name, {})[0]["checker"])
    assert by_port["results"] == want["results"]
    assert by_jax["results"] == got["results"]


def test_bank_analyze_reads_the_stored_accounts(runs):
    want, got = runs["bank"]
    tdir = tstore.test_dir(got)
    stored = tstore.load(tdir)
    # the codec keeps the integer account ids of the test map
    assert stored["accounts"] == got["accounts"] == {i: 10 for i in range(8)}
    assert stored["total-amount"] == 80
    again = tcore.analyze(tdir, checker=tmain.demo_checker("demo-bank",
                                                           cpu=True))
    by_jax = jcore.analyze(tdir, checker=jbank.BankChecker())
    assert again["results"] == by_jax["results"] == got["results"]
    assert got["results"]["read-count"] > 0
    assert got["results"]["expected-total"] == 80


@pytest.fixture(scope="module")
def injected(tmp_path_factory):
    return {name: _run_both(tmp_path_factory, name, demo, seed, extra)
            for name, (demo, seed, extra) in INJECTED.items()}


#: the anomaly each injection must show
INJECTED_ANOMALY = {
    "queue-dup": "queue-phantom", "queue-lose": "queue-lost",
    "queue-reorder-fifo": "queue-fifo-violation",
    "kafka-client.dup-send": "duplicate",
    "kafka-client.zombie-resend": "duplicate",
    "kafka-client.torn-send": "lost-write",
    "kafka-client.reorder-send": "int-send-skip",
}


@pytest.mark.parametrize("name", list(INJECTED))
def test_injected_runs_equal(injected, name):
    want, got = injected[name]
    assert _ops(got["history"]) == _ops(want["history"])
    assert got["results"] == want["results"]
    assert got["results"]["valid?"] is False, got["results"]
    assert INJECTED_ANOMALY[name] in got["results"]["anomaly-types"], \
        got["results"]


def test_kafka_fault_plan_fires_per_member_and_op():
    """`_adversary` consults only the sites a plan names, at the index
    ``member * _FAULT_STRIDE + op-ordinal``, in both packages."""
    for mod in (jkafka, tkafka):
        assert mod._FAULT_STRIDE == 1_000_003
    assert tkafka.ADVERSARY_SITES == jkafka.ADVERSARY_SITES
    spec = {"seed": 3, "p": 0.3, "sites": ["client.dup-send",
                                           "client.torn-send"]}
    shapes = {}
    for tag, mod in (("jax", jkafka), ("port", tkafka)):
        c = mod.KafkaClient(mod.KafkaStore()).open({}, "n1")
        test = {"faults": dict(spec)}
        shapes[tag] = [sorted(c._adversary(test)) for _ in range(60)]
        # no plan, no draw: the probability knobs are 0
        assert c._adversary({}) == set() and c._op_n == 61
    assert shapes["port"] == shapes["jax"]
    fired = {s for ss in shapes["port"] for s in ss}
    assert fired == {"dup-send", "torn-send"}


def test_kafka_workload_and_final_gen():
    for mod in (jkafka, tkafka):
        wl = mod.workload(key_count=3)
        assert wl["kafka-key-count"] == 3 and wl["workload-kind"] == "kafka"
        assert "final-generator" in wl
    assert tkafka.workload(device="cpu")["checker"].device == "cpu"


def test_queue_drain_stops_on_empty_only():
    for mod in (jqueue, tqueue):
        assert mod._is_empty_fail({"type": "fail", "f": "dequeue",
                                   "error": "Empty"})
        assert not mod._is_empty_fail({"type": "fail", "f": "dequeue",
                                       "error": "aborted"})
        assert not mod._is_empty_fail({"type": "ok", "f": "dequeue"})


@pytest.mark.parametrize("name", NINE)
def test_demo_checker_takes_the_device(name):
    t = tmain.demo_checker(f"demo-{name}", cpu=True)
    d = tmain.demo_checker(f"demo-{name}")
    if name == "set":
        # the set checkers are host scans
        assert not hasattr(t, "device") and not hasattr(d, "device")
    else:
        assert t.device == "cpu" and d.device is None
    assert type(t).__name__ == type(
        jmain._wl(name, {})[0]["checker"]).__name__


def test_bank_workload_keys_equal_to_jax():
    for n, total in ((8, 80), (3, 10)):
        a, b = jbank.workload(n_accounts=n, total=total), \
            tbank.workload(n_accounts=n, total=total)
        assert a["accounts"] == b["accounts"]
        assert a["total-amount"] == b["total-amount"] == \
            sum(b["accounts"].values())


def test_bank_checker_rules_equal_to_jax():
    """`tests/test_workloads.py`'s bank rules: a wrong total, a negative
    balance unless allowed, and the modal total with no test map."""
    cases = [
        ({"total-amount": 20}, [{0: 10, 1: 10}, {0: 10, 1: 5}], False),
        ({"total-amount": 20}, [{0: 25, 1: -5}], False),
        ({"total-amount": 20}, [{0: 25, 1: -5}], True),
        ({}, [{0: 10, 1: 10}, {0: 15, 1: 10}, {0: 10, 1: 10}], False),
    ]
    for test, reads, neg_ok in cases:
        out = []
        for ops, mod, kw in ((jops, jbank, {}),
                             (tops, tbank, {"device": "cpu"})):
            h = ops.history([e for r in reads for e in (
                ops.invoke(0, "read", None), ops.ok(0, "read", r))])
            out.append(mod.BankChecker(negative_balances_ok=neg_ok, **kw)
                       .check(test, h))
        assert out[0] == out[1]
    assert out[1]["valid?"] is False and out[1]["bad-read-count"] == 1
    assert out[1]["bad-reads"][0]["total"] == 25


def test_no_card_records_unknown_for_each_family(tmp_path, monkeypatch):
    """Without ``--cpu`` and with no card, every device checker's result
    is valid? unknown naming `NoDeviceError`.  The set demo checks on the
    host, and the Knossos race of a history of at most
    `HOST_FIRST_MAX_OPS` ops asks the card only when both host legs say
    unknown, so those two stay valid."""
    from jepsen_tpu_torch.checkers.knossos import competition

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in NINE:
        t = _test_map(PORT, name, SEEDS[name], str(tmp_path), n_ops=20)
        t["checker"] = tmain.demo_checker(t["name"])
        done = tcore.run(t)
        r = done["results"]
        if name in ("set", "lin-register"):
            assert r["valid?"] is True, r
            assert len(done["history"]) <= competition.HOST_FIRST_MAX_OPS
        else:
            assert r["valid?"] == "unknown", (name, r)
            assert "NoDeviceError" in r["error"], (name, r)
    with pytest.raises(backend.NoDeviceError):
        backend.resolve(None)
