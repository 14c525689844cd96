"""Port parity for the checker API (`jepsen_tpu_torch/checkers/api.py`).

Each case builds one history in each package (the same events, or the
JAX history carried over op for op) and runs the JAX checker and the
port's on it.  The result dicts must be equal: the built-in history
checkers, `Stats` (whose JAX columnar branch the port answers with its
per-op loop), `compose`, `check_safe`'s deadline and crash results, and
`Linearizable` / `QueueChecker` with their device leg on the CPU.  Where
a competition decides the winner (`algorithm="auto"`), only the verdict
is compared.
"""

import dataclasses
import os
import random

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import models as jmodels  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import checkers as tcheckers  # noqa: E402
from jepsen_tpu_torch import models as tmodels  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.ir import HistoryIR  # noqa: E402
from jepsen_tpu_torch.resilience import Deadline  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402


@pytest.fixture(autouse=True, params=["native", "no-native"])
def _no_native(request, monkeypatch):
    """Every case runs twice: with `JT_NO_NATIVE` unset, both packages
    run their C++ WGL and Tarjan (the JAX package's default path), and
    with it set, both run the Python searches."""
    if request.param == "native":
        monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("JT_NO_NATIVE", "1")


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def both(*events):
    """(type, process, f, value[, error]) tuples as one history per
    package."""
    def mk(mod):
        return mod.history([getattr(mod, e[0])(e[1], e[2], e[3],
                                               **({"error": e[4]}
                                                  if len(e) > 4 else {}))
                            for e in events])
    return mk(jops), mk(tops)


#: the corpora of tests/test_checker_api.py, and more of each checker
CORPORA = {
    "queue-info-enqueue": [
        ("invoke", 0, "enqueue", 1), ("info", 0, "enqueue", 1)],
    "queue-lost-unexpected": [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 7)],
    "queue-valid": [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "enqueue", 2), ("invoke", 2, "dequeue", None),
        ("ok", 1, "enqueue", 2), ("ok", 2, "dequeue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 1)],
    "set": [
        ("invoke", 0, "add", 1), ("ok", 0, "add", 1),
        ("invoke", 1, "add", 2), ("ok", 1, "add", 2),
        ("invoke", 2, "add", 3), ("fail", 2, "add", 3),
        ("invoke", 0, "read", None), ("ok", 0, "read", [1])],
    "set-stale": [
        ("invoke", 0, "add", 1), ("ok", 0, "add", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", []),
        ("invoke", 1, "add", 2), ("info", 1, "add", 2, "timeout"),
        ("invoke", 2, "read", None), ("ok", 2, "read", [1, 2])],
    "counter": [
        ("invoke", 0, "add", 1), ("ok", 0, "add", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", 1),
        ("invoke", 0, "add", 2), ("info", 0, "add", 2),
        ("invoke", 1, "read", None), ("ok", 1, "read", 3),
        ("invoke", 2, "read", None), ("ok", 2, "read", 1),
        ("invoke", 3, "read", None), ("ok", 3, "read", 9)],
    "counter-fail": [
        ("invoke", 0, "add", 5), ("fail", 0, "add", 5),
        ("invoke", 1, "add", -2), ("invoke", 2, "read", None),
        ("ok", 2, "read", -2), ("ok", 1, "add", -2)],
    "stats": [
        ("invoke", 0, "txn", None), ("ok", 0, "txn", None),
        ("invoke", 1, "cas", None), ("fail", 1, "cas", None)],
    "uids": [
        ("invoke", 0, "generate", None), ("ok", 0, "generate", 1),
        ("invoke", 1, "generate", None), ("ok", 1, "generate", 2),
        ("invoke", 0, "generate", None), ("ok", 0, "generate", 1),
        ("invoke", 2, "generate", None), ("ok", 2, "generate", [3]),
        ("invoke", 3, "generate", None),
        ("info", 3, "generate", None, "crash")],
    "empty-ish": [
        ("invoke", 0, "read", None), ("info", 0, "read", None, "down")],
}

CHECKERS = {
    "stats": lambda api: api.Stats(),
    "total-queue": lambda api: api.TotalQueueChecker(),
    "set": lambda api: api.SetChecker(),
    "set-full": lambda api: api.SetFullChecker(),
    "counter": lambda api: api.CounterChecker(),
    "unique-ids": lambda api: api.UniqueIds(),
    "unhandled": lambda api: api.UnhandledExceptions(),
    "concurrency-1": lambda api: api.ConcurrencyLimit(1),
    "noop": lambda api: api.NoopChecker(),
}


def outcome(chk, h):
    """`chk.check` on `h`, or the exception it raised (a checker given
    another workload's history may raise; the port raises alike)."""
    try:
        return chk.check({}, h)
    except Exception as e:  # noqa: BLE001 — compared, not swallowed
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("checker", sorted(CHECKERS))
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_builtin_checkers_equal(corpus, checker):
    jh, th = both(*CORPORA[corpus])
    assert outcome(CHECKERS[checker](japi), jh) == \
        outcome(CHECKERS[checker](tapi), th)


def test_stats_past_the_columnar_cut_equal():
    """From `COLUMNAR_MIN` ops the JAX `Stats` takes its columnar fold;
    the port's per-op loop gives the same dict."""
    rng = random.Random(0)
    events = []
    for i in range(japi.Stats.COLUMNAR_MIN // 2 + 8):
        f = rng.choice(["read", "write", "cas"])
        events.append(("invoke", i % 7, f, None))
        events.append((rng.choice(["ok", "ok", "fail", "info"]), i % 7, f,
                       None))
    jh, th = both(*events)
    assert len(jh) >= japi.Stats.COLUMNAR_MIN
    assert japi.Stats().check({}, jh) == tapi.Stats().check({}, th)


def test_compose_equal():
    jh, th = both(*CORPORA["stats"])
    a = japi.check_safe(japi.compose({"stats": japi.Stats(),
                                      "uids": japi.UniqueIds()}), {}, jh)
    b = tapi.check_safe(tapi.compose({"stats": tapi.Stats(),
                                      "uids": tapi.UniqueIds()}), {}, th)
    assert a == b and b["valid?"] is False
    assert tcheckers.compose is tapi.compose
    assert tcheckers.check_safe is tapi.check_safe
    assert tcheckers.Checker is tapi.Checker


def test_compose_shares_one_history_ir():
    seen = []

    class Probe(tapi.Checker):
        def check(self, test, history, opts=None):
            seen.append(history)
            return {"valid?": True}

    _, th = both(*CORPORA["set"])
    r = tapi.compose({"a": Probe(), "b": Probe()}).check({}, th)
    assert r == {"valid?": True, "a": {"valid?": True},
                 "b": {"valid?": True}}
    assert isinstance(seen[0], HistoryIR) and seen[0] is seen[1]
    assert seen[0].ops is th.ops


@pytest.mark.parametrize("vs,want", [
    ([True, True], True), ([True, "unknown"], "unknown"),
    (["unknown", False], False), ([], True)])
def test_merge_valid_equal(vs, want):
    assert japi._merge_valid(vs) == tapi._merge_valid(vs) == want


def test_fn_checker_and_log_file_pattern_equal(tmp_path):
    fn = lambda test, h, opts: {"valid?": len(h) > 2}  # noqa: E731
    jh, th = both(*CORPORA["set"])
    assert japi.checker(fn, "len").check({}, jh) == \
        tapi.checker(fn, "len").check({}, th)
    assert tapi.checker(fn, "len").name() == "len"
    for node, text in (("n1", "ok\nPANIC: disk\n"), ("n2", "fine\n")):
        os.makedirs(tmp_path / node)
        (tmp_path / node / "db.log").write_text(text)
    test = {"store-dir": str(tmp_path)}
    a = japi.LogFilePattern("PANIC", "db.log").check(test, jh)
    b = tapi.LogFilePattern("PANIC", "db.log").check(test, th)
    assert a == b and b["valid?"] is False and b["count"] == 1


# ------------------------------------------------------------ check_safe


def test_check_safe_creates_deadline_from_test_map():
    seen = {}

    class Slow(tapi.Checker):
        def check(self, test, history, opts=None):
            seen["deadline"] = (opts or {}).get("deadline")
            seen["deadline"].check("slow-checker")
            return {"valid?": True}

    res = tapi.check_safe(Slow(), {"checker-time-limit": 0.0}, [], None)
    assert isinstance(seen["deadline"], Deadline)
    assert res == {"valid?": "unknown", "checker": "Slow",
                   "error": "deadline-exceeded"}


def test_check_safe_composed_checkers_share_one_deadline():
    seen = []

    class Probe(tapi.Checker):
        def check(self, test, history, opts=None):
            seen.append((opts or {}).get("deadline"))
            return {"valid?": True}

    chk = tapi.compose({"a": Probe(), "b": Probe()})
    res = tapi.check_safe(chk, {"checker-time-limit": 30.0}, [], None)
    assert res["valid?"] is True
    assert len(seen) == 2 and seen[0] is seen[1] is not None


def test_check_safe_no_limit_no_deadline():
    seen = {}

    class Probe(tapi.Checker):
        def check(self, test, history, opts=None):
            seen["opts"] = opts
            return {"valid?": True}

    tapi.check_safe(Probe(), {}, [], None)
    assert not (seen["opts"] or {}).get("deadline")


def test_deadline_resolve_rule():
    dl = Deadline(5.0)
    assert Deadline.resolve({"deadline": dl}, {"checker-time-limit": 1})\
        is dl
    assert Deadline.resolve({"time-limit": 2}, {"checker-time-limit": 99})\
        .remaining() <= 2
    assert Deadline.resolve(None, {"checker-time-limit": 3}).remaining() \
        <= 3
    assert Deadline.resolve({}, {}) is None
    assert Deadline.resolve(None, None) is None


def test_crashing_checker_is_unknown_with_its_name():
    class Boom(tapi.Checker):
        def check(self, test, history, opts=None):
            raise ZeroDivisionError("bad denominator")

    class BadName(Boom):
        def name(self):
            raise RuntimeError("no name")

    res = tapi.check_safe(Boom(), {}, [], None)
    assert res["valid?"] == "unknown" and res["checker"] == "Boom"
    assert "ZeroDivisionError: bad denominator" in res["error"]
    res = tapi.check_safe(BadName(), {}, [], None)
    assert res["checker"] == "BadName"
    out = tapi.check_safe(tapi.compose({"boom": Boom(),
                                        "ok": tapi.NoopChecker()}), {}, [])
    assert out["valid?"] == "unknown" and out["boom"]["checker"] == "Boom"
    assert out["ok"] == {"valid?": True}


# ---------------------------------------- Linearizable and QueueChecker


@pytest.mark.parametrize("algorithm", ["wgl", "linear", "device"])
@pytest.mark.parametrize("seed", [0, 3])
def test_linearizable_equal(algorithm, seed):
    # the device search runs at its default 16,384-row frontier here, so
    # its history stays short
    kw = dict(n_ops=12 if algorithm == "device" else 40, concurrency=3,
              stale_read_prob=0.4 if seed else 0, seed=seed)
    jh = jsynth.lin_register_history(**kw)
    th = tsynth.lin_register_history(**kw)
    a = japi.check_safe(japi.Linearizable(jmodels.cas_register(),
                                          algorithm=algorithm), {}, jh, {})
    b = tapi.check_safe(tapi.Linearizable(tmodels.cas_register(),
                                          algorithm=algorithm,
                                          device="cpu"), {}, th, {})
    assert a == b


def test_linearizable_auto_and_model_from_test_map():
    for kw in (dict(n_ops=40, concurrency=3, seed=2),
               dict(n_ops=300, concurrency=4, seed=1),
               dict(n_ops=40, concurrency=3, stale_read_prob=0.4, seed=3)):
        jh = jsynth.lin_register_history(**kw)
        th = tsynth.lin_register_history(**kw)
        a = japi.Linearizable().check({}, jh, {})
        b = tapi.Linearizable(device="cpu").check({}, th, {})
        assert a["valid?"] == b["valid?"] != "unknown"
    jh, th = both(("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 1, "read", None), ("ok", 1, "read", 2))
    a = japi.Linearizable(algorithm="wgl").check(
        {"model": jmodels.register()}, jh, {})
    b = tapi.Linearizable(algorithm="wgl", device="cpu").check(
        {"model": tmodels.register()}, th, {})
    assert a == b and b["valid?"] is False


def test_linearizable_deadline_from_opts():
    kw = dict(n_ops=120, concurrency=5, stale_read_prob=0.25,
              info_prob=0.3, seed=5)
    th = tsynth.lin_register_history(**kw)
    res = tapi.check_safe(tapi.Linearizable(algorithm="device",
                                            device="cpu"),
                          {}, th, {"time-limit": 1.0})
    assert res["valid?"] == "unknown"
    assert res["error"] == "deadline-exceeded"


def test_linearizable_without_a_card_is_unknown_naming_the_error(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    th = tsynth.lin_register_history(n_ops=40, concurrency=3, seed=0)
    res = tapi.check_safe(tapi.Linearizable(algorithm="device"), {}, th)
    assert res["valid?"] == "unknown" and res["checker"] == "Linearizable"
    assert "NoDeviceError" in res["error"]


QUEUE = {
    "valid": [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "enqueue", 2), ("ok", 1, "enqueue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 1)],
    "phantom": [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 5)],
    "crashed-enqueue": [
        ("invoke", 0, "enqueue", 1), ("info", 0, "enqueue", 1),
        ("invoke", 1, "enqueue", 2), ("ok", 1, "enqueue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 1),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 2)],
}


@pytest.mark.parametrize("case", sorted(QUEUE))
def test_queue_checker_equal(case, monkeypatch):
    from jepsen_tpu.checkers.knossos import memo as jmemo
    from jepsen_tpu_torch.checkers.knossos import memo as tmemo

    # the unordered queue's states are unbounded: both packages explode
    # the memo and take the direct DFS, sooner under a lower cap
    monkeypatch.setattr(jmemo.memoize, "__defaults__", (500,))
    monkeypatch.setattr(tmemo.memoize, "__defaults__", (500,))
    jh, th = both(*QUEUE[case])
    a = japi.QueueChecker().check({}, jh, {})
    b = tapi.QueueChecker(device="cpu").check({}, th, {})
    assert a["valid?"] == b["valid?"] != "unknown"
    assert b["valid?"] is (case != "phantom")


def test_compose_linearizable_and_stats_equal():
    kw = dict(n_ops=60, concurrency=4, seed=4)
    jh = jsynth.lin_register_history(**kw)
    th = tsynth.lin_register_history(**kw)
    a = japi.check_safe(japi.compose({
        "linear": japi.Linearizable(jmodels.cas_register(),
                                    algorithm="linear"),
        "stats": japi.Stats()}), {}, jh, {})
    b = tapi.check_safe(tapi.compose({
        "linear": tapi.Linearizable(tmodels.cas_register(),
                                    algorithm="linear", device="cpu"),
        "stats": tapi.Stats()}), {}, th, {})
    assert a == b and b["valid?"] is True
    # the carried-over JAX history checks alike
    assert tapi.Linearizable(algorithm="linear", device="cpu").check(
        {}, carry(jh), {}) == b["linear"]
