"""Port parity for the native host library (`jepsen_tpu_torch/native`).

The port's C++ source is a byte-for-byte copy of the JAX package's, built
by its own loader into `build/`.  `scc`, `bfs_cycle` and `wgl` must give
the JAX package's `jepsen_tpu.native` outputs on the corpora of
`tests/test_native.py`: labels, paths, verdict, `explored`, and the abort
flag stopping a search.  A compiler that is missing or fails raises
`NativeError` (the JAX loader returns None there and its callers run
Python), and `JT_NO_NATIVE` sends `tarjan_scc` and `wgl.check` to their
Python bodies in both packages.
"""

import filecmp
import os
import random

import numpy as np
import pytest

from jepsen_tpu import native as jnative
from jepsen_tpu.checkers.elle import graph as jgraph
from jepsen_tpu.checkers.knossos import memo as jmemo
from jepsen_tpu.checkers.knossos import prep as jprep
from jepsen_tpu.checkers.knossos import wgl as jwgl
from jepsen_tpu.history import ops as jops
from jepsen_tpu import models as jmodels
from jepsen_tpu_torch import native as tnative
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checkers.elle import graph as tgraph
from jepsen_tpu_torch.checkers.knossos import memo as tmemo
from jepsen_tpu_torch.checkers.knossos import prep as tprep
from jepsen_tpu_torch.checkers.knossos import wgl as twgl
from jepsen_tpu_torch.checkers.knossos.search import Search
from jepsen_tpu_torch.history import ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_graph(rng):
    n = rng.randint(1, 60)
    m = rng.randint(0, 3 * n)
    src = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int64)
    dst = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int64)
    return n, src, dst


#: the graphs of tests/test_native.py: (n, src, dst)
GRAPHS = {
    "simple-cycle": (4, [0, 1, 2, 3], [1, 2, 0, 3]),
    "dead-end": (4, [0, 1, 2, 2], [1, 2, 0, 3]),
    "path": (3, [0, 1], [1, 2]),
    "two-cycles": (4, [0, 1, 0, 2, 3], [1, 0, 2, 3, 0]),
    "ring-50": (50, list(range(50)), list(range(1, 50)) + [0]),
    "empty": (0, [], []),
}


def test_source_is_a_byte_copy():
    assert filecmp.cmp(
        os.path.join(REPO, "jepsen_tpu/native/src/jepsen_native.cpp"),
        os.path.join(REPO, "jepsen_tpu_torch/native/src/jepsen_native.cpp"),
        shallow=False)


def test_library_is_the_ports_own_build():
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR
    assert so.name.startswith("libjt_native_") and so.suffix == ".so"
    assert "jepsen_tpu/native" not in str(tnative.lib()._name)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_scc_equal(name):
    n, src, dst = GRAPHS[name]
    src, dst = np.array(src, np.int64), np.array(dst, np.int64)
    np.testing.assert_array_equal(tnative.scc(n, src, dst),
                                  jnative.scc(n, src, dst))


@pytest.mark.parametrize("seed", range(5))
def test_scc_equal_random(seed):
    rng = random.Random(42 + seed)
    for _ in range(5):
        n, src, dst = _random_graph(rng)
        np.testing.assert_array_equal(tnative.scc(n, src, dst),
                                      jnative.scc(n, src, dst))


def test_scc_big_path_equal():
    n = 100_000
    src = np.arange(n, dtype=np.int64)
    dst = np.roll(src, -1)
    got = tnative.scc(n, src, dst)
    assert (got == got[0]).all()
    np.testing.assert_array_equal(got, jnative.scc(n, src, dst))


@pytest.mark.parametrize("case", [
    ("simple-cycle", 0, None, 4096), ("dead-end", 0, None, 4096),
    ("path", 0, None, 4096), ("two-cycles", 0, [1, 0, 1, 1], 4096),
    ("two-cycles", 0, None, 4096), ("ring-50", 0, None, 4),
    ("ring-50", 7, None, 4096), ("empty", 0, None, 4096)])
def test_bfs_cycle_equal(case):
    name, start, mask, max_len = case
    n, src, dst = GRAPHS[name]
    m = None if mask is None else np.array(mask, np.uint8)
    got = tnative.bfs_cycle(n, np.array(src), np.array(dst), start, mask=m,
                            max_len=max_len)
    want = jnative.bfs_cycle(n, np.array(src), np.array(dst), start, mask=m,
                             max_len=max_len)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def _wgl_inputs(events, model):
    """One hand-built history as (JAX memo and ops, port memo and ops)."""
    jh = jops.history([getattr(jops, t)(p, f, v) for t, p, f, v in events])
    th = tops.history([getattr(tops, t)(p, f, v) for t, p, f, v in events])
    jo, to = jprep.prepare(jh), tprep.prepare(th)
    return (jo, jmemo.memoize(getattr(jmodels, model)(), jo)), \
        (to, tmemo.memoize(getattr(tmodels, model)(), to))


def _native_args(ops, memo, never):
    return (memo.op_sym, [o.invoke_pos for o in ops],
            [o.return_pos for o in ops], never, memo.table, memo.init_state)


#: the WGL corpora of tests/test_native.py (the abort corpus below)
WGL = {
    "valid-register": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", 1)]),
    "invalid-register": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 0, "read", None), ("ok", 0, "read", 2)]),
    "info-may-not-linearize": ("register", [
        ("invoke", 0, "write", 1), ("info", 0, "write", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", None)]),
}


def _random_cas(seed):
    """tests/test_native.py's random concurrent cas-register histories."""
    rng = random.Random(seed)
    vals = [None, 0, 1, 2]
    events = []
    for p in range(3):
        for _ in range(rng.randint(1, 3)):
            kind = rng.choice(["read", "write", "cas"])
            if kind == "read":
                v = rng.choice(vals)
            elif kind == "write":
                v = rng.choice([0, 1, 2])
            else:
                v = [rng.choice([0, 1, 2]), rng.choice([0, 1, 2])]
            events.append((p, kind, v))
    rng.shuffle(events)
    out = []
    for p, kind, v in events:
        out.append(("invoke", p, kind, v))
        out.append((rng.choice(["ok", "ok", "ok", "info"]), p, kind, v))
    return "cas_register", out


for _s in range(10):
    WGL[f"random-cas-{_s}"] = _random_cas(7 + _s)


@pytest.mark.parametrize("name", sorted(WGL))
def test_wgl_equal(name, monkeypatch):
    monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    model, events = WGL[name]
    (jo, jm), (to, tm) = _wgl_inputs(events, model)
    never = 2 * len(events) + 1
    for budget in (5_000_000, 2):
        assert tnative.wgl(*_native_args(to, tm, never), budget) == \
            jnative.wgl(*_native_args(jo, jm, never), budget)
    # and the whole check, on the native path and on the Python one
    assert twgl.check(to, getattr(tmodels, model)()) == \
        jwgl.check(jo, getattr(jmodels, model)())
    monkeypatch.setenv("JT_NO_NATIVE", "1")
    assert twgl.check(to, getattr(tmodels, model)()) == \
        jwgl.check(jo, getattr(jmodels, model)())


def _wide_invalid(n=18):
    """n fully concurrent writes, then a read of a value never written:
    the search must explore every order before it can say False."""
    events = [("invoke", i, "write", i) for i in range(n)]
    events += [("ok", i, "write", i) for i in range(n)]
    events += [("invoke", n, "read", None), ("ok", n, "read", 777)]
    return events


def test_wgl_abort_flag_stops_the_search():
    events = _wide_invalid()
    (jo, jm), (to, tm) = _wgl_inputs(events, "cas_register")
    never = 2 * len(events) + 1
    ctl = Search()
    ctl.abort()
    got = tnative.wgl(*_native_args(to, tm, never), 50_000_000,
                      abort_flag=ctl.flag)
    verdict, explored, aborted = got
    assert aborted is True and verdict is None and explored < 10_000
    jflag = np.ones(1, np.int32)
    assert got == jnative.wgl(*_native_args(jo, jm, never), 50_000_000,
                              abort_flag=jflag)
    with pytest.raises(TypeError):
        tnative.wgl(*_native_args(to, tm, never), 10,
                    abort_flag=np.zeros(1, np.int64))


def test_wgl_check_summary_and_budget_equal(monkeypatch):
    """An invalid search above 200,000 configs keeps the summary shape
    (op-count, explored) in both packages; an exhausted budget names
    `explored`; an aborted search says so."""
    monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    events = _wide_invalid(16)
    (jo, _), (to, _) = _wgl_inputs(events, "cas_register")
    want = jwgl.check(jo, jmodels.cas_register())
    assert want["valid?"] is False and "explored" in want["final-info"]
    assert twgl.check(to, tmodels.cas_register()) == want
    for budget in (1, 1000):
        assert twgl.check(to, tmodels.cas_register(), max_configs=budget) \
            == jwgl.check(jo, jmodels.cas_register(), max_configs=budget)
    ctl = Search()
    ctl.abort()
    got = twgl.check(to, tmodels.cas_register(), ctl=ctl)
    assert got["valid?"] == "unknown" and got["reason"] == "aborted", got


def test_calls_counted():
    tnative.CALLS = 0
    tnative.scc(3, np.array([0, 1]), np.array([1, 0]))
    tnative.bfs_cycle(3, np.array([0, 1]), np.array([1, 0]), 0)
    assert tnative.CALLS == 2


@pytest.mark.parametrize("setting", ["native", "python"])
def test_no_native_routes_both_packages(setting, monkeypatch):
    """`JT_NO_NATIVE` picks the Python bodies in both packages, and
    unset, the port calls its library (counted) where the JAX package
    calls its own."""
    if setting == "python":
        monkeypatch.setenv("JT_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    rng = random.Random(3)
    tnative.CALLS = 0
    for _ in range(4):
        n, src, dst = _random_graph(rng)
        np.testing.assert_array_equal(tgraph.tarjan_scc(n, src, dst),
                                      jgraph.tarjan_scc(n, src, dst))
    model, events = WGL["invalid-register"]
    (jo, _), (to, _) = _wgl_inputs(events, model)
    assert twgl.check(to, tmodels.register()) == \
        jwgl.check(jo, jmodels.register())
    assert tnative.CALLS == (5 if setting == "native" else 0)


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The loader with nothing loaded and an empty build directory."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_missing_compiler_raises(fresh_loader, monkeypatch):
    monkeypatch.setattr(tnative, "CXX",
                        str(fresh_loader / "no-such-compiler"))
    with pytest.raises(tnative.NativeError, match="not usable"):
        tnative.scc(2, np.array([0]), np.array([1]))
    # and the checkers let it through: nothing runs Python instead
    monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    with pytest.raises(tnative.NativeError):
        tgraph.tarjan_scc(2, np.array([0]), np.array([1]))
    model, events = WGL["valid-register"]
    _, (to, _) = _wgl_inputs(events, model)
    with pytest.raises(tnative.NativeError):
        twgl.check(to, tmodels.register())


def test_failed_build_raises(fresh_loader, monkeypatch):
    src = tnative.SRC
    bad = fresh_loader / "broken.cpp"
    bad.write_text("extern \"C\" int jt_scc( {\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    with pytest.raises(tnative.NativeError, match="failed"):
        tnative.lib()
    assert not list((fresh_loader / "build").glob("*.so"))
    # a compiler that runs and fails is no better
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "CXX", "false")
    with pytest.raises(tnative.NativeError):
        tnative.wgl([0], [0], [1], 3, np.zeros((1, 1), np.int32), 0)


def test_unloadable_library_raises(fresh_loader, monkeypatch):
    so = tnative.BUILD_DIR / f"libjt_native_{tnative._digest(tnative.CXX)}.so"
    so.parent.mkdir(parents=True)
    so.write_bytes(b"not a shared object")
    with pytest.raises(tnative.NativeError, match="loading"):
        tnative.lib()


def test_digest_keys_compiler_version(monkeypatch):
    """Another compiler version gives another library name."""
    d = tnative._digest(tnative.CXX)
    monkeypatch.setattr(tnative, "compiler_version",
                        lambda cxx: "g++ (another) 99.0\n")
    assert tnative._digest(tnative.CXX) != d
