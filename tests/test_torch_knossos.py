"""Port parity for Knossos linearizability (`jepsen_tpu_torch/models`,
`jepsen_tpu_torch/checkers/knossos/`, `HistoryIR.lin_ops` and
`synth.lin_register_history`).

Each case builds its input once and runs the JAX function and the port's,
on the CPU, on it.  The tolerance is exact:

- models step to equal states (or both to `Inconsistent`, with the same
  message); `memoize` tables, `op_sym` and `n_states` are equal;
- `prepare` and `lin_register_history` give equal `LinOp` rows and ops;
- `wgl.check`, `linear.check`, `device_wgl.check`,
  `device_wgl._blocked_and_check` and `analysis` return equal dicts, with
  `JT_NO_NATIVE` unset (both packages' C++ WGL, the JAX default) and set
  (both packages' Python search);
- `_expand_block` returns the JAX arrays bit for bit, the port's int32
  words read through `.view(np.uint32)`.

The port's race rule is pinned too: a device leg that fails with a real
error makes `analysis` raise, and only a synthetic `FaultInjected` loses
the race as in the JAX package.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import models as jmodels  # noqa: E402
from jepsen_tpu.checkers.knossos import competition as jcomp  # noqa: E402
from jepsen_tpu.checkers.knossos import device_wgl as jdw  # noqa: E402
from jepsen_tpu.checkers.knossos import linear as jlinear  # noqa: E402
from jepsen_tpu.checkers.knossos import memo as jmemo  # noqa: E402
from jepsen_tpu.checkers.knossos import prep as jprep  # noqa: E402
from jepsen_tpu.checkers.knossos import wgl as jwgl  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import models as tmodels  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import competition as tcomp  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import device_wgl as tdw  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import linear as tlinear  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import memo as tmemo  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import prep as tprep  # noqa: E402
from jepsen_tpu_torch.checkers.knossos import wgl as twgl  # noqa: E402
from jepsen_tpu_torch.checkers.knossos.search import Search  # noqa: E402
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


def small_state_cap(monkeypatch, cap=500):
    """`memoize`'s default `max_states` lowered in both packages: queue
    models reach unboundedly many states, so memoizing them raises
    `StateExplosion` either way, and sooner under the lower cap."""
    monkeypatch.setattr(jmemo.memoize, "__defaults__", (cap,))
    monkeypatch.setattr(tmemo.memoize, "__defaults__", (cap,))


def both(*events):
    """One hand-built history in each package: `events` are
    (type, process, f, value) tuples."""
    jh = jops.history([getattr(jops, t)(p, f, v) for t, p, f, v in events])
    th = tops.history([getattr(tops, t)(p, f, v) for t, p, f, v in events])
    return jh, th


MODEL_NAMES = ["register", "cas_register", "mutex", "fifo_queue",
               "unordered_queue", "grow_only_set"]

#: the hand-built corpora of tests/test_knossos.py and tests/test_linear.py
HAND = {
    "trivial": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", 1)]),
    "stale-read": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 0, "write", 2), ("ok", 0, "write", 2),
        ("invoke", 1, "read", None), ("ok", 1, "read", 1)]),
    "concurrent-read": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "read", None), ("invoke", 0, "write", 2),
        ("ok", 1, "read", 2), ("ok", 0, "write", 2)]),
    "cas": ("cas_register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "cas", [1, 3]), ("ok", 1, "cas", [1, 3]),
        ("invoke", 2, "read", None), ("ok", 2, "read", 3)]),
    "cas-wrong-old": ("cas_register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "cas", [2, 3]), ("ok", 1, "cas", [2, 3])]),
    "failed-op": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "write", 9), ("fail", 1, "write", 9),
        ("invoke", 2, "read", None), ("ok", 2, "read", 1)]),
    "info-write-bad": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "write", 2), ("info", 1, "write", 2),
        ("invoke", 2, "read", None), ("ok", 2, "read", 7)]),
    "info-write-applied": ("register", [
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "write", 2), ("info", 1, "write", 2),
        ("invoke", 2, "read", None), ("ok", 2, "read", 2)]),
    "mutex": ("mutex", [
        ("invoke", 0, "acquire", None), ("ok", 0, "acquire", None),
        ("invoke", 1, "acquire", None),
        ("invoke", 0, "release", None), ("ok", 0, "release", None),
        ("ok", 1, "acquire", None)]),
    "mutex-bad": ("mutex", [
        ("invoke", 0, "acquire", None), ("ok", 0, "acquire", None),
        ("invoke", 1, "acquire", None), ("ok", 1, "acquire", None)]),
    "fifo": ("fifo_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 0, "enqueue", 2), ("ok", 0, "enqueue", 2),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 1),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 2)]),
    "fifo-bad": ("fifo_queue", [
        ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
        ("invoke", 0, "enqueue", 2), ("ok", 0, "enqueue", 2),
        ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 2)]),
    "linear-reorder": ("register", [
        ("invoke", 0, "write", 1), ("invoke", 1, "write", 2),
        ("ok", 1, "write", 2), ("ok", 0, "write", 1),
        ("invoke", 2, "read", None), ("ok", 2, "read", 1)]),
    "linear-info-late": ("register", [
        ("invoke", 0, "write", 5), ("info", 0, "write", 5),
        ("invoke", 1, "read", None), ("ok", 1, "read", None),
        ("invoke", 1, "read", None), ("ok", 1, "read", 5)]),
    "unordered-queue": ("unordered_queue", [
        ("invoke", 0, "enqueue", 1), ("invoke", 1, "enqueue", 2),
        ("ok", 0, "enqueue", 1), ("ok", 1, "enqueue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 2),
        ("invoke", 2, "dequeue", None), ("ok", 2, "dequeue", 3)]),
    "set": ("grow_only_set", [
        ("invoke", 0, "add", 1), ("ok", 0, "add", 1),
        ("invoke", 1, "add", 2), ("invoke", 0, "read", None),
        ("ok", 0, "read", [1, 2]), ("ok", 1, "add", 2)]),
}

#: the synth settings of tests/test_knossos.py
SYNTH = {
    "plain": dict(n_ops=40, concurrency=3),
    "stale": dict(n_ops=40, concurrency=3, stale_read_prob=0.4),
    "diff": dict(n_ops=30, concurrency=3, stale_read_prob=0.3,
                 info_prob=0.1),
    "crash-heavy": dict(n_ops=120, concurrency=5, stale_read_prob=0.25,
                        info_prob=0.2),
    "cas-heavy": dict(n_ops=100, concurrency=5, info_prob=0.08,
                      cas_prob=0.3),
}


def synth_pair(**kw):
    return (jsynth.lin_register_history(**kw),
            tsynth.lin_register_history(**kw))


def ops_pair(**kw):
    jh, th = synth_pair(**kw)
    return jprep.prepare(jh), tprep.prepare(th)


def model_pair(name):
    return getattr(jmodels, name)(), getattr(tmodels, name)()


# ---------------------------------------------------------------- models


def _random_step(rng, name):
    v = lambda: rng.choice([None, 0, 1, 2])  # noqa: E731
    if name in ("register", "cas_register"):
        f = rng.choice(["write", "read", "cas", "bogus"]
                       if name == "cas_register" else
                       ["write", "read", "read", "bogus"])
        if f == "cas":
            return f, [rng.choice([None, 0, 1, 2]), rng.choice([0, 1, 2])]
        return f, v()
    if name == "mutex":
        return rng.choice(["acquire", "release", "bogus"]), None
    if name in ("fifo_queue", "unordered_queue"):
        return rng.choice(["enqueue", "enqueue", "dequeue", "bogus"]), v()
    f = rng.choice(["add", "add", "read", "bogus"])
    if f == "read":
        return f, rng.choice([None, [], [0], [0, 1], [1, 2, 0]])
    return f, v()


def _state(m):
    if isinstance(m, (jmodels.Inconsistent, tmodels.Inconsistent)):
        return ("inconsistent", m.msg)
    return (type(m).__name__, m.__dict__)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_models_step_equal(name):
    rng = random.Random(MODEL_NAMES.index(name))
    for _ in range(40):
        jm, tm = model_pair(name)
        for _ in range(12):
            f, val = _random_step(rng, name)
            jm2, tm2 = jm.step(f, val), tm.step(f, val)
            assert _state(jm2) == _state(tm2), (name, f, val)
            if isinstance(tm2, tmodels.Inconsistent):
                continue
            # value objects: an equal state is equal and hashes alike
            clone = object.__new__(type(tm2))
            clone.__dict__.update(tm2.__dict__)
            assert clone == tm2 and hash(clone) == hash(tm2)
            assert len({clone, tm2}) == 1
            jm, tm = jm2, tm2


def test_model_constructors_and_repr():
    for name in MODEL_NAMES:
        jm, tm = model_pair(name)
        assert repr(jm) == repr(tm)
    assert repr(jmodels.inconsistent("x")) == repr(tmodels.inconsistent("x"))
    assert tmodels.Register(1) == tmodels.Register(1)
    assert tmodels.Register(1) != tmodels.CASRegister(1)
    assert len({tmodels.CASRegister(2), tmodels.CASRegister(2)}) == 1


# ------------------------------------------------ generator, prep, memo


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("setting", sorted(SYNTH))
def test_lin_register_history_and_prepare_equal(setting, seed):
    jh, th = synth_pair(seed=seed, **SYNTH[setting])
    assert [op.to_dict() for op in jh] == [op.to_dict() for op in th]
    jo, to = jprep.prepare(jh), tprep.prepare(th)
    assert [dataclasses.asdict(o) for o in jo] == \
        [dataclasses.asdict(o) for o in to]
    assert [o.is_info for o in jo] == [o.is_info for o in to]
    assert tprep.NEVER == jprep.NEVER


def _memo_equal(jo, to, name):
    jm, tm = model_pair(name)
    a, b = jmemo.memoize(jm, jo), tmemo.memoize(tm, to)
    assert a.table.dtype == b.table.dtype
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.op_sym, b.op_sym)
    assert (a.n_states, a.n_syms, a.init_state) == \
        (b.n_states, b.n_syms, b.init_state)


@pytest.mark.parametrize("case", sorted(HAND))
def test_memoize_equal_hand(case, monkeypatch):
    small_state_cap(monkeypatch)
    name, events = HAND[case]
    jh, th = both(*events)
    if name.endswith("queue"):
        jm, tm = model_pair(name)
        with pytest.raises(jmemo.StateExplosion):
            jmemo.memoize(jm, jprep.prepare(jh))
        with pytest.raises(tmemo.StateExplosion):
            tmemo.memoize(tm, tprep.prepare(th))
        return
    _memo_equal(jprep.prepare(jh), tprep.prepare(th), name)


@pytest.mark.parametrize("setting", sorted(SYNTH))
def test_memoize_equal_synth(setting):
    jo, to = ops_pair(seed=3, **SYNTH[setting])
    _memo_equal(jo, to, "cas_register")


def test_memoize_state_explosion_equal():
    jo, to = ops_pair(n_ops=40, concurrency=3, seed=0)
    with pytest.raises(jmemo.StateExplosion):
        jmemo.memoize(jmodels.cas_register(), jo, max_states=2)
    with pytest.raises(tmemo.StateExplosion):
        tmemo.memoize(tmodels.cas_register(), to, max_states=2)


# ------------------------------------------------------- wgl and linear


@pytest.mark.parametrize("case", sorted(HAND))
def test_wgl_and_linear_equal_hand(case, monkeypatch):
    small_state_cap(monkeypatch)
    name, events = HAND[case]
    jh, th = both(*events)
    jm, tm = model_pair(name)
    assert jwgl.check(jh, jm) == twgl.check(th, tm)
    assert jlinear.check(jh, jm) == tlinear.check(th, tm)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("setting", ["plain", "stale", "diff", "cas-heavy"])
def test_wgl_and_linear_equal_synth(setting, seed):
    jo, to = ops_pair(seed=seed, **SYNTH[setting])
    jm, tm = model_pair("cas_register")
    assert jwgl.check(list(jo), jm) == twgl.check(list(to), tm)
    assert jlinear.check(list(jo), jm) == tlinear.check(list(to), tm)


@pytest.mark.parametrize("mode", ["_force_sets", "_force_wide"])
def test_linear_forced_representations_equal(mode):
    for seed in (0, 1):
        jo, to = ops_pair(n_ops=60, concurrency=5, info_prob=0.08,
                          cas_prob=0.3, stale_read_prob=0.2, seed=seed)
        jm, tm = model_pair("cas_register")
        a = jlinear._search(jo, jmemo.memoize(jm, jo), 200_000,
                            **{mode: True})
        b = tlinear._search(to, tmemo.memoize(tm, to), 200_000,
                            **{mode: True})
        assert a == b, (mode, seed)


def test_wgl_budget_and_abort_equal():
    jo, to = ops_pair(n_ops=60, concurrency=5, seed=2)
    jm, tm = model_pair("cas_register")
    assert jwgl.check(list(jo), jm, max_configs=5) == \
        twgl.check(list(to), tm, max_configs=5)
    assert jlinear.check(list(jo), jm, max_configs=3) == \
        tlinear.check(list(to), tm, max_configs=3)
    ctl = Search()
    ctl.abort()
    assert tlinear.check(list(to), tm, ctl=ctl)["valid?"] == "unknown"
    assert twgl.check([], tm) == jwgl.check([], jm)


def test_wgl_direct_search_on_state_explosion(monkeypatch):
    """Past `max_states` both packages take the unmemoized DFS."""
    jo, to = ops_pair(n_ops=40, concurrency=3, stale_read_prob=0.4, seed=1)
    jm, tm = model_pair("cas_register")
    small_state_cap(monkeypatch, 1)
    a, b = jwgl.check(list(jo), jm), twgl.check(list(to), tm)
    assert a == b and a["valid?"] is False and \
        a["final-info"] == {"op-count": len(to)}


# ----------------------------------------------------------- device_wgl


def _window_inputs(rng, ops, A, F, n_valid):
    """Random but well-formed `_expand_block` inputs over `ops`' setup:
    an active window of A slots and an F-row frontier."""
    memo = tmemo.memoize(tmodels.cas_register(), ops)
    n_pad, W, invokes, returns, op_sym, must, z1, z2 = tdw._setup(ops, memo)
    act = np.sort(rng.choice(len(ops), size=min(A - 1, len(ops)),
                             replace=False)).astype(np.int32)
    act_mask = np.zeros(A, bool)
    act_mask[:len(act)] = True
    act_pad = np.zeros(A, np.int32)
    act_pad[:len(act)] = act
    word = (np.arange(n_pad) // 32).astype(np.int32)
    bit = (np.arange(n_pad) % 32).astype(np.int32)
    win = (act_mask, invokes[act_pad], returns[act_pad], op_sym[act_pad],
           z1[act_pad], z2[act_pad], word[act_pad], bit[act_pad])
    states = rng.integers(0, memo.n_states, F).astype(np.int32)
    bits = rng.integers(0, 2 ** 32, (F, W), dtype=np.uint32)
    # most rows share their words, so children collide and dedup works
    bits[1::2] = bits[0]
    bits[:, -1] |= np.uint32(1 << 31)           # the sign bit in play
    h1 = rng.integers(0, 2 ** 32, F, dtype=np.uint32)
    h2 = rng.integers(0, 2 ** 32, F, dtype=np.uint32)
    h1[1::4] = h1[0]
    valid = np.zeros(F, bool)
    valid[:n_valid] = True
    return W, win, memo.table, (states, bits, h1, h2, valid)


@pytest.mark.parametrize("A,F,C", [(8, 64, None), (32, 128, None),
                                   (16, 64, 12)])
def test_expand_block_bit_equal(A, F, C):
    import jax.numpy as jnp

    rng = np.random.default_rng(A * 1000 + F)
    _, to = ops_pair(n_ops=100, concurrency=20, info_prob=0.05, seed=2)
    W, win, table, frontier = _window_inputs(rng, to, A, F, F - 5)
    C = C or min(max(4 * F, A), F * A)
    jout = jdw._expand_block(A, W, F, C, *map(jnp.asarray, win),
                             jnp.asarray(table),
                             *map(jnp.asarray, frontier))
    tout = tdw._expand_block(A, W, F, C, *(tdw._i32(a, "cpu") if
                                           a.dtype != bool else
                                           torch.from_numpy(a)
                                           for a in win),
                             tdw._i32(table, "cpu"),
                             *(tdw._i32(a, "cpu") if a.dtype != bool else
                               torch.from_numpy(a) for a in frontier))
    names = ["states", "bits", "h1", "h2", "valid", "n_unique"]
    for nm, j, t in zip(names, jout, tout):
        j = np.asarray(j)
        t = t.numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        if nm == "n_unique":
            assert int(j) == int(t)
            continue
        assert j.dtype == t.dtype, nm
        np.testing.assert_array_equal(j, t, err_msg=nm)
    if C == 12:
        assert int(tout[5]) > C         # the caller must split this block
    assert int(tout[5]) > 0


def _frontier_args(ops, max_frontier):
    memo = tmemo.memoize(tmodels.cas_register(), ops)
    n_pad, W, invokes, returns, op_sym, must, z1, z2 = tdw._setup(ops, memo)
    arrays = (invokes, returns, op_sym, must, memo.table, z1, z2)
    return n_pad, W, max_frontier, len(ops) + 1, arrays, memo.init_state


@pytest.mark.parametrize("max_frontier", [256, 8])
def test_frontier_search_equal(max_frontier):
    import jax.numpy as jnp

    _, to = ops_pair(n_ops=30, concurrency=4, info_prob=0.1, seed=0)
    n_pad, W, F, n_waves, arrays, init = _frontier_args(to, max_frontier)
    j = jdw._frontier_search(n_pad, W, F, n_waves,
                             *map(jnp.asarray, arrays), jnp.int32(init))
    t = tdw._frontier_search(n_pad, W, F, n_waves,
                             *(tdw._i32(a, "cpu") for a in arrays), init)
    assert tuple(bool(x) for x in j) == t[:3]
    assert t[2] is (max_frontier == 8)          # the small cap overflows
    assert 0 < t[3] <= n_waves


@pytest.mark.parametrize("seed", range(4))
def test_device_check_single_path_equal(seed):
    jo, to = ops_pair(n_ops=30, concurrency=4,
                      stale_read_prob=0.3 if seed % 2 else 0.0,
                      info_prob=0.1, seed=seed)
    jm, tm = model_pair("cas_register")
    a = jdw.check(jo, jm, max_frontier=256)
    b = tdw.check(to, tm, max_frontier=256, device="cpu")
    assert a == b and "blocked" not in b
    assert b["valid?"] == twgl.check(list(to), tm)["valid?"]


def test_device_check_overflow_falls_through_to_blocked():
    jo, to = ops_pair(n_ops=30, concurrency=4, info_prob=0.1, seed=0)
    jm, tm = model_pair("cas_register")
    a = jdw.check(jo, jm, max_frontier=8)
    b = tdw.check(to, tm, max_frontier=8, device="cpu")
    assert a == b and b["blocked"] is True


def test_device_check_early_returns_equal():
    jm, tm = model_pair("cas_register")
    assert jdw.check([], jm) == tdw.check([], tm, device="cpu")
    _, to = ops_pair(n_ops=30, concurrency=4, seed=0)
    ctl = Search()
    ctl.abort()
    assert tdw.check(to, tm, ctl=ctl, device="cpu") == {
        "valid?": "unknown", "op-count": len(to), "reason": "aborted"}
    big = [tprep.LinOp(i, "write", 1, 2 * i, 2 * i + 1, 2 * i, 2 * i + 1)
           for i in range(tdw.MAX_DEVICE_OPS + 1)]
    assert tdw.check(big, tm, device="cpu")["reason"] == \
        "too many ops for device WGL"
    # a queue model over register ops refuses every op: nothing linearizes
    jo, to = ops_pair(n_ops=40, concurrency=3, seed=0)
    assert tdw.check(to, tmodels.FIFOQueue(), max_frontier=64,
                     device="cpu") == \
        jdw.check(jo, jmodels.FIFOQueue(), max_frontier=64)


BLOCKED = {
    # waves above HOST_EXPAND_MAX rows: _expand_block runs (6 calls)
    "wide": (dict(n_ops=100, concurrency=20, info_prob=0.0, seed=0),
             16384),
    # the same with 64-row blocks: hundreds of calls and block splits
    "wide-split": (dict(n_ops=100, concurrency=20, info_prob=0.0, seed=0),
                   64),
    # crash-heavy: 11 crashed ops, the dominance prune runs
    "crash-heavy": (dict(n_ops=120, concurrency=5, info_prob=0.1, seed=0),
                    16384),
    # crash-heavy with stale reads: invalid
    "crash-stale": (dict(n_ops=120, concurrency=5, info_prob=0.2,
                         stale_read_prob=0.25, seed=1), 16384),
}


@pytest.mark.parametrize("case", sorted(BLOCKED))
def test_blocked_search_equal(case):
    kw, max_frontier = BLOCKED[case]
    jo, to = ops_pair(**kw)
    jm, tm = model_pair("cas_register")
    tdw.EXPAND_CALLS = tdw.SPLITS = tdw.HOST_WAVES = 0
    a = jdw._blocked_and_check(jo, jm, max_frontier=max_frontier)
    b = tdw._blocked_and_check(to, tm, max_frontier=max_frontier,
                               device="cpu")
    assert a == b and b["blocked"] is True
    assert b["valid?"] == twgl.check(list(to), tm)["valid?"]
    if case.startswith("wide"):
        assert tdw.EXPAND_CALLS > 0 and tdw.HOST_WAVES > 0
        assert (tdw.SPLITS > 0) is (case == "wide-split")
    else:
        assert sum(o.is_info for o in to) >= 3
        assert tdw.EXPAND_CALLS == 0


def test_blocked_search_budget_equal():
    jo, to = ops_pair(n_ops=100, concurrency=20, info_prob=0.0, seed=0)
    jm, tm = model_pair("cas_register")
    a = jdw._blocked_and_check(jo, jm, max_configs=500)
    b = tdw._blocked_and_check(to, tm, max_configs=500, device="cpu")
    assert a == b and b["reason"] == "config budget exhausted"


def test_blocked_search_deadline_returns_unknown_fast():
    _, to = ops_pair(n_ops=120, concurrency=5, stale_read_prob=0.25,
                     info_prob=0.3, seed=5)
    t0 = time.monotonic()
    res = tdw._blocked_and_check(list(to), tmodels.cas_register(),
                                 ctl=Search(deadline=Deadline(1.0)),
                                 device="cpu")
    dt = time.monotonic() - t0
    assert res["valid?"] == "unknown"
    assert res["error"] == "deadline-exceeded"
    assert res.get("explored", 0) >= 0
    assert dt < 15, f"deadline did not bound the search ({dt:.1f}s)"


def test_device_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, to = ops_pair(n_ops=30, concurrency=4, seed=0)
    th = tsynth.lin_register_history(n_ops=30, concurrency=4, seed=0)
    with pytest.raises(backend.NoDeviceError):
        tdw.check(to, tmodels.cas_register())
    with pytest.raises(backend.NoDeviceError):
        tdw._blocked_and_check(to, tmodels.cas_register())
    with pytest.raises(backend.NoDeviceError):
        tcomp.analysis(th, tmodels.cas_register(), algorithm="device")


def test_device_call_fault_is_raised_on_the_direct_path():
    _, to = ops_pair(n_ops=30, concurrency=4, seed=0)
    plan = tres.FaultPlan(persistent=("knossos.device-wgl",))
    with tres.use(plan), pytest.raises(tres.FaultInjected):
        tdw.check(to, tmodels.cas_register(), max_frontier=64,
                  device="cpu")
    assert plan.injected and plan.injected[0][1] == "knossos.device-wgl"


def test_expand_seam_takes_the_plan_resolved_once():
    """The blocked search resolves the fault plan once and hands it to
    every `_expand_block` call."""
    _, to = ops_pair(n_ops=100, concurrency=20, info_prob=0.0, seed=0)
    plan = tres.FaultPlan()
    tdw.EXPAND_CALLS = 0
    with tres.use(plan):
        r = tdw._blocked_and_check(to, tmodels.cas_register(),
                                   device="cpu")
    assert r["valid?"] is True
    assert plan._n_calls == 6 == tdw.EXPAND_CALLS
    plan = tres.FaultPlan(persistent=("knossos.device-wgl.expand",))
    with tres.use(plan), pytest.raises(tres.FaultInjected):
        tdw._blocked_and_check(to, tmodels.cas_register(), device="cpu")


# ------------------------------------------------------------- analysis


@pytest.mark.parametrize("algorithm", ["wgl", "linear", "device"])
@pytest.mark.parametrize("setting", ["plain", "stale"])
def test_analysis_equal(algorithm, setting):
    jh, th = synth_pair(seed=1, **SYNTH[setting])
    jm, tm = model_pair("cas_register")
    kw = {"max_frontier": 256} if algorithm == "device" else {}
    a = jcomp.analysis(jh, jm, algorithm=algorithm, **kw)
    b = tcomp.analysis(th, tm, algorithm=algorithm, device="cpu", **kw)
    assert a == b


@pytest.mark.parametrize("case", ["cas", "stale-read", "fifo-bad",
                                  "linear-info-late"])
def test_analysis_auto_verdict_equal(case, monkeypatch):
    small_state_cap(monkeypatch)
    name, events = HAND[case]
    jh, th = both(*events)
    jm, tm = model_pair(name)
    assert jcomp.analysis(jh, jm)["valid?"] == \
        tcomp.analysis(th, tm, device="cpu")["valid?"]


def test_analysis_auto_races_three_legs():
    jh, th = synth_pair(n_ops=300, concurrency=4, seed=1)
    jm, tm = model_pair("cas_register")
    b = tcomp.analysis(th, tm, device="cpu")
    assert len(tprep.prepare(th)) > tcomp.HOST_FIRST_MAX_OPS
    assert b["valid?"] is True and b["algorithm"] in ("wgl", "linear",
                                                      "device")
    assert jcomp.analysis(jh, jm)["valid?"] is True


def test_analysis_ctl_reusable_and_deadline_bounded():
    ctl = Search(deadline_s=600)
    for seed in (1, 2):
        th = tsynth.lin_register_history(n_ops=400, concurrency=4,
                                         seed=seed)
        r = tcomp.analysis(th, tmodels.cas_register(), ctl=ctl,
                           device="cpu")
        assert r["valid?"] is True, r
    assert not ctl.aborted()
    th = tsynth.lin_register_history(n_ops=200, concurrency=4, seed=7)
    t0 = time.time()
    r = tcomp.analysis(th, tmodels.cas_register(), deadline_s=0.001,
                       device="cpu")
    assert time.time() - t0 < 30
    assert r["valid?"] in (True, "unknown"), r


def test_analysis_device_deadline_plumbs_through():
    th = tsynth.lin_register_history(n_ops=120, concurrency=5,
                                     stale_read_prob=0.25, info_prob=0.3,
                                     seed=5)
    res = tcomp.analysis(th, tmodels.cas_register(), algorithm="device",
                         deadline=Deadline(1.0), device="cpu")
    assert res["valid?"] == "unknown"
    assert res["error"] == "deadline-exceeded"


def _waiting_host_legs(wait_s=20.0):
    """Host legs that answer "unknown" once the race aborts them, or
    after `wait_s`."""
    def leg(ops, model, ctl=None, max_configs=None):
        t_end = time.monotonic() + wait_s
        while not ctl.aborted() and time.monotonic() < t_end:
            time.sleep(0.01)
        return {"valid?": "unknown", "op-count": len(ops)}
    return (("linear", leg), ("wgl", leg))


def test_device_leg_error_is_raised_from_the_race(monkeypatch):
    """A real device error is not a lost race: `analysis` raises it, and
    the waiting host legs are aborted."""
    def broken(ops, model, ctl=None, device=None, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tcomp, "HOST_LEGS", _waiting_host_legs())
    monkeypatch.setattr(tdw, "check", broken)
    th = tsynth.lin_register_history(n_ops=300, concurrency=4, seed=1)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tcomp.analysis(th, tmodels.cas_register(), device="cpu")
    assert time.time() - t0 < 10
    # the small-history device fallback raises too, as in the JAX package
    monkeypatch.setattr(tcomp, "HOST_LEGS", _waiting_host_legs(0.0))
    th = tsynth.lin_register_history(n_ops=60, concurrency=4, seed=1)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tcomp.analysis(th, tmodels.cas_register(), device="cpu")


def test_device_leg_without_a_card_is_raised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcomp, "HOST_LEGS", _waiting_host_legs())
    th = tsynth.lin_register_history(n_ops=300, concurrency=4, seed=1)
    with pytest.raises(backend.NoDeviceError):
        tcomp.analysis(th, tmodels.cas_register())


def test_fault_injected_device_leg_loses_as_in_jax(monkeypatch):
    """A synthetic fault of the device leg loses the race: the host
    verdict comes back, as the JAX package's race gives it."""
    def faulted_t(ops, model, ctl=None, device=None, **kw):
        raise tres.FaultInjected("device-lost", "knossos.device-wgl", 0,
                                 transient=False)

    def faulted_j(ops, model, ctl=None, **kw):
        raise RuntimeError("UNAVAILABLE: device lost (injected)")

    monkeypatch.setattr(tdw, "check", faulted_t)
    monkeypatch.setattr(jdw, "check", faulted_j)
    for kw in (dict(n_ops=300, concurrency=4, seed=1),
               dict(n_ops=300, concurrency=4, stale_read_prob=0.3,
                    seed=3)):
        jh, th = synth_pair(**kw)
        a = jcomp.analysis(jh, jmodels.cas_register())
        b = tcomp.analysis(th, tmodels.cas_register(), device="cpu")
        assert a["valid?"] == b["valid?"] != "unknown"
        assert b["algorithm"] in ("wgl", "linear")
    # with every host leg waiting, the faulted device leg leaves the
    # race unknown and nothing is raised
    monkeypatch.setattr(tcomp, "HOST_LEGS", _waiting_host_legs())
    th = tsynth.lin_register_history(n_ops=300, concurrency=4, seed=1)
    r = tcomp.analysis(th, tmodels.cas_register(), deadline_s=1.0,
                       device="cpu")
    assert r["valid?"] == "unknown"


def test_host_leg_crash_stays_a_loser(monkeypatch):
    def crash(ops, model, ctl=None, **kw):
        raise ValueError("host leg bug")

    monkeypatch.setattr(tcomp, "HOST_LEGS",
                        (("linear", crash), ("wgl", twgl.check)))
    th = tsynth.lin_register_history(n_ops=60, concurrency=4, seed=1)
    r = tcomp.analysis(th, tmodels.cas_register(), device="cpu")
    assert r["valid?"] is True and r["algorithm"] == "wgl"


def test_race_threads_are_reaped():
    before = {t.name for t in threading.enumerate()}
    th = tsynth.lin_register_history(n_ops=300, concurrency=4, seed=2)
    tcomp.analysis(th, tmodels.cas_register(), device="cpu")
    deadline = time.time() + 30
    while time.time() < deadline:
        left = {t.name for t in threading.enumerate()
                if t.name.startswith("knossos-race-") and
                t.name != "knossos-race-reaper"} - before
        if not left:
            break
        time.sleep(0.1)
    assert not left


def test_history_ir_lin_ops_memoized_and_used():
    jh, th = synth_pair(n_ops=40, concurrency=3, seed=4)
    ir = HistoryIR.of(th)
    ops = ir.lin_ops()
    assert ops is ir.lin_ops() and "lin_ops" in ir.build_s
    assert [dataclasses.asdict(o) for o in ops] == \
        [dataclasses.asdict(o) for o in jprep.prepare(jh)]
    assert tcomp.analysis(ir, tmodels.cas_register(), algorithm="wgl") == \
        jcomp.analysis(jh, jmodels.cas_register(), algorithm="wgl")
