"""Port parity for the task scheduler and the folds
(`jepsen_tpu_torch/history/task.py`, `history/fold.py`) and for the
checker API's `Stats` and `output_path` that use them.

Each case runs the same scenario, on the same seeded ops, through the
JAX package's module and the port's, and requires equal results: task
results and failure kinds, fold values (parallel, fused, columnar,
serial, over a stored `LazyHistory`), and `Stats` dicts below and above
its columnar threshold of 65,536 ops.  The spec is `tests/test_task.py`
and `tests/test_fold.py`.
"""

import concurrent.futures as fut
import dataclasses
import random
import threading

import pytest

from jepsen_tpu.checkers import api as japi
from jepsen_tpu.history import fold as jfold
from jepsen_tpu.history import ops as jops
from jepsen_tpu.history import task as jtask
from jepsen_tpu.store import format as jformat
from jepsen_tpu_torch.checkers import api as tapi
from jepsen_tpu_torch.history import fold as tfold
from jepsen_tpu_torch.history import ops as tops
from jepsen_tpu_torch.history import task as ttask
from jepsen_tpu_torch.store import format as tformat

PKGS = {
    "jax": (jtask, jfold, jops, jformat, japi),
    "torch": (ttask, tfold, tops, tformat, tapi),
}


def both(scenario, *args):
    """`scenario(*modules, *args)` on each package; the two results."""
    return [scenario(*PKGS[name], *args) for name in ("jax", "torch")]


def mk(ops_mod, n, seed=0):
    """`tests/test_fold.py`'s history: n ops of five processes, read or
    write, each invoke followed by its ok, fail or info."""
    rng = random.Random(seed)
    ops = []
    for i in range(n // 2):
        p = rng.randrange(5)
        f = rng.choice(["read", "write"])
        ops.append(ops_mod.Op(type="invoke", process=p, f=f, value=i))
        ops.append(ops_mod.Op(type=rng.choice(["ok", "fail", "info"]),
                              process=p, f=f, value=i))
    return ops_mod.history(ops)


def outcome(t, timeout=10):
    """A task's result, or the name of the exception it ends with."""
    try:
        return ("ok", t.result(timeout))
    except Exception as e:  # noqa: BLE001 — the kind is the result
        return ("raised", type(e).__name__)


# ---- task ------------------------------------------------------------------


def dag_scenario(task, *_):
    with task.TaskExecutor(4) as ex:
        a = ex.submit(lambda: 1, name="a")
        b = ex.submit(lambda x: x + 1, deps=[a], name="b")
        c = ex.submit(lambda x: x + 2, deps=[a], name="c")
        d = ex.submit(lambda x, y: x * y, deps=[b, c], name="d")
        parts = [ex.submit(lambda i=i: i, name=f"p{i}") for i in range(5)]
        fan = ex.submit(lambda *xs: list(xs), deps=parts, name="fan")
        return [outcome(t) for t in (a, b, c, d, fan)] + \
            [(t.name, t.state) for t in (a, b, c, d, fan)]


def failure_scenario(task, *_):
    with task.TaskExecutor(2) as ex:
        a = ex.submit(lambda: 1 / 0, name="boom")
        b = ex.submit(lambda x: x, deps=[a], name="child")
        first = [outcome(a), outcome(b)]
        late = ex.submit(lambda x: x, deps=[a], name="late")
        return first + [late.done(), outcome(late), a.state, b.state,
                        late.state]


def cancel_scenario(task, *_):
    gate = threading.Event()
    with task.TaskExecutor(1) as ex:
        blocker = ex.submit(gate.wait, name="blocker")
        a = ex.submit(lambda: 1, deps=[blocker], name="a")
        b = ex.submit(lambda x: x, deps=[a], name="b")
        cancelled = ex.cancel(a)
        gate.set()
        return [cancelled, outcome(a), outcome(b), outcome(blocker),
                ex.cancel(blocker), a.state, b.state]


def stress_scenario(task, *_):
    rng = random.Random(42)
    with task.TaskExecutor(8) as ex:
        tasks = []
        for i in range(300):
            k = rng.randint(0, min(3, len(tasks)))
            deps = [tasks[j] for j in
                    (rng.sample(range(len(tasks)), k) if tasks else [])]
            tasks.append(ex.submit(lambda *xs: sum(xs) + 1, deps=deps,
                                   name=f"t{i}"))
        return [t.result(30) for t in tasks]


@pytest.mark.parametrize("scenario", [dag_scenario, failure_scenario,
                                      cancel_scenario, stress_scenario],
                         ids=["dag", "failure", "cancel", "stress"])
def test_task_executor_equal_to_jax(scenario):
    want, got = both(scenario)
    assert got == want


def test_task_dep_order_under_contention():
    def run(task, *_):
        out, lock = [], threading.Lock()
        rng = random.Random(0)
        delays = [rng.random() * 0.002 for _ in range(50)]

        def emit(i):
            def go(*_):
                threading.Event().wait(delays[i])
                with lock:
                    out.append(i)
            return go

        with task.TaskExecutor(8) as ex:
            prev = None
            for i in range(50):
                prev = ex.submit(emit(i), deps=[prev] if prev else [],
                                 name=f"c{i}")
            prev.result(30)
        return out

    want, got = both(run)
    assert got == want == list(range(50))


# ---- fold ------------------------------------------------------------------


def folds_scenario(task, fold, ops, fmt, api, n, seed, columnar):
    h = mk(ops, n, seed)
    folder = fold.Folder(h, columnar=columnar)
    out = [folder.fold(fold.count_fold()),
           folder.fold(fold.type_count_fold()),
           folder.fold(fold.group_count_fold(column="f"))]
    if not columnar:
        out += [folder.fold(fold.count_fold(lambda o: o.type == "ok")),
                folder.fold(fold.group_count_fold(lambda o: o.process)),
                folder.fold(fold.collect_fold(lambda o: o.type == "ok",
                                              lambda o: o.index))]
    return out


@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("n,seed", [(0, 0), (1001, 1), (40_000, 3)])
def test_folds_equal_to_jax(n, seed, columnar):
    want, got = both(folds_scenario, n, seed, columnar)
    assert got == want


def test_fusion_and_serial_folds_equal_to_jax():
    def run(task, fold, ops, *_):
        h = mk(ops, 5000, seed=4)
        seen = []

        def counting(name):
            def red(acc, op):
                seen.append(name)
                return acc + 1
            return fold.fold_spec(name=name, reducer_identity=lambda: 0,
                                  reducer=red, combiner_identity=lambda: 0,
                                  combiner=lambda a, b: a + b)

        fused = fold.Folder(h, max_workers=1).fold_many(
            [counting("a"), counting("b")])
        order = fold.fold_spec(
            name="order-hash", associative=False,
            reducer_identity=lambda: 0,
            reducer=lambda acc, op: (acc * 31 + op.index) % (2 ** 61 - 1))
        serial = fold.Folder(mk(ops, 40_000, seed=5)).fold(order)
        bad = fold.fold_spec(reducer_identity=lambda: 0,
                             reducer=lambda a, o: a + 1)
        try:
            fold.Folder(h).fold(bad)
            raised = None
        except TypeError as e:
            raised = str(e)
        return fused, len(seen), serial, raised

    want, got = both(run)
    assert got == want
    assert got[1] == 10_000 and got[3] is not None


def test_concurrent_submit_equal_to_jax():
    def run(task, fold, ops, *_):
        h = mk(ops, 20_000, seed=7)
        with fold.Folder(h) as folder:
            futures = [folder.submit(fold.count_fold()) for _ in range(6)]
            futures.append(folder.submit(fold.group_count_fold(
                lambda o: o.f)))
            done = fut.wait(futures, timeout=30)
            assert not done.not_done
            boom = fold.fold_spec(
                name="boom", reducer_identity=lambda: 0,
                reducer=lambda a, o: 1 / 0, combiner_identity=lambda: 0,
                combiner=lambda a, b: a + b)
            err = outcome(folder.submit(boom), 30)
            return [f.result() for f in futures] + [err]

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("extra", [100, 2 * 16384])
def test_folder_over_stored_history_equal_to_jax(extra, tmp_path):
    def run(task, fold, ops, fmt, *_):
        n = fmt.CHUNK_SIZE + extra
        h = ops.History([o for i in range(n // 2) for o in (
            ops.invoke(i % 5, "read", None), ops.ok(i % 5, "read", i))])
        p = str(tmp_path / f"{fold.__name__}.jepsen")
        fmt.JepsenFile(p).write_test({"name": "f"}, h)
        lh = fmt.JepsenFile(p).read_history()
        folder = fold.Folder(lh)
        cached_before = len(lh._cache)
        count = folder.fold(fold.count_fold())
        col = fold.Folder(fmt.JepsenFile(p).read_history(), columnar=True)
        return (count, len(folder._thunks), cached_before,
                len(lh._cache) > 0, col.fold(fold.type_count_fold()))

    want, got = both(run)
    assert got == want
    assert got[2] == 0 and got[3]


def test_folder_rejects_raw_dict_chunks_as_jax_does():
    def run(task, fold, *_):
        try:
            fold.Folder([{"type": "ok", "f": "read"}])
        except TypeError as e:
            return str(e)
        return None

    want, got = both(run)
    assert got == want and got is not None


def test_columns_of_equal_to_jax():
    import numpy as np

    h = mk(jops, 3000, seed=12)
    want = jfold.columns_of(h.ops)
    got = tfold.columns_of(tops.history(
        [dataclasses.asdict(o) for o in h]).ops)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


# ---- Stats and output_path -------------------------------------------------


@pytest.mark.parametrize("n", [0, 2000, 65_534, 65_536, 80_000])
def test_stats_equal_to_jax_below_and_above_columnar(n):
    want, got = both(lambda *m: m[4].Stats().check({}, mk(m[2], n, seed=11)))
    assert got == want
    assert tapi.Stats.COLUMNAR_MIN == japi.Stats.COLUMNAR_MIN == 65_536


def test_stats_with_nemesis_ops_equal_to_jax():
    def run(task, fold, ops, fmt, api):
        h = list(mk(ops, 70_000, seed=13))
        for i in range(0, len(h), 997):
            h.insert(i, ops.Op(type="info", process="nemesis", f="kill"))
        return api.Stats().check({}, ops.history(h))

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("sub", [None, "perf"])
def test_output_path_equal_to_jax(sub, tmp_path):
    test = {"name": "op", "start-time": 1_700_000_000.0,
            "store-dir": str(tmp_path)}
    opts = {"subdirectory": sub} if sub else None
    want = japi.output_path(test, opts, "latency.png")
    got = tapi.output_path(test, opts, "latency.png")
    assert got == want
    assert got.startswith(str(tmp_path))
