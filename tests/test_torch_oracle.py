"""Port parity for the host modules of the list-append checker: the
port's copies must equal the JAX package's originals.

Covers `history.ops` (and the `history([asdict(op) ...])` carry-over),
`history.soa.pack_txns`, `checkers.elle.oracle.check`, `graph`
(`tarjan_scc`, `find_cycle`), `specs`, `consistency`, `sessions`,
`coverage` and `resilience`.  Everything here is host code: no jit runs.
Every case runs with `JT_NO_NATIVE` unset (both packages' C++ Tarjan, the
JAX default) and set (both packages' Python Tarjan).
"""

import dataclasses
import glob
import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers.elle import consistency as jcons  # noqa: E402
from jepsen_tpu.checkers.elle import coverage as jcov  # noqa: E402
from jepsen_tpu.checkers.elle import graph as jgraph  # noqa: E402
from jepsen_tpu.checkers.elle import oracle as jor  # noqa: E402
from jepsen_tpu.checkers.elle import sessions as jsess  # noqa: E402
from jepsen_tpu.checkers.elle import specs as jspecs  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.history import soa as jsoa  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import consistency as tcons  # noqa: E402
from jepsen_tpu_torch.checkers.elle import coverage as tcov  # noqa: E402
from jepsen_tpu_torch.checkers.elle import graph as tgraph  # noqa: E402
from jepsen_tpu_torch.checkers.elle import oracle as tor  # noqa: E402
from jepsen_tpu_torch.checkers.elle import sessions as tsess  # noqa: E402
from jepsen_tpu_torch.checkers.elle import specs as tspecs  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history import soa as tsoa  # noqa: E402
from test_torch_list_append import (  # noqa: E402
    HAND_BUILT,
    carry,
    golden,
    synth_history,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LA_GOLDEN = sorted(glob.glob(os.path.join(DATA, "la-*.json")))
RW_GOLDEN = sorted(glob.glob(os.path.join(DATA, "rw-*.json")))


@pytest.fixture(autouse=True, params=["native", "no-native"])
def _no_native(request, monkeypatch):
    """Both packages on their C++ Tarjan, then on their Python one."""
    if request.param == "native":
        monkeypatch.delenv("JT_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("JT_NO_NATIVE", "1")


def op_history(case):
    """(JAX op history, models) for a corpus case name."""
    kind, _, name = case.partition(":")
    if kind == "golden":
        return golden(os.path.join(DATA, name))
    if kind == "hand":
        return HAND_BUILT[name](), ["strict-serializable"]
    return synth_history(int(name)), ["strict-serializable"]


CASES = ([f"golden:{os.path.basename(p)}" for p in LA_GOLDEN]
         + [f"hand:{n}" for n in sorted(HAND_BUILT)]
         + [f"synth:{s}" for s in range(8)])


@pytest.mark.parametrize("case", CASES)
def test_pack_txns_equal_to_jax(case):
    h, _ = op_history(case)
    want = jsoa.pack_txns(h, "list-append")
    got = tsoa.pack_txns(carry(h), "list-append")
    for f in tsoa.PACKED_COLS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.key_names == want.key_names
    assert got.val_names == want.val_names
    assert got.n_events == want.n_events


@pytest.mark.parametrize("case", CASES)
def test_oracle_check_equal_to_jax(case):
    h, models = op_history(case)
    assert tor.check(carry(h), models) == jor.check(h, models)


def test_oracle_on_packed_input_and_deadline():
    p = synth.packed_la_history(n_txns=400, n_keys=9, seed=2)
    q = tsoa.packed_from_arrays(p)
    models = ["strict-serializable"]
    assert tor.check(q, models) == jor.check(p, models)
    want = jor.check(p, models, deadline=jres.Deadline(0.0))
    got = tor.check(q, models, deadline=tres.Deadline(0.0))
    assert got == want and got["valid?"] == "unknown"


def test_history_carry_over_is_field_for_field():
    h = synth_history(3)
    h.ops[0].ext = {"node": "n1"}
    t = carry(h)
    assert [dataclasses.asdict(o) for o in t.ops] == \
        [dataclasses.asdict(o) for o in h.ops]
    np.testing.assert_array_equal(t._pair, h._pair)
    # the port's own op constructors build the same history as the JAX ones
    mk = [(m.invoke, m.ok) for m in (jops, tops)]
    (ji, jo), (ti, to) = mk
    jh = jops.history([ji(0, "txn", [["r", "x", None]]),
                       jo(0, "txn", [["r", "x", [1]]])])
    th = tops.history([ti(0, "txn", [["r", "x", None]]),
                       to(0, "txn", [["r", "x", [1]]])])
    assert [dataclasses.asdict(o) for o in th] == \
        [dataclasses.asdict(o) for o in jh]
    assert (tops.INVOKE, tops.OK, tops.FAIL, tops.INFO) == \
        (jops.INVOKE, jops.OK, jops.FAIL, jops.INFO)


def _relabel(comp):
    """Component ids renumbered by first appearance."""
    seen = {}
    return [seen.setdefault(int(c), len(seen)) for c in comp]


def _random_graph(seed):
    rng = random.Random(seed)
    n = rng.randint(1, 60)
    m = rng.randint(0, 3 * n)
    src = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int32)
    dst = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int32)
    rel = np.array([rng.randrange(5) for _ in range(m)], dtype=np.int8)
    return n, src, dst, rel


@pytest.mark.parametrize("seed", range(6))
def test_tarjan_scc_equal_to_jax(seed):
    n, src, dst, _ = _random_graph(seed)
    got = tgraph.tarjan_scc(n, src, dst)
    # both packages under one `JT_NO_NATIVE` setting, label for label:
    # the ids are arbitrary, so C++ and Python labels need not match
    np.testing.assert_array_equal(got, jgraph.tarjan_scc(n, src, dst))
    assert _relabel(got) == _relabel(jgraph.tarjan_scc(n, src, dst))
    assert [c.tolist() for c in tgraph.nontrivial_sccs(n, src, dst)] == \
        [c.tolist() for c in jgraph.nontrivial_sccs(n, src, dst)]


@pytest.mark.parametrize("seed", range(6))
def test_find_cycle_equal_to_jax(seed):
    n, src, dst, rel = _random_graph(100 + seed)
    je, te = (g.EdgeList(src, dst, rel) for g in (jgraph, tgraph))
    nodes = np.arange(n, dtype=np.int64)
    n_hits = 0
    for name in tspecs.SPEC_ORDER:
        got = tgraph.find_cycle(nodes, te.project(tspecs.CYCLE_ANOMALY_SPECS[
            name].rels), tspecs.CYCLE_ANOMALY_SPECS[name])
        want = jgraph.find_cycle(nodes, je.project(jspecs.CYCLE_ANOMALY_SPECS[
            name].rels), jspecs.CYCLE_ANOMALY_SPECS[name])
        assert got == want, name
        n_hits += got is not None
    if seed == 0:
        assert n_hits > 0


@pytest.mark.parametrize("seed", range(6))
def test_nonadjacent_search_equal_to_jax_at_every_budget(seed):
    # the port's G-nonadjacent search keeps one path where the JAX one
    # copies it into every stack entry: the same cycle, or None at the
    # same step, with the same budget left
    rng = random.Random(seed)
    n = rng.randint(6, 40)
    m = rng.randint(n, 4 * n)
    src = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int32)
    dst = np.array([rng.randrange(n) for _ in range(m)], dtype=np.int32)
    # rw twice as likely as each other rel, so that cycles with two
    # nonadjacent rw edges occur
    rel = np.array([rng.choice((0, 1, 2, 2, 4)) for _ in range(m)],
                   dtype=np.int8)
    nodes = np.arange(n, dtype=np.int64)
    hits = 0
    for name in ("G-nonadjacent", "G-nonadjacent-realtime"):
        je, te = (g.EdgeList(src, dst, rel).project(s.CYCLE_ANOMALY_SPECS[
            name].rels) for g, s in ((jgraph, jspecs), (tgraph, tspecs)))
        for steps in (1, 5, 40, 300, 3_000, 2_000_000):
            jb, tb = [steps], [steps]
            want = jgraph._find_nonadjacent_cycle(
                nodes, je, jspecs.CYCLE_ANOMALY_SPECS[name], jb)
            got = tgraph._find_nonadjacent_cycle(
                nodes, te, tspecs.CYCLE_ANOMALY_SPECS[name], tb)
            assert (got, tb) == (want, jb), (name, steps)
            hits += got is not None
    if seed == 0:
        assert hits > 0


def test_edge_helpers_equal_to_jax():
    rng = np.random.default_rng(5)
    inv = np.sort(rng.integers(0, 200, 40))
    comp = inv + rng.integers(1, 30, 40)
    proc = rng.integers(0, 4, 40)
    for a, b in ((tgraph.realtime_edges(inv, comp, 40),
                  jgraph.realtime_edges(inv, comp, 40)),
                 ((tgraph.process_edges(proc, inv), 0),
                  (jgraph.process_edges(proc, inv), 0))):
        (ea, na), (eb, nb) = a, b
        assert na == nb
        for f in ("src", "dst", "rel"):
            np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f))
    assert tgraph.REL_NAMES == jgraph.REL_NAMES


def test_spec_tables_equal_to_jax():
    assert tspecs.SPEC_ORDER == jspecs.SPEC_ORDER
    assert tspecs.NONADJACENT_FAMILY == jspecs.NONADJACENT_FAMILY
    assert {k: (v.rels, v.rw_mode)
            for k, v in tspecs.CYCLE_ANOMALY_SPECS.items()} == \
        {k: (v.rels, v.rw_mode) for k, v in jspecs.CYCLE_ANOMALY_SPECS.items()}


@pytest.mark.parametrize("model", jcons.ALL_MODELS)
def test_anomalies_for_models_equal_to_jax(model):
    assert tcons.ALL_MODELS == jcons.ALL_MODELS
    assert tcons.canonical(model) == jcons.canonical(model)
    assert tcons.anomalies_for_models([model]) == \
        jcons.anomalies_for_models([model])
    found = sorted(tcons.proscribed_anomalies(model))[:2]
    assert tcons.friendly_boundary(found) == jcons.friendly_boundary(found)


def test_coverage_equal_to_jax():
    for models in (["strict-serializable"], ["snapshot-isolation"],
                   ["monotonic-reads"], ["causal", "linearizable"]):
        want = set(jcons.anomalies_for_models(models)) | {"G0"}
        for checked in (False, True):
            assert tcov.unchecked_for_la(want, checked) == \
                jcov.unchecked_for_la(want, checked)


@pytest.mark.parametrize("path", LA_GOLDEN + RW_GOLDEN, ids=os.path.basename)
def test_sessions_equal_to_jax(path):
    h, _ = golden(path)
    fn = "check_la" if os.path.basename(path).startswith("la-") else "check"
    want = getattr(jsess, fn)(h)
    got = getattr(tsess, fn)(carry(h))
    assert got == want


def _session_history(seed, n_procs=6, n_keys=4, n_txns=400):
    """A JAX rw-register history whose reads see random earlier versions:
    every session guarantee is broken many times over, across keys."""
    rng = random.Random(seed)
    written = {k: [] for k in range(n_keys)}
    ops, t = [], 0
    for i in range(n_txns):
        p = rng.randrange(n_procs)
        mops = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randrange(n_keys)
            if rng.random() < 0.5:
                v = rng.choice(written[k] + [None])
                mops.append(["r", k, v])
            else:
                v = len(written[k]) + 1
                written[k].append(v)
                mops.append(["w", k, v])
        ops.append({"type": "invoke", "f": "txn", "process": p,
                    "value": [[f, k, None if f == "r" else v]
                              for f, k, v in mops], "time": t})
        ops.append({"type": "ok", "f": "txn", "process": p, "value": mops,
                    "time": t + 1})
        t += 2
    return jops.history(ops)


@pytest.mark.parametrize("seed", range(6))
def test_sessions_walk_equal_to_jax_on_violations(seed):
    # the port's walk skips re-activating a version's dependencies, which
    # adds nothing to a set: the same reports, in the same order, as the
    # JAX walk on histories full of cross-key violations
    h = _session_history(seed)
    want = jsess.check(h)
    got = tsess.check(carry(h))
    assert got == want
    assert {"writes-follow-reads-violation",
            "monotonic-writes-violation"} <= set(got["anomaly-types"])


def test_sessions_find_violations():
    h, _ = golden(os.path.join(DATA, "la-rw-cycle.json"))
    got = tsess.check_la(carry(h))
    assert got["valid?"] is False and got["anomalies"]


def test_is_transient_equal_to_jax():
    cases = [
        (jres.FaultInjected("oom", "s", 0), tres.FaultInjected("oom", "s", 0),
         True),
        (jres.FaultInjected("device-lost", "s", 1, transient=False),
         tres.FaultInjected("device-lost", "s", 1, transient=False), False),
        (jres.DeadlineExceeded("x"), tres.DeadlineExceeded("x"), False),
        (ValueError("bad shape"), ValueError("bad shape"), False),
    ]
    for j, t, verdict in cases:
        assert jres.is_transient(j) is verdict
        assert tres.is_transient(t) is verdict
        assert str(t) == str(j)
    assert tres.is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not tres.is_transient(
        RuntimeError("CUDA error: an illegal memory access was encountered"))


def test_fault_plans_and_policies_equal_to_jax():
    def run(res):
        plan = res.FaultPlan(seed=7, p=0.3, kinds=("oom", "xla",
                                                   "device-lost"))
        msgs = []
        for _ in range(40):
            try:
                plan.fire("elle.infer")
            except res.FaultInjected as e:
                msgs.append((str(e), e.transient))
        return plan.injected, msgs, list(res.RetryPolicy(5, seed=3).delays())

    assert run(tres) == run(jres)
    assert tres.deadline_result(checker="c") == jres.deadline_result(
        checker="c")
    with tres.use(tres.FaultPlan(persistent=True)) as plan:
        assert tres.active_plan() is plan
    assert tres.active_plan() is None


def test_degrade_to_host_equal_to_jax():
    def run(res):
        exc = res.FaultInjected("device-lost", "site", 3, transient=False)
        return res.degrade_to_host("site", lambda: {"valid?": True}, exc)

    assert run(tres) == run(jres)
    assert run(tres) == {
        "valid?": True, "degraded": "host-fallback",
        "device-error": "FaultInjected: UNAVAILABLE: device lost (injected) "
                        "[site=site call=3]"}
    with pytest.raises(tres.DeadlineExceeded):
        tres.degrade_to_host("site", lambda: {"valid?": True},
                             RuntimeError("x"), deadline=tres.Deadline(0.0))


def test_dense_val_names_equal_to_jax():
    p = synth.packed_la_history(n_txns=200, n_keys=7, seed=4)
    want = jsoa._DenseValNames(p.n_vals, p.mop_key, p.mop_val)
    got = tsoa._DenseValNames(p.n_vals, p.mop_key, p.mop_val)
    assert len(got) == len(want) == p.n_vals
    assert got[0:p.n_vals] == want[0:p.n_vals] == p.val_names
    assert got[-1] == want[-1]
    with pytest.raises(IndexError):
        got[p.n_vals]
