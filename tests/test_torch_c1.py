"""A component of more than `MAX_K_CAP` backward edges (ROADMAP C1).

A run whose completions come back out of apply order ranks its txns by
completion, so many of its ww and wr edges run backward and their rank
intervals overlap into one component of thousands of edges.
`detect_cycles` sweeps such a component in column batches of
`MAX_K_CAP` and closes it as one meta matrix (`_close_group`); the
JAX package reports itself inexact there and answers through its host
oracle.  `MAX_K_CAP` is lowered here (in every port module that imported
it) so that a history of a few hundred txns, `chip_smoke.jitter_history`,
reaches that path on the CPU; the phase 16a of `chip_smoke.py` runs it at
the full cap on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    Components,
    component_sizes,
    jitter_history,
)
from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.checkers.elle import rw_register as jrw  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.ops import cycle_sweep as jcs  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_rw as tdrw  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.checkers.elle import rw_register as trw  # noqa: E402
from jepsen_tpu_torch.history.soa import pack_txns as tpack  # noqa: E402
from jepsen_tpu_torch.ops import cycle_sweep as tcs  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from test_torch_sweep import _on_a_cycle, graphs, local_graph  # noqa: E402

MODELS = ["strict-serializable"]
CAP = 64          # MAX_K_CAP lowered: components of 100-300 edges pass it
N_TXNS = 200


def lower_cap(monkeypatch, cap: int = CAP) -> None:
    for mod in (tcs, tdc, tdrw):
        monkeypatch.setattr(mod, "MAX_K_CAP", cap)


def to_jax(h):
    return jops.history([dataclasses.asdict(op) for op in h])


def la_case(inject: bool):
    h = jitter_history(N_TXNS, seed=0)
    if inject:
        assert tsynth.inject_wr_cycle(h)
    return h


def inject_rw_g1c(h) -> bool:
    """Two committed txns that write different keys each read the
    other's write: a pure wr cycle (G1c) in an rw-register history."""
    oks = [op for op in h.ops if op.type == "ok"]
    writes = [(op, m) for op in oks for m in op.value if m[0] == "w"]
    for i, (t1, (_, k1, v1)) in enumerate(writes):
        for t2, (_, k2, v2) in writes[i + 1:]:
            keys1 = {m[1] for m in t1.value}
            keys2 = {m[1] for m in t2.value}
            if t1 is t2 or k1 == k2 or k2 in keys1 or k1 in keys2:
                continue
            t1.value.append(["r", k2, v2])
            t2.value.append(["r", k1, v1])
            return True
    return False


def same_verdict(got, want):
    """The device path held against the oracle, as
    tests/test_device_la.py does: equal `valid?` and anomaly types."""
    assert got["valid?"] == want["valid?"]
    assert set(got.get("anomaly-types", [])) == \
        set(want.get("anomaly-types", []))


def test_reproducer_has_a_component_past_the_cap():
    h = jitter_history(N_TXNS, seed=0)
    assert [dataclasses.asdict(op) for op in h] == \
        [dataclasses.asdict(op) for op in jitter_history(N_TXNS, seed=0)]
    with Components() as c:
        r = tla.check(h, MODELS, device="cpu")
    assert r["valid?"] is True
    print(f"backward edges and largest component per projection: {c.seen}")
    assert c.largest() > CAP


@pytest.mark.parametrize("inject", [False, True], ids=["valid", "g1c"])
def test_list_append_answers_past_the_cap(inject, monkeypatch):
    h = la_case(inject)
    at_cap = tla.check(h, MODELS, device="cpu")
    lower_cap(monkeypatch)
    with Components() as c:
        got = tla.check(h, MODELS, device="cpu")
    assert c.largest() > CAP
    assert got == at_cap
    same_verdict(got, jla.check(to_jax(h), MODELS))
    if inject:
        assert got["valid?"] is False and "G1c" in got["anomaly-types"]
    else:
        assert got["valid?"] is True


@pytest.mark.parametrize("inject", [False, True], ids=["valid", "g1c"])
def test_rw_register_answers_past_the_cap(inject, monkeypatch):
    # rw_register.check reaches detect_cycles through
    # txn_cycles._cycle_regions, over host-built edges
    h = jitter_history(N_TXNS, kind="rw-register", seed=1)
    if inject:
        assert inject_rw_g1c(h)
    at_cap = trw.check(h, MODELS, device="cpu")
    lower_cap(monkeypatch)
    with Components() as c:
        got = trw.check(h, MODELS, device="cpu")
    assert c.largest() > CAP
    assert got == at_cap
    same_verdict(got, jrw.check(to_jax(h), MODELS))
    assert got["valid?"] is (not inject)
    if inject:
        assert "G1c" in got["anomaly-types"]


@pytest.mark.parametrize("seed", range(3))
def test_detect_cycles_closes_a_component_past_the_k_cap(seed, monkeypatch):
    # 300 backward edges, one component of 69-106 of them swept in column
    # batches of 64 and the rest in batches of whole components: the
    # witnesses are the backward edges on a cycle, as the strongly
    # connected components say and the JAX sweep finds under its cap
    n_nodes = 400
    arrays = local_graph(n_nodes, seed, n_back=300, max_drop=8)
    gj, gt = graphs(n_nodes, arrays)
    assert max(component_sizes(gt)) > CAP
    lower_cap(monkeypatch)
    got = tcs.detect_cycles(gt, device="cpu")
    want = jcs.detect_cycles(gj)
    assert got.converged and want.converged and got.n_backward == 300
    assert got.largest_component == max(component_sizes(gt))
    assert got.has_cycle == want.has_cycle
    assert list(got.witness_edge_ids) == sorted(want.witness_edge_ids)
    assert list(got.witness_edge_ids) == list(_on_a_cycle(n_nodes, arrays))


def test_small_round_budget_grows_in_every_column_batch(monkeypatch):
    n_nodes = 400
    arrays = local_graph(n_nodes, 1, n_back=300, max_drop=8)
    _, gt = graphs(n_nodes, arrays)
    assert max(component_sizes(gt)) > CAP
    lower_cap(monkeypatch)
    got = tcs.detect_cycles(gt, max_rounds=1, device="cpu")
    assert got.converged
    assert list(got.witness_edge_ids) == list(_on_a_cycle(n_nodes, arrays))


def test_past_the_component_cap_is_inexact_and_raises(monkeypatch):
    lower_cap(monkeypatch, 8)
    cap = tcs.MAX_COMPONENT_BATCHES * 8
    wide = local_graph(200, 0, n_back=300, max_drop=6)
    _, gw = graphs(200, wide)
    res = tcs.detect_cycles(gw, device="cpu")
    assert res.largest_component > cap and not res.converged
    assert f"past the cap of {cap}" in tcs.unconverged_reason(res)
    h = la_case(False)
    with pytest.raises(tla.SweepNotConverged, match=f"past the cap of {cap}"):
        tla.check(h, MODELS, device="cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed", range(3))
def test_closure_diagonal_is_exact(dtype, seed):
    # the boolean closure of a sparse random digraph against plain
    # boolean reachability
    rng = np.random.default_rng(seed)
    m = 300
    adj = rng.random((m, m)) < 1.2 / m
    reach = adj.copy()
    for _ in range(m):
        nxt = reach | ((reach.astype(np.int64) @ adj.astype(np.int64)) > 0)
        if (nxt == reach).all():
            break
        reach = nxt
    got = tcs._closure_diagonal(torch.from_numpy(adj).to(dtype))
    assert got.tolist() == np.diagonal(reach).tolist()


def test_grow_until_exact_stays_inexact_past_the_cap(monkeypatch):
    # the projection_scan route (core_check_exact, check_stored,
    # check_batch) counts a projection's backward edges against MAX_K_CAP
    # and has no component batching: past the cap both packages return
    # the overflow, so a stored run of such a history checks unknown in
    # both (ROADMAP C1)
    h = jitter_history(N_TXNS, seed=0)
    lower_cap(monkeypatch)
    monkeypatch.setattr(jdc, "MAX_K_CAP", CAP)
    tp = tpack(h)
    jp = jpack(to_jax(h))
    tb, to = tdc.core_check_exact(tdi.pad_packed(tp, device="cpu"),
                                  tp.n_keys, max_k=32, device="cpu")
    jb, jo = jdc.core_check_exact(jdi.pad_packed(jp), jp.n_keys, max_k=32)
    assert np.asarray(jb).tolist() == tb.tolist()
    assert int(jo) == int(to) > 0
