"""Port parity for the queue corpora's host modules: `jepsen_tpu_torch/
client.py`, `workloads/kafka.py` (`KafkaStore`, `KafkaClient`, `gen`,
`_observations`, the scan twin `KafkaChecker`) and `workloads/mem.py` (the
queue part of `MemStore` / `MemClient`).

With the same seeds and knobs the port's simulators write the same
histories as the JAX ones, op for op and field for field, and the scan
twin returns the same dicts.  `chip_smoke.py`'s corpus builders (which may
not import the JAX package) are pinned equal to
`tests/test_queue_checkers.py`'s.
"""

import dataclasses
import random

import pytest

from jepsen_tpu import client as jclient
from jepsen_tpu.history import ops as jops
from jepsen_tpu.workloads import kafka as jwk
from jepsen_tpu.workloads import mem as jmem
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch.history import ops as tops
from jepsen_tpu_torch.workloads import kafka as twk
from jepsen_tpu_torch.workloads import mem as tmem
from test_queue_checkers import _sim_kafka, _sim_mem_queue

KNOBS = ("lose_tail_p", "dup_p", "dup_send_p", "reorder_p", "zombie_p",
         "torn_p")
QUEUE_KNOBS = ("dup_enqueue_p", "lose_enqueue_p", "reorder_dequeue_p",
               "crash_p", "fail_p")


def _ops(h):
    return [dataclasses.asdict(op) for op in h]


def carry(h):
    return tops.history([dataclasses.asdict(op) for op in h],
                        reindex=False)


def test_client_base_equal():
    c = tclient.Client()
    assert c.open({}, "n1") is c
    assert c.setup({}) is None and c.teardown({}) is None
    assert c.close({}) is None
    with pytest.raises(NotImplementedError):
        c.invoke({}, {"f": "read"})
    names = [n for n in vars(jclient.Client) if not n.startswith("_")]
    assert names == [n for n in vars(tclient.Client)
                     if not n.startswith("_")]
    assert issubclass(twk.KafkaClient, tclient.Client)
    assert issubclass(tmem.MemClient, tclient.Client)


def test_stale_min_polls_equal():
    assert twk.STALE_MIN_POLLS == jwk.STALE_MIN_POLLS


GEN_OPTS = [
    dict(),
    dict(key_count=3, crash_frac=0.05, subscribe_frac=0.5, txn_frac=0.3),
    dict(key_count=2, subscribe_frac=0.2),
    dict(key_count=6, poll_frac=0.2, assign_frac=0.3, txn_frac=0.6,
         max_txn_mops=6),
]


@pytest.mark.parametrize("opts", range(len(GEN_OPTS)))
@pytest.mark.parametrize("seed", range(3))
def test_gen_equal(seed, opts):
    kw = GEN_OPTS[opts]
    j = jwk.gen(rng=random.Random(seed), **kw)
    t = twk.gen(rng=random.Random(seed), **kw)
    assert [j(None, None) for _ in range(300)] == \
        [t(None, None) for _ in range(300)]


def _drive_store(m):
    """One sequence of store calls; the states it passes through."""
    st = m.KafkaStore()
    members = [st.new_member() for _ in range(4)]
    seen = []
    for i in range(40):
        k = i % 3
        if i % 5 == 0:
            st.subscribe(members[i % 4], sorted({k, (k + 1) % 3}))
        elif i % 7 == 0:
            st.leave(members[i % 4])
        elif i % 11 == 0:
            st.append_lost(k)
        else:
            st.append(k, i)
        seen.append((st.generation, dict(st.assign), dict(st.subs),
                     [st.read_from(kk, 0, 100) for kk in range(3)]))
    return seen


def test_kafka_store_equal():
    assert _drive_store(jwk) == _drive_store(twk)


@pytest.mark.parametrize("knob", (None,) + KNOBS)
@pytest.mark.parametrize("seed", range(3))
def test_kafka_sim_writes_the_same_history(seed, knob):
    """The corpus builder of tests/test_queue_checkers.py on the JAX
    workload, and chip_smoke's copy on the port's, op for op."""
    import chip_smoke as cs

    kw = {knob: 0.3} if knob else {}
    want = _sim_kafka(seed, ops=150, **kw)
    got = cs.sim_kafka(seed, ops=150, **kw)
    assert _ops(got) == _ops(carry(want))


@pytest.mark.parametrize("seed", range(3))
def test_kafka_sim_frozen_and_all_knobs_equal(seed):
    import chip_smoke as cs

    frozen = dict(ops=120, n_clients=2, freeze=True,
                  gen_kw=dict(key_count=2, subscribe_frac=0.2))
    assert _ops(cs.sim_kafka(seed, **frozen)) == \
        _ops(carry(_sim_kafka(seed, **frozen)))
    knobs = dict.fromkeys(KNOBS, 0.05)
    assert _ops(cs.sim_kafka(seed, ops=400, n_clients=10, **knobs)) == \
        _ops(carry(_sim_kafka(seed, ops=400, n_clients=10, **knobs)))


def test_kafka_client_open_equal():
    """`open` hands out new members on the shared store with the knobs."""
    def opened(m):
        base = m.KafkaClient(dup_p=0.1, torn_p=0.2, rng=random.Random(1))
        cs = [base.open({}, f"n{i}") for i in range(3)]
        return [(c.member, c.dup_p, c.torn_p, c.store is base.store)
                for c in cs]

    assert opened(jwk) == opened(twk)


@pytest.mark.parametrize("knob", (None,) + QUEUE_KNOBS)
@pytest.mark.parametrize("seed", range(3))
def test_mem_queue_sim_writes_the_same_history(seed, knob):
    import chip_smoke as cs

    kw = {knob: 0.3} if knob else {}
    want = _sim_mem_queue(seed, ops=150, **kw)
    got = cs.sim_mem_queue(seed, ops=150, **kw)
    assert _ops(got) == _ops(carry(want))
    assert _ops(cs.sim_mem_queue(seed, ops=80, drain=False, **kw)) == \
        _ops(carry(_sim_mem_queue(seed, ops=80, drain=False, **kw)))


def test_mem_client_queue_ops_equal():
    """The port's MemClient on a direct op sequence, against the JAX one;
    an op it does not know raises."""
    def run(m):
        c = m.MemClient(m.MemStore(), rng=random.Random(3), crash_p=0.1,
                        fail_p=0.1, dup_enqueue_p=0.2, lose_enqueue_p=0.1,
                        reorder_dequeue_p=0.3).open(None, "n1")
        out = []
        for i in range(200):
            op = ({"f": "enqueue", "value": i} if i % 3 else
                  {"f": "dequeue", "value": None})
            out.append(c.invoke(None, dict(op, process=0)))
        return out, list(c.store.queue)

    assert run(jmem) == run(tmem)
    with pytest.raises(ValueError):
        tmem.MemClient().invoke(None, {"f": "frobnicate", "value": 1})


def _observation_cases():
    cases = {f"sim-{s}-{k}": (lambda s=s, k=k: _sim_kafka(
        s, **({k: 0.3} if k else {}))) for s in range(2)
        for k in (None,) + KNOBS}
    cases["frozen"] = lambda: _sim_kafka(
        1, ops=100, n_clients=2, freeze=True,
        gen_kw=dict(key_count=2, subscribe_frac=0.2))
    return cases


OBS = _observation_cases()


@pytest.mark.parametrize("name", sorted(OBS))
def test_observations_and_scan_twin_equal(name):
    h = OBS[name]()
    th = carry(h)
    assert twk._observations(th) == jwk._observations(h)
    assert twk.KafkaChecker().check(None, th, {}) == \
        jwk.KafkaChecker().check(None, h, {})


def test_scan_twin_empty_unknown():
    assert twk.KafkaChecker().check({}, tops.history([])) == \
        jwk.KafkaChecker().check({}, jops.history([])) == \
        {"valid?": "unknown"}
