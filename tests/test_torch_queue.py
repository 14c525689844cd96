"""Port parity for the queue/kafka checker family
(`jepsen_tpu_torch/checkers/queue/`: packed, kafka, fifo, MODELS) and the
IR section it reads (`HistoryIR.queue`).

Every corpus of `tests/test_queue_checkers.py` (each adversarial knob,
frozen commits, the clean controls, the mem-store queue knobs) and the
hand-built histories of `tests/test_kafka.py` go through the JAX package
and the port.  The tolerance is exact everywhere:

- every `PackedKafka` / `PackedFifo` column and id table is equal;
- the 13 kafka masks and the 4 fifo outputs of the port's `_math` on CPU
  torch (through `_TorchXP`) equal the JAX `_math(np)` and the JAX jitted
  kernel on the CPU (bucket-padded, then sliced);
- the whole result dicts of the port's `check(..., device="cpu")` equal
  the JAX `check(..., use_device=True)`, both host twins and, for kafka,
  both scan twins (`KafkaChecker`).

Beside those: the empty-table branches the unpadded port meets and the
padded JAX device path never does, the int64 route (a history past JAX's
`device_safe` bound runs on the device and equals the JAX host verdict),
the fallback rule (a `FaultPlan` degrades with the JAX stamp, a real
device error is raised, no card raises `NoDeviceError`) and
`HistoryIR.queue`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.checkers import queue as jqueue  # noqa: E402
from jepsen_tpu.checkers.queue import fifo as jfifo  # noqa: E402
from jepsen_tpu.checkers.queue import kafka as jkafka  # noqa: E402
from jepsen_tpu.checkers.queue import packed as jpacked  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.history.ir import HistoryIR as JIR  # noqa: E402
from jepsen_tpu.workloads import kafka as jwk  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.checkers import queue as tqueue  # noqa: E402
from jepsen_tpu_torch.checkers.queue import fifo as tfifo  # noqa: E402
from jepsen_tpu_torch.checkers.queue import kafka as tkafka  # noqa: E402
from jepsen_tpu_torch.checkers.queue import packed as tpacked  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.ir import HistoryIR as TIR  # noqa: E402
from jepsen_tpu_torch.ops import kernels  # noqa: E402
from jepsen_tpu_torch.workloads import kafka as twk  # noqa: E402
from test_queue_checkers import _sim_kafka, _sim_mem_queue  # noqa: E402

CPU = torch.device("cpu")
#: the smallest `_sim_kafka(0, ops=n)` (3 clients, the tests' knobs; n a
#: multiple of 1,000) whose epoch codes reach JAX's sentinel: b_ep.max()
#: is 1,081,409,536 >= 2^30 at 86,000 ops and 1,067,037,055 at 85,000
INT64_OPS = 86_000


def carry(h):
    """The port's copy of a JAX op history, indices kept."""
    return tops.history([dataclasses.asdict(op) for op in h],
                        reindex=False)


# ---------------------------------------------------------------- corpora

#: knob -> (knobs, seeds): the adversarial shapes of
#: tests/test_queue_checkers.py at its ten seeds, and the broker knobs of
#: tests/test_kafka.py at three
SHAPES = {
    "dup-send": (dict(dup_send_p=0.3), 10),
    "zombie-resend": (dict(zombie_p=0.3), 10),
    "torn-send": (dict(torn_p=0.5), 10),
    "reorder-send": (dict(reorder_p=0.5), 10),
    "lose-tail": (dict(lose_tail_p=0.3), 3),
    "dup": (dict(dup_p=0.5), 3),
}

KAFKA = {}
for _shape, (_knobs, _n) in SHAPES.items():
    for _s in range(_n):
        KAFKA[f"{_shape}-{_s}"] = \
            lambda s=_s, k=_knobs: _sim_kafka(s, **k)
for _s in range(8):
    KAFKA[f"frozen-{_s}"] = lambda s=_s: _sim_kafka(
        s, ops=60, n_clients=2, freeze=True,
        gen_kw=dict(key_count=2, subscribe_frac=0.2))
for _s in range(4):
    KAFKA[f"clean-{_s}"] = lambda s=_s: _sim_kafka(s, gen_kw=dict(
        key_count=3, crash_frac=0.0, subscribe_frac=0.5, txn_frac=0.3))
KAFKA["all-knobs"] = lambda: _sim_kafka(
    5, ops=400, **{k: 0.05 for k in ("lose_tail_p", "dup_p", "dup_send_p",
                                     "reorder_p", "zombie_p", "torn_p")})


def _hand_built(m):
    """The literal histories of tests/test_kafka.py, built with the op
    helpers of module `m` (the JAX or the port's `history.ops`)."""
    h, inv, ok = m.history, m.invoke, m.ok
    return {
        "inconsistent-offsets": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (0, 1))]),
            inv(1, "send", [("send", 0, 2)]),
            ok(1, "send", [("send", 0, (0, 2))])]),
        "lost-write": h([
            inv(0, "send", [("send", 0, 10)]),
            ok(0, "send", [("send", 0, (0, 10))]),
            inv(0, "send", [("send", 0, 11)]),
            ok(0, "send", [("send", 0, (1, 11))]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(1, 11)]})])]),
        "nonmonotonic-poll": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(3, "c"), (4, "d")]})]),
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(2, "b")]})])]),
        "int-poll-skip": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a"), (2, "c")]})]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(1, "b")]})])]),
        "poll-skip": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a")]})]),
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(2, "c")]})]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(1, "b")]})])]),
        "redelivery-after-assign": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a"), (1, "b")]})]),
            inv(0, "assign", [0]),
            ok(0, "assign", [0]),
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a"), (1, "b")]})])]),
        "nonmonotonic-send": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (5, 1))]),
            inv(0, "send", [("send", 0, 2)]),
            ok(0, "send", [("send", 0, (3, 2))])]),
        "int-send-skip": h([
            inv(0, "txn", [("send", 0, 1), ("send", 0, 2)]),
            ok(0, "txn", [("send", 0, (0, 1)), ("send", 0, (4, 2))])]),
        "precommitted-read": h([
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(0, "x")]})]),
            inv(0, "send", [("send", 0, "x")]),
            ok(0, "send", [("send", 0, (0, "x"))])]),
        "unseen": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (0, 1))]),
            inv(0, "send", [("send", 0, 2)]),
            ok(0, "send", [("send", 0, (1, 2))]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(0, 1)]})])]),
        "group-rebalance-seek": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a"), (1, "b")]})],
               ext={"rebalance": 1}),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(2, "c"), (3, "d")]})],
               ext={"rebalance": 2}),
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(4, "e")]})],
               ext={"rebalance": 3})]),
    }


HAND = sorted(_hand_built(jops))
#: each hand-built case and the anomaly tests/test_kafka.py expects
HAND_EXPECT = {"redelivery-after-assign": None, "unseen": None,
               "group-rebalance-seek": None}

FIFO = {
    "lose-enqueue": lambda: _sim_mem_queue(0, lose_enqueue_p=1.0),
    "dup-enqueue": lambda: _sim_mem_queue(1, dup_enqueue_p=1.0),
    "crash": lambda: _sim_mem_queue(2, crash_p=0.2),
    "fail": lambda: _sim_mem_queue(3, fail_p=0.2),
    "undrained": lambda: _sim_mem_queue(4, drain=False),
}
for _s in range(6):
    FIFO[f"reorder-{_s}"] = lambda s=_s: _sim_mem_queue(
        s, reorder_dequeue_p=0.5)
for _s in range(4):
    FIFO[f"mixed-{_s}"] = lambda s=_s: _sim_mem_queue(
        s, dup_enqueue_p=0.2, lose_enqueue_p=0.1, reorder_dequeue_p=0.3)
for _s in range(3):
    FIFO[f"clean-{_s}"] = lambda s=_s: _sim_mem_queue(s, ops=120)


def _kafka_case(name):
    """(JAX history, port history) of a kafka corpus or hand-built case."""
    if name in KAFKA:
        h = KAFKA[name]()
        return h, carry(h)
    return _hand_built(jops)[name], _hand_built(tops)[name]


KAFKA_ALL = sorted(KAFKA) + [f"hand:{n}" for n in HAND]


def _case(name):
    return _kafka_case(name[5:] if name.startswith("hand:") else name)


# --------------------------------------------------------------- helpers

KAFKA_ARRAYS = [f.name for f in dataclasses.fields(jpacked.PackedKafka)]
FIFO_ARRAYS = [f.name for f in dataclasses.fields(jpacked.PackedFifo)]


def _equal_packs(want, got, fields):
    for name in fields:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


def _jax_kafka_kernel(pk):
    """The JAX jitted kernel on the CPU, on the bucket-padded columns,
    sliced back to each mask's real length."""
    out = jkafka._kernel()(*jkafka._padded_cols(pk), off_base=pk.off_base)
    lens = dict(zip(jkafka.MASKS, (
        len(pk.s_key),) * 4 + (len(pk.b_key),) * 2 + (len(pk.m_key),) * 3
        + (len(pk.dv_key), len(pk.av_key), len(pk.b_key), len(pk.b_key))))
    return tuple(np.asarray(m)[:lens[n]] for m, n in zip(out, jkafka.MASKS))


def _jax_fifo_kernel(pf):
    """The JAX jitted fifo kernel on the CPU, bucket-padded, sliced."""
    from jepsen_tpu.compilecache import bucket

    V = bucket.pow2_at_least(max(len(pf.e_ok), 1))
    Q = bucket.pow2_at_least(max(len(pf.q_val), 1))

    def pad(a, n, fill):
        out = np.full(n, fill, np.int64)
        out[:len(a)] = a
        return out

    cols = (pad(pf.e_ok, V, 0), pad(pf.e_maybe, V, 0),
            pad(pf.d_cnt, V, 0), pad(pf.v_inv, V, -1),
            pad(pf.v_done, V, -1),
            pad(pf.q_val, Q, -1), pad(pf.q_proc, Q, -1),
            np.concatenate([pf.q_by_proc,
                            np.arange(len(pf.q_by_proc), Q,
                                      dtype=np.int64)]))
    out = jfifo._kernel()(*cols, big=jfifo._big(pf))
    n_v, n_q = len(pf.e_ok), len(pf.q_val)
    return tuple(np.asarray(x)[:n] for x, n in
                 zip(out, (n_v, n_v, n_q, n_q)))


def _torch_masks(math, lead, cols):
    """The port's `_math` over CPU tensors, as numpy."""
    t = [torch.from_numpy(np.ascontiguousarray(c, np.int64)) for c in cols]
    return tuple(m.numpy() for m in math(tkafka._TorchXP(CPU), lead, *t))


def _same_outputs(want, got, names):
    assert len(want) == len(got) == len(names)
    for n, a, b in zip(names, want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b)), n
        assert np.asarray(a).shape == np.asarray(b).shape, n


def _strip(d):
    d = dict(d)
    d.pop("degraded", None)
    return d


# ------------------------------------------------------------- registries

def test_models_and_names_equal():
    assert tqueue.MODELS == jqueue.MODELS
    assert tkafka.ANOMALIES == jkafka.ANOMALIES
    assert tkafka.MASKS == jkafka.MASKS
    assert tkafka.SITE == jkafka.SITE == tfifo.SITE
    assert tkafka.STALE_MIN_POLLS == jkafka.STALE_MIN_POLLS \
        == twk.STALE_MIN_POLLS
    assert (tfifo.LOST, tfifo.PHANTOM, tfifo.FIFO) == \
        (jfifo.LOST, jfifo.PHANTOM, jfifo.FIFO)
    assert tpacked.SENTINEL == jpacked.SENTINEL
    for n in (0, 1, 2, 3, 7, 8, 1000, 1 << 20):
        assert tpacked._pow2(n) == jpacked._pow2(n)
        assert tpacked._pow2(n, 8) == jpacked._pow2(n, 8)


# ------------------------------------------------------------------ kafka

@pytest.mark.parametrize("name", KAFKA_ALL)
def test_pack_kafka_equal(name):
    """Every column and id table, and `device_safe`, of the port's pack
    equal the JAX pack's."""
    jh, th = _case(name)
    want, got = jpacked.pack_kafka(jh), tpacked.pack_kafka(th)
    _equal_packs(want, got, KAFKA_ARRAYS)
    assert (want.empty, want.device_safe) == (got.empty, got.device_safe)


@pytest.mark.parametrize("name", KAFKA_ALL)
def test_kafka_masks_equal(name):
    """The 13 masks: the port's `_math` on CPU torch, numpy (its host
    twin), the JAX `_math(np)` and the JAX jitted kernel."""
    jh, _ = _case(name)
    pk = jpacked.pack_kafka(jh)
    want = jkafka._math(np, pk.off_base, *jkafka._cols(pk))
    _same_outputs(want, _torch_masks(tkafka._math, pk.off_base,
                                     tkafka._cols(pk)), tkafka.MASKS)
    _same_outputs(want, tkafka._reduce_host(pk), tkafka.MASKS)
    _same_outputs(want, tkafka._reduce_device(pk, CPU), tkafka.MASKS)
    if pk.device_safe:
        _same_outputs(want, _jax_kafka_kernel(pk), tkafka.MASKS)


@pytest.mark.parametrize("name", KAFKA_ALL)
def test_kafka_check_equal(name):
    """Whole result dicts: the port's device path (on the CPU) == the
    JAX device path == both host twins == both scan twins."""
    jh, th = _case(name)
    got = tkafka.check(th, device="cpu")
    assert "degraded" not in got
    assert got == _strip(jkafka.check(jh, use_device=True))
    assert got == jkafka.check(jh, use_device=False)
    assert got == tkafka.check(th, use_device=False)
    assert got == tkafka.host_verdict(tpacked.pack_kafka(th))
    twin = jwk.KafkaChecker().check(None, jh, {})
    assert got == twin == twk.KafkaChecker().check(None, th, {})
    if name.startswith("hand:") and name[5:] not in HAND_EXPECT:
        assert got["valid?"] is False and name[5:] in got["anomaly-types"]


def test_kafka_corpus_shows_every_injected_anomaly():
    """Across the corpora each knob is attributed as
    tests/test_queue_checkers.py expects, by the port's device path."""
    seen = {}
    for name in KAFKA:
        shape = name.rsplit("-", 1)[0]
        r = tkafka.check(carry(KAFKA[name]()), device="cpu")
        seen.setdefault(shape, set()).update(r.get("anomaly-types") or [])
    assert "duplicate" in seen["dup-send"]
    assert "duplicate" in seen["zombie-resend"]
    assert "lost-write" in seen["torn-send"]
    assert seen["reorder-send"] & {"int-send-skip", "nonmonotonic-send"}
    assert "stale-consumer-group" in seen["frozen"]
    assert seen["clean"] == set()


def test_bincount_weighted_counts_agree_on_positive():
    """numpy's and torch's weighted bincounts of int64 weights are
    float64, JAX's keeps the weights' type (int32 without x64): only
    ``> 0`` is read, and all three agree on it."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, 400)
    w = (rng.random(400) < 0.2).astype(np.int64)
    a = tkafka._bincount(np, x, 64, weights=w)
    b = tkafka._bincount(tkafka._TorchXP(CPU), torch.from_numpy(x), 64,
                         weights=torch.from_numpy(w)).numpy()
    c = np.asarray(jkafka._bincount(jnp, jnp.asarray(x), 64,
                                    weights=jnp.asarray(w)))
    assert a.dtype == np.float64 and b.dtype == np.float64
    assert c.dtype == np.int32
    assert np.array_equal(a > 0, b > 0) and np.array_equal(a > 0, c > 0)
    assert np.array_equal(a, b) and np.array_equal(a, c)
    plain = tkafka._bincount(tkafka._TorchXP(CPU), torch.from_numpy(x), 64)
    assert plain.dtype == torch.int64
    assert np.array_equal(plain.numpy(), np.bincount(x, minlength=64))


def _empty_table_histories(m):
    """Histories whose packs take `_math`'s early branches: no poll at all
    (u_comp and B empty), empty polls only (B empty, n_polls > 0), polls
    and no send (S == 0), one non-empty batch (B == 1)."""
    h, inv, ok = m.history, m.invoke, m.ok
    return {
        "sends-only": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (0, 1))]),
            inv(1, "send", [("send", 1, 2)]),
            ok(1, "send", [("send", 1, (0, 2))])]),
        "empty-polls": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (0, 1))]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [], 1: []})])]),
        "polls-only": h([
            inv(0, "poll", [("poll", None)]),
            ok(0, "poll", [("poll", {0: [(0, "a"), (1, "b")]})]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(1, "b")]})],
               ext={"rebalance": 1})]),
        "one-batch": h([
            inv(0, "send", [("send", 0, 1)]),
            ok(0, "send", [("send", 0, (0, 1))]),
            inv(1, "poll", [("poll", None)]),
            ok(1, "poll", [("poll", {0: [(0, 1)]})])]),
    }


@pytest.mark.parametrize("name", sorted(_empty_table_histories(jops)))
def test_kafka_empty_tables_equal(name):
    jh = _empty_table_histories(jops)[name]
    th = _empty_table_histories(tops)[name]
    pk = jpacked.pack_kafka(jh)
    want = jkafka._math(np, pk.off_base, *jkafka._cols(pk))
    got = _torch_masks(tkafka._math, pk.off_base, tkafka._cols(pk))
    _same_outputs(want, got, tkafka.MASKS)
    assert tkafka.check(th, device="cpu") == \
        _strip(jkafka.check(jh, use_device=True)) == \
        jkafka.check(jh, use_device=False)


def test_kafka_empty_table_branches_are_taken():
    """The corpora above reach the zero-row shapes: u_comp empty, B == 0
    with polls counted, S == 0."""
    packs = {n: tpacked.pack_kafka(h)
             for n, h in _empty_table_histories(tops).items()}
    assert len(packs["sends-only"].u_comp) == 0
    assert len(packs["sends-only"].b_key) == 0
    assert len(packs["empty-polls"].b_key) == 0
    assert packs["empty-polls"].n_polls == 2
    assert len(packs["polls-only"].s_key) == 0
    assert len(packs["one-batch"].b_key) == 1


def test_kafka_empty_history_unknown():
    assert tkafka.check(tops.history([]), device="cpu") == \
        jkafka.check(jops.history([])) == {"valid?": "unknown"}
    assert tfifo.check(tops.history([]), device="cpu") == \
        jfifo.check(jops.history([])) == {"valid?": "unknown"}


def test_int64_route_runs_on_the_device():
    """The smallest corpus past JAX's sentinel: JAX checks it on the host
    (`device_safe` is False); the port runs it on the device in int64 and
    its dict equals the JAX host verdict."""
    jh = _sim_kafka(0, ops=INT64_OPS)
    th = carry(jh)
    jp = jpacked.pack_kafka(jh)
    assert int(jp.b_ep.max()) >= int(jpacked.SENTINEL)
    assert not jp.device_safe
    tp = tpacked.pack_kafka(th)
    _equal_packs(jp, tp, KAFKA_ARRAYS)
    calls = []
    reduce = tkafka._reduce_device
    try:
        tkafka._reduce_device = lambda pk, dev: calls.append(dev) or \
            reduce(pk, dev)
        got = tkafka.check(tp, device="cpu")
    finally:
        tkafka._reduce_device = reduce
    assert calls == [CPU]
    assert got == jkafka.host_verdict(jp) == \
        jkafka.check(jh, use_device=True)


def test_int64_route_hand_built_epoch_codes():
    """A few ops whose epoch codes pass 2^31 (1,024 reassigns by one
    process and a rebalance generation of 2^20): the same on the device
    as on both packages' host twins."""
    def build(m):
        ops = []
        for _ in range(1024):
            ops += [m.invoke(0, "assign", [0]), m.ok(0, "assign", [0])]
        ops += [m.invoke(0, "poll", [("poll", None)]),
                m.ok(0, "poll", [("poll", {0: [(0, "a"), (1, "b")]})],
                     ext={"rebalance": 1 << 20}),
                m.invoke(0, "poll", [("poll", None)]),
                m.ok(0, "poll", [("poll", {0: [(1, "b")]})],
                     ext={"rebalance": 1 << 20})]
        return m.history(ops)

    jh, th = build(jops), build(tops)
    pk = tpacked.pack_kafka(th)
    assert int(pk.b_ep.max()) > 2 ** 31 and not pk.device_safe
    got = tkafka.check(th, device="cpu")
    assert got == jkafka.host_verdict(jpacked.pack_kafka(jh))
    assert got["anomaly-types"] == ["nonmonotonic-poll"]


# ------------------------------------------------------------------- fifo

@pytest.mark.parametrize("name", sorted(FIFO))
def test_pack_fifo_equal(name):
    h = FIFO[name]()
    want, got = jpacked.pack_fifo(h), tpacked.pack_fifo(carry(h))
    _equal_packs(want, got, FIFO_ARRAYS)
    assert want.empty == got.empty


FIFO_OUT = ("lost", "phantom", "fifo", "prev_inv")


@pytest.mark.parametrize("name", sorted(FIFO))
def test_fifo_outputs_equal(name):
    """The 4 outputs: the port's `_math` on CPU torch (`torch.cummax`),
    numpy, the JAX `_math(np)` and the JAX jitted kernel."""
    pf = jpacked.pack_fifo(FIFO[name]())
    want = jfifo._math(np, jfifo._big(pf), *jfifo._cols(pf))
    assert tfifo._big(pf) == jfifo._big(pf)
    _same_outputs(want, _torch_masks(tfifo._math, tfifo._big(pf),
                                     tfifo._cols(pf)), FIFO_OUT)
    _same_outputs(want, tfifo._reduce_host(pf), FIFO_OUT)
    _same_outputs(want, tfifo._reduce_device(pf, CPU), FIFO_OUT)
    _same_outputs(want, _jax_fifo_kernel(pf), FIFO_OUT)


@pytest.mark.parametrize("fifo", [False, True], ids=["total", "fifo"])
@pytest.mark.parametrize("name", sorted(FIFO))
def test_fifo_check_equal(name, fifo):
    jh = FIFO[name]()
    th = carry(jh)
    got = tfifo.check(th, fifo=fifo, device="cpu")
    assert "degraded" not in got
    assert got == _strip(jfifo.check(jh, fifo=fifo, use_device=True))
    assert got == jfifo.check(jh, fifo=fifo, use_device=False)
    assert got == tfifo.check(th, fifo=fifo, use_device=False)
    if not fifo:
        # the legacy keys of both packages' scan twin
        twin = tapi.TotalQueueChecker().check(None, th, {})
        assert twin == japi.TotalQueueChecker().check(None, jh, {})
        for k, v in twin.items():
            assert got[k] == v, k


def test_fifo_knobs_attributed():
    lost = tfifo.check(carry(FIFO["lose-enqueue"]()), fifo=True,
                       device="cpu")
    assert tfifo.LOST in lost["anomaly-types"]
    phantom = tfifo.check(carry(FIFO["dup-enqueue"]()), fifo=True,
                          device="cpu")
    assert tfifo.PHANTOM in phantom["anomaly-types"]
    hit = False
    for s in range(6):
        h = carry(FIFO[f"reorder-{s}"]())
        total = tfifo.check(h, fifo=False, device="cpu")
        strict = tfifo.check(h, fifo=True, device="cpu")
        assert total["valid?"] is True
        hit |= tfifo.FIFO in (strict.get("anomaly-types") or [])
    assert hit


@pytest.mark.parametrize("name", ["enqueues-only", "dequeues-only"])
def test_fifo_zero_rows_equal(name):
    """Q == 0 (no OK dequeue) and V rows with no enqueue."""
    def build(m):
        if name == "enqueues-only":
            return m.history([m.invoke(0, "enqueue", 1),
                              m.ok(0, "enqueue", 1),
                              m.invoke(1, "enqueue", 2),
                              m.info(1, "enqueue", 2)])
        return m.history([m.invoke(0, "dequeue", None),
                          m.ok(0, "dequeue", 7)])

    jh, th = build(jops), build(tops)
    pf = jpacked.pack_fifo(jh)
    if name == "enqueues-only":
        assert len(pf.q_val) == 0
    want = jfifo._math(np, jfifo._big(pf), *jfifo._cols(pf))
    _same_outputs(want, _torch_masks(tfifo._math, tfifo._big(pf),
                                     tfifo._cols(pf)), FIFO_OUT)
    for fifo in (False, True):
        assert tfifo.check(th, fifo=fifo, device="cpu") == \
            _strip(jfifo.check(jh, fifo=fifo)) == \
            jfifo.check(jh, fifo=fifo, use_device=False)


def test_fifo_device_bound_is_int64():
    """JAX's int32 bound sends a history with large op indices to the
    host; the port's int64 bound keeps it on the device."""
    ops = [tops.Op(index=i, type=t, process=0, f=f, value=v) for i, (t, f, v)
           in enumerate([("invoke", "enqueue", 1), ("ok", "enqueue", 1),
                         ("invoke", "dequeue", None), ("ok", "dequeue", 1)])]
    ops[-1] = dataclasses.replace(ops[-1], index=1 << 40)
    pf = tpacked.pack_fifo(ops)
    assert tfifo._big(pf) * (len(pf.q_val) + 2) >= 2 ** 31
    assert tfifo._big(pf) * (len(pf.q_val) + 2) < tfifo.DEVICE_BOUND
    calls = []
    reduce = tfifo._reduce_device
    try:
        tfifo._reduce_device = lambda p, dev: calls.append(dev) or \
            reduce(p, dev)
        got = tfifo.check(pf, fifo=True, device="cpu")
    finally:
        tfifo._reduce_device = reduce
    assert calls == [CPU]
    assert got == tfifo.host_verdict(pf, fifo=True)


# --------------------------------------------------- faults and the card

def _plan(mod):
    return mod.FaultPlan(seed=5, p=1.0, kinds=("oom",), sites="queue.check")


def _policy(mod):
    return mod.RetryPolicy(max_attempts=2, base_delay_s=0.0,
                           max_delay_s=0.0)


# checker -> (port check, JAX check, corpus)
CHECKERS = {
    "kafka": (tkafka.check, jkafka.check,
              lambda: _sim_kafka(2, dup_send_p=0.2, torn_p=0.3)),
    "fifo": (lambda h, **kw: tfifo.check(h, fifo=True, **kw),
             lambda h, **kw: jfifo.check(h, fifo=True, **kw),
             lambda: _sim_mem_queue(0, dup_enqueue_p=0.2,
                                    reorder_dequeue_p=0.3)),
}


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_fault_plan_degrades_with_the_jax_stamp(checker):
    tcheck, jcheck, corpus = CHECKERS[checker]
    h = corpus()
    jplan = _plan(jres)
    want = jcheck(h, plan=jplan, policy=_policy(jres),
                  deadline=jres.Deadline(30.0))
    assert jplan.injected
    tplan = _plan(tres)
    got = tcheck(carry(h), plan=tplan, policy=_policy(tres),
                 deadline=tres.Deadline(30.0), device="cpu")
    assert tplan.injected
    assert want["degraded"] == tres.DEGRADED_HOST
    assert got == want
    assert _strip(got) == tcheck(carry(h), use_device=False)
    with tres.use(_plan(tres)):
        assert tcheck(carry(h), policy=_policy(tres), device="cpu") == want


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_real_device_error_is_raised(checker, monkeypatch):
    """The JAX package degrades any exception at `queue.check`; the port
    raises everything but a synthetic fault."""
    tcheck, _, corpus = CHECKERS[checker]

    def boom(*a, **kw):
        raise kernels.KernelError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tkafka if checker == "kafka" else tfifo,
                        "_reduce_device", boom)
    with pytest.raises(kernels.KernelError):
        tcheck(carry(corpus()), device="cpu")
    assert tcheck(carry(corpus()), use_device=False)["valid?"] is False


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_entry_points_need_a_card_unless_told_cpu(checker, monkeypatch):
    tcheck, _, corpus = CHECKERS[checker]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tcheck(carry(corpus()))
    assert tcheck(carry(corpus()), device="cpu")["valid?"] is False
    assert tcheck(carry(corpus()), use_device=False)["valid?"] is False


@pytest.mark.parametrize("checker", sorted(CHECKERS))
def test_deadline_results_equal(checker):
    tcheck, jcheck, corpus = CHECKERS[checker]
    h = corpus()
    with pytest.raises(tres.DeadlineExceeded):
        tcheck(carry(h), deadline=tres.Deadline(0.0), device="cpu")
    with pytest.raises(jres.DeadlineExceeded):
        jcheck(h, deadline=jres.Deadline(0.0))


def test_checker_classes_equal():
    h = _sim_kafka(3, torn_p=0.5)
    assert tkafka.PackedKafkaChecker(device="cpu").check({}, carry(h)) == \
        _strip(jkafka.PackedKafkaChecker().check({}, h))
    assert tkafka.PackedKafkaChecker().name() == "kafka"
    q = _sim_mem_queue(0, reorder_dequeue_p=0.5)
    for fifo in (False, True):
        chk = tfifo.PackedQueueChecker(fifo=fifo, device="cpu")
        assert chk.name() == "total-queue"
        assert chk.check({}, carry(q)) == \
            _strip(jfifo.PackedQueueChecker(fifo=fifo).check({}, q))


# --------------------------------------------------------------------- IR

def test_ir_queue_memoized_and_booked(monkeypatch):
    """`HistoryIR.queue(kind)` builds each packing once, books it in
    `build_s` under ``queue:<kind>``, equals the JAX IR's, and a check
    handed the IR packs nothing again."""
    jh = KAFKA["frozen-3"]()
    ir = TIR(carry(jh))
    pk = ir.queue("kafka")
    assert ir.queue("kafka") is pk and ir.queue() is pk
    assert set(ir.build_s) == {"queue:kafka"}
    _equal_packs(JIR(jh).queue("kafka"), pk, KAFKA_ARRAYS)
    calls = []
    pack = tpacked.pack_kafka
    monkeypatch.setattr(tpacked, "pack_kafka",
                        lambda h: calls.append(h) or pack(h))
    assert tkafka.check(ir, device="cpu") == \
        tkafka.check(carry(jh), device="cpu")
    assert len(calls) == 1    # the bare history's, not the IR's
    q = FIFO["mixed-1"]()
    qir = TIR(carry(q))
    pf = qir.queue("fifo")
    assert qir.queue("fifo") is pf and "queue:fifo" in qir.build_s
    _equal_packs(JIR(q).queue("fifo"), pf, FIFO_ARRAYS)
    assert tfifo.check(qir, fifo=True, device="cpu") == \
        _strip(jfifo.check(JIR(q), fifo=True))
