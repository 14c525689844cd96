"""Port parity for the mesh branch (`jepsen_tpu_torch/parallel/`: `mesh`,
`batch.make_mesh` and `check_batch(mesh=)`, `op_shard`, `hybrid`, the
mesh half of `slots`) and its callers.

Each test of `tests/test_parallel.py` that runs by default has its
counterpart here, on the same numpy inputs: the JAX package on its 8
virtual host devices, the port on meshes of ``cpu`` shards (where
`slots.default_mesh` resolves the mesh, the `cpu_shards` fixture widens
the CPU's one visible device to 8 shards).  Tolerance:
exactly equal.  Bits, overflows and row dicts are equal bit for bit, but
for one key: the port runs `infer` on the mesh's first device, so its
``"inference-sharded"`` is always False (pinned by
`test_check_sharded_reports_inference_sharding`).  Beside those: the
guard of `op_shard.check_sharded` (`tests/test_campaign.py`), the windows
of `cycle_sweep._sweep_window` gathered against the whole sweep, `Mesh`
itself, and the checks that take the mesh `slots.default_mesh` resolves
under ``JEPSEN_SHARDS``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.checkers.elle import oracle as joracle  # noqa: E402
from jepsen_tpu.checkers.elle.device_infer import \
    pad_packed as jpad  # noqa: E402
from jepsen_tpu.checkers.invariants import bank as jbank  # noqa: E402
from jepsen_tpu.checkers.invariants import session as jsess  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.parallel import batch as jb  # noqa: E402
from jepsen_tpu.parallel import hybrid as jhy  # noqa: E402
from jepsen_tpu.parallel import op_shard as jos  # noqa: E402
from jepsen_tpu.parallel import slots as jslots  # noqa: E402
from jepsen_tpu.resilience import FaultPlan as JPlan  # noqa: E402
from jepsen_tpu.resilience import RetryPolicy as JPolicy  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import bank as tbank  # noqa: E402
from jepsen_tpu_torch.checkers.invariants import \
    session as tsess  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from jepsen_tpu_torch.ops import cycle_sweep as tcs  # noqa: E402
from jepsen_tpu_torch.parallel import batch as tb  # noqa: E402
from jepsen_tpu_torch.parallel import hybrid as thy  # noqa: E402
from jepsen_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from jepsen_tpu_torch.parallel import op_shard as tos  # noqa: E402
from jepsen_tpu_torch.parallel import slots as tslots  # noqa: E402
from jepsen_tpu_torch.resilience import FaultPlan as TPlan  # noqa: E402
from jepsen_tpu_torch.resilience import RetryPolicy as TPolicy  # noqa: E402
from test_invariants import (  # noqa: E402
    bank_history,
    inject_bank_wrong_total,
    inject_session_break,
    sess_history,
)

CPU = torch.device("cpu")


def carry(h):
    """The port's copy of a JAX op history."""
    return tops.history([dataclasses.asdict(op) for op in h])


def _port(ps):
    return [packed_from_arrays(p) for p in ps]


def _tmesh(n):
    return tb.make_mesh(n, device="cpu")


def _no_inference_key(row):
    return {k: v for k, v in row.items() if k != "inference-sharded"}


def _cyclic_packed(seed=5, n_inject=8):
    h = synth.la_history(n_txns=120, n_keys=5, concurrency=6,
                         multi_append_prob=0.2, seed=seed)
    for _ in range(n_inject):
        synth.inject_wr_cycle(h)
        synth.inject_rw_cycle(h)
    return jpack(h, "list-append")


def _sharded_cases():
    """The histories of `test_check_sharded_differential`: a valid one, an
    rw cycle, a wr cycle with a G1a."""
    cases = [synth.packed_la_history(n_txns=96, n_keys=6, seed=99)]
    for seed in (3, 5):
        h = synth.la_history(n_txns=100, n_keys=5, concurrency=6,
                             multi_append_prob=0.2, seed=seed)
        if seed == 3:
            synth.inject_rw_cycle(h)
        else:
            synth.inject_wr_cycle(h)
            synth.inject_g1a(h)
        cases.append(jpack(h, "list-append"))
    return cases


#: JAX results shared between tests (each JAX program compiles once)
_JAX = {}


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _p48(s):
    return synth.packed_la_history(n_txns=48, n_keys=4, seed=s)


def _rows48(n):
    """The JAX rows of the 48-txn histories of seeds 0 .. n-1: its
    `check_batch` of seeds 0-9 on the 8-device mesh (10 rows over 8
    devices, padded to 16), which `tests/test_parallel.py` pins equal to
    the unsharded batch."""
    rows = _jax("rows48", lambda: jb.check_batch(
        [_p48(s) for s in range(10)], mesh=jb.make_mesh(8)))
    return rows[:n]


def _jax_core(p):
    """The JAX `core_check` of `p` padded (bits, overflow)."""
    return _jax(("core", id(p)), lambda: jdc.core_check(jpad(p), p.n_keys))


def _bits_equal(t, j):
    bits_t, over_t = t
    bits_j, over_j = j
    assert bits_t.cpu().tolist() == np.asarray(bits_j).tolist()
    assert int(over_t) == int(np.asarray(over_j))


# -- tests/test_parallel.py, one counterpart each --------------------------

def test_check_batch_unsharded():
    ps = [_p48(s) for s in range(4)]
    got = tb.check_batch(_port(ps), device="cpu")
    assert got == _rows48(4)
    assert len(got) == 4 and all(r["valid?"] is True for r in got)


def test_check_batch_sharded_non_divisible():
    # 10 histories on an 8-shard mesh: blocks of 2, the last two empty
    ps = [_p48(s) for s in range(10)]
    got = tb.check_batch(_port(ps), mesh=_tmesh(8))
    assert got == _rows48(10)
    assert got == tb.check_batch(_port(ps), device="cpu")
    assert len(got) == 10 and all(r["valid?"] is True for r in got)


CYCLIC = _cyclic_packed()


def test_core_check_exact_rebatches_overflow():
    # the JAX test pins its core_check_exact from max_k=2 equal to its
    # core_check; the port's equals both
    p = CYCLIC
    tp = tdi.pad_packed(packed_from_arrays(p), device="cpu")
    _, over_small = tdc.core_check(tp, p.n_keys, max_k=2, device="cpu")
    assert int(over_small) > 0, "fixture must overflow max_k=2"
    got = tdc.core_check_exact(tp, p.n_keys, max_k=2, max_rounds=8,
                               device="cpu")
    _bits_equal(got, _jax_core(p))
    _bits_equal(got, tdc.core_check(tp, p.n_keys, device="cpu"))
    assert int(got[1]) == 0 and int(got[0][-1]) == 1


def test_check_sharded_differential():
    jmesh, tmesh_ = jb.make_mesh(8), _tmesh(8)
    for p in _sharded_cases():
        hp, tp = jpad(p), tdi.pad_packed(packed_from_arrays(p),
                                         device="cpu")
        got = tos._core_check_sharded(tp, p.n_keys, tmesh_, "dp")
        _bits_equal(got, jos._core_check_sharded(hp, p.n_keys, jmesh, "dp"))
        _bits_equal(got, tdc.core_check(tp, p.n_keys, device="cpu"))


def test_check_sharded_overflow_rebatch():
    p = CYCLIC
    got = tos.check_sharded(packed_from_arrays(p), mesh=_tmesh(8), max_k=8)
    want = jos.check_sharded(p, mesh=jb.make_mesh(8), max_k=8)
    assert _no_inference_key(got) == _no_inference_key(want)
    assert got["valid?"] is False and got["exact"] is True


def test_check_sharded_non_pow2_mesh():
    # 6 shards don't divide max_k=128: the budget rounds up to 132
    p = _p48(2)
    got = tos.check_sharded(packed_from_arrays(p), mesh=_tmesh(6))
    assert got == _jax("sharded6", lambda: jos.check_sharded(
        p, mesh=jb.make_mesh(6)))
    assert got["valid?"] is True


def _recovers_rows():
    return _jax("recovers", lambda: jb.check_batch(
        [_p48(s) for s in range(3)] + [CYCLIC]))


def test_check_batch_recovers_overflowed_history():
    ps = [_p48(s) for s in range(3)] + [CYCLIC]
    got = tb.check_batch(_port(ps), device="cpu")
    assert got == _jax("recovers", lambda: jb.check_batch(ps))
    assert got == tb.check_batch(_port(ps), mesh=_tmesh(4))
    assert [r["valid?"] for r in got[:3]] == [True, True, True]
    assert got[3]["valid?"] is False and got[3]["exact"] is True


def test_check_sharded_reports_inference_sharding():
    # the one key where the port's row differs: it never partitions
    # inference, so "inference-sharded" is False on every mesh, where
    # the JAX row says True on a mesh that divides the padded arrays
    p = _p48(2)
    j8 = jos.check_sharded(p, mesh=jb.make_mesh(8))
    j6 = _jax("sharded6", lambda: jos.check_sharded(
        p, mesh=jb.make_mesh(6)))
    t8 = tos.check_sharded(packed_from_arrays(p), mesh=_tmesh(8))
    t6 = tos.check_sharded(packed_from_arrays(p), mesh=_tmesh(6))
    assert j8["inference-sharded"] is True
    assert j6["inference-sharded"] is False
    assert t8["inference-sharded"] is False
    assert t6["inference-sharded"] is False
    assert _no_inference_key(t8) == _no_inference_key(j8)
    assert t6 == j6
    assert t6["valid?"] is True and t8["valid?"] is True


@pytest.mark.skipif(not os.environ.get("JT_SCALE_TESTS"),
                    reason="set JT_SCALE_TESTS=1: ~10 min, >=1M-txn "
                           "sharded differential")
def test_check_sharded_differential_1m():
    p = synth.packed_la_history(n_txns=1_000_000, n_keys=125_000,
                                mops_per_txn=4, read_frac=0.25, seed=7)
    hp = jpad(p)
    tp = tdi.pad_packed(packed_from_arrays(p), device="cpu")
    got = tos._core_check_sharded(tp, p.n_keys, _tmesh(8), "dp")
    _bits_equal(got, jos._core_check_sharded(hp, p.n_keys,
                                             jb.make_mesh(8), "dp"))
    _bits_equal(got, tdc.core_check(tp, p.n_keys, device="cpu"))
    assert int(got[1]) == 0 and int(got[0][-1]) == 1


def test_check_batch_checkpointed_resume(tmp_path):
    ps = [_p48(s) for s in range(7)]
    want = _rows48(7)
    ck = str(tmp_path / "ck.jsonl")
    got = tb.check_batch_checkpointed(_port(ps), ck, group_size=3,
                                      mesh=_tmesh(2))
    assert got == want
    assert sum(1 for line in open(ck) if line.strip()) == 7
    # resume: nothing recomputed, same results (file untouched)
    assert tb.check_batch_checkpointed(_port(ps), ck, group_size=3,
                                       mesh=_tmesh(2)) == want
    assert sum(1 for line in open(ck) if line.strip()) == 7
    # partial checkpoint: drop the last 3 lines, resume completes them,
    # in groups of the mesh's size (4)
    lines = [line for line in open(ck) if line.strip()]
    with open(ck, "w") as f:
        f.writelines(lines[:4])
    seen = []
    assert tb.check_batch_checkpointed(
        _port(ps), ck, mesh=_tmesh(4),
        on_group=lambda info: seen.append(info["indices"])) == want
    assert seen == [[4, 5, 6]]
    assert sum(1 for line in open(ck) if line.strip()) == 7


def test_check_batch_checkpointed_rejects_foreign_batch(tmp_path):
    ps = [_p48(s) for s in range(3)]
    ck = str(tmp_path / "ck.jsonl")
    tb.check_batch_checkpointed(_port(ps), ck, mesh=_tmesh(3))
    other = [synth.packed_la_history(n_txns=48, n_keys=4, seed=s + 50)
             for s in range(3)]
    with pytest.raises(ValueError, match="different batch"):
        tb.check_batch_checkpointed(_port(other), ck, mesh=_tmesh(3))
    # the JAX package refuses the port's checkpoint the same way
    with pytest.raises(ValueError, match="different batch"):
        jb.check_batch_checkpointed(other, ck)


def test_check_batch_checkpointed_tolerates_torn_line(tmp_path):
    ps = [_p48(s) for s in range(4)]
    ck = str(tmp_path / "ck.jsonl")
    want = tb.check_batch_checkpointed(_port(ps), ck, group_size=2,
                                       mesh=_tmesh(2))
    assert want == _rows48(4)
    data = open(ck, "rb").read()
    open(ck, "wb").write(data[:-17])
    got = tb.check_batch_checkpointed(_port(ps), ck, group_size=2,
                                      mesh=_tmesh(2))
    assert got == want
    import json

    recs = [json.loads(line) for line in open(ck) if line.strip()]
    assert sorted(r["i"] for r in recs) == [0, 1, 2, 3]


def test_check_batch_hybrid_differential():
    ps = [_p48(s) for s in range(5)]
    bad = synth.la_history(n_txns=48, n_keys=4, concurrency=4, seed=13)
    assert synth.inject_wr_cycle(bad)
    ps.append(jpack(bad, "list-append"))
    got = thy.check_batch_hybrid(
        _port(ps), thy.make_hybrid_mesh(2, 4, ["cpu"] * 8))
    assert got == jhy.check_batch_hybrid(ps, jhy.make_hybrid_mesh(2, 4))
    assert got[:5] == _rows48(5)
    assert got == tb.check_batch(_port(ps), device="cpu")
    assert got[-1]["valid?"] is False and got[-1]["cycles"]["G1c"]


def test_check_batch_hybrid_4x2():
    ps = [synth.packed_la_history(n_txns=40, n_keys=4, seed=s + 20)
          for s in range(3)]
    got = thy.check_batch_hybrid(
        _port(ps), thy.make_hybrid_mesh(4, 2, ["cpu"] * 8))
    assert got == jhy.check_batch_hybrid(ps, jhy.make_hybrid_mesh(4, 2))
    assert got == tb.check_batch(_port(ps), device="cpu")


def test_check_batch_hybrid_overflow_fallback():
    # a history that overflows tiny max_k must still get a definitive
    # verdict, the JAX package's (its test pins its hybrid rows equal to
    # its batch rows)
    ps = [_p48(1), CYCLIC]
    got = thy.check_batch_hybrid(
        _port(ps), thy.make_hybrid_mesh(2, 2, ["cpu"] * 4), max_k=4)
    assert got == [_rows48(2)[1], _recovers_rows()[3]]
    assert got[0]["valid?"] is True
    assert got[1]["valid?"] is False and got[1]["exact"] is True


@pytest.mark.skipif(not os.environ.get("JT_SCALE_TESTS"),
                    reason="set JT_SCALE_TESTS=1: ~15 min, 4 x 200k-txn "
                           "hybrid (dcn x k) differential")
def test_check_batch_hybrid_500k():
    ps = [synth.packed_la_history(n_txns=200_000, n_keys=25_000,
                                  mops_per_txn=4, read_frac=0.25, seed=s)
          for s in range(4)]
    got = thy.check_batch_hybrid(
        _port(ps), thy.make_hybrid_mesh(2, 4, ["cpu"] * 8))
    assert got == jhy.check_batch_hybrid(ps, jhy.make_hybrid_mesh(2, 4))
    assert got == tb.check_batch(_port(ps), device="cpu")
    assert all(r["valid?"] is True and r["exact"] for r in got)


@pytest.fixture
def cpu_shards(monkeypatch):
    """The CPU's visible devices widened to 8 ``cpu`` shards, as the JAX
    tests force 8 virtual host devices (`tests/conftest.py`); without it
    the CPU shows one device and `default_mesh` gives no mesh there."""
    real = tslots.all_devices

    def widened(device):
        devs = real(device)
        return devs * 8 if devs == [CPU] else devs

    monkeypatch.setattr(tslots, "all_devices", widened)


def _recorded_meshes(monkeypatch):
    """Every mesh `slots.default_mesh` resolves, as (n_txns, shards)."""
    seen = []
    real = tslots.default_mesh

    def recording(n_txns=None, device=None):
        m = real(n_txns, device=device)
        seen.append((n_txns, None if m is None else m.devices.size))
        return m

    monkeypatch.setattr(tslots, "default_mesh", recording)
    return seen


def _default_cases():
    """The histories of `test_sharded_default_differential_shard_counts`:
    (packed cases, op histories)."""
    def make():
        cases = [synth.packed_la_history(n_txns=96, n_keys=6, seed=12)]
        hs = []
        for seed in (4, 6):
            h = synth.la_history(n_txns=110, n_keys=5, concurrency=6,
                                 multi_append_prob=0.2, seed=seed)
            if seed == 4:
                synth.inject_wr_cycle(h)
                synth.inject_g1a(h)
            else:
                synth.inject_rw_cycle(h)
            hs.append(h)
            cases.append(jpack(h, "list-append"))
        return cases, hs

    return _jax("default-cases", make)


def _default_want():
    """The JAX side of the shard-count tests, once: the core bits, the
    `list_append.check` dicts and the host oracle's verdicts.  Its own
    test pins them equal at 1, 2 and 4 shards."""
    def make():
        cases, hs = _default_cases()
        models = ("strict-serializable",)
        return ([_jax_core(p) for p in cases],
                [jla.check(h, models, _force_no_fallback=True) for h in hs],
                [joracle.check(h, models) for h in hs])

    return _jax("default-want", make)


@pytest.mark.parametrize("n", ["1", "2", "4"])
def test_sharded_default_differential_shard_counts(monkeypatch,
                                                   cpu_shards, n):
    """The sharded-default path (`core_check_auto` under a forced
    JEPSEN_SHARDS) at 1, 2 and 4 shards equals the single-device core
    check and the JAX package's, and `list_append.check` equals the JAX
    dict and the host oracle's verdict and anomaly set; both take the
    mesh `default_mesh` resolves (none at 1)."""
    cases, hs = _default_cases()
    bits_want, la_want, oracle_want = _default_want()
    monkeypatch.setenv("JEPSEN_SHARDS", n)
    seen = _recorded_meshes(monkeypatch)
    for p, want in zip(cases, bits_want):
        tp = tdi.pad_packed(packed_from_arrays(p), device="cpu")
        got = tdc.core_check_auto(tp, p.n_keys, device="cpu")
        _bits_equal(got, want)
        _bits_equal(got, tdc.core_check(tp, p.n_keys, device="cpu"))
    for h, want, ref in zip(hs, la_want, oracle_want):
        got = tla.check(carry(h), ("strict-serializable",), device="cpu",
                        _force_no_fallback=True)
        assert got == want
        assert got["valid?"] == ref["valid?"]
        assert sorted(got["anomaly-types"]) == sorted(ref["anomaly-types"])
    want = None if n == "1" else int(n)
    assert len(seen) == len(cases) + len(hs)
    assert {s for _, s in seen} == {want}


def _caller_inputs():
    """(bank history, session history, their JAX dicts), once."""
    def make():
        bank = inject_bank_wrong_total(bank_history(n_ops=80, seed=3))
        sess = inject_session_break(sess_history(seed=1))
        return (bank, sess, jbank.check(bank, {"total-amount": 40}),
                jsess.check(sess))

    return _jax("callers", make)


@pytest.mark.parametrize("n", ["1", "2", "4"])
def test_every_caller_takes_the_default_mesh(monkeypatch, cpu_shards,
                                              n):
    """`core_check_exact`, the bank reduction and the session check take
    the mesh `default_mesh` resolves under JEPSEN_SHARDS (the bank's rows
    split into one block per shard), with the JAX package's dicts."""
    bank, sess, bank_want, sess_want = _caller_inputs()
    monkeypatch.setenv("JEPSEN_SHARDS", n)
    seen = _recorded_meshes(monkeypatch)
    p = CYCLIC
    tp = tdi.pad_packed(packed_from_arrays(p), device="cpu")
    _bits_equal(tdc.core_check_exact(tp, p.n_keys, max_k=2, device="cpu"),
                _jax_core(p))
    blocks = []
    real_place = tslots.place_sharded

    def place(x, mesh=None, device=None):
        out = real_place(x, mesh, device=device)
        blocks.append(len(out))
        return out

    monkeypatch.setattr(tslots, "place_sharded", place)
    n_reads = sum(op.type == "ok" and op.f == "read" for op in bank.ops)
    assert n_reads % 4 == 0, n_reads
    got = tbank.check(carry(bank), {"total-amount": 40}, device="cpu")
    assert got == bank_want and got["valid?"] is False
    got = tsess.check(carry(sess), device="cpu")
    assert got == sess_want and got["valid?"] is False
    want = None if n == "1" else int(n)
    assert len(seen) == 3 and {s for _, s in seen} == {want}
    assert blocks == [1 if n == "1" else int(n)]


def test_cpu_shows_one_device(monkeypatch):
    """The CPU's visible devices are the one ``cpu``, as JAX sees one
    device on a CPU host: a forced JEPSEN_SHARDS, a slot, or both leave
    the single-device path there."""
    assert tslots.all_devices("cpu") == [CPU]
    monkeypatch.setenv("JEPSEN_SHARDS", "4")
    assert tslots.default_mesh(1 << 20, device="cpu") is None
    try:
        tslots.set_active_slot(1, 4)
        assert tslots._visible_devices("cpu") == [CPU]
        assert tslots.default_mesh(1 << 20, device="cpu") is None
    finally:
        tslots.set_active_slot(None)


def test_default_mesh_gates(monkeypatch, cpu_shards):
    """Mesh resolution: a forced JEPSEN_SHARDS activates sharding; an
    unforced CPU check stays single-device; sub-threshold histories stay
    single-device; slot slices carve the device set; one card (or none)
    never gives a mesh."""
    monkeypatch.delenv("JEPSEN_SHARDS", raising=False)
    assert tslots.default_mesh(1 << 20, device="cpu") is None
    assert jslots.default_mesh(1 << 20) is None
    monkeypatch.setenv("JEPSEN_SHARDS", "4")
    m = tslots.default_mesh(1 << 20, device="cpu")
    assert m is not None and m.devices.size == 4
    assert m.devices.size == jslots.default_mesh(1 << 20).devices.size
    assert m.axis_names == ("batch",)
    assert tslots.default_mesh(None, device="cpu") is m     # cached
    monkeypatch.setenv("JEPSEN_SHARDS", "1")
    assert tslots.default_mesh(1 << 20, device="cpu") is None
    assert jslots.default_mesh(1 << 20) is None
    monkeypatch.delenv("JEPSEN_SHARDS", raising=False)
    # slot slices: 8 devices / 4 slots -> 2 devices per slot
    cpus = tslots.all_devices("cpu")
    assert len(tslots.slot_devices(1, 4, cpus)) == \
        len(jslots.slot_devices(1, 4)) == 2
    try:
        tslots.set_active_slot(1, 4)
        jslots.set_active_slot(1, 4)
        assert len(tslots._visible_devices("cpu")) == \
            len(jslots._visible_devices()) == 2
        # a slot makes the unforced CPU check shard, past the size gate
        assert tslots.default_mesh(1 << 20, device="cpu").devices.size == 2
        assert tslots.default_mesh(1 << 10, device="cpu") is None
    finally:
        tslots.set_active_slot(None)
        jslots.set_active_slot(None)
    # the card's side: at most one visible card gives no mesh, forced
    # or not (a one-card host, and a host with none)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tslots.set_forced_shards(4)
    try:
        assert tslots.default_mesh(None) is None
        assert tslots.default_mesh(1 << 20, device="cuda") is None
    finally:
        tslots.set_forced_shards(None)


# -- beside the JAX tests --------------------------------------------------

def test_op_shard_guard_not_nested():
    """The sharded sweep's fault site fires ONCE per dispatch (site
    parallel.op-shard), not once per nesting level, with the JAX
    package's plan trace (`tests/test_campaign.py`)."""
    p = synth.packed_la_history(n_txns=48, n_keys=4, seed=2)
    jplan = JPlan(at={0: "oom"})
    tplan = TPlan(at={0: "oom"})
    want = jos.check_sharded(p, mesh=jb.make_mesh(2), plan=jplan,
                             policy=JPolicy(max_attempts=2,
                                            base_delay_s=0.0))
    got = tos.check_sharded(packed_from_arrays(p), mesh=_tmesh(2),
                            plan=tplan,
                            policy=TPolicy(max_attempts=2,
                                           base_delay_s=0.0))
    assert got["valid?"] is True
    assert _no_inference_key(got) == _no_inference_key(want)
    assert tplan.injected == jplan.injected == [
        (0, "parallel.op-shard", "oom")]
    assert tplan._n_calls == jplan._n_calls >= 2


def _sweep_inputs(p):
    """(n_nodes, rank, e_src, e_dst, mask, chain nodes, starts, mask) of
    projection 3 (ww+wr+rw+process) of a padded history on the CPU."""
    tp = tdi.pad_packed(packed_from_arrays(p), device="cpu")
    out = tdi.infer(tp, p.n_keys)
    edges, chains = out["edges"], out["chains"]
    fams = ("ww", "wr", "rw", "tb", "bt")
    rank = torch.cat([out["ranks"]["txn"], out["ranks"]["barrier"]])
    mask = torch.cat([edges[k][2] & (k in ("ww", "wr", "rw"))
                      for k in fams])
    cn = torch.cat([chains["process"][0], chains["barrier"][0]])
    cs = torch.cat([chains["process"][1], chains["barrier"][1]])
    cm = torch.cat([chains["process"][2],
                    torch.zeros_like(chains["barrier"][2])])
    return (2 * out["ranks"]["txn"].shape[0], rank,
            torch.cat([edges[k][0] for k in fams]),
            torch.cat([edges[k][1] for k in fams]), mask, cn, cs, cm)


@pytest.mark.parametrize("k_local", [1, 3, 12])
def test_sweep_windows_gather_to_the_whole_sweep(k_local):
    """The windows of `_sweep_window` at k_local 1, 3 and k (k = 12
    columns, each window a `_window_rows`) gather to the meta matrix of
    one window over all k, whose closure is the single-window sweep's
    witness; `_sweep_window` over as many `cpu` shards gives that
    sweep's result."""
    k = 12
    for p in (_cyclic_packed(n_inject=2), _sharded_cases()[1]):
        n_nodes, rank, src, dst, mask, cn, cs, cm = _sweep_inputs(p)
        has, wit, n_back, conv = tcs._sweep_window(
            n_nodes, k, 64, rank, src, dst, mask, cn, cs, cm)
        assert 0 < n_back <= k and conv
        is_back = mask & tcs.backward_test(rank, src, dst, n_nodes)
        back_id = torch.where(
            is_back, torch.cumsum(is_back.int(), 0, dtype=torch.int32) - 1,
            -1)
        in_k = is_back & (back_id < k)
        bsrc, bdst = (tcs._endpoint_table(k, back_id, in_k, e)
                      for e in (src, dst))

        def window(off, width):
            return tcs._window_rows(n_nodes, k, 64, n_back, off, width,
                                    rank, src, dst, mask & ~is_back, cn,
                                    cs, cm, bsrc, bdst)

        whole, c = window(0, k)
        assert c == conv and whole.shape == (k, k)
        valid8 = (torch.arange(k) < n_back).to(torch.int8)
        closed = tcs._closure_diagonal(whole.float()).to(torch.int8)
        assert torch.equal(closed & valid8, wit)
        rows, flags = zip(*(window(off, k_local)
                            for off in range(0, k, k_local)))
        assert all(r.shape == (k_local, k) for r in rows)
        assert torch.equal(tmesh.all_gather_rows(rows, CPU), whole)
        assert tmesh.psum([not f for f in flags]) == 0
        got = tcs._sweep_window(n_nodes, k, 64, rank, src, dst, mask, cn,
                                cs, cm, devices=[CPU] * (k // k_local))
        assert got[0] == has and torch.equal(got[1], wit)
        assert got[2:] == (n_back, conv)


def test_mesh_with_repeated_devices_and_mixed_types():
    m = tmesh.Mesh([CPU] * 4, ("dp",))
    assert m.shape == {"dp": 4} and m.devices.size == 4
    assert m.axis_names == ("dp",)
    assert all(d == CPU for d in m.devices.flat)
    h = thy.make_hybrid_mesh(2, 2, ["cpu"] * 4)
    assert h.shape == {"dcn": 2, "k": 2} and h.devices.shape == (2, 2)
    with pytest.raises(ValueError, match="one device type"):
        tmesh.Mesh(["cpu", "cuda:0"], ("dp",))
    with pytest.raises(ValueError, match="axis names"):
        tmesh.Mesh([CPU] * 4, ("dcn", "k"))
    parts = [torch.arange(3).reshape(1, 3), torch.arange(3, 9).reshape(2, 3)]
    assert tmesh.all_gather_rows(parts, CPU).tolist() == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    assert tmesh.psum([True, False, True]) == 2
    assert tmesh.pmax([0, 3, 1]) == 3


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    assert _tmesh(0).devices.size == 8
    assert tb.make_mesh(3, axis="x", device="cpu").shape == {"x": 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tb.make_mesh(2)
    with pytest.raises(backend.NoDeviceError):
        tos.check_sharded(packed_from_arrays(
            synth.packed_la_history(n_txns=48, n_keys=4, seed=2)))
