"""Port parity for batched checking (`jepsen_tpu_torch/parallel/batch.py`,
BASELINE config 5 on one card): `check_batch`,
`check_batch_checkpointed` and the corpus of `chip_smoke.py` phase 12.

Tolerance: exactly equal.  Every row's dict equals the JAX package's
`check_batch` (its one-device `jit(vmap(core_check))` here on the CPU)
and the same history checked alone, on batches that mix verdicts (a
failed writer, stale reads, injected cycles, a row that overflows the
sweep's budget and takes the exact rerun), pow2 size buckets and a
history whose layout fact `txn_major` is False.  Checkpoints pass between
the two packages in both directions with no history checked again.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.parallel import batch as jb  # noqa: E402
from jepsen_tpu.resilience import faults as jfaults  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from jepsen_tpu_torch.parallel import batch as tb  # noqa: E402
from jepsen_tpu_torch.resilience import faults as tfaults  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config5_script():
    spec = importlib.util.spec_from_file_location(
        "config5_batch", os.path.join(REPO, "scripts", "config5_batch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _valid(n, seed, **kw):
    return jsynth.packed_la_history(n, n_keys=max(4, n // 8), seed=seed,
                                    **kw)


def _cyclic_op(seed=5, n_inject=8):
    # tests/test_parallel.py's _cyclic_packed: injected wr and rw cycles
    h = jsynth.la_history(n_txns=120, n_keys=5, concurrency=6,
                          multi_append_prob=0.2, seed=seed)
    for _ in range(n_inject):
        jsynth.inject_wr_cycle(h)
        jsynth.inject_rw_cycle(h)
    return jpack(h, "list-append")


def _overflow():
    # 150 stale reads at 1,000 txns: more than 128 backward edges and no
    # positive count, so the row takes the exact rerun
    return chip_smoke.stale_reads(
        jsynth.packed_la_history(1000, n_keys=500, seed=0), n_reads=150)


def _not_txn_major(p):
    # swap the last mop of txn 0 with the first mop of the last txn: the
    # order of each txn's own mops is unchanged, mop_txn is no longer
    # nondecreasing
    q = dataclasses.replace(p, **{f: getattr(p, f).copy() for f in (
        "mop_txn", "mop_kind", "mop_key", "mop_val", "mop_rd_start",
        "mop_rd_len")})
    i = int(np.flatnonzero(q.mop_txn == 0)[-1])
    j = int(np.flatnonzero(q.mop_txn == q.n_txns - 1)[0])
    for f in ("mop_txn", "mop_kind", "mop_key", "mop_val", "mop_rd_start",
              "mop_rd_len"):
        a = getattr(q, f)
        a[i], a[j] = a[j], a[i]
    return q


#: name -> list of the JAX package's PackedTxns
BATCHES = {
    "valid": lambda: [_valid(48, s) for s in range(4)],
    "mixed": lambda: [
        _valid(300, 0, **chip_smoke.C5_KW),
        chip_smoke.seed_invalid(_valid(300, 1, **chip_smoke.C5_KW)),
        chip_smoke.stale_reads(_valid(300, 2, **chip_smoke.C5_KW), 16),
        _cyclic_op(),
        _valid(300, 3, **chip_smoke.C5_KW)],
    "overflow": lambda: [_valid(48, 0), _overflow(), _valid(300, 1)],
    "sizes": lambda: [
        _valid(48, 0), _valid(300, 1), _not_txn_major(_valid(300, 2)),
        _valid(1500, 3), jsynth.packed_la_history(131, n_keys=1, seed=4)],
}

_WANT = {}


def _want(name):
    """The JAX package's `check_batch` on a corpus, once per module."""
    if name not in _WANT:
        _WANT[name] = jb.check_batch(BATCHES[name]())
    return _WANT[name]


def _port(ps):
    return [packed_from_arrays(p) for p in ps]


def _alone(p):
    """`p` checked alone: `core_check_exact` on its own padding."""
    h = tdi.pad_packed(p, device="cpu")
    bits, over = tdc.core_check_exact(h, p.n_keys, device="cpu")
    return tb.summarize_batch_bits(bits[None], over[None], None, p.n_keys,
                                   1)[0]


@pytest.mark.parametrize("name", list(BATCHES))
def test_check_batch_equal_to_jax_and_to_each_alone(name):
    ps = _port(BATCHES[name]())
    got = tb.check_batch(ps, device="cpu")
    assert got == _want(name)
    assert got == [_alone(p) for p in ps]
    assert all(r["exact"] for r in got)
    if name == "mixed":
        assert [r["valid?"] for r in got] == [True, False, False, False,
                                              True]
        assert got[1]["counts"]["G1a"] > 0 and not any(
            got[1]["cycles"].values())
        assert not any(got[2]["counts"].values())
        assert got[2]["cycles"]["G2-family"]
    if name == "overflow":
        assert [r["valid?"] for r in got] == [True, False, True]
        assert not any(got[1]["counts"].values())


def test_overflow_row_takes_the_exact_rerun(monkeypatch):
    ps = _port(BATCHES["overflow"]())
    batch = tb.pad_batch(ps, device="cpu")
    _, over = tb._batched_core(batch, batch.n_keys)
    assert over.tolist()[0] == over.tolist()[2] == 0
    assert over.tolist()[1] > 0
    budgets = []
    exact = tb.core_check_exact
    monkeypatch.setattr(tb, "core_check_exact", lambda h, nk, max_k, **kw:
                        budgets.append(max_k) or exact(h, nk, max_k, **kw))
    tb.check_batch(ps, device="cpu")
    assert budgets == [tdi.pow2_at_least(128 + over.tolist()[1], 128)]


def test_shared_caps_change_the_branch_not_the_verdict():
    # the batch runs each row with shared facts: the largest n_keys, the
    # flags ANDed (one member is not txn-major) and no per-key order
    # columns (their shapes differ), which most of these histories do not
    # take alone
    ps = _port(BATCHES["sizes"]())
    batch = tb.pad_batch(ps, device="cpu")
    alone = [tdi.pad_packed(p, device="cpu") for p in ps]
    assert batch.n_keys == max(p.n_keys for p in ps)
    assert [h.txn_major for h in alone] == [True, True, False, True, True]
    assert not batch.txn_major and batch.run_cap == 0
    assert not batch.app_val_mono and alone[0].app_val_mono
    assert batch.key_ord_len is None and batch.key_ord_read is None
    assert all(h.key_ord_len is not None for h in alone)
    assert batch.run_sort is not None        # one shape (M) for every row
    assert batch.txn_type.shape == (5, 2048)
    want = jb.pad_batch(BATCHES["sizes"]())
    fields, statics = tdi.padded_to_numpy(batch)
    for f in tdi.DATA_FIELDS:
        w = getattr(want, f)
        assert (w is None) == (fields[f] is None), f
        if w is not None:
            assert fields[f].dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(fields[f], np.asarray(w),
                                          err_msg=f)
    for f in tdi.STATIC_FIELDS:
        assert statics[f] == getattr(want, f), f


def test_stacked_ir_columns_when_every_member_has_them():
    ps = _port(BATCHES["valid"]())
    batch = tb.pad_batch(ps, device="cpu")
    want = jb.pad_batch(BATCHES["valid"]())
    for f in tb._IR_FIELDS:
        assert getattr(batch, f) is not None, f
        np.testing.assert_array_equal(getattr(batch, f).numpy(),
                                      np.asarray(getattr(want, f)))
    caps = tb.batch_caps(ps)
    assert tuple(caps) == tuple(jb.batch_caps(BATCHES["valid"]()))
    assert tb._row(batch, 2).mop_txn.data_ptr() == \
        batch.mop_txn[2].data_ptr()         # a row is a view


def test_batch_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tb.check_batch(_port(BATCHES["valid"]()))


# -- checkpoints -----------------------------------------------------------


def _counting(monkeypatch, mod):
    """Count the histories `mod.check_batch` computes."""
    seen = []
    real = mod.check_batch

    def run(ps, *a, **kw):
        seen.append(len(ps))
        return real(ps, *a, **kw)

    monkeypatch.setattr(mod, "check_batch", run)
    return seen


def _seven():
    return [_valid(48, s) for s in range(6)] + [_cyclic_op()]


def test_checkpointed_resume(tmp_path, monkeypatch):
    ps = _port(_seven())
    ck = str(tmp_path / "ck.jsonl")
    want = tb.check_batch(ps, device="cpu")
    seen = _counting(monkeypatch, tb)
    groups = []
    got = tb.check_batch_checkpointed(ps, ck, group_size=3,
                                      on_group=groups.append, device="cpu")
    assert got == want and seen == [3, 3, 1]
    assert [g["group"] for g in groups] == [0, 1, 2]
    assert [g["done"] for g in groups] == [3, 6, 7]
    assert sum(1 for line in open(ck) if line.strip()) == 7
    # resume: nothing computed, same results
    assert tb.check_batch_checkpointed(ps, ck, group_size=3,
                                       device="cpu") == want
    assert seen == [3, 3, 1]
    # drop the last 3 lines: the resume completes them
    lines = [line for line in open(ck) if line.strip()]
    with open(ck, "w") as f:
        f.writelines(lines[:4])
    assert tb.check_batch_checkpointed(ps, ck, group_size=3,
                                       device="cpu") == want
    assert seen == [3, 3, 1, 2, 1]
    assert sum(1 for line in open(ck) if line.strip()) == 7


def test_checkpointed_rejects_foreign_batch(tmp_path):
    ck = str(tmp_path / "ck.jsonl")
    tb.check_batch_checkpointed(_port([_valid(48, s) for s in range(3)]),
                                ck, device="cpu")
    other = _port([_valid(48, s + 50) for s in range(3)])
    with pytest.raises(ValueError, match="different batch"):
        tb.check_batch_checkpointed(other, ck, device="cpu")


def test_checkpointed_heals_torn_line(tmp_path):
    ps = _port([_valid(48, s) for s in range(4)])
    ck = str(tmp_path / "ck.jsonl")
    want = tb.check_batch_checkpointed(ps, ck, group_size=2, device="cpu")
    data = open(ck, "rb").read()
    open(ck, "wb").write(data[:-17])           # a crash mid-append
    assert tb.check_batch_checkpointed(ps, ck, group_size=2,
                                       device="cpu") == want
    recs = [json.loads(line) for line in open(ck) if line.strip()]
    assert sorted(r["i"] for r in recs) == [0, 1, 2, 3]
    # a parseable but unterminated last line is torn too
    open(ck, "wb").write(data.rstrip(b"\n"))
    assert tb.check_batch_checkpointed(ps, ck, group_size=2,
                                       device="cpu") == want
    assert open(ck, "rb").read() == data


class _Crash(Exception):
    pass


def _crash_after_first(info):
    raise _Crash(info)


def _jax_seven(tmp_path_factory):
    """The JAX package's `check_batch_checkpointed` of `_seven()` on a
    fresh file, once per module."""
    if "seven" not in _WANT:
        ck = str(tmp_path_factory.mktemp("jax7") / "ck.jsonl")
        _WANT["seven"] = jb.check_batch_checkpointed(_seven(), ck,
                                                     group_size=3)
    return _WANT["seven"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("part", ["whole", "first-group"])
def test_checkpoint_passes_between_the_packages(tmp_path, tmp_path_factory,
                                                monkeypatch, writer, part):
    want = _jax_seven(tmp_path_factory)
    ps_j = _seven()
    ps_t = _port(ps_j)
    ck = str(tmp_path / "ck.jsonl")
    on_group = _crash_after_first if part == "first-group" else None
    try:
        if writer == "jax":
            first = jb.check_batch_checkpointed(ps_j, ck, group_size=3,
                                                on_group=on_group)
        else:
            first = tb.check_batch_checkpointed(ps_t, ck, group_size=3,
                                                on_group=on_group,
                                                device="cpu")
    except _Crash:
        first = None
    assert (first is None) == (part == "first-group")
    written = open(ck, "rb").read()
    assert written.count(b"\n") == (7 if first else 3)
    seen_j, seen_t = _counting(monkeypatch, jb), _counting(monkeypatch, tb)
    if writer == "jax":
        got = tb.check_batch_checkpointed(ps_t, ck, group_size=3,
                                          device="cpu")
        seen = seen_t
    else:
        got = jb.check_batch_checkpointed(ps_j, ck, group_size=3)
        seen = seen_j
    assert got == want
    # nothing judged again; the JAX package fills the last group to 3
    assert seen == ([] if first else [3, 1] if writer == "jax" else [3, 3])
    if first:
        assert got == first and open(ck, "rb").read() == written


def test_digests_equal_between_the_packages(tmp_path):
    # the checkpoint's digest hashes the PackedTxns columns' bytes: the
    # port's columns carry the JAX dtypes, so every digest agrees
    ps_j = BATCHES["mixed"]()
    ck_j, ck_t = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jb.check_batch_checkpointed(ps_j, ck_j, group_size=5)
    tb.check_batch_checkpointed(_port(ps_j), ck_t, group_size=5,
                                device="cpu")
    assert open(ck_t, "rb").read() == open(ck_j, "rb").read()


# -- the device guard ------------------------------------------------------


@pytest.mark.parametrize("spec", [
    dict(at={0: "oom"}),
    dict(persistent=["parallel.batch"], kinds=["device-lost"]),
    dict(persistent=["parallel.batch"]),
], ids=["transient", "persistent-device-lost", "persistent-oom"])
def test_fault_plan_at_parallel_batch_as_in_jax(spec):
    ps_j = BATCHES["valid"]()
    jplan, tplan = jfaults.FaultPlan(**spec), tfaults.FaultPlan(**spec)
    try:
        want = jb.check_batch(ps_j, plan=jplan)
    except jfaults.FaultInjected as e:
        want = str(e)
    try:
        got = tb.check_batch(_port(ps_j), plan=tplan, device="cpu")
    except tfaults.FaultInjected as e:
        got = str(e)
    assert got == want
    assert tplan.injected == jplan.injected
    assert tplan.injected[0] == (0, "parallel.batch", spec.get(
        "kinds", ["oom"])[0])
    if "at" in spec:
        assert got == _want("valid")


def test_real_error_is_raised(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tb, "core_check", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tb.check_batch(_port(BATCHES["valid"]()), device="cpu")


# -- chip_smoke's phase 12 corpus ------------------------------------------


def test_seed_invalid_equal_to_config5_script():
    script = _config5_script()
    p = jsynth.packed_la_history(2000, n_keys=250, seed=3,
                                 **chip_smoke.C5_KW)
    want = script.seed_invalid(dataclasses.replace(
        p, txn_type=p.txn_type.copy()))
    got = chip_smoke.seed_invalid(packed_from_arrays(p))
    np.testing.assert_array_equal(got.txn_type, want.txn_type)
    assert int((got.txn_type != p.txn_type).sum()) == 1


def test_config5_corpus_verdicts():
    ps = [chip_smoke.config5_history(i, n_txns=2000) for i in range(5)]
    want = jsynth.packed_la_history(2000, n_keys=250, seed=0,
                                    mops_per_txn=4, read_frac=0.25)
    np.testing.assert_array_equal(ps[0].mop_key, want.mop_key)
    got = tb.check_batch(ps, device="cpu")
    assert [r["valid?"] for r in got] == [True, True, False, False, True]
    assert got[3]["counts"]["G1a"] > 0
    assert any(got[2]["cycles"].values()) and all(r["exact"] for r in got)
