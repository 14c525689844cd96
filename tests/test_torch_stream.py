"""Port parity for the streamed check of a stored run
(`jepsen_tpu_torch/checkers/elle/stream.py`): `stage_chunks`' arrays and
every `infer` array on them bit for bit, and `check_stored` returns the
JAX package's dict, for list-append and rw-register, an empty or missing
history and an expired deadline.  Tests that need many chunks patch
`CHUNK_SIZE` in both packages (`test_torch_store.small_chunks`), so that a
few hundred txns make several chunks.

Tolerance: exactly equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.checkers.elle import stream as jstream  # noqa: E402
from jepsen_tpu.resilience import DeadlineExceeded as JDeadline  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import stream as tstream  # noqa: E402
from jepsen_tpu_torch.resilience import DeadlineExceeded  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from test_torch_infer import jax_kernel_branch, leaves  # noqa: E402,F401
from test_torch_store import _save_both, small_chunks  # noqa: E402,F401


def _stored_pair(tmp_path, monkeypatch, h_j, h_t):
    """(JAX test map, port test map), each its own package's `load` of
    its own save of the same history."""
    dj, dt = _save_both(tmp_path, monkeypatch, h_j, h_t)
    return jstore.load(dj), tstore.load(dt)


def _la_corpus(name):
    kw = dict(n_txns=300, n_keys=6, concurrency=6, multi_append_prob=0.2,
              seed=9)
    pair = []
    for synth in (jsynth, tsynth):
        h = synth.la_history(**kw)
        if name == "wr-cycle":
            assert synth.inject_wr_cycle(h)
        elif name == "g1a+rw":
            assert synth.inject_g1a(h) and synth.inject_rw_cycle(h)
        pair.append(h)
    return pair


def test_stage_chunks_every_array_equal(tmp_path, monkeypatch, small_chunks,
                                        jax_kernel_branch):
    tj, tt = _stored_pair(tmp_path, monkeypatch, *_la_corpus("wr-cycle"))
    assert len(tt["history"]._chunks) > 5
    hj, pj = jstream.stage_chunks(tj["history"].iter_chunks())
    ht, pt = tstream.stage_chunks(tt["history"].iter_chunks(),
                                  device="cpu")
    assert (pt.n_txns, pt.n_mops, pt.key_names, pt.val_names) == \
        (pj.n_txns, pj.n_mops, pj.key_names, pj.val_names)
    fields, statics = tdi.padded_to_numpy(ht)
    for f in tdi.DATA_FIELDS:
        want = getattr(hj, f)
        assert (want is None) == (fields[f] is None), f
        if want is not None:
            want = np.asarray(want)
            assert fields[f].dtype == want.dtype, f
            np.testing.assert_array_equal(fields[f], want, err_msg=f)
    for f in tdi.STATIC_FIELDS:
        assert statics[f] == getattr(hj, f), f
    # the layout facts hold; no IR columns, so V = O = R and the rest
    # of the facts are off
    assert ht.txn_major and ht.run_cap and ht.complete_monotone
    assert ht.v_cap == ht.o_cap == 0 and ht.run_sort is None
    assert not (ht.app_val_mono or ht.rd_start_mono or ht.proc_seq)
    n = 0
    for path, a, b in leaves(jdi.infer(hj, hj.n_keys),
                             tdi.infer(ht, ht.n_keys)):
        np.testing.assert_array_equal(b, a, err_msg=path)
        if a.ndim:   # 0-d counts and witnesses are int64 scalars here
            assert b.dtype == a.dtype, path
        n += 1
    assert n == 37


def test_stage_chunks_empty_and_default_device(monkeypatch):
    h, pk = tstream.stage_chunks(iter([]), device="cpu")
    assert pk.n_txns == 0 and h.txn_type.shape == (8,)
    assert not bool(h.txn_mask.any())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.NoDeviceError):
        tstream.stage_chunks(iter([]))


def check_stored_case(tmp_path, monkeypatch, name):
    """`check_stored` of corpus `name` equals the JAX package's (the
    `wr-cycle` and `g1a+rw` cases run from `test_torch_stream_cycle.py`
    and `test_torch_stream_g1a.py`, files of their own, so that the test
    run spreads them over workers of their own).  Call it under the
    `small_chunks` fixture."""
    tj, tt = _stored_pair(tmp_path, monkeypatch, *_la_corpus(name))
    want = jstream.check_stored(tj)
    got = tstream.check_stored(tt, device="cpu")
    assert got == want
    assert got["valid?"] is (name == "valid") and got["exact"]
    if name == "wr-cycle":
        assert got["cycles"]["G1c"]
    # a store dir path works the same way
    assert tstream.check_stored(
        os.path.dirname(tt["history"]._path), device="cpu") == want


@pytest.mark.parametrize("name", ["valid"])
def test_check_stored_list_append_equal_to_jax(tmp_path, monkeypatch,
                                               small_chunks, name):
    check_stored_case(tmp_path, monkeypatch, name)


def test_check_stored_rw_register_equal_to_jax(tmp_path, monkeypatch,
                                               small_chunks):
    kw = dict(n_txns=150, n_keys=6, concurrency=5, seed=2)
    tj, tt = _stored_pair(tmp_path, monkeypatch, jsynth.rw_history(**kw),
                          tsynth.rw_history(**kw))
    want = jstream.check_stored(tj, workload="rw-register")
    got = tstream.check_stored(tt, workload="rw-register", device="cpu")
    assert got == want
    assert got["valid?"] is True and "lost-update" in got["counts"]
    assert got["n-txns"] == 150


def test_check_stored_unknown_and_deadline(tmp_path, monkeypatch):
    for t in ({"name": "none"}, {"name": "empty", "history": []}):
        assert tstream.check_stored(dict(t), device="cpu") == \
            jstream.check_stored(dict(t))
    hj, ht = _la_corpus("valid")
    tj, tt = _stored_pair(tmp_path, monkeypatch, hj, ht)
    tj["checker-time-limit"] = tt["checker-time-limit"] = 0
    with pytest.raises(JDeadline) as want:
        jstream.check_stored(tj)
    with pytest.raises(DeadlineExceeded) as got:
        tstream.check_stored(tt, device="cpu")
    assert str(got.value) == str(want.value)
