"""Port parity for stored histories: the op-level generator and its
injectors (`jepsen_tpu_torch/workloads/synth.py`), the store
(`jepsen_tpu_torch/store/`: codec, the `.jepsen` format, two-phase saves)
and the streamed check of a stored run (`checkers/elle/stream.py`).

Tolerance: exactly equal.  Histories are equal op for op, files byte for
byte, `stage_chunks`' arrays and every `infer` array on them bit for bit,
and `check_stored` returns the JAX package's dict.  Tests that need many
chunks patch `CHUNK_SIZE` in both packages, so that a few hundred txns
make several chunks.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.checkers.elle import stream as jstream  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.resilience import DeadlineExceeded as JDeadline  # noqa: E402
from jepsen_tpu.store import codec as jcodec  # noqa: E402
from jepsen_tpu.store import format as jformat  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import backend  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import stream as tstream  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.resilience import DeadlineExceeded  # noqa: E402
from jepsen_tpu_torch.store import codec as tcodec  # noqa: E402
from jepsen_tpu_torch.store import format as tformat  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from test_torch_infer import jax_kernel_branch, leaves  # noqa: E402,F401

SMALL_CHUNK = 64


def _dicts(h):
    return [dataclasses.asdict(op) for op in h]


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages read and write chunks of SMALL_CHUNK ops for the
    whole test (`LazyHistory.__getitem__` divides by the module's
    constant, so a file read under another size is mis-indexed)."""
    monkeypatch.setattr(jformat, "CHUNK_SIZE", SMALL_CHUNK)
    monkeypatch.setattr(tformat, "CHUNK_SIZE", SMALL_CHUNK)


# -- the op-level generator and its injectors ------------------------------


LA_KW = [
    dict(n_txns=200, n_keys=5, concurrency=5, seed=0),
    dict(n_txns=150, n_keys=3, concurrency=8, max_mops=6, read_prob=0.3,
         fail_prob=0.1, info_prob=0.1, multi_append_prob=0.3, seed=7),
    dict(n_txns=120, n_keys=5, concurrency=6, multi_append_prob=0.2,
         seed=5),
    dict(n_txns=1, n_keys=1, concurrency=1, seed=2),
]


@pytest.mark.parametrize("kw", LA_KW, ids=range(len(LA_KW)))
def test_la_history_equal_op_for_op(kw):
    want, got = jsynth.la_history(**kw), tsynth.la_history(**kw)
    assert isinstance(got, tops.History)
    assert _dicts(got) == _dicts(want)
    np.testing.assert_array_equal(got._pair, want._pair)


@pytest.mark.parametrize("inject", [
    "inject_g1a", "inject_g1b", "inject_wr_cycle", "inject_rw_cycle",
    "wr+rw x8", "g1a+wr",
])
@pytest.mark.parametrize("kw", LA_KW[:3], ids=range(3))
def test_injectors_equal_op_for_op(inject, kw):
    steps = {"wr+rw x8": ["inject_wr_cycle", "inject_rw_cycle"] * 8,
             "g1a+wr": ["inject_g1a", "inject_wr_cycle"]}.get(inject,
                                                              [inject])
    hj, ht = jsynth.la_history(**kw), tsynth.la_history(**kw)
    for step in steps:
        assert getattr(tsynth, step)(ht) == getattr(jsynth, step)(hj)
    assert _dicts(ht) == _dicts(hj)


def test_injector_helpers_equal():
    hj, ht = jsynth.la_history(**LA_KW[0]), tsynth.la_history(**LA_KW[0])
    for k in range(5):
        assert tsynth._key_order(ht, k) == jsynth._key_order(hj, k)
        for v in range(1, 60, 7):
            assert tsynth._prefix_through(ht, k, v) == \
                jsynth._prefix_through(hj, k, v)
            assert tsynth._prefix_before(ht, k, v) == \
                jsynth._prefix_before(hj, k, v)
    assert [dataclasses.asdict(o) for o in tsynth._ok_txns(ht)] == \
        [dataclasses.asdict(o) for o in jsynth._ok_txns(hj)]
    for oj, ot in zip(hj.ops, ht.ops):
        assert tsynth._appends(ot) == jsynth._appends(oj)
        assert tsynth._reads(ot) == jsynth._reads(oj)
        assert tsynth._touched_keys(ot) == jsynth._touched_keys(oj)


# -- codec -----------------------------------------------------------------


CODEC_VALUES = [
    None, 42, 3.5, "hi", [1, 2, 3], ("append", 3, 7),
    [("append", 1, 2), ("r", 1, [1, 2])],
    {"a": 1, "b": [True, False]}, {1: "x", (2, 3): "y"},
    {"§t": "literal-key"}, {1, 2, 3}, b"\x00\xffbytes",
    {"nested": {"deep": [({"k": (1,)},)]}},
    {frozenset({1, 2}): "x"}, frozenset({1}),
    np.int64(7), np.float32(1.5), np.bool_(True), np.arange(3),
]


@pytest.mark.parametrize("v", CODEC_VALUES, ids=range(len(CODEC_VALUES)))
def test_codec_round_trip_and_bytes_equal(v):
    b = tcodec.dumps(v)
    assert b == jcodec.dumps(v)
    assert tcodec.loads(b) == jcodec.loads(b)
    if not isinstance(v, (np.generic, np.ndarray)):
        assert tcodec.loads(b) == v
    assert type(tcodec.loads(b)) is type(jcodec.loads(b))


def test_codec_unserializable_placeholder_names_the_module():
    class Weird:
        pass

    out = tcodec.loads(tcodec.dumps({"db": Weird()}))
    assert out == jcodec.loads(jcodec.dumps({"db": Weird()}))
    assert out["db"]["§obj"] == f"{__name__}.{Weird.__qualname__}"
    # an object of a package names that package's module: the one place
    # where the two packages' files differ
    t = tcodec.loads(tcodec.dumps({"c": tstore.JepsenFile("x")}))
    j = jcodec.loads(jcodec.dumps({"c": jstore.JepsenFile("x")}))
    assert t["c"]["§obj"] == "jepsen_tpu_torch.store.format.JepsenFile"
    assert j["c"]["§obj"] == "jepsen_tpu.store.format.JepsenFile"


# -- the .jepsen format ----------------------------------------------------


def _mk_history(mod, n):
    ops = []
    for i in range(n // 2):
        ops.append(mod.invoke(i % 5, "txn", [("append", 1, i)]))
        ops.append(mod.ok(i % 5, "txn", [("append", 1, i)]))
    return mod.History(ops)


def test_format_round_trip_and_results(tmp_path):
    p = str(tmp_path / "t.jepsen")
    jf = tformat.JepsenFile(p)
    jf.write_test({"name": "fmt", "nodes": ["n1"], "concurrency": 5},
                  _mk_history(tops, 100))
    t2 = jf.read_test()
    assert t2 == {"name": "fmt", "nodes": ["n1"], "concurrency": 5}
    h2 = jf.read_history()
    assert isinstance(h2, tformat.LazyHistory)
    assert len(h2) == 100 and h2[99].index == 99
    assert h2[0].value == [("append", 1, 0)]  # tuples survive
    assert jf.read_results() is None
    size0 = os.path.getsize(p)
    jf.append_results({"valid?": True, "count": 10})
    assert os.path.getsize(p) > size0         # appended, not rewritten
    assert jf.read_results() == {"valid?": True, "count": 10}
    jf.append_results({"valid?": False})
    assert jf.read_results() == {"valid?": False}
    assert len(jf.read_history()) == 100
    assert tformat.CHUNK_SIZE == jformat.CHUNK_SIZE == 16384
    assert tformat.MAGIC == jformat.MAGIC


def test_format_lazy_chunks(tmp_path, small_chunks):
    p = str(tmp_path / "big.jepsen")
    n = SMALL_CHUNK * 2 + 10
    tformat.JepsenFile(p).write_test({"name": "big"}, _mk_history(tops, n))
    lh = tformat.JepsenFile(p).read_history()
    assert len(lh) == n and len(lh._chunks) == 3
    assert lh[SMALL_CHUNK].index == SMALL_CHUNK
    assert lh[-1].index == n - 1
    seen = [op.index for chunk in lh.iter_chunks() for op in chunk]
    assert seen == list(range(n))
    assert len(lh.materialize()) == n
    with pytest.raises(IndexError):
        lh[n]


@pytest.mark.parametrize("where", [40, -12])
def test_format_corruption_detected(tmp_path, where):
    p = str(tmp_path / "c.jepsen")
    tformat.JepsenFile(p).write_test({"name": "c"}, _mk_history(tops, 4))
    with open(p, "r+b") as f:
        f.seek(where, os.SEEK_SET if where >= 0 else os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(tformat.FormatError):
        tformat.JepsenFile(p).read()
    with open(p, "r+b") as f:
        f.write(b"NOTMAGIC")
    with pytest.raises(tformat.FormatError, match="bad magic"):
        tformat.JepsenFile(p).read_test()


# -- files pass between the packages ---------------------------------------


def _save_both(tmp_path, monkeypatch, hist_j, hist_t, results=None):
    """Save one plain-data test map with each package into its own
    directory under the same relative store dir; returns the two run
    dirs (JAX, port)."""
    dirs = []
    for pkg, hist, sub in ((jstore, hist_j, "jax"), (tstore, hist_t,
                                                      "torch")):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        t = {"name": "x-pkg", "store-dir": "store", "start-time": 1000.0,
             "nodes": ["n1", "n2"], "concurrency": 5,
             "checker-opts": {1: (2, 3), "s": {4}},
             "history": hist}
        pkg.save_0(t)
        if results is not None:
            t["results"] = results
            pkg.save_1(t)
        dirs.append(str(tmp_path / sub / pkg.test_dir(t)))
    return dirs


@pytest.mark.parametrize("with_results", [False, True])
def test_store_files_byte_equal_and_cross_loadable(tmp_path, monkeypatch,
                                                   small_chunks,
                                                   with_results):
    kw = dict(n_txns=150, n_keys=4, concurrency=5, fail_prob=0.05,
              info_prob=0.05, seed=3)
    hj, ht = jsynth.la_history(**kw), tsynth.la_history(**kw)
    res = {"valid?": False, "anomaly-types": ["G1c"],
           "counts": {"G1c": 1}} if with_results else None
    dj, dt = _save_both(tmp_path, monkeypatch, hj, ht, res)
    names = ["test.jepsen", "history.json"] + \
        (["results.json"] if with_results else [])
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == sorted(names)
    for name in names:
        with open(os.path.join(dj, name), "rb") as a, \
                open(os.path.join(dt, name), "rb") as b:
            assert a.read() == b.read(), name
    # each package loads the other's file into equal ops
    from_jax, from_port = tstore.load(dj), jstore.load(dt)
    assert len(from_jax["history"]._chunks) > 2
    assert _dicts(from_jax["history"]) == _dicts(hj.ops)
    assert _dicts(from_port["history"]) == _dicts(ht.ops)
    assert isinstance(from_jax["history"][0], tops.Op)
    strip = {"history"}
    assert {k: v for k, v in from_jax.items() if k not in strip} == \
        {k: v for k, v in jstore.load(dj).items() if k not in strip}
    if with_results:
        assert from_jax["results"] == from_port["results"] == res


def test_store_two_phase_listing_and_latest(tmp_path):
    base = str(tmp_path / "store")
    runs_j = str(tmp_path / "jstore")
    for i in range(2):
        for pkg, b, mod in ((tstore, base, tops), (jstore, runs_j, jops)):
            t = {"name": "lst", "store-dir": b,
                 "start-time": 1000.0 + i * 61,
                 "history": _mk_history(mod, 20),
                 "results": {"valid?": True, "i": i}}
            pkg.save_0(t)
            d = pkg.test_dir(t)
            assert os.path.exists(os.path.join(d, "history.json"))
            pkg.save_1(t)
    runs = tstore.tests("lst", base=base)
    assert [os.path.basename(r) for r in runs] == \
        [os.path.basename(r) for r in jstore.tests("lst", base=runs_j)]
    assert len(runs) == 2 and runs[0] > runs[1]
    assert tstore.latest("lst", base=base) == runs[0]
    assert tstore.latest(None, base=base) == runs[0]
    loaded = tstore.load("lst", "latest", base=base)
    assert loaded["results"] == {"valid?": True, "i": 1}
    assert tstore.load_results("lst", base=base) == loaded["results"]
    assert loaded["history"][3].value == [("append", 1, 1)]
    assert os.path.islink(os.path.join(base, "current"))
    assert tstore.sanitize("..") == jstore.sanitize("..") == "test"
    assert tstore.timestamp(1000.5) == jstore.timestamp(1000.5)
    tstore.delete("lst", base=base)
    assert tstore.tests("lst", base=base) == []
    with pytest.raises(FileNotFoundError):
        tstore.load("lst", base=base)


def test_store_save1_without_save0_secrets_and_gc(tmp_path):
    base = str(tmp_path / "s")
    t = {"name": "dicts", "store-dir": base, "password": "s3cret",
         "start-time": 5.0,
         "history": [{"type": "invoke", "process": 0, "f": "r",
                      "value": None},
                     {"type": "ok", "process": 0, "f": "r", "value": 1}],
         "results": {"valid?": np.True_}}
    tstore.save_1(t)
    d = tstore.test_dir(t)
    loaded = tstore.load(d)
    assert loaded["results"]["valid?"] is True
    assert "password" not in loaded
    assert b"s3cret" not in open(os.path.join(d, "test.jepsen"), "rb").read()
    unlanded = {"name": "run", "store-dir": base, "start-time": 10.0,
                "history": _mk_history(tops, 2)}
    tstore.save_0(unlanded)
    stats = tstore.gc_runs(base, retention_s=60.0)
    assert stats == {"archived": 1, "kept": 0, "skipped": 1}
    assert tstore.tests(base=base) == [tstore.test_dir(unlanded)]


# -- stage_chunks and check_stored -----------------------------------------


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


@pytest.mark.parametrize("name", ["valid", "wr-cycle", "g1a+rw"])
def test_check_stored_list_append_equal_to_jax(tmp_path, monkeypatch,
                                               small_chunks, name):
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
