"""Port parity for `pad_packed` and `infer`
(`jepsen_tpu_torch/checkers/elle/device_infer.py`).

The port keeps one expansion structure on every device: the JAX package's
kernel branch (per-key and per-read values seeded at segment starts and
forward-filled).  So the JAX side runs that branch here on the CPU as
`tests/test_pallas_fill.py` does (JT_PALLAS=1 with the grid emulator,
JT_PALLAS_EMULATE=1, jit caches cleared around it), and every array
`infer` returns must be equal.  Histories stay far under 2^16 txns: with
JT_PALLAS=1 the JAX package would also send chain scans of 2^17+ rows to
the compiled TPU kernel, which the CPU cannot run.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import stale_reads  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.history.soa import TXN_FAIL  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from jepsen_tpu_torch.ops import fill  # noqa: E402


def _failed_first_txn(p):
    # an aborted writer whose appends stay visible: G1a, dirty-update
    p.txn_type = p.txn_type.copy()
    p.txn_type[0] = TXN_FAIL
    return p


def _corrupt_read_element(p):
    # one read element replaced: incompatible-order, internal
    p.rd_elems = p.rd_elems.copy()
    p.rd_elems[3] = p.rd_elems[9]
    return p


#: name -> PackedTxns (the JAX package's); odd sizes far under 2^16 txns
CORPORA = {
    "valid": lambda: synth.packed_la_history(531, n_keys=7, seed=3),
    "one-key": lambda: synth.packed_la_history(131, n_keys=1, seed=4),
    "g1a": lambda: _failed_first_txn(
        synth.packed_la_history(775, n_keys=19, seed=5)),
    "corrupt-element": lambda: _corrupt_read_element(
        synth.packed_la_history(777, n_keys=5, seed=6)),
    "stale-reads": lambda: stale_reads(
        synth.packed_la_history(1043, n_keys=130, seed=7)),
}

#: IR columns and facts stripped as tests/test_ir.py does (the in-program
#: sorts of infer); "all" also drops the layout facts, reaching the
#: two-key run sort, the argsort barrier order and the one-key process
#: sort
STRIP = {
    "ir": dict(v_cap=0, o_cap=0, app_val_mono=False, rd_start_mono=False,
               proc_seq=False, run_sort=None, inv_run=None,
               key_ord_len=None, key_ord_read=None, proc_order=None,
               barrier_order=None, barrier_bi=None),
}
STRIP["all"] = dict(STRIP["ir"], proc_seq=True, txn_major=False, run_cap=0,
                    complete_monotone=False)


def padded_pair(name, strip=None):
    """(JAX PaddedLA, port PaddedLA on the CPU, n_keys) for a corpus."""
    p = CORPORA[name]()
    hj = jdi.pad_packed(p)
    ht = tdi.pad_packed(packed_from_arrays(p), device="cpu")
    if strip:
        hj = dataclasses.replace(hj, **STRIP[strip])
        ht = dataclasses.replace(ht, **STRIP[strip])
    return hj, ht, p.n_keys


def leaves(a, b, path=""):
    """Pairs of leaf arrays of a JAX and a port `infer` output."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            yield from leaves(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from leaves(x, y, f"{path}[{i}]")
    else:
        yield path, np.asarray(a), b.numpy()


@pytest.fixture
def jax_kernel_branch(monkeypatch):
    """The JAX `infer` on its kernel (forward-fill) branch, through the
    grid emulator; the branch is chosen at trace time, so the jit cache
    is dropped on the way in and out."""
    monkeypatch.setenv("JT_PALLAS", "1")
    monkeypatch.setenv("JT_PALLAS_EMULATE", "1")
    jdi.infer.clear_cache()
    yield
    jdi.infer.clear_cache()


@pytest.mark.parametrize("name", list(CORPORA))
def test_pad_packed_equal_field_by_field(name):
    hj, ht, _ = padded_pair(name)
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
    assert ht.run_sort is not None and ht.v_cap and ht.o_cap


@pytest.mark.parametrize("name,strip", [
    ("valid", None), ("one-key", None), ("g1a", None),
    ("corrupt-element", None), ("stale-reads", None),
    ("stale-reads", "ir"), ("corrupt-element", "all"), ("g1a", "all"),
])
def test_infer_equal_to_jax_kernel_branch(jax_kernel_branch, monkeypatch,
                                          name, strip):
    hj, ht, n_keys = padded_pair(name, strip)
    want = jdi.infer(hj, n_keys)
    fill.LAUNCHES = 0
    calls = []
    monkeypatch.setattr(tdi, "locf",
                        lambda x: calls.append(x.shape) or fill.locf(x))
    got = tdi.infer(ht, n_keys)
    assert fill.LAUNCHES == 0  # CPU tensors take the plain forward-fill
    # 12 fills (9 with one key: no slot-key fills), and one each for the
    # monotone writer and read-element seed indices, which every corpus
    # takes unless its layout facts are stripped
    mono = int(ht.app_val_mono) + int(ht.rd_start_mono)
    assert mono == (0 if strip else 2), (ht.app_val_mono, ht.rd_start_mono)
    assert len(calls) == (9 if n_keys == 1 else 12) + mono, calls
    n = 0
    for path, w, g in leaves(want, got):
        np.testing.assert_array_equal(g, w, err_msg=path)
        if w.ndim:
            assert g.dtype == w.dtype, path
        n += 1
    assert n == 37
    counts = {k: int(v) for k, v in got["counts"].items()}
    if name == "valid":
        assert not any(counts.values()), counts
    if name == "g1a":
        assert counts["G1a"] > 0, counts
    if name == "corrupt-element":
        assert counts["incompatible-order"] > 0, counts
    if name == "stale-reads":
        assert int(got["edges"]["rw"][2].sum()) > 0


def test_default_device_is_the_card_never_the_cpu(monkeypatch):
    # with no device named and no card visible, the entry point raises
    # instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = packed_from_arrays(CORPORA["valid"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdi.pad_packed(p)
    h = tdi.pad_packed(p, device="cpu")
    assert h.rd_elems.device.type == "cpu"
    out = tdi.infer(h, p.n_keys)
    assert out["edges"]["ww"][0].device.type == "cpu"
