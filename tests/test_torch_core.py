"""Port parity for the verdict (`jepsen_tpu_torch/checkers/elle/
device_core.py`), the state hand-over helpers, the copied generator, and
the port's purity.

`core_check` and `core_check_exact` must give the JAX package's 13 bits
and overflow on every corpus (the JAX side on its default branch here on
the CPU), the helpers must round-trip both packages' arrays exactly,
`packed_la_history` must equal the original, and importing the port and
running a check (`core_check_exact`, `list_append.check`, `oracle.check`)
must load neither `jax` nor `jepsen_tpu`.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.history import soa as jsoa  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.history import soa as tsoa  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from test_torch_infer import CORPORA, padded_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the kernels' expected verdicts: (corpus, strip) -> bits
EXPECTED = {
    ("valid", None): [0] * 12 + [1],
    ("stale-reads", None): [0] * 9 + [1, 1, 1, 1],
}


@pytest.mark.parametrize("name,strip", [
    ("valid", None), ("one-key", None), ("g1a", None),
    ("corrupt-element", None), ("stale-reads", None), ("stale-reads", "ir"),
])
def test_core_check_equal_to_jax(name, strip):
    hj, ht, n_keys = padded_pair(name, strip)
    want_bits, want_over = jdc.core_check(hj, n_keys)
    bits, over = tdc.core_check(ht, n_keys, device="cpu")
    assert bits.tolist() == np.asarray(want_bits).tolist()
    assert int(over) == int(want_over)
    if (name, strip) in EXPECTED:
        assert bits.tolist() == EXPECTED[name, strip]


@pytest.mark.parametrize("name,max_k", [("stale-reads", 8),
                                         ("g1a", 128)])
def test_core_check_exact_equal_to_jax(name, max_k):
    # max_k = 8 overflows on the stale reads: the grow retry runs
    hj, ht, n_keys = padded_pair(name)
    want_bits, want_over = jdc.core_check_exact(hj, n_keys, max_k=max_k)
    bits, over = tdc.core_check_exact(ht, n_keys, max_k=max_k, device="cpu")
    assert bits.tolist() == np.asarray(want_bits).tolist()
    assert int(over) == int(want_over) == 0
    _, over_first = tdc.core_check(ht, n_keys, max_k=max_k, device="cpu")
    assert (int(over_first) > 0) == (name == "stale-reads")


def test_grow_until_exact_rules():
    calls = []

    def run(k, r):
        # overflow until k >= 40, then the fixpoint needs r >= 16
        calls.append((k, r))
        over = max(40 - k, 0)
        conv = int(over == 0 and r >= 16)
        return torch.tensor([0] * 12 + [conv]), torch.tensor(over)

    bits, over = tdc.grow_until_exact(run, max_k=8, max_rounds=4)
    assert calls == [(8, 4), (64, 4), (64, 8), (64, 16)]
    assert int(bits[-1]) == 1 and int(over) == 0


def test_include_stacks_equal_to_jax():
    assert tdc.proj_include_stack().tolist() == \
        np.asarray(jdc.proj_include_stack()).tolist()
    assert tdc.chain_include_stack().tolist() == \
        np.asarray(jdc.chain_include_stack()).tolist()
    assert tdc.PROJECTIONS == jdc.PROJECTIONS
    assert tdc.COUNT_NAMES == jdc.COUNT_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_la_history_equal_to_original(seed):
    kw = [dict(n_txns=300, n_keys=40), dict(n_txns=517, n_keys=1),
          dict(n_txns=1000, n_keys=125, concurrency=3, mops_per_txn=6,
               read_frac=0.3)][seed]
    want = synth.packed_la_history(seed=seed, **kw)
    got = tsynth.packed_la_history(seed=seed, **kw)
    for f in tsoa.PACKED_COLS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.key_names == want.key_names
    assert got.val_names == want.val_names
    assert got.n_events == want.n_events


def test_soa_constants_equal_to_jax():
    for c in ("MOP_APPEND", "MOP_READ", "TXN_OK", "TXN_FAIL", "TXN_INFO"):
        assert getattr(tsoa, c) == getattr(jsoa, c), c


def test_packed_from_arrays_round_trip():
    p = CORPORA["g1a"]()
    q = tsoa.packed_from_arrays(p)
    assert isinstance(q, tsoa.PackedTxns)
    for f in tsoa.PACKED_COLS:
        np.testing.assert_array_equal(getattr(q, f), getattr(p, f))
        assert getattr(q, f) is not getattr(p, f)   # copied
    assert (q.n_txns, q.n_mops, q.n_keys, q.n_vals, q.n_events) == \
        (p.n_txns, p.n_mops, p.n_keys, p.n_vals, p.n_events)
    back = jsoa.PackedTxns(**dataclasses.asdict(q))
    np.testing.assert_array_equal(back.rd_elems, p.rd_elems)


@pytest.mark.parametrize("strip", [None, "ir"])
def test_padded_from_numpy_round_trip(strip):
    hj, ht, n_keys = padded_pair("stale-reads", strip)
    fields = {f: None if getattr(hj, f) is None else np.asarray(getattr(hj, f))
              for f in tdi.DATA_FIELDS}
    statics = {f: getattr(hj, f) for f in tdi.STATIC_FIELDS}
    h2 = tdi.padded_from_numpy(fields, statics, device="cpu")
    f2, s2 = tdi.padded_to_numpy(h2)
    assert s2 == statics
    for f in tdi.DATA_FIELDS:
        if fields[f] is None:
            assert f2[f] is None, f
        else:
            assert f2[f].dtype == fields[f].dtype, f
            np.testing.assert_array_equal(f2[f], fields[f], err_msg=f)
    # a PaddedLA built from the JAX arrays checks exactly like the port's
    assert tdc.core_check(h2, n_keys, device="cpu")[0].tolist() == \
        tdc.core_check(ht, n_keys, device="cpu")[0].tolist()


def test_port_imports_neither_jax_nor_jepsen_tpu():
    code = """
import pkgutil, importlib, sys
import jepsen_tpu_torch
for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__, "jepsen_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from jepsen_tpu_torch.checkers.elle import device_core, device_infer
from jepsen_tpu_torch.workloads.synth import packed_la_history
p = chip_smoke.stale_reads(packed_la_history(300, n_keys=20, seed=1))
h = device_infer.pad_packed(p, device="cpu")
bits, over = device_core.core_check_exact(h, p.n_keys, device="cpu")
assert bits.tolist()[12] == 1, bits
from jepsen_tpu_torch.checkers.elle import list_append, oracle
from jepsen_tpu_torch.history import history, invoke, ok
h = history([invoke(0, "txn", [["append", "x", 1], ["r", "y", None]]),
             invoke(1, "txn", [["append", "y", 9], ["r", "x", None]]),
             ok(0, "txn", [["append", "x", 1], ["r", "y", [9]]]),
             ok(1, "txn", [["append", "y", 9], ["r", "x", [1]]])])
r = list_append.check(h, ["strict-serializable"], device="cpu",
                      _force_no_fallback=True)
o = oracle.check(h, ["strict-serializable"])
assert (r["valid?"], r["anomaly-types"]) == (o["valid?"], o["anomaly-types"])
assert "G1c" in r["anomaly-types"], r
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("loaded:", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "loaded: []" in res.stdout
