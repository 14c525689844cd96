"""Port parity for the state hand-over helpers: `soa.packed_from_arrays`
and `device_infer.padded_from_numpy` / `padded_to_numpy` round-trip both
packages' arrays exactly, and a `PaddedLA` built from the JAX arrays
checks like the port's own.

Tolerance: exactly equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.history import soa as jsoa  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.history import soa as tsoa  # noqa: E402
from test_torch_infer import CORPORA, padded_pair  # noqa: E402


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
