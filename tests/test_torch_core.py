"""Port parity for the verdict (`jepsen_tpu_torch/checkers/elle/
device_core.py`) and the copied generator.

`core_check` must give the JAX package's 13 bits and overflow on every
corpus (the JAX side on its default branch here on the CPU), and
`packed_la_history` must equal the original.  `core_check_exact` is in
`test_torch_core_exact.py` and `test_torch_core_faults.py`, the
hand-over helpers in `test_torch_padded.py`, the port's purity in
`test_torch_purity.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.workloads import synth  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.history import soa as tsoa  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from test_torch_infer import padded_pair  # noqa: E402

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
