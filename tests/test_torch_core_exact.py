"""Port parity for `core_check_exact` (`jepsen_tpu_torch/checkers/elle/
device_core.py`): the 13 bits and overflow of the JAX package on the
corpora whose budget overflows, the grow rules of `grow_until_exact`, and
an expired deadline raised with the JAX message.

Tolerance: exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from test_torch_infer import padded_pair  # noqa: E402


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


def test_core_check_exact_expired_deadline_raises_like_jax():
    hj, ht, n_keys = padded_pair("stale-reads")
    with pytest.raises(jres.DeadlineExceeded) as want:
        jdc.core_check_exact(hj, n_keys, deadline=jres.Deadline(0))
    with pytest.raises(tres.DeadlineExceeded) as got:
        tdc.core_check_exact(ht, n_keys, deadline=tres.Deadline(0),
                             device="cpu")
    assert str(got.value) == str(want.value) == "elle.grow-until-exact"
    # an unexpired deadline changes nothing
    bits, over = tdc.core_check_exact(ht, n_keys, max_k=8,
                                      deadline=tres.Deadline(600),
                                      device="cpu")
    assert bits.tolist() == \
        np.asarray(jdc.core_check_exact(hj, n_keys, max_k=8)[0]).tolist()
