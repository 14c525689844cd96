"""Port parity for `check_batch` (`jepsen_tpu_torch/parallel/batch.py`):
the overflowed row's exact rerun, in a file of its own so that the test run spreads it over its
own worker.

Tolerance: exactly equal (see `test_torch_batch.py`).
"""

import pytest

pytest.importorskip("torch")

from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.parallel import batch as tb  # noqa: E402
from test_torch_batch import BATCHES, _port  # noqa: E402


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
