"""Port parity for `check_batch` (`jepsen_tpu_torch/parallel/batch.py`)
on the `mixed` corpus of `test_torch_batch.py`, in a file of its own so
that the test run spreads it over its own worker.

Tolerance: exactly equal (see `test_torch_batch.py`).
"""

import pytest

pytest.importorskip("torch")

from test_torch_batch import check_batch_case  # noqa: E402


@pytest.mark.parametrize("name", ["mixed"])
def test_check_batch_equal_to_jax_and_to_each_alone(name):
    check_batch_case(name)
