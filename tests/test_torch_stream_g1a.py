"""Port parity for `check_stored` (`jepsen_tpu_torch/checkers/elle/
stream.py`) on the `g1a+rw` corpus of `test_torch_stream.py`, in a file
of its own so that the test run spreads it over its own worker.

Tolerance: exactly equal (see `test_torch_stream.py`).
"""

import pytest

pytest.importorskip("torch")

from test_torch_store import small_chunks  # noqa: E402,F401
from test_torch_stream import check_stored_case  # noqa: E402


@pytest.mark.parametrize("name", ["g1a+rw"])
def test_check_stored_list_append_equal_to_jax(tmp_path, monkeypatch,
                                               small_chunks, name):
    check_stored_case(tmp_path, monkeypatch, name)
