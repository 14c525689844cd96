"""Port parity for `check_batch` (`jepsen_tpu_torch/parallel/batch.py`):
the checkpoint's digests against the JAX package's, in a file of its own so that the test run spreads it over its
own worker.

Tolerance: exactly equal (see `test_torch_batch.py`).
"""

import pytest

pytest.importorskip("torch")

from jepsen_tpu.parallel import batch as jb  # noqa: E402
from jepsen_tpu_torch.parallel import batch as tb  # noqa: E402
from test_torch_batch import BATCHES, _port  # noqa: E402


def test_digests_equal_between_the_packages(tmp_path):
    # the checkpoint's digest hashes the PackedTxns columns' bytes: the
    # port's columns carry the JAX dtypes, so every digest agrees
    ps_j = BATCHES["mixed"]()
    ck_j, ck_t = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jb.check_batch_checkpointed(ps_j, ck_j, group_size=5)
    tb.check_batch_checkpointed(_port(ps_j), ck_t, group_size=5,
                                device="cpu")
    assert open(ck_t, "rb").read() == open(ck_j, "rb").read()
