"""History substrate (the port's copy of `jepsen_tpu/history`): Op
records and dense histories (`ops`), and their structure-of-array packing
for the device (`soa`).  The JAX package's device folds (`fold`) and its
`HistoryIR` (`ir`) are not ported yet.
"""

from jepsen_tpu_torch.history.ops import (
    Op,
    History,
    history,
    invoke,
    ok,
    fail,
    info,
    INVOKE,
    OK,
    FAIL,
    INFO,
)
from jepsen_tpu_torch.history.soa import PackedTxns, pack_txns

__all__ = [
    "Op",
    "History",
    "history",
    "invoke",
    "ok",
    "fail",
    "info",
    "INVOKE",
    "OK",
    "FAIL",
    "INFO",
    "PackedTxns",
    "pack_txns",
]
