"""History substrate (the port's copy of `jepsen_tpu/history`): Op
records and dense histories (`ops`), their structure-of-array packing
for the device (`soa`), and `HistoryIR` (`ir`), which packs and pads a
history once for every check of it.  The JAX package's device folds
(`fold`) are not ported yet.
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
from jepsen_tpu_torch.history.ir import HistoryIR

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
    "HistoryIR",
]
