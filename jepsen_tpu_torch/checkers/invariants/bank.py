"""Bank invariants: total balance + snapshot reads, vectorized (the port's
copy of `jepsen_tpu/checkers/invariants/bank.py`).

The reference's `jepsen/tests/bank.clj` checker as whole-history array
reductions over the SoA packing (:func:`packed.pack_bank`):

- **total balance**: every committed whole-state read must sum to the
  initial total (under snapshot isolation a read observes one atomic
  snapshot; transfers conserve money, so any other sum is read skew);
- **negative balances**: flagged unless the workload allows them
  (`negative-balances-ok`).

Both checks are one pass over the ``[n_reads, n_accounts]`` balance
matrix: row sums, sign tests, boolean reductions.  The **device path**
runs that pass as torch reductions on the entry point's device (the CUDA
card unless the caller names the CPU) through
`resilience.with_fallback` (site ``invariants.bank``) with retry /
deadline / fault-plan semantics.  The **host numpy oracle twin**
(`host_verdict`, ``use_device=False``) is the exact same arithmetic.
Only a synthetic `FaultInjected` of a fault plan degrades to it, with
``"degraded": "host-fallback"`` stamped; every other device error is
raised, where the JAX package degrades any exception.

The balances stay int64 on the device.  The JAX package runs without
x64, so its device sums are int32 and wrap above 2^31 - 1; the two agree
wherever the sums fit in int32.

Result shape matches the elle family (``valid?`` / ``anomaly-types`` /
``anomalies``) and keeps the legacy bank keys (``bad-reads`` /
``bad-read-count`` / ``read-count``) the workload tests and perf plots
already consume.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.invariants import packed as packed_mod
from jepsen_tpu_torch.checkers.invariants.packed import PackedBank

WRONG_TOTAL = "bank-wrong-total"
NEGATIVE = "bank-negative-balance"

SITE = "invariants.bank"


def resolve_total(test: Optional[dict], pb: PackedBank,
                  total: Optional[int] = None) -> Optional[int]:
    """The expected conserved total: explicit arg > test map
    ``total-amount`` > sum of the test's initial ``accounts`` > the
    modal read sum (so a single anomalous read can't become the
    baseline)."""
    if total is not None:
        return int(total)
    t = (test or {}).get("total-amount")
    if t is not None:
        return int(t)
    accounts = (test or {}).get("accounts")
    if isinstance(accounts, dict) and accounts:
        return int(sum(accounts.values()))
    if pb.n_reads:
        sums = pb.balances.sum(axis=1)
        vals, counts = np.unique(sums, return_counts=True)
        return int(vals[np.argmax(counts)])
    return None


def _reduce_host(balances: np.ndarray, total: int, negative_ok: bool):
    """The one reduction both paths implement: (row sums, wrong-total
    mask, negative mask)."""
    sums = balances.sum(axis=1)
    wrong = sums != total
    neg = (balances < 0).any(axis=1) if not negative_ok \
        else np.zeros(len(balances), bool)
    return sums, wrong, neg


def _reduce_device(balances: np.ndarray, total: int, negative_ok: bool,
                   dev: torch.device):
    """`_reduce_host` as torch reductions on `dev`, int64 throughout.
    Sharded by default, as in the JAX package: the rows (reads) split
    over the mesh `parallel.slots.default_mesh` resolves for `dev`
    (`place_sharded`), each block reduced on its shard's device and the
    results concatenated in order."""
    from jepsen_tpu_torch.parallel.slots import place_sharded

    parts = []
    for b in place_sharded(np.ascontiguousarray(balances, np.int64),
                           device=dev):
        sums = b.sum(dim=1)
        wrong = sums != total
        neg = (b < 0).any(dim=1) if not negative_ok \
            else torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
        parts.append([x.cpu().numpy() for x in (sums, wrong, neg)])
    return tuple(np.concatenate(col) for col in zip(*parts))


def host_verdict(pb: PackedBank, total: int, negative_ok: bool,
                 max_reported: int = 8) -> Dict[str, Any]:
    """The exact host oracle twin — numpy only, no tensors."""
    sums, wrong, neg = _reduce_host(pb.balances, total, negative_ok)
    return _render(pb, total, sums, wrong, neg, max_reported)


def _render(pb: PackedBank, total: int, sums, wrong, neg,
            max_reported: int) -> Dict[str, Any]:
    found: Dict[str, list] = {}
    bad = wrong | neg
    bad_reads = []
    for i in np.nonzero(bad)[0][:max_reported]:
        entry = {
            "op-index": int(pb.read_op_index[i]),
            "process": int(pb.read_process[i]),
            "total": int(sums[i]),
            "expected-total": int(total),
            "negative": [pb.accounts[j]
                         for j in np.nonzero(pb.balances[i] < 0)[0]],
        }
        bad_reads.append(entry)
        if wrong[i]:
            found.setdefault(WRONG_TOTAL, []).append(entry)
        if neg[i]:
            found.setdefault(NEGATIVE, []).append(entry)
    return {
        "valid?": not bool(bad.any()),
        "anomaly-types": sorted(found),
        "anomalies": found,
        "read-count": pb.n_reads,
        "bad-read-count": int(bad.sum()),
        "bad-reads": bad_reads,
        "expected-total": int(total),
    }


def check(history, test: Optional[dict] = None, *,
          negative_balances_ok: bool = False,
          total: Optional[int] = None,
          use_device: bool = True,
          max_reported: int = 8,
          deadline=None, plan=None, policy=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a bank history.  Accepts a History / op list / PackedBank /
    HistoryIR.

    The device path runs on `device` (the CUDA card unless the caller
    names the CPU; no card raises `backend.NoDeviceError`), guarded,
    retried and deadline-polled; a synthetic fault of `plan` degrades to
    the host twin with the standard stamp.  ``use_device=False`` IS the
    host twin — the two must agree verdict-for-verdict."""
    from jepsen_tpu_torch import resilience, telemetry
    from jepsen_tpu_torch.history.ir import HistoryIR

    dev = backend.resolve(device) if use_device else None
    ph = telemetry.phases()
    pb = history if isinstance(history, PackedBank) else None
    if pb is None:
        accounts = ((test or {}).get("accounts") or {}).keys() or None
        ph.start("invariants.pack", device=False)
        pb = (history.bank(accounts)
              if isinstance(history, HistoryIR)
              else packed_mod.pack_bank(history, accounts=accounts))
    t = resolve_total(test, pb, total)
    if not pb.n_reads or t is None:
        ph.end()
        return {"valid?": "unknown", "read-count": pb.n_reads,
                "anomaly-types": [], "anomalies": {}, "bad-reads": []}
    if deadline is not None:
        deadline.check(SITE)
    if not use_device:
        ph.start("invariants.check", device=False, reads=pb.n_reads)
        res = host_verdict(pb, t, negative_balances_ok, max_reported)
        ph.end()
        return res
    ph.start("invariants.check", device=True, reads=pb.n_reads)
    try:
        (sums, wrong, neg), degraded = resilience.with_fallback(
            SITE,
            lambda: _reduce_device(pb.balances, t, negative_balances_ok,
                                   dev),
            lambda: _reduce_host(pb.balances, t, negative_balances_ok),
            deadline=deadline, plan=plan, policy=policy)
    except resilience.DeadlineExceeded:
        ph.end()
        return resilience.deadline_result(checker="bank")
    res = _render(pb, t, sums, wrong, neg, max_reported)
    if degraded:
        res["degraded"] = degraded
    ph.end()
    return res
