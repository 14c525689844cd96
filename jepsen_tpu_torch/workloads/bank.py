"""Bank workload (the port's copy of `jepsen_tpu/workloads/bank.py`).

Equivalent of the reference's `jepsen/src/jepsen/tests/bank.clj`
(SURVEY.md §2.6): concurrent transfers between accounts plus whole-state
reads; under snapshot isolation the total balance must be invariant, and
read skew shows up as reads whose balances don't sum to the expected total.
Negative balances are flagged unless the test allows them.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..checkers.invariants import bank as inv_bank


class _BankGen:
    def __init__(self, *, accounts=(0, 1, 2, 3, 4, 5, 6, 7),
                 max_transfer: int = 5, read_frac: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.accounts = list(accounts)
        self.max_transfer = max_transfer
        self.read_frac = read_frac
        self.rng = rng or random.Random()

    def __call__(self, test, ctx):
        if self.rng.random() < self.read_frac:
            return {"f": "read", "value": None}
        frm, to = self.rng.sample(self.accounts, 2)
        return {"f": "transfer",
                "value": {"from": frm, "to": to,
                          "amount": 1 + self.rng.randrange(self.max_transfer)}}


def gen(**opts) -> Any:
    return _BankGen(**opts)


class BankChecker(checker_api.Checker):
    """Total-balance + snapshot-read invariants, delegated to the
    vectorized invariants family (`checkers/invariants/bank.py`): the
    reads become a dense [n_reads, n_accounts] matrix whose row sums /
    sign checks run as one array reduction on `device` (the CUDA card
    unless it names another).

    Reference `bank/checker`: :bad-reads = reads with wrong total or
    (unless negative-balances?) any negative balance."""

    def __init__(self, *, negative_balances_ok: bool = False,
                 device: DeviceLike = None):
        self.negative_ok = negative_balances_ok
        self.device = device

    def name(self) -> str:
        return "bank"

    def check(self, test, history, opts=None):
        return inv_bank.check(
            history, test,
            negative_balances_ok=self.negative_ok,
            deadline=(opts or {}).get("deadline"), device=self.device)


def workload(*, n_accounts: int = 8, total: int = 80, max_transfer: int = 5,
             negative_balances_ok: bool = False,
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    """Also returns the test-map keys the checker needs (accounts/total),
    like the reference workload's extra test keys."""
    accounts = {i: total // n_accounts for i in range(n_accounts)}
    return {
        "generator": gen(accounts=range(n_accounts),
                         max_transfer=max_transfer, rng=rng),
        "checker": BankChecker(negative_balances_ok=negative_balances_ok,
                               device=device),
        "accounts": accounts,
        # derived from the actual initial balances, so a non-divisible
        # `total` can't make every read look invalid
        "total-amount": sum(accounts.values()),
        "workload-kind": "bank",
    }
