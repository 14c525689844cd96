"""Linearizable register workload (the port's copy of
`jepsen_tpu/workloads/linearizable_register.py`).

Equivalent of the reference's
`jepsen/src/jepsen/tests/linearizable_register.clj` (SURVEY.md §2.6):
read / write / cas ops against one register, checked for linearizability by
the Knossos-equivalent search (`BASELINE.json:7`'s etcd-register shape),
whose device leg runs on `device` (the CUDA card unless the caller names
the CPU).
"""

from __future__ import annotations

import random
from typing import Any, Optional

from ..backend import DeviceLike
from ..checkers import api as checker_api
from ..models import cas_register


class _RegisterGen:
    def __init__(self, *, values: int = 5, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self.values = values

    def __call__(self, test, ctx):
        r = self.rng.random()
        if r < 1 / 3:
            return {"f": "read", "value": None}
        if r < 2 / 3:
            return {"f": "write", "value": self.rng.randrange(self.values)}
        return {"f": "cas", "value": [self.rng.randrange(self.values),
                                      self.rng.randrange(self.values)]}


def gen(**opts) -> Any:
    return _RegisterGen(**opts)


def workload(*, values: int = 5, algorithm: str = "auto",
             rng: Optional[random.Random] = None,
             device: DeviceLike = None) -> dict:
    return {
        "generator": gen(values=values, rng=rng),
        "checker": checker_api.Linearizable(model=cas_register(),
                                            algorithm=algorithm,
                                            device=device),
    }
