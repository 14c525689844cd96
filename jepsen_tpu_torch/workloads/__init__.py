"""Workloads (L5, SURVEY.md §2.6): test suites the framework expresses
(the port's copy of `jepsen_tpu/workloads/__init__.py`).

Each workload module exposes ``workload(**opts) -> dict`` with
``generator`` / ``checker`` (and optionally ``final-generator`` plus extra
test-map keys), mirroring the reference's `{:generator :client :checker
:final-generator}` workload maps.  Clients come from the db-specific suite
(or `jepsen_tpu_torch.workloads.mem` for in-process runs).  A workload's
checker runs on its ``device=`` argument: the CUDA card unless the caller
names the CPU.  `synth` holds the synthetic packed and op-level history
generators.
"""

from . import append, bank, linearizable_register, long_fork, queue, sets, wr

__all__ = ["append", "bank", "linearizable_register", "long_fork",
           "queue", "sets", "wr"]
