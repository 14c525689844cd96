"""Automated anomaly triage: shrink invalid runs to minimal failing
witnesses (the port's copy of `jepsen_tpu/minimize`).

An invalid verdict over a 100k-op history is not actionable on its own;
what a human debugs is the 6-op core of the cycle (the Elle insight:
minimal witnesses are what make anomaly reports usable).  This package
delta-debugs (ddmin, Zeller & Hildebrandt TSE '02) any stored run whose
checker returned ``valid? false`` down to a minimal sub-history that
STILL fails with the same anomaly class:

- :mod:`~.reduce`  — the ddmin engine over closure-safe invoke/ok
  units, with structure-aware phases (drop processes → project keys →
  ddmin op ranges);
- :mod:`~.probe`   — candidate re-checks through the original checker,
  fanned out in parallel via the campaign scheduler (device probes
  serialized through DeviceSlots), each under a per-probe Deadline;
  a probe whose error names `KernelError` or `NoDeviceError` makes the
  shrink raise instead of counting as "does not reproduce";
- :mod:`~.witness` — the persisted ``witness.jsonl`` + ``witness.json``
  (explained cycle, stable digests; re-shrinking an unchanged run is a
  cache hit);
- :mod:`~.core`    — the :func:`shrink` orchestrator with per-round
  telemetry spans.

Surfaces: ``python -m jepsen_tpu_torch shrink <run-dir>`` (on the card,
or the CPU under ``--cpu``) and the campaign spec key ``"shrink": true``
(invalid cells get a witness column).  See ``docs/MINIMIZE.md``.
"""

from jepsen_tpu_torch.minimize.core import shrink
from jepsen_tpu_torch.minimize.probe import ProbePool, resolve_checker
from jepsen_tpu_torch.minimize.reduce import (
    Reducer,
    Unit,
    build_history,
    units_of,
)
from jepsen_tpu_torch.minimize.witness import (
    history_digest,
    load_witness,
    save_witness,
    witness_paths,
)

__all__ = [
    "shrink", "ProbePool", "resolve_checker", "Reducer", "Unit",
    "build_history", "units_of", "history_digest", "load_witness",
    "save_witness", "witness_paths",
]
