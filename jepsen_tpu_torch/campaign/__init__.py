"""Campaign layer: run, index, and regression-check whole *fleets* of
tests (the port's copy of `jepsen_tpu/campaign`).

`core.run` orchestrates exactly one test; a production-scale system
runs many seeds × workloads × fault plans concurrently and keeps the
verdicts queryable across campaigns.  Four pieces:

- :mod:`~.plan` — declarative campaign spec (JSON/dict matrix) expanded
  into :class:`~.plan.RunSpec` rows with *stable* per-run ids (same
  spec → same ids, the resume/regression key);
- :mod:`~.scheduler` — a device-aware worker pool: host-only runs fill
  all workers freely, device-pipeline runs serialize through a bounded
  set of device slots; per-run isolation via thread or subprocess
  executors, with `resilience.RetryPolicy` retries on crashed runs and
  `Deadline` budgets threaded into each test map;
- :mod:`~.index` — the persistent results database: an append-only,
  fsync'd, torn-line-tolerant jsonl ledger keyed by run id, supporting
  resume (completed runs skipped on restart) and regression queries
  (verdict flips per (workload, fault, seed) key, checker span
  duration trends across campaign generations);
- :mod:`~.core` — the orchestrator: `run_campaign(spec)` → summary,
  plus `status`/`report` and the single-run executor the scheduler and
  the subprocess runner share.

Surfaces: ``python -m jepsen_tpu_torch campaign run|status|report
<spec.json>`` (the cells' checkers on the card, or the CPU under
``--cpu``) and `report.render_campaign` (suite rollup).

See ``docs/CAMPAIGN.md``.
"""

from jepsen_tpu_torch.campaign.core import (
    execute_run,
    report_campaign,
    run_campaign,
    status_campaign,
)
from jepsen_tpu_torch.campaign.index import Index
from jepsen_tpu_torch.campaign.plan import RunSpec, expand, load_spec
from jepsen_tpu_torch.campaign.scheduler import DeviceSlots, Scheduler

__all__ = [
    "RunSpec", "expand", "load_spec",
    "Scheduler", "DeviceSlots",
    "Index",
    "run_campaign", "status_campaign", "report_campaign", "execute_run",
]
