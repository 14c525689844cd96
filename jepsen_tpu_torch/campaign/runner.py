"""Subprocess executor entry: one isolated campaign run (the port's copy
of `jepsen_tpu/campaign/runner.py`).

``python -m jepsen_tpu_torch.campaign.runner`` reads ``{"runspec":
{...}, "base": "store", "workloads": [...]}`` JSON on stdin, registers
the campaign's importable workloads (`plan.register_imported`),
executes the run, and prints the index record as its LAST stdout line
(the scheduler parses bottom-up, so workload logging above it is
harmless).  A crashing run exits non-zero with NO record line — the
scheduler treats that as a failed attempt, retries per its policy, and
only then indexes the crash record; a clean exit always carries a
record.

The run's checkers run on the card unless its opts say ``"cpu"``
(`campaign.core.run_campaign` sets it); ``JT_FORCE_CPU`` is not read.
SIGTERM (the scheduler's deadline) becomes `SystemExit`, so the run's
teardown stops what it started before the process group is killed.
"""

from __future__ import annotations

import json
import os
import signal
import sys


def _stop(signum, _frame):
    raise SystemExit(128 + signum)


def main() -> int:
    signal.signal(signal.SIGTERM, _stop)
    payload = json.loads(sys.stdin.read() or "{}")
    import logging

    logging.basicConfig(
        level=logging.WARNING, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from jepsen_tpu_torch.campaign.core import execute_run
    from jepsen_tpu_torch.campaign.plan import RunSpec, register_imported

    register_imported(payload.get("workloads") or [])
    rs = RunSpec.from_dict(payload["runspec"])
    rec = execute_run(rs, payload.get("base") or "store")
    slot = os.environ.get("JEPSEN_CAMPAIGN_DEVICE_SLOT")
    if slot is not None:
        rec["device-slot"] = int(slot)
    print(json.dumps(rec))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
