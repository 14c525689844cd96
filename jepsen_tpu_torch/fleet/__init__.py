"""jepsen_tpu_torch.fleet — the fault-tolerant multi-host control plane
(the port's copy of `jepsen_tpu/fleet`).

A distributed, crash-tolerant execution layer over `campaign/`
(docs/FLEET.md): a coordinator serves a campaign spec as a **leased
work queue** over HTTP (`coordinator.FleetCoordinator` on `web.serve`),
remote workers (`worker.FleetWorker`, ``cli fleet work``) claim cells,
execute them through `campaign.core.execute_run`, renew their leases
while running, and upload the verdict record — and the whole plane
survives its own nemeses: worker ``kill -9`` (lease lapses, cell
requeues), coordinator ``kill -9`` (the fsync'd ledger replays to the
identical queue state), partitions (workers retry through them), and
zombie double-completions (discarded, at-most-once verdicts).

The contract is the campaign contract, distributed: every cell
terminates with exactly one attributable verdict record in the same
append-only index a single-process `run_campaign` writes.

On top sits the **autopilot** (`autopilot.Autopilot`, ``cli fleet
autopilot``, docs/AUTOPILOT.md): the continuous driver that streams
spec-template generations into the queue forever, gates each one,
quarantines + auto-shrinks regressions, and scales the worker pool —
including rolling version upgrades — from its own crash-replayable
journal.

The port's differences: it has no compile cache (its kernels are built
once into ``build/``, keyed by a digest of their sources), so nothing
compile-cache-shaped travels over the fleet's wire; and a worker made
with ``cpu=True`` (``fleet work --cpu``) runs its cells' checkers on
the CPU instead of the CUDA card.
"""

from .autopilot import (Autopilot, AutopilotJournal, autopilot_path,
                        scenario_rotation)
from .coordinator import FleetCoordinator
from .queue import WorkQueue, fleet_path, record_digest
from .worker import FleetWorker

__all__ = ["Autopilot", "AutopilotJournal", "FleetCoordinator",
           "FleetWorker", "WorkQueue", "autopilot_path",
           "fleet_path", "record_digest", "scenario_rotation"]
