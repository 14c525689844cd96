"""verifier/ — the always-on incremental checking service (the port's
copy of `jepsen_tpu/verifier`).

Turns the batch checker into infrastructure: clients stream history
segments in (op-dict jsonl, the ``history.json`` line format), rolling
verdicts stream out, and sealing a session runs the full batch checker
and asserts it agrees with the incremental result.

Layers (see ``docs/VERIFIER.md``):

- :mod:`.session` — :class:`VerifierSession`, the incremental checker:
  per-key tail-index edge maintenance, dirty-region cycle sweeps in
  device-sized guarded chunks, the shared
  :func:`~jepsen_tpu_torch.checkers.elle.oracle.boundary_verdict` tail.
- :mod:`.journal` — fsync'd per-session journals; accept → fsync → ack;
  byte-cursor resume; crash replay to the identical verdict digest.
- :mod:`.service` — :class:`VerifierService`, the session manager
  (``web.serve`` routes the ingest endpoints to it, ``serve --ingest``);
  journal compaction, session GC/archival, and the maintenance loop.
- :mod:`.sweep` — multi-tenant batched dirty-region sweeps: many
  sessions' regions, one ``ops.cycle_sweep.detect_cycles`` dispatch on
  the card.
- :mod:`.client` — :class:`LiveCheck`, the live-checking client
  `core.run`'s interpreter streams through.
"""

from .client import LiveCheck, live_check_for
from .journal import (
    SessionJournal,
    read_checkpoint,
    read_meta,
    split_segment,
    write_checkpoint,
)
from .service import VerifierService, scan_sessions
from .session import (
    VerdictMismatch,
    VerifierSession,
    iter_packed_segments,
    verdict_digest,
)

__all__ = [
    "VerifierSession", "VerifierService", "SessionJournal",
    "VerdictMismatch", "verdict_digest", "iter_packed_segments",
    "split_segment", "scan_sessions", "read_meta", "LiveCheck",
    "live_check_for", "read_checkpoint", "write_checkpoint",
]
