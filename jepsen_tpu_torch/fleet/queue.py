"""The fleet's durable work queue: leased claims over a jsonl ledger
(the port's copy of `jepsen_tpu/fleet/queue.py`).

One file per campaign (``<store>/fleet/<name>.jsonl``), one JSON event
per state transition, fsync'd on append — the same durability and
torn-line story as `campaign/index.py` and `verifier/journal.py`: a
``kill -9`` mid-append leaves at most one torn trailing line, which a
reload drops (and the next writer truncates away).

The queue's in-memory state is a **pure function of the event
sequence**: every live transition appends its event first, then applies
it through the same ``_apply`` the replay path uses, so a coordinator
killed and restarted over the ledger reaches the *identical* state —
pinned by :meth:`WorkQueue.digest` in the crash tests.

Events:

- ``enqueue`` — a cell (serialized RunSpec) enters, state ``queued``.
  Idempotent on the stable run id: re-enqueueing a known cell is a
  no-op, which is what makes a finished fleet re-serve resume with 0
  cells executed (parity with `campaign/index.py` resume semantics).
- ``claim`` — a worker takes the cell under a lease deadline.
- ``renew`` — the claim holder extends its lease while running.
- ``requeue`` — a lease lapsed (``lease-expired``) or the worker
  drained (``released``); the cell goes back to ``queued``.
- ``complete`` — the cell's one verdict record lands; state ``done``.
  **At-most-once**: a zombie worker completing an already-finished
  cell is detected and its duplicate discarded (a ``duplicate`` event
  is logged for attribution, the cell's record never changes, and the
  ``fleet-duplicate-completions`` counter ticks).  A *resend* of the
  identical record by the same worker (a lost ack retried) is
  recognized and acked as ``already`` — idempotent, not a duplicate.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["WorkQueue", "fleet_path", "record_digest"]


def fleet_path(name: str, base: Optional[str] = None) -> str:
    """The fleet ledger path: ``<store>/fleet/<name>.jsonl``."""
    from jepsen_tpu_torch import store

    return os.path.join(base or store.BASE, "fleet",
                        store.sanitize(name) + ".jsonl")


def record_digest(record: Dict[str, Any]) -> str:
    """Digest of a verdict record — the resend-vs-duplicate test: the
    same worker re-sending the same record (lost ack) matches; a
    re-executed cell's record (different wall_s at the very least)
    does not."""
    return hashlib.sha256(
        json.dumps(record, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _norm_mesh(m: Any) -> Optional[Tuple[int, ...]]:
    """Normalize a mesh-shape capability/requirement ("2x2", [2, 2],
    (2, 2)) to a comparable tuple; None when unspecified."""
    if m is None or m == "":
        return None
    if isinstance(m, str):
        m = [p for p in m.replace("x", ",").split(",") if p.strip()]
    try:
        return tuple(int(p) for p in m)
    except (TypeError, ValueError):
        return None


def _caps_match(spec: Dict[str, Any], caps: Optional[Dict[str, Any]]
                ) -> bool:
    """Worker-affine placement predicate: does this worker's advertised
    capability set satisfy a device cell's requirements?  A cell pins
    requirements via opts ``"backend"`` (e.g. ``"cuda"``) and/or
    ``"mesh"`` (device mesh shape); an unpinned cell matches everyone,
    an unadvertised capability fails a pinned one."""
    opts = spec.get("opts") or {}
    need_backend = opts.get("backend")
    if need_backend:
        have = str((caps or {}).get("backend") or "")
        if have.lower() != str(need_backend).lower():
            return False
    need_mesh = _norm_mesh(opts.get("mesh"))
    if need_mesh is not None:
        if _norm_mesh((caps or {}).get("mesh")) != need_mesh:
            return False
    return True


def _count(name: str, **labels: Any) -> None:
    """Bump a fleet counter on the live registry.  Applied during
    replay too, so a restarted coordinator's counters equal the ledger
    truth instead of restarting from zero."""
    try:
        from jepsen_tpu_torch import telemetry

        telemetry.registry().counter(name, **labels).inc()
    except Exception:  # noqa: BLE001 — observability must not fail work
        pass


class WorkQueue:
    """One campaign's leased work queue, replayed from its ledger.

    Thread-safe (one lock around every transition).  The queue is
    owned by the coordinator — the single writer; like
    `campaign.index.Index`, a torn trailing line observed at load is
    only *healed* (truncated) right before the first append, never by
    a read-only replay (whose "torn line" may be a live writer's
    in-flight append).
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        #: run id -> cell state dict (spec/state/worker/deadline/...)
        self.cells: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []  # enqueue order = claim order
        self.requeues = 0
        self.duplicates = 0
        self._good_bytes: Optional[int] = None
        self._load()

    # -- replay --------------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        good = 0
        torn = False
        with open(self.path, "rb") as f:
            for line in f:
                if not line.strip():
                    good += len(line)
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    torn = True  # torn trailing event (crash debris)
                    break
                if not line.endswith(b"\n"):
                    torn = True  # unterminated: a later append would fuse
                    break
                if isinstance(ev, dict):
                    self._apply(ev)
                good += len(line)
        if torn:
            self._good_bytes = good

    def _apply(self, ev: Dict[str, Any]) -> None:
        """The one transition function — replay and live appends both
        go through here, so they cannot diverge."""
        k = ev.get("ev")
        run = ev.get("run")
        if k == "enqueue":
            self.cells[run] = {
                "run": run, "spec": ev.get("spec") or {},
                "state": "queued", "worker": None, "deadline": None,
                "claims": 0, "requeues": 0,
                "completed_by": None, "record": None,
                "record_digest": None,
                # timeline bookkeeping: the ledger event
                # timestamps, replay-stable (they come FROM the
                # ledger), excluded from the state digest (derived
                # observability, not queue state)
                "enqueued_ts": ev.get("ts"),
                "claimed_ts": None,
                # in-memory only (not digested, not replayed): when the
                # first affinity deferral parked this cell — the
                # starvation-fallback clock
                "_deferred_at": None,
            }
            self._order.append(run)
            return
        cell = self.cells.get(run)
        if cell is None:
            return  # event for an unknown cell: tolerate (old ledger)
        if k == "claim":
            cell.update(state="claimed", worker=ev.get("worker"),
                        deadline=ev.get("deadline"),
                        claimed_ts=ev.get("ts"))
            cell["claims"] += 1
        elif k == "renew":
            if cell["state"] == "claimed" and \
                    cell["worker"] == ev.get("worker"):
                cell["deadline"] = ev.get("deadline")
        elif k == "requeue":
            cell.update(state="queued", worker=None, deadline=None)
            cell["_deferred_at"] = None  # affinity clock restarts
            cell["requeues"] += 1
            self.requeues += 1
            _count("fleet-requeues", worker=ev.get("worker") or "?",
                   reason=ev.get("reason") or "?")
        elif k == "complete":
            rec = ev.get("record")
            cell.update(state="done", worker=None, deadline=None,
                        completed_by=ev.get("worker"), record=rec,
                        record_digest=record_digest(rec or {}))
        elif k == "duplicate":
            self.duplicates += 1
            _count("fleet-duplicate-completions",
                   worker=ev.get("worker") or "?")

    # -- the durable append --------------------------------------------------

    def _event(self, ev: Dict[str, Any]) -> None:
        """Append one event (fsync'd) and apply it.  Healing a torn
        tail observed at load happens here, right before the first
        append — writer-only, like the campaign index."""
        ev = dict(ev, ts=round(time.time(), 3))
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self._good_bytes is not None:
            with open(self.path, "r+b") as f:
                f.truncate(self._good_bytes)
            self._good_bytes = None
        with open(self.path, "a") as f:
            f.write(json.dumps(ev) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._apply(ev)

    # -- transitions ---------------------------------------------------------

    def enqueue(self, spec: Dict[str, Any]) -> bool:
        """Admit one cell (a ``RunSpec.to_dict()``); idempotent on the
        stable run id — a known cell (queued, claimed, or done) is a
        no-op."""
        run = spec["run_id"]
        with self._lock:
            if run in self.cells:
                return False
            self._event({"ev": "enqueue", "run": run, "spec": spec})
            return True

    def claim(self, worker: str, *, lease_s: float,
              device_ok: bool = True,
              caps: Optional[Dict[str, Any]] = None,
              now: Optional[float] = None
              ) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """Claim the first queued cell this worker can run; returns
        ``(spec, lease_deadline)`` or ``(None, None)``.  Expired leases
        are requeued first (opportunistic — the coordinator has no
        background reaper thread to crash).

        Placement is **worker-affine**: a device-classified
        cell whose opts pin a ``"backend"`` or ``"mesh"`` shape is
        skipped by workers whose registered `caps` don't match — each
        skip counts on ``fleet-affinity-deferrals{worker}`` — until the
        cell has been deferred for longer than one lease, after which
        ANY device-capable worker may take it (starvation-safe
        fallback: affinity is a preference, never a deadlock)."""
        now = time.time() if now is None else now
        with self._lock:
            self._expire_locked(now)
            for run in self._order:
                cell = self.cells[run]
                if cell["state"] != "queued":
                    continue
                if cell["spec"].get("device"):
                    if not device_ok:
                        continue
                    if not _caps_match(cell["spec"], caps):
                        first = cell["_deferred_at"]
                        if first is None:
                            cell["_deferred_at"] = first = now
                        if now - first <= float(lease_s):
                            _count("fleet-affinity-deferrals",
                                   worker=worker)
                            continue
                        # starved past a lease: any capable worker runs
                        # it — a fleet with no matching worker must
                        # still finish
                deadline = round(now + float(lease_s), 3)
                self._event({"ev": "claim", "run": run, "worker": worker,
                             "deadline": deadline})
                cell["_deferred_at"] = None
                return dict(cell["spec"]), deadline
            return None, None

    def renew(self, run: str, worker: str, lease_s: float,
              now: Optional[float] = None) -> bool:
        """Extend a held lease.  False means the lease was LOST (lapsed
        and requeued, or the cell finished elsewhere) — the worker may
        keep running, but its eventual completion can be discarded as
        a duplicate."""
        now = time.time() if now is None else now
        with self._lock:
            cell = self.cells.get(run)
            if cell is None or cell["state"] != "claimed" or \
                    cell["worker"] != worker:
                return False
            self._event({"ev": "renew", "run": run, "worker": worker,
                         "deadline": round(now + float(lease_s), 3)})
            return True

    def release(self, run: str, worker: str) -> bool:
        """Voluntarily give a claim back (the SIGTERM drain path)."""
        with self._lock:
            cell = self.cells.get(run)
            if cell is None or cell["state"] != "claimed" or \
                    cell["worker"] != worker:
                return False
            self._event({"ev": "requeue", "run": run, "worker": worker,
                         "reason": "released"})
            return True

    def expire(self, now: Optional[float] = None) -> List[str]:
        """Requeue every claimed cell whose lease deadline passed;
        returns the requeued run ids."""
        now = time.time() if now is None else now
        with self._lock:
            return self._expire_locked(now)

    def _expire_locked(self, now: float) -> List[str]:
        out = []
        for run in self._order:
            cell = self.cells[run]
            if cell["state"] == "claimed" and \
                    isinstance(cell["deadline"], (int, float)) and \
                    cell["deadline"] < now:
                self._event({"ev": "requeue", "run": run,
                             "worker": cell["worker"],
                             "reason": "lease-expired"})
                out.append(run)
        return out

    def complete(self, run: str, worker: str,
                 record: Dict[str, Any]) -> str:
        """Land a cell's verdict record.  Returns one of:

        - ``"accepted"`` — the one verdict record for this cell; the
          caller (coordinator) appends it to the campaign index.
        - ``"already"`` — the same worker resent the identical record
          (a lost ack): idempotent, ack again, append nothing.
        - ``"duplicate"`` — a zombie's record for a cell someone else
          already finished: discarded, counted, never indexed.
        - ``"unknown"`` — no such cell.

        A completion from a worker whose lease lapsed (the cell is
        requeued or re-claimed but NOT yet done) is accepted:
        first-verdict-wins preserves exactly-one-record-per-cell, and
        the slower executor's later completion becomes the duplicate.
        """
        with self._lock:
            cell = self.cells.get(run)
            if cell is None:
                return "unknown"
            if cell["state"] == "done":
                if cell["completed_by"] == worker and \
                        cell["record_digest"] == record_digest(record):
                    return "already"
                self._event({"ev": "duplicate", "run": run,
                             "worker": worker})
                return "duplicate"
            self._event({"ev": "complete", "run": run, "worker": worker,
                         "record": record})
            return "accepted"

    # -- views ---------------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {"queued": 0, "claimed": 0, "done": 0}
            for cell in self.cells.values():
                out[cell["state"]] += 1
            out["cells"] = len(self.cells)
            out["requeues"] = self.requeues
            out["duplicates"] = self.duplicates
            return out

    def done_cells(self) -> List[Dict[str, Any]]:
        """Completed cells in enqueue order (records included) — the
        coordinator's boot reconcile walks these."""
        with self._lock:
            return [dict(self.cells[r]) for r in self._order
                    if self.cells[r]["state"] == "done"]

    def cell_times(self, run: str) -> Dict[str, Any]:
        """One cell's control-plane timing facts (ledger timestamps):
        the material for the ``fleet:enqueue-wait`` segment the
        coordinator stamps into index records."""
        with self._lock:
            c = self.cells.get(run)
            if c is None:
                return {}
            return {"enqueued": c.get("enqueued_ts"),
                    "claimed": c.get("claimed_ts"),
                    "claims": c["claims"], "requeues": c["requeues"]}

    def claim_latencies(self, last: int = 50) -> List[float]:
        """The most recent cells' enqueue->first-claim waits (ledger
        timestamps), in enqueue order — the raw material for the
        scaler's claim-latency signal."""
        with self._lock:
            out = []
            for run in self._order:
                c = self.cells[run]
                enq, clm = c.get("enqueued_ts"), c.get("claimed_ts")
                if isinstance(enq, (int, float)) and \
                        isinstance(clm, (int, float)) and clm >= enq:
                    out.append(round(clm - enq, 6))
            return out[-max(1, int(last)):]

    def claim_latency_p95(self, last: int = 50) -> Optional[float]:
        """Nearest-rank p95 over `claim_latencies` — one of the two
        signals the autopilot scaler sizes the worker pool on (the
        other is queue depth).  None until a cell has been claimed."""
        xs = sorted(self.claim_latencies(last))
        if not xs:
            return None
        import math

        return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]

    def leases(self) -> List[Dict[str, Any]]:
        """Active claims: run / worker / lease deadline."""
        with self._lock:
            return [{"run": r, "worker": c["worker"],
                     "deadline": c["deadline"]}
                    for r in self._order
                    if (c := self.cells[r])["state"] == "claimed"]

    def digest(self) -> str:
        """Digest of the queue state — replay-stable: a coordinator
        killed and restarted over the same ledger reports the same
        digest (the crash-test pin).  Covers cell states, holders,
        lease deadlines, claim counts, and completion identities; the
        observability counters are excluded (they are derived, not
        state)."""
        with self._lock:
            state = [(r, c["state"], c["worker"], c["deadline"],
                      c["claims"], c["completed_by"], c["record_digest"])
                     for r in self._order
                     for c in (self.cells[r],)]
        return hashlib.sha256(
            json.dumps(state, default=str).encode()).hexdigest()[:16]
