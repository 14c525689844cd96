"""The fleet coordinator: the campaign's HTTP control plane (the port's
copy of `jepsen_tpu/fleet/coordinator.py`).

One coordinator per campaign (``cli fleet serve <spec.json>``), mounted
on `web.serve` (the handler routes ``POST /fleet/<verb>`` and ``GET
/fleet/status`` here).  It owns three durable artifacts:

- the **work queue ledger** (`queue.WorkQueue`,
  ``<store>/fleet/<name>.jsonl``) — who holds what under which lease;
- the **campaign index** (`campaign.index.Index`) — the same
  append-only verdict ledger a single-process `run_campaign` writes,
  so every downstream surface (web grid, warehouse, regression
  queries, resume) works unchanged on a distributed campaign;
- the **heartbeat file** (`telemetry.Heartbeat`,
  ``<store>/campaigns/<name>.live.json``) — ONE writer for the live
  dashboard, fed over HTTP by remote workers (heartbeats pushed over
  HTTP merge into the exact shape the single-process scheduler writes,
  so ``/campaign/<name>/live`` renders both).

Crash discipline: the queue ledger is appended BEFORE the index (a
``complete`` event is the commit point), and boot **reconciles** —
any queue-done cell whose record is missing from the index (a crash
landed between the two appends) is re-appended from the ledger's own
copy of the record.  A ``kill -9``'d coordinator therefore replays to
the identical queue state (`boot digest pinned <queue.WorkQueue.digest>`)
and never loses or doubles a verdict.

Chaos: every endpoint fires the active `resilience.FaultPlan` at its
site (``fleet.register`` / ``fleet.claim`` / ``fleet.heartbeat`` /
``fleet.complete`` / ``fleet.release`` / ``fleet.status``) — an
injected fault becomes a 503 the workers' retry policy rides out, a
``stall`` kind becomes server-side latency.  The same site family
fires client-side in `worker.FleetWorker`, so a plan installed in
either process partitions that side of the seam.

The port has no compile cache: its kernels are built once into
``build/`` under a digest of their sources, so there is nothing per
shape to ship.  So the coordinator mints no cache-transfer secret, a
claim carries no ``compilecache`` advert, an uploaded artifact is never
absorbed as cache entries, ``GET /fleet/cache`` answers an empty entry
list and ``GET /fleet/cache/<name>`` answers 404.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple, Union

from jepsen_tpu_torch import store
from jepsen_tpu_torch.campaign import core as ccore
from jepsen_tpu_torch.campaign import plan as plan_mod
from jepsen_tpu_torch.campaign.index import Index
from jepsen_tpu_torch.resilience import faults as faults_mod
from jepsen_tpu_torch.resilience.faults import FaultInjected
from jepsen_tpu_torch.telemetry import spans as spans_mod

from .artifacts import ArtifactStore
from .queue import WorkQueue, fleet_path

logger = logging.getLogger("jepsen.fleet")

__all__ = ["FleetCoordinator"]

#: a worker whose last heartbeat is older than this many leases is
#: counted dead by the workers-alive gauge (it can still come back)
ALIVE_LEASES = 3.0

#: a worker silent for this many leases is dropped from the registry
#: entirely — the cardinality bound: a fleet churning
#: through register/expire cycles (worker names embed pids) must not
#: grow the worker table, /fleet/status, or the federated /metrics
#: surface monotonically
PRUNE_LEASES = 40.0

#: per-worker cap on federated metric rows accepted over heartbeat —
#: the other half of the cardinality bound
MAX_FEDERATED_SERIES = 48

#: seconds between artifact-staging GC passes;
#: the passes ride the heartbeat/status paths, no dedicated thread
STAGING_GC_INTERVAL_S = 30.0

#: wall-clock t0 alignment: a generation's window
#: anchor is set this many seconds past its FIRST claim, so the other
#: hosts' cells claimed shortly after share the same absolute timeline
T0_LEAD_S = 0.5

#: a worker whose reported t0 differs from the authoritative anchor by
#: more than this is flagged clock-desynced on /fleet/status
T0_SKEW_S = 0.25


def _registry():
    from jepsen_tpu_torch import telemetry

    return telemetry.registry()


class FleetCoordinator:
    """Serve one campaign spec to a fleet of HTTP workers.

    Thread-safe — the web server's handler threads call straight in
    (the queue has its own lock; the coordinator lock covers the index
    append + done-set bookkeeping).
    """

    def __init__(self, spec: Union[str, dict],
                 base: Optional[str] = None, *,
                 lease_s: float = 15.0,
                 run_deadline_s: Optional[float] = None,
                 staging_retention_s: float = 24 * 3600.0):
        self.spec = plan_mod.load_spec(spec)
        self.base = base or store.BASE
        self.name = self.spec["name"]
        self.lease_s = float(lease_s)
        self.specs = plan_mod.expand(self.spec)
        self.gen = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        self.spec_digest = plan_mod.spec_digest(self.spec)
        self._lock = threading.RLock()
        #: streamed-generation labels: run id -> the
        #: autopilot generation label its record is stamped with (the
        #: gate groups samples by this; admit() fills it)
        self._gen_by_run: Dict[str, str] = {}
        #: the owning `fleet.autopilot.Autopilot`, when one drives
        #: this coordinator — /fleet/status and the web panel join
        #: its status_doc through this
        self.autopilot: Optional[Any] = None
        for rs in self.specs:
            # same opt plumbing as run_campaign: a hard per-run wall
            # also bounds the checkers cooperatively
            if run_deadline_s and \
                    rs.opts.get("checker-time-limit") is None:
                rs.opts["checker-time-limit"] = run_deadline_s
        #: the campaign-level nemesis schedule: per
        #: generation g (= the seed axis), the synchronized window set
        #: every host's cell installs.  Expanded once here — the same
        #: pure function `expand` evaluates, so the sets broadcast over
        #: claim equal the ones already baked into the cell opts.
        self.sched = self.spec.get("nemesis-schedule")
        self._windows_by_gen: Dict[int, list] = {}
        self._windows_digests: Dict[int, str] = {}
        #: per-generation wall-clock window anchor: lazily
        #: set at a generation's first claim; broadcast with the
        #: window set so every host fires the schedule on the
        #: coordinator's absolute timeline
        self._gen_t0: Dict[int, float] = {}
        #: store federation: the artifact-upload endpoint's
        #: staging + atomic landing
        self.artifacts = ArtifactStore(self.base)
        #: staging retention: permanently
        #: abandoned upload partials expire past this; GC rides the
        #: heartbeat/status paths, throttled to one pass per interval
        self.staging_retention_s = float(staging_retention_s)
        self._staging_gc_at = 0.0
        if self.sched:
            for g in self.spec["seeds"]:
                # pass the normalized block, not the whole spec — the
                # spec path would re-run load_spec once per seed
                wins = plan_mod.schedule_windows(self.sched, g)
                self._windows_by_gen[int(g)] = wins
                self._windows_digests[int(g)] = \
                    plan_mod.windows_digest(wins)
        self.idx = Index(ccore.index_path(self.name, self.base))
        spec_ids = {rs.run_id for rs in self.specs}
        self._done_ids = self.idx.completed_ids() & spec_ids
        self.queue = WorkQueue(fleet_path(self.name, self.base))
        #: the replayed-state digest at construction — the kill -9
        #: crash tests compare this against an independent replay of
        #: the pre-kill ledger
        self.boot_digest = self.queue.digest()
        enqueued = 0
        for rs in self.specs:
            if rs.run_id in self._done_ids:
                continue  # resume parity: indexed cells never re-run
            if self.queue.enqueue(rs.to_dict()):
                enqueued += 1
        self._reconcile()
        #: worker registry: name -> capabilities + last_seen
        self.workers: Dict[str, Dict[str, Any]] = {}
        from jepsen_tpu_torch.telemetry import Heartbeat

        #: the ONE live.json writer per campaign; remote workers feed
        #: it over /fleet/heartbeat
        self._hbs: Dict[str, Any] = {}
        self._hbs[self.name] = Heartbeat(
            ccore.live_path(self.name, self.base), campaign=self.name,
            total=len(self.specs), done=len(self._done_ids))
        logger.info(
            "fleet %s: %d cells (%d already indexed, %d enqueued), "
            "lease %.1fs, boot digest %s", self.name, len(self.specs),
            len(self._done_ids), enqueued, self.lease_s,
            self.boot_digest)
        self._update_gauges()

    def _reconcile(self) -> None:
        """Re-append index records for queue-done cells the index
        missed — the crash window between the queue's ``complete``
        event (the commit point) and the index append."""
        indexed = self.idx.completed_ids()
        for cell in self.queue.done_cells():
            run = cell["run"]
            if run in indexed or not isinstance(cell["record"], dict):
                continue
            self.idx.append(self._stamp(cell["record"],
                                        cell["completed_by"]))
            self._done_ids.add(run)
            logger.info("fleet %s: reconciled missing index record "
                        "for %s", self.name, run)

    def admit(self, run_specs, gen: Optional[str] = None
              ) -> Dict[str, int]:
        """Stream a new generation of cells into the LIVE queue (the
        autopilot's enqueue seam): extend the plan, map each
        run id to its generation label for record stamping, and
        enqueue idempotently — already-indexed cells count done
        immediately (restart-free resume), already-queued ids are
        refused by the ledger.  Safe to call any number of times with
        the same specs; that is the crash-window contract."""
        added = enq = already = 0
        with self._lock:
            known = {rs.run_id for rs in self.specs}
            indexed = self.idx.completed_ids()
            for rs in run_specs:
                rid = rs.run_id
                if gen:
                    self._gen_by_run[rid] = str(gen)
                if rid not in known:
                    self.specs.append(rs)
                    known.add(rid)
                    added += 1
                if rid in indexed:
                    if rid not in self._done_ids:
                        self._done_ids.add(rid)
                        already += 1
                elif self.queue.enqueue(rs.to_dict()):
                    enq += 1
            hb = self._hbs.get(self.name)
            if hb is not None:
                try:
                    hb.state["total"] = len(self.specs)
                    hb.state["done"] = len(self._done_ids)
                except Exception:  # noqa: BLE001 — display only
                    pass
        self._update_gauges()
        logger.info("fleet %s: admitted %s (+%d cells, %d enqueued, "
                    "%d already indexed)", self.name, gen or "-",
                    added, enq, already)
        return {"admitted": added, "enqueued": enq,
                "already-done": already}

    def _stamp(self, record: Dict[str, Any], worker: Any
               ) -> Dict[str, Any]:
        rec = dict(record)
        with self._lock:
            gen = self._gen_by_run.get(str(record.get("run") or ""))
        rec.setdefault("gen", gen or self.gen)
        rec.setdefault("spec", self.spec_digest)
        if worker:
            rec.setdefault("fleet-worker", str(worker))
        run = rec.get("run")
        if run:
            # trace stitching: the record always names its
            # trace (derived from the stable run id — identical across
            # retries), and the control-plane segments only the
            # coordinator's ledger knows land as gateable spans next
            # to the worker's checker spans (`obs gate --span
            # fleet:enqueue-wait` works like any checker span)
            rec.setdefault("trace", spans_mod.trace_id_for(str(run)))
            t = self.queue.cell_times(str(run))
            enq, clm = t.get("enqueued"), t.get("claimed")
            spans = rec.setdefault("spans", {})
            if isinstance(spans, dict) \
                    and isinstance(enq, (int, float)) \
                    and isinstance(clm, (int, float)) and clm >= enq:
                spans.setdefault("fleet:enqueue-wait",
                                 round(clm - enq, 6))
        return rec

    # -- shared endpoint plumbing -------------------------------------------

    def _guarded(self, site: str, fn, *args
                 ) -> Tuple[int, Dict[str, Any]]:
        """Fire the active fault plan at this control-plane seam, then
        run the handler.  Injected faults surface as 503 (the "drop"
        the workers' retry policy rides out); ``stall`` kinds sleep
        inside ``fire`` — server-side latency."""
        try:
            plan = faults_mod.active_plan()
            if plan is not None:
                plan.fire(site)
        except FaultInjected as e:
            return 503, {"error": str(e), "injected": True}
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — a handler bug must
            logger.exception("fleet %s failed", site)  # not kill serve
            return 500, {"error": f"{type(e).__name__}: {e}"}

    @property
    def finished(self) -> bool:
        with self._lock:
            return len(self._done_ids) >= len(self.specs)

    # -- endpoints (code, doc) ----------------------------------------------

    def register(self, body: Dict[str, Any]
                 ) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.register", self._register, body)

    def _register(self, body: Dict[str, Any]
                  ) -> Tuple[int, Dict[str, Any]]:
        worker = str(body.get("worker") or "")
        if not worker:
            return 400, {"error": "register needs a worker name"}
        with self._lock:
            self.workers[worker] = {
                "host": body.get("host"),
                "backend": body.get("backend"),
                "mesh": body.get("mesh"),
                "device-slots": int(body.get("device-slots", 1)),
                # rolling-upgrade visibility: the stamped
                # build version, refreshed on heartbeat, rendered as
                # jepsen_fleet_host_info{host,version}
                "version": str(body.get("version") or "") or None,
                "registered": round(time.time(), 3),
                "last-seen": round(time.time(), 3),
            }
        self._update_gauges()
        return 200, {"ok": True, "campaign": self.name,
                     "lease-s": self.lease_s,
                     "total": len(self.specs),
                     "nemesis-schedule": bool(self.sched)}

    def claim(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.claim", self._claim, body)

    def _claim(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        worker = str(body.get("worker") or "")
        if not worker:
            return 400, {"error": "claim needs a worker name"}
        caps = self._touch(worker)
        spec, deadline = self.queue.claim(
            worker, lease_s=self.lease_s,
            device_ok=caps.get("device-slots", 1) > 0, caps=caps)
        self._update_gauges()
        if spec is None:
            c = self.queue.counts()
            # under an autopilot the fleet is never "finished" from a
            # worker's perspective — a drained generation is just the
            # gap before the next one streams in.  Workers
            # idle-poll; the autopilot drains them by SIGTERM when the
            # loop actually ends.
            fin = self.finished and self.autopilot is None
            return 200, {"spec": None, "finished": fin,
                         "queued": c["queued"], "claimed": c["claimed"]}
        out = {"spec": spec, "lease-s": self.lease_s,
               "deadline": deadline}
        # the trace broadcast: the claim carries the run's
        # trace context — minted at enqueue time semantics (a pure
        # function of the run id, so a re-claim after a lease lapse
        # hands out the SAME trace), parented on the coordinator's
        # claim segment
        ctx = spans_mod.mint_trace(str(spec.get("run_id") or ""))
        out["trace"] = dict(ctx.child("fleet:claim").to_dict(),
                            header=ctx.header())
        if self.sched:
            # the window broadcast: the claim response is the
            # AUTHORITATIVE carrier of the cell generation's
            # synchronized window set — a worker that missed every
            # heartbeat tick still installs the correct seeded windows
            # from here, before execute_run
            g = int(spec.get("seed", 0))
            with self._lock:
                # wall-clock t0 alignment: one absolute anchor per
                # generation, minted at its first claim.  The claim
                # also carries the coordinator's "now" so the worker
                # can estimate its clock offset and convert the anchor
                # into its own clock domain.
                t0 = self._gen_t0.setdefault(
                    g, round(time.time() + T0_LEAD_S, 3))
            out["windows"] = {
                "gen": g,
                "set": self._windows_by_gen.get(g, []),
                "digest": self._windows_digests.get(g, ""),
                "t0": t0,
                "now": round(time.time(), 3),
            }
        return 200, out

    def heartbeat(self, body: Dict[str, Any]
                  ) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.heartbeat", self._heartbeat, body)

    def _heartbeat(self, body: Dict[str, Any]
                   ) -> Tuple[int, Dict[str, Any]]:
        """The merged heartbeat sink: fleet workers renew leases and
        publish in-flight state; remote `run_campaign`\\ s
        (`telemetry.stream.HttpHeartbeat`) push whole-campaign
        progress.  Everything lands in the campaign's ONE
        `telemetry.Heartbeat` writer, so ``/campaign/<n>/live``
        renders both sources in the same shape."""
        campaign = str(body.get("campaign") or self.name)
        worker = body.get("worker")
        hb = self._hb_for(campaign, total=body.get("total"),
                          done=body.get("init-done"))
        if worker is not None:
            # liveness only for KNOWN fleet workers (registered, or
            # implicitly via claim/complete): a remote run_campaign's
            # scheduler slot names (campaign-worker-0, ...) pushing
            # through this sink are that campaign's workers, not this
            # fleet's — registering them would pollute the worker
            # table and over-count the workers-alive gauge
            with self._lock:
                known = str(worker) in self.workers
            if known:
                self._touch(str(worker))
                if body.get("version"):
                    with self._lock:
                        if str(worker) in self.workers:
                            self.workers[str(worker)]["version"] = \
                                str(body["version"])
            if "state" in body:
                hb.worker(str(worker), body.get("state"))
        out: Dict[str, Any] = {"ok": True, "lease-s": self.lease_s}
        mx = body.get("metrics")
        if worker is not None and isinstance(mx, list):
            # metrics federation: the heartbeat
            # doubles as the metrics push channel.  Rows are capped
            # per worker (cardinality bound) and retire with worker
            # liveness — the exposition only renders alive workers'
            # snapshots, and the prune drops silent workers entirely
            rows = [r for r in mx[:MAX_FEDERATED_SERIES]
                    if isinstance(r, dict) and r.get("name")
                    and isinstance(r.get("value"), (int, float))]
            with self._lock:
                if str(worker) in self.workers:
                    self.workers[str(worker)]["metrics"] = {
                        "rows": rows, "ts": round(time.time(), 3)}
        wins = body.get("windows")
        if worker is not None and "windows" in body and wins is None:
            with self._lock:  # cell done: the worker's windows retire
                if str(worker) in self.workers:
                    self.workers[str(worker)].pop("windows", None)
        if worker is not None and isinstance(wins, dict):
            # window open/close ticks: lease renewal doubles
            # as chaos clock sync — the worker reports its installed
            # window digest + currently-open positions, the coordinator
            # records them (the /fleet dashboard's desync view) and
            # echoes the authoritative digest for that generation so a
            # desynced worker can see it immediately
            with self._lock:
                if str(worker) in self.workers:
                    self.workers[str(worker)]["windows"] = dict(
                        wins, ts=round(time.time(), 3))
            try:
                g = int(wins.get("gen"))
            except (TypeError, ValueError):
                g = None
            if g is not None and g in self._windows_digests:
                out["windows-digest"] = self._windows_digests[g]
        done = body.get("done")
        if isinstance(done, dict):
            hb.record_done(done.get("run"), done.get("valid?"))
        lost = []
        for run in body.get("renew") or []:
            if not self.queue.renew(str(run), str(worker or ""),
                                    self.lease_s):
                lost.append(str(run))
        self.queue.expire()
        if body.get("finished"):
            hb.close()
        self._update_gauges()
        out["lost"] = lost
        return 200, out

    def complete(self, body: Dict[str, Any]
                 ) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.complete", self._complete, body)

    def _complete(self, body: Dict[str, Any]
                  ) -> Tuple[int, Dict[str, Any]]:
        worker = str(body.get("worker") or "")
        run = str(body.get("run") or "")
        record = body.get("record")
        if not worker or not run or not isinstance(record, dict):
            return 400, {"error": "complete needs worker, run, record"}
        self._touch(worker)
        status = self.queue.complete(run, worker, record)
        if status == "unknown":
            return 404, {"error": f"no such cell {run!r}"}
        if status == "accepted":
            with self._lock:
                self.idx.append(self._stamp(record, worker))
                self._done_ids.add(run)
                hb = self._hbs.get(self.name)
                if hb is not None:
                    hb.record_done(run, record.get("valid?"))
                    if self.finished:
                        hb.close()
        self._update_gauges()
        if status == "duplicate":
            logger.warning("fleet %s: duplicate completion of %s by "
                           "zombie %s discarded", self.name, run, worker)
            return 200, {"ok": False, "duplicate": True}
        return 200, {"ok": True, "status": status,
                     "finished": self.finished}

    def artifact(self, run_id: str, params: Dict[str, Any],
                 body: bytes) -> Tuple[int, Dict[str, Any]]:
        """``POST /fleet/artifact/<run-id>`` — the store-federation
        upload seam (chunked + digest-verified + idempotent; see
        `artifacts.ArtifactStore`).  Guarded like every other
        control-plane endpoint, so chaos plans drop/stall uploads."""
        return self._guarded("fleet.artifact", self._artifact,
                             run_id, params, body)

    def _artifact(self, run_id: str, params: Dict[str, Any],
                  body: bytes) -> Tuple[int, Dict[str, Any]]:
        return self.artifacts.handle(run_id, params, body)

    def cache_index(self) -> Tuple[int, Dict[str, Any]]:
        """``GET /fleet/cache`` — the distributable entry advert: empty,
        as the port has no compile cache to distribute."""
        return self._guarded("fleet.cache", self._cache_index)

    def _cache_index(self) -> Tuple[int, Dict[str, Any]]:
        return 200, {"entries": [], "bytes": 0}

    def cache_blob(self, name: str) -> Tuple[int, Dict[str, Any]]:
        """``GET /fleet/cache/<name>`` — no entry exists: 404."""
        return self._guarded("fleet.cache", self._cache_blob, name)

    def _cache_blob(self, name: str) -> Tuple[int, Dict[str, Any]]:
        return 404, {"error": f"no cache entry {name!r}"}

    def release(self, body: Dict[str, Any]
                ) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.release", self._release, body)

    def _release(self, body: Dict[str, Any]
                 ) -> Tuple[int, Dict[str, Any]]:
        worker = str(body.get("worker") or "")
        run = str(body.get("run") or "")
        ok = self.queue.release(run, worker)
        self._update_gauges()
        return 200, {"ok": ok}

    def status(self) -> Tuple[int, Dict[str, Any]]:
        return self._guarded("fleet.status", self._status)

    def _status(self) -> Tuple[int, Dict[str, Any]]:
        self.queue.expire()
        now = time.time()
        with self._lock:
            workers = {}
            for w, c in self.workers.items():
                row = {"host": c.get("host"),
                       "backend": c.get("backend"),
                       "mesh": c.get("mesh"),
                       "device-slots": c.get("device-slots"),
                       "version": c.get("version"),
                       "age-s": round(now - c["last-seen"], 3),
                       "alive": now - c["last-seen"] <=
                       ALIVE_LEASES * self.lease_s}
                wins = c.get("windows")
                if isinstance(wins, dict):
                    g = wins.get("gen")
                    auth = self._windows_digests.get(
                        int(g)) if isinstance(g, int) else None
                    row["windows"] = dict(
                        wins, synced=(auth is not None and
                                      wins.get("digest") == auth))
                    # clock-desync visibility: the worker's
                    # reported (offset-corrected) t0 vs the anchor
                    auth_t0 = (self._gen_t0.get(int(g))
                               if isinstance(g, int) else None)
                    wt0 = wins.get("t0")
                    if isinstance(wt0, (int, float)) \
                            and auth_t0 is not None:
                        skew = round(float(wt0) - auth_t0, 3)
                        row["windows"]["t0-skew"] = skew
                        row["windows"]["clock-synced"] = \
                            abs(skew) <= T0_SKEW_S
                workers[w] = row
            done = len(self._done_ids)
        self._update_gauges()
        counts = self.queue.counts()
        out = {
            "campaign": self.name,
            "gen": self.gen,
            "spec-digest": self.spec_digest,
            "total": len(self.specs),
            "done": done,
            "finished": done >= len(self.specs),
            "counts": counts,
            # the scaler's two inputs, first-class
            # instead of derivable-via-obs-sql
            "queue-depth": counts["queued"],
            "claim-latency-p95-s": self.queue.claim_latency_p95(),
            "leases": self.queue.leases(),
            "digest": self.queue.digest(),
            "boot-digest": self.boot_digest,
            "lease-s": self.lease_s,
            "workers": workers,
        }
        ap = self.autopilot
        if ap is not None:
            try:
                out["autopilot"] = ap.status_doc()
            except Exception:  # noqa: BLE001 — panel is best-effort
                logger.debug("autopilot status failed", exc_info=True)
        if self.sched:
            with self._lock:
                t0s = {str(g): t for g, t in
                       sorted(self._gen_t0.items())}
            out["nemesis-schedule"] = {
                "faults": self.sched["faults"],
                "windows": self.sched["windows"],
                "digest-by-gen": {str(g): d for g, d in
                                  sorted(self._windows_digests.items())},
                "t0-by-gen": t0s,
                "gens": {str(g): w for g, w in
                         sorted(self._windows_by_gen.items())},
            }
        return 200, out

    # -- internals -----------------------------------------------------------

    def _touch(self, worker: str) -> Dict[str, Any]:
        """Refresh a worker's liveness; unseen workers get implicit
        default capabilities (register is polite, not mandatory)."""
        with self._lock:
            caps = self.workers.setdefault(worker, {
                "host": None, "backend": None, "mesh": None,
                "device-slots": 1, "version": None,
                "registered": round(time.time(), 3),
                "last-seen": round(time.time(), 3)})
            caps["last-seen"] = round(time.time(), 3)
            return dict(caps)

    def _hb_for(self, campaign: str, total: Any = None,
                done: Any = None):
        from jepsen_tpu_torch.telemetry import Heartbeat

        with self._lock:
            hb = self._hbs.get(campaign)
            if hb is None:
                hb = self._hbs[campaign] = Heartbeat(
                    ccore.live_path(campaign, self.base),
                    campaign=campaign,
                    total=int(total or 0), done=int(done or 0))
            return hb

    def federated_metrics(self) -> Dict[str, Dict[str, Any]]:
        """The fleet exposition's source: each
        ALIVE worker's last pushed metrics snapshot, keyed by worker
        name.  Dead workers' series retire here — the same
        liveness-gated discipline as the verifier's per-session gauge
        retirement, so a scrape's series set shrinks back as workers
        expire instead of growing monotonically."""
        now = time.time()
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for w, c in self.workers.items():
                if now - c["last-seen"] > ALIVE_LEASES * self.lease_s:
                    continue
                mx = c.get("metrics")
                if isinstance(mx, dict) and mx.get("rows"):
                    out[w] = {"host": c.get("host"),
                              "version": c.get("version"),
                              "rows": list(mx["rows"]),
                              "age-s": round(now - mx["ts"], 3)}
        return out

    def _prune_workers(self, now: float) -> None:
        """Drop workers silent past PRUNE_LEASES from the registry —
        bounds the worker table (names embed pids, so a churning fleet
        mints new ones forever) and with it /fleet/status and the
        federated metrics surface.  Caller holds self._lock."""
        cutoff = PRUNE_LEASES * self.lease_s
        for w in [w for w, c in self.workers.items()
                  if now - c["last-seen"] > cutoff]:
            del self.workers[w]

    def gc_staging(self, now: Optional[float] = None) -> Dict[str, int]:
        """One artifact-staging retention pass:
        expire permanently abandoned upload partials, refresh the
        ``fleet-artifact-staging-bytes`` gauge."""
        return self.artifacts.gc(self.staging_retention_s, now=now)

    def _maybe_gc_staging(self, now: float) -> None:
        with self._lock:
            due = now >= self._staging_gc_at
            if due:
                self._staging_gc_at = now + STAGING_GC_INTERVAL_S
        if due:
            try:
                self.gc_staging(now)
            except Exception:  # noqa: BLE001 — retention is best-effort
                logger.debug("staging gc failed", exc_info=True)

    def _update_gauges(self) -> None:
        """The fleet's /metrics surface (live registry): workers alive
        by heartbeat freshness, active leases, cells by state."""
        try:
            reg = _registry()
            now = time.time()
            with self._lock:
                self._prune_workers(now)
                alive = sum(
                    1 for c in self.workers.values()
                    if now - c["last-seen"] <= ALIVE_LEASES * self.lease_s)
            c = self.queue.counts()
            reg.gauge("fleet-workers-alive").set(alive)
            reg.gauge("fleet-leases-active").set(c["claimed"])
            for state in ("queued", "claimed", "done"):
                reg.gauge("fleet-cells", state=state).set(c[state])
            # the scaler's two inputs: depth + claim p95
            reg.gauge("fleet-queue-depth").set(c["queued"])
            p95 = self.queue.claim_latency_p95()
            if p95 is not None:
                reg.gauge("fleet-claim-latency-p95-s").set(p95)
            if self.sched:
                # chaos visibility: currently-open windows across the
                # fleet, by fault family, from the workers' heartbeat
                # ticks (stale workers excluded by liveness)
                open_by_fault = {f: 0 for f in self.sched["faults"]}
                with self._lock:
                    for cw in self.workers.values():
                        if now - cw["last-seen"] > \
                                ALIVE_LEASES * self.lease_s:
                            continue
                        wins = cw.get("windows")
                        for o in (wins or {}).get("open") or ():
                            f = str((o or {}).get("fault"))
                            if f in open_by_fault:
                                open_by_fault[f] += 1
                for f, n in open_by_fault.items():
                    reg.gauge("fleet-nemesis-windows-active",
                              campaign=self.name, fault=f).set(n)
            self._maybe_gc_staging(now)
        except Exception:  # noqa: BLE001 — observability only
            logger.debug("fleet gauge update failed", exc_info=True)

    def summary(self) -> Dict[str, Any]:
        """The suite rollup once the fleet finished — the same shape
        `run_campaign` returns (`campaign.core.summarize`)."""
        return ccore.summarize(self.spec, self.base, idx=self.idx)

    def close(self) -> None:
        """Shut down the observability side.  Only THIS fleet's own
        heartbeat is closed, and only when its campaign actually
        finished — an interrupted fleet must leave its in-flight state
        in live.json for the /live post-mortem (same contract as
        `run_campaign`), and heartbeats created for OTHER campaigns
        pushing through /fleet/heartbeat belong to those campaigns:
        they close themselves via their own ``finished`` push."""
        with self._lock:
            hb = self._hbs.get(self.name)
        if hb is not None and self.finished:
            hb.close()
