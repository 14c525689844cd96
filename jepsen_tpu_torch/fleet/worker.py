"""The fleet worker: claim → execute → renew → complete, over HTTP (the
port's copy of `jepsen_tpu/fleet/worker.py`).

``cli fleet work --coordinator URL`` runs one of these until the
coordinator reports the campaign finished.  Execution is exactly
`campaign.core.execute_run` — shrink-on-invalid, telemetry streaming,
crash→attributable-record semantics all included — so a distributed
cell's index record is indistinguishable from a single-process one
(modulo the ``fleet-worker`` stamp the coordinator adds).

Resilience contract:

- every control-plane call goes through `resilience.device_call` with
  a seeded `RetryPolicy` and the :func:`~.policy.is_transient_http`
  classifier — connection refusals (a coordinator restarting),
  timeouts, 502/503/504, and injected `FaultInjected` transients are
  ridden out with bounded backoff; 4xx protocol errors propagate.
  The call sites are the ``fleet.*`` fault-plan family, so a plan
  installed in the worker process (``JEPSEN_FAULTS`` env in the chaos
  soak) drops/stalls the client side of the same seams the
  coordinator guards server-side.
- a renewer thread heartbeats + renews the lease at ``lease/3`` while
  a cell runs; a LOST lease (the coordinator expired it — e.g. after a
  partition) is noted but execution continues: the completion is then
  either the first verdict (accepted) or a zombie duplicate the
  coordinator discards.  Renewer failures never kill the run.
- SIGTERM (``cli fleet work`` installs the handler) drains gracefully:
  the in-flight cell finishes and uploads, a claimed-but-unstarted
  cell is released back to the queue, and the loop exits.

The port's differences: with ``cpu=True`` (``fleet work --cpu``) each
claimed cell's opts get ``"cpu"`` after `RunSpec.from_dict`, so its
checkers run on the CPU and its run id stays the coordinator's; without
it they run on the CUDA card, and with no card visible a device cell is
indexed as an unknown naming `NoDeviceError`, as a campaign's is.  The
port has no compile cache, so a worker pulls and pushes no cache
entries.  The ``backend`` capability is whatever the caller passes
(``fleet work --backend cuda`` on the card): a cell whose opts pin
``"backend": "cuda"`` is placed only on such a worker.
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import resilience, store
from jepsen_tpu_torch.campaign.plan import RunSpec
from jepsen_tpu_torch.campaign.scheduler import crash_record
from jepsen_tpu_torch.resilience import RetryPolicy
from jepsen_tpu_torch.resilience.policy import is_transient_http
from jepsen_tpu_torch.telemetry import spans as spans_mod

logger = logging.getLogger("jepsen.fleet")

__all__ = ["FleetWorker"]

#: cap on the metric rows one heartbeat pushes —
#: must stay under the coordinator's MAX_FEDERATED_SERIES so nothing
#: is silently dropped server-side
MAX_PUSHED_SERIES = 48


class FleetWorker:
    """One remote executor against a fleet coordinator."""

    def __init__(self, coordinator: str, base: Optional[str] = None, *,
                 name: Optional[str] = None, device_slots: int = 1,
                 backend: Optional[str] = None, mesh: Any = None,
                 poll_s: float = 0.5,
                 lease_s: float = 15.0,
                 retry: Optional[RetryPolicy] = None,
                 timeout_s: float = 10.0,
                 claim_budget_s: float = 120.0,
                 upload: bool = False,
                 version: Optional[str] = None,
                 cpu: bool = False):
        self.url = coordinator.rstrip("/")
        self.base = base or store.BASE
        self.name = name or f"{socket.gethostname()}-{os.getpid()}"
        #: rolling-upgrade identity: stamped at register
        #: and every heartbeat so the coordinator (and the autopilot's
        #: upgrade tick) can tell which build each worker runs
        self.version = str(
            version or os.environ.get("JEPSEN_WORKER_VERSION")
            or "dev")
        self.device_slots = int(device_slots)
        self.backend = backend
        self.mesh = mesh
        self.poll_s = float(poll_s)
        self.lease_s = float(lease_s)  # server value adopted at register
        self.timeout_s = float(timeout_s)
        #: how long claim outages are ridden out before giving up —
        #: spent in seeded-jittered backoff sleeps (each worker's delay
        #: stream is seeded from its own name, so a fleet recovering
        #: from a coordinator outage doesn't synchronize its re-poll
        #: storm)
        self.claim_budget_s = float(claim_budget_s)
        self._backoff_rng = random.Random(f"{self.name}|claim-backoff")
        # generous by default: the retry window must cover a
        # coordinator kill -9 + restart (a few seconds of ECONNREFUSED)
        self.retry = retry or RetryPolicy(
            max_attempts=8, base_delay_s=0.2, multiplier=2.0,
            max_delay_s=2.0, classify=is_transient_http)
        #: SIGTERM drain flag (cli fleet work sets it from the handler)
        self.stop = threading.Event()
        #: store federation: upload run dirs to the
        #: coordinator's artifact endpoint after each cell — no shared
        #: store filesystem needed.  Forced per cell by opts
        #: ``"artifact-upload": true`` even when the flag is off.
        self.upload = bool(upload)
        self.uploads_done = 0
        self.cells_done = 0
        self.duplicates = 0
        #: the last installed window set (digest + descriptors) — what
        #: heartbeat ticks report while a scheduled cell runs
        self.installed_windows: Optional[Dict[str, Any]] = None
        #: the in-flight cell's trace context: every
        #: control-plane POST made while a cell runs carries it in the
        #: Jepsen-Trace header — heartbeat/renew, artifact chunks,
        #: complete all stitch onto the run's one trace
        self._trace: Optional[spans_mod.TraceContext] = None
        #: run every claimed cell's checkers on the CPU
        self.cpu = bool(cpu)

    # -- transport -----------------------------------------------------------

    def _post(self, site: str, path: str,
              doc: Dict[str, Any]) -> Dict[str, Any]:
        """One guarded control-plane POST: the active fault plan fires
        at `site` (client-side chaos), transients retry per the
        policy."""
        return self._post_raw(site, path, json.dumps(doc).encode(),
                              ctype="application/json")

    def _post_raw(self, site: str, path: str, body: bytes, *,
                  ctype: str = "application/octet-stream",
                  accept_conflict: bool = False) -> Dict[str, Any]:
        """One guarded POST.  With ``accept_conflict``, protocol 409s
        are ANSWERS, not failures — their JSON body carries the
        server's cursor, so they parse (stamped ``_conflict``) instead
        of raising."""
        def send() -> Dict[str, Any]:
            headers = {"Content-Type": ctype}
            tr = self._trace
            if tr is not None:
                headers[spans_mod.TRACE_HEADER] = tr.header()
            req = urllib.request.Request(
                self.url + path, data=body,
                headers=headers, method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as r:
                    return json.loads(r.read().decode() or "{}")
            except urllib.error.HTTPError as e:
                if accept_conflict and e.code == 409:
                    doc = json.loads(e.read().decode() or "{}")
                    doc["_conflict"] = True
                    return doc
                raise

        return resilience.device_call(site, send, policy=self.retry)

    # -- store federation -----------------------------------------

    CHUNK_BYTES = 256 * 1024

    def _artifact_post(self, run_id: str, params: Dict[str, Any],
                       body: bytes) -> Dict[str, Any]:
        from urllib.parse import quote, urlencode

        q = urlencode({k: v for k, v in params.items()
                       if v is not None})
        path = f"/fleet/artifact/{quote(run_id)}" + (f"?{q}" if q
                                                     else "")
        return self._post_raw("fleet.artifact", path, body,
                              accept_conflict=True)

    #: how long an upload rides out a coordinator outage (a kill -9 +
    #: restart window) before giving up — each re-contact resumes from
    #: the server's durable cursor, so patience costs no re-sent bytes
    UPLOAD_BUDGET_S = 30.0

    def upload_artifact(self, run_id: str, rel: str) -> bool:
        """Stream one run dir to the coordinator's artifact endpoint
        (docs/FLEET.md federation): tar + sha256, chunked from the
        server's resume cursor — a coordinator kill -9 mid-upload
        leaves a resumable partial this loop picks back up after the
        restart; a digest mismatch restarts the upload from byte 0.
        Transport outages outlasting the retry policy re-probe under
        :data:`UPLOAD_BUDGET_S` instead of failing the upload."""
        import tempfile

        from .artifacts import pack_run_dir_file

        d = os.path.join(self.base, rel)
        if not os.path.isdir(d):
            logger.warning("fleet worker %s: no run dir %s to upload",
                           self.name, d)
            return False
        with tempfile.TemporaryFile(prefix="jepsen-artifact-") as spool:
            total, digest = pack_run_dir_file(d, spool)
            return self._upload_spooled(run_id, rel, spool, total,
                                        digest)

    def _upload_spooled(self, run_id: str, rel: str, spool: Any,
                        total: int, digest: str) -> bool:
        # budget anchors the CONTINUOUS outage, not total upload time:
        # every successful request pushes the deadline back out
        deadline = time.monotonic() + self.UPLOAD_BUDGET_S

        def patient(params: Dict[str, Any], body: bytes
                    ) -> Optional[Dict[str, Any]]:
            nonlocal deadline
            while True:
                try:
                    r = self._artifact_post(run_id, params, body)
                    deadline = time.monotonic() + self.UPLOAD_BUDGET_S
                    return r
                except urllib.error.HTTPError as e:
                    if e.code < 500:
                        # deterministic protocol rejection (oversized
                        # artifact, bad rel): no retry can land it —
                        # fail fast instead of burning the outage
                        # budget on a non-outage
                        logger.warning(
                            "fleet worker %s: artifact upload of %s "
                            "rejected (%s); giving up", self.name,
                            run_id, e)
                        return None
                    if time.monotonic() > deadline:
                        logger.warning(
                            "fleet worker %s: artifact upload of %s "
                            "gave up after %.0fs of outage (%s)",
                            self.name, run_id, self.UPLOAD_BUDGET_S, e)
                        return None
                    time.sleep(0.5)
                except Exception as e:  # noqa: BLE001 — outage window
                    if time.monotonic() > deadline:
                        logger.warning(
                            "fleet worker %s: artifact upload of %s "
                            "gave up after %.0fs of outage (%s)",
                            self.name, run_id, self.UPLOAD_BUDGET_S, e)
                        return None
                    time.sleep(0.5)

        probe = patient({}, b"")
        if probe is None:
            return False
        if probe.get("landed") and probe.get("rel", rel) == rel:
            return True
        if probe.get("rel", rel) != rel:
            # the marker/partial is another execution's dir (lease-
            # lapse re-run, new timestamp): upload ours from scratch —
            # the server discards the stale state on the first chunk
            probe = {"received": 0}
        offset = int(probe.get("received", 0))
        restarts = 0
        while True:
            spool.seek(offset)
            chunk = spool.read(self.CHUNK_BYTES)
            r = patient(
                {"offset": offset, "total": total,
                 "digest": digest, "rel": rel}, chunk)
            if r is None:
                return False
            if r.get("landed"):
                self.uploads_done += 1
                return True
            if r.get("_conflict"):
                got = int(r.get("received", 0))
                if got == 0:
                    # a discard-class answer (digest mismatch, unpack
                    # failure), not a resume gap — gaps always carry a
                    # positive cursor.  Counted regardless of offset:
                    # a single-chunk upload conflicts AT offset 0, and
                    # without the count it would re-POST forever while
                    # the kept-alive lease pins the cell to this worker
                    restarts += 1  # retry from 0 once, then give up
                    if restarts > 1:
                        logger.warning(
                            "fleet worker %s: artifact %s rejected "
                            "twice (%s); giving up", self.name,
                            run_id, r.get("error"))
                        return False
                offset = got
                continue
            new_off = int(r.get("received", offset + len(chunk)))
            if new_off <= offset and chunk:
                logger.warning(
                    "fleet worker %s: artifact upload of %s stuck at "
                    "%d", self.name, run_id, offset)
                return False
            offset = new_off

    # -- protocol ------------------------------------------------------------

    def register(self) -> Dict[str, Any]:
        r = self._post("fleet.register", "/fleet/register", {
            "worker": self.name, "host": socket.gethostname(),
            "backend": self.backend, "mesh": self.mesh,
            "device-slots": self.device_slots,
            "version": self.version})
        if isinstance(r.get("lease-s"), (int, float)):
            self.lease_s = float(r["lease-s"])
        logger.info("fleet worker %s registered with %s (campaign %s, "
                    "lease %.1fs)", self.name, self.url,
                    r.get("campaign"), self.lease_s)
        return r

    def _claim_backoff(self, fails: int) -> float:
        """One seeded-jittered backoff delay for the `fails`-th
        consecutive claim outage: exponential from `poll_s`, capped,
        each draw scaled by a per-worker random factor — two workers
        with the same poll settings still desynchronize their re-poll
        storms against a recovering coordinator."""
        base = min(self.poll_s * (2.0 ** max(0, fails - 1)), 5.0)
        return base * self._backoff_rng.uniform(0.5, 1.5)

    def run(self) -> int:
        """Claim-execute until the campaign finishes (or SIGTERM
        drains); returns the number of cells this worker completed."""
        self.register()
        claim_fails = 0
        claim_waited = 0.0
        while not self.stop.is_set():
            try:
                r = self._post("fleet.claim", "/fleet/claim",
                               {"worker": self.name})
            except Exception as e:  # noqa: BLE001 — outage outlasting
                # the retry budget: keep polling under seeded jittered
                # backoff (a daemon rides out long partitions), give up
                # only once the configured budget is spent
                claim_fails += 1
                delay = self._claim_backoff(claim_fails)
                if claim_waited + delay > self.claim_budget_s:
                    logger.error(
                        "fleet worker %s: claim outage outlasted the "
                        "%.1fs budget (%d attempts); giving up",
                        self.name, self.claim_budget_s, claim_fails)
                    raise
                claim_waited += delay
                logger.warning("fleet worker %s: claim failed (%s); "
                               "re-polling in %.2fs", self.name, e,
                               delay)
                time.sleep(delay)
                continue
            claim_fails = 0
            claim_waited = 0.0
            spec = r.get("spec")
            if not spec:
                if r.get("finished"):
                    break
                time.sleep(self.poll_s)
                continue
            if self.stop.is_set():
                # drained between claim and start: give the cell back
                # instead of sitting on the lease until it lapses
                self._post("fleet.release", "/fleet/release",
                           {"worker": self.name, "run": spec["run_id"]})
                break
            self._run_cell(spec, r.get("windows"), r.get("trace"))
        logger.info("fleet worker %s done: %d cells completed "
                    "(%d duplicates discarded upstream)",
                    self.name, self.cells_done, self.duplicates)
        return self.cells_done

    def _install_windows(self, rs: RunSpec,
                         windows: Optional[Dict[str, Any]]) -> None:
        """Install the claim response's synchronized window set before
        `execute_run`.  The claim broadcast is
        authoritative: it overrides whatever the ledger's serialized
        spec carried (a cell enqueued before the schedule existed, or
        by an older coordinator), so every host's cell for generation
        *g* runs the same seeded windows at the same schedule
        positions.  The worker's name rides along as the executing
        host, the attribution the cross-host fault-window ddmin
        surfaces."""
        from jepsen_tpu_torch.campaign.plan import windows_digest

        rs.opts["_fleet-host"] = self.name
        wins = (windows or {}).get("set")
        if wins is not None:
            rs.opts["nemesis-windows"] = wins
        wins = rs.opts.get("nemesis-windows")
        if wins:
            self.installed_windows = {
                "gen": int(rs.seed),
                "digest": windows_digest(wins),
                "set": wins,
            }
            # wall-clock t0 alignment: the claim carries the
            # coordinator's absolute window anchor plus its "now";
            # delta converts the anchor into THIS host's clock domain,
            # so every host's windows fire at the same absolute time
            # instead of `at_s` past whenever each workload happened
            # to start.  The aligned anchor rides opts["nemesis-t0"]
            # into `combined.schedule_package`.
            t0 = (windows or {}).get("t0")
            now = (windows or {}).get("now")
            if isinstance(t0, (int, float)) \
                    and isinstance(now, (int, float)):
                delta = time.time() - float(now)
                t0_local = float(t0) + delta
                self.installed_windows["t0"] = round(t0_local, 3)
                rs.opts["nemesis-t0"] = t0_local
            want = (windows or {}).get("digest")
            if want and want != self.installed_windows["digest"]:
                logger.warning(
                    "fleet worker %s: installed window digest %s != "
                    "coordinator's %s for gen %s", self.name,
                    self.installed_windows["digest"], want, rs.seed)
        else:
            self.installed_windows = None

    def _window_ticks(self, t0: float) -> Optional[Dict[str, Any]]:
        """The heartbeat's chaos-clock payload: installed digest plus
        which schedule positions are open right now (derived from the
        deterministic window offsets and the cell's elapsed wall
        clock) — lease renewal doubles as window open/close tick
        sync."""
        iw = self.installed_windows
        if not iw:
            return None
        # one read: the cell thread may pop "t0" (stale-anchor path)
        # between a has-key check and a lookup on this renewer thread
        t0v = iw.get("t0")
        if t0v is not None:
            # aligned mode: elapsed runs from the shared wall-clock
            # anchor, so two hosts' open/closed reports agree even when
            # their workloads started at different times
            elapsed = time.time() - float(t0v)
        else:
            elapsed = time.monotonic() - t0
        open_: List[Dict[str, Any]] = [
            {"pos": w.get("pos"), "fault": w.get("fault")}
            for w in iw["set"]
            if w["at_s"] <= elapsed < w["at_s"] + w["dur_s"]]
        out = {"gen": iw["gen"], "digest": iw["digest"],
               "n": len(iw["set"]), "open": open_,
               "elapsed": round(elapsed, 3)}
        if t0v is not None:
            out["t0"] = t0v
        return out

    def metrics_snapshot(self) -> List[Dict[str, Any]]:
        """The heartbeat's metrics payload: this
        worker's own progress counters, process RSS, the jit
        compile-cache stats, and a bounded slice of the process-wide
        registry — what the coordinator re-exposes with ``host=``
        labels so one scrape sees the whole fleet."""
        rows: List[Dict[str, Any]] = [
            {"name": "worker-cells-done", "kind": "counter",
             "labels": {}, "value": self.cells_done},
            {"name": "worker-uploads-done", "kind": "counter",
             "labels": {}, "value": self.uploads_done},
            {"name": "worker-duplicate-completions", "kind": "counter",
             "labels": {}, "value": self.duplicates},
        ]
        try:
            from jepsen_tpu_torch.telemetry.stream import _hwm_bytes, _rss_bytes

            rss = _rss_bytes()
            if rss:
                rows.append({"name": "worker-rss-bytes",
                             "kind": "gauge", "labels": {},
                             "value": rss})
                # the kernel high watermark federates the worker's PEAK
                # footprint: visible fleet-wide even when no
                # scrape coincided with the spike, and retired with the
                # worker's liveness like every host-attributed series
                hwm = _hwm_bytes()
                rows.append({"name": "worker-rss-peak-bytes",
                             "kind": "gauge", "labels": {},
                             "value": max(rss, hwm or 0)})
        except Exception:  # noqa: BLE001 — observability only
            pass
        try:
            # compile cost: the process's first sightings of each
            # (site, shape class), visible fleet-wide on one scrape
            from jepsen_tpu_torch.resilience.guard import compile_cache_stats

            st = compile_cache_stats()
            rows.append({"name": "jit-cache-entries", "kind": "gauge",
                         "labels": {}, "value": st["entries"]})
            rows.append({"name": "compile-cache-miss",
                         "kind": "counter", "labels": {},
                         "value": st["misses"]})
        except Exception:  # noqa: BLE001
            pass
        try:
            from jepsen_tpu_torch.telemetry import metrics as metrics_mod

            snap = metrics_mod.registry().snapshot()
            extra = [
                dict(name=m["name"], kind=kind, labels=m["labels"],
                     value=float(m["value"]))
                for kind, group in (("counter", snap["counters"]),
                                    ("gauge", snap["gauges"]))
                for m in sorted(group, key=lambda m: (
                    m["name"], str(sorted(m["labels"].items()))))
                if isinstance(m.get("value"), (int, float))]
            rows.extend(extra[:max(0, MAX_PUSHED_SERIES - len(rows))])
        except Exception:  # noqa: BLE001
            pass
        return rows[:MAX_PUSHED_SERIES]

    def _run_cell(self, spec: Dict[str, Any],
                  windows: Optional[Dict[str, Any]] = None,
                  trace: Optional[Dict[str, Any]] = None) -> None:
        from jepsen_tpu_torch.campaign.core import execute_run

        rs = RunSpec.from_dict(spec)
        rs.opts["_base"] = self.base
        if self.cpu:
            rs.opts["cpu"] = True  # after from_dict: the run id stays
        self._install_windows(rs, windows)
        run_id = rs.run_id
        # distributed trace: adopt the claim's trace id —
        # equal to the locally derivable one (both are pure functions
        # of the run id), so a claim from an older coordinator still
        # traces.  The worker's own control-plane segment parents on
        # the claim segment the coordinator handed out.
        trace_id = str((trace or {}).get("trace-id")
                       or spans_mod.trace_id_for(run_id))
        rs.opts["trace-id"] = trace_id
        self._trace = spans_mod.trace_context(trace_id,
                                              f"fleet:worker:{self.name}")
        t_claim = time.monotonic()
        state = {"run": run_id, "workload": rs.workload_label,
                 "fault": rs.fault_label, "seed": rs.seed,
                 "slot": None, "worker-host": socket.gethostname()}
        if self.installed_windows:
            state["windows-digest"] = self.installed_windows["digest"]
        stop_renew = threading.Event()
        lease_lost = threading.Event()
        t0 = time.monotonic()

        def renew_loop() -> None:
            # heartbeat + renew at lease/3; failures are logged, never
            # fatal — a lapsed lease just makes the completion racy,
            # which the coordinator's at-most-once rule resolves
            while not stop_renew.wait(max(0.2, self.lease_s / 3.0)):
                try:
                    r = self._post("fleet.heartbeat", "/fleet/heartbeat",
                                   {"worker": self.name, "state": state,
                                    "version": self.version,
                                    "windows": self._window_ticks(t0),
                                    "metrics": self.metrics_snapshot(),
                                    "renew": [run_id]})
                    if run_id in (r.get("lost") or []):
                        lease_lost.set()
                        logger.warning(
                            "fleet worker %s: lease on %s LOST "
                            "(requeued elsewhere); finishing anyway",
                            self.name, run_id)
                    want = r.get("windows-digest")
                    if want and self.installed_windows and \
                            want != self.installed_windows["digest"]:
                        logger.warning(
                            "fleet worker %s: window desync on %s "
                            "(installed %s, coordinator %s); will "
                            "reinstall at next claim", self.name,
                            run_id, self.installed_windows["digest"],
                            want)
                except Exception as e:  # noqa: BLE001 — best-effort
                    logger.warning("fleet worker %s: heartbeat failed "
                                   "(%s)", self.name, e)

        # announce the claim before execution so the live dashboard
        # names the in-flight cell even if the run wedges instantly
        try:
            self._post("fleet.heartbeat", "/fleet/heartbeat",
                       {"worker": self.name, "state": state,
                        "version": self.version,
                        "windows": self._window_ticks(t0),
                        "metrics": self.metrics_snapshot(),
                        "renew": [run_id]})
        except Exception:  # noqa: BLE001
            pass
        renewer = threading.Thread(target=renew_loop, daemon=True,
                                   name=f"fleet-renew-{self.name}")
        renewer.start()
        # wall-clock t0 alignment: hold the workload until the
        # generation's (clock-offset-corrected) anchor so every host
        # starts — and therefore fires its windows — at the same
        # absolute time, while the offsets stay RELATIVE to workload
        # start (chaos-equivalent with the single-process expansion of
        # the same spec).  A stale anchor (claimed late,
        # or a clock jumped) is skipped, bounded by the claim lead.
        iw = self.installed_windows
        if iw and iw.get("t0") is not None:
            wait = float(iw["t0"]) - time.time()
            if 0.0 < wait <= 5.0:
                time.sleep(wait)
            else:
                if wait > 5.0:
                    logger.warning(
                        "fleet worker %s: window anchor %.3fs ahead "
                        "(clock skew?); starting unaligned", self.name,
                        wait)
                # drop the anchor entirely, for a far-future anchor
                # (clock skew — leaving nemesis-t0 set would shift
                # every window by the full skew, silently diverging
                # from the single-process schedule) AND for a stale
                # one (claimed after t0, e.g. a later cell of the
                # same generation — schedule_package clamps the shift
                # to 0, so anchor-based ticks would report windows
                # closed that actually fire relative to workload
                # start).  Unaligned means RELATIVE offsets from
                # workload start — and the tick
                # clock must agree with where the faults really fire.
                iw.pop("t0", None)
                rs.opts.pop("nemesis-t0", None)
        t0 = time.monotonic()  # the window tick clock: workload start
        # the claim→workload-start gap: claim transport,
        # window install, and anchor wait — stamped as a gateable span
        # on the index record next to the coordinator's enqueue-wait
        claim_to_start_s = time.monotonic() - t_claim
        # mesh capability -> default-mesh shard count: a cell pinning
        # opts["mesh"] — or a worker advertising one — pins its device
        # checks to exactly that many devices: `parallel.slots.
        # default_mesh` reads it for every sharded-by-default check
        # (`core_check_auto`, `core_check_exact`, `list_append.check`,
        # the bank and session reductions).  On one card, or on the
        # CPU, the pin leaves the single-device path, as on a one-device
        # JAX host.  The pin
        # is THREAD-LOCAL (slots.set_forced_shards): several workers may
        # share one process, and a process-global env pin would leak
        # across their concurrently executing cells
        import math

        from jepsen_tpu_torch.fleet.queue import _norm_mesh
        from jepsen_tpu_torch.parallel import slots as slots_mod

        want_mesh = _norm_mesh(rs.opts.get("mesh")) or \
            _norm_mesh(self.mesh)
        if want_mesh:
            slots_mod.set_forced_shards(math.prod(want_mesh))
        try:
            rec = execute_run(rs, self.base)
        except Exception as e:  # noqa: BLE001 — same contract as the
            # scheduler: whatever escapes execute_run becomes an
            # attributable unknown record, never a worker crash
            rec = crash_record(rs, f"{type(e).__name__}: {e}", 1,
                               time.monotonic() - t0)
        finally:
            if want_mesh:
                slots_mod.set_forced_shards(None)
        # store federation: ship the run dir BEFORE the verdict record,
        # so the record's "dir" is browsable on the coordinator the
        # moment the verdict lands.  Best-effort with retries — an
        # upload outage never loses the verdict (the record carries
        # it), and the idempotent protocol makes a re-upload after a
        # lease-lapse re-execution harmless.  The renewer stays alive
        # through upload AND complete: an outage-ridden upload
        # (UPLOAD_BUDGET_S) can outlast the lease, and without
        # renewals the cell would spuriously requeue and re-execute
        # while this attempt is seconds from landing.
        try:
            rec.setdefault("trace", trace_id)
            sp = rec.setdefault("spans", {})
            if isinstance(sp, dict):
                sp.setdefault("fleet:claim-to-start",
                              round(claim_to_start_s, 6))
            if (self.upload or rs.opts.get("artifact-upload")) \
                    and isinstance(rec.get("dir"), str):
                t_up = time.monotonic()
                try:
                    if not self.upload_artifact(run_id, rec["dir"]):
                        logger.warning(
                            "fleet worker %s: artifact upload of %s "
                            "did not land", self.name, run_id)
                except Exception as e:  # noqa: BLE001 — verdict >
                    # artifact
                    logger.warning("fleet worker %s: artifact upload "
                                   "of %s failed (%s)", self.name,
                                   run_id, e)
                finally:
                    if isinstance(sp, dict):
                        sp.setdefault(
                            "fleet:upload",
                            round(time.monotonic() - t_up, 6))
            try:
                r = self._post("fleet.complete", "/fleet/complete",
                               {"worker": self.name, "run": run_id,
                                "record": rec})
                if r.get("duplicate"):
                    self.duplicates += 1
                    logger.warning(
                        "fleet worker %s: completion of %s was a "
                        "duplicate (cell finished elsewhere)",
                        self.name, run_id)
                else:
                    self.cells_done += 1
            except Exception as e:  # noqa: BLE001 — an outage
                # outlasting the retries loses THIS attempt, not the
                # cell: the lease lapses, the cell requeues, and
                # another worker (or this one, next claim) re-executes
                # it — exactly-once still holds because this record
                # never landed
                logger.warning("fleet worker %s: complete(%s) failed "
                               "beyond retries (%s); cell will "
                               "requeue on lease expiry", self.name,
                               run_id, e)
        finally:
            stop_renew.set()
            renewer.join(timeout=5)
            self.installed_windows = None
            try:
                self._post("fleet.heartbeat", "/fleet/heartbeat",
                           {"worker": self.name, "state": None,
                            "version": self.version,
                            "metrics": self.metrics_snapshot(),
                            "windows": None})
            except Exception:  # noqa: BLE001
                pass
            self._trace = None
