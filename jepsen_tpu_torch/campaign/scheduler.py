"""Device-aware worker pool for campaign runs (the port's copy of
`jepsen_tpu/campaign/scheduler.py`).

The placement rule mirrors the hardware: host-only checking (stats,
set, the elle host oracle) parallelizes freely across worker threads,
but device-pipeline runs (elle list-append/rw-register, knossos device
WGL, the invariants and queue families) contend for the one card — so
RunSpecs marked ``device=True`` serialize through a bounded set of
:class:`DeviceSlots` (default 1 slot: one device pipeline at a time;
each run learns its slot id, `parallel.slots.set_active_slot`).

Isolation + resilience per run:

- ``executor="thread"`` (default) runs in-process — cheap, shares the
  built kernels and the card's context across runs.  Two
  process-global resources constrain it: the telemetry collector
  (`telemetry.activate` is process-wide, so TELEMETRIC runs
  additionally serialize through one token — a concurrent pair would
  cross-attribute each other's spans), and the shared "jepsen" logger
  (concurrent runs' ``jepsen.log`` files can interleave lines; use the
  subprocess executor when per-run logs must be pristine);
- ``executor="subprocess"`` re-invokes ``python -m
  jepsen_tpu_torch.campaign.runner`` per run, in a session of its own —
  a crashing checker cannot take the campaign down, and the hard
  ``run_deadline_s`` is enforced on the runner's whole process group:
  SIGTERM (the runner turns it into `SystemExit`, so the run's db
  teardown stops the daemons it started), a grace of
  `TERM_GRACE_S`, then SIGKILL, then a wait.  The JAX module's
  ``subprocess.run(timeout=)`` killed the runner alone.  Workloads
  registered with an importable builder are registered again in the
  runner (`plan.registered`);
- crashed runs retry per a seeded `resilience.RetryPolicy` (every
  exception is retryable at this level — the run may have died to an
  environment flake), and whatever survives the retries is recorded as
  an attributable ``valid? unknown`` record, never an exception: the
  campaign always completes with a full index.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch.campaign.plan import RunSpec
from jepsen_tpu_torch.resilience import RetryPolicy

logger = logging.getLogger("jepsen.campaign")

__all__ = ["DeviceSlots", "Scheduler", "crash_record", "TERM_GRACE_S"]

#: seconds a runner past its deadline has, after SIGTERM, to tear its
#: run down before its process group is killed
TERM_GRACE_S = 5.0


class DeviceSlots:
    """A bounded pool of device slots.  `acquire()` blocks until a slot
    frees and returns its index (stable ids, lowest-free-first) so a
    run can pin work to "its" mesh slice; `try_acquire()` is the
    non-blocking form the scheduler uses so a slotless device run parks
    back in the queue instead of wedging a worker."""

    def __init__(self, n: int = 1):
        self.n = max(1, int(n))
        self._free = list(range(self.n))
        self._cv = threading.Condition()

    def acquire(self) -> int:
        with self._cv:
            while not self._free:
                self._cv.wait()
            return self._free.pop(0)

    def try_acquire(self) -> Optional[int]:
        with self._cv:
            return self._free.pop(0) if self._free else None

    def release(self, slot: int) -> None:
        with self._cv:
            self._free.append(slot)
            self._free.sort()
            self._cv.notify()


def crash_record(rs: RunSpec, err: str, attempt: int,
                 wall_s: float = 0.0) -> Dict[str, Any]:
    """The attributable record for a run that died outside `core.run`'s
    own error handling — still a verdict, never a crash."""
    from jepsen_tpu_torch.telemetry import spans as _spans

    return {
        "run": rs.run_id, "key": rs.key, "campaign": rs.campaign,
        "workload": rs.workload_label, "fault": rs.fault_label,
        "seed": rs.seed, "valid?": "unknown", "error": err,
        "trace": _spans.trace_id_for(rs.run_id),
        "degraded": None, "deadline": False, "dir": None,
        "ops": 0, "wall_s": round(wall_s, 3), "attempt": attempt,
        "spans": {},
    }


class Scheduler:
    """Run a list of RunSpecs across `n_workers` threads."""

    def __init__(self, n_workers: int = 2, *, device_slots: int = 1,
                 executor: str = "thread",
                 retry: Optional[RetryPolicy] = None,
                 run_deadline_s: Optional[float] = None,
                 heartbeat: Optional[Any] = None):
        if executor not in ("thread", "subprocess"):
            raise ValueError(f"unknown executor {executor!r}")
        self.n_workers = max(1, int(n_workers))
        self.slots = DeviceSlots(device_slots)
        self.executor = executor
        #: optional telemetry.Heartbeat: per-worker in-flight state
        #: published to the campaign ledger dir as runs start/finish —
        #: the live fleet dashboard's data (docs/TELEMETRY.md)
        self.heartbeat = heartbeat
        # campaign-level retries: ANY exception is retryable here (the
        # run may have died to an env flake, not a code bug); seeded
        # backoff keeps faulted campaigns replayable
        self.retry = retry or RetryPolicy(max_attempts=2, base_delay_s=0.1,
                                          classify=lambda e: True)
        self.run_deadline_s = run_deadline_s
        # one telemetric thread-run at a time: the collector activated
        # by core.run is process-global, so a concurrent pair would
        # record each other's spans (subprocess runs are immune)
        self._tel_lock = threading.Lock()

    def run(self, specs: List[RunSpec],
            execute: Callable[[RunSpec], Dict[str, Any]],
            on_result: Optional[Callable[[Dict[str, Any]], None]] = None
            ) -> List[Dict[str, Any]]:
        """Execute every spec; returns records in spec order.  `execute`
        maps a RunSpec to its index record (the thread-executor path);
        the subprocess executor ignores it and shells out to the runner
        module.  `on_result` fires on the scheduler threads as records
        land (the campaign appends to the index there, so a kill
        mid-campaign loses at most the in-flight runs)."""
        q: "queue.Queue[tuple]" = queue.Queue()
        for i, rs in enumerate(specs):
            q.put((i, rs))
        results: List[Optional[Dict[str, Any]]] = [None] * len(specs)
        lock = threading.Lock()
        # queue-wait accounting (the phase taxonomy): a parked run
        # stamps its park time; the dequeue that finally proceeds books
        # the gap.  Entries are only ever touched by the thread holding
        # that queue item, so plain dicts suffice.
        parked: Dict[int, float] = {}
        waited: Dict[int, float] = {}
        nparks: Dict[int, int] = {}

        def park(i: int, rs: RunSpec) -> None:
            parked[i] = time.monotonic()
            nparks[i] = nparks.get(i, 0) + 1
            q.put((i, rs))
            time.sleep(0.02)

        def work() -> None:
            while True:
                try:
                    i, rs = q.get_nowait()
                except queue.Empty:
                    return
                t_park = parked.pop(i, None)
                if t_park is not None:
                    waited[i] = (waited.get(i, 0.0)
                                 + (time.monotonic() - t_park))
                slot = None
                if rs.device:
                    # never BLOCK a worker on a slot: a slotless device
                    # run goes back in the queue so host-only runs
                    # behind it keep flowing ("host-only runs fill all
                    # workers freely"); the brief sleep bounds the spin
                    # when only device work remains
                    slot = self.slots.try_acquire()
                    if slot is None:
                        park(i, rs)
                        continue
                # wanted_for, not a bare opts check: the process-wide
                # telemetry.enable()/JEPSEN_TELEMETRY opt-ins make
                # core.run activate a collector too
                from jepsen_tpu_torch import telemetry

                tel = (self.executor == "thread" and telemetry.wanted_for(
                    {"telemetry": rs.opts.get("telemetry")}))
                if tel and not self._tel_lock.acquire(blocking=False):
                    # same park-don't-block rule for the telemetry token
                    if slot is not None:
                        self.slots.release(slot)
                    park(i, rs)
                    continue
                # Heartbeat methods never raise (see its no-raise
                # guarantee) — no defensive wrapping here
                hb = self.heartbeat
                wname = threading.current_thread().name
                if hb is not None:
                    st = {
                        "run": rs.run_id, "workload": rs.workload_label,
                        "fault": rs.fault_label, "seed": rs.seed,
                        "slot": slot}
                    if rs.opts.get("nemesis-windows"):
                        # parity with fleet workers: the live dashboard
                        # shows which window set a local worker runs
                        from jepsen_tpu_torch.campaign.plan import \
                            windows_digest

                        st["windows-digest"] = windows_digest(
                            rs.opts["nemesis-windows"])
                    hb.worker(wname, st)
                try:
                    rec = self._run_one(rs, execute, slot)
                finally:
                    if tel:
                        self._tel_lock.release()
                    if slot is not None:
                        self.slots.release(slot)
                    if hb is not None:
                        hb.worker(wname, None)
                if hb is not None:
                    hb.record_done(rs.run_id, rec.get("valid?"))
                qw = waited.pop(i, None)
                if qw:
                    try:
                        ph = rec.setdefault("phases", {}).setdefault(
                            "run", {})
                        ph["queue_wait_s"] = round(
                            float(ph.get("queue_wait_s") or 0.0) + qw, 6)
                        n = nparks.pop(i, 1)
                        cn = rec.setdefault("counters", {})
                        cn["scheduler-requeues"] = (
                            float(cn.get("scheduler-requeues") or 0) + n)
                        telemetry.registry().counter(
                            "scheduler-requeues").inc(n)
                    except Exception:  # noqa: BLE001 — accounting only
                        pass
                with lock:
                    results[i] = rec
                    if on_result is not None:
                        try:
                            on_result(rec)
                        except Exception:  # noqa: BLE001
                            logger.exception("on_result failed for %s",
                                             rs.run_id)

        threads = [threading.Thread(target=work, daemon=True,
                                    name=f"campaign-worker-{w}")
                   for w in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [r for r in results if r is not None]

    # -- one run, with slots + retries --------------------------------------

    def _run_one(self, rs: RunSpec,
                 execute: Callable[[RunSpec], Dict[str, Any]],
                 slot: Optional[int] = None) -> Dict[str, Any]:
        t0 = time.monotonic()
        delays = self.retry.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                if self.executor == "subprocess":
                    rec = self._run_subprocess(rs, slot)
                else:
                    # pin this thread's device slot to the acquired one
                    # (parallel/slots.py): the run can read which slot
                    # it holds
                    from jepsen_tpu_torch.parallel import slots as slots_mod

                    slots_mod.set_active_slot(slot, self.slots.n)
                    try:
                        rec = execute(rs)
                    finally:
                        slots_mod.set_active_slot(None)
                rec["attempt"] = attempt
                if slot is not None:
                    rec["device-slot"] = slot
                return rec
            except Exception as e:  # noqa: BLE001 — retried below
                delay = next(delays, None)
                err = f"{type(e).__name__}: {e}"
                if delay is None:
                    logger.warning("run %s failed after %d attempt(s): "
                                   "%s", rs.run_id, attempt, err)
                    rec = crash_record(
                        rs, err + "\n" + traceback.format_exc(limit=3),
                        attempt, time.monotonic() - t0)
                    if slot is not None:
                        rec["device-slot"] = slot
                    return rec
                logger.warning("run %s attempt %d failed (%s); "
                               "retrying in %.2fs", rs.run_id, attempt,
                               err, delay)
                time.sleep(delay)

    # -- subprocess isolation ------------------------------------------------

    def _run_subprocess(self, rs: RunSpec, slot: Optional[int]
                        ) -> Dict[str, Any]:
        """One run in its own interpreter and session: `python -m
        jepsen_tpu_torch.campaign.runner` reads the RunSpec JSON on
        stdin, prints the index record as its last stdout line.  A
        deadline overrun ends the runner's whole process group
        (`_end_group`) -> attributable unknown.  The runner inherits
        this process's environment."""
        from jepsen_tpu_torch.campaign.plan import registered

        base = rs.opts.get("_base") or "store"
        payload = json.dumps({"runspec": rs.to_dict(), "base": base,
                              "workloads": registered()})
        env = dict(os.environ)
        if slot is not None:
            env["JEPSEN_CAMPAIGN_DEVICE_SLOT"] = str(slot)
            env["JEPSEN_CAMPAIGN_DEVICE_SLOTS"] = str(self.slots.n)
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.campaign.runner"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=os.getcwd(),
            start_new_session=True)
        try:
            out, err = proc.communicate(payload,
                                        timeout=self.run_deadline_s)
        except subprocess.TimeoutExpired:
            _end_group(proc)
            rec = crash_record(rs, "run-deadline-exceeded "
                               f"({self.run_deadline_s}s, killed)", 1)
            rec["deadline"] = True
            return rec
        except BaseException:
            # interrupted (KeyboardInterrupt, SystemExit from a signal
            # handler): the runner's group goes with its caller
            _end_group(proc, grace_s=0.0)
            raise
        for line in reversed((out or "").strip().splitlines()):
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except ValueError:
                    break
        raise RuntimeError(
            f"runner rc={proc.returncode}, no record on stdout; stderr "
            f"tail: {(err or '')[-500:]}")


def _end_group(proc: subprocess.Popen, grace_s: float = TERM_GRACE_S
               ) -> None:
    """End a runner that leads its own session: SIGTERM to its process
    group, up to `grace_s` for the runner to exit (its teardown runs),
    then SIGKILL to whatever is left of the group, then collect it."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            pass  # the whole group is gone
        if sig == signal.SIGTERM:
            try:
                proc.communicate(timeout=grace_s)
            except subprocess.TimeoutExpired:
                pass
    proc.communicate()
