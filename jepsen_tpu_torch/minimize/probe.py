"""Candidate re-checking — the shrinker's execution engine (the port's
copy of `jepsen_tpu/minimize/probe.py`).

Each ddmin candidate is a re-closed sub-history that must be run back
through the SAME checker that judged the original run, under a
per-probe :class:`resilience.Deadline` (a pathological candidate must
cost at most ``probe_deadline_s``, never the whole shrink budget) and
the `device_call` guard the checkers already wrap their device seams in
(a synthetic `FaultInjected` degrades to the host path — a degraded
probe still yields a usable verdict).

Fan-out reuses the campaign layer's machinery wholesale: candidates of
one round become throwaway :class:`~jepsen_tpu_torch.campaign.plan.RunSpec`\\s
executed by :class:`~jepsen_tpu_torch.campaign.scheduler.Scheduler` —
device-pipeline probes (elle list-append / rw-register, knossos device
WGL, the invariants and queue families) serialize through its
:class:`DeviceSlots` exactly like campaign cells (one card), while
host-only probes fill all workers.  A probe that crashes out of its
retries comes back as an attributable ``valid? unknown`` record, which
the shrinker conservatively treats as "does not reproduce" — a flaky
probe can cost minimality, never soundness.

One difference from the JAX module: a probe (or baseline, or confirm)
whose error names `KernelError` or `NoDeviceError` is not a flake but a
card that cannot check, so :class:`ProbePool` raises it
(:func:`raise_device_error`) instead of letting the shrink end quietly
unshrunk.  A resolved checker carries the run's device
(:func:`resolve_checker`): the card, or the CPU when asked.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.backend import DeviceLike, NoDeviceError
from jepsen_tpu_torch.campaign.plan import RunSpec
from jepsen_tpu_torch.campaign.scheduler import Scheduler
from jepsen_tpu_torch.checkers import api as checker_api
from jepsen_tpu_torch.history.ops import History

from jepsen_tpu_torch.minimize.reduce import Unit, build_history
from jepsen_tpu_torch.telemetry import export as tel_export

__all__ = ["resolve_checker", "is_device_checker", "host_equivalent",
           "ProbePool", "device_error", "raise_device_error",
           "DEVICE_ERRORS"]

#: checker name() values whose check() dispatches to the device
#: pipelines — probes of these serialize through DeviceSlots
DEVICE_CHECKER_NAMES = frozenset({
    "list-append", "rw-register", "Linearizable", "QueueChecker",
    "bank", "long-fork", "write-skew", "session",
    "kafka", "total-queue",
})

#: workload-kind (stamped into test maps by the workload bundles) ->
#: (workloads submodule, checker class): the declarative dispatch for
#: stored runs whose checker object didn't survive serialization
_KIND_CHECKERS = {
    "bank": ("bank", "BankChecker"),
    "long-fork": ("long_fork", "LongForkChecker"),
    "write-skew": ("write_skew", "WriteSkewChecker"),
    "session": ("session", "SessionChecker"),
    "kafka": ("..checkers.queue.kafka", "PackedKafkaChecker"),
    "queue": ("..checkers.queue.fifo", "PackedQueueChecker"),
}


#: the error classes that mean the card cannot check: a probe naming one
#: makes the shrink raise (the JAX module counts it as non-reproducing)
DEVICE_ERRORS = ("KernelError", "NoDeviceError")


def _wl_checker(mod: str, cls: str, device: DeviceLike = None):
    import importlib

    # the port's own modules: a stored run never reaches the JAX package
    name = (f"jepsen_tpu_torch.{mod[2:]}" if mod.startswith("..")
            else f"jepsen_tpu_torch.workloads.{mod}")
    m = importlib.import_module(name)
    return getattr(m, cls)(device=device)


def resolve_checker(test: Optional[dict], history: History,
                    device: DeviceLike = None) -> checker_api.Checker:
    """Rebuild a checker for a stored run, on `device`: when None, the
    CPU if the test map says ``"cpu"``, else the card.

    Stored tests persist checker objects only as ``"§obj"``
    placeholders, so re-checking needs a fresh instance.  A live
    checker on the test map wins; then the test's ``workload-kind``
    stamp (the invariants workloads carry one); otherwise the
    history's own shape decides (the same dispatch the workloads
    encode): list-append txns → the elle list-append pipeline,
    rw-register txns → rw-register, read/write/cas registers → knossos
    linearizability, transfer/whole-state-read ops → bank."""
    chk = (test or {}).get("checker")
    if chk is not None and hasattr(chk, "check"):
        return chk
    if device is None and (test or {}).get("cpu"):
        device = "cpu"
    kind = (test or {}).get("workload-kind")
    if kind in _KIND_CHECKERS:
        return _wl_checker(*_KIND_CHECKERS[kind], device)
    # shape scan: distinctive markers (transfer ops, dict-valued
    # snapshot reads, txn mop kinds) decide immediately; bare register
    # reads only RECORD register shape — a bank history whose first
    # client op happens to be a read must still reach its transfer ops
    register_seen = False
    for op in history:
        if not op.is_client_op():
            continue
        if op.f == "transfer":
            return _wl_checker(*_KIND_CHECKERS["bank"], device)
        if op.f == "read" and isinstance(op.value, dict):
            return _wl_checker(*_KIND_CHECKERS["bank"], device)
        if op.f in ("send", "poll", "subscribe", "assign"):
            return _wl_checker(*_KIND_CHECKERS["kafka"], device)
        if op.f in ("enqueue", "dequeue"):
            return _wl_checker(*_KIND_CHECKERS["queue"], device)
        if op.f == "txn" and isinstance(op.value, (list, tuple)):
            for m in op.value:
                if not (isinstance(m, (list, tuple)) and m):
                    continue
                if m[0] == "append":
                    from jepsen_tpu_torch.workloads.append import AppendChecker

                    return AppendChecker(device=device)
                if m[0] == "w":
                    from jepsen_tpu_torch.workloads.wr import WrChecker

                    return WrChecker(device=device)
                if m[0] in ("send", "poll"):
                    return _wl_checker(*_KIND_CHECKERS["kafka"], device)
        if op.f in ("write", "cas"):
            return checker_api.Linearizable(device=device)
        if op.f == "read":
            register_seen = True
    if register_seen:
        return checker_api.Linearizable(device=device)
    raise ValueError(
        "cannot infer a checker from this history's op shapes; "
        "pass one explicitly (shrink(..., checker=...))")


def device_error(result: Any) -> Optional[str]:
    """The first ``error`` string anywhere in a (possibly composed)
    result that names one of `DEVICE_ERRORS`, or None."""
    if not isinstance(result, dict):
        return None
    err = result.get("error")
    if isinstance(err, str) and any(e in err for e in DEVICE_ERRORS):
        return err
    for v in result.values():
        found = device_error(v)
        if found is not None:
            return found
    return None


def raise_device_error(result: Any) -> None:
    """Raise the card's error a result names: `NoDeviceError` for no
    card, `KernelError` for a kernel that did not build or launch."""
    err = device_error(result)
    if err is None:
        return
    if "NoDeviceError" in err:
        raise NoDeviceError(err)
    from jepsen_tpu_torch.ops.kernels import KernelError

    raise KernelError(err)


def is_device_checker(chk: checker_api.Checker) -> bool:
    try:
        return chk.name() in DEVICE_CHECKER_NAMES
    except Exception:  # noqa: BLE001 — a broken name() is not a device
        return False


def host_equivalent(chk: checker_api.Checker
                    ) -> Optional[checker_api.Checker]:
    """A host-side twin for cheap probing, or None.

    Shrink probes are many and SMALL — the opposite of the shape the
    device pipeline is built for (one big history amortizing its host
    padding and launches).  For list-append the exact host oracle is the reference
    the device path is differentially tested against, so probing
    through it cannot change a verdict, only skip the per-candidate
    padding and launches; other checkers have no faster exact twin and
    probe as-is."""
    if _name(chk) == "list-append":
        from jepsen_tpu_torch.checkers.elle import oracle

        models = tuple(getattr(chk, "models", ("serializable",)))
        anomalies = tuple(getattr(chk, "anomalies", ()))

        def fn(test, history, opts):
            return oracle.check(history, models, anomalies,
                                deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(fn, "list-append-host")
    if _name(chk) == "rw-register":
        # the rw host path (use_device=False) IS the oracle the fused
        # device pipeline is differentially tested against — probing
        # through it cannot change a verdict, only skip the device
        # dispatch every small ddmin candidate would otherwise pay
        from jepsen_tpu_torch.checkers.elle import rw_register

        rw_models = tuple(getattr(chk, "models", ("snapshot-isolation",)))
        rw_anoms = tuple(getattr(chk, "anomalies", ()))

        def rw_fn(test, history, opts):
            return rw_register.check(
                history, consistency_models=rw_models,
                anomalies=rw_anoms, use_device=False,
                deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(rw_fn, "rw-register-host")
    if _name(chk) == "bank":
        # the invariants checkers' use_device=False path IS their host
        # oracle twin (same arrays, numpy instead of torch) — probing
        # through it skips the per-candidate device dispatch
        from jepsen_tpu_torch.checkers.invariants import bank as inv_bank

        neg_ok = bool(getattr(chk, "negative_ok", False))

        def bank_fn(test, history, opts):
            return inv_bank.check(history, test, use_device=False,
                                  negative_balances_ok=neg_ok,
                                  deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(bank_fn, "bank-host")
    if _name(chk) in ("long-fork", "write-skew"):
        from jepsen_tpu_torch.checkers.invariants import predicate

        def pred_fn(test, history, opts):
            return predicate.check(history, use_device=False,
                                   deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(pred_fn, _name(chk) + "-host")
    if _name(chk) == "session":
        from jepsen_tpu_torch.checkers.invariants import session as inv_sess

        guarantees = getattr(chk, "guarantees", None)

        def sess_fn(test, history, opts):
            kw = {"guarantees": guarantees} if guarantees else {}
            return inv_sess.check(history, use_device=False,
                                  deadline=(opts or {}).get("deadline"),
                                  **kw)

        return checker_api.FnChecker(sess_fn, "session-host")
    if _name(chk) == "kafka":
        # the packed kafka checker's use_device=False path is the host
        # oracle twin (same packing, numpy reductions) — exact, minus
        # the per-candidate device dispatch
        from jepsen_tpu_torch.checkers.queue import kafka as q_kafka

        def kafka_fn(test, history, opts):
            return q_kafka.check(history, test, use_device=False,
                                 deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(kafka_fn, "kafka-host")
    if _name(chk) == "total-queue":
        from jepsen_tpu_torch.checkers.queue import fifo as q_fifo

        want_fifo = bool(getattr(chk, "fifo", False))

        def tq_fn(test, history, opts):
            return q_fifo.check(history, test, fifo=want_fifo,
                                use_device=False,
                                deadline=(opts or {}).get("deadline"))

        return checker_api.FnChecker(tq_fn, "total-queue-host")
    return None


class ProbePool:
    """Runs batches of candidate sub-histories through the checker.

    One pool per shrink: holds the scheduler configuration (workers,
    device slots, per-probe deadline), the target-anomaly signature,
    and the probe tallies (count, durations) the orchestrator turns
    into per-round telemetry attrs.
    """

    def __init__(self, test: dict, chk: checker_api.Checker, *,
                 target: Sequence[str] = (),
                 probe_deadline_s: Optional[float] = None,
                 workers: int = 2, device_slots: int = 1,
                 device: Optional[bool] = None):
        self.test = test
        self.checker = chk
        self.target = frozenset(target)
        self.probe_deadline_s = probe_deadline_s
        self.workers = max(1, int(workers))
        self.device = is_device_checker(chk) if device is None \
            else bool(device)
        self.slots = max(1, int(device_slots))
        self.n_probes = 0
        self.durations_s: List[float] = []
        self._seq = 0

    # -- verdict interpretation ---------------------------------------------

    def reproduces(self, result: Dict[str, Any]) -> bool:
        """Does a probe result still show the target anomaly?  Invalid
        AND (no target pinned, or anomaly classes overlap).  Unknowns
        (deadline-expired, crashed probes) never count: the shrinker
        may only keep a candidate it POSITIVELY re-confirmed, else the
        witness could stop reproducing."""
        if result.get("valid?") is not False:
            return False
        if not self.target:
            return True
        return bool(self.target & set(result.get("anomaly-types") or ()))

    # -- probing ------------------------------------------------------------

    def check_history(self, h: History, *,
                      bounded: bool = True) -> Dict[str, Any]:
        """One candidate through check_safe: the per-probe Deadline is
        created by check_safe from opts["time-limit"]; the checkers'
        own device_call guards pick it up from there.  `bounded=False`
        skips the per-probe deadline — the baseline re-check of the
        FULL history (which legitimately needs the original run's
        budget) and the final confirm must not be refused by a budget
        sized for small ddmin candidates.  A result whose error names
        `DEVICE_ERRORS` raises (`raise_device_error`)."""
        res = self._check(h, bounded=bounded)
        raise_device_error(res)
        return res

    def _check(self, h: History, *, bounded: bool = True
               ) -> Dict[str, Any]:
        opts: Dict[str, Any] = {}
        if bounded and self.probe_deadline_s is not None:
            opts["time-limit"] = float(self.probe_deadline_s)
        # probes must not re-render per-run artifacts into the store
        # dir on every candidate (blank the store-dir the viz hooks key
        # on), and must NOT replay the run's own fault plan: the
        # anomaly lives in the HISTORY, and a chaos plan's shared call
        # counter advanced by parallel probes would make verdicts
        # scheduling-dependent.  A process-installed/env plan (the
        # degradation-drill idiom) still applies.
        t = {k: v for k, v in self.test.items()
             if k not in ("store-dir", "faults", "faults-plan")}
        return checker_api.check_safe(self.checker, t, h, opts)

    def probe_batch(self, phase: str, candidates: List[List[Unit]]
                    ) -> List[bool]:
        """Probe every candidate of one round in parallel; returns the
        reproduces-flags in candidate order (deterministic regardless
        of scheduling).  `phase` is the reduction phase label (the
        orchestrator wraps this in a per-round telemetry span)."""
        if not candidates:
            return []
        base = self._seq + 1
        self._seq += len(candidates)
        specs = [RunSpec(run_id=f"probe-{base + i}", campaign="minimize",
                         workload="probe", seed=0, device=self.device)
                 for i in range(len(candidates))]
        histories = [build_history(c) for c in candidates]
        results: Dict[str, Dict[str, Any]] = {}

        def execute(rs: RunSpec) -> Dict[str, Any]:
            i = int(rs.run_id.rsplit("-", 1)[1]) - base
            t0 = time.perf_counter()
            res = self._check(histories[i])
            dt = time.perf_counter() - t0
            telemetry.registry().histogram(
                "shrink-probe-duration-s",
                buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
                checker=_name(self.checker)).observe(dt)
            return {"run": rs.run_id, "valid?": res.get("valid?"),
                    "result": res, "wall_s": dt}

        sched = Scheduler(min(self.workers, len(specs)),
                          device_slots=self.slots)
        for rec in sched.run(specs, execute):
            results[rec["run"]] = rec
        for rs in specs:
            # a card that cannot check ends the shrink: never a quiet
            # "does not reproduce" (a crash record carries it as error)
            rec = results.get(rs.run_id) or {}
            raise_device_error(rec.get("result") or rec)
        out: List[bool] = []
        for rs in specs:
            rec = results.get(rs.run_id) or {}
            self.n_probes += 1
            if "wall_s" in rec:
                self.durations_s.append(float(rec["wall_s"]))
            out.append(self.reproduces(rec.get("result") or rec))
        return out

    # -- probe latency aggregates (telemetry attrs) -------------------------

    def latency_quantiles(self) -> Dict[str, float]:
        if not self.durations_s:
            return {}
        s = sorted(self.durations_s)
        return {"probe_p50_s": quantile(s, 0.50),
                "probe_p95_s": quantile(s, 0.95)}


def quantile(sorted_vals: List[float], p: float) -> float:
    """THE quantile rule for probe durations — delegates to the shared
    telemetry formula (`export.quantile`, also behind `trace --top`'s
    p95 column) so the per-round span attrs, the persisted witness
    meta, and the trace tables can never disagree."""
    return round(tel_export.quantile(sorted_vals, p), 4)


def _name(chk: checker_api.Checker) -> str:
    try:
        return chk.name()
    except Exception:  # noqa: BLE001
        return type(chk).__name__
