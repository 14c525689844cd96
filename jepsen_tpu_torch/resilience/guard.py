"""The device-call guard: retry transients, degrade to host (the port's
copy of `jepsen_tpu/resilience/guard.py`).

One entry point, :func:`device_call`, wraps every device seam of a
checker (elle infer, the cycle sweeps):

1. polls the cooperative :class:`~.policy.Deadline` before each attempt;
2. consults the active :class:`~.faults.FaultPlan` (chaos mode / test
   harness) — the plan may raise a synthetic device fault here;
3. retries transient failures (`policy.is_transient`) per
   :class:`~.policy.RetryPolicy` with seeded backoff;
4. re-raises once the policy is exhausted (or the failure is
   non-transient); the caller decides whether to degrade to its host
   oracle via :func:`degrade_to_host`, stamping ``"degraded":
   "host-fallback"``.

:func:`with_fallback` joins the two for the invariants checkers (bank,
predicate, session).  Its rule is the port's, not the JAX package's: only
a synthetic :class:`~.faults.FaultInjected` of a fault plan degrades to
the host oracle; every other error of the device path (a kernel or CUDA
error, no card) is raised, where the JAX package degrades any exception.

Every retry/fallback increments a telemetry counter, streams an event
and annotates the innermost open span, so a degraded run is diagnosable
straight from ``telemetry.json``.  With telemetry on, each attempt is
timed by :func:`_stamp_device_time`: a call whose arguments or result
hold a CUDA tensor is timed on the card, with a pair of
``torch.cuda.Event`` records on the current stream around it (the JAX
package blocks on the result and reads the host clock); any other call
gets the host's wall clock, as in the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from jepsen_tpu_torch.resilience import faults as faults_mod
from jepsen_tpu_torch.resilience.policy import (
    DEFAULT_POLICY,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
)

logger = logging.getLogger("jepsen.resilience")

__all__ = ["device_call", "degrade_to_host", "with_fallback",
           "env_anomaly", "DEGRADED_HOST", "compile_cache_stats",
           "reset_compile_cache_stats"]

DEGRADED_HOST = "host-fallback"


def _registry():
    from jepsen_tpu_torch import telemetry

    return telemetry.registry()


def _stream_event(ev: str, **fields: Any) -> None:
    from jepsen_tpu_torch import telemetry

    telemetry.stream_event(ev, **fields)


def env_anomaly(site: str, kind: str = "anomaly", **fields: Any) -> None:
    """Record an ENVIRONMENT anomaly — a card that had to be re-dialled,
    a flapping transport, a degraded accelerator — as a structured
    resilience signal instead of a free-text field.  Bumps the
    ``resilience-env-anomalies`` counter (in telemetry snapshots) and
    streams an ``env-anomaly`` event (visible to ``tail`` and counted by
    ``replay()``).  Never raises."""
    try:
        _registry().counter("resilience-env-anomalies", site=site,
                            kind=kind).inc()
        _stream_event("env-anomaly", site=site, kind=kind, **fields)
    except Exception:  # noqa: BLE001 — observability must not fail work
        logger.debug("env_anomaly(%s) failed", site, exc_info=True)


def _annotate(**attrs: Any) -> None:
    from jepsen_tpu_torch import telemetry

    sp = telemetry.current()
    if sp is not None:
        sp.set_attr(**attrs)


# ---------------------------------------------------------------------------
# First-call accounting per (site, shape class).  The JAX package books the
# first call of each shape class as ``compile_s`` (jax.jit compiles per
# shape); the port compiles nothing per shape (its kernels are built once,
# keyed by a source digest), but keeps the same books so both packages'
# spans carry the same keys: ``compile_s`` is the first call's time,
# ``execute_s`` every later call's, ``jit-cache-entries`` the shape
# classes seen.
# ---------------------------------------------------------------------------

_compile_lock = threading.Lock()
_seen_shapes: set = set()
_compile_misses = 0


def _dtype_name(dt: Any) -> str:
    # torch.int32 and numpy's int32 label alike
    return str(dt).replace("torch.", "") if dt is not None else ""


def _shape_key(args: tuple, kw: dict) -> Tuple:
    """The call's shape-class key: (shape, dtype) of every array-like
    leaf one or two levels down."""
    parts = []

    def add(v: Any, depth: int) -> None:
        shape = getattr(v, "shape", None)
        if shape is not None:
            parts.append((str(tuple(shape)),
                          _dtype_name(getattr(v, "dtype", None))))
        elif depth < 2 and isinstance(v, (list, tuple)):
            for x in v[:8]:
                add(x, depth + 1)

    for a in args:
        add(a, 0)
    for v in kw.values():
        add(v, 0)
    return tuple(parts)


def compile_cache_stats() -> Dict[str, int]:
    """Process-wide shape-class stats: distinct (site, shape) classes
    seen and total first sightings."""
    with _compile_lock:
        return {"entries": len(_seen_shapes),
                "misses": _compile_misses}


def reset_compile_cache_stats() -> None:
    """Tests only."""
    global _compile_misses
    with _compile_lock:
        _seen_shapes.clear()
        _compile_misses = 0


def _peek_shape(site: str, args: tuple, kw: dict) -> Optional[Tuple]:
    """This call's shape-class key — WITHOUT recording it: the commit
    happens only after the attempt succeeds (:func:`_commit_shape`), so
    a transient failure leaves the shape unseen for the retry."""
    try:
        return (site,) + _shape_key(args, kw)
    except Exception:  # noqa: BLE001 — exotic args must not fail a call
        return None


def _commit_shape(key: Optional[Tuple]) -> bool:
    """Record a successfully-executed shape class; True if this commit
    was its first."""
    global _compile_misses
    if key is None:
        return False
    with _compile_lock:
        if key in _seen_shapes:
            return False
        _seen_shapes.add(key)
        _compile_misses += 1
        return True


def _shape_label(shape_key: Optional[Tuple]) -> str:
    """A compact label for a call's shape class; scalars-only calls
    label as ``scalar``."""
    if not shape_key or len(shape_key) < 2:
        return "scalar"
    return "+".join(f"{s}:{d}" if d else s for s, d in shape_key[1:])


def _holds_cuda(v: Any, depth: int = 0) -> bool:
    """Does `v` hold a CUDA tensor — itself, or one or two levels down
    in a sequence, mapping or object's fields?"""
    if isinstance(v, torch.Tensor):
        return v.is_cuda
    if depth >= 2:
        return False
    if isinstance(v, dict):
        items = list(v.values())
    elif isinstance(v, (list, tuple)):
        items = list(v)
    else:
        fields = getattr(v, "__dict__", None)
        if fields is None:
            fields = {k: getattr(v, k) for k in getattr(v, "__slots__", ())
                      if hasattr(v, k)}
        items = list(fields.values()) if isinstance(fields, dict) else []
    return any(_holds_cuda(x, depth + 1) for x in items[:64])


def _stamp_device_time(site: str, fn: Callable, args: tuple,
                       kw: dict) -> Any:
    """Run one device attempt, stamping its device time onto the
    enclosing telemetry span as ``device_time_ns`` (summed across calls
    under that span).  With CUDA initialized in this process the attempt
    is bracketed by two ``torch.cuda.Event(enable_timing=True)`` records
    on the current stream, and the end event is synchronized: a call
    whose arguments or result hold a CUDA tensor books the events'
    elapsed time, any other call the host's wall clock.
    ``device_dispatch_s`` is the host time until the call returned
    (enqueue), before the synchronization.  Only reached when telemetry
    is enabled; a device failure surfacing at the synchronization
    propagates to the caller's retry classifier."""
    from jepsen_tpu_torch import telemetry

    shape_key = _peek_shape(site, args, kw)
    events = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter_ns()
    out = fn(*args, **kw)
    disp = time.perf_counter_ns() - t0
    dt = None
    if events is not None:
        events[1].record()
        events[1].synchronize()
        if _holds_cuda(out) or _holds_cuda(args) or _holds_cuda(kw):
            dt = int(events[0].elapsed_time(events[1]) * 1e6)
    if dt is None:
        dt = time.perf_counter_ns() - t0
    first = _commit_shape(shape_key)
    sp = telemetry.current()
    if sp is not None and sp.attrs is not None:
        try:
            sp.attrs["device_time_ns"] = \
                int(sp.attrs.get("device_time_ns", 0)) + dt
            k = "compile_s" if first else "execute_s"
            sp.attrs[k] = float(sp.attrs.get(k, 0.0)) + dt / 1e9
            sp.attrs["device_dispatch_s"] = float(
                sp.attrs.get("device_dispatch_s", 0.0)) + disp / 1e9
            prof = sp.attrs.get("profile")
            if not isinstance(prof, dict):
                prof = sp.attrs["profile"] = {}
            cell = prof.setdefault(
                f"{site}|{_shape_label(shape_key)}",
                {"calls": 0, "compile_s": 0.0, "execute_s": 0.0,
                 "device_dispatch_s": 0.0})
            cell["calls"] += 1
            cell[k] = float(cell.get(k, 0.0)) + dt / 1e9
            cell["device_dispatch_s"] = float(
                cell.get("device_dispatch_s", 0.0)) + disp / 1e9
        except Exception:  # noqa: BLE001 — noop-span attrs are shared
            pass
    reg = telemetry.registry()
    reg.counter("device-time-ns", site=site).inc(dt)
    if first:
        reg.counter("compile-cache-miss", site=site).inc()
    with _compile_lock:
        n = len(_seen_shapes)
    reg.gauge("jit-cache-entries").set(n)
    return out


def device_call(site: str, fn: Callable, *args: Any,
                policy: Optional[RetryPolicy] = None,
                deadline: Optional[Deadline] = None,
                plan: Optional[faults_mod.FaultPlan] = None,
                **kw: Any) -> Any:
    """Run a device entry point under the resilience policy.

    `site` names the seam for fault targeting and logs (e.g.
    ``"elle.infer"``).  `plan` defaults to the installed plan
    (`faults.active_plan()`, none unless a caller installed one).
    Raises the last error when retries are exhausted or the failure is
    non-transient; :class:`DeadlineExceeded` always propagates
    immediately.
    """
    policy = policy or DEFAULT_POLICY
    if plan is None:
        plan = faults_mod.active_plan()
    delays = policy.delays()
    attempt = 0
    while True:
        if deadline is not None:
            deadline.check(site)
        attempt += 1
        try:
            if plan is not None:
                plan.fire(site)
            from jepsen_tpu_torch import telemetry

            if telemetry.enabled():
                return _stamp_device_time(site, fn, args, kw)
            return fn(*args, **kw)
        except DeadlineExceeded:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if not policy.classify(e):
                raise
            delay = next(delays, None)
            if delay is None:  # attempts exhausted: the original error
                _annotate(retries=attempt - 1, retry_exhausted=True)
                raise
            _registry().counter("resilience-retries", site=site,
                                kind=type(e).__name__).inc()
            _stream_event("retry", site=site, attempt=attempt,
                          kind=type(e).__name__)
            _annotate(retries=attempt)
            logger.warning("transient device failure at %s (attempt "
                           "%d/%d), retrying in %.3fs: %s", site, attempt,
                           policy.max_attempts, delay, e)
            if deadline is not None:
                delay = deadline.bound_sleep(delay)
            if delay > 0:
                time.sleep(delay)


def degrade_to_host(site: str, host_fn: Callable[[], Any],
                    exc: BaseException, *,
                    deadline: Optional[Deadline] = None) -> Any:
    """The shared degradation tail every device->host fallback goes
    through: count the fallback, annotate the open span, poll the deadline (an expired budget must
    NOT be converted into a possibly much slower host run — expiry
    raises :class:`DeadlineExceeded`), run the host oracle, and stamp
    dict results with ``"degraded": "host-fallback"`` plus the device
    error."""
    _registry().counter("resilience-fallbacks", site=site).inc()
    _stream_event("fallback", site=site, error=type(exc).__name__)
    _annotate(degraded=DEGRADED_HOST, device_error=type(exc).__name__)
    logger.warning("persistent device failure at %s; degrading to "
                   "host oracle: %s", site, exc)
    if deadline is not None:
        deadline.check(site)
    res = host_fn()
    if isinstance(res, dict):
        res["degraded"] = DEGRADED_HOST
        res["device-error"] = f"{type(exc).__name__}: {exc}"
    return res


def with_fallback(site: str, device_fn: Callable[[], Any],
                  host_fn: Callable[[], Any], *,
                  policy: Optional[RetryPolicy] = None,
                  deadline: Optional[Deadline] = None,
                  plan: Optional[faults_mod.FaultPlan] = None
                  ) -> Tuple[Any, Optional[str]]:
    """Run `device_fn` under :func:`device_call`; when a synthetic
    :class:`~.faults.FaultInjected` outlives its retries, run `host_fn`
    via :func:`degrade_to_host`.  Returns ``(result, degraded)`` where
    `degraded` is None on the device path and :data:`DEGRADED_HOST` after
    the oracle fallback (dict results also carry the stamp).  Every other
    error, and :class:`DeadlineExceeded`, is raised."""
    try:
        return device_call(site, device_fn, policy=policy,
                           deadline=deadline, plan=plan), None
    except faults_mod.FaultInjected as e:  # the degradation drill
        return degrade_to_host(site, host_fn, e,
                               deadline=deadline), DEGRADED_HOST
