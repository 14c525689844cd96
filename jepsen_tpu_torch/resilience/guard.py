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

Retries and fallbacks are logged on the ``jepsen.resilience`` logger.
The JAX package's telemetry counters, span annotations and compile-cost
stamps are not carried over (the port has no telemetry module yet).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Tuple

from jepsen_tpu_torch.resilience import faults as faults_mod
from jepsen_tpu_torch.resilience.policy import (
    DEFAULT_POLICY,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
)

logger = logging.getLogger("jepsen.resilience")

__all__ = ["device_call", "degrade_to_host", "with_fallback",
           "DEGRADED_HOST"]

DEGRADED_HOST = "host-fallback"


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
            return fn(*args, **kw)
        except DeadlineExceeded:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if not policy.classify(e):
                raise
            delay = next(delays, None)
            if delay is None:  # attempts exhausted: the original error
                raise
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
    through: log the fallback, poll the deadline (an expired budget must
    NOT be converted into a possibly much slower host run — expiry
    raises :class:`DeadlineExceeded`), run the host oracle, and stamp
    dict results with ``"degraded": "host-fallback"`` plus the device
    error."""
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
