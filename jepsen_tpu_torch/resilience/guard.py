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

Retries and fallbacks are logged on the ``jepsen.resilience`` logger.
The JAX package's telemetry counters, span annotations and compile-cost
stamps are not carried over (the port has no telemetry module yet), nor
is its `with_fallback`, whose callers (the invariant and queue checkers)
the port does not have yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from jepsen_tpu_torch.resilience import faults as faults_mod
from jepsen_tpu_torch.resilience.policy import (
    DEFAULT_POLICY,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
)

logger = logging.getLogger("jepsen.resilience")

__all__ = ["device_call", "degrade_to_host", "DEGRADED_HOST"]

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
