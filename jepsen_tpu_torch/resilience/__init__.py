"""Resilience layer (the port's copy of `jepsen_tpu/resilience`): the
checking pipeline survives faults in *itself* — device OOM, synthetic
faults, pathological histories — and always terminates with an
attributable verdict.

- :mod:`~.policy` — :class:`RetryPolicy` (seeded backoff + the PyTorch
  transient classifier) and the cooperative :class:`Deadline`, whose
  expiry becomes ``{"valid?": "unknown", "error": "deadline-exceeded"}``;
- :mod:`~.faults` — the deterministic seeded :class:`FaultPlan`, the
  resilience layer's own test harness (given as ``plan=``, installed
  with :class:`use`, or resolved for a run by :func:`plan_for` from the
  test map or ``JEPSEN_FAULTS``);
- :mod:`~.guard` — :func:`device_call`, the seam wrapper that retries
  transients, :func:`degrade_to_host`, the tail that runs the host
  oracle with a ``"degraded": "host-fallback"`` stamp, and
  :func:`with_fallback`, the two joined (only a synthetic fault
  degrades).
"""

from jepsen_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    active_plan,
    clear,
    install,
    parse_spec,
    plan_for,
    seeded_for,
    use,
)
from jepsen_tpu_torch.resilience.guard import (
    DEGRADED_HOST,
    degrade_to_host,
    device_call,
    env_anomaly,
    with_fallback,
)
from jepsen_tpu_torch.resilience.policy import (
    DEADLINE_ERROR,
    DEFAULT_POLICY,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    deadline_result,
    is_transient,
    is_transient_http,
)

__all__ = [
    "Deadline", "DeadlineExceeded", "RetryPolicy", "is_transient",
    "is_transient_http", "env_anomaly",
    "DEADLINE_ERROR", "DEFAULT_POLICY", "deadline_result",
    "FaultPlan", "FaultInjected", "use", "install", "clear", "active_plan",
    "parse_spec", "seeded_for", "plan_for",
    "device_call", "degrade_to_host", "with_fallback",
    "DEGRADED_HOST",
]
