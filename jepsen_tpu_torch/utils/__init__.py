from jepsen_tpu_torch.utils.core import (
    fcatch,
    majority,
    minority,
    nemesis_intervals,
    rand_distribution,
    relative_time_nanos,
    timeout,
    with_retry,
)

__all__ = [
    "fcatch",
    "majority",
    "minority",
    "nemesis_intervals",
    "rand_distribution",
    "relative_time_nanos",
    "timeout",
    "with_retry",
]
