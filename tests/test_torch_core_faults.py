"""Port parity for the resilience sites of `core_check_exact`
(`jepsen_tpu_torch/checkers/elle/device_core.py`): one guard per grow
try at the caller's site, the deadline polled before each try, and a
`FaultPlan` that fires at the JAX package's sites with the same
injections, call counts and messages.

Tolerance: exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import device_core as jdc  # noqa: E402
from jepsen_tpu.resilience import faults as jfaults  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_core as tdc  # noqa: E402
from jepsen_tpu_torch.resilience import faults as tfaults  # noqa: E402
from test_torch_infer import padded_pair  # noqa: E402


def test_grow_until_exact_polls_deadline_and_guards_each_try():
    # one guard per try at the caller's site, the deadline polled before
    # each try: the JAX signature
    calls = []

    def run(k, r):
        calls.append((k, r))
        return torch.tensor([0] * 12 + [1]), torch.tensor(max(16 - k, 0))

    plan = tfaults.FaultPlan(at={1: "oom"})
    bits, over = tdc.grow_until_exact(run, max_k=8, site="parallel.batch",
                                      plan=plan,
                                      deadline=tres.Deadline(60))
    assert calls == [(8, 64), (16, 64)]       # the faulted try ran again
    assert plan.injected == [(1, "parallel.batch", "oom")]
    with pytest.raises(tres.DeadlineExceeded, match="grow-until-exact"):
        tdc.grow_until_exact(run, deadline=tres.Deadline(0))


@pytest.mark.parametrize("spec", [
    dict(at={0: "oom"}),                      # first try, retried
    dict(at={1: "xla"}),                      # the grown try, retried
    dict(persistent=["elle.core-check"], kinds=["device-lost"]),
    dict(p=1.0, sites=["elle.infer"]),        # another site: never fires
], ids=["first-try", "grown-try", "persistent", "other-site"])
def test_core_check_exact_fault_plan_fires_at_jax_sites(spec):
    # max_k = 8 overflows on the stale reads, so the grow loop tries
    # twice; each try is one call of the plan in both packages
    hj, ht, n_keys = padded_pair("stale-reads")
    jplan, tplan = jfaults.FaultPlan(**spec), tfaults.FaultPlan(**spec)
    want = got = None
    with jfaults.use(jplan):
        try:
            want = np.asarray(jdc.core_check_exact(hj, n_keys,
                                                   max_k=8)[0]).tolist()
        except jfaults.FaultInjected as e:
            want = str(e)
    with tfaults.use(tplan):
        try:
            got = tdc.core_check_exact(ht, n_keys, max_k=8,
                                       device="cpu")[0].tolist()
        except tfaults.FaultInjected as e:
            got = str(e)
    assert got == want
    assert tplan.injected == jplan.injected
    assert tplan._n_calls == jplan._n_calls
    if "persistent" in spec:
        assert "site=elle.core-check call=0" in got
