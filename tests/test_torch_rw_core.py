"""Port parity for the rw-register core (`jepsen_tpu_torch/checkers/elle/
device_rw.py`): every `infer_rw` array bit for bit (dtype and shape
too), `rw_core_check`'s `(bits, overflowed, rw_overflow)` also under a
tiny `rw_cap` and `max_k=1` and one round, and `device_rw.check`'s dict
and grow loop, on the corpora of `test_torch_rw_register.py`, which
holds the checker API's cases.

Tolerance: exactly equal.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from jepsen_tpu.checkers.elle import device_infer as jdi  # noqa: E402
from jepsen_tpu.checkers.elle import device_rw as jdrw  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_infer as tdi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import device_rw as tdrw  # noqa: E402
from jepsen_tpu_torch.history.soa import packed_from_arrays  # noqa: E402
from test_torch_rw_register import concurrent, packed  # noqa: E402

INFER_CASES = ["g1c-wr-cycle", "write-skew", "g1a", "internal",
               "lost-update", "duplicate-writes", "aborted-duplicate",
               "g1b", "cyclic-versions", "synth-fail-info", "packed-seed0",
               "packed-stale"]


def leaves(a, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from leaves(a[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        for i, x in enumerate(a):
            yield from leaves(x, f"{path}[{i}]")
    else:
        yield path, a


@pytest.mark.parametrize("name", INFER_CASES)
@pytest.mark.parametrize("rw_cap", [0, 4], ids=["cap-M", "cap-4"])
def test_infer_rw_equal_to_jax(name, rw_cap):
    p, tp = packed(name)
    want = dict(leaves(jdrw.infer_rw(jdi.pad_packed(p), p.n_keys,
                                     rw_cap=rw_cap)))
    got = dict(leaves(tdrw.infer_rw(tdi.pad_packed(tp, device="cpu"),
                                    tp.n_keys, rw_cap=rw_cap)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        a, b = np.asarray(a), got[path].numpy()
        assert (b.dtype, b.shape) == (a.dtype, a.shape), path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", INFER_CASES)
@pytest.mark.parametrize("budget", [dict(), dict(rw_cap=1, max_k=1),
                                    dict(max_rounds=1)],
                         ids=["default", "rw_cap1-max_k1", "rounds1"])
def test_rw_core_check_equal_to_jax(name, budget):
    p, tp = packed(name)
    want = jdrw.rw_core_check(jdi.pad_packed(p), p.n_keys, **budget)
    got = tdrw.rw_core_check(tdi.pad_packed(tp, device="cpu"), tp.n_keys,
                             device="cpu", **budget)
    assert [t.tolist() for t in got] == \
        [np.asarray(a).tolist() for a in want]


@pytest.mark.parametrize("name", INFER_CASES)
def test_device_rw_check_equal_to_jax(name):
    p, tp = packed(name)
    # a tiny first budget: the grow loop must take the same steps
    kw = dict(max_k=1, max_rounds=1)
    want = jdrw.check(p, **kw)
    got = tdrw.check(tp, device="cpu", **kw)
    assert got == want
    assert got["exact"] is True


def test_device_rw_check_grows_rw_cap(monkeypatch):
    # 40 nil reads and 40 blind writes of one key: 1,600 rw edges against
    # a first rw_cap of M = 128 slots, so the grow loop must double it
    h = concurrent(*([([["r", "x", None]], [["r", "x", None]])] * 40
                     + [([["w", "x", i]], [["w", "x", i]])
                        for i in range(40)]))
    p = jpack(h, "rw-register")
    tp = packed_from_arrays(p)
    caps = []
    real = tdrw.rw_core_check

    def spy(h, n_keys, max_k, max_rounds, rw_cap, device=None):
        caps.append(rw_cap)
        return real(h, n_keys, max_k, max_rounds, rw_cap, device=device)

    monkeypatch.setattr(tdrw, "rw_core_check", spy)
    got = tdrw.check(tp, device="cpu")
    assert got == jdrw.check(p)
    assert got["exact"] is True and got["valid?"] is True
    assert caps == [128, 2048]
