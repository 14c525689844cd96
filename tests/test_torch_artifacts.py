"""Port parity for the post-run artifacts: the perf, timeline and clock
checkers (`jepsen_tpu_torch/checkers/perf.py`, `timeline.py`,
`clock.py`), the Knossos failure SVG (`checkers/knossos/report.py`) and
the text reports (`report.py`).

The same seeded histories go through the JAX package's module and the
port's: point series and nemesis intervals must be equal array for
array, checker dicts equal (file paths aside, which name each package's
store dir), `timeline.html` and the SVG byte for byte, and the reports
line for line.  The plots are made where matplotlib is present and
skipped, with the same dict in both packages, where it is not.  The spec
is `tests/test_perf_checkers.py` and `tests/test_linear.py`.
"""

import dataclasses
import os
import random
import sys

import numpy as np
import pytest

from jepsen_tpu import report as jreport
from jepsen_tpu.checkers import clock as jclock
from jepsen_tpu.checkers import perf as jperf
from jepsen_tpu.checkers import timeline as jtimeline
from jepsen_tpu.checkers.knossos import linear as jlinear
from jepsen_tpu.checkers.knossos import report as jkreport
from jepsen_tpu.checkers.knossos import wgl as jwgl
from jepsen_tpu.history import ops as jops
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu.models import register as jregister
from jepsen_tpu_torch import report as treport
from jepsen_tpu_torch.checkers import clock as tclock
from jepsen_tpu_torch.checkers import perf as tperf
from jepsen_tpu_torch.checkers import timeline as ttimeline
from jepsen_tpu_torch.checkers.knossos import linear as tlinear
from jepsen_tpu_torch.checkers.knossos import report as tkreport
from jepsen_tpu_torch.checkers.knossos import wgl as twgl
from jepsen_tpu_torch.history import ops as tops
from jepsen_tpu_torch.models import cas_register as tcas
from jepsen_tpu_torch.models import register as tregister

S = 1_000_000_000  # ns


def carry(h):
    return tops.history([dataclasses.asdict(op) for op in h])


def perf_history(seed: int, n: int = 400, with_nemesis: bool = True):
    """A JAX history of `n` client ops from four processes, reads and
    writes with seeded latencies and outcomes, and partition, kill and
    clock-offset nemesis ops among them."""
    rng = random.Random(seed)
    ops, t, free = [], 0, [0] * 4
    for i in range(n // 2):
        t += rng.randrange(1, 50_000_000)
        p = rng.randrange(4)
        start = max(t, free[p])
        f = rng.choice(["read", "write"])
        ops.append(jops.Op(type="invoke", process=p, f=f, value=i,
                           time=start))
        typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
        free[p] = start + rng.randrange(1, 200_000_000)
        ops.append(jops.Op(type=typ, process=p, f=f, value=i,
                           time=free[p]))
        free[p] += 1
    if with_nemesis:
        span = max(t, 1)
        for k, f in enumerate(["start-partition", "stop-partition", "kill",
                               "start", "kill"]):
            at = span * (k + 1) // 6
            ops.append(jops.Op(type="invoke", process="nemesis", f=f,
                               time=at))
            ops.append(jops.Op(type="info", process="nemesis", f=f,
                               time=at + 1000))
        for k in range(3):
            ops.append(jops.Op(
                type="info", process="nemesis", f="check-clock-offsets",
                value={"n1": float(k * 10), "n2": -5.0 + k,
                       "n3": None if k == 1 else 2.5},
                time=span * k // 3))
    ops.sort(key=lambda o: o.time)
    return jops.history(ops)


def same_arrays(want, got):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_arrays(want[k], got[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(want, got):
            same_arrays(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def without_file(r):
    return {k: v for k, v in r.items() if k != "file"}


@pytest.mark.parametrize("seed", range(3))
def test_points_and_intervals_equal_to_jax(seed):
    h = perf_history(seed)
    th = carry(h)
    same_arrays(jperf.latency_points(h), tperf.latency_points(th))
    for dt in (0.5, 1.0):
        same_arrays(jperf.rate_points(h, dt=dt), tperf.rate_points(th, dt=dt))
    same_arrays(jperf.nemesis_intervals(h), tperf.nemesis_intervals(th))
    test = {"plot": {"nemeses": [{"name": "kill", "start": {"kill"},
                                  "stop": {"start"}}]}}
    same_arrays(jperf.nemesis_intervals(h, test),
                tperf.nemesis_intervals(th, test))
    same_arrays(jperf._perf_specs(test), tperf._perf_specs(test))
    assert jclock.offset_series(h) == tclock.offset_series(th)


@pytest.mark.parametrize("spec", [
    [(1, "kill"), (2, "start"), (3, "kill"), (4, "start")],
    [(1, "start"), (2, "stop"), (3, "start"), (4, "stop")],
    [(1, "start"), (3, "stop")],
    [(1, "kill")],
    [(1, "kill"), (2, "start"), (4, "kill")],
])
def test_nemesis_interval_rules_equal_to_jax(spec):
    ops = []
    for (t, f) in spec:
        ops.append(jops.Op(type="invoke", process="nemesis", f=f, time=t * S))
        ops.append(jops.Op(type="info", process="nemesis", f=f,
                           time=t * S + 1000))
    ops.append(jops.Op(type="invoke", process=0, f="read", time=6 * S))
    ops.append(jops.Op(type="ok", process=0, f="read", value=1,
                       time=6 * S + 1000))
    h = jops.history(ops)
    assert jperf.nemesis_intervals(h) == tperf.nemesis_intervals(carry(h))


@pytest.mark.parametrize("plots", [True, False], ids=["plots", "no-mpl"])
def test_perf_checkers_equal_to_jax(plots, tmp_path, monkeypatch):
    if not plots:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    h = perf_history(5)
    for mod, hh, store in ((jperf, h, "j"), (tperf, carry(h), "t")):
        test = {"name": "perfy", "store-dir": str(tmp_path / store),
                "start-time": 1_700_000_000.0}
        res = [mod.LatencyGraph().check(test, hh),
               mod.RateGraph().check(test, hh),
               mod.perf().check(test, hh)]
        if mod is jperf:
            want = res
        else:
            got = res
    for w, g in zip(want[:2], got[:2]):
        assert without_file(g) == without_file(w)
        assert ("file" in g) == ("file" in w)
        if "file" in w:
            assert os.path.basename(g["file"]) == \
                os.path.basename(w["file"])
            assert os.path.getsize(g["file"]) > 1000
    assert {k: without_file(v) if isinstance(v, dict) else v
            for k, v in got[2].items()} == \
        {k: without_file(v) if isinstance(v, dict) else v
         for k, v in want[2].items()}
    if not plots:
        assert got[0]["plot"] == "skipped (no matplotlib)"


def test_empty_history_graphs_equal_to_jax():
    for cls in ("LatencyGraph", "RateGraph"):
        want = getattr(jperf, cls)().check({"name": "e"}, jops.history([]))
        got = getattr(tperf, cls)().check({"name": "e"}, tops.history([]))
        assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_timeline_html_byte_equal_to_jax(seed, tmp_path):
    h = perf_history(seed, n=120)
    h = jops.history(list(h) + [jops.invoke(9, "read", None)])  # unpaired
    out = []
    for mod, hh, store in ((jtimeline, h, "j"),
                           (ttimeline, carry(h), "t")):
        test = {"name": "tl", "store-dir": str(tmp_path / store),
                "start-time": 1_700_000_000.0}
        r = mod.html_timeline().check(test, hh)
        with open(r["file"], "rb") as f:
            out.append((without_file(r), f.read()))
    assert out[1] == out[0]
    assert out[0][0]["valid?"] is True
    assert b"timeline" in out[0][1]


def test_clock_plot_equal_to_jax(tmp_path):
    h = perf_history(2)
    got = []
    for mod, hh, store in ((jclock, h, "j"), (tclock, carry(h), "t")):
        test = {"name": "ck", "store-dir": str(tmp_path / store),
                "start-time": 1_700_000_000.0}
        got.append(without_file(mod.ClockPlot().check(test, hh)))
    assert got[1] == got[0] and got[0]["nodes"] == 3


def knossos_cases():
    return {
        "linear": (lambda m: [m.invoke(0, "write", 1), m.ok(0, "write", 1),
                              m.invoke(1, "write", 2), m.ok(1, "write", 2),
                              m.invoke(0, "read", None),
                              m.ok(0, "read", 7)], "linear"),
        "wgl": (lambda m: [m.invoke(0, "write", 1), m.ok(0, "write", 1),
                           m.invoke(0, "read", None),
                           m.ok(0, "read", 9)], "wgl"),
        "cas": (lambda m: [m.invoke(0, "write", 1), m.invoke(1, "cas",
                                                             [2, 3]),
                           m.ok(0, "write", 1), m.invoke(2, "read", None),
                           m.ok(1, "cas", [2, 3]), m.ok(2, "read", 3)],
                "linear"),
    }


@pytest.mark.parametrize("case", list(knossos_cases()))
def test_knossos_svg_byte_equal_to_jax(case, tmp_path, monkeypatch):
    build, algo = knossos_cases()[case]
    monkeypatch.setenv("JT_NO_NATIVE", "1")
    svgs = []
    for ops, mods, model in (
            (jops, (jlinear, jwgl, jkreport), jcas if case == "cas"
             else jregister),
            (tops, (tlinear, twgl, tkreport), tcas if case == "cas"
             else tregister)):
        h = ops.history(build(ops))
        check = mods[0].check if algo == "linear" else mods[1].check
        res = check(h, model())
        assert res["valid?"] is False
        path = str(tmp_path / f"{ops.__name__}.svg")
        out = mods[2].render_analysis(h, res, path)
        svgs.append(None if out is None else open(out, "rb").read())
    assert svgs[1] == svgs[0]
    if case == "linear":
        assert svgs[0].startswith(b"<svg") and b"non-linearizable" in svgs[0]


def test_knossos_window_ops_equal_to_jax():
    h = perf_history(1, n=80, with_nemesis=False)
    for center in (0, 17, 79):
        want, lo, hi = jkreport._window_ops(h, center, radius=10)
        got, tlo, thi = tkreport._window_ops(carry(h), center, radius=10)
        assert (tlo, thi) == (lo, hi)
        assert [(dataclasses.asdict(a), dataclasses.asdict(b) if b else None)
                for a, b in got] == \
            [(dataclasses.asdict(a), dataclasses.asdict(b) if b else None)
             for a, b in want]


def test_report_render_equal_to_jax(capsys):
    test = {"name": "demo-append", "history": list(range(12)),
            "results": {"valid?": False, "anomaly-types": ["G1c"],
                        "anomalies": {"G1c": [{"cycle": list(range(20))}]},
                        "stats": {"count": 12, "by-f": {"txn": {"ok": 9}}}}}
    for t in (test, {"name": "t", "results": {"valid?": True}},
              {"results": {"valid?": "unknown", "error": "x"}}):
        assert treport.render(t) == jreport.render(t)
    treport.print_report(test)
    jreport.print_report(test)
    out = capsys.readouterr().out.split("\n")
    half = len(out) // 2
    assert out[:half] == out[half:2 * half]


def test_report_render_campaign_equal_to_jax():
    summary = {
        "campaign": "c1", "total": 5, "pending": 1, "index": "idx.jsonl",
        "counts": {"true": 3, "false": 1, "unknown": 1, "degraded": 1,
                   "deadline": 1},
        "executed": 4, "skipped": 1, "wall_s": 12.5, "seeds": [0, 1],
        "rows": [
            {"workload": "append", "fault": "none", "seed": 0,
             "valid?": True},
            {"workload": "append", "fault": "kill", "seed": 1,
             "valid?": False, "degraded": True},
            {"workload": "wr", "fault": "none", "seed": 0,
             "valid?": "unknown", "deadline": True},
        ],
        "span-stats": {"elle.check": {"count": 3, "p50": 0.1, "p95": 0.2,
                                      "max": 0.25}},
        "regressions": [{"key": "append/kill/1", "from": True,
                         "to": False, "when": "g2"}],
    }
    assert treport.render_campaign(summary) == \
        jreport.render_campaign(summary)
    empty = {"campaign": "c0"}
    assert treport.render_campaign(empty) == jreport.render_campaign(empty)
