"""Clock-offset plot (the port's copy of `jepsen_tpu/checkers/clock.py`).

Equivalent of the reference's `jepsen/src/jepsen/checker/clock.clj`
(SURVEY.md §2.1): plots the per-node clock offsets sampled by the clock
nemesis (ops with ``f == "check-clock-offsets"`` whose value is
``{node: offset_ms}``, as the JAX package's `nemesis/time.py` samples
them) so clock-skew faults are visible alongside the perf graphs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..history.ops import INVOKE
from .api import Checker, output_path

_NS = 1e9


def offset_series(history) -> Dict[Any, List]:
    """node -> [(t_seconds, offset_ms), ...] from nemesis samples."""
    series: Dict[Any, List] = {}
    for op in history:
        if op.type == INVOKE or op.f != "check-clock-offsets":
            continue
        if not isinstance(op.value, dict):
            continue
        t = op.time / _NS
        for node, off in op.value.items():
            if off is None:
                continue
            series.setdefault(node, []).append((t, float(off)))
    return series


class ClockPlot(Checker):
    """Writes clock.png; always valid (reference `clock-plot`)."""

    def __init__(self, filename: str = "clock.png"):
        self.filename = filename

    def check(self, test, history, opts=None):
        series = offset_series(history)
        if not series:
            return {"valid?": True, "nodes": 0}
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 4))
        for node, pts in sorted(series.items(), key=lambda kv: repr(kv[0])):
            t = [p[0] for p in pts]
            off = [p[1] for p in pts]
            ax.plot(t, off, marker="o", ms=3, lw=1, label=str(node))
        ax.axhline(0, color="#888", lw=0.8)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("clock offset (ms)")
        ax.set_title(f'{test.get("name", "test")} clock offsets')
        ax.legend(fontsize=7)
        path = output_path(test, opts, self.filename)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return {"valid?": True, "nodes": len(series), "file": path}


def clock_plot(**kw) -> ClockPlot:
    return ClockPlot(**kw)
