"""HTML timeline of operations per process (the port's copy of
`jepsen_tpu/checkers/timeline.py`, byte for byte the same HTML).

Equivalent of the reference's `jepsen/src/jepsen/checker/timeline.clj`
(SURVEY.md §2.1): one column per process, one bar per op spanning
invoke→completion, colored by outcome, with the op's details in a hover
tooltip; written as a standalone ``timeline.html`` into the store dir.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional

from ..history.ops import FAIL, INFO, INVOKE, OK
from .api import Checker, output_path

_COLOR = {OK: "#6DB6FE", FAIL: "#FEB5DA", INFO: "#FFAA26",
          INVOKE: "#C9C9C9"}
_NS = 1e9
_PX_PER_S = 100.0
_MIN_PX = 2.0
_COL_W = 120


def _bars(history) -> List[dict]:
    bars = []
    for op in history:
        if op.type != INVOKE:
            continue
        comp = history.completion(op) if hasattr(history, "completion") \
            else None
        t0 = op.time / _NS
        if comp is not None:
            t1 = comp.time / _NS
            outcome = comp.type
            detail = comp
        else:
            t1 = history[len(history) - 1].time / _NS if len(history) else t0
            outcome = INFO
            detail = op
        bars.append({
            "process": op.process, "t0": t0, "t1": t1, "outcome": outcome,
            "title": (f"{op.process} {op.f} {op.value!r} -> "
                      f"{outcome} {detail.value!r}"
                      + (f" err={detail.error!r}" if detail.error else "")),
            "label": f"{op.f}",
            "index": op.index,
        })
    return bars


class Timeline(Checker):
    """Writes timeline.html (reference `timeline/html`); always valid."""

    def __init__(self, filename: str = "timeline.html"):
        self.filename = filename

    def check(self, test, history, opts=None):
        bars = _bars(history)
        processes = sorted({b["process"] for b in bars}, key=repr)
        col_of = {p: i for i, p in enumerate(processes)}
        t_max = max((b["t1"] for b in bars), default=0.0)

        divs = []
        for b in bars:
            top = b["t0"] * _PX_PER_S
            height = max((b["t1"] - b["t0"]) * _PX_PER_S, _MIN_PX)
            left = col_of[b["process"]] * _COL_W
            divs.append(
                f'<div class="op" style="top:{top:.1f}px;'
                f'left:{left}px;height:{height:.1f}px;'
                f'background:{_COLOR[b["outcome"]]}" '
                f'title="{html.escape(b["title"])}">'
                f'{html.escape(str(b["label"]))}'
                f'<span class="idx">{b["index"]}</span></div>')
        heads = "".join(
            f'<div class="head" style="left:{col_of[p] * _COL_W}px">'
            f'{html.escape(str(p))}</div>' for p in processes)
        doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(str(test.get("name", "test")))} timeline</title>
<style>
body {{ font-family: sans-serif; margin: 0; }}
.lane {{ position: relative; margin-top: 30px;
        height: {t_max * _PX_PER_S + 40:.0f}px; }}
.head {{ position: fixed; top: 0; width: {_COL_W - 4}px; text-align: center;
        background: #eee; font-weight: bold; padding: 2px 0; }}
.op {{ position: absolute; width: {_COL_W - 8}px; font-size: 9px;
      overflow: hidden; border-radius: 2px; padding-left: 2px;
      box-sizing: border-box; border: 1px solid rgba(0,0,0,.25); }}
.idx {{ float: right; color: rgba(0,0,0,.45); padding-right: 2px; }}
</style></head>
<body><div class="lane">{heads}{"".join(divs)}</div></body></html>"""

        path = output_path(test, opts, self.filename)
        with open(path, "w") as f:
            f.write(doc)
        return {"valid?": True, "op-count": len(bars), "file": path}


def html_timeline(**kw) -> Timeline:
    return Timeline(**kw)
