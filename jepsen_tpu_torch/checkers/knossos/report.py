"""SVG rendering of non-linearizable windows (the port's copy of
`jepsen_tpu/checkers/knossos/report.py`, byte for byte the same SVG).

Equivalent of `knossos/linear/report.clj` (SURVEY.md §2.4): given a
failed linearizability analysis, draw the ops around the violation — one
lane per process, bars spanning invoke→return, the offending op
highlighted — as a standalone SVG written into the store dir.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional

from ...history.ops import FAIL, INFO, INVOKE, OK, History

_LANE_H = 28
_PX_PER_POS = 14
_BAR_H = 20

_FILL = {OK: "#6DB6FE", INFO: "#FFAA26", FAIL: "#FEB5DA"}


def _window_ops(history: History, center_index: int, radius: int = 20):
    lo = max(0, center_index - radius)
    hi = min(len(history), center_index + radius)
    out = []
    for op in history:
        if op.type != INVOKE or not op.is_client_op():
            continue
        comp = history.completion(op)
        end = comp.index if comp is not None else hi
        if end < lo or op.index > hi:
            continue
        out.append((op, comp))
    return out, lo, hi


def render_analysis(history: History, analysis: Dict[str, Any],
                    path: str, radius: int = 20) -> Optional[str]:
    """Write an SVG for a failed analysis; returns the path (or None if
    the analysis has no localizable op)."""
    final = analysis.get("final-info") or {}
    op_info = final.get("op") or {}
    center = op_info.get("index")
    if center is None:
        # WGL-style failure: anchor on the last linearized op if present
        configs = final.get("configs") or []
        linz = [i for c in configs for i in c.get("linearized", [])]
        if not linz:
            return None
        center = max(linz)
    ops, lo, hi = _window_ops(history, int(center), radius)
    if not ops:
        return None
    procs = sorted({op.process for op, _ in ops}, key=repr)
    lane = {p: i for i, p in enumerate(procs)}

    def x(pos: int) -> float:
        return 60 + (pos - lo) * _PX_PER_POS

    parts: List[str] = []
    for p in procs:
        y = 20 + lane[p] * _LANE_H
        parts.append(f'<text x="6" y="{y + 14}" font-size="11">'
                     f'{html.escape(str(p))}</text>')
    for op, comp in ops:
        y = 20 + lane[op.process] * _LANE_H
        x0 = x(op.index)
        x1 = x(comp.index) if comp is not None else x(hi) + 10
        outcome = comp.type if comp is not None else INFO
        bad = op.index == center
        stroke = "#C60F0F" if bad else "#666"
        sw = 2.5 if bad else 0.75
        label = f"{op.f} {op.value!r}"
        if comp is not None and comp.value is not None \
                and comp.value != op.value:
            label += f" → {comp.value!r}"
        parts.append(
            f'<rect x="{x0:.0f}" y="{y}" width="{max(x1 - x0, 6):.0f}" '
            f'height="{_BAR_H}" rx="3" fill="{_FILL[outcome]}" '
            f'stroke="{stroke}" stroke-width="{sw}"/>'
            f'<text x="{x0 + 3:.0f}" y="{y + 14}" font-size="10">'
            f'{html.escape(label[:28])}</text>')
    w = x(hi) + 40
    h = 30 + len(procs) * _LANE_H
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}" '
           f'height="{h}" font-family="sans-serif">'
           f'<text x="6" y="12" font-size="12" fill="#C60F0F">'
           f'non-linearizable: op {center}</text>'
           + "".join(parts) + "</svg>")
    with open(path, "w") as f:
        f.write(svg)
    return path
