"""Anomaly sub-graph visualization (the port's copy of
`jepsen_tpu/checkers/elle/viz.py`).

Equivalent of the reference's `elle/src/elle/viz.clj` (SURVEY.md §2.3):
renders each detected cycle anomaly as an SVG under
``store/<run>/elle/<anomaly>-<i>.svg`` — transactions laid out on a
circle, dependency edges as labeled arrows (ww/wr/rw/rt/proc), with op
summaries so a human can follow the cycle the checker found.

Cycle witnesses are the checkers' rendered edge lists:
``[{"src": hist_index, "rel": "ww", "dst": hist_index}, ...]``.
"""

from __future__ import annotations

import html
import math
import os
from typing import Any, Dict, List, Sequence

_REL_COLOR = {"ww": "#3A54C6", "wr": "#0F8548", "rw": "#C60F0F",
              "rt": "#666666", "realtime": "#666666",
              "proc": "#A56203", "process": "#A56203"}

_R = 150  # circle radius
_CX = _R + 110
_CY = _R + 60


def _op_label(history, idx: int) -> str:
    if history is None:
        return f"T{idx}"
    try:
        op = history[idx]
    except (IndexError, KeyError, TypeError):
        return f"T{idx}"
    v = repr(op.value)
    if len(v) > 36:
        v = v[:33] + "..."
    return f"{idx}: {op.f} {v}"


def _is_cycle(witness: Any) -> bool:
    return (isinstance(witness, list) and witness
            and all(isinstance(e, dict) and "src" in e and "dst" in e
                    for e in witness))


def render_cycle(cycle: Sequence[dict], path: str,
                 history=None, title: str = "") -> str:
    """One cycle -> one SVG (circle layout)."""
    nodes: List[Any] = []
    for e in cycle:
        for n in (e["src"], e["dst"]):
            if n not in nodes:
                nodes.append(n)
    n = max(len(nodes), 1)
    pos = {v: (_CX + _R * math.cos(2 * math.pi * i / n - math.pi / 2),
               _CY + _R * math.sin(2 * math.pi * i / n - math.pi / 2))
           for i, v in enumerate(nodes)}

    parts: List[str] = [
        '<defs><marker id="arr" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="7" markerHeight="7" orient="auto-start-reverse">'
        '<path d="M 0 0 L 10 5 L 0 10 z" fill="#333"/></marker></defs>']
    for e in cycle:
        (x0, y0), (x1, y1) = pos[e["src"]], pos[e["dst"]]
        # shorten so arrows don't overlap node circles
        dx, dy = x1 - x0, y1 - y0
        d = math.hypot(dx, dy) or 1.0
        pad = 16
        x0p, y0p = x0 + dx / d * pad, y0 + dy / d * pad
        x1p, y1p = x1 - dx / d * pad, y1 - dy / d * pad
        rel = str(e.get("rel", "?"))
        color = _REL_COLOR.get(rel, "#333")
        why = str(e.get("why", "")) if e.get("why") else ""
        tip = (f"<title>{html.escape(why)}</title>") if why else ""
        parts.append(
            f'<line x1="{x0p:.0f}" y1="{y0p:.0f}" x2="{x1p:.0f}" '
            f'y2="{y1p:.0f}" stroke="{color}" stroke-width="1.6" '
            f'marker-end="url(#arr)">{tip}</line>')
        mx, my = (x0 + x1) / 2, (y0 + y1) / 2
        label = rel
        if e.get("key") is not None:
            label = f'{rel} {e["key"]!r}'
        parts.append(
            f'<text x="{mx:.0f}" y="{my:.0f}" font-size="11" '
            f'fill="{color}" font-weight="bold">{html.escape(label)}'
            f'{tip}</text>')
    for v in nodes:
        x, y = pos[v]
        parts.append(
            f'<circle cx="{x:.0f}" cy="{y:.0f}" r="13" fill="#fff" '
            f'stroke="#333"/>'
            f'<text x="{x:.0f}" y="{y + 4:.0f}" font-size="9" '
            f'text-anchor="middle">{html.escape(str(v))}</text>')
        lx = x + (22 if x >= _CX else -22)
        anchor = "start" if x >= _CX else "end"
        parts.append(
            f'<text x="{lx:.0f}" y="{y + 4:.0f}" font-size="9" '
            f'text-anchor="{anchor}" fill="#555">'
            f'{html.escape(_op_label(history, v))}</text>')
    # Explainer legend: one line per edge naming the key/values evidence
    # (the reference's Explainer output, `elle/core.clj`)
    whys = [str(e["why"]) for e in cycle if e.get("why")]
    w, h = 2 * _CX, 2 * _CY + (14 * len(whys) + 10 if whys else 0)
    for i, why in enumerate(whys):
        parts.append(
            f'<text x="8" y="{2 * _CY + 14 * (i + 1):.0f}" font-size="10" '
            f'fill="#333">{i + 1}. {html.escape(why)}</text>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
           f'height="{h}" font-family="sans-serif">'
           f'<text x="8" y="16" font-size="13">{html.escape(title)}</text>'
           + "".join(parts) + "</svg>")
    with open(path, "w") as f:
        f.write(svg)
    return path


def write_anomalies(results: Dict[str, Any], out_dir: str,
                    history=None, max_per_type: int = 4) -> List[str]:
    """Render every cycle witness in a check result's anomalies map
    (reference: elle's `viz!` writing under store/.../elle/).  Returns the
    written paths, also recorded in results["viz-files"]."""
    anomalies = results.get("anomalies") or {}
    written: List[str] = []
    for name, witnesses in sorted(anomalies.items()):
        if not isinstance(witnesses, list):
            continue
        count = 0
        for witness in witnesses:
            # checkers report cycle anomalies as {"cycle": [edges], ...}
            if isinstance(witness, dict) and "cycle" in witness:
                witness = witness["cycle"]
            if not _is_cycle(witness):
                continue
            if count >= max_per_type:
                break
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{name}-{count}.svg")
            render_cycle(witness, path, history=history,
                         title=f"{name} (cycle of {len(witness)} edges)")
            written.append(path)
            count += 1
    if written:
        results["viz-files"] = written
    return written


def viz_for_test(results: Dict[str, Any], test: dict,
                 history=None) -> List[str]:
    """Write anomaly SVGs into the test's store dir under elle/."""
    from ... import store

    if results.get("valid?") is not False:
        return []
    try:
        out_dir = os.path.join(store.test_dir(test), "elle")
    except OSError:
        return []
    return write_anomalies(results, out_dir, history=history)
