"""Text rendering of test results (the port's copy of
`jepsen_tpu/report.py`).

Equivalent of the reference's `jepsen/src/jepsen/report.clj` (SURVEY.md
§2.1): a compact human-readable summary of a completed test's results
map, for terminals and logs.
"""

from __future__ import annotations

from typing import Any, List


def _fmt(v: Any, indent: int = 0, depth: int = 0) -> List[str]:
    pad = "  " * indent
    if isinstance(v, dict):
        lines = []
        for k in sorted(v, key=str):
            val = v[k]
            if isinstance(val, (dict, list)) and val and depth < 4:
                lines.append(f"{pad}{k}:")
                lines.extend(_fmt(val, indent + 1, depth + 1))
            else:
                sval = repr(val)
                if len(sval) > 120:
                    sval = sval[:117] + "..."
                lines.append(f"{pad}{k}: {sval}")
        return lines
    if isinstance(v, list):
        if len(v) > 8:
            shown = v[:8]
            rest = f"{pad}... ({len(v) - 8} more)"
            return [x for item in shown for x in _fmt(item, indent, depth + 1)] + [rest]
        return [x for item in v for x in _fmt(item, indent, depth + 1)]
    return [f"{pad}{v!r}"]


def render(test: dict) -> str:
    """Render a completed test's verdict + results (reference's textual
    report)."""
    results = test.get("results", {}) or {}
    valid = results.get("valid?")
    mark = {True: "✓", False: "✗"}.get(valid, "?")
    header = (f"{mark} {test.get('name', 'test')} — valid? = {valid}"
              f" ({len(test.get('history') or [])} ops)")
    body = _fmt({k: v for k, v in results.items() if k != "valid?"})
    return "\n".join([header] + body)


def print_report(test: dict) -> None:
    print(render(test))


# -- campaign rollups --------------------------------------------------------

_CELL = {True: "ok", False: "FAIL", "unknown": "?", None: "-"}


def _campaign_cell(row: dict) -> str:
    """One grid cell: verdict mark + attribution flags (t = deadline
    budget expired, h = degraded to the host oracle)."""
    mark = _CELL.get(row.get("valid?"), "?")
    flags = ("t" if row.get("deadline") else "") + \
            ("h" if row.get("degraded") else "")
    return mark + ("·" + flags if flags else "")


def render_campaign(summary: dict) -> str:
    """Suite-level rollup of a campaign summary (see
    `campaign.core.summarize`): verdict counts, the workload × fault ×
    seed grid, span-duration aggregates, and regressions."""
    c = summary.get("counts", {})
    lines: List[str] = [
        f"campaign {summary.get('campaign')} — "
        f"{summary.get('total', 0)} runs: "
        f"{c.get('true', 0)} ok, {c.get('false', 0)} invalid, "
        f"{c.get('unknown', 0)} unknown "
        f"({c.get('degraded', 0)} degraded, "
        f"{c.get('deadline', 0)} deadline-expired, "
        f"{summary.get('pending', 0)} pending)",
        f"index: {summary.get('index')}",
    ]
    if summary.get("executed") or summary.get("skipped"):
        lines.append(f"this invocation: {summary.get('executed', 0)} "
                     f"executed, {summary.get('skipped', 0)} resumed "
                     f"(skipped), {summary.get('wall_s', 0)}s")
    seeds = summary.get("seeds") or []
    rows = summary.get("rows") or []
    if rows:
        by_rf: dict = {}
        for r in rows:
            by_rf.setdefault((r["workload"], r["fault"]), {})[r["seed"]] = r
        w0 = max([len(w) for w, _ in by_rf] + [8])
        w1 = max([len(f) for _, f in by_rf] + [5])
        head = (f"  {'workload':<{w0}} {'fault':<{w1}} "
                + " ".join(f"s{s:<5}" for s in seeds))
        lines += ["", head, "  " + "-" * (len(head) - 2)]
        for (wl, fl), cells in sorted(by_rf.items()):
            marks = " ".join(
                f"{_campaign_cell(cells[s]) if s in cells else '-':<6}"
                for s in seeds)
            lines.append(f"  {wl:<{w0}} {fl:<{w1}} {marks}")
        lines.append("  (ok/FAIL/?  ·t = checker deadline expired, "
                     "·h = degraded to host oracle)")
    stats = summary.get("span-stats") or {}
    if stats:
        lines += ["", "  checker span durations (s, across all indexed "
                      "runs):"]
        lines.append(f"  {'span':<32} {'n':>4} {'p50':>10} {'p95':>10} "
                     f"{'max':>10}")
        for name, st in stats.items():
            lines.append(f"  {name:<32} {st['count']:>4} {st['p50']:>10.4f}"
                         f" {st['p95']:>10.4f} {st['max']:>10.4f}")
    regs = summary.get("regressions") or []
    if regs:
        lines += ["", "  REGRESSIONS (valid? moved away from True):"]
        for r in regs:
            lines.append(f"  {r['key']}: {r['from']} -> {r['to']} "
                         f"({r.get('when') or r.get('gen') or '?'})")
    else:
        lines += ["", "  no regressions"]
    return "\n".join(lines)


def print_campaign(summary: dict) -> None:
    print(render_campaign(summary))
