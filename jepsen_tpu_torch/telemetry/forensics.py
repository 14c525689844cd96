"""Regression forensics + device-call profiles (the port's copy of
`jepsen_tpu/telemetry/forensics.py`).

The span gate (:mod:`gate`) is a tripwire: rc 1 when a span's p95
regressed.  This module turns the trip into a diagnosis — WHERE inside the span the
extra time went (the phase-bucket taxonomy ``spans.PHASE_BUCKETS``) and
WHAT co-moved with it (compile-cache misses, retries, requeues, sweep
dispatches) — so a performance change cites machine-generated before/after
attribution instead of a hand-run bench.

Parity contract: every function here is PURE over the
``(gen, spans, phases, counters)`` record shape that BOTH backends
produce (``Index.forensic_records`` off the raw jsonl,
``Warehouse.forensic_records`` off SQL), so the warehouse fast path and
the jsonl scan fallback reach the identical verdict — the same
discipline as ``index.witness_pair_diffs``.

Attribution rule: per generation, a span's MEAN duration over the
records that carry it; the delta between generations is split across
the mean per-bucket deltas of the same records.  Means (not p95s)
because a bucket share of a p95 is not well defined — the p95 verdict
itself still comes from :mod:`gate`'s Mann-Whitney test, so forensics
never changes a gate decision, only explains it.
"""

from __future__ import annotations

import fnmatch
import os
from typing import Any, Dict, List, Optional, Tuple

from .spans import PHASE_BUCKETS

__all__ = ["profile_from_doc", "profile_rows_from_dirs",
           "render_profile", "attribute_span", "run_diff",
           "render_diff", "resolve_spans"]

#: the span_profile/profile-cell value keys, in display order
PROFILE_KEYS = ("calls", "compile_s", "execute_s", "device_dispatch_s")


# ---------------------------------------------------------------------------
# Device-call profiles: (site, shape-class) self-time cells
# ---------------------------------------------------------------------------

def _empty_cell() -> Dict[str, Any]:
    return {"calls": 0, "compile_s": 0.0, "execute_s": 0.0,
            "device_dispatch_s": 0.0}


def profile_from_doc(doc: Any) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """The run's per-(site, shape-class) device-call profile, summed
    over every span's ``profile`` attr in a telemetry.json document —
    THE extraction both the warehouse run-dir ingest and the jsonl
    fallback use."""
    out: Dict[Tuple[str, str], Dict[str, Any]] = {}
    if not isinstance(doc, dict):
        return out

    def fold(prof: Any) -> None:
        if not isinstance(prof, dict):
            return
        for key, cell in prof.items():
            if not isinstance(cell, dict):
                continue
            site, _, shape = str(key).partition("|")
            agg = out.setdefault((site, shape or "scalar"), _empty_cell())
            agg["calls"] += int(cell.get("calls") or 0)
            for k in ("compile_s", "execute_s", "device_dispatch_s"):
                v = cell.get(k)
                if isinstance(v, (int, float)):
                    agg[k] += float(v)

    def walk(sp: Dict[str, Any]) -> None:
        fold((sp.get("attrs") or {}).get("profile"))
        for c in sp.get("children") or []:
            walk(c)

    for r in doc.get("spans") or []:
        walk(r)
    return out


def profile_rows_from_dirs(base: str, dirs: List[str]
                           ) -> List[Dict[str, Any]]:
    """The jsonl-scan twin of ``Warehouse.campaign_profile``: read each
    run dir's telemetry.json and aggregate per (site, shape, host).
    ``dirs`` are store-relative (ledger record ``dir`` fields)."""
    import json

    agg: Dict[Tuple[str, str, Optional[str]], Dict[str, Any]] = {}
    for rel in dirs:
        if not rel:
            continue
        path = os.path.join(base, rel, "telemetry.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        meta = doc.get("meta") or {} if isinstance(doc, dict) else {}
        host = meta.get("host") if isinstance(meta, dict) else None
        for (site, shape), cell in profile_from_doc(doc).items():
            a = agg.setdefault((site, shape, host), _empty_cell())
            a["calls"] += cell["calls"]
            for k in ("compile_s", "execute_s", "device_dispatch_s"):
                a[k] += cell[k]
    out = [{"site": site, "shape": shape, "host": host,
            "calls": int(c["calls"]),
            "compile_s": round(c["compile_s"], 6),
            "execute_s": round(c["execute_s"], 6),
            "device_dispatch_s": round(c["device_dispatch_s"], 6)}
           for (site, shape, host), c in agg.items()]
    out.sort(key=lambda r: -(r["compile_s"] + r["execute_s"]))
    return out


def render_profile(rows: List[Dict[str, Any]], width: int = 44) -> str:
    """Text treemap of a campaign profile: per site (largest first) a
    bar of its self-time share, then its shape classes indented —
    ``obs profile``'s renderer (the web page shares the row shape)."""
    if not rows:
        return "no device-call profile (no telemetric runs ingested?)"
    by_site: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_site.setdefault(r["site"], []).append(r)
    site_total = {s: sum(r["compile_s"] + r["execute_s"] for r in rs)
                  for s, rs in by_site.items()}
    grand = sum(site_total.values()) or 1e-12
    lines = [f"{'site / shape-class':<52} {'calls':>7} "
             f"{'compile':>9} {'execute':>9} {'dispatch':>9}"]
    for site in sorted(by_site, key=lambda s: -site_total[s]):
        rs = by_site[site]
        share = site_total[site] / grand
        bar = "#" * max(1, int(round(share * width)))
        lines.append(f"{site:<38} {bar} {share * 100:5.1f}%")
        for r in sorted(rs, key=lambda r: -(r["compile_s"]
                                            + r["execute_s"])):
            host = f" @{r['host']}" if r.get("host") else ""
            lines.append(
                f"  {r['shape'][:48] + host:<50} {r['calls']:>7} "
                f"{r['compile_s']:>8.3f}s {r['execute_s']:>8.3f}s "
                f"{r['device_dispatch_s']:>8.3f}s")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Regression forensics over ledger records
# ---------------------------------------------------------------------------

def resolve_spans(names: Any, patterns: List[str]) -> List[str]:
    """Expand ``--span`` values (exact names and ``*`` globs) against
    the known span names, preserving pattern order then name order;
    exact names pass through even when absent (the gate reports
    insufficient-data for them, matching single-span behavior)."""
    known = sorted(names)
    out: List[str] = []
    for pat in patterns:
        if any(ch in pat for ch in "*?["):
            out.extend(n for n in known
                       if fnmatch.fnmatchcase(n, pat) and n not in out)
        elif pat not in out:
            out.append(pat)
    return out


def _gen_order(records: List[Tuple]) -> List[str]:
    order: List[str] = []
    for gen, _spans, _ph, _cn in records:
        g = str(gen or "?")
        if g not in order:
            order.append(g)
    return order


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def attribute_span(span: str, records: List[Tuple],
                   from_gen: str, to_gen: str) -> Dict[str, Any]:
    """Attribute one span's generation-to-generation delta across the
    phase buckets and forensic counter deltas.  ``records`` is the
    backend-shared ``(gen, spans, phases, counters)`` list."""
    def for_gen(g: str) -> Tuple[List[float], List[Dict[str, Any]],
                                 List[Dict[str, float]]]:
        durs, phs, cns = [], [], []
        for gen, spans, phases, counters in records:
            if str(gen or "?") != g:
                continue
            dur = spans.get(span)
            if isinstance(dur, (int, float)):
                durs.append(float(dur))
                phs.append(phases.get(span) or {})
            cns.append(counters or {})
        return durs, phs, cns

    d_from, ph_from, cn_from = for_gen(from_gen)
    d_to, ph_to, cn_to = for_gen(to_gen)
    mean_from, mean_to = _mean(d_from), _mean(d_to)
    delta = mean_to - mean_from
    buckets = []
    for b in PHASE_BUCKETS:
        bf = _mean([float(p.get(b) or 0.0) for p in ph_from])
        bt = _mean([float(p.get(b) or 0.0) for p in ph_to])
        bd = bt - bf
        if not bf and not bt:
            continue
        buckets.append({
            "bucket": b, "from_s": round(bf, 6), "to_s": round(bt, 6),
            "delta_s": round(bd, 6),
            "share": round(bd / delta, 4) if delta > 0 else None,
        })
    buckets.sort(key=lambda e: -e["delta_s"])
    attributed = sum(e["delta_s"] for e in buckets if e["delta_s"] > 0)
    names = sorted({k for c in cn_from + cn_to for k in c})
    counters = []
    for name in names:
        cf = _mean([float(c.get(name) or 0.0) for c in cn_from])
        ct = _mean([float(c.get(name) or 0.0) for c in cn_to])
        if cf == ct:
            continue
        counters.append({"name": name, "from": round(cf, 3),
                         "to": round(ct, 3),
                         "delta": round(ct - cf, 3)})
    counters.sort(key=lambda e: -abs(e["delta"]))
    dominant = next((e["bucket"] for e in buckets
                     if e["delta_s"] > 0), None)
    return {
        "span": span, "from-gen": from_gen, "to-gen": to_gen,
        "n_from": len(d_from), "n_to": len(d_to),
        "mean_from": round(mean_from, 6), "mean_to": round(mean_to, 6),
        "delta_s": round(delta, 6),
        "rel_delta": (round(delta / mean_from, 4) if mean_from > 0
                      else None),
        "phases": buckets,
        "attributed_s": round(attributed, 6),
        "unattributed_s": round(max(0.0, delta - attributed), 6)
        if delta > 0 else 0.0,
        "counters": counters,
        "dominant": dominant,
    }


def run_diff(base: str, campaign: str, *,
             from_gen: Optional[str] = None,
             to_gen: Optional[str] = None,
             spans: Optional[List[str]] = None,
             alpha: float = 0.05, threshold: float = 0.25,
             min_runs: int = 3) -> Dict[str, Any]:
    """The ``cli obs diff`` engine: gate every span between two
    generations and attribute each regression's delta.  Returns a
    report dict with ``status`` in {"regression", "pass",
    "insufficient-data"}; unknown campaigns / missing generations are
    insufficient-data (rc 2), a named regression is rc 1."""
    from jepsen_tpu_torch.campaign.core import index_path
    from jepsen_tpu_torch.campaign.index import Index

    from . import gate as gate_mod

    idx = Index(index_path(campaign, base))
    records = idx.forensic_records()
    order = _gen_order(records)
    report: Dict[str, Any] = {
        "campaign": campaign, "generations": order,
        "alpha": alpha, "threshold": threshold, "min_runs": min_runs,
    }
    if len(order) < 2 and not (from_gen and to_gen):
        report.update(status="insufficient-data",
                      reason=f"need >= 2 generations, have {len(order)}",
                      spans=[])
        return report
    g_from = from_gen or order[-2]
    g_to = to_gen or order[-1]
    report.update({"from-gen": g_from, "to-gen": g_to})
    if g_from == g_to:
        report.update(status="insufficient-data",
                      reason="from-gen == to-gen", spans=[])
        return report
    names = sorted({n for _g, sp, _p, _c in records for n in sp})
    wanted = resolve_spans(names, spans) if spans else names
    entries = []
    for span in wanted:
        by_gen: Dict[str, List[float]] = {}
        for gen, sp, _p, _c in records:
            dur = sp.get(span)
            if isinstance(dur, (int, float)):
                by_gen.setdefault(str(gen or "?"), []).append(float(dur))
        res = gate_mod.gate_samples(by_gen.get(g_from, []),
                                    by_gen.get(g_to, []),
                                    alpha=alpha, threshold=threshold,
                                    min_runs=min_runs)
        entry = attribute_span(span, records, g_from, g_to)
        entry["gate"] = res
        entry["status"] = res.get("status")
        entries.append(entry)
    rank = {"regression": 0, "pass": 1, "insufficient-data": 2}
    entries.sort(key=lambda e: (rank.get(e["status"], 3),
                                -(e.get("rel_delta") or 0.0)))
    report["spans"] = entries
    if any(e["status"] == "regression" for e in entries):
        report["status"] = "regression"
    elif any(e["status"] == "pass" for e in entries):
        report["status"] = "pass"
    else:
        report["status"] = "insufficient-data"
        report.setdefault("reason", "no span had enough samples in "
                                    "both generations")
    return report


def _fmt_pct(x: Optional[float]) -> str:
    return f"{x * 100:+.0f}%" if isinstance(x, (int, float)) else "?"


def render_attribution(entry: Dict[str, Any]) -> List[str]:
    """The per-span forensics lines shared by ``obs diff`` and
    ``obs gate --explain``."""
    lines = []
    head = (f"{entry['span']}: {_fmt_pct(entry.get('rel_delta'))} "
            f"(mean {entry['mean_from']:.4f}s -> "
            f"{entry['mean_to']:.4f}s, "
            f"n={entry['n_from']}/{entry['n_to']})")
    if entry.get("dominant"):
        share = next((e.get("share") for e in entry["phases"]
                      if e["bucket"] == entry["dominant"]), None)
        pct = (f"{share * 100:.0f}% " if isinstance(share, (int, float))
               else "")
        head += f" — {pct}of delta in {entry['dominant']}"
    lines.append(head)
    for e in entry.get("phases") or []:
        share = e.get("share")
        pct = (f" ({share * 100:5.1f}% of delta)"
               if isinstance(share, (int, float)) else "")
        lines.append(f"    {e['bucket']:<18} {e['from_s']:>9.4f}s -> "
                     f"{e['to_s']:>9.4f}s  {e['delta_s']:+9.4f}s{pct}")
    if entry.get("unattributed_s"):
        lines.append(f"    {'(unattributed)':<18} "
                     f"{entry['unattributed_s']:+9.4f}s outside the "
                     "phase buckets")
    for c in (entry.get("counters") or [])[:8]:
        lines.append(f"    {c['name']}  {c['from']:g} -> {c['to']:g} "
                     f"({c['delta']:+g})")
    return lines


def render_diff(report: Dict[str, Any]) -> str:
    lines = [f"obs diff: campaign {report['campaign']} "
             f"{report.get('from-gen', '?')} -> "
             f"{report.get('to-gen', '?')} "
             f"[{report.get('status')}]"]
    if report.get("reason"):
        lines.append(f"  {report['reason']}")
    for entry in report.get("spans") or []:
        marker = {"regression": "REGRESSION", "pass": "ok",
                  "insufficient-data": "n/a"}.get(entry["status"], "?")
        lines.append("")
        lines.append(f"[{marker}] " + render_attribution(entry)[0])
        if entry["status"] == "regression":
            lines.extend(render_attribution(entry)[1:])
        g = entry.get("gate") or {}
        if g.get("status") == "regression":
            lines.append(f"    gate: p95 {g.get('p95_old')}s -> "
                         f"{g.get('p95_new')}s, p={g.get('p_value')}")
    return "\n".join(lines)
