"""Statistical span-regression gate (the port's copy of
`jepsen_tpu/telemetry/gate.py`, the JAX package's ``cli obs gate``).

Turns "quote span_trend deltas, not anecdotes" into an enforceable
check: compare one span site's per-run duration samples
across two campaign generations and exit nonzero on regression.

The decision combines two tests, BOTH of which must trip:

- a one-sided **Mann-Whitney U** (normal approximation with tie
  correction and continuity correction — stdlib only) that the new
  generation's durations are stochastically larger, at significance
  ``alpha``; and
- a **hard relative-delta threshold** on the group p95s
  (``(p95_new - p95_old) / p95_old > threshold``), so a statistically
  detectable but operationally irrelevant shift doesn't fail the build
  — and conversely a huge delta backed by too little evidence doesn't
  pass silently (it exits with the distinct "insufficient data" code).

Exit codes (``cli obs gate``): 0 pass, 1 regression, 2 cannot evaluate
(unknown campaign/span, or fewer than ``min_runs`` samples per side).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["mann_whitney_u", "gate_samples", "run_gate", "render_gate"]


def _rank(values: Sequence[float]) -> Tuple[List[float], float]:
    """Average ranks (1-based) and the tie-correction term
    ``sum(t^3 - t)`` over tie groups."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    tie_term = 0.0
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and \
                values[order[j + 1]] == values[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        t = j - i + 1
        if t > 1:
            tie_term += t ** 3 - t
        i = j + 1
    return ranks, tie_term


def mann_whitney_u(a: Sequence[float], b: Sequence[float]
                   ) -> Dict[str, float]:
    """One-sided Mann-Whitney U test that ``b`` is stochastically
    LARGER than ``a`` (the regression direction for durations).
    Returns ``{"u": U_b, "z": ..., "p": one-sided p-value}`` using the
    normal approximation with tie correction and a 0.5 continuity
    correction.  Degenerate inputs (an empty side, or all values tied)
    return p = 1.0 — no evidence of regression."""
    n1, n2 = len(a), len(b)
    if not n1 or not n2:
        return {"u": 0.0, "z": 0.0, "p": 1.0}
    ranks, tie_term = _rank(list(a) + list(b))
    r2 = sum(ranks[n1:])
    u2 = r2 - n2 * (n2 + 1) / 2.0  # pairs where b > a (+ half-ties)
    mu = n1 * n2 / 2.0
    n = n1 + n2
    var = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0:
        return {"u": u2, "z": 0.0, "p": 1.0}
    z = (u2 - mu - 0.5) / math.sqrt(var)
    p = 0.5 * math.erfc(z / math.sqrt(2.0))
    return {"u": u2, "z": z, "p": p}


def _p95(vals: List[float]) -> float:
    from jepsen_tpu_torch.campaign.index import _percentile

    return _percentile(vals, 95)


def gate_samples(old: List[float], new: List[float], *,
                 alpha: float = 0.05, threshold: float = 0.25,
                 min_runs: int = 3) -> Dict[str, Any]:
    """The gate decision over two sample groups.  Returns a result map
    with ``status`` in {"pass", "regression", "insufficient-data"} and
    the full evidence (n, p95s, relative delta, U, p-value)."""
    res: Dict[str, Any] = {
        "n_old": len(old), "n_new": len(new),
        "alpha": alpha, "threshold": threshold,
    }
    if len(old) < min_runs or len(new) < min_runs:
        res["status"] = "insufficient-data"
        res["reason"] = (f"need >= {min_runs} runs per generation "
                         f"(have {len(old)} vs {len(new)})")
        return res
    p95_old, p95_new = _p95(old), _p95(new)
    rel = ((p95_new - p95_old) / p95_old if p95_old > 0
           else (math.inf if p95_new > 0 else 0.0))
    mw = mann_whitney_u(old, new)
    res.update({
        "p95_old": round(p95_old, 6), "p95_new": round(p95_new, 6),
        "rel_delta": (round(rel, 4) if math.isfinite(rel) else rel),
        "u": mw["u"], "z": round(mw["z"], 4), "p_value": mw["p"],
    })
    significant = mw["p"] < alpha
    big = rel > threshold
    if significant and big:
        res["status"] = "regression"
        res["reason"] = (f"p95 +{rel * 100.0:.1f}% (> "
                         f"{threshold * 100.0:.0f}%) and Mann-Whitney "
                         f"p={mw['p']:.2g} < {alpha:g}")
    else:
        res["status"] = "pass"
        res["reason"] = ("shift not significant "
                         f"(p={mw['p']:.2g} >= {alpha:g})"
                         if big else
                         f"p95 delta {rel * 100.0:+.1f}% within "
                         f"{threshold * 100.0:.0f}% threshold")
    return res


def run_gate(base: str, campaign: str, span: str, *,
             from_gen: Optional[str] = None,
             to_gen: Optional[str] = None,
             alpha: float = 0.05, threshold: float = 0.25,
             min_runs: int = 3) -> Dict[str, Any]:
    """Gate one span site of one campaign: pull its (gen, duration)
    samples (warehouse-backed when fresh, jsonl scan otherwise), pick
    the generation pair (default: the two most recent), and decide.
    The result map carries ``status`` as in :func:`gate_samples`."""
    from jepsen_tpu_torch.campaign.core import index_path
    from jepsen_tpu_torch.campaign.index import Index

    path = index_path(campaign, base)
    samples = Index(path).span_samples(span)
    by_gen: Dict[str, List[float]] = {}
    order: List[str] = []
    for gen, dur in samples:
        g = str(gen or "?")
        if g not in by_gen:
            order.append(g)
        by_gen.setdefault(g, []).append(dur)
    res: Dict[str, Any] = {"campaign": campaign, "span": span,
                           "generations": order}
    if not order:
        res.update(status="insufficient-data",
                   reason=f"no samples for span {span!r} in campaign "
                          f"{campaign!r} (index: {path})",
                   n_old=0, n_new=0)
        return res
    if from_gen is None or to_gen is None:
        if len(order) < 2:
            res.update(status="insufficient-data",
                       reason="need two generations to compare "
                              f"(have {order})", n_old=0, n_new=0)
            return res
        from_gen = from_gen or order[-2]
        to_gen = to_gen or order[-1]
    if from_gen not in by_gen or to_gen not in by_gen:
        missing = [g for g in (from_gen, to_gen) if g not in by_gen]
        res.update(status="insufficient-data",
                   reason=f"generation(s) {missing} not in {order}",
                   n_old=0, n_new=0)
        return res
    if from_gen == to_gen:
        # a half-specified pair can resolve to the same generation
        # (e.g. --from-gen <latest> with --to-gen omitted): comparing a
        # group against itself always passes — refuse loudly (exit 2)
        # instead of letting a misconfigured gate pass forever
        res.update(status="insufficient-data",
                   reason=f"from-gen == to-gen ({from_gen!r}): nothing "
                          f"to compare (generations: {order})",
                   n_old=0, n_new=0)
        return res
    res.update({"from-gen": from_gen, "to-gen": to_gen})
    res.update(gate_samples(by_gen[from_gen], by_gen[to_gen],
                            alpha=alpha, threshold=threshold,
                            min_runs=min_runs))
    return res


def render_gate(res: Dict[str, Any]) -> str:
    """Human one-screen gate report."""
    lines = [f"obs gate: {res.get('campaign')} span={res.get('span')}"]
    if res.get("from-gen"):
        lines.append(f"  generations: {res['from-gen']} -> "
                     f"{res['to-gen']} "
                     f"({res.get('n_old')} vs {res.get('n_new')} runs)")
    if "p95_old" in res:
        lines.append(
            f"  p95: {res['p95_old']}s -> {res['p95_new']}s "
            f"({res['rel_delta'] * 100.0:+.1f}%), "
            f"Mann-Whitney U={res['u']:.1f} z={res['z']} "
            f"p={res['p_value']:.3g}")
    lines.append(f"  {res.get('status').upper()}: {res.get('reason')}")
    return "\n".join(lines)
