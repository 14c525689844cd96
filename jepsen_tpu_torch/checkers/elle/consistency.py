"""Consistency-model lattice (the port's copy of
`jepsen_tpu/checkers/elle/consistency.py`).

Equivalent of the reference's `elle/consistency_model.clj` (SURVEY.md §2.3):
a DAG of consistency models ordered by strength, a mapping from observed
anomalies to the models they rule out, and `friendly_boundary` reporting —
"not(serializable) but maybe(snapshot-isolation)".

The lattice covers the reference's full ~40-model surface: the Adya PL
hierarchy (PL-1 … PL-3, PL-CS, PL-2L, PL-MSR, PL-2+, PL-FCV, PL-3U), the
snapshot-isolation family (incl. prefix-consistent and parallel SI), the
Cerone transactional models (read-atomic, causal-cerone, prefix), the
session-guarantee family (monotonic-reads/writes, read-your-writes,
writes-follow-reads, PRAM, causal, sequential), single-object realtime
(linearizable), and the strong-session / strong (realtime) variants built
from process- and realtime-edge cycle anomalies.

Sources for the implication edges: Adya's thesis (PL hierarchy and G-x
phenomena), Bailis et al. HAT, Cerone et al. (RA/causal/prefix/PSI),
Terry et al. session guarantees, Daudjee & Salem strong-session models,
Viotti & Vukolić's survey (session lattice: linearizable > sequential >
causal > PRAM > {MR, MW, RYW}).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Set

# model -> models it directly implies (stronger -> weaker edges)
IMPLIES: Dict[str, List[str]] = {
    # --- serializability column (Adya PL-3 and realtime/session variants)
    "strict-serializable": ["serializable", "strong-session-serializable",
                            "strong-snapshot-isolation", "linearizable",
                            "conflict-serializable", "strong-read-committed"],
    "strong-session-serializable": ["serializable",
                                    "strong-session-read-committed"],
    "serializable": ["repeatable-read", "view-serializable", "read-atomic",
                     "update-serializable"],
    "conflict-serializable": ["view-serializable"],
    "view-serializable": [],
    # Adya PL-3U: serializability w.r.t. update transactions only
    "update-serializable": ["forward-consistent-view"],
    # Adya PL-FCV / PL-2+ / PL-2L column
    "forward-consistent-view": ["consistent-view"],
    "repeatable-read": ["cursor-stability", "consistent-view"],
    "consistent-view": ["monotonic-view"],
    "monotonic-view": ["read-committed"],
    "monotonic-snapshot-read": ["read-committed"],
    "cursor-stability": ["read-committed"],
    # --- snapshot-isolation family
    "strong-snapshot-isolation": ["snapshot-isolation",
                                  "strong-session-snapshot-isolation"],
    "strong-session-snapshot-isolation":
        ["prefix-consistent-snapshot-isolation"],
    "prefix-consistent-snapshot-isolation": ["snapshot-isolation"],
    "snapshot-isolation": ["consistent-view", "monotonic-atomic-view",
                           "read-atomic", "monotonic-snapshot-read"],
    "parallel-snapshot-isolation": ["causal-cerone"],
    # --- Cerone transactional models
    "causal-cerone": ["read-atomic", "causal"],
    "prefix": ["causal-cerone"],
    "read-atomic": ["monotonic-atomic-view"],
    "monotonic-atomic-view": ["read-committed"],
    # --- weak isolation floor
    "read-committed": ["read-uncommitted"],
    "read-uncommitted": [],
    # --- session guarantees (Terry et al.; Viotti & Vukolić ordering)
    "linearizable": ["sequential"],
    "sequential": ["causal"],
    "causal": ["PRAM", "writes-follow-reads"],
    "PRAM": ["monotonic-reads", "monotonic-writes", "read-your-writes"],
    "monotonic-reads": [],
    "monotonic-writes": [],
    "read-your-writes": [],
    "writes-follow-reads": [],
    # --- strong-session / strong (realtime) weak-isolation variants
    "strong-session-read-uncommitted": ["read-uncommitted"],
    "strong-session-read-committed": ["read-committed",
                                      "strong-session-read-uncommitted"],
    "strong-read-uncommitted": ["strong-session-read-uncommitted"],
    "strong-read-committed": ["read-committed", "strong-read-uncommitted",
                              "strong-session-read-committed"],
}

ALL_MODELS = sorted(IMPLIES.keys())

# Canonical aliases users may pass (reference supports many).
ALIASES = {
    "strict-1SR": "strict-serializable",
    "strong-serializable": "strict-serializable",
    "PL-SS": "strict-serializable",
    "PL-3": "serializable",
    "PL-3U": "update-serializable",
    "PL-FCV": "forward-consistent-view",
    "PL-2.99": "repeatable-read",
    "PL-2+": "consistent-view",
    "PL-2L": "monotonic-view",
    "PL-MSR": "monotonic-snapshot-read",
    "PL-CS": "cursor-stability",
    "PL-2": "read-committed",
    "PL-1": "read-uncommitted",
    "SI": "snapshot-isolation",
    "strong-SI": "strong-snapshot-isolation",
    "strong-session-SI": "strong-session-snapshot-isolation",
    "prefix-consistent-SI": "prefix-consistent-snapshot-isolation",
    "PSI": "parallel-snapshot-isolation",
    "serializability": "serializable",
    "sequential-consistency": "sequential",
    "causal-consistency": "causal",
    "pipelined-RAM": "PRAM",
    "pram": "PRAM",
}

# model -> anomalies it directly proscribes (closed downward over IMPLIES:
# a model also proscribes everything its weaker models do).  The session
# leaves use "<model>-violation" tokens for per-session ordering
# violations (checkers that scan per-process read/write orders emit them).
PROSCRIBED: Dict[str, Set[str]] = {
    "read-uncommitted": {"G0", "duplicate-elements", "incompatible-order",
                         "cyclic-versions", "duplicate-writes"},
    "read-committed": {"G1a", "G1b", "G1c", "dirty-update", "aborted-read",
                       "intermediate-read"},
    "monotonic-atomic-view": {"monotonic-atomic-view-violation"},
    "read-atomic": {"internal", "fractured-read"},
    "causal-cerone": {"G1c-process", "G0-process"},
    "prefix": set(),
    "parallel-snapshot-isolation": set(),
    "monotonic-view": {"G-monotonic"},
    "monotonic-snapshot-read": {"G-MSR"},
    "consistent-view": {"G-single"},
    "forward-consistent-view": {"G-SIb"},
    "update-serializable": {"G-update"},
    "cursor-stability": {"G-cursor", "lost-update"},
    "snapshot-isolation": {"G-single", "G-SI", "G-SIa", "G-SIb",
                           "lost-update"},
    "prefix-consistent-snapshot-isolation": set(),
    "repeatable-read": {"G2-item", "lost-update"},
    "serializable": {"G2-item", "G2", "G-nonadjacent", "G-single"},
    "conflict-serializable": {"G0", "G1c", "G2-item", "G2", "G-single",
                              "G-nonadjacent"},
    "view-serializable": {"G2-item"},
    "strong-session-serializable": {"G2-item-process", "G-single-process",
                                    "G-nonadjacent-process",
                                    "G1c-process", "G0-process"},
    "strong-session-snapshot-isolation": {"G-single-process", "G1c-process"},
    "strong-snapshot-isolation": {"G-single-realtime", "G1c-realtime"},
    "strict-serializable": {"G2-item-realtime", "G-single-realtime",
                            "G1c-realtime", "G0-realtime",
                            "G-nonadjacent-realtime"},
    "linearizable": set(),
    "sequential": set(),
    "causal": set(),
    "PRAM": set(),
    "monotonic-reads": {"monotonic-reads-violation"},
    "monotonic-writes": {"monotonic-writes-violation"},
    "read-your-writes": {"read-your-writes-violation"},
    "writes-follow-reads": {"writes-follow-reads-violation"},
    "strong-session-read-uncommitted": {"G0-process"},
    "strong-session-read-committed": {"G1c-process"},
    "strong-read-uncommitted": {"G0-realtime"},
    "strong-read-committed": {"G1c-realtime"},
}

assert set(PROSCRIBED) == set(IMPLIES), \
    sorted(set(PROSCRIBED) ^ set(IMPLIES))


def canonical(model: str) -> str:
    m = ALIASES.get(model, model)
    if m not in IMPLIES:
        raise ValueError(f"unknown consistency model {model!r}")
    return m


def _descendants(model: str) -> Set[str]:
    """All models implied by `model` (including itself)."""
    seen: Set[str] = set()
    stack = [model]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(IMPLIES[m])
    return seen


_DESC: Dict[str, FrozenSet[str]] = {m: frozenset(_descendants(m)) for m in IMPLIES}


def proscribed_anomalies(model: str) -> Set[str]:
    """Every anomaly that rules out `model` (its own + all weaker models')."""
    out: Set[str] = set()
    for m in _DESC[canonical(model)]:
        out |= PROSCRIBED[m]
    return out


def anomaly_impossible_models(anomalies: Iterable[str]) -> Set[str]:
    """All models ruled out by any of the observed anomalies."""
    obs = set(anomalies)
    return {m for m in IMPLIES if proscribed_anomalies(m) & obs}


# niche formalisms kept out of the headline "not" line when a friendlier
# violated model exists (they still appear in "also-not") — the
# "friendly" in the reference's friendly-boundary
_NONFRIENDLY = frozenset({"conflict-serializable", "view-serializable"})


def friendly_boundary(anomalies: Iterable[str]) -> Dict[str, List[str]]:
    """Reference `elle.consistency-model/friendly-boundary`:

    {:not        — the weakest violated models (the informative boundary)
     :also-not   — all other violated models}
    """
    impossible = anomaly_impossible_models(anomalies)
    # minimal (weakest) violated: no other violated model is implied by it
    boundary = set()
    for m in impossible:
        weaker = _DESC[m] - {m}
        if not (weaker & impossible):
            boundary.add(m)
    if boundary - _NONFRIENDLY:
        boundary -= _NONFRIENDLY
    return {
        "not": sorted(boundary),
        "also-not": sorted(impossible - boundary),
    }


def anomalies_for_models(models: Iterable[str]) -> Set[str]:
    """Which anomalies must be searched for to validate `models`."""
    out: Set[str] = set()
    for m in models:
        out |= proscribed_anomalies(m)
    return out
