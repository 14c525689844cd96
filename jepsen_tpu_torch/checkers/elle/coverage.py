"""Anomaly-coverage contract: never silently validate an unsearched
anomaly (the port's copy of `jepsen_tpu/checkers/elle/coverage.py`).

`anomalies_for_models` hands checkers tokens across the WHOLE lattice
vocabulary; a checker that cannot produce some requested token must not
return `valid?: True` as if it had searched for it.  This module is the
single place that records, for the list-append pipeline, which tokens
are searched directly, which foreign-vocabulary tokens are *covered by
equivalence* under list-append semantics (each with its justification),
and which must degrade the verdict to `"unknown"` with an
`unchecked-anomalies` list.  The rw-register checker has its own inline
session handling (`rw_register.check`); its vocabulary is natively
rw-shaped so no equivalence map is needed there.

Reference: `elle/consistency_model.clj` defines the token lattice; the
reference checker itself silently ignores unknown tokens — this contract
is deliberately stricter (an oracle that cannot look must say so).
"""

from __future__ import annotations

from typing import Any, Dict, Set, Tuple

from jepsen_tpu_torch.checkers.elle.specs import SPEC_ORDER

#: non-cycle anomaly counts device/host list-append inference produces
LA_COUNT_TOKENS = frozenset({
    "duplicate-appends", "duplicate-elements", "incompatible-order",
    "G1a", "G1b", "dirty-update", "internal",
})

#: foreign-vocabulary tokens covered by a searched family under
#: list-append semantics.  Every entry must carry its justification:
#:
#: - aborted-read / intermediate-read: the rw-register names for G1a /
#:   G1b; the la counts are exactly those checks over append values.
#: - duplicate-writes: rw name for duplicate-appends.
#: - cyclic-versions: a version-order contradiction; la version orders
#:   come from the longest read, so a contradiction surfaces as
#:   incompatible-order (reads disagreeing with the inferred order).
#: - lost-update: two txns updating one observed version.  Appends
#:   cannot lose updates (every committed append lands in the list);
#:   the conflict shape surfaces as ww/rw cycles (G-single family).
#: - G2: full Adya G2 adds predicate anti-dependencies; list-append
#:   has no predicate reads, so G2 == G2-item here (the reference's
#:   treatment on this workload).
#: - fractured-read: reading part of a txn's atomic writes — with
#:   append semantics the missing fragment is a reader<-writer rw edge
#:   against a wr edge, i.e. a G-single cycle; the length/content side
#:   is `internal`.
#: - monotonic-atomic-view-violation: MAV breaks are fractured reads
#:   observed after a first fragment — the identical G-single/internal
#:   shape as fractured-read above.
#: - G-SI / G-SIa / G-SIb / G-monotonic / G-MSR / G-update / G-cursor:
#:   specialized cycle taxa inside the ww∪wr∪rw(∪realtime) edge
#:   vocabulary.  Every one of them is a cycle in a projection this
#:   checker sweeps, so on a valid history (all projections acyclic)
#:   they are definitively absent; when a cycle exists the broader
#:   family (G-single / G1c / G2-item ± realtime) reports it and the
#:   verdict is already False.  This matches the reference checker's
#:   practical SI boundary (G-single + lost-update) on this workload.
LA_EQUIV_COVERED = frozenset({
    "aborted-read", "intermediate-read", "duplicate-writes",
    "cyclic-versions", "lost-update", "G2", "fractured-read",
    "monotonic-atomic-view-violation",
    "G-SI", "G-SIa", "G-SIb", "G-monotonic", "G-MSR", "G-update",
    "G-cursor",
})

_SUFFIX = "-violation"


def _session_tokens(want: Set[str]) -> Set[str]:
    from jepsen_tpu_torch.checkers.elle import sessions

    return {w for w in want if w.endswith(_SUFFIX)
            and w[:-len(_SUFFIX)] in sessions.GUARANTEES}


def run_la_sessions(history, want: Set[str], packed_input: bool,
                    max_reported: int = 8) -> Tuple[Dict[str, Any], bool]:
    """Run the session-guarantee checker for requested session tokens on
    an op-level list-append history.  Returns (anomalies, checked).

    A PackedTxns-only caller cannot be session-checked (the packed form
    drops the op-level view the session walker needs) — `checked` stays
    False and `finalize_la` degrades the verdict unless process-edge
    cycle coverage applies (see there).
    """
    sess_want = _session_tokens(want)
    if not sess_want or packed_input:
        return {}, False
    from jepsen_tpu_torch.checkers.elle import sessions

    res = sessions.check_la(
        history, guarantees=[w[:-len(_SUFFIX)] for w in sess_want],
        max_reported=max_reported)
    return res["anomalies"], True


def unchecked_for_la(want: Set[str], sess_checked: bool) -> list:
    """Requested tokens the list-append pipeline did not and cannot
    search this call."""
    searched = LA_COUNT_TOKENS | set(SPEC_ORDER) | LA_EQUIV_COVERED
    sess_want = _session_tokens(want)
    if sess_checked or "G-single-process" in want:
        # per-session ordering violations surface as process-edge cycles
        # in the transactional graph (the reference's own treatment), so
        # a strict/strong-session-class request keeps its verdict even
        # on packed input; a BARE session request does not.  Only the
        # G-single-process family qualifies: read-centric violations
        # (monotonic-reads, RYW) need anti-dependency (rw) edges, which
        # G0-process/G1c-process projections do not search
        searched |= sess_want
    return sorted(want - searched)


def apply_unchecked(result: Dict[str, Any], unchecked) -> Dict[str, Any]:
    """The degradation rule, shared by every checker: surface the
    unchecked list, and downgrade a would-be `valid?: True` to
    `"unknown"` (an oracle that cannot look must say so)."""
    if unchecked:
        result["unchecked-anomalies"] = sorted(unchecked)
        if result["valid?"] is True:
            result["valid?"] = "unknown"
    return result


def finalize_la(result: Dict[str, Any], want: Set[str],
                sess_checked: bool) -> Dict[str, Any]:
    """Apply the coverage contract to a finished list-append verdict."""
    return apply_unchecked(result, unchecked_for_la(want, sess_checked))
