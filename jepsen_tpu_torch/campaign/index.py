"""The campaign results database: an append-only jsonl ledger (the
port's copy of `jepsen_tpu/campaign/index.py`).

One file per campaign (``<store>/campaigns/<name>.jsonl``), one JSON
record per completed run, fsync'd on append — the same durability and
torn-line story as `parallel.batch.check_batch_checkpointed`'s
checkpoints and the original `scripts/tpu_campaign.py` stage ledger: a
crash mid-append leaves at most one torn trailing line, which a reload
drops (and truncates) before resuming.

Records are keyed two ways:

- ``run`` — the RunSpec's stable run id.  A run id with a verdict on
  file is *complete*; `run_campaign` skips it on restart (resume).
- ``key`` — ``workload|fault|seed``, stable across spec-opt tweaks and
  campaign generations; the regression-query key.

Each record carries the verdict (``valid?``), attribution (``error``,
``degraded``, ``deadline``), the run's store dir, wall time, and — for
telemetric runs — per-span checker durations pulled from the run's
``telemetry.json``, which powers the "checker p95 span duration trend"
query (:meth:`Index.span_trend`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Index", "witness_pair_diffs", "verdict_counts_over"]


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile over a non-empty list (stdlib-only)."""
    s = sorted(xs)
    i = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[i]


def verdict_counts_over(latest: Iterable[Dict[str, Any]]
                        ) -> Dict[str, int]:
    """The verdict histogram over latest-per-run records — ONE
    counting rule shared by the jsonl scan and the warehouse fast path
    (and its /metrics rollups), so the classification can't drift
    between backends."""
    counts = {"true": 0, "false": 0, "unknown": 0,
              "degraded": 0, "deadline": 0}
    for r in latest:
        v = r.get("valid?")
        counts["true" if v is True else
               "false" if v is False else "unknown"] += 1
        if r.get("degraded"):
            counts["degraded"] += 1
        if r.get("deadline"):
            counts["deadline"] += 1
    return counts


def witness_pair_diffs(by_key: Dict[str, List[Dict[str, Any]]]
                       ) -> List[Dict[str, Any]]:
    """The witness-drift diff over consecutive witness-bearing records
    per key.  Input: key → records (each holding ``gen`` + a
    ``witness`` dict), in append order.  ONE implementation shared by
    the jsonl scan and the warehouse fast path, so the two backends
    can't drift."""
    out: List[Dict[str, Any]] = []
    for key, recs in sorted(by_key.items()):
        for prev, cur in zip(recs[:-1], recs[1:]):
            pw, cw = prev["witness"], cur["witness"]
            pa = set(pw.get("anomaly-types") or ())
            ca = set(cw.get("anomaly-types") or ())
            p_ops, c_ops = pw.get("ops") or 0, cw.get("ops") or 0
            out.append({
                "key": key,
                "from-gen": prev.get("gen"), "to-gen": cur.get("gen"),
                "from-ops": p_ops, "to-ops": c_ops,
                "ops-delta": c_ops - p_ops,
                "from-digest": pw.get("digest"),
                "to-digest": cw.get("digest"),
                "digest-changed": pw.get("digest") != cw.get("digest"),
                "anomalies-added": sorted(ca - pa),
                "anomalies-removed": sorted(pa - ca),
                "changed": (pw.get("digest") != cw.get("digest")
                            or pa != ca or p_ops != c_ops),
            })
    return out


class Index:
    """In-memory view over one campaign's jsonl ledger.

    Loading tolerates a torn trailing record (crash mid-append): the
    first unparsable or unterminated line and everything after it are
    dropped from the in-memory view, like the batch checkpoint reader.
    The FILE is only healed (truncated back to the last durable record)
    lazily on the next :meth:`append` — read-only consumers (the web
    dashboard, `campaign status`) must never truncate, because their
    "torn line" may just be a live writer's append in flight.

    Loading is LAZY, because the regression/trend queries have a
    warehouse fast path (docs/TELEMETRY.md): when ``<store>/
    warehouse.sqlite`` exists and fully covers this ledger (ingest
    cursor == file size), ``flips``/``regressions``/``span_stats``/
    ``span_trend``/``witness_diffs``/``verdict_counts``/
    ``latest_by_run`` answer from indexed SQL without parsing the
    jsonl at all.  A stale or absent warehouse falls back to the scan
    — the ledger stays the source of truth either way.
    """

    def __init__(self, path: str, use_warehouse: bool = True):
        self.path = path
        self.use_warehouse = use_warehouse
        self._records: Optional[List[Dict[str, Any]]] = None
        self._load_lock = threading.Lock()
        #: byte offset of the last durable record seen at load; a
        #: resuming WRITER truncates to it before its first append
        self._good_bytes: Optional[int] = None
        self._wh: Optional[tuple] = None  # cached (warehouse, rel)
        self._wh_resolved = False
        self._wh_compacted = False

    @property
    def records(self) -> List[Dict[str, Any]]:
        if self._records is None:
            with self._load_lock:
                if self._records is None:
                    self._load()
        return self._records

    #: queries a COMPACTED ledger's warehouse still answers exactly:
    #: their rollup rows (flip_rollup / span_gen_rollup / the kept
    #: witness records) survive compaction untouched.  Everything else
    #: lost its raw rows and must fall back to the jsonl scan.
    _COMPACT_SAFE = frozenset({"flips", "span_trend", "witness_diffs"})

    def _warehouse(self, query: Optional[str] = None):
        """(warehouse, ledger-rel) when the SQL fast path may answer
        for this ledger, else None.  Resolved (freshness-checked) once
        per Index and cached — the same point-in-time semantics as the
        one-shot jsonl load — and invalidated by :meth:`append`, which
        makes the warehouse stale by definition.  ``query`` gates
        per-query on compaction: once a ledger's raw rows were folded
        past the generation horizon, only the ``_COMPACT_SAFE`` queries
        keep the SQL path.  The warehouse is a derived index, so an
        error opening it sends the query to the jsonl scan."""
        if not self.use_warehouse:
            return None
        if not self._wh_resolved:
            try:
                from jepsen_tpu_torch.telemetry import warehouse as wmod

                self._wh = wmod.for_ledger(self.path)
                self._wh_compacted = bool(
                    self._wh is not None and
                    self._wh[0].ledger_compacted(self._wh[1]))
            except Exception:  # noqa: BLE001 — fast path, never fail
                self._wh = None
                self._wh_compacted = False
            self._wh_resolved = True
        if self._wh_compacted and query not in self._COMPACT_SAFE:
            return None
        return self._wh

    # -- persistence --------------------------------------------------------

    def _load(self) -> None:
        recs: List[Dict[str, Any]] = []
        if not os.path.exists(self.path):
            self._records = recs
            return
        good_bytes = 0
        torn = False
        with open(self.path, "rb") as f:
            for line in f:
                if not line.strip():
                    good_bytes += len(line)
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    torn = True  # torn trailing record
                    break
                if not line.endswith(b"\n"):
                    torn = True  # parseable but unterminated: a later
                    break        # append would fuse with it
                recs.append(rec)
                good_bytes += len(line)
        # arm the heal only on an OBSERVED torn line — never because the
        # file merely grew between our read and now (that's a concurrent
        # writer's complete record, which truncation would destroy)
        if torn:
            self._good_bytes = good_bytes
        self._records = recs

    def append(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Durably append one record (fsync'd) and index it.  If the
        load saw a torn tail, the writer truncates it away first so the
        new record can't fuse with crash debris."""
        rec = dict(rec)
        rec.setdefault("ts", time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()))
        recs = self.records  # force the load: the heal check below
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self._good_bytes is not None:
            with open(self.path, "r+b") as f:
                f.truncate(self._good_bytes)
            self._good_bytes = None
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        recs.append(rec)
        # the append outdated any warehouse coverage of this ledger:
        # re-resolve (and re-check freshness) on the next query
        self._wh, self._wh_resolved = None, False
        return rec

    # -- resume -------------------------------------------------------------

    def completed_ids(self) -> set:
        """Run ids that already hold an attributable verdict — skipped
        on resume.  Any verdict counts (True / False / "unknown"): the
        contract is *attributable termination*, not success."""
        return {r["run"] for r in self.records if "valid?" in r}

    def latest(self, run_id: str) -> Optional[Dict[str, Any]]:
        for r in reversed(self.records):
            if r.get("run") == run_id:
                return r
        return None

    def by_key(self) -> Dict[str, List[Dict[str, Any]]]:
        """Records grouped by regression key, in append order."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for r in self.records:
            if "valid?" in r and r.get("key"):
                out.setdefault(r["key"], []).append(r)
        return out

    # -- regression queries -------------------------------------------------

    def flips(self) -> List[Dict[str, Any]]:
        """Verdict flips per key: every consecutive pair of records for
        the same (workload, fault, seed) whose ``valid?`` changed.
        ``regression`` marks the bad direction (away from True) — the
        "which (workload, seed) flipped valid? since the last campaign"
        query."""
        wh = self._warehouse("flips")
        if wh is not None:
            return wh[0].flips(wh[1])
        out: List[Dict[str, Any]] = []
        for key, recs in sorted(self.by_key().items()):
            for prev, cur in zip(recs[:-1], recs[1:]):
                if prev.get("valid?") != cur.get("valid?"):
                    out.append({
                        "key": key,
                        "run": cur.get("run"),
                        "from": prev.get("valid?"),
                        "to": cur.get("valid?"),
                        "regression": prev.get("valid?") is True,
                        "when": cur.get("ts"),
                        "gen": cur.get("gen"),
                    })
        return out

    def regressions(self) -> List[Dict[str, Any]]:
        return [f for f in self.flips() if f["regression"]]

    def witness_diffs(self) -> List[Dict[str, Any]]:
        """Per-key witness comparison across campaign generations
        for every consecutive pair of auto-shrunk
        records under the same ``workload|fault|seed`` key, the
        op-count / digest / anomaly-set deltas.  A digest change with
        an unchanged spec is the "the minimal repro MOVED" signal — a
        different failure than last generation, even when the verdict
        column still just says False."""
        wh = self._warehouse("witness_diffs")
        if wh is not None:
            return witness_pair_diffs(wh[0].witness_records(wh[1]))
        by_key: Dict[str, List[Dict[str, Any]]] = {}
        for r in self.records:
            w = r.get("witness")
            if isinstance(w, dict) and w.get("ops") and r.get("key"):
                by_key.setdefault(r["key"], []).append(r)
        return witness_pair_diffs(by_key)

    # -- telemetry aggregates ----------------------------------------------

    def _span_values(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for r in self.records:
            for name, dur in (r.get("spans") or {}).items():
                if isinstance(dur, (int, float)):
                    out.setdefault(name, []).append(float(dur))
        return out

    def span_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-span duration aggregates across every indexed run:
        count / min / p50 / p95 / max (seconds)."""
        wh = self._warehouse("span_stats")
        if wh is not None:
            return wh[0].span_stats(wh[1])
        return {
            name: {
                "count": len(vals),
                "min": round(min(vals), 6),
                "p50": round(_percentile(vals, 50), 6),
                "p95": round(_percentile(vals, 95), 6),
                "max": round(max(vals), 6),
            }
            for name, vals in sorted(self._span_values().items())
        }

    def span_samples(self, name: str
                     ) -> List[Tuple[Optional[str], float]]:
        """(gen, duration) samples for one span name, in append order —
        the material for :meth:`span_trend` and the ``cli obs gate``
        regression gate."""
        wh = self._warehouse("span_samples")
        if wh is not None:
            return wh[0].span_samples(wh[1], name)
        out: List[Tuple[Optional[str], float]] = []
        for r in self.records:
            dur = (r.get("spans") or {}).get(name)
            if isinstance(dur, (int, float)):
                out.append((r.get("gen"), float(dur)))
        return out

    def span_trend(self, name: str) -> List[Tuple[str, float]]:
        """p95 of one span per campaign generation, in first-seen gen
        order — the "checker p95 span duration trend" query.  The
        warehouse answers from its materialized per-generation rollup;
        the jsonl path recomputes from the raw samples."""
        wh = self._warehouse("span_trend")
        if wh is not None:
            return wh[0].span_trend(wh[1], name)
        by_gen: Dict[str, List[float]] = {}
        order: List[str] = []
        for gen, dur in self.span_samples(name):
            g = str(gen or "?")
            if g not in by_gen:
                order.append(g)
            by_gen.setdefault(g, []).append(dur)
        return [(g, round(_percentile(by_gen[g], 95), 6)) for g in order]

    def forensic_records(self) -> List[tuple]:
        """``(gen, spans, phases, counters)`` per record in append
        order — the backend-shared input of
        :mod:`jepsen_tpu_torch.telemetry.forensics` (``obs diff`` / ``obs
        gate --explain``).  Warehouse and jsonl scan MUST return the
        identical shape so both paths reach the same verdict."""
        wh = self._warehouse("forensic_records")
        if wh is not None:
            return wh[0].forensic_records(wh[1])
        return [(r.get("gen"), r.get("spans") or {},
                 r.get("phases") or {}, r.get("counters") or {})
                for r in self.records]

    def profile(self) -> List[Dict[str, Any]]:
        """Per-(site, shape-class, host) device-call profile aggregated
        over the campaign's run dirs — ``cli obs profile``'s data.
        Warehouse-backed from the ``span_profile`` table when fresh;
        the fallback re-reads each run dir's telemetry.json through the
        same extraction (``forensics.profile_from_doc``)."""
        wh = self._warehouse("profile")
        if wh is not None:
            return wh[0].campaign_profile(wh[1])
        from jepsen_tpu_torch.telemetry.forensics import profile_rows_from_dirs

        base = os.path.dirname(os.path.dirname(os.path.abspath(self.path)))
        dirs, seen = [], set()
        for r in self.records:
            d = r.get("dir")
            if d and d not in seen:
                seen.add(d)
                dirs.append(d)
        return profile_rows_from_dirs(base, dirs)

    # -- rollups ------------------------------------------------------------

    def latest_by_run(self) -> Dict[str, Dict[str, Any]]:
        """The LATEST verdict-bearing record per run id — what the web
        campaign grid renders.  Warehouse-backed when fresh; NOTE the
        warehouse path reconstructs the grid PROJECTION (run/key/
        workload/fault/seed/valid?/error/degraded/deadline/dir/ops/
        wall_s/gen/ts/witness) — per-span durations stay in
        :meth:`span_stats`/:meth:`span_samples`, not here."""
        wh = self._warehouse("latest_by_run")
        if wh is not None:
            return wh[0].latest_by_run(wh[1])
        latest: Dict[str, Dict[str, Any]] = {}
        for r in self.records:
            if "valid?" in r and r.get("run"):
                latest[r["run"]] = r
        return latest

    def verdict_counts(self, runs: Optional[Iterable[str]] = None
                       ) -> Dict[str, int]:
        """Verdict histogram over the LATEST record per run id.  Built
        on :meth:`latest_by_run` so both backends share ONE
        record-selection rule (verdict-bearing, truthy run id)."""
        latest = dict(self.latest_by_run())
        if runs is not None:
            wanted = set(runs)
            latest = {k: v for k, v in latest.items() if k in wanted}
        return verdict_counts_over(latest.values())
