"""Port parity for the observatory: `jepsen_tpu_torch/telemetry/
warehouse.py`, `prometheus.py`, the warehouse paths of `campaign/index`
and `campaign/core`, and the CLI's `obs` and `tail --since`, against the
JAX package's on the CPU.

The spec is the JAX package's `tests/test_warehouse.py`.  Each scenario
runs once with each package's modules, on equal inputs in stores of its
own, asserts the spec's contract in both, and the two observations must
be equal: ingest counts and cursors, the SQL answers against the jsonl
scans, compaction, rollups, the alert signals and the statements they
run, the event table, verifier sessions, the schema migration, `obs`'s
exit codes and output, and the exposition, which is also held byte for
byte against `tests/data/prometheus-golden.txt`.  Then a store that the
port's campaign wrote on the CPU (two generations of seeded `append`
cells with telemetry, one cell with an injected G1c and its auto-shrunk
witness) is ingested by both warehouses: every table, every `Index`
answer and `counts()` are equal, and `tail --since` through the port's
warehouse prints what the stream scan prints.  The spec's timing pins
(the 10x speedups) and `bench.py`'s self-ingest have no counterpart: the
port has no benchmark yet.
"""

import json
import os
import random
import shutil
import sqlite3
import time
import types

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu.campaign.index import Index as JIndex  # noqa: E402
from jepsen_tpu.telemetry import alerts as jalerts  # noqa: E402
from jepsen_tpu.telemetry import gate as jgate  # noqa: E402
from jepsen_tpu.telemetry import metrics as jmetrics  # noqa: E402
from jepsen_tpu.telemetry import prometheus as jprom  # noqa: E402
from jepsen_tpu.telemetry import stream as jstream  # noqa: E402
from jepsen_tpu.telemetry import warehouse as jwh  # noqa: E402
from jepsen_tpu.verifier import VerifierService as JVerifier  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import __main__ as tmain  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch.campaign import core as tcc  # noqa: E402
from jepsen_tpu_torch.campaign import plan as tplan  # noqa: E402
from jepsen_tpu_torch.campaign.index import Index as TIndex  # noqa: E402
from jepsen_tpu_torch.generator import core as tgen  # noqa: E402
from jepsen_tpu_torch.telemetry import alerts as talerts  # noqa: E402
from jepsen_tpu_torch.telemetry import gate as tgate  # noqa: E402
from jepsen_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from jepsen_tpu_torch.telemetry import prometheus as tprom  # noqa: E402
from jepsen_tpu_torch.telemetry import stream as tstream  # noqa: E402
from jepsen_tpu_torch.telemetry import warehouse as twh  # noqa: E402
from jepsen_tpu_torch.verifier import VerifierService as TVerifier  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402
from jepsen_tpu_torch.workloads.append import AppendChecker  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "prometheus-golden.txt")

PKGS = {
    "jax": types.SimpleNamespace(
        cli=jcli, Index=JIndex, wmod=jwh, gate=jgate, metrics=jmetrics,
        prometheus=jprom, stream=jstream, alerts=jalerts,
        Verifier=JVerifier, synth=jsynth),
    "torch": types.SimpleNamespace(
        cli=tcli, Index=TIndex, wmod=twh, gate=tgate, metrics=tmetrics,
        prometheus=tprom, stream=tstream, alerts=talerts,
        Verifier=lambda base: TVerifier(base, device="cpu"),
        synth=tsynth),
}


def both(tmp_path, scenario):
    """Run `scenario(P, base)` with each package's modules in a store of
    its own; the two observations must be equal.  Returns the port's."""
    out = {}
    for name, P in PKGS.items():
        base = tmp_path / name
        base.mkdir()
        out[name] = scenario(P, base)
    assert out["torch"] == out["jax"]
    return out["torch"]


# ------------------------------------------------------------ helpers
# (the spec's own helpers: the same synthetic ledgers and run dirs)

def _write_ledger(base, name="soak", gens=("g1", "g2"), n=20,
                  scale=None, seed=0, witness_every=0, flip_every=0):
    """A synthetic campaign ledger: ``n`` runs per generation, span
    durations ~U(0.9, 1.1) * scale[gen]."""
    scale = scale or {}
    cdir = os.path.join(str(base), "campaigns")
    os.makedirs(cdir, exist_ok=True)
    path = os.path.join(cdir, name + ".jsonl")
    rng = random.Random(seed)
    with open(path, "a") as f:
        for gen in gens:
            m = scale.get(gen, 1.0)
            for i in range(n):
                rec = {
                    "campaign": name, "run": f"r-{gen}-{i}",
                    "key": f"la|none|{i}", "workload": "la",
                    "fault": None, "seed": i,
                    "valid?": (False if flip_every and gen != gens[0]
                               and i % flip_every == 0 else True),
                    "dir": f"d/{gen}/{i}", "ops": 100,
                    "wall_s": round(rng.uniform(5, 20), 2), "gen": gen,
                    "ts": "2026-08-03T00:00:00Z",
                    "spans": {
                        "check:la": round(rng.uniform(0.9, 1.1) * m, 6),
                        "workload": round(rng.uniform(1, 3), 6),
                    },
                }
                if witness_every and i % witness_every == 0:
                    rec["witness"] = {
                        "ops": 2 + (i + (0 if gen == gens[0] else 1)) % 5,
                        "digest": f"w{(i + len(gen)) % 3}",
                        "anomaly-types": ["G1c"]}
                f.write(json.dumps(rec) + "\n")
    return path


def _fresh(P, base, path):
    wh = P.wmod.open_or_create(str(base))
    wh.ingest_ledger(path, str(base))
    return wh


def _mk_run(base, name, ts, valid=True, telemetry=True, witness=False,
            events=None, torn_events=False):
    d = os.path.join(str(base), name, ts)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid?": valid}, f)
    if telemetry:
        with open(os.path.join(d, "telemetry.json"), "w") as f:
            json.dump({
                "spans": [{"name": "run", "dur_ns": 2_000_000_000,
                           "children": [{"name": "check:la",
                                         "dur_ns": 500_000_000}]}],
                "metrics": {"counters": [{"name": "ops-ok", "labels": {},
                                          "value": 42}],
                            "gauges": [], "histograms": []},
            }, f)
    if witness:
        with open(os.path.join(d, "witness.json"), "w") as f:
            json.dump({"ops": 4, "source-ops": 100, "digest": "wd",
                       "anomaly-types": ["G1c"], "probes": 9}, f)
    if events is not None:
        with open(os.path.join(d, "events.jsonl"), "w") as f:
            for i in range(events):
                f.write(json.dumps({"t": 100.0 + i, "ev": "tick",
                                    "i": i}) + "\n")
            if torn_events:
                f.write('{"t": 999.0, "ev": "to')  # crash mid-append
    return d


def _queries(idx):
    """Every `Index` query the warehouse can answer, as one value."""
    names = sorted(idx.span_stats())
    return {
        "flips": idx.flips(), "regressions": idx.regressions(),
        "span_stats": idx.span_stats(),
        "span_trend": {n: idx.span_trend(n) for n in names},
        "span_samples": {n: idx.span_samples(n) for n in names},
        "witness_diffs": idx.witness_diffs(),
        "verdict_counts": idx.verdict_counts(),
        "forensic_records": idx.forensic_records(),
        "profile": idx.profile(),
    }


def _same_answers(fast, slow, n_dirs):
    """The warehouse's answers against the scan's: equal, but for the
    profile's summed times.  The warehouse stores each run dir's times
    rounded to 6 decimals and sums those, the scan sums the unrounded
    times and rounds once (in both packages), so over `n_dirs` run dirs
    the two differ by at most (n_dirs + 1) half units of the 6th
    decimal; calls and keys are equal."""
    keys = ("site", "shape", "host", "calls")
    fp, sp = fast.pop("profile"), slow.pop("profile")
    assert fast == slow
    assert [{k: r[k] for k in keys} for r in fp] == \
        [{k: r[k] for k in keys} for r in sp]
    for a, b in zip(fp, sp):
        for k in ("compile_s", "execute_s", "device_dispatch_s"):
            assert abs(a[k] - b[k]) <= (n_dirs + 1) * 0.5e-6 + 1e-12, \
                (k, a, b)
    fast["profile"], slow["profile"] = fp, sp


#: the grid projection `latest_by_run` answers from SQL (the spec's
#: field list): the jsonl scan returns whole records
GRID = ("run", "key", "workload", "fault", "seed", "valid?", "dir", "ops",
        "wall_s", "gen", "ts", "witness")


def _grid(idx):
    return {run: {k: r.get(k) for k in GRID}
            for run, r in idx.latest_by_run().items()}


# ------------------------------------------------- incremental ingest

def test_ingest_is_cursor_incremental(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=10)
        wh = P.wmod.open_or_create(str(base))
        seen = [wh.ingest_ledger(path, str(base)),
                wh.ingest_ledger(path, str(base)),
                wh.ledger_fresh(path, str(base))]
        _write_ledger(base, gens=("g3",), n=5)
        seen += [wh.ingest_ledger(path, str(base)), wh.counts()]
        assert seen[:3] == [20, 0, True] and seen[3] == 5
        assert seen[4]["campaign_records"] == 25
        return seen

    both(tmp_path, scenario)


def test_torn_tail_left_unconsumed_until_healed(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=3)
        with open(path, "a") as f:
            f.write('{"run": "torn", "valid?": tru')  # no newline
        wh = P.wmod.open_or_create(str(base))
        seen = [wh.ingest_ledger(path, str(base)),
                wh.ledger_fresh(path, str(base)),
                P.Index(path)._warehouse() is None]
        with open(path, "a") as f:
            f.write('e, "key": "k", "gen": "g9"}\n')
        seen += [wh.ingest_ledger(path, str(base)),
                 wh.ledger_fresh(path, str(base))]
        assert seen == [6, False, True, 1, True]
        return seen

    both(tmp_path, scenario)


def test_shrunken_ledger_wiped_and_reingested(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=10)
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_ledger(path, str(base))
        lines = open(path).readlines()
        with open(path, "w") as f:
            f.writelines(lines[:7])
        wh.ingest_ledger(path, str(base))
        assert wh.counts()["campaign_records"] == 7
        flips = P.Index(path).flips()
        assert flips == P.Index(path, use_warehouse=False).flips()
        return wh.counts(), flips

    both(tmp_path, scenario)


def test_mid_ingest_crash_rolls_back_whole_unit(tmp_path, monkeypatch):
    def scenario(P, base):
        path = _write_ledger(base, n=10)
        wh = P.wmod.open_or_create(str(base))
        real = P.wmod.Warehouse._insert_record
        calls = []

        def dying(self, ledger, rec):
            if len(calls) == 12:
                raise RuntimeError("simulated crash mid-ingest")
            calls.append(rec)
            return real(self, ledger, rec)

        monkeypatch.setattr(P.wmod.Warehouse, "_insert_record", dying)
        with pytest.raises(RuntimeError):
            wh.ingest_ledger(path, str(base))
        monkeypatch.setattr(P.wmod.Warehouse, "_insert_record", real)
        seen = [wh.counts()["campaign_records"],
                wh.ledger_fresh(path, str(base)),
                wh.ingest_ledger(path, str(base)),
                wh.ledger_fresh(path, str(base))]
        assert seen == [0, False, 20, True]
        return seen

    both(tmp_path, scenario)


# -------------------------------------------- fast path == jsonl scan

def test_sql_queries_equal_jsonl_scan(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=30, scale={"g2": 1.4},
                             witness_every=4, flip_every=5)
        _fresh(P, base, path)
        slow = P.Index(path, use_warehouse=False)
        fast = P.Index(path)
        assert fast._warehouse() is not None, "fast path not engaged"
        q = _queries(fast)
        assert q == _queries(slow)
        assert _grid(fast) == _grid(slow)
        return q, _grid(fast)

    both(tmp_path, scenario)


def test_runless_and_empty_run_records_agree_across_backends(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=4)
        with open(path, "a") as f:
            f.write(json.dumps({"campaign": "soak", "key": "k-norun",
                                "valid?": False, "gen": "g2"}) + "\n")
            f.write(json.dumps({"campaign": "soak", "run": "",
                                "key": "k-e", "valid?": False,
                                "gen": "g2"}) + "\n")
        _fresh(P, base, path)
        slow = P.Index(path, use_warehouse=False)
        fast = P.Index(path)
        assert fast._warehouse() is not None
        assert set(fast.latest_by_run()) == set(slow.latest_by_run())
        assert fast.verdict_counts() == slow.verdict_counts()
        assert slow.verdict_counts()["false"] == 0
        return sorted(fast.latest_by_run()), fast.verdict_counts()

    both(tmp_path, scenario)


def test_corrupt_midfile_event_line_same_prefix_both_backends(tmp_path):
    def scenario(P, base):
        d = _mk_run(base, "a-test", "t9", events=5)
        p = os.path.join(d, "events.jsonl")
        with open(p, "a") as f:
            f.write('{"t": 200.0, "ev": "corrupt"\n')  # complete, bad JSON
            f.write(json.dumps({"t": 201.0, "ev": "tick", "i": 99}) + "\n")
        wh = P.wmod.open_or_create(str(base))
        n = wh.ingest_events(d, str(base))
        got = [e.get("i") for e in wh.events_since(d, str(base))]
        assert got == [e.get("i") for e in P.stream.read_events(p)]
        assert n == 5 and not wh.events_fresh(d, str(base))
        assert wh.ingest_events(d, str(base)) == 0
        return n, got

    both(tmp_path, scenario)


def test_stale_warehouse_falls_back_to_scan(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=5, flip_every=2)
        _fresh(P, base, path)
        assert P.Index(path)._warehouse() is not None
        idx = P.Index(path)
        idx.append({"run": "r-new", "key": "la|none|0", "valid?": True,
                    "gen": "g3"})
        assert idx._warehouse() is None
        flips = idx.flips()
        assert any(f["run"] == "r-new" for f in flips)
        assert P.Index(path)._warehouse() is None
        assert P.Index(path).flips() == flips
        return [{k: v for k, v in f.items() if k != "ts"} for f in flips]

    both(tmp_path, scenario)


def test_batched_ingest_equivalent_and_fewer_commits(tmp_path):
    def scenario(P, base):
        for sub in ("a", "b"):
            b = base / sub
            os.makedirs(b)
            for i in (1, 2, 3):
                _write_ledger(b, name=f"s{i}", n=8, flip_every=3, seed=i)

        def commits(wh, fn):
            seen = []
            wh.db.set_trace_callback(
                lambda s: seen.append(s) if "COMMIT" in s.upper() else None)
            try:
                fn()
            finally:
                wh.db.set_trace_callback(None)
            return len(seen)

        wa = P.wmod.open_or_create(str(base / "a"))
        wb = P.wmod.open_or_create(str(base / "b"))
        na = commits(wa, lambda: wa.ingest_store(
            str(base / "a"), events=False, batch_units=1))
        nb = commits(wb, lambda: wb.ingest_store(
            str(base / "b"), events=False, batch_units=64))
        assert wa.counts() == wb.counts()
        flips = []
        for name in ("s1", "s2", "s3"):
            pa, pb = (os.path.join(str(base / s), "campaigns",
                                   name + ".jsonl") for s in ("a", "b"))
            assert P.Index(pa).flips() == P.Index(pb).flips()
            flips.append(P.Index(pa).flips())
        assert nb < na, (na, nb)
        again = wb.ingest_store(str(base / "b"), events=False)
        assert again["records"] == 0
        return na, nb, wa.counts(), flips, again

    both(tmp_path, scenario)


def test_compaction_parity_for_safe_queries(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, gens=("g1", "g2", "g3", "g4"), n=30,
                             scale={"g4": 1.3}, flip_every=7,
                             witness_every=10)
        wh = _fresh(P, base, path)
        idx = P.Index(path)
        before = (idx.flips(), idx.span_trend("check:la"),
                  idx.witness_diffs())
        n_before = wh.counts()["campaign_records"]
        stats = wh.compact_ledger(path, str(base), keep_gens=2)
        assert stats["gens-compacted"] == 2
        assert stats["dropped-records"] > 0 and stats["kept-witnesses"] > 0
        rel = os.path.relpath(path, str(base))
        assert wh.ledger_compacted(rel)
        assert wh.counts()["campaign_records"] < n_before
        idx2 = P.Index(path)
        after = (idx2.flips(), idx2.span_trend("check:la"),
                 idx2.witness_diffs())
        assert after == before
        scan = P.Index(path, use_warehouse=False)
        assert after == (scan.flips(), scan.span_trend("check:la"),
                         scan.witness_diffs())
        assert idx2._warehouse("flips") is not None
        assert idx2._warehouse("span_stats") is None
        assert idx2.span_stats() == scan.span_stats()
        again = wh.ingest_store(str(base), events=False)
        assert again["records"] == 0
        return stats, after, wh.counts()

    both(tmp_path, scenario)


def test_flip_detection_across_compaction_horizon(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, gens=("g1", "g2"), n=12, flip_every=5)
        wh = _fresh(P, base, path)
        wh.compact_ledger(path, str(base), keep_gens=0)
        assert wh.counts()["campaign_records"] == 0
        _write_ledger(base, gens=("g3",), n=12, flip_every=4)
        wh.ingest_store(str(base), events=False)
        flips = P.Index(path).flips()
        assert flips == P.Index(path, use_warehouse=False).flips()
        return flips

    both(tmp_path, scenario)


def test_alert_signals_touch_rollup_tables_only(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, gens=("g1", "g2"), n=25, flip_every=6)
        wh = _fresh(P, base, path)
        stmts = []
        wh.db.set_trace_callback(stmts.append)
        try:
            sig = wh.alert_signals()
        finally:
            wh.db.set_trace_callback(None)
        for s in stmts:
            assert "campaign_records" not in s.lower(), s
            assert "record_spans" not in s.lower(), s
        assert sig["flips"] > 0 and sig["span-p95-s:check:la"] > 0
        wh.compact_ledger(path, str(base), keep_gens=1)
        sig2 = wh.alert_signals()
        assert sig2["flips"] == sig["flips"]
        assert sig2["compacted-gens"] == 1.0
        return stmts, sig, sig2

    both(tmp_path, scenario)


# ------------------------------------------------- run dirs + rebuild

def test_run_dir_ingest_digest_noop_and_missing_artifacts(tmp_path):
    def scenario(P, base):
        d = _mk_run(base, "a-test", "t1", witness=True)
        _mk_run(base, "a-test", "t2", valid=False, telemetry=False)
        wh = P.wmod.open_or_create(str(base))
        stats = [wh.ingest_store(str(base)), wh.ingest_store(str(base))]
        assert stats[0]["runs"] == 2
        assert stats[1] == {"ledgers": 0, "records": 0, "runs": 0,
                            "events": 0, "sessions": 0,
                            "fleet-events": 0, "archived": 0}
        c = wh.counts()
        assert c["runs"] == 2 and c["witnesses"] == 1
        assert c["run_spans"] == 2
        rel = os.path.relpath(d, str(base))
        spans = {n: (t, k) for n, t, k in wh.run_spans(rel)}
        assert spans["run"] == (2.0, 1) and spans["check:la"] == (0.5, 1)
        time.sleep(0.01)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump({"valid?": "unknown", "error": "x"}, f)
        stats.append(wh.ingest_store(str(base)))
        assert stats[2]["runs"] == 1
        roll = wh.rollups()["runs_by_verdict"]
        assert roll == {"false": 1, "unknown": 1}
        return stats, c, spans, roll

    both(tmp_path, scenario)


def test_in_progress_run_recorded_as_running(tmp_path):
    def scenario(P, base):
        d = os.path.join(str(base), "a-test", "t-live")
        os.makedirs(d)
        wh = P.wmod.open_or_create(str(base))
        seen = [wh.ingest_store(str(base))["runs"],
                wh.rollups()["runs_by_verdict"],
                wh.query("SELECT status, valid FROM runs")[1][0],
                wh.ingest_store(str(base))["runs"]]
        time.sleep(0.01)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump({"valid?": True}, f)
        seen += [wh.ingest_store(str(base))["runs"],
                 wh.rollups()["runs_by_verdict"],
                 wh.query("SELECT status FROM runs")[1][0]]
        assert seen == [1, {"running": 1}, ("running", None), 0, 1,
                        {"true": 1}, ("done",)]
        return seen

    both(tmp_path, scenario)


def test_verifier_session_ingest_and_rollup(tmp_path):
    def scenario(P, base):
        svc = P.Verifier(str(base))
        try:
            h = P.synth.la_history(n_txns=60, n_keys=3, seed=0)
            body = b"".join(json.dumps(op.to_dict()).encode() + b"\n"
                            for op in h)
            svc.ingest("wh-a", body, cursor=0)
            svc.verdict("wh-a")
            svc.ingest("wh-b", body, cursor=0)
            svc.verdict("wh-b")
            svc.seal("wh-b")
        finally:
            svc.close()
        wh = P.wmod.open_or_create(str(base))
        assert wh.ingest_store(str(base))["sessions"] == 2
        rows = {r["name"]: r for r in wh.verifier_sessions()}
        assert rows["wh-a"]["state"] == "open"
        assert rows["wh-a"]["valid"] is True
        assert rows["wh-b"]["state"] == "sealed"
        assert rows["wh-b"]["seal_equal"] == 1
        assert rows["wh-a"]["txns"] == rows["wh-b"]["txns"] > 0
        roll = wh.rollups()
        assert roll["verifier_by_state"] == {"open": 1, "sealed": 1}
        assert roll["runs_by_verdict"] == {}
        ex = P.prometheus.exposition(base=str(base),
                                     registry=P.metrics.Registry())
        assert 'jepsen_warehouse_verifier_sessions{state="open"} 1' in ex
        assert 'jepsen_warehouse_verifier_sessions{state="sealed"} 1' in ex
        return ({n: {k: v for k, v in r.items() if k != "updated"}
                 for n, r in rows.items()}, roll["verifier_by_state"])

    both(tmp_path, scenario)


def test_rebuild_from_torn_partial_store(tmp_path):
    def scenario(P, base):
        _mk_run(base, "a-test", "t1", events=5, torn_events=True)
        _mk_run(base, "a-test", "t2", telemetry=False)
        d3 = _mk_run(base, "a-test", "t3", telemetry=False)
        with open(os.path.join(d3, "results.json"), "w") as f:
            f.write("{not json")
        _write_ledger(base, n=4)
        wh = P.wmod.open_or_create(str(base))
        stats = wh.rebuild(str(base))
        assert stats["runs"] == 3 and stats["records"] == 8
        assert stats["events"] == 5
        c1 = wh.counts()
        assert c1["runs"] == 3 and c1["events"] == 5
        assert wh.rebuild(str(base))["runs"] == 3
        assert wh.counts() == c1
        again = wh.ingest_store(str(base))
        assert again == {"ledgers": 1, "records": 0, "runs": 0,
                         "events": 0, "sessions": 0, "fleet-events": 0,
                         "archived": 0}
        return stats, c1, again

    both(tmp_path, scenario)


def test_v4_to_v5_migration_on_populated_store(tmp_path):
    """A schema-v4 warehouse file (no span profile, no phase or counter
    columns) is migrated in place on open; `rebuild` refills what the
    migration left empty, identically twice."""
    PROF_SQL = ("SELECT dir, host, site, shape, calls, compile_s, "
                "execute_s, device_dispatch_s FROM span_profile "
                "ORDER BY dir, site, shape")
    V4_COLS = ("id, ledger, campaign, run, key, workload, fault, "
               "seed, valid, error, degraded, deadline, dir, ops, "
               "wall_s, gen, spec, ts, witness, trace")

    def scenario(P, base):
        d = _mk_run(base, "a-test", "t1")
        tp = os.path.join(d, "telemetry.json")
        with open(tp) as f:
            doc = json.load(f)
        doc["spans"][0]["children"][0]["attrs"] = {"profile": {
            "elle.infer|i32[1024]": {"calls": 3, "compile_s": 0.21,
                                     "execute_s": 0.05,
                                     "device_dispatch_s": 0.012}}}
        doc["meta"] = {"host": "host-a"}
        with open(tp, "w") as f:
            json.dump(doc, f)
        path = _write_ledger(base, n=6)
        recs = [json.loads(ln) for ln in open(path)]
        for r in recs:
            r["phases"] = {"check:la": {"compile_s": 0.1,
                                        "execute_s": 0.2}}
            r["counters"] = {"compile-cache-miss{site=checker}": 2.0}
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        rel = os.path.relpath(path, str(base))
        whp = P.wmod.warehouse_path(str(base))
        wh = P.wmod.Warehouse(whp)
        wh.ingest_store(str(base))
        prof0 = wh.query(PROF_SQL)[1]
        assert prof0 and prof0[0][1] == "host-a"
        assert prof0[0][2] == "elle.infer"
        roll0 = wh.query("SELECT * FROM span_rollup ORDER BY 1, 2")[1]
        gen0 = wh.query("SELECT * FROM span_gen_rollup "
                        "ORDER BY 1, 2, 3")[1]
        fr0 = wh.forensic_records(rel)
        assert fr0 and all(p and c for _, _, p, c in fr0)
        wh.close()
        db = sqlite3.connect(whp)
        with db:
            db.execute("DROP TABLE span_profile")
            db.execute("ALTER TABLE campaign_records "
                       "RENAME TO campaign_records_v5")
            db.execute("""CREATE TABLE campaign_records(
                id INTEGER PRIMARY KEY, ledger TEXT NOT NULL,
                campaign TEXT, run TEXT, key TEXT, workload TEXT,
                fault TEXT, seed TEXT, valid TEXT, error TEXT,
                degraded TEXT, deadline INTEGER, dir TEXT, ops INTEGER,
                wall_s REAL, gen TEXT, spec TEXT, ts TEXT, witness TEXT,
                trace TEXT)""")
            db.execute(f"INSERT INTO campaign_records({V4_COLS}) "
                       f"SELECT {V4_COLS} FROM campaign_records_v5")
            db.execute("DROP TABLE campaign_records_v5")
            db.execute("INSERT OR REPLACE INTO meta(key, value) "
                       "VALUES ('schema_version', '4')")
        db.close()
        wh = P.wmod.Warehouse(whp)
        try:
            seen = [wh.query("SELECT value FROM meta WHERE key = "
                             "'schema_version'")[1][0][0],
                    wh.query("SELECT * FROM span_rollup "
                             "ORDER BY 1, 2")[1] == roll0,
                    wh.query("SELECT * FROM span_gen_rollup "
                             "ORDER BY 1, 2, 3")[1] == gen0,
                    wh.query("SELECT COUNT(*) FROM span_profile")[1],
                    all(p == {} and c == {}
                        for _, _, p, c in wh.forensic_records(rel)),
                    wh.ingest_store(str(base))["records"]]
            assert seen == [str(P.wmod.SCHEMA_VERSION), True, True, [(0,)],
                            True, 0]
            wh.rebuild(str(base))
            assert wh.query(PROF_SQL)[1] == prof0
            assert wh.forensic_records(rel) == fr0
            wh.rebuild(str(base))
            assert wh.query(PROF_SQL)[1] == prof0
        finally:
            wh.close()
        return seen, prof0, roll0, gen0, fr0

    both(tmp_path, scenario)


def test_event_ingest_rotation_resets_and_since_filter(tmp_path):
    def scenario(P, base):
        d = os.path.join(str(base), "a-test", "t1")
        os.makedirs(d)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump({"valid?": True}, f)
        s = P.stream.EventStream(os.path.join(d, "events.jsonl"),
                                 max_bytes=256, keep=9)
        for i in range(12):
            s.emit("tick", i=i)
        wh = P.wmod.open_or_create(str(base))
        assert wh.ingest_store(str(base))["events"] > 12
        assert wh.events_fresh(d, str(base))
        for i in range(12, 18):
            s.emit("tick", i=i)
        wh.ingest_store(str(base))
        evs = wh.events_since(d, str(base))
        tick_evs = [e for e in evs if e.get("ev") == "tick"]
        assert [e["i"] for e in tick_evs] == list(range(18))
        cut = tick_evs[9]["t"]
        since = [e.get("i") for e in
                 wh.events_since(d, str(base), since=cut)
                 if e.get("ev") == "tick"]
        assert since == [e["i"] for e in tick_evs if e["t"] >= cut]
        assert 9 in since and 17 in since and 0 not in since
        return [e.get("ev") for e in evs], [e.get("i") for e in evs]

    both(tmp_path, scenario)


def test_event_ingest_new_session_regrow_not_spliced(tmp_path):
    def scenario(P, base):
        d = os.path.join(str(base), "a-test", "t1")
        os.makedirs(d)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump({"valid?": True}, f)
        p = os.path.join(d, "events.jsonl")
        s = P.stream.EventStream(p)
        for i in range(3):
            s.emit("tick", i=i, session=1)
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_store(str(base))
        assert wh.events_fresh(d, str(base))
        time.sleep(0.01)
        s2 = P.stream.EventStream(p)
        for i in range(20):
            s2.emit("tick", i=i, session=2)
        assert not wh.events_fresh(d, str(base))
        wh.ingest_store(str(base))
        evs = [e for e in wh.events_since(d, str(base))
               if e.get("ev") == "tick"]
        assert {e.get("session") for e in evs} == {2}
        assert [e["i"] for e in evs] == list(range(20))
        return [(e["session"], e["i"]) for e in evs]

    both(tmp_path, scenario)


def test_cached_handle_detects_deleted_and_replaced_file(tmp_path):
    def scenario(P, base):
        path = _write_ledger(base, n=3)
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_ledger(path, str(base))
        assert P.wmod.open_if_exists(str(base)) is wh
        os.remove(P.wmod.warehouse_path(str(base)))
        assert P.wmod.open_if_exists(str(base)) is None
        wh2 = P.wmod.Warehouse(P.wmod.warehouse_path(str(base)))
        wh2.ingest_ledger(path, str(base))
        wh2.close()
        wh3 = P.wmod.open_if_exists(str(base))
        assert wh3 is not None and wh3 is not wh
        return wh3.counts()

    assert both(tmp_path, scenario)["campaign_records"] == 6


def test_obs_sql_cte_write_refused_at_engine_level(tmp_path):
    def scenario(P, base):
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_bench({"metric": "m", "value": 1.0}, "BENCH_r09.json")
        with pytest.raises(sqlite3.OperationalError):
            wh.query("WITH x AS (SELECT 1) DELETE FROM bench")
        assert len(wh.bench_series()) == 1
        return wh.query("SELECT COUNT(*) FROM bench")

    assert both(tmp_path, scenario) == (["COUNT(*)"], [(1,)])


def test_bench_ingest_series_and_bad_file(tmp_path):
    def scenario(P, base):
        wh = P.wmod.open_or_create(str(base))
        for i, v in ((3, 133000.0), (4, 186000.0), (5, 277000.0)):
            wh.ingest_bench({"metric": "check-throughput", "value": v,
                             "unit": "ops/s", "n_txns": 1000000,
                             "backend": "cpu"}, f"BENCH_r0{i}.json")
        wh.ingest_bench({"metric": "check-throughput", "value": 140000.0},
                        "BENCH_r03.json")
        bad = base / "bad.json"
        bad.write_text("{nope")
        assert wh.ingest_bench_file(str(bad)) is False
        wrapped = base / "BENCH_r06.json"
        wrapped.write_text(json.dumps({
            "n": 6, "cmd": "python bench.py", "rc": 0, "tail": "...",
            "parsed": {"metric": "check-throughput", "value": 300000.0,
                       "unit": "ops/s", "backend": "cpu"}}))
        assert wh.ingest_bench_file(str(wrapped)) is True
        series = [{k: v for k, v in r.items() if k != "ingested_at"}
                  for r in wh.bench_series()]
        assert [r["source"] for r in series] == [
            "BENCH_r03.json", "BENCH_r04.json", "BENCH_r05.json",
            "BENCH_r06.json"]
        assert [r["value"] for r in series] == [140000.0, 186000.0,
                                                277000.0, 300000.0]
        return series

    both(tmp_path, scenario)


# ------------------------------------------------------- gate + obs CLI

def _obs(P, base, capsys, *args):
    """`obs ...` through the package's CLI: (rc, stdout, stderr) with
    the store's path taken out of the text."""
    disp = P.cli.single_test_cmd(lambda o: {})
    rc = P.cli.run(disp, ["--store-dir", str(base), "obs", *args])
    cap = capsys.readouterr()
    return rc, cap.out.replace(str(base), "S"), cap.err.replace(
        str(base), "S")


def test_mann_whitney_and_gate_statuses_equal():
    rng = random.Random(7)
    a = [rng.uniform(1.0, 1.2) for _ in range(20)]
    b = [x * 1.5 for x in a]
    for x, y in ((a, b), (b, a), ([1.0] * 10, [1.0] * 10), ([], [1.0])):
        assert tgate.mann_whitney_u(x, y) == jgate.mann_whitney_u(x, y)
    rng = random.Random(3)
    old = [rng.uniform(1.0, 1.2) for _ in range(15)]
    for new in ([rng.uniform(1.0, 1.2) for _ in range(15)],
                [x * 1.5 for x in old], [x * 1.05 for x in old]):
        assert tgate.gate_samples(old, new) == jgate.gate_samples(old, new)
    assert tgate.gate_samples([1.0, 1.0], [9.9, 9.9])["status"] == \
        "insufficient-data"


def test_cli_obs_gate_pass_and_regression_exit_codes(tmp_path, capsys):
    def scenario(P, base):
        _write_ledger(base, gens=("g1", "g2", "g3"), scale={"g3": 1.5},
                      n=20)
        seen = [_obs(P, base, capsys, "ingest")]
        for extra in (["--from-gen", "g1", "--to-gen", "g2"],
                      ["--from-gen", "g2", "--to-gen", "g3"], [],
                      ["--from-gen", "g3"]):
            seen.append(_obs(P, base, capsys, "gate", "--campaign", "soak",
                             "--span", "check:la", *extra))
        seen.append(_obs(P, base, capsys, "gate", "--campaign", "soak",
                         "--span", "no-such-span"))
        assert [s[0] for s in seen] == [0, 0, 1, 1, 2, 2]
        assert "PASS" in seen[1][1] and "REGRESSION" in seen[2][1]
        assert "from-gen == to-gen" in seen[4][1]
        return seen

    both(tmp_path, scenario)


def test_gate_works_without_warehouse_via_scan(tmp_path, capsys):
    def scenario(P, base):
        _write_ledger(base, gens=("g1", "g2"), n=10)
        r = _obs(P, base, capsys, "gate", "--campaign", "soak", "--span",
                 "check:la")
        assert r[0] == 0
        assert not os.path.exists(P.wmod.warehouse_path(str(base)))
        return r

    both(tmp_path, scenario)


def test_cli_obs_ingest_rebuild_sql_bench(tmp_path, capsys):
    def scenario(P, base):
        _write_ledger(base, n=5)
        _mk_run(base, "a-test", "t1")
        bench = base / "BENCH_r05.json"
        bench.write_text(json.dumps({"metric": "m", "value": 277000.0,
                                     "unit": "ops/s", "n_txns": 1000000,
                                     "backend": "cpu"}))
        seen = [_obs(P, base, capsys, "ingest", "--bench", str(bench)),
                _obs(P, base, capsys, "rebuild"),
                _obs(P, base, capsys, "sql",
                     "SELECT COUNT(*) FROM campaign_records"),
                _obs(P, base, capsys, "sql",
                     "DELETE FROM campaign_records"),
                _obs(P, base, capsys, "bench"),
                _obs(P, base, capsys, "ingest", "--bench",
                     str(base / "BENCH_r0*.jsn"))]
        assert [s[0] for s in seen] == [0, 0, 0, 2, 0, 2]
        out = seen[0][1]
        assert "10 records" in out and "1 runs" in out and "1 bench" in out
        assert seen[2][1].splitlines()[1] == "10"
        assert "BENCH_r05.json" in seen[4][1]
        return seen

    both(tmp_path, scenario)


def test_cli_obs_query_surfaces_need_warehouse(tmp_path, capsys):
    def scenario(P, base):
        seen = [_obs(P, base, capsys, a, *q) for a, q in (
            ("sql", ["SELECT 1"]), ("bench", []), ("timeline", ["r"]),
            ("compact", []))]
        assert all(s[0] == 2 and "no warehouse" in s[2] for s in seen)
        return seen

    both(tmp_path, scenario)


def test_cli_obs_compact_and_gc(tmp_path, capsys):
    def scenario(P, base):
        _write_ledger(base, gens=("g1", "g2", "g3"), n=6, flip_every=2,
                      witness_every=3)
        _mk_run(base, "a-test", "20200101T000000.000Z")
        _mk_run(base, "a-test", time.strftime("%Y%m%dT%H%M%S.000Z",
                                              time.gmtime()))
        seen = [_obs(P, base, capsys, "ingest"),
                _obs(P, base, capsys, "compact", "--keep-gens", "1"),
                _obs(P, base, capsys, "compact", "nope"),
                _obs(P, base, capsys, "gc"),
                _obs(P, base, capsys, "gc", "--retention", "3600"),
                _obs(P, base, capsys, "ingest")]
        assert [s[0] for s in seen] == [0, 0, 2, 2, 0, 0]
        assert os.listdir(os.path.join(str(base), "_archive",
                                       "a-test")) == ["20200101T000000.000Z"]
        return seen

    both(tmp_path, scenario)


# ------------------------------------------------ prometheus golden

class _GoldenFleet:
    """The spec's stand-in for a coordinator's federated metrics: two
    alive workers' pushed snapshots (`render_fleet` duck-types it)."""

    def federated_metrics(self):
        return {
            "w1": {"host": "h1", "age-s": 1.0, "version": "v1", "rows": [
                {"name": "worker-cells-done", "kind": "counter",
                 "labels": {}, "value": 3},
                {"name": "jit-cache-entries", "kind": "gauge",
                 "labels": {}, "value": 7},
                {"name": "worker-rss-peak-bytes", "kind": "gauge",
                 "labels": {}, "value": 120_000_000},
                {"name": "compile-cache-hits", "kind": "counter",
                 "labels": {}, "value": 9},
            ]},
            "w2": {"host": "h2", "age-s": 2.0, "version": "v2", "rows": [
                {"name": "worker-cells-done", "kind": "counter",
                 "labels": {}, "value": 5},
                {"name": "jit-cache-entries", "kind": "gauge",
                 "labels": {}, "value": 4},
                {"name": "worker-rss-peak-bytes", "kind": "gauge",
                 "labels": {}, "value": 95_000_000},
            ]},
        }


def _golden_registry(P):
    """The spec's fixed registry contents, in `P`'s registry."""
    reg = P.metrics.Registry()
    reg.counter("ops-invoked", worker=0).inc(42)
    reg.counter("resilience-faults-injected", site="elle.infer").inc(3)
    reg.gauge("checker-ops-per-s", checker="list-append").set(277000.5)
    reg.gauge("unset-gauge")  # never set: skipped from the exposition
    h = reg.histogram("probe-s", (0.1, 1.0), path='a"b\\c\nd')
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.gauge("verifier-sessions-active").set(2)
    reg.counter("verifier-ops-ingested").inc(1234)
    reg.gauge("verifier-verdict-freshness-s", session="s1").set(0.25)
    sw = reg.histogram("verifier-sweep-s", (0.001, 0.01, 0.1, 1.0, 10.0))
    for v in (0.005, 0.02, 0.02, 0.3):
        sw.observe(v)
    reg.gauge("verifier-journal-bytes").set(5120)
    reg.counter("verifier-compactions").inc(3)
    reg.counter("verifier-live-degraded").inc(1)
    for state, n in (("started", 2), ("chunk", 9), ("resumed", 1),
                     ("landed", 2), ("rejected", 1)):
        reg.counter("fleet-artifact-uploads", state=state).inc(n)
    reg.gauge("fleet-workers-alive").set(3)
    reg.gauge("fleet-leases-active").set(2)
    for state, n in (("queued", 4), ("claimed", 2), ("done", 6)):
        reg.gauge("fleet-cells", state=state).set(n)
    reg.counter("fleet-requeues", worker="w1",
                reason="lease-expired").inc(2)
    reg.counter("fleet-duplicate-completions", worker="w1").inc(1)
    reg.gauge("fleet-nemesis-windows-active", campaign="soak",
              fault="skew").set(1)
    reg.gauge("fleet-nemesis-windows-active", campaign="soak",
              fault="partition").set(0)
    reg.counter("fleet-affinity-deferrals", worker="w1").inc(3)
    reg.gauge("fleet-artifact-staging-bytes").set(4096)
    reg.gauge("jit-cache-entries").set(11)
    reg.counter("compile-cache-miss", site="elle.infer").inc(2)
    reg.counter("compile-cache-hits").inc(9)
    reg.counter("compile-cache-misses").inc(4)
    reg.counter("compile-cache-bytes").inc(3131146)
    reg.counter("compile-cache-fallthrough",
                site="elle.core-check").inc(1)
    reg.gauge("compile-cache-entries").set(3)
    reg.counter("compile-cache-transfers", state="pushed").inc(2)
    reg.counter("compile-cache-transfers", state="absorbed").inc(2)
    reg.gauge("process-rss-peak-bytes").set(104857600)
    reg.gauge("device-memory-peak-bytes", device="cpu:0").set(8388608)
    reg.gauge("jit-cache-entries-peak").set(13)
    reg.gauge("fleet-queue-depth").set(4)
    reg.gauge("fleet-claim-latency-p95-s").set(0.42)
    reg.gauge("fleet-quarantined-cells").set(1)
    reg.gauge("fleet-paroled-cells").set(1)
    reg.gauge("fleet-autopilot-generations").set(5)
    reg.counter("queue-anomalies-found", anomaly="lost-write").inc(2)
    reg.counter("queue-anomalies-found", anomaly="duplicate").inc(3)
    reg.counter("queue-adversarial-injections", shape="torn-send").inc(2)
    reg.counter("queue-adversarial-injections",
                shape="zombie-resend").inc(1)
    return reg


def _golden_exposition(P, base):
    """The spec's deterministic exposition: the fixed registry, the
    federated fleet, one heartbeat at a pinned age, a warehouse with one
    ledger, one running run, one verifier session and one bench row, and
    one firing and one pending alert."""
    reg = _golden_registry(P)
    cdir = os.path.join(str(base), "campaigns")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "soak.live.json"), "w") as f:
        json.dump({"campaign": "soak", "updated": 990.0, "total": 12,
                   "done": 7, "workers": {"0": {"run": "x"}},
                   "finished": False}, f)
    _write_ledger(base, n=2, flip_every=1)
    os.makedirs(os.path.join(str(base), "live-test", "t0"), exist_ok=True)
    vdir = os.path.join(str(base), "verifier", "s1")
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "session.json"), "w") as f:
        json.dump({"session": "s1", "state": "open", "txns": 10,
                   "ops": 40, "segments": 2, "updated": 995.0,
                   "verdict": {"valid?": True, "anomaly-types": []}}, f)
    wh = P.wmod.open_or_create(str(base))
    wh.ingest_store(str(base), events=False)
    wh.ingest_bench({"metric": "check-throughput", "value": 277000.0,
                     "unit": "ops/s", "n_txns": 1000000,
                     "backend": "cpu"}, "BENCH_r05.json")
    eng = P.alerts.AlertEngine(str(base), rules=P.alerts.load_rules([
        {"name": "claim-latency-blowout", "kind": "threshold",
         "severity": "page", "signal": "gauge:x", "op": ">",
         "value": 0.0, "for": 0.0},
        {"name": "journal-growth", "kind": "threshold",
         "severity": "warn", "signal": "gauge:x", "op": ">",
         "value": 0.0, "for": 3600.0}]), sinks=[])
    eng.evaluate(signals={"gauge:x": 1.0}, now=990.0)
    return P.prometheus.exposition(base=str(base), registry=reg,
                                   now=1000.0, fleet=_GoldenFleet())


def test_prometheus_exposition_matches_golden(tmp_path):
    got = both(tmp_path, _golden_exposition)
    with open(GOLDEN) as f:
        assert got == f.read()


@pytest.mark.parametrize("part", ["registry", "heartbeats", "fleet",
                                  "warehouse", "alerts"])
def test_exposition_parts_equal(tmp_path, part):
    """Each renderer alone, on the golden contents."""
    def scenario(P, base):
        _golden_exposition(P, base)
        wh = P.wmod.open_if_exists(str(base))
        return {
            "registry": lambda: P.prometheus.render_registry(
                _golden_registry(P)),
            "heartbeats": lambda: P.prometheus.render_heartbeats(
                str(base), now=1000.0),
            "fleet": lambda: P.prometheus.render_fleet(_GoldenFleet()),
            "warehouse": lambda: P.prometheus.render_warehouse(wh),
            "alerts": lambda: P.prometheus.render_alerts(str(base)),
        }[part]()

    assert both(tmp_path, scenario)


def test_exposition_parses_as_text_format_004():
    """`chip_smoke.parse_exposition` (20e's check) reads the golden
    exposition line by line, and refuses a malformed line or a sample
    before its family's ``# TYPE``."""
    with open(GOLDEN) as f:
        text = f.read()
    samples = cs.parse_exposition(text)
    assert samples[
        'ALERTS{alertname="claim-latency-blowout",severity="page",'
        'state="firing"}'] == 1.0
    assert samples['jepsen_warehouse_runs{valid="running"}'] == 1.0
    assert samples['jepsen_probe_s_bucket{le="+Inf",'
                   'path="a\\"b\\\\c\\nd"}'] == 3.0
    for bad in ("jepsen_x 1\n", "# TYPE jepsen_x gauge\njepsen_x{a=b} 1\n",
                "# TYPE jepsen_x gauge\njepsen_x one\n",
                "# TYPE jepsen_x nope\n", "# TYPE jepsen_x gauge\n"
                "jepsen_x 1"):
        with pytest.raises(AssertionError):
            cs.parse_exposition(bad)


def test_exposition_names_and_escaping():
    for name in ("checker-ops-per-s", "9bad", "a.b/c", ""):
        assert tprom.metric_name(name) == jprom.metric_name(name)
    assert tprom.metric_name("checker-ops-per-s") == \
        "jepsen_checker_ops_per_s"
    assert tprom.metric_name("9bad") == "jepsen__9bad"
    assert tprom.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


def test_exposition_histogram_buckets_cumulative_and_ordered(tmp_path):
    def scenario(P, base):
        reg = P.metrics.Registry()
        h = reg.histogram("lat-s", (0.1, 1.0))
        for v in (0.05, 0.06, 0.5, 5.0):
            h.observe(v)
        return P.prometheus.render_registry(reg)

    lines = both(tmp_path, scenario)
    assert [ln for ln in lines if "_bucket" in ln] == [
        'jepsen_lat_s_bucket{le="0.1"} 2',
        'jepsen_lat_s_bucket{le="1"} 3',
        'jepsen_lat_s_bucket{le="+Inf"} 4',
    ]
    assert "jepsen_lat_s_sum 5.61" in lines
    assert "jepsen_lat_s_count 4" in lines


# ------------------------------ a store the port's campaign wrote

class InjectedAppendChecker(AppendChecker):
    """The `append` demo's checker that first puts one G1c into the
    run's history (`synth.inject_wr_cycle`, in place, once): the cell
    comes out invalid, and its auto-shrink probes the injected history."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.injected = False

    def check(self, test, history, opts=None):
        if not self.injected:
            self.injected = tsynth.inject_wr_cycle(history)
        return super().check(test, history, opts)


def append_g1c_test(opts: dict) -> dict:
    """A campaign cell: the `append` demo bounded by ``opts["ops"]``,
    checked by `InjectedAppendChecker` on the CPU."""
    wl, client = tmain._wl("append", opts)
    gen = tgen.limit(int(opts.get("ops", 60)), tgen.clients(wl["generator"]))
    return tcore.noop_test(
        name="append-g1c", nodes=["n1", "n2", "n3"],
        concurrency=int(opts.get("concurrency", 2)), client=client,
        generator=gen, checker=InjectedAppendChecker(device="cpu"))


SPEC = {"name": "wh-parity", "seeds": [0, 1],
        "workloads": [{"name": "append", "opts": {"ops": 60}},
                      {"name": "append-g1c", "opts": {"ops": 60}}],
        "opts": {"concurrency": 2, "telemetry": True, "time-limit": None,
                 "shrink": {"rounds": 6}}}


#: columns the ingest stamps with its own clock
CLOCK_COLUMNS = {"ingested_at"}


def _tables(path: str, tables) -> dict:
    """Every row of every data table of the warehouse file at `path`,
    ordered by all its columns (the clock columns left out)."""
    db = sqlite3.connect(path)
    try:
        out = {}
        for t in tables:
            cols = [r[1] for r in db.execute(f"PRAGMA table_info({t})")
                    if r[1] not in CLOCK_COLUMNS]
            sel = ", ".join(cols)
            out[t] = (cols, db.execute(
                f"SELECT {sel} FROM {t} ORDER BY {sel}").fetchall())
        return out
    finally:
        db.close()


@pytest.fixture(scope="module")
def campaign_store(tmp_path_factory):
    """Two generations of `SPEC` run by the port's campaign on the CPU."""
    base = str(tmp_path_factory.mktemp("wh-campaign"))
    tplan.register_workload("append-g1c", append_g1c_test)
    try:
        sums = [tcc.run_campaign(SPEC, base, workers=2, cpu=True)]
        gen = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        while time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) == gen:
            time.sleep(0.05)  # the next generation's stamp
        sums.append(tcc.run_campaign(SPEC, base, workers=2, cpu=True,
                                     rerun=True))
    finally:
        tplan._EXTRA_WORKLOADS.pop("append-g1c", None)
    return base, sums


def test_port_campaign_store_ingested_equal(campaign_store, tmp_path):
    base, sums = campaign_store
    ledger = os.path.join("campaigns", "wh-parity.jsonl")
    recs = [json.loads(ln) for ln in open(os.path.join(base, ledger))]
    assert len(recs) == 8 and len({r["gen"] for r in recs}) == 2
    bad = [r for r in recs if r["valid?"] is False]
    assert len(bad) == 4 and all(r["workload"].startswith("append-g1c")
                                 for r in bad)
    assert all((r.get("witness") or {}).get("digest") for r in bad), bad
    got = {}
    for name, P in PKGS.items():
        store = str(tmp_path / name)
        shutil.copytree(base, store)  # copy2: the run digests' mtimes too
        wh = P.wmod.open_or_create(store)
        stats = wh.ingest_store(store)
        again = wh.ingest_store(store)
        tables = _tables(P.wmod.warehouse_path(store), P.wmod._DATA_TABLES)
        path = os.path.join(store, ledger)
        fast, slow = P.Index(path), P.Index(path, use_warehouse=False)
        assert fast._warehouse() is not None
        q = _queries(fast)
        _same_answers(q, _queries(slow), len(recs))
        assert _grid(fast) == _grid(slow)
        got[name] = (stats, again, wh.counts(), tables, q, _grid(fast),
                     wh.rollups(), wh.alert_signals())
    assert got["torch"] == got["jax"]
    stats, again, counts, tables = got["torch"][:4]
    cols, rows = tables["runs"]
    done = [r for r in rows if r[cols.index("status")] == "done"]
    assert stats["records"] == 8 and len(done) == 8
    assert again["records"] == 0 and again["runs"] == 0
    assert counts["witnesses"] == 4 and counts["span_profile"] > 0
    assert counts["events"] > 0  # the telemetric runs stream events.jsonl
    assert tables["campaign_records"][1] and tables["trace_spans"][1]


def test_port_campaign_post_ingest_keeps_warehouse_warm(campaign_store,
                                                        tmp_path):
    """`run_campaign` ingests its new records into an existing
    warehouse, so the SQL fast path answers right after it."""
    base, _ = campaign_store
    store = str(tmp_path / "s")
    shutil.copytree(base, store)
    wh = twh.open_or_create(store)
    wh.ingest_store(store)
    path = os.path.join(store, "campaigns", "wh-parity.jsonl")
    tplan.register_workload("append-g1c", append_g1c_test)
    try:
        spec = dict(SPEC, workloads=SPEC["workloads"][:1], seeds=[0])
        tcc.run_campaign(spec, store, workers=1, cpu=True, rerun=True)
    finally:
        tplan._EXTRA_WORKLOADS.pop("append-g1c", None)
    n = sum(1 for _ in open(path))
    assert n == 9
    assert wh.counts()["campaign_records"] == n
    idx = TIndex(path)
    assert idx._warehouse() is not None
    scan = _queries(TIndex(path, use_warehouse=False))
    # the ledger's queries answer from SQL at once; the new run dir's
    # device-call profile lands with the next `obs ingest`, as in JAX
    assert {k: v for k, v in _queries(idx).items() if k != "profile"} == \
        {k: v for k, v in scan.items() if k != "profile"}
    wh.ingest_store(store)
    _same_answers(_queries(TIndex(path)), scan, n)


def test_tail_since_through_the_warehouse_equals_the_scan(tmp_path, capsys):
    """`tail DIR --since` answers from the warehouse's event table when
    it covers the run, and prints what the stream scan prints (and what
    the JAX CLI prints on the same store)."""
    base = tmp_path / "s"
    d = os.path.join(str(base), "a-test", "t1")
    os.makedirs(d)
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid?": True}, f)
    s = tstream.EventStream(os.path.join(d, "events.jsonl"),
                            max_bytes=512, keep=9)
    for i in range(30):
        s.emit("tick", i=i)
    s.close()
    since = "1d"

    def tail(P):
        disp = P.cli.single_test_cmd(lambda o: {})
        rc = P.cli.run(disp, ["tail", d, "--since", since])
        return rc, capsys.readouterr().out

    scan = tail(PKGS["torch"])
    calls = []
    real = twh.Warehouse.events_since

    def counted(self, *a, **kw):
        calls.append(a)
        return real(self, *a, **kw)

    wh = twh.open_or_create(str(base))
    wh.ingest_store(str(base))
    assert wh.events_fresh(d, str(base))
    try:
        twh.Warehouse.events_since = counted
        fast = tail(PKGS["torch"])
    finally:
        twh.Warehouse.events_since = real
    assert calls, "the warehouse did not answer"
    assert fast == scan and fast[0] == 0 and "tick" in fast[1]
    assert tail(PKGS["jax"]) == fast
