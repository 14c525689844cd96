"""Port parity for run observability: trace context, compile-time
attribution on device calls, and the warehouse's timeline stitching with
`obs timeline`, against the JAX package's on the CPU.

The spec is the parts of the JAX package's `tests/test_observability.py`
that need neither the fleet nor `web.py`: the trace context (`:36-98`),
compile attribution (`:101-134`, `:489-521`) and timeline stitching
(`:305-486`).  Each scenario runs once with each package's modules and
the two observations must be equal.  Compile attribution is held to the
port's rule: `compile_s` books the first call of each (site, shape
class), `execute_s` every later one, and a transient failure does not
use up a shape's first sighting.  The metrics federation and staging
tests (`:137-303`) are in `test_torch_fleet.py`.  The tests on the live
fleet seam (`:524-618`) run each package's coordinator, verifier and
`web.serve` in a store of its own (the port's worker and service on the
CPU): one cell through a real worker stitches one trace whose
``/timeline/<run>`` page renders, a session adopts the trace of the
``Jepsen-Trace`` header on ``POST /ingest``, and ``/fleet/status`` and
the ``/fleet`` page carry the per-host verdict freshness.
"""

import json
import os
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import fleet as jfleet  # noqa: E402
from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu import verifier as jver  # noqa: E402
from jepsen_tpu import web as jweb  # noqa: E402
from jepsen_tpu.resilience import guard as jguard  # noqa: E402
from jepsen_tpu.telemetry import export as jexport  # noqa: E402
from jepsen_tpu.telemetry import spans as jspans  # noqa: E402
from jepsen_tpu.telemetry import warehouse as jwh  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import fleet as tfleet  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch import telemetry as ttel  # noqa: E402
from jepsen_tpu_torch import verifier as tver  # noqa: E402
from jepsen_tpu_torch import web as tweb  # noqa: E402
from jepsen_tpu_torch.resilience import guard as tguard  # noqa: E402
from jepsen_tpu_torch.telemetry import export as texport  # noqa: E402
from jepsen_tpu_torch.telemetry import spans as tspans  # noqa: E402
from jepsen_tpu_torch.telemetry import warehouse as twh  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(
        cli=jcli, core=jcore, res=jres, store=jstore, tel=jtel,
        guard=jguard, export=jexport, spans=jspans, wmod=jwh,
        fleet=jfleet, verifier=jver, web=jweb),
    "torch": types.SimpleNamespace(
        cli=tcli, core=tcore, res=tres, store=tstore, tel=ttel,
        guard=tguard, export=texport, spans=tspans, wmod=twh,
        fleet=tfleet, verifier=tver, web=tweb),
}


def both(tmp_path, scenario):
    """Run `scenario(P, base)` with each package in a directory of its
    own; the two observations must be equal.  Returns the port's."""
    out = {}
    for name, P in PKGS.items():
        base = tmp_path / name
        base.mkdir()
        out[name] = scenario(P, base)
    assert out["torch"] == out["jax"]
    return out["torch"]


# ------------------------------------------------- trace context core

@pytest.mark.parametrize("run_id", ["append-s0-abc", "append-s1-abc",
                                    "cell-7", ""])
def test_trace_id_is_pure_function_of_run_id(run_id):
    a = tspans.trace_id_for(run_id)
    assert a == tspans.trace_id_for(run_id) == jspans.trace_id_for(run_id)
    assert len(a) == 32 and int(a, 16) >= 0


def test_mint_parse_header_round_trip(tmp_path):
    def scenario(P, base):
        ctx = P.spans.mint_trace("run-1")
        hdr = ctx.header()
        assert hdr == f"00-{ctx.trace_id}-{ctx.span_id}-01"
        back = P.spans.parse_trace_header(hdr)
        assert back.trace_id == ctx.trace_id
        assert back.parent_id == ctx.span_id
        for bad in (None, "", "zz", "00-short-x-01",
                    "00-" + "g" * 32 + "-" + "0" * 16 + "-01"):
            assert P.spans.parse_trace_header(bad) is None
        c1, c2 = ctx.child("claim"), ctx.child("claim")
        assert c1.span_id == c2.span_id and c1.parent_id == ctx.span_id
        seg = P.spans.trace_context(ctx.trace_id, "run")
        assert seg.trace_id == ctx.trace_id and seg.span_id != ctx.span_id
        return hdr, back.span_id, c1.span_id, seg.span_id

    both(tmp_path, scenario)


def test_trace_scope_is_thread_local_and_restores(tmp_path):
    def scenario(P, base):
        assert P.spans.current_trace() is None
        ctx = P.spans.mint_trace("run-1")
        with P.spans.trace_scope(ctx):
            assert P.spans.current_trace() is ctx
            with P.spans.trace_scope(None):
                assert P.spans.current_trace() is None
            assert P.spans.current_trace() is ctx
        assert P.spans.current_trace() is None
        return ctx.trace_id

    both(tmp_path, scenario)


def test_collector_stamps_trace_on_roots_and_snapshot(tmp_path):
    def scenario(P, base):
        coll = P.tel.Collector()
        coll.trace = P.spans.trace_context(P.spans.trace_id_for("run-1"),
                                           "run")
        with coll.span("run"):
            with coll.span("inner"):
                pass
        doc = P.export.snapshot(coll)
        root = doc["spans"][0]
        assert root["attrs"]["trace_id"] == coll.trace.trace_id
        assert "trace_id" not in root["children"][0]["attrs"]
        return doc["trace"], root["attrs"]["trace_id"]

    got = both(tmp_path, scenario)
    assert got[0]["trace-id"] == tspans.trace_id_for("run-1")


def test_core_run_derives_trace_from_campaign_run_id(tmp_path):
    def scenario(P, base):
        t = P.core.noop_test(name="tr")
        t["store-dir"] = str(base)
        t["telemetry"] = True
        t["campaign-run-id"] = "cell-7"
        done = P.core.run(t)
        with open(os.path.join(P.store.test_dir(done),
                               "telemetry.json")) as f:
            doc = json.load(f)
        assert doc["meta"]["host"]
        return doc["trace"]["trace-id"], doc["meta"]["run-id"]

    assert both(tmp_path, scenario) == (tspans.trace_id_for("cell-7"),
                                        "cell-7")


# --------------------------------------- compile-time attribution

def test_compile_vs_execute_attribution_on_device_call_spans(tmp_path):
    """The first call of a (site, shape class) books ``compile_s``, a
    repeat ``execute_s``, a new shape a fresh first sighting."""
    def scenario(P, base):
        P.guard.reset_compile_cache_stats()
        coll = P.tel.activate()
        try:
            x = np.zeros((4, 4))
            with coll.span("device-site") as sp:
                P.res.device_call("obs.test", lambda v: v, x)
                first = sorted(k for k in ("compile_s", "execute_s")
                               if k in sp.attrs)
                P.res.device_call("obs.test", lambda v: v, x)
                second = sorted(k for k in ("compile_s", "execute_s")
                                if k in sp.attrs)
                P.res.device_call("obs.test", lambda v: v,
                                  np.zeros((8, 4)))
            st = P.guard.compile_cache_stats()
            reg = P.tel.registry()
            return (first, second, st,
                    reg.gauge("jit-cache-entries").value,
                    reg.counter("compile-cache-miss",
                                site="obs.test").value,
                    sorted(sp.attrs["profile"]))
        finally:
            P.tel.deactivate(coll)
            P.guard.reset_compile_cache_stats()

    got = both(tmp_path, scenario)
    assert got[:5] == (["compile_s"], ["compile_s", "execute_s"],
                       {"entries": 2, "misses": 2}, 2, 2)


def test_compile_attribution_lands_on_the_attempt_that_succeeds(tmp_path):
    """A transient failure on a shape's first attempt does not use up
    its first sighting: the retry that succeeds books ``compile_s``."""
    def scenario(P, base):
        P.guard.reset_compile_cache_stats()
        coll = P.tel.activate()
        try:
            calls = {"n": 0}

            def flaky(v):
                calls["n"] += 1
                if calls["n"] == 1:
                    e = RuntimeError("RESOURCE_EXHAUSTED: transient")
                    e.transient = True
                    raise e
                return v

            pol = P.res.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                    max_delay_s=0.0)
            with coll.span("site") as sp:
                P.res.device_call("obs.flaky", flaky, np.zeros((3, 3)),
                                  policy=pol)
            return (calls["n"], "compile_s" in sp.attrs,
                    "execute_s" in sp.attrs,
                    P.guard.compile_cache_stats()["misses"])
        finally:
            P.tel.deactivate(coll)
            P.guard.reset_compile_cache_stats()

    assert both(tmp_path, scenario) == (2, True, False, 1)


# ----------------------------------------- warehouse timeline stitching

def _write_fleet_ledger(base, name="fl", run="r-0", worker="w0",
                        t0=1000.0, spans=None, requeue=False):
    """The spec's hand-written fleet ledger (the fleet is not ported)."""
    d = os.path.join(str(base), "fleet")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name + ".jsonl")
    evs = [{"ev": "enqueue", "run": run, "ts": t0}]
    t = t0 + 0.5
    if requeue:
        evs.append({"ev": "claim", "run": run, "worker": "dead", "ts": t})
        evs.append({"ev": "requeue", "run": run, "worker": "dead",
                    "reason": "lease-expired", "ts": t + 1.0})
        t += 1.5
    evs.append({"ev": "claim", "run": run, "worker": worker, "ts": t})
    rec = {"run": run, "valid?": True}
    if spans:
        rec["spans"] = spans
    evs.append({"ev": "complete", "run": run, "worker": worker,
                "record": rec, "ts": t + 2.0})
    with open(path, "a") as f:
        for ev in evs:
            f.write(json.dumps(ev) + "\n")
    return path


def _orphan(wh, trace_id, run, host="hX", name="run"):
    with wh._lock, wh.db:
        wh.db.execute(
            "INSERT INTO trace_spans(trace_id, origin, source, run, host, "
            "name, t0, t1, dur_s) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (trace_id, "bogus", "run", run, host, name, 1000.0, 1001.0,
             1.0))


def test_fleet_ledger_stitches_trace_segments(tmp_path):
    def scenario(P, base):
        path = _write_fleet_ledger(
            base, run="cell-1", worker="w0", requeue=True,
            spans={"fleet:claim-to-start": 0.25, "fleet:upload": 0.5,
                   "check:la": 1.0})
        wh = P.wmod.open_or_create(str(base))
        n = wh.ingest_fleet_ledger(path, str(base))
        tl = wh.trace_timeline("cell-1")
        assert tl["trace-id"] == P.spans.trace_id_for("cell-1")
        assert not tl["orphans"]
        by_name = {s["name"]: s for s in tl["spans"]}
        assert by_name["fleet:enqueue-wait"]["dur_s"] == 0.5
        assert by_name["fleet:attempt"]["host"] == "dead"
        assert by_name["fleet:execute"]["host"] == "w0"
        assert by_name["fleet:execute"]["dur_s"] == 2.0
        assert "check:la" not in by_name
        wh.ingest_fleet_ledger(path, str(base))
        _write_fleet_ledger(base, run="cell-2", t0=2000.0)
        wh.ingest_fleet_ledger(path, str(base))
        tl2 = wh.trace_timeline("cell-1")
        assert len(tl2["spans"]) == len(by_name)
        return (n, tl, wh.fleet_worker_rollup(
            os.path.relpath(path, str(base))), wh.counts())

    both(tmp_path, scenario)


def test_run_dir_trace_rows_on_absolute_time(tmp_path):
    def scenario(P, base):
        d = os.path.join(str(base), "a-test", "t1")
        os.makedirs(d)
        tid = P.spans.trace_id_for("cell-9")
        doc = {
            "version": 1, "epoch_ns": 1_000_000_000_000,
            "perf0_ns": 500_000,
            "meta": {"name": "a-test", "host": "hostA",
                     "run-id": "cell-9"},
            "trace": {"trace-id": tid, "span-id": "s" * 16},
            "spans": [{"name": "run", "t0_ns": 500_000,
                       "dur_ns": 2_000_000_000, "attrs": {},
                       "children": [
                           {"name": "workload", "t0_ns": 600_000,
                            "dur_ns": 1_000_000_000, "attrs": {},
                            "children": [
                                {"name": "leaf", "t0_ns": 700_000,
                                 "dur_ns": 1, "attrs": {},
                                 "children": []}]}]}],
            "metrics": {"counters": [], "gauges": [], "histograms": []},
        }
        with open(os.path.join(d, "telemetry.json"), "w") as f:
            json.dump(doc, f)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump({"valid?": True}, f)
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_run_dir(d, str(base))
        tl = wh.trace_timeline("cell-9")
        by_name = {s["name"]: s for s in tl["spans"]}
        assert set(by_name) == {"run", "run:workload"}
        assert by_name["run"]["t0"] == 1000.0
        assert by_name["run"]["dur_s"] == 2.0
        assert by_name["run"]["host"] == "hostA"
        assert by_name["run:workload"]["run"] == "cell-9"
        return tl, P.wmod.Warehouse.timeline_layout(tl)

    both(tmp_path, scenario)


def test_orphan_spans_detected(tmp_path):
    def scenario(P, base):
        path = _write_fleet_ledger(base, run="cell-1")
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_fleet_ledger(path, str(base))
        _orphan(wh, "f" * 32, "cell-1")
        tl = wh.trace_timeline("cell-1")
        assert len(tl["orphans"]) == 1
        assert tl["orphans"][0]["trace_id"] == "f" * 32
        assert all(s["trace_id"] == tl["trace-id"] for s in tl["spans"])
        return tl, wh.traces()

    both(tmp_path, scenario)


def test_verifier_session_snapshot_stitches(tmp_path):
    def scenario(P, base):
        tid = P.spans.trace_id_for("cell-3")
        vdir = os.path.join(str(base), "verifier", "s3")
        os.makedirs(vdir)
        with open(os.path.join(vdir, "session.json"), "w") as f:
            json.dump({"session": "s3", "state": "sealed", "opened": 100.0,
                       "updated": 105.5, "txns": 4, "ops": 10,
                       "segments": 1,
                       "config": {"trace-id": tid, "host": "w7"}}, f)
        wh = P.wmod.open_or_create(str(base))
        assert wh.ingest_verifier_sessions(str(base)) == 1
        tl = wh.trace_timeline("cell-3")
        assert [s["name"] for s in tl["spans"]] == ["verifier:live-session"]
        assert tl["spans"][0]["host"] == "w7"
        assert tl["spans"][0]["dur_s"] == 5.5
        wh.ingest_verifier_sessions(str(base))
        assert len(wh.trace_timeline("cell-3")["spans"]) == 1
        return tl, wh.verifier_sessions()

    both(tmp_path, scenario)


def test_cli_obs_timeline_renders_and_flags_orphans(tmp_path, capsys):
    def scenario(P, base):
        path = _write_fleet_ledger(base, run="cell-1", worker="w0")
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_fleet_ledger(path, str(base))
        disp = P.cli.single_test_cmd(lambda o: {})
        argv = ["--store-dir", str(base), "obs", "timeline"]
        seen = []
        for key in ("cell-1", P.spans.trace_id_for("cell-1"),
                    "no-such-run"):
            rc = P.cli.run(disp, argv + [key])
            seen.append((rc, capsys.readouterr().out))
        _orphan(wh, "e" * 32, "cell-1", host=None, name="x")
        rc = P.cli.run(disp, argv + ["cell-1"])
        seen.append((rc, capsys.readouterr().out))
        assert [s[0] for s in seen] == [0, 0, 2, 1]
        assert "fleet:enqueue-wait" in seen[0][1]
        assert "fleet:execute" in seen[0][1]
        assert P.spans.trace_id_for("cell-1") in seen[0][1]
        assert "ORPHAN" in seen[3][1]
        return seen

    both(tmp_path, scenario)


def test_timeline_with_only_orphan_spans_reports_not_crashes(tmp_path,
                                                             capsys):
    def scenario(P, base):
        wh = P.wmod.open_or_create(str(base))
        _orphan(wh, "d" * 32, "lonely", host="h")
        tl = wh.trace_timeline("lonely")
        assert not tl["spans"] and len(tl["orphans"]) == 1
        lay = P.wmod.Warehouse.timeline_layout(tl)
        assert lay["spans"] == [] and lay["hosts"] == []
        disp = P.cli.single_test_cmd(lambda o: {})
        rc = P.cli.run(disp, ["--store-dir", str(base), "obs", "timeline",
                              "lonely"])
        out = capsys.readouterr().out
        assert rc == 1 and "ORPHAN" in out
        return tl, out

    both(tmp_path, scenario)


def test_port_run_stitches_with_device_times(tmp_path):
    """A telemetric `append` run of the port on the CPU, ingested by both
    warehouses: the same trace rows, span totals and device-call profile
    (its times are the run's own `device_time_ns`)."""
    from jepsen_tpu_torch.__main__ import DEMOS
    from jepsen_tpu_torch.generator import core as gen

    base = str(tmp_path / "s")
    t = DEMOS["append"]({"store-dir": base, "cpu": True, "seed": 0,
                         "concurrency-spec": "2n"})
    t["generator"] = gen.limit(100, t["generator"])
    t.update({"telemetry": True, "campaign-run-id": "cell-5"})
    done = tcore.run(t)
    d = tstore.test_dir(done)
    with open(os.path.join(d, "telemetry.json")) as f:
        doc = json.load(f)

    def device_ns(sp):
        return int((sp.get("attrs") or {}).get("device_time_ns") or 0) + \
            sum(device_ns(c) for c in sp.get("children") or [])

    assert sum(device_ns(sp) for sp in doc["spans"]) > 0
    got = {}
    for name, P in PKGS.items():
        wh = P.wmod.Warehouse(str(tmp_path / f"{name}.sqlite"))
        try:
            wh.ingest_run_dir(d, base)
            rel = os.path.relpath(d, base)
            got[name] = (wh.trace_timeline("cell-5"), wh.run_spans(rel),
                         wh.query("SELECT site, shape, calls, compile_s, "
                                  "execute_s FROM span_profile ORDER BY "
                                  "site, shape")[1])
        finally:
            wh.close()
    assert got["torch"] == got["jax"]
    tl, _, prof = got["torch"]
    assert tl["trace-id"] == tspans.trace_id_for("cell-5") and tl["spans"]
    assert prof and all(c + e > 0 for *_, c, e in prof)


# --------------------------------- the trace across a live fleet seam

def _fleet_server(P, base):
    """`P`'s coordinator and verifier on its own `web.serve` (the
    port's service on the CPU); returns (coord, ver, srv, url)."""
    spec = {"name": "obsfl", "workloads": ["set"], "seeds": [0],
            "opts": {"time-limit": 0.1, "telemetry": True}}
    coord = P.fleet.FleetCoordinator(spec, str(base), lease_s=10.0)
    ver = P.verifier.VerifierService(
        str(base), **({"device": "cpu"} if P is PKGS["torch"] else {}))
    srv = P.web.serve(port=0, base=str(base), background=True,
                      fleet=coord, verifier=ver)
    return coord, ver, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _with_fleet_server(P, base, body):
    coord, ver, srv, url = _fleet_server(P, base)
    try:
        return body(coord, ver, url)
    finally:
        srv.server_close()
        ver.close()
        coord.close()


def test_fleet_worker_end_to_end_single_trace(tmp_path):
    """One cell through a real coordinator and worker over HTTP: the
    record, the run dir's telemetry and the fleet segments carry one
    trace, with zero orphans, and ``/timeline/<run>`` renders it."""
    def scenario(P, base):
        def body(coord, _ver, url):
            kw = {"cpu": True} if P is PKGS["torch"] else {}
            w = P.fleet.FleetWorker(url, str(base), name="obs-w0",
                                    poll_s=0.05, **kw)
            assert w.run() == 1
            run_id = next(iter(coord._done_ids))
            want = P.spans.trace_id_for(run_id)
            rec = coord.idx.latest_by_run()[run_id]
            assert rec["trace"] == want
            wh = P.wmod.open_or_create(str(base))
            wh.ingest_store(str(base))
            tl = wh.trace_timeline(run_id)
            assert tl["trace-id"] == want and not tl["orphans"]
            names = {s["name"] for s in tl["spans"]}
            assert {s["trace_id"] for s in tl["spans"]} == {want}
            hosts = {s["host"] for s in tl["spans"] if s["source"] == "run"}
            with urllib.request.urlopen(f"{url}/timeline/{run_id}") as r:
                page = r.read().decode()
            assert want in page and "fleet:execute" in page
            return (run_id, want, sorted(k for k in rec["spans"]
                                         if k.startswith("fleet:")),
                    sorted(names), sorted(hosts))

        return _with_fleet_server(P, base, body)

    run_id, _want, fleet_spans, names, hosts = both(tmp_path, scenario)
    assert {"fleet:claim-to-start", "fleet:enqueue-wait"} <= \
        set(fleet_spans)
    assert {"fleet:enqueue-wait", "fleet:claim-to-start", "fleet:execute",
            "run:workload"} <= set(names)
    assert hosts == ["obs-w0"]


def test_verifier_adopts_trace_from_header(tmp_path):
    def scenario(P, base):
        def body(_coord, ver, url):
            ctx = P.spans.mint_trace("cell-x")
            req = urllib.request.Request(
                f"{url}/ingest/hsess?cursor=0",
                data=b'{"type": "invoke", "process": 0, "f": "txn", '
                     b'"value": []}\n',
                headers={P.spans.TRACE_HEADER: ctx.header()},
                method="POST")
            with urllib.request.urlopen(req) as r:
                ack = json.loads(r.read().decode())
            assert ack["ops"] == 1
            sessions = {s["session"]: s for s in ver.sessions()}
            assert sessions["hsess"]["config"]["trace-id"] == ctx.trace_id
            with open(os.path.join(str(base), "verifier", "hsess",
                                   "session.json")) as f:
                on_disk = json.load(f)["config"]["trace-id"]
            assert on_disk == ctx.trace_id
            return ack, ctx.trace_id

        return _with_fleet_server(P, base, body)

    both(tmp_path, scenario)


def test_fleet_status_surfaces_verdict_freshness_per_host(tmp_path):
    def scenario(P, base):
        def body(coord, ver, url):
            coord.register({"worker": "fw1", "host": "fw1"})
            assert ver.open("livesess", {"host": "fw1"})[0] == 200
            assert ver.ingest(
                "livesess", b'{"type": "invoke", "process": 0, '
                b'"f": "txn", "value": []}\n')[0] == 200
            with urllib.request.urlopen(url + "/fleet/status") as r:
                doc = json.loads(r.read().decode())
            assert "fw1" in doc["verifier-freshness"]
            row = doc["workers"]["fw1"]
            assert isinstance(row["verdict-freshness-s"], (int, float))
            assert row["live-sessions"] == 1
            with urllib.request.urlopen(url + "/fleet") as r:
                page = r.read().decode()
            assert "verdict freshness" in page and "fw1" in page
            return sorted(doc["verifier-freshness"]), row["live-sessions"]

        return _with_fleet_server(P, base, body)

    both(tmp_path, scenario)
