"""Port parity for the web pages: `jepsen_tpu_torch/web.py` against
`jepsen_tpu/web.py` on the CPU.

One store is built once (a telemetric run, a deadline and a degraded
run, an in-flight event stream, a shrunk witness with fault windows, a
campaign ledger over two generations with its heartbeat, warehouse and
device-call profile, a fleet ledger with a traced cell, an alert
journal, a sealed and an open verifier session).  Both packages'
`web.serve` serve it at once (port 0, ``background=True``), with
`time.time` in both web modules fixed to one value, and every GET route
of the JAX module's routing table, with the 404s and the 400 of each,
must answer the same status, content type and bytes, nothing masked.
The verifier's POST routes (``/ingest``, ``/verifier/<s>/<verb>``) and
the pages of a service or a coordinator attached are driven in each
package's own store under a fixed clock and compared the same way.

The specs are `tests/test_cli_web.py` (`:107`, `:120`, `:131`, `:249`,
`:339`, `:391`, `:583`), `tests/test_campaign.py` (`:553`, `:568`,
`:600`), `tests/test_invariants.py:815`, `tests/test_telemetry.py:429`
and `tests/test_warehouse.py:770`: each of their assertions is made
here on the port's answer.  The port's differences, each pinned here: a
500 names the error's type; ``/fleet/cache`` advertises no entries.
"""

import io
import json
import os
import time
import types
import urllib.error
import urllib.request
import zipfile

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu import web as jweb  # noqa: E402
from jepsen_tpu.campaign import core as jccore  # noqa: E402
from jepsen_tpu.campaign.index import Index as JIndex  # noqa: E402
from jepsen_tpu.checkers.api import Stats  # noqa: E402
from jepsen_tpu.generator import core as jg  # noqa: E402
from jepsen_tpu.minimize import witness as jwitness  # noqa: E402
from jepsen_tpu.telemetry import alerts as jalerts  # noqa: E402
from jepsen_tpu.telemetry import stream as jstream  # noqa: E402
from jepsen_tpu.telemetry import warehouse as jwh  # noqa: E402
from jepsen_tpu.verifier import VerifierService as JService  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu.workloads.mem import MemClient  # noqa: E402
from jepsen_tpu_torch import web as tweb  # noqa: E402
from jepsen_tpu_torch.fleet import coordinator as tcoord  # noqa: E402
from jepsen_tpu_torch.verifier import VerifierService as TService  # noqa: E402
from jepsen_tpu.fleet import coordinator as jcoord  # noqa: E402

#: the one wall clock both web modules read
NOW = 1_792_000_000.0
PKGS = {"jax": (jweb, JService, jcoord), "torch": (tweb, TService, tcoord)}


def _test_fn(opts):
    return {**opts, "name": "cli-test", "nodes": ["n1"], "concurrency": 2,
            "client": MemClient(),
            "generator": jg.clients(jg.limit(
                6, lambda t, c: {"f": "read", "value": None})),
            "checker": Stats()}


def _jsonl(h) -> bytes:
    return b"".join(json.dumps(op.to_dict()).encode() + b"\n" for op in h)


def _fetch(url, path, data=None, method=None):
    req = urllib.request.Request(url + path, data=data,
                                 method=method or ("POST" if data is not None
                                                   else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture()
def fixed_pages(monkeypatch):
    """`time.time` of both web modules answers NOW."""
    clock = types.SimpleNamespace(time=lambda: NOW)
    monkeypatch.setattr(jweb, "time", clock)
    monkeypatch.setattr(tweb, "time", clock)


@pytest.fixture()
def clock(monkeypatch):
    """The wall clock every module reads answers NOW (the services'
    and coordinators' timestamps, the pages' ages)."""
    real_gmtime = time.gmtime
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real_gmtime(*(a or (NOW,))))


# ------------------------------------------------------------ the store

def _campaign(base, run_rel, wit_rel):
    """A ledger over two generations (the second slower, its delta in
    compile_s), a heartbeat, and cells that link a run, its witness
    and its timeline."""
    idx = JIndex(jccore.index_path("camp", base))
    for gen, scale in (("g1", 1.0), ("g2", 1.6)):
        for i in range(3):
            span = round(scale * (1.0 + 0.01 * i), 6)
            rec = {"campaign": "camp", "run": f"r-{gen}-{i}",
                   "key": f"append|nofault|s{i}", "workload": "append",
                   "fault": "nofault", "seed": i, "valid?": True,
                   "gen": gen, "dir": run_rel,
                   "spans": {"check:la": span, "workload": 0.5},
                   "phases": {"check:la": {
                       "compile_s": round(0.1 + 0.9 * (span - 1.0), 6),
                       "execute_s": round(0.2 + 0.1 * (span - 1.0), 6)}},
                   "counters": {"compile-cache-miss{site=checker}":
                                2.0 + (40.0 if gen == "g2" else 0.0)}}
            if i == 0:
                rec.update({"valid?": gen == "g1", "dir": wit_rel,
                            "trace": "t", "witness": {
                                "ops": 6 if gen == "g1" else 4,
                                "digest": "aaa" if gen == "g1" else "bbb",
                                "anomaly-types": ["G1c"]}})
            if i == 1:
                rec.update({"valid?": "unknown",
                            "error": "deadline-exceeded",
                            "deadline": True})
            if i == 2:
                rec["degraded"] = "host-fallback"
            idx.append(rec)
    hb = jtel.Heartbeat(jccore.live_path("camp", base), campaign="camp",
                        total=6, done=2, min_interval_s=0.0)
    hb.worker("campaign-worker-0", {"run": "r-g2-2", "workload": "append",
                                    "fault": "nofault", "seed": 2,
                                    "slot": 0})
    # a second ledger with no heartbeat, no warehouse rows of spans
    JIndex(jccore.index_path("empty", base)).append(
        {"campaign": "empty", "run": "e1", "key": "k", "valid?": True,
         "gen": "g1"})


def _fleet_ledger(base, run="cell-1", t0=1000.0):
    d = os.path.join(base, "fleet")
    os.makedirs(d, exist_ok=True)
    evs = [{"ev": "enqueue", "run": run, "ts": t0},
           {"ev": "claim", "run": run, "worker": "w0", "ts": t0 + 0.5},
           {"ev": "complete", "run": run, "worker": "w0",
            "record": {"run": run, "valid?": True,
                       "spans": {"fleet:claim-to-start": 0.25}},
            "ts": t0 + 2.5}]
    with open(os.path.join(d, "fl.jsonl"), "a") as f:
        for ev in evs:
            f.write(json.dumps(ev) + "\n")


def _witness_run(base):
    """An invalid append history stored as a run, with a shrunk witness
    whose evidence names a cycle, a bank bad-read and a kafka lost
    write, and its surviving fault windows."""
    h = jsynth.la_history(n_txns=12, n_keys=2, concurrency=3, seed=3)
    assert jsynth.inject_wr_cycle(h)
    t = {"name": "wit-run", "store-dir": base,
         "start-time": 1_700_000_000.0, "history": h}
    jstore.save_0(t)
    d = jstore.test_dir(t)
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid?": False, "anomaly-types": ["G1c"]}, f)
    jwitness.save_witness(d, h[:6], {
        "valid?": False, "source-ops": len(h), "checker": "list-append",
        "rounds": 3, "probes": 17, "probe_p50_s": 0.01,
        "anomaly-types": ["G1c", "bank-wrong-total", "lost-write"],
        "anomalies": {
            "G1c": [{"cycle": [{"rel": "wr", "why": "T1 read T2's write"},
                               {"rel": "ww", "key": "x"}]}],
            "bank-wrong-total": [{"op-index": 4, "process": 1,
                                  "total": 99, "expected-total": 100,
                                  "negative": [2]}],
            "lost-write": [["k", 3, 7]],
            "session": [{"key": "y", "process": 2, "op": 5, "read": 1,
                         "rank": 2}, "plain"],
        },
        "fault-windows": [{"f": "partition", "span": [2, 5],
                           "ops": [2, 3], "pos": 0, "digest": "abc",
                           "host": "w0", "kept": True},
                          {"f": "kill", "span": [6, 8], "ops": []}]})
    return os.path.relpath(d, base)


def _verifier_sessions(base):
    svc = JService(base)
    h = jsynth.la_history(n_txns=60, n_keys=4, concurrency=5, seed=11)
    assert jsynth.inject_wr_cycle(h)
    assert svc.open("sealed1", {"host": "w0"})[0] == 200
    assert svc.ingest("sealed1", _jsonl(h), cursor=0)[0] == 200
    assert svc.verdict("sealed1")[0] == 200
    assert svc.seal("sealed1")[0] == 200
    h2 = jsynth.la_history(n_txns=30, n_keys=3, concurrency=3, seed=2)
    assert svc.ingest("open1", _jsonl(h2), cursor=0)[0] == 200
    assert svc.verdict("open1")[0] == 200
    svc.close()


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("web"))
    # a telemetric run with a latency histogram and a device-call profile
    t = jcore.run(_test_fn({"store-dir": base, "telemetry": True}))
    coll = jtel.activate()
    for v in (0.02, 0.03, 0.5, 2.0):
        coll.registry.histogram("demo-latency-s",
                                buckets=(0.01, 0.1, 1.0)).observe(v)
    jtel.deactivate(coll)
    d = jstore.test_dir(t)
    tp = os.path.join(d, "telemetry.json")
    with open(tp) as f:
        doc = json.load(f)
    doc["metrics"]["histograms"] += coll.registry.snapshot()["histograms"]
    doc["spans"][0]["children"][0]["attrs"] = {"profile": {
        "elle.infer|i32[1024]": {"calls": 3, "compile_s": 0.21,
                                 "execute_s": 0.05,
                                 "device_dispatch_s": 0.012}}}
    doc["meta"] = dict(doc.get("meta") or {}, host="host-a")
    with open(tp, "w") as f:
        json.dump(doc, f)
    run_rel = os.path.relpath(d, base)
    # a deadline-expired and a degraded run
    for name, res in (("dl-run", {"valid?": "unknown",
                                  "error": "deadline-exceeded"}),
                      ("deg-run", {"valid?": True, "append": {
                          "valid?": True, "degraded": "host-fallback"}})):
        rd = os.path.join(base, name, "20260101T000000.000Z")
        os.makedirs(rd)
        with open(os.path.join(rd, "results.json"), "w") as f:
            json.dump(res, f)
    # an in-flight stream (open spans, no end) and a corrupt run
    rd = os.path.join(base, "cli-test", "20990101T000000.000Z")
    os.makedirs(rd)
    s = jstream.EventStream(os.path.join(rd, "events.jsonl"))
    s.emit("span-open", name="run", tid=1)
    s.emit("span-open", name="check:wedged", tid=1)
    s.close()
    with open(os.path.join(rd, "events.jsonl")) as f:
        lines = [ln for ln in f if json.loads(ln).get("ev") != "end"]
    with open(os.path.join(rd, "events.jsonl"), "w") as f:
        f.writelines(lines)
    rd = os.path.join(base, "bad-run", "20260101T000000.000Z")
    os.makedirs(rd)
    with open(os.path.join(rd, "results.json"), "w") as f:
        f.write("{not json")
    wit_rel = _witness_run(base)
    _campaign(base, run_rel, wit_rel)
    _fleet_ledger(base)
    _verifier_sessions(base)
    with open(jalerts.alerts_path(base), "w") as f:
        for i, (rule, st) in enumerate((("card-peak", "pending"),
                                        ("card-peak", "firing"),
                                        ("ingest-lag", "resolved"))):
            f.write(json.dumps({"ev": "state", "rule": rule, "state": st,
                                "value": 1.5 + i, "severity": "page",
                                "at": 1000.0 + i, "ts": 1000.0 + i},
                               sort_keys=True) + "\n")
        f.write(json.dumps({"ev": "notify-result", "rule": "card-peak",
                            "sink": "log", "ok": True}) + "\n")
    jwh.open_or_create(base).ingest_store(base)
    return base, run_rel, wit_rel


@pytest.fixture()
def both_servers(store_dir, fixed_pages):
    base, run_rel, wit_rel = store_dir
    srvs = {name: mods[0].serve(port=0, base=base, background=True)
            for name, mods in PKGS.items()}
    urls = {name: f"http://127.0.0.1:{s.server_address[1]}"
            for name, s in srvs.items()}
    try:
        yield base, run_rel, wit_rel, urls
    finally:
        for s in srvs.values():
            s.server_close()


def _routes(base, run_rel, wit_rel):
    q = urllib.request.quote
    run = q(run_rel)
    wit = q(wit_rel)
    routes = [
        "/", "/index.html", "/nope",
        f"/files/{run}/", f"/files/{run}/results.json",
        f"/files/{run}/telemetry.json", f"/files/{run}/history.txt",
        f"/files/{wit}/witness.json", "/files/", "/files/nope",
        "/files/..%2f..%2fetc%2fpasswd", f"/zip/{run}", "/zip/nope",
        f"/telemetry/{run}", "/telemetry/dl-run/20260101T000000.000Z",
        "/telemetry/nope", f"/live/{run}",
        "/live/cli-test/20990101T000000.000Z", "/live/nope",
        "/live/verifier/sealed1", f"/run/{run}", f"/run/{run}/",
        "/run/dl-run/20260101T000000.000Z",
        "/run/deg-run/20260101T000000.000Z",
        "/run/bad-run/20260101T000000.000Z", f"/run/{wit}",
        f"/run/{wit}/witness", f"/run/{run}/witness", "/run/nope",
        "/run/nope/witness", "/run/..%2f..", "/campaigns", "/campaigns/",
        "/campaign/camp", "/campaign/camp/", "/campaign/camp/live",
        "/campaign/camp/trend", "/campaign/camp/forensics",
        "/campaign/camp/witness-diff", "/campaign/empty",
        "/campaign/empty/live", "/campaign/empty/trend",
        "/campaign/empty/forensics", "/campaign/empty/witness-diff",
        "/campaign/nope", "/campaign/nope/live", "/campaign/nope/trend",
        "/campaign/nope/forensics", "/campaign/nope/witness-diff",
        "/campaign/..%2f..%2fx", "/profile/camp", "/profile/empty",
        "/profile/nope", "/verdict/sealed1", "/verdict/open1",
        "/verdict/nope", "/verdict/..%2F..%2Foutside", "/verifier",
        "/verifier/", "/verifier/sealed1", "/verifier/open1",
        "/verifier/nope", "/verifier/..%2F..%2Foutside", "/alerts",
        "/alerts/", "/fleet", "/fleet/status", "/fleet/cache",
        "/fleet/cache/x", "/timeline/cell-1", "/timeline/nope",
        "/timeline/",
    ]
    return routes


def test_every_get_route_answers_the_jax_bytes(both_servers):
    base, run_rel, wit_rel, urls = both_servers
    statuses = {}
    for path in _routes(base, run_rel, wit_rel):
        want = _fetch(urls["jax"], path)
        got = _fetch(urls["torch"], path)
        assert got == want, (path, got[:2], want[:2])
        statuses[path] = got[0]
    # every page of the store renders; the misses are the JAX module's
    ok = {p for p, c in statuses.items() if c == 200}
    assert "/campaign/camp/forensics" in ok and "/profile/camp" in ok
    assert "/timeline/cell-1" in ok and "/verifier/sealed1" in ok
    assert statuses["/verdict/..%2F..%2Foutside"] == 400
    assert statuses["/files/..%2f..%2fetc%2fpasswd"] == 404
    assert statuses["/fleet"] == 404 and statuses["/nope"] == 404
    assert not any(c >= 500 for c in statuses.values()), statuses


def test_every_post_route_without_a_service_answers_the_jax_bytes(
        both_servers):
    _base, _r, _w, urls = both_servers
    for path in ("/ingest/s?cursor=0", "/ingest/s", "/verifier/s/open",
                 "/verifier/s/seal", "/verifier/s/nope", "/fleet/claim",
                 "/fleet/artifact/r1?offset=0", "/nope"):
        want = _fetch(urls["jax"], path, b"{}")
        got = _fetch(urls["torch"], path, b"{}")
        assert got == want and got[0] == 404, (path, got, want)
        assert b"ROADMAP" not in got[2]


def test_store_pages_name_what_the_specs_assert(both_servers):
    """The specs' assertions, on the port's answers."""
    base, run_rel, wit_rel, urls = both_servers
    url = urls["torch"]
    status, _, body = _fetch(url, "/")
    assert status == 200 and b"cli-test" in body
    for link in (b'href="/campaigns"', b'href="/verifier"',
                 b'href="/alerts"', b'href="/metrics"', b"/live/",
                 b"/telemetry/"):
        assert link in body, link
    assert b"b-deadline" in body and b"b-degraded" in body
    assert b"host-fallback" in body and b"corrupt" in body
    status, ctype, body = _fetch(url, f"/files/{run_rel}/results.json")
    assert status == 200 and json.loads(body)["valid?"] is True
    assert ctype == "application/json"
    status, ctype, body = _fetch(url, f"/zip/{run_rel}")
    assert status == 200 and ctype == "application/zip"
    names = zipfile.ZipFile(io.BytesIO(body)).namelist()
    assert any(n.endswith("results.json") for n in names)
    status, _, body = _fetch(url, f"/telemetry/{run_rel}")
    assert b"latency percentiles" in body and b"demo-latency-s" in body
    assert b"p50" in body and b"p99" in body and b"trace.json" in body
    status, _, body = _fetch(url, f"/live/{run_rel}")
    assert b"ended" in body and b"http-equiv" not in body
    status, _, body = _fetch(url, "/live/cli-test/20990101T000000.000Z")
    assert b"check:wedged" in body and b"in flight" in body
    assert b"http-equiv" in body
    status, _, body = _fetch(url, f"/run/{run_rel}")
    assert b"warehouse" in body and b"check:Stats" in body
    status, _, body = _fetch(url, f"/run/{wit_rel}/witness")
    assert b"minimal witness" in body and b"expected" in body
    assert b"surviving fault windows" in body and b"a lost write" in body
    status, _, body = _fetch(url, "/campaign/camp")
    for frag in (b"/campaign/camp/live", b"/campaign/camp/witness-diff",
                 b"/campaign/camp/trend", b"<th>s0</th>", b"b-witness",
                 b"/timeline/r-g2-0", b"regressions"):
        assert frag in body, frag
    status, _, body = _fetch(url, "/campaign/camp/live")
    assert b"r-g2-2" in body and b"2/6" in body
    status, _, body = _fetch(url, "/campaign/camp/witness-diff")
    assert b"append|nofault|s0" in body and b"6 &rarr; 4" in body
    status, _, body = _fetch(url, "/campaign/camp/trend")
    assert b"<th>g1</th>" in body and b"obs gate" in body
    assert body.count(b"background:#f2a3a3") == 1
    status, _, body = _fetch(url, "/campaign/camp/forensics")
    assert b"regression" in body and b"compile_s" in body
    status, _, body = _fetch(url, "/profile/camp")
    assert b"elle.infer" in body and b"host-a" in body
    status, _, body = _fetch(url, "/timeline/cell-1")
    assert b"fleet:execute" in body and b"w0" in body
    status, _, body = _fetch(url, "/alerts")
    assert b"card-peak" in body and b"firing" in body
    assert body.index(b"card-peak") < body.index(b"ingest-lag")
    status, _, body = _fetch(url, "/verifier")
    assert b"sealed1" in body and b"sealed" in body and b"open1" in body
    status, _, body = _fetch(url, "/verifier/sealed1")
    assert b"incremental == batch" in body and b"G1c" in body
    status, _, body = _fetch(url, "/verdict/sealed1")
    doc = json.loads(body)
    assert doc["snapshot"] is True and doc["valid?"] is False


def test_a_500_names_the_error_type(store_dir, fixed_pages, monkeypatch):
    """The port's difference: a handler error answers 500 naming the
    error's type (a device error on the server names `NoDeviceError`);
    the JAX module's names only its message."""
    base, _r, _w = store_dir

    def boom(self):
        raise RuntimeError("card on fire")

    out = {}
    for name, (web, _s, _c) in PKGS.items():
        monkeypatch.setattr(web._Handler, "_alerts_page", boom)
        srv = web.serve(port=0, base=base, background=True)
        try:
            out[name] = _fetch(f"http://127.0.0.1:{srv.server_address[1]}",
                               "/alerts")
        finally:
            srv.server_close()
    assert out["jax"] == (500, "text/plain", b"error: card on fire")
    assert out["torch"] == (500, "text/plain",
                            b"error: RuntimeError: card on fire")


# ---------------------------------------- a service or a coordinator

def _service_scenario(P, base):
    """The verifier's POST routes and pages with a service attached."""
    web, Service, _c = P
    svc = Service(base, **({"device": "cpu"} if Service is TService
                           else {}))
    srv = web.serve(port=0, base=base, background=True, verifier=svc)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    h = jsynth.la_history(n_txns=80, n_keys=4, concurrency=5, seed=21)
    assert jsynth.inject_wr_cycle(h)
    body = _jsonl(h)
    out = []

    def call(path, data=None, method=None):
        out.append((path, *_fetch(url, path, data, method)))
        return out[-1]

    try:
        call("/verifier/s1/open",
             json.dumps({"consistency-models": ["serializable"]}).encode())
        call("/verifier/s1/open", b"{not json")
        call("/verifier/..%2Fevil/open", b"")
        call("/verifier/_archive/open", b"")
        call("/ingest/s1?cursor=x", body[:10])
        call(f"/ingest/s1?cursor={len(body)}", body[:10])
        cur = 0
        while cur < len(body):
            _p, code, _t, raw = call(f"/ingest/s1?cursor={cur}",
                                     body[cur:cur + 3000])
            assert code == 200, raw
            cur = json.loads(raw)["cursor"]
        call("/ingest/s1?cursor=0", body[:100])
        call("/verdict/s1")
        call("/verifier")
        call("/verifier/s1")
        call("/verifier/s1/compact", b"")
        call("/verifier/s1/nope", b"")
        call("/verifier/nope/seal", b"")
        call("/verifier/nope/compact", b"")
        call("/verifier/nope/expire", b"")
        call("/ingest/s2", body[:2000])
        call("/verifier/s2/expire", b"")
        call("/verdict/s2")
        call("/", None)
        _p, code, _t, raw = call("/verifier/s1/seal", b"")
        assert code == 200, raw
        sealed = json.loads(raw)
        call("/verifier/s1/seal", b"")
        call("/ingest/s1?cursor=0", body[:100])
        call("/verifier")
        call("/verifier/s1")
    finally:
        srv.server_close()
        svc.close()
    return out, sealed


def test_verifier_routes_with_a_service_answer_the_jax_bytes(tmp_path,
                                                             clock):
    got = {}
    for name, P in PKGS.items():
        base = tmp_path / name
        base.mkdir()
        # one store path for both: a page names no path, but the
        # sessions' journals are compared by their own tests
        got[name] = _service_scenario(P, str(base))
    (jout, jsealed), (tout, tsealed) = got["jax"], got["torch"]
    seal_paths = {"/verifier/s1/seal"}
    for (jp, *jr), (tp, *tr) in zip(jout, tout):
        assert jp == tp
        if jp in seal_paths:
            continue  # the batch checkers' dicts differ in keys
        assert tr == jr, (jp, tr[:2], jr[:2], tr[2][:300], jr[2][:300])
    assert len(jout) == len(tout)
    # the seal: the JAX service's host oracle against the port's
    # list_append.check on the CPU — the same verdict, digest and
    # equality
    for k in ("equal", "digest", "incremental"):
        assert tsealed[k] == jsealed[k], k
    for k in ("valid?", "anomaly-types"):
        assert tsealed["verdict"][k] == jsealed["verdict"][k], k
    assert "G1c" in tsealed["verdict"]["anomaly-types"]


def _fleet_scenario(P, base):
    """``/fleet``, ``/fleet/status`` and the index with a coordinator
    and a verifier attached, a worker registered and live."""
    web, Service, Coord = P
    svc = Service(base, **({"device": "cpu"} if Service is TService
                           else {}))
    coord = Coord.FleetCoordinator(
        {"name": "flw", "workloads": ["set"], "seeds": [0, 1],
         "opts": {"time-limit": 0.1}}, base, lease_s=10.0)
    srv = web.serve(port=0, base=base, background=True, fleet=coord,
                    verifier=svc)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        coord.register({"worker": "fw1", "host": "fw1", "backend": "cpu",
                        "version": "v1"})
        coord.claim({"worker": "fw1"})
        svc.open("livesess", {"host": "fw1"})
        svc.ingest("livesess", b'{"type": "invoke", "process": 0, '
                   b'"f": "txn", "value": []}\n')
        return [(p, *_fetch(url, p)) for p in
                ("/fleet", "/fleet/", "/fleet/status", "/", "/alerts",
                 "/campaign/flw/live", "/verifier")]
    finally:
        srv.server_close()
        svc.close()
        coord.close()


def test_fleet_pages_with_a_coordinator_answer_the_jax_bytes(tmp_path,
                                                             clock):
    got = {}
    for name, P in PKGS.items():
        # one path for both stores, emptied between: the pages name it
        base = tmp_path / "store"
        if base.exists():
            import shutil

            shutil.rmtree(base)
        base.mkdir()
        got[name] = _fleet_scenario(P, str(base))
    assert got["torch"] == got["jax"]
    page = dict((p, b) for p, _c, _t, b in got["torch"])
    assert b"fleet &mdash; flw" in page["/fleet"] or \
        "fleet — flw".encode() in page["/fleet"]
    assert b"fw1" in page["/fleet"] and b"verdict freshness" in \
        page["/fleet"]
    assert b'href="/fleet"' in page["/"]
