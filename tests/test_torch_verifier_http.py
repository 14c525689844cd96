"""Port parity for the verifier over HTTP: the ingest routes of
`jepsen_tpu_torch/web.py`, the CLI's ``serve [--ingest]`` and the live
check's URL transport (`verifier/client.py`), against the JAX package's
on the CPU.

The spec is `tests/test_verifier.py` (`:312`, `:322`, `:363`, `:486`,
`:522`, `:585`, `:794`).  Each scenario runs once with each package's
`web.serve` and `VerifierService` in a store of its own (the port's
service on the CPU) and the answers must be equal; the seal's batch
dict, which differs between the JAX host oracle and the port's
`list_append.check`, is compared by its verdict, digest and equality.
The ``kill -9`` contract runs a ``python -m jepsen_tpu_torch --cpu
serve --ingest`` child: killed in mid-session and restarted on the same
store, it replays to the digest of a fresh session fed the journaled
prefix, and the client's resume from its last acked cursor seals equal
to the batch check.

The port's difference, pinned here: a device error in the service is
raised, not answered as a transient 503.  Without ``--cpu`` and with no
card, a seal answers 500 naming `NoDeviceError`, and a live check of a
run against such a server ends ``degraded`` with the reason naming it.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu import web as jweb  # noqa: E402
from jepsen_tpu.checkers.elle import oracle as joracle  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.verifier import VerifierService as JService  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import web as tweb  # noqa: E402
from jepsen_tpu_torch import verifier as tv  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.history import history as thistory  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_792_000_000.0
PKGS = {"jax": (jweb, lambda b: JService(b)),
        "torch": (tweb, lambda b: tv.VerifierService(b, device="cpu"))}
#: requests to the children go to 127.0.0.1 only
LOCAL = {"NO_PROXY": "127.0.0.1,localhost", "no_proxy": "127.0.0.1,localhost"}


def _jsonl(h) -> bytes:
    return b"".join(json.dumps(op.to_dict()).encode() + b"\n" for op in h)


def _post(port, path, data=b""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def clock(monkeypatch):
    real_gmtime = time.gmtime
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real_gmtime(*(a or (NOW,))))


def both(tmp_path, scenario, served=True):
    """`scenario(port, base, svc)` against each package's server with a
    service attached (``served=False``: the service only, no server);
    the two observations must be equal.  Returns the port's."""
    out = {}
    for name, (web, make) in PKGS.items():
        base = str(tmp_path / name)
        os.makedirs(base)
        svc = make(base)
        srv = (web.serve(port=0, base=base, background=True, verifier=svc)
               if served else None)
        try:
            out[name] = scenario(srv.server_address[1] if srv else None,
                                 base, svc)
        finally:
            if srv is not None:
                srv.server_close()
            svc.close()
    assert out["torch"] == out["jax"]
    return out["torch"]


def _seal_view(sealed):
    return {"equal": sealed.get("equal"), "digest": sealed.get("digest"),
            "valid?": sealed["verdict"]["valid?"],
            "anomaly-types": sealed["verdict"]["anomaly-types"],
            "incremental": sealed.get("incremental")}


# ------------------------------------------------------- the routes

def test_http_ingest_verdict_seal_pages(tmp_path, clock):
    h = jsynth.la_history(n_txns=100, n_keys=4, seed=11)
    jsynth.inject_rw_cycle(h)
    body = _jsonl(h)

    def scenario(port, _base, _svc):
        seen = []
        code, r = _post(port, "/verifier/s1/open",
                        json.dumps({"consistency-models":
                                    ["strict-serializable"]}).encode())
        assert code == 200 and r["state"] == "open"
        seen.append(r)
        cur = 0
        while cur < len(body):
            code, r = _post(port, f"/ingest/s1?cursor={cur}",
                            body[cur:cur + 4096])
            assert code == 200
            seen.append(r)
            cur = r["cursor"]
        assert cur == len(body)
        code, raw = _get(port, "/verdict/s1")
        v = json.loads(raw)
        assert code == 200 and v["valid?"] is False and v["anomaly-types"]
        seen.append(v)
        code, sealed = _post(port, "/verifier/s1/seal")
        assert code == 200 and sealed["equal"] is True
        seen.append(_seal_view(sealed))
        # re-seal is idempotent
        code, again = _post(port, "/verifier/s1/seal")
        assert code == 200 and _seal_view(again) == _seal_view(sealed)
        code, page = _get(port, "/verifier")
        assert code == 200 and b"s1" in page and b"sealed" in page
        seen.append(page)
        code, page = _get(port, "/verifier/s1")
        assert code == 200 and b"incremental == batch" in page
        seen.append(page)
        code, page = _get(port, "/live/verifier/s1")
        assert code == 200
        code, page = _get(port, "/")
        assert code == 200 and b"/verifier" in page
        seen.append(page)
        code, m = _get(port, "/metrics")
        assert b"jepsen_verifier_ops_ingested_total" in m
        assert b"jepsen_verifier_sweep_s_bucket" in m
        return seen

    both(tmp_path, scenario)


def test_http_read_only_pages_without_service(tmp_path, clock):
    """`serve` without --ingest still renders sessions from their
    session.json snapshots (and 404s POSTs)."""
    h = jsynth.la_history(n_txns=50, n_keys=3, seed=0)

    def scenario(_port, base, svc):
        svc.ingest("ro", _jsonl(h), cursor=0)
        svc.verdict("ro")
        svc.close()
        web = tweb if isinstance(svc, tv.VerifierService) else jweb
        srv = web.serve(port=0, base=base, background=True)
        try:
            port = srv.server_address[1]
            code, page = _get(port, "/verifier")
            assert code == 200 and b"ro" in page
            code, raw = _get(port, "/verdict/ro")
            assert code == 200 and json.loads(raw)["valid?"] is True
            code, doc = _post(port, "/ingest/ro?cursor=0", b"{}\n")
            assert code == 404 and "no verifier service" in doc["error"]
            return page, raw, doc
        finally:
            srv.server_close()

    both(tmp_path, scenario, served=False)


def test_bad_session_name_is_400_everywhere(tmp_path):
    def scenario(port, _base, _svc):
        out = []
        for method, path in (("GET", "/verdict/..%2Fevil"),
                             ("POST", "/verifier/a%3Ab/seal"),
                             ("POST", "/ingest/..%2Fevil?cursor=0"),
                             ("POST", "/verifier/a%3Ab/open"),
                             ("POST", "/verifier/_archive/open"),
                             ("POST", "/verifier/.hidden/open")):
            if method == "GET":
                code, raw = _get(port, path)
                doc = json.loads(raw)
            else:
                code, doc = _post(port, path, b"{}\n")
            assert code == 400 and "bad session name" in doc["error"], \
                (path, code, doc)
            out.append((code, doc))
        # an encoded slash splits the name: the rest reads as the verb
        out.append(_post(port, "/verifier/..%2Fevil/seal"))
        assert out[-1][0] == 404 and "unknown verb" in out[-1][1]["error"]
        return out

    both(tmp_path, scenario)


def test_readonly_verdict_rejects_traversal(tmp_path):
    """The no-service /verdict path joins the name into a filesystem
    path: a traversal name answers 400, never a file outside the
    store."""
    outside = tmp_path / "outside"
    outside.mkdir()
    (outside / "session.json").write_text('{"secret": 1}')
    out = {}
    for name, (web, _make) in PKGS.items():
        base = tmp_path / name / "store"
        base.mkdir(parents=True)
        (tmp_path / name / "outside").mkdir()
        (tmp_path / name / "outside" / "session.json").write_text(
            '{"secret": 1}')
        srv = web.serve(port=0, base=str(base), background=True)
        try:
            port = srv.server_address[1]
            code, raw = _get(port, "/verdict/..%2F..%2Foutside")
            assert code == 400 and b"secret" not in raw
            code2, raw2 = _get(port, "/verifier/..%2F..%2Foutside")
            assert code2 == 404
            out[name] = (code, raw, code2, raw2)
        finally:
            srv.server_close()
    assert out["torch"] == out["jax"]


def test_session_page_is_side_effect_free(tmp_path):
    """An auto-refreshing tab on /verifier/<s> runs no sweep, grows no
    events.jsonl: only GET /verdict mutates."""
    h = jsynth.la_history(n_txns=40, n_keys=3, seed=5)

    def scenario(port, base, _svc):
        _post(port, "/ingest/pg?cursor=0", _jsonl(h))
        _get(port, "/verdict/pg")
        ev = os.path.join(base, "verifier", "pg", "events.jsonl")
        size0 = os.path.getsize(ev)
        for _ in range(3):
            code, _page = _get(port, "/verifier/pg")
            assert code == 200
        assert os.path.getsize(ev) == size0
        _get(port, "/verdict/pg")
        return os.path.getsize(ev) > size0

    assert both(tmp_path, scenario) is True


def test_compact_expire_and_unknown_verbs(tmp_path, clock):
    h = jsynth.la_history(n_txns=200, n_keys=5, seed=3)
    body = _jsonl(h)

    def scenario(port, _base, _svc):
        out = [_post(port, "/verifier/nope/compact"),
               _post(port, "/verifier/a%3Ab/compact"),
               _post(port, "/ingest/c1?cursor=0", body),
               _post(port, "/verifier/c1/compact"),
               _post(port, "/verifier/c1/frobnicate"),
               _post(port, "/verifier/c1/expire"),
               _post(port, "/verifier/c1/expire"),
               _post(port, f"/ingest/c1?cursor={len(body)}", b""),
               _post(port, "/ingest/c1?cursor=oops", b""),
               _post(port, f"/ingest/c1?cursor={len(body) + 5}",
                     body[:50])]
        code, raw = _get(port, "/verdict/c1")
        out.append((code, json.loads(raw)))
        return out

    out = both(tmp_path, scenario)
    assert [c for c, _d in out] == [404, 400, 200, 200, 404, 200, 404,
                                    200, 400, 409, 200]


# ----------------------------------------------------- the CLI's serve

def _parser_flags(p):
    sub = next(a for a in p._actions if a.dest == "cmd")
    ps = sub.choices["serve"]
    return sorted((tuple(a.option_strings), a.dest, a.default,
                   a.type.__name__ if a.type else None, a.nargs)
                  for a in ps._actions if a.dest != "help")


def test_serve_flags_equal_to_the_jax_parser():
    got = _parser_flags(tcli.single_test_cmd(lambda o: o)[0])
    want = _parser_flags(jcli.single_test_cmd(lambda o: o)[0])
    assert got == want
    assert {f[1] for f in got} == {
        "port", "host", "ingest", "compact_bytes", "gc_idle",
        "archive_sealed", "maintain_interval"}


def test_serve_cmd_builds_the_service_on_the_asked_device(monkeypatch,
                                                         tmp_path):
    seen = {}

    def fake_serve(**kw):
        seen.update(kw)
        seen["svc"] = kw["verifier"]

    monkeypatch.setattr(tweb, "serve", fake_serve)
    from jepsen_tpu_torch.__main__ import suite

    for cpu, dev in ((True, "cpu"), (False, None)):
        argv = (["--cpu"] if cpu else []) + [
            "--store-dir", str(tmp_path), "serve", "--ingest", "-p", "9",
            "--compact-bytes", "4096", "--gc-idle", "60",
            "--archive-sealed", "120", "--maintain-interval", "0.5"]
        assert tcli.run(suite(), argv) == 0
        svc = seen["svc"]
        assert svc.device == dev and seen["port"] == 9
        assert svc.default_config == {"compact-bytes": 4096,
                                      "gc-idle-s": 60.0,
                                      "archive-sealed-s": 120.0}
        assert svc._maint is None  # closed when the server returned
    assert tcli.run(suite(), ["--store-dir", str(tmp_path), "serve",
                              "-p", "9"]) == 0
    assert seen["verifier"] is None


# ------------------------------------------------- kill -9 the daemon

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_up(port, proc, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        assert proc.poll() is None, "serve child exited"
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/verifier", timeout=2)
            return True
        except Exception:  # noqa: BLE001
            time.sleep(0.2)
    return False


def _spawn_serve(base, port, cpu=True):
    env = dict(os.environ, **LOCAL)
    argv = [sys.executable, "-m", "jepsen_tpu_torch",
            *(["--cpu"] if cpu else []), "--store-dir", base, "serve",
            "--ingest", "-p", str(port)]
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env, cwd=REPO)
    assert _wait_up(port, proc), "serve child did not come up"
    return proc


def test_kill9_serve_daemon_replay_and_client_resume(tmp_path):
    """kill -9 the ``serve --ingest`` child in mid-session; restart it
    on the same store: the journal replays to the verdict digest of a
    fresh session fed the journaled prefix, the client's resume from
    its last acked cursor is idempotent, and the seal equals the batch
    check (the port's on the CPU, and the JAX host oracle)."""
    base = str(tmp_path)
    h = jsynth.la_history(n_txns=150, n_keys=5, seed=13)
    synth_ok = jsynth.inject_wr_cycle(h)
    assert synth_ok
    body = _jsonl(h)
    port = _free_port()
    proc = _spawn_serve(base, port)
    cur = 0
    try:
        while cur < len(body) // 2:
            code, r = _post(port, f"/ingest/k9?cursor={cur}",
                            body[cur:cur + 2048])
            assert code == 200
            cur = r["cursor"]
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
    port2 = _free_port()
    proc2 = _spawn_serve(base, port2)
    try:
        code, raw = _get(port2, "/verdict/k9")
        assert code == 200
        recovered = json.loads(raw)
        ref = tv.VerifierSession("ref", ("serializable",), device="cpu")
        for chunk in tv.SessionJournal(
                os.path.join(base, "verifier", "k9")).read_ops():
            ref.append_ops(chunk)
        assert recovered["digest"] == tv.verdict_digest(ref.verdict())
        while cur < len(body):
            code, r = _post(port2, f"/ingest/k9?cursor={cur}",
                            body[cur:cur + 2048])
            assert code == 200
            cur = r["cursor"]
        assert cur == len(body)
        code, sealed = _post(port2, "/verifier/k9/seal")
        assert code == 200 and sealed["equal"] is True
        ops = [json.loads(ln) for ln in body.splitlines()]
        batch = tla.check(thistory(ops), ["serializable"], device="cpu")
        want = joracle.check(jpack(h, "list-append"), ("serializable",))
        for b in (batch, want):
            assert sealed["verdict"]["valid?"] == b["valid?"] is False
            assert sealed["verdict"]["anomaly-types"] == b["anomaly-types"]
        assert "G1c" in sealed["verdict"]["anomaly-types"]
    finally:
        proc2.kill()
        proc2.wait(timeout=10)


# ------------------------------------------- no card, no --cpu: raised

def test_serve_without_cpu_and_no_card_answers_500_naming_the_error(
        tmp_path):
    """``serve --ingest`` without ``--cpu`` checks on the card: with
    none visible the seal answers 500 naming `NoDeviceError` (the JAX
    service answers every seal error as a transient 503), and a live
    check streaming to it ends degraded with the reason named."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the seal would run on it")
    base = str(tmp_path / "served")
    os.makedirs(base)
    port = _free_port()
    proc = _spawn_serve(base, port, cpu=False)
    try:
        h = jsynth.la_history(n_txns=40, n_keys=3, seed=1)
        code, r = _post(port, "/ingest/nd?cursor=0", _jsonl(h))
        assert code == 200, r
        code, doc = _post(port, "/verifier/nd/seal")
        assert code == 500 and doc["error"].startswith("NoDeviceError: "), \
            (code, doc)
        lc = tv.live_check_for({
            "name": "x", "store-dir": str(tmp_path),
            "live-check": {"url": f"http://127.0.0.1:{port}",
                           "session": "nd2", "budget-s": 5}})
        assert not lc.degraded
        for op in h:
            lc.feed(op.to_dict())
        out = lc.finish()
        assert out["state"] == "degraded", out
        assert "500" in out["reason"] and "NoDeviceError" in out["reason"]
    finally:
        proc.terminate()
        proc.wait(timeout=10)
