"""Port parity for the fleet: `jepsen_tpu_torch/fleet/` (the queue, the
artifact store, the coordinator, the worker) and the port's `web.py`
against the JAX package's on the CPU.

The spec is the JAX package's `tests/test_fleet.py`, all but its chaos
soak.  The deterministic parts run once with each package's modules in a
store of their own under a fixed clock (`time.time` and `time.gmtime`
patched alike), and the two observations must be equal: the queue's
scripted event sequences give byte-equal ledgers and equal `digest()`,
`counts()` and cells; `record_digest`, `_norm_mesh` and `_caps_match`
agree on a grid; `pack_run_dir` of one directory gives equal bytes and
sha256; `ArtifactStore.handle` sequences give equal ``(code, doc)`` and
landed trees; the coordinator driven by the same scripted calls gives
equal responses, index records and `status()`.  The parts that need
real sockets and threads run the port alone and compare what is
deterministic with the JAX package: a fleet of two `FleetWorker(cpu=True)`
threads against the port's `web.serve` indexes one record per cell with
the verdicts, by key, of the JAX `campaign.run_campaign` of the same
spec.  Every server binds port 0, every thread is joined with a bound.

The port's differences, each pinned here: no compile cache (no secret
minted, no ``compilecache`` advert, ``/fleet/cache`` empty and
``/fleet/cache/<name>`` 404 even where the store holds such files); a
worker's ``cpu=True`` puts ``"cpu"`` into the cell's opts and leaves
the run id.  The dashboards on the fleet's server (``/``, ``/fleet``,
``/campaign/<n>/live``) render from the port's coordinator as the
JAX package's do from its own (the pages byte for byte are in
`test_torch_web.py`), and the verifier's POST routes are served beside
the fleet's.
"""

import hashlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import campaign as jcamp  # noqa: E402
from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu.campaign import core as jccore  # noqa: E402
from jepsen_tpu.campaign import plan as jplan  # noqa: E402
from jepsen_tpu.campaign.index import Index as JIndex  # noqa: E402
from jepsen_tpu.fleet import artifacts as jart  # noqa: E402
from jepsen_tpu.fleet import coordinator as jcoord  # noqa: E402
from jepsen_tpu.fleet import queue as jqueue  # noqa: E402
from jepsen_tpu.fleet import worker as jworker  # noqa: E402
from jepsen_tpu.telemetry import prometheus as jprom  # noqa: E402
from jepsen_tpu.telemetry import warehouse as jwh  # noqa: E402
from jepsen_tpu_torch import campaign as tcamp  # noqa: E402
from jepsen_tpu_torch import telemetry as ttel  # noqa: E402
from jepsen_tpu_torch import web as tweb  # noqa: E402
from jepsen_tpu_torch.campaign import core as tccore  # noqa: E402
from jepsen_tpu_torch.campaign import plan as tplan  # noqa: E402
from jepsen_tpu_torch.campaign.index import Index as TIndex  # noqa: E402
from jepsen_tpu_torch.fleet import artifacts as tart  # noqa: E402
from jepsen_tpu_torch.fleet import coordinator as tcoord  # noqa: E402
from jepsen_tpu_torch.fleet import queue as tqueue  # noqa: E402
from jepsen_tpu_torch.fleet import worker as tworker  # noqa: E402
from jepsen_tpu_torch.telemetry import prometheus as tprom  # noqa: E402
from jepsen_tpu_torch.telemetry import warehouse as twh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(
        Q=jqueue, A=jart, C=jcoord, W=jworker, tel=jtel, ccore=jccore,
        plan=jplan, Index=JIndex, prom=jprom, wmod=jwh, camp=jcamp),
    "torch": types.SimpleNamespace(
        Q=tqueue, A=tart, C=tcoord, W=tworker, tel=ttel, ccore=tccore,
        plan=tplan, Index=TIndex, prom=tprom, wmod=twh, camp=tcamp),
}

SPEC = {"name": "fl", "workloads": ["set"], "seeds": [0, 1, 2, 3, 4, 5],
        "opts": {"time-limit": 0.15}}

SCHED_SPEC = {
    "name": "fl-sched", "workloads": ["bank"], "seeds": [0, 1],
    "nemesis-schedule": {"faults": ["skew", "partition"], "windows": 2,
                         "interval": 0.02, "duration": 0.2, "seed": 5},
    "opts": {"time-limit": 0.3, "ops": 60, "concurrency": 2,
             "client-latency": 0.002},
}


class Clock:
    """The fixed wall clock both packages read: `time.time` answers
    `now`, `time.gmtime()` its UTC struct; a scenario moves `now`."""

    def __init__(self, now: float = 1_700_000_000.0):
        self.now = now


@pytest.fixture()
def clock(monkeypatch):
    c = Clock()
    real_gmtime = time.gmtime
    monkeypatch.setattr(time, "time", lambda: c.now)
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real_gmtime(*(a or (c.now,))))
    return c


def both(tmp_path, scenario, clock=None):
    """Run `scenario(P, base)` with each package in a store of its own
    (the clock, when given, reset to the same start); the two
    observations must be equal.  Returns the port's."""
    out = {}
    start = clock.now if clock is not None else None
    for name, P in PKGS.items():
        if clock is not None:
            clock.now = start
        base = tmp_path / name
        base.mkdir()
        out[name] = scenario(P, str(base))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _spec(run, device=False, **opts):
    return {"run_id": run, "campaign": "q", "workload": "set",
            "seed": 0, "opts": dict(opts), "fault": None,
            "fault_label": "nofault", "workload_label": "set",
            "device": device}


def _queue_obs(q, path):
    cells = {r: {k: v for k, v in c.items() if k != "_deferred_at"}
             for r, c in q.cells.items()}
    with open(path, "rb") as f:
        ledger = f.read()
    return {"digest": q.digest(), "counts": q.counts(), "cells": cells,
            "leases": q.leases(), "ledger": ledger}


# ---------------------------------------------------------------- queue

def _q_lifecycle(P, base):
    path = os.path.join(base, "q.jsonl")
    q = P.Q.WorkQueue(path)
    out = [q.enqueue(_spec("r1")), q.enqueue(_spec("r2")),
           q.enqueue(_spec("r1"))]
    out.append(q.claim("w1", lease_s=5.0, now=100.0))
    out += [q.renew("r1", "w1", 5.0, now=102.0),
            q.renew("r1", "w2", 5.0, now=102.0), q.renew("r2", "w1", 5.0),
            q.expire(now=106.0), q.expire(now=108.0)]
    q.claim("w2", lease_s=5.0, now=110.0)
    out += [q.release("r1", "w2"), q.release("r1", "w2")]
    assert out[:3] == [True, True, False]
    assert out[3][0]["run_id"] == "r1" and out[3][1] == 105.0
    assert out[7:9] == [[], ["r1"]] and q.counts()["requeues"] == 2
    return out, _queue_obs(q, path)


def _q_capability(P, base):
    path = os.path.join(base, "q.jsonl")
    q = P.Q.WorkQueue(path)
    q.enqueue(_spec("dev", device=True))
    q.enqueue(_spec("host"))
    a = q.claim("w0", lease_s=5.0, device_ok=False)
    b = q.claim("w1", lease_s=5.0, device_ok=True)
    assert a[0]["run_id"] == "host" and b[0]["run_id"] == "dev"
    return [a, b], _queue_obs(q, path)


def _q_at_most_once(P, base):
    path = os.path.join(base, "q.jsonl")
    q = P.Q.WorkQueue(path)
    q.enqueue(_spec("r1"))
    q.claim("w1", lease_s=0.1, now=0.0)
    q.expire(now=1.0)
    q.claim("w2", lease_s=5.0, now=1.0)
    rec2 = {"run": "r1", "valid?": True, "wall_s": 0.2}
    out = [q.complete("r1", "w2", rec2), q.complete("r1", "w2", dict(rec2)),
           q.complete("r1", "w1", {"run": "r1", "valid?": True,
                                   "wall_s": 0.9}),
           q.complete("nope", "w1", rec2)]
    assert out == ["accepted", "already", "duplicate", "unknown"]
    assert q.cells["r1"]["record"]["wall_s"] == 0.2
    return out, _queue_obs(q, path)


def _q_replay(P, base):
    path = os.path.join(base, "q.jsonl")
    q = P.Q.WorkQueue(path)
    for i in range(5):
        q.enqueue(_spec(f"r{i}"))
    q.claim("w1", lease_s=0.1, now=0.0)
    q.claim("w2", lease_s=9.0, now=0.0)
    q.expire(now=5.0)
    q.complete("r1", "w2", {"valid?": False})
    q.complete("r1", "w9", {"valid?": True})
    q.claim("w3", lease_s=9.0, now=6.0)
    replayed = P.Q.WorkQueue(path)
    assert replayed.digest() == q.digest()
    assert replayed.counts() == q.counts()
    a = q.claim("wx", lease_s=1.0, now=7.0)[0]["run_id"]
    b = replayed.claim("wx", lease_s=1.0, now=7.0)[0]["run_id"]
    assert a == b
    return a, _queue_obs(q, path)


def _q_torn_tail(P, base):
    path = os.path.join(base, "q.jsonl")
    q = P.Q.WorkQueue(path)
    q.enqueue(_spec("r1"))
    q.claim("w1", lease_s=5.0)
    digest = q.digest()
    with open(path, "a") as f:
        f.write('{"ev": "complete", "run": "r1", "wor')
    size = os.path.getsize(path)
    seen = P.Q.WorkQueue(path)
    assert seen.digest() == digest and os.path.getsize(path) == size
    seen.complete("r1", "w1", {"valid?": True})
    again = P.Q.WorkQueue(path)
    assert again.cells["r1"]["state"] == "done"
    assert again.digest() == seen.digest()
    return digest, _queue_obs(again, path)


def _q_affinity(P, base):
    reg = P.tel.registry()

    def deferrals(w):
        return reg.counter("fleet-affinity-deferrals", worker=w).value

    out = []
    q = P.Q.WorkQueue(os.path.join(base, "q.jsonl"))
    q.enqueue(_spec("dev", device=True, backend="cuda"))
    before = deferrals("cpu-w")
    out.append(q.claim("cpu-w", lease_s=5.0, caps={"backend": "cpu"},
                       now=100.0))
    out.append(deferrals("cpu-w") - before)
    out.append(q.claim("cuda-w", lease_s=5.0, caps={"backend": "CUDA"},
                       now=100.5))
    q2 = P.Q.WorkQueue(os.path.join(base, "q2.jsonl"))
    q2.enqueue(_spec("dev2", device=True, backend="cuda"))
    for now in (100.0, 103.0, 106.0):  # starved past a lease: it yields
        out.append(q2.claim("cpu-w", lease_s=5.0, caps={"backend": "cpu"},
                            now=now))
    q3 = P.Q.WorkQueue(os.path.join(base, "q3.jsonl"))
    q3.enqueue(_spec("dev3", device=True, mesh="2x2"))
    out.append(q3.claim("w", lease_s=5.0, caps={"mesh": [4]}, now=0.0))
    out.append(q3.claim("w", lease_s=5.0, caps={"mesh": [2, 2]}, now=0.1))
    assert out[0] == (None, None) and out[1] == 1
    assert out[2][0]["run_id"] == "dev" and out[5][0]["run_id"] == "dev2"
    assert out[6] == (None, None) and out[7][0]["run_id"] == "dev3"
    return out, [_queue_obs(x, x.path) for x in (q, q2, q3)]


def _q_claim_latency(P, base):
    q = P.Q.WorkQueue(os.path.join(base, "q.jsonl"))
    assert q.claim_latency_p95() is None
    t = time.time()
    for i in range(4):
        q.enqueue(_spec(f"r{i}"))
    for i in range(3):
        q.claim("w", lease_s=9.0, now=t + i)
    return q.claim_latencies(), q.claim_latency_p95(), _queue_obs(q, q.path)


QUEUE_SCRIPTS = {
    "lifecycle": _q_lifecycle, "capability filter": _q_capability,
    "at-most-once completion": _q_at_most_once,
    "replay reaches identical state": _q_replay,
    "torn tail tolerated and healed": _q_torn_tail,
    "affinity and starvation fallback": _q_affinity,
    "claim latency": _q_claim_latency,
}


@pytest.mark.parametrize("script", sorted(QUEUE_SCRIPTS))
def test_queue_scripts_byte_equal_ledgers(tmp_path, clock, script):
    both(tmp_path, QUEUE_SCRIPTS[script], clock)


MESHES = [None, "", "2x2", "2,2", "4", [2, 2], (2, 2), [4], "x", "2xq",
          ["a"], 4]


@pytest.mark.parametrize("m", MESHES, ids=repr)
def test_norm_mesh_equal(m):
    assert tqueue._norm_mesh(m) == jqueue._norm_mesh(m)


CAPS = [None, {}, {"backend": "cuda"}, {"backend": "CUDA"},
        {"backend": "tpu"}, {"mesh": "2x2"}, {"mesh": [4]},
        {"backend": "cuda", "mesh": [2, 2]}]
NEEDS = [{}, {"backend": "cuda"}, {"backend": "tpu"}, {"mesh": "2x2"},
         {"mesh": [4]}, {"backend": "cuda", "mesh": "2x2"},
         {"backend": ""}, {"mesh": "bad"}]


@pytest.mark.parametrize("need", NEEDS, ids=repr)
def test_caps_match_equal_on_a_grid(need):
    spec = {"opts": need}
    for caps in CAPS:
        assert tqueue._caps_match(spec, caps) == \
            jqueue._caps_match(spec, caps), (need, caps)
    assert tqueue._caps_match({}, None) is True


RECORDS = [{}, {"run": "r1", "valid?": True, "wall_s": 0.2},
           {"run": "r1", "valid?": True, "wall_s": 0.9},
           {"b": [1, 2, {"z": None}], "a": float("inf")},
           {"t": ("x", 1), "s": {"n": object.__name__}}]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_record_digest_equal(i):
    assert tqueue.record_digest(RECORDS[i]) == \
        jqueue.record_digest(RECORDS[i])


def test_fleet_path_equal(tmp_path):
    for name in ("fl", "a b/c", "x:y"):
        assert tqueue.fleet_path(name, str(tmp_path)) == \
            jqueue.fleet_path(name, str(tmp_path))


# ------------------------------------------------------------ artifacts

def _make_run_dir(base, name="a-test", ts="20260101T000000.000Z",
                  extra=0):
    d = os.path.join(base, name, ts)
    os.makedirs(os.path.join(d, "sub"), exist_ok=True)
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid?": True, "pad": "x" * (extra * 97)}, f)
    with open(os.path.join(d, "sub", "events.jsonl"), "w") as f:
        for i in range(extra + 3):
            f.write(json.dumps({"i": i}) + "\n")
    with open(os.path.join(d, "test.jepsen"), "wb") as f:
        f.write(bytes(range(256)) * (1 + extra))
    return d, f"{name}/{ts}"


def _tree(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for fn in files:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.mark.parametrize("extra", [0, 3, 400])
def test_pack_run_dir_equal_bytes_on_one_directory(tmp_path, extra):
    src, _ = _make_run_dir(str(tmp_path), extra=extra)
    data_t, dig_t = tart.pack_run_dir(src)
    data_j, dig_j = jart.pack_run_dir(src)
    assert data_t == data_j and dig_t == dig_j
    assert dig_t == hashlib.sha256(data_t).hexdigest()
    spool_t, spool_j = io.BytesIO(), io.BytesIO()
    assert tart.pack_run_dir_file(src, spool_t) == \
        jart.pack_run_dir_file(src, spool_j)
    assert spool_t.getvalue() == spool_j.getvalue() == data_t


def _a_chunked(P, base):
    src, rel = _make_run_dir(os.path.join(base, "worker"))
    data, digest = jart.pack_run_dir(src)
    cbase = os.path.join(base, "coord")
    st = P.A.ArtifactStore(cbase)
    p = {"total": len(data), "digest": digest, "rel": rel}
    out = [st.handle("r1", {}, b""),
           st.handle("r1", dict(p, offset=100), data[100:200]),
           st.handle("r1", dict(p, offset=0), data[:200]),
           st.handle("r1", dict(p, offset=100), data[100:300])]
    st2 = P.A.ArtifactStore(cbase)  # the coordinator restarted
    out += [st2.handle("r1", {}, b""),
            st2.handle("r1", dict(p, offset=300), data[300:]),
            st2.handle("r1", dict(p, offset=0), data[:200])]
    assert out[-2][1]["landed"] is True and out[-1][1]["already"] is True
    assert _tree(os.path.join(cbase, rel)) == _tree(src)
    assert not os.path.exists(os.path.join(cbase, "fleet", "staging",
                                           "r1.tar"))
    return out, _tree(os.path.join(cbase, rel)), \
        sorted(os.listdir(os.path.join(cbase, "fleet", "staging")))


def _a_digest_mismatch(P, base):
    src, rel = _make_run_dir(os.path.join(base, "w"))
    data, digest = jart.pack_run_dir(src)
    src2, _ = _make_run_dir(os.path.join(base, "w2"), extra=7)
    data2, digest2 = jart.pack_run_dir(src2)
    st = P.A.ArtifactStore(os.path.join(base, "c"))
    out = [st.handle("r2", {"offset": 0, "total": len(data),
                            "digest": "0" * 64, "rel": rel}, data),
           st.handle("r2", {"offset": 0, "total": len(data2),
                            "digest": digest2, "rel": rel}, data2[:100]),
           st.handle("r2", {"offset": 0, "total": len(data),
                            "digest": digest, "rel": rel}, data)]
    assert out[0][0] == 409 and out[-1][1]["landed"] is True
    return out, _tree(os.path.join(base, "c", rel))


def _a_reexecution(P, base):
    wbase = os.path.join(base, "w")
    src, rel = _make_run_dir(wbase, ts="t1")
    data, digest = jart.pack_run_dir(src)
    src2, rel2 = _make_run_dir(wbase, ts="t2", extra=3)
    data2, digest2 = jart.pack_run_dir(src2)
    cbase = os.path.join(base, "c")
    st = P.A.ArtifactStore(cbase)
    p = {"total": len(data), "digest": digest, "rel": rel}
    p2 = {"total": len(data2), "digest": digest2, "rel": rel2}
    out = [st.handle("r1", dict(p, offset=0), data), st.handle("r1", {}, b""),
           st.handle("r1", dict(p2, offset=0), data2),
           st.handle("r1", dict(p, offset=0), data)]
    assert "already" not in out[2][1] and out[3][1]["already"] is True
    return out, _tree(os.path.join(cbase, rel)), \
        _tree(os.path.join(cbase, rel2))


def _a_traversal(P, base):
    st = P.A.ArtifactStore(base)
    base_p = {"offset": 0, "total": 10, "digest": "d" * 64}
    out = [st.handle("r3", dict(base_p, rel=rel), b"x" * 10)
           for rel in ("../evil/t", "a/../../b", "a", "a/b/c", ".hide/t",
                       "a/.incoming-t", "campaigns/t", "verifier/t",
                       "fleet/t")]
    out.append(st.handle("../run", {}, b""))
    out.append(st.handle("r3", {"offset": 0}, b"x"))  # missing params
    out.append(st.handle("r3", dict(base_p, rel="a/t", offset=5),
                         b"x" * 10))  # past the declared total
    assert all(code == 400 for code, _ in out)
    return out


def _a_hostile(P, base):
    cases = []
    for name, kind in (("../escape.txt", tarfile.REGTYPE),
                       ("/abs.txt", tarfile.REGTYPE),
                       ("link", tarfile.SYMTYPE),
                       ("dev", tarfile.CHRTYPE)):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            info = tarfile.TarInfo(name)
            info.type = kind
            payload = b"pwned" if kind == tarfile.REGTYPE else b""
            info.size = len(payload)
            if kind == tarfile.SYMTYPE:
                info.linkname = "/etc/passwd"
            info.mtime = 0
            tf.addfile(info, io.BytesIO(payload))
        cases.append(buf.getvalue())
    st = P.A.ArtifactStore(base)
    out = []
    for i, evil in enumerate(cases):
        p = {"offset": 0, "total": len(evil),
             "digest": hashlib.sha256(evil).hexdigest(),
             "rel": f"a-test/t{i}"}
        out.append(st.handle(f"r{i}", p, evil))
    assert all(code == 409 and "unpack" in r["error"] for code, r in out)
    assert not os.path.exists(os.path.join(base, "escape.txt"))
    return out, sorted(os.listdir(base)), \
        sorted(os.listdir(os.path.join(base, "a-test")))


ARTIFACT_SCRIPTS = {
    "chunked resumable idempotent": _a_chunked,
    "digest mismatch and new upload discard": _a_digest_mismatch,
    "re-execution lands a new rel": _a_reexecution,
    "traversal and reserved subtrees": _a_traversal,
    "hostile tar members": _a_hostile,
}


@pytest.mark.parametrize("script", sorted(ARTIFACT_SCRIPTS))
def test_artifact_store_sequences_equal(tmp_path, clock, script):
    both(tmp_path, ARTIFACT_SCRIPTS[script], clock)


def _staging_gc(P, base):
    st = P.A.ArtifactStore(base)
    os.makedirs(st.staging, exist_ok=True)
    now = time.time()

    def stage(run_id, started, landed=False, meta=True):
        part = os.path.join(st.staging, run_id + ".tar")
        with open(part, "wb") as f:
            f.write(b"x" * 64)
        os.utime(part, (started, started))
        if not meta:
            return
        doc = {"run": run_id, "total": 128, "digest": "d",
               "rel": "a/t", "started": started}
        if landed:
            doc["landed"] = True
            doc["landed-at"] = started
        with open(os.path.join(st.staging, run_id + ".json"), "w") as f:
            json.dump(doc, f)

    stage("old-abandoned", now - 1000)
    stage("old-landed-marker", now - 1000, landed=True)
    stage("orphan-part", now - 1000, meta=False)
    stage("fresh", now - 10)
    out = st.gc(retention_s=100, now=now)
    left = sorted(os.listdir(st.staging))
    gauge = P.tel.registry().gauge("fleet-artifact-staging-bytes").value
    assert out["removed"] == 3 and left == ["fresh.json", "fresh.tar"]
    assert gauge == out["staging-bytes"] > 0
    return out, left, st.gc(retention_s=100, now=now)


def test_artifact_staging_gc_expires_abandoned_partials(tmp_path, clock):
    both(tmp_path, _staging_gc, clock)


# ---------------------------------------------------------- coordinator

def _coord_scenario(P, base, clock):
    """One scheduled campaign driven by scripted calls: register, claim
    (window broadcast and t0 anchor), heartbeat ticks with metrics,
    complete, a resend, lease expiry and the zombie's duplicate,
    release, status, the federated series, a second boot."""
    out = []
    coord = P.C.FleetCoordinator(SCHED_SPEC, base, lease_s=5.0)
    out.append(("boot", coord.boot_digest, coord.gen, coord.finished))
    out.append(coord.register({"worker": "wa", "host": "ha",
                               "backend": "cuda", "version": "v1"}))
    out.append(coord.register({}))
    code, r1 = coord.claim({"worker": "wa"})
    out.append((code, r1))
    assert "compilecache" not in r1
    run1 = r1["spec"]["run_id"]
    ticks = {"gen": r1["windows"]["gen"], "digest": r1["windows"]["digest"],
             "open": [{"pos": 0, "fault": "skew"}], "t0": r1["windows"]["t0"]}
    rows = [{"name": "worker-cells-done", "kind": "counter", "labels": {},
             "value": 3},
            {"name": "worker-rss-peak-bytes", "kind": "gauge",
             "labels": {}, "value": 1500.0}, {"name": "bad"}]
    out.append(coord.heartbeat({"worker": "wa", "windows": ticks,
                                "metrics": rows, "version": "v2",
                                "state": {"run": run1}, "renew": [run1]}))
    out.append(coord.heartbeat({"worker": "ghost", "renew": [run1]}))
    out.append(coord.status())
    out.append(sorted(P.prom.render_fleet(coord)))
    code, r2 = coord.claim({"worker": "wb"})
    out.append((code, r2))
    run2 = r2["spec"]["run_id"]
    rec1 = {"run": run1, "key": "bank|nofault|s0", "valid?": True,
            "wall_s": 0.5, "spans": {"workload": 0.25}}
    resend = json.loads(json.dumps(rec1))  # as a lost ack's retry sends
    out.append(coord.complete({"worker": "wa", "run": run1,
                               "record": rec1}))
    out.append(coord.complete({"worker": "wa", "run": run1,
                               "record": resend}))
    out.append(coord.complete({"worker": "wa", "run": "nope",
                               "record": rec1}))
    out.append(coord.complete({"worker": "wa"}))
    # wb stops renewing: its lease lapses and another worker takes it
    clock.now += 6.0
    out.append(coord.heartbeat({"worker": "wc", "renew": []}))
    code, r3 = coord.claim({"worker": "wc"})
    out.append((code, r3))
    rec2 = {"run": run2, "key": "bank|nofault|s1", "valid?": False,
            "wall_s": 0.7}
    out.append(coord.complete({"worker": "wc", "run": run2,
                               "record": rec2}))
    out.append(coord.complete({"worker": "wb", "run": run2,
                               "record": dict(rec2, wall_s=9.0)}))
    out.append(coord.release({"worker": "wc", "run": run2}))
    out.append(coord.claim({"worker": "wc"}))
    out.append(coord.status())
    out.append(coord.cache_index())
    out.append(coord.cache_blob("x"))
    out.append(coord.artifact("r9", {}, b""))
    out.append(coord.federated_metrics())
    out.append(coord.gc_staging())
    idx = P.Index(P.ccore.index_path(SCHED_SPEC["name"], base))
    out.append(idx.records)
    with open(P.Q.fleet_path(SCHED_SPEC["name"], base), "rb") as f:
        out.append(f.read())
    coord.close()
    with open(P.ccore.live_path(SCHED_SPEC["name"], base)) as f:
        live = json.load(f)
    out.append({k: live.get(k) for k in ("campaign", "total", "done",
                                         "finished")})
    again = P.C.FleetCoordinator(SCHED_SPEC, base, lease_s=5.0)
    out.append((again.boot_digest, again.queue.digest(), again.finished,
                again.claim({"worker": "late"})))
    again.close()
    return out


def test_coordinator_scripted_calls_equal(tmp_path, clock):
    out = both(tmp_path, lambda P, base: _coord_scenario(P, base, clock),
               clock)
    status = out[6][1]
    assert status["workers"]["wa"]["windows"]["synced"] is True
    assert status["workers"]["wa"]["windows"]["clock-synced"] is True
    assert status["workers"]["wa"]["version"] == "v2"
    assert "ghost" not in status["workers"]
    final = out[-10][1]
    assert out[9][1]["status"] == "accepted"
    assert out[10][1]["status"] == "already"
    assert final["finished"] and final["counts"]["duplicates"] == 1
    assert final["counts"]["requeues"] == 1
    assert out[-1][2] is True and out[-1][3][1]["finished"] is True


def test_coordinator_no_compile_cache(tmp_path):
    """The port's differences: no secret minted, no advert in a claim,
    an empty ``/fleet/cache`` and a 404 for an entry, even where the
    store holds files under ``compilecache/``; the JAX coordinator
    mints ``fleet/secret``."""
    for name, P in PKGS.items():
        base = str(tmp_path / name)
        os.makedirs(os.path.join(base, "compilecache"))
        with open(os.path.join(base, "compilecache", "e1.bin"), "wb") as f:
            f.write(b"entry")
        coord = P.C.FleetCoordinator(dict(SPEC, seeds=[0]), base)
        try:
            secret = os.path.exists(os.path.join(base, "fleet", "secret"))
            code, r = coord.claim({"worker": "w"})
            if name == "jax":
                assert secret
                continue
            assert not secret and code == 200 and r["spec"]
            assert "compilecache" not in r
            assert coord.cache_index() == (200, {"entries": [],
                                                 "bytes": 0})
            assert coord.cache_blob("e1.bin") == (
                404, {"error": "no cache entry 'e1.bin'"})
            assert not hasattr(coord, "cache_dir")
        finally:
            coord.close()


def _reconcile(P, base):
    spec = dict(SPEC, name="fl-rec", seeds=[0, 1])
    ids = [rs.run_id for rs in P.plan.expand(spec)]
    q = P.Q.WorkQueue(P.Q.fleet_path("fl-rec", base))
    for rs in P.plan.expand(spec):
        q.enqueue(rs.to_dict())
    q.claim("w1", lease_s=9.0)
    rec = {"run": ids[0], "key": "set|nofault|s0", "valid?": True,
           "wall_s": 0.1}
    assert q.complete(ids[0], "w1", rec) == "accepted"
    pre = P.Q.WorkQueue(P.Q.fleet_path("fl-rec", base)).digest()
    coord = P.C.FleetCoordinator(spec, base, lease_s=5.0)
    assert coord.boot_digest == pre
    coord.close()
    P.C.FleetCoordinator(spec, base, lease_s=5.0).close()
    recs = P.Index(P.ccore.index_path("fl-rec", base)).records
    assert len([r for r in recs if r["run"] == ids[0]]) == 1
    return pre, recs


def test_coordinator_reconciles_index_from_ledger(tmp_path, clock):
    pre, recs = both(tmp_path, _reconcile, clock)
    assert recs[0]["fleet-worker"] == "w1" and recs[0]["valid?"] is True


def _scoped(P, base):
    spec = dict(SPEC, name="fl-scope", seeds=[0])
    run_id = P.plan.expand(spec)[0].run_id
    coord = P.C.FleetCoordinator(spec, base, lease_s=5.0)
    out = [coord.heartbeat({"campaign": "other", "total": 3,
                            "worker": "campaign-worker-0",
                            "state": {"run": "r-other", "slot": 0}})]
    out.append(sorted(coord.status()[1]["workers"]))
    out.append(coord.claim({"worker": "real-w"}))
    out.append(coord.complete({"worker": "real-w", "run": run_id,
                               "record": {"run": run_id, "key": "k",
                                          "valid?": True}}))
    out.append(sorted(coord.status()[1]["workers"]))
    coord.close()
    for name in ("fl-scope", "other"):
        with open(P.ccore.live_path(name, base)) as f:
            doc = json.load(f)
        out.append((doc["finished"], sorted(doc["workers"])))
    assert out[1] == [] and out[4] == ["real-w"]
    assert out[-2][0] is True and out[-1][0] is False
    return out


def test_coordinator_close_and_touch_scoped_to_own_fleet(tmp_path, clock):
    both(tmp_path, _scoped, clock)


def _warehouse_ledger(P, base):
    q = P.Q.WorkQueue(P.Q.fleet_path("wf", base))
    for i in range(3):
        q.enqueue(_spec(f"r{i}"))
    q.claim("hostA", lease_s=0.1, now=0.0)
    q.expire(now=1.0)
    q.claim("hostB", lease_s=9.0, now=1.0)
    q.complete("r0", "hostB", {"valid?": True})
    q.complete("r0", "hostA", {"valid?": True})
    wh = P.wmod.open_or_create(base)
    try:
        out = [wh.ingest_store(base)["fleet-events"],
               wh.fleet_worker_rollup("fleet/wf.jsonl"),
               wh.ingest_store(base)["fleet-events"]]
        q.complete("r1", "hostB", {"valid?": False})
        out.append(wh.ingest_store(base)["fleet-events"])
    finally:
        wh.close()
    assert out[0] == 8 and out[1][0]["worker"] == "hostA"
    return out


def test_warehouse_ingests_the_ports_fleet_ledger(tmp_path, clock):
    both(tmp_path, _warehouse_ledger, clock)


def _federated(P, base):
    spec = {"name": "fed", "workloads": ["noop"], "seeds": [0], "opts": {}}
    coord = P.C.FleetCoordinator(spec, base, lease_s=0.2)
    coord.register({"worker": "w1", "host": "h1"})
    coord.register({"worker": "w2", "host": "h2"})
    rows = [{"name": "worker-cells-done", "kind": "counter",
             "labels": {}, "value": 3},
            {"name": "worker-rss-bytes", "kind": "gauge",
             "labels": {}, "value": 1000.0},
            {"name": "worker-rss-peak-bytes", "kind": "gauge",
             "labels": {}, "value": 1500.0}]
    coord.heartbeat({"worker": "w1", "metrics": rows})
    coord.heartbeat({"worker": "w2", "metrics": [dict(rows[0], value=5)]})
    live = P.prom.render_fleet(coord)
    with coord._lock:
        for c in coord.workers.values():
            c["last-seen"] -= 10.0
    retired = P.prom.render_fleet(coord)
    coord.close()
    text = "\n".join(live)
    assert 'jepsen_fleet_host_worker_cells_done_total{host="w1"} 3' in text
    assert "jepsen_fleet_rollup_worker_cells_done_total 8" in text
    assert 'jepsen_fleet_host_worker_rss_peak_bytes{host="w1"} 1500' \
        in text
    assert not any(ln.startswith("jepsen_fleet_host_") for ln in retired)
    return live, retired


def test_federated_metrics_host_labels_rollups_and_retirement(tmp_path,
                                                              clock):
    both(tmp_path, _federated, clock)


def _churn(P, base):
    spec = {"name": "fed", "workloads": ["noop"], "seeds": [0], "opts": {}}
    coord = P.C.FleetCoordinator(spec, base, lease_s=0.05)
    counts = []
    for gen in range(6):
        name = f"churn-{gen}"
        coord.register({"worker": name, "host": name})
        coord.heartbeat({"worker": name, "metrics": [
            {"name": "worker-cells-done", "kind": "counter", "labels": {},
             "value": gen},
            {"name": "worker-rss-peak-bytes", "kind": "gauge",
             "labels": {}, "value": 1000 + gen}]})
        counts.append(sum(1 for ln in P.prom.render_fleet(coord)
                          if ln.startswith("jepsen_fleet_host_")))
        with coord._lock:
            for c in coord.workers.values():
                c["last-seen"] -= 100 * P.C.PRUNE_LEASES
    coord._update_gauges()
    with coord._lock:
        left = dict(coord.workers)
    coord.close()
    assert counts == [counts[0]] * len(counts) and not left
    return counts


def test_federation_cardinality_flat_under_worker_churn(tmp_path, clock):
    both(tmp_path, _churn, clock)


def test_worker_metrics_snapshot_shape_and_cap(tmp_path):
    snaps = {}
    for name, P in PKGS.items():
        w = P.W.FleetWorker("http://127.0.0.1:1", str(tmp_path), name="w")
        rows = w.metrics_snapshot()
        assert 0 < len(rows) <= P.W.MAX_PUSHED_SERIES
        for r in rows:
            assert r["kind"] in ("counter", "gauge")
            assert isinstance(r["value"], (int, float))
            assert isinstance(r["labels"], dict)
        snaps[name] = rows
    want = {"worker-cells-done", "worker-uploads-done",
            "worker-duplicate-completions", "jit-cache-entries",
            "compile-cache-miss", "worker-rss-bytes",
            "worker-rss-peak-bytes"}
    assert want <= {r["name"] for r in snaps["torch"]}
    assert [r["name"] for r in snaps["torch"][:5]] == \
        [r["name"] for r in snaps["jax"][:5]]
    assert tworker.MAX_PUSHED_SERIES == jworker.MAX_PUSHED_SERIES


def test_worker_claim_backoff_seeded_equal_and_budgeted():
    streams = {}
    for name, P in PKGS.items():
        for wn in ("wa", "wb"):
            w = P.W.FleetWorker("http://127.0.0.1:1", "store", name=wn,
                                poll_s=0.1)
            streams[name, wn] = [w._claim_backoff(i) for i in range(1, 9)]
    assert streams["torch", "wa"] == streams["jax", "wa"]
    assert streams["torch", "wb"] == streams["jax", "wb"]
    assert streams["torch", "wa"] != streams["torch", "wb"]
    w = tworker.FleetWorker("http://127.0.0.1:1", "store", name="wc",
                            poll_s=0.01, claim_budget_s=0.05)
    w.register = lambda: None
    calls = []

    def dead_post(site, path, doc):
        calls.append(site)
        raise ConnectionRefusedError("down")

    w._post = dead_post
    with pytest.raises(ConnectionRefusedError):
        w.run()
    assert len(calls) > 1


def test_worker_installs_the_claims_windows_as_jax_does(tmp_path, clock):
    """The claim's window set is authoritative over a stale spec; the
    installed opts, digests and ticks equal the JAX worker's."""
    seen = {}
    for name, P in PKGS.items():
        clock.now = 1_700_000_000.0
        base = str(tmp_path / name)
        coord = P.C.FleetCoordinator(SCHED_SPEC, base, lease_s=5.0)
        try:
            code, r = coord.claim({"worker": "w"})
            w = P.W.FleetWorker("http://127.0.0.1:1", base, name="w")
            stale = dict(r["spec"], opts=dict(r["spec"]["opts"]))
            stale["opts"].pop("nemesis-windows", None)
            rs = (jplan if name == "jax" else tplan).RunSpec.from_dict(stale)
            w._install_windows(rs, r["windows"])
            seen[name] = (r["windows"], rs.opts, w.installed_windows,
                          w._window_ticks(0.0))
        finally:
            coord.close()
    assert seen["torch"] == seen["jax"]
    wins, opts, _, ticks = seen["torch"]
    assert opts["nemesis-windows"] == jplan.schedule_windows(
        SCHED_SPEC, wins["gen"])
    assert opts["_fleet-host"] == "w" and ticks["t0"] == wins["t0"]


def test_cpu_worker_keeps_the_run_id(tmp_path, monkeypatch):
    """`FleetWorker(cpu=True)` puts ``"cpu"`` into the claimed cell's
    opts after `RunSpec.from_dict`: its record carries the coordinator's
    run id, and the run's checkers ran with ``device="cpu"``."""
    seen = []

    def fake_execute(rs, base):
        seen.append((rs.run_id, dict(rs.opts)))
        return {"run": rs.run_id, "key": rs.key, "valid?": True}

    monkeypatch.setattr(tccore, "execute_run", fake_execute)
    base = str(tmp_path)
    spec = dict(SPEC, name="fl-cpu", workloads=["append"], seeds=[0])
    coord = tcoord.FleetCoordinator(spec, base, lease_s=5.0)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for cpu in (True, False):
            w = tworker.FleetWorker(url, base, name=f"w{cpu}",
                                    poll_s=0.05, cpu=cpu)
            if cpu:
                assert w.run() == 1
            else:
                w._run_cell(tplan.expand(spec)[0].to_dict())
    finally:
        srv.server_close()
        coord.close()
    (rid, opts), (rid2, opts2) = seen
    assert rid == rid2 == tplan.expand(spec)[0].run_id
    assert opts["cpu"] is True and "cpu" not in opts2
    assert rid == jplan.expand(spec)[0].run_id


# --------------------------------------------- HTTP end to end (real IO)

def _get(url, path, timeout=10):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.read().decode()


def _post(url, path, doc, timeout=10):
    req = urllib.request.Request(
        url + path, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _post_raw(url, path, body, timeout=10):
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/octet-stream"},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode() or "{}")


def _join(threads, seconds):
    t_end = time.monotonic() + seconds
    for t in threads:
        t.join(timeout=max(0.1, t_end - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "workers wedged"


FLEET_SPEC = {"name": "fl", "workloads": ["set", "append"],
              "seeds": [0, 1, 2], "opts": {"time-limit": 0.15}}


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """One 6-cell campaign (set and append, three seeds) run by two
    `FleetWorker(cpu=True)` threads against the port's coordinator on
    the port's `web.serve`, over a real socket, the workers uploading
    their run dirs into a store of their own."""
    base = str(tmp_path_factory.mktemp("fleet"))
    wbase = str(tmp_path_factory.mktemp("fleet-workers"))
    coord = tcoord.FleetCoordinator(FLEET_SPEC, base, lease_s=5.0)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    ws = [tworker.FleetWorker(url, wbase, name=f"w{i}", poll_s=0.05,
                              cpu=True, upload=True) for i in range(2)]
    ts = [threading.Thread(target=w.run, daemon=True) for w in ws]
    for t in ts:
        t.start()
    try:
        _join(ts, 180)
        # the workers stop once the coordinator reports the campaign
        # finished, and the worker table and the federated host series
        # follow their liveness: three leases (15 s here) after their
        # last heartbeat the series retire.  So the status, metrics and
        # fleet documents are read as the fleet finishes, not after the
        # tests in between (the JAX campaign alone takes 12-19 s)
        seen = {path: _get(url, path)
                for path in ("/fleet/status", "/metrics", "/fleet")}
        yield base, url, coord, ws, seen
    finally:
        srv.server_close()
        coord.close()


def test_fleet_every_cell_exactly_one_record(fleet_run):
    base, url, coord, ws, _seen = fleet_run
    idx = TIndex(tccore.index_path("fl", base))
    per_run = {}
    for rec in idx.records:
        assert rec["valid?"] in (True, False, "unknown")
        per_run[rec["run"]] = per_run.get(rec["run"], 0) + 1
        assert rec.get("fleet-worker") in ("w0", "w1")
        assert os.path.isdir(os.path.join(base, rec["dir"])), rec
    assert per_run == {rs.run_id: 1 for rs in jplan.expand(FLEET_SPEC)}
    assert sum(w.cells_done for w in ws) == 6
    assert sum(w.uploads_done for w in ws) == 6


def test_fleet_matches_the_jax_campaign(fleet_run, tmp_path):
    base, *_ = fleet_run
    ref = jcamp.run_campaign(FLEET_SPEC, str(tmp_path), workers=2)
    want = {r["key"]: r["valid?"] for r in ref["rows"]}
    got = {rec["key"]: rec["valid?"] for rec in
           TIndex(tccore.index_path("fl", base)).latest_by_run().values()}
    assert got == want and set(want.values()) == {True}


def test_fleet_status_metrics_and_cache_routes(fleet_run):
    base, url, coord, _ws, seen = fleet_run
    s = json.loads(seen["/fleet/status"])
    assert s["finished"] is True and s["done"] == 6
    assert s["counts"]["done"] == 6 and s["counts"]["queued"] == 0
    assert s["digest"] and s["boot-digest"]
    assert set(s["workers"]) == {"w0", "w1"}
    body = seen["/metrics"]
    assert "jepsen_fleet_workers_alive" in body
    assert 'jepsen_fleet_cells{state="done"} 6' in body
    assert "jepsen_fleet_leases_active 0" in body
    assert 'jepsen_fleet_host_worker_cells_done_total{host="w' in body
    assert json.loads(_get(url, "/fleet/cache")) == {"entries": [],
                                                     "bytes": 0}
    for path in ("/fleet/cache/x", "/run/x", "/timeline/x"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url, path)
        assert e.value.code == 404, path
    page = seen["/fleet"]
    assert "fleet — fl" in page and "w0" in page and "w1" in page
    # the index page links the fleet dashboard and the campaigns
    index = _get(url, "/")
    assert 'href="/fleet"' in index and 'href="/campaigns"' in index
    assert ">fl<" in _get(url, "/campaigns")
    for path in ("/ingest/s?cursor=0", "/verifier/s/open"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, path, {})
        assert e.value.code == 404
        assert "no verifier service" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/fleet/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_raw(url, "/fleet/claim", b"[1]")
    assert e.value.code == 400


def test_fleet_live_page_renders_coordinator_heartbeat(fleet_run):
    """The coordinator's heartbeat writer produces the live.json shape
    the single-process scheduler writes: ``/campaign/<n>/live`` renders
    it unchanged."""
    base, url, *_ = fleet_run
    with open(tccore.live_path("fl", base)) as f:
        doc = json.load(f)
    assert doc["finished"] is True and doc["done"] == 6
    page = _get(url, "/campaign/fl/live")
    assert "finished" in page and "6/6 runs done" in page


def test_scheduler_and_fleet_heartbeats_share_one_shape(tmp_path):
    """Both writers, the scheduler's file-only `Heartbeat` and the
    coordinator's HTTP-fed one, render on ``/campaign/<n>/live``, and
    ``/fleet`` names the worker that pushed."""
    base = str(tmp_path)
    hb = ttel.Heartbeat(tccore.live_path("filecamp", base),
                        campaign="filecamp", total=4)
    hb.worker("campaign-worker-0", {"run": "r-file", "workload": "set",
                                    "fault": "nofault", "seed": 0,
                                    "slot": None})
    coord = tcoord.FleetCoordinator(dict(SPEC, name="fl-hb", seeds=[0]),
                                    base, lease_s=5.0)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        page = _get(url, "/campaign/filecamp/live")
        assert "r-file" in page and "campaign-worker-0" in page
        _post(url, "/fleet/register", {"worker": "remote-w",
                                       "host": "remote-w"})
        _post(url, "/fleet/heartbeat",
              {"worker": "remote-w", "state": {
                  "run": "r-http", "workload": "set",
                  "fault": "nofault", "seed": 1, "slot": None}})
        page = _get(url, "/campaign/fl-hb/live")
        assert "r-http" in page and "remote-w" in page
        page = _get(url, "/fleet")
        assert "fleet — fl-hb" in page and "remote-w" in page
    finally:
        srv.server_close()
        coord.close()


def test_fleet_finished_campaign_resumes_zero(fleet_run):
    base, *_ = fleet_run
    c2 = tcoord.FleetCoordinator(FLEET_SPEC, base, lease_s=5.0)
    try:
        assert c2.finished and c2.queue.counts()["queued"] == 0
        code, r = c2.claim({"worker": "late"})
        assert code == 200 and r["spec"] is None and r["finished"]
    finally:
        c2.close()
    summary = tcamp.run_campaign(FLEET_SPEC, base, workers=2, cpu=True)
    assert summary["executed"] == 0 and summary["skipped"] == 6


def test_fleet_lease_expiry_requeue_and_zombie_discard(tmp_path):
    base = str(tmp_path)
    spec = dict(SPEC, name="fl-ghost", seeds=[0, 1, 2])
    coord = tcoord.FleetCoordinator(spec, base, lease_s=0.6)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        ghost = _post(url, "/fleet/claim", {"worker": "ghost"})
        run = ghost["spec"]["run_id"]
        time.sleep(0.7)
        w = tworker.FleetWorker(url, base, name="alive", poll_s=0.05,
                                cpu=True)
        t = threading.Thread(target=w.run, daemon=True)
        t.start()
        _join([t], 60)
        s = json.loads(_get(url, "/fleet/status"))
        assert s["finished"] and s["counts"]["requeues"] >= 1
        idx = TIndex(tccore.index_path("fl-ghost", base))
        assert {r.run_id for r in jplan.expand(spec)} == \
            {rec["run"] for rec in idx.records}
        r = _post(url, "/fleet/complete",
                  {"worker": "ghost", "run": run,
                   "record": {"run": run, "valid?": True, "wall_s": 99.0}})
        assert r == {"ok": False, "duplicate": True}
        assert json.loads(_get(url, "/fleet/status"))[
            "counts"]["duplicates"] == 1
        assert len([rec for rec in TIndex(tccore.index_path(
            "fl-ghost", base)).records if rec["run"] == run]) == 1
    finally:
        srv.server_close()
        coord.close()


def test_nemesis_broadcast_survives_heartbeat_chaos(tmp_path):
    """With the worker's ``fleet.heartbeat`` seam dead, the records'
    installed-window digests still equal the JAX package's schedule."""
    from jepsen_tpu_torch.resilience import RetryPolicy
    from jepsen_tpu_torch.resilience.faults import FaultPlan, use
    from jepsen_tpu_torch.resilience.policy import is_transient_http

    base = str(tmp_path)
    spec = dict(SCHED_SPEC, name="fl-chaos-hb")
    coord = tcoord.FleetCoordinator(spec, base, lease_s=30.0)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    plan = FaultPlan(persistent=("fleet.heartbeat",), kinds=("oom",))
    try:
        w = tworker.FleetWorker(url, base, name="deaf", poll_s=0.05,
                                cpu=True,
                                retry=RetryPolicy(
                                    max_attempts=2, base_delay_s=0.02,
                                    classify=is_transient_http))
        with use(plan):
            t = threading.Thread(target=w.run, daemon=True)
            t.start()
            _join([t], 120)
        assert len(plan.injected) > 0
        recs = list(TIndex(tccore.index_path(
            "fl-chaos-hb", base)).latest_by_run().values())
        assert len(recs) == 2
        for rec in recs:
            assert rec["windows-digest"] == jplan.windows_digest(
                jplan.schedule_windows(spec, rec["seed"]))
        assert "windows" not in coord.status()[1]["workers"]["deaf"]
    finally:
        srv.server_close()
        coord.close()


def test_run_campaign_pushes_heartbeat_to_the_ports_coordinator(tmp_path):
    coord_base = str(tmp_path / "coord")
    camp_base = str(tmp_path / "camp")
    coord = tcoord.FleetCoordinator(dict(SPEC, name="fl-push", seeds=[0]),
                                    coord_base, lease_s=5.0)
    srv = tweb.serve(port=0, base=coord_base, background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        spec = {"name": "pushed", "workloads": ["noop"], "seeds": [0],
                "opts": {"coordinator": url}}
        summary = tcamp.run_campaign(spec, camp_base, workers=1, cpu=True)
        assert summary["executed"] == 1
        assert not os.path.exists(tccore.live_path("pushed", camp_base))
        with open(tccore.live_path("pushed", coord_base)) as f:
            doc = json.load(f)
        assert doc["campaign"] == "pushed" and doc["finished"] is True
        assert doc["total"] == 1 and doc["done"] == 1
    finally:
        srv.server_close()
        coord.close()


def test_status_joins_verifier_freshness(tmp_path):
    from jepsen_tpu_torch.verifier import VerifierService

    base = str(tmp_path)
    coord = tcoord.FleetCoordinator(dict(SPEC, seeds=[0]), base)
    ver = VerifierService(base)
    srv = tweb.serve(port=0, base=base, background=True, fleet=coord,
                     verifier=ver)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        coord.register({"worker": "fw1", "host": "fw1"})
        assert ver.open("livesess", {"host": "fw1"})[0] == 200
        assert ver.ingest("livesess", b'{"type": "invoke", "process": 0, '
                          b'"f": "txn", "value": []}\n')[0] == 200
        doc = json.loads(_get(url, "/fleet/status"))
        assert "fw1" in doc["verifier-freshness"]
        row = doc["workers"]["fw1"]
        assert isinstance(row["verdict-freshness-s"], (int, float))
        assert row["live-sessions"] == 1
        # the verifier's POST routes are served beside the fleet's: the
        # resend of an acked byte is an idempotent replay
        ack = _post_raw(url, "/ingest/livesess?cursor=1", b"{}")
        assert ack["replayed"] is True and ack["cursor"] > 1
    finally:
        srv.server_close()
        ver.close()
        coord.close()


def test_serve_background_close_joins_its_thread(tmp_path):
    before = set(threading.enumerate())
    srv = tweb.serve(port=0, base=str(tmp_path), background=True)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url, "/fleet/status")
    assert e.value.code == 404
    assert "no fleet coordinator" in json.loads(e.value.read())["error"]
    _get(url, "/metrics")  # 200 without a fleet too
    srv.server_close()
    assert set(threading.enumerate()) <= before


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kill9_coordinator_mid_upload_resumable_then_lands(tmp_path):
    """The federation crash pin, the coordinator a ``python -m
    jepsen_tpu_torch fleet serve`` child: kill -9 it mid-upload; the
    staged partial survives, the restart's boot digest equals the
    digest before the kill, the worker resumes from the durable cursor
    and the landed dir is byte-equal to the source."""
    cbase = str(tmp_path / "coord")
    wbase = str(tmp_path / "worker")
    os.makedirs(cbase)
    spec_path = str(tmp_path / "fed.json")
    with open(spec_path, "w") as f:
        json.dump({"name": "fed", "workloads": ["noop"], "seeds": [0],
                   "opts": {"time-limit": 0.05}}, f)
    src, rel = _make_run_dir(wbase, extra=400)
    data, digest = tart.pack_run_dir(src)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO

    def spawn():
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", "--store-dir",
             cbase, "fleet", "serve", spec_path, "-p", str(port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env, cwd=str(tmp_path))
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                return proc, json.loads(_get(url, "/fleet/status",
                                             timeout=2))
            except Exception:  # noqa: BLE001 — not up yet
                time.sleep(0.2)
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError("the coordinator did not come up")

    proc, _ = spawn()
    chunk = 1024
    sent = 0
    try:
        _post(url, "/fleet/claim", {"worker": "doomed"})
        pre = json.loads(_get(url, "/fleet/status"))["digest"]
        while sent < min(3 * chunk, len(data) // 2):
            r = _post_raw(url, f"/fleet/artifact/up1?offset={sent}"
                          f"&total={len(data)}&digest={digest}"
                          f"&rel={rel}", data[sent:sent + chunk])
            assert r["received"] == sent + len(data[sent:sent + chunk])
            sent = r["received"]
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    part = os.path.join(cbase, "fleet", "staging", "up1.tar")
    assert os.path.getsize(part) == sent
    proc, status = spawn()
    try:
        assert status["boot-digest"] == pre
        assert status["counts"]["claimed"] == 1
        w = tworker.FleetWorker(url, wbase, name="up-w")
        assert w.upload_artifact("up1", rel) is True
        assert w.uploads_done == 1
        assert _tree(os.path.join(cbase, rel)) == _tree(src)
        assert w.upload_artifact("up1", rel) is True
    finally:
        proc.kill()
        proc.wait(timeout=10)
