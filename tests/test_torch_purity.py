"""The port's purity: importing every module of `jepsen_tpu_torch` and
running a check (`core_check_exact`, `list_append.check`, `oracle.check`,
`rw_register.check`, Knossos, the native `wgl.check`, `session.check`,
the queue checks, `stream.check_stored`, `batch.check_batch`,
`op_shard.check_sharded` on a 3-shard mesh, `hybrid.check_batch_hybrid`, a
telemetric, live-checked `core.run` of the `append` demo, and the CLI's
`shrink` of a bank run and `campaign run` of bank, kafka and noop cells
with auto-shrink, then `obs ingest` and `obs alerts --eval` of that
store, a warehouse-backed `Index`, the Prometheus exposition, the Knossos
CLI and `repl.recheck`, all on the CPU) in a fresh
interpreter must load neither `jax` nor `jepsen_tpu`; nor may the fleet
(a coordinator on the port's `web.serve`, a `FleetWorker(cpu=True)`
running and uploading one append cell, an `Autopilot` closing one
generation, `fleet status` and `cache ls`); nor may a ``python -m
jepsen_tpu_torch --cpu serve --ingest`` child that ingests, sweeps,
seals and serves its pages (read off ``-X importtime``).  The walk imports
every module, the telemetry and verifier packages included.  A file of its own, so that the test run
spreads its child process over its own worker.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_jepsen_tpu():
    code = """
import pkgutil, importlib, sys
import jepsen_tpu_torch
for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__, "jepsen_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from jepsen_tpu_torch.checkers.elle import device_core, device_infer
from jepsen_tpu_torch.history.soa import pack_txns
from jepsen_tpu_torch.workloads.synth import packed_la_history
p = chip_smoke.stale_reads(packed_la_history(300, n_keys=20, seed=1))
h = device_infer.pad_packed(p, device="cpu")
bits, over = device_core.core_check_exact(h, p.n_keys, device="cpu")
assert bits.tolist()[12] == 1, bits
from jepsen_tpu_torch.checkers.elle import list_append, oracle
from jepsen_tpu_torch.history import history, invoke, ok
h = history([invoke(0, "txn", [["append", "x", 1], ["r", "y", None]]),
             invoke(1, "txn", [["append", "y", 9], ["r", "x", None]]),
             ok(0, "txn", [["append", "x", 1], ["r", "y", [9]]]),
             ok(1, "txn", [["append", "y", 9], ["r", "x", [1]]])])
r = list_append.check(h, ["strict-serializable"], device="cpu",
                      _force_no_fallback=True)
o = oracle.check(h, ["strict-serializable"])
assert (r["valid?"], r["anomaly-types"]) == (o["valid?"], o["anomaly-types"])
assert "G1c" in r["anomaly-types"], r
from jepsen_tpu_torch.checkers.elle import rw_register
from jepsen_tpu_torch.history import HistoryIR
from jepsen_tpu_torch.workloads.synth import packed_rw_history
ir = HistoryIR.of(h)
assert list_append.check(ir, ["strict-serializable"], device="cpu",
                         _force_no_fallback=True) == r
rw_register.FUSED_MIN_TXNS = 1
ir = HistoryIR.of(chip_smoke.stale_reads_rw(
    packed_rw_history(600, n_keys=75, seed=7), 6))
r = rw_register.check(ir, ["strong-snapshot-isolation"], device="cpu")
assert r["valid?"] is False and "fused-device" not in r, r
assert rw_register.check(ir, ["strong-snapshot-isolation"],
                         use_device=False)["valid?"] is False
from jepsen_tpu_torch.checkers import api, check_safe, compose
from jepsen_tpu_torch.checkers.knossos import analysis
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.workloads.synth import lin_register_history
lh = lin_register_history(n_ops=40, concurrency=3, seed=0)
for alg in ("auto", "wgl", "linear", "device"):
    kw = {"max_frontier": 256} if alg in ("auto", "device") else {}
    r = analysis(lh, cas_register(), algorithm=alg, device="cpu", **kw)
    assert r["valid?"] is True, (alg, r)
r = check_safe(compose({"linear": api.Linearizable(device="cpu"),
                        "stats": api.Stats()}), {}, lh, {})
assert r["valid?"] is True and r["linear"]["valid?"] is True, r
from jepsen_tpu_torch import native
from jepsen_tpu_torch.checkers import invariants
from jepsen_tpu_torch.checkers.elle import closed_predicate
from jepsen_tpu_torch.checkers.invariants import session
from jepsen_tpu_torch.checkers.knossos import wgl
native.CALLS = 0
assert wgl.check(lh, cas_register())["valid?"] is True
assert native.CALLS == 1, native.CALLS
sh = history([invoke(0, "txn", [["r", 0, None], ["w", 0, 1]]),
              ok(0, "txn", [["r", 0, None], ["w", 0, 1]]),
              invoke(0, "txn", [["r", 0, None]]),
              ok(0, "txn", [["r", 0, None]])])
r = session.check(sh, device="cpu")
assert r["valid?"] is False and r["anomaly-types"] == [
    "read-your-writes-violation"], r
assert "session" in invariants.MODELS and closed_predicate.check
from jepsen_tpu_torch.checkers.queue import MODELS, fifo, kafka
r = kafka.check(HistoryIR(chip_smoke.sim_kafka(0, torn_p=0.5)), device="cpu")
assert r["valid?"] is False and "lost-write" in r["anomaly-types"], r
q = chip_smoke.sim_mem_queue(0, reorder_dequeue_p=0.5)
r = fifo.check(q, fifo=True, device="cpu")
assert r["anomaly-types"] == ["queue-fifo-violation"], r
assert fifo.check(q, fifo=True, use_device=False) == r
assert set(MODELS) == {"kafka", "total-queue"}
import tempfile
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checkers.elle import stream
from jepsen_tpu_torch.parallel import batch
from jepsen_tpu_torch.workloads.synth import la_history, inject_wr_cycle
sh = la_history(n_txns=120, n_keys=5, concurrency=6, seed=3)
assert inject_wr_cycle(sh)
with tempfile.TemporaryDirectory() as d:
    t = {"name": "purity", "store-dir": d, "history": sh}
    store.save_0(t)
    r = stream.check_stored(store.test_dir(t), device="cpu")
assert r["valid?"] is False and r["cycles"]["G1c"], r
ps = [packed_la_history(48, n_keys=4, seed=s) for s in range(3)]
rs = batch.check_batch(ps + [pack_txns(sh)], device="cpu")
assert [x["valid?"] for x in rs] == [True, True, True, False], rs
from jepsen_tpu_torch.parallel import hybrid, op_shard
r = op_shard.check_sharded(p, mesh=batch.make_mesh(3, device="cpu"))
assert r["valid?"] is False and r["inference-sharded"] is False, r
assert hybrid.check_batch_hybrid(
    ps, hybrid.make_hybrid_mesh(2, 2, ["cpu"] * 4)) == rs[:3]
from jepsen_tpu_torch import core
from jepsen_tpu_torch.__main__ import DEMOS
from jepsen_tpu_torch.generator import core as gen
import os
with tempfile.TemporaryDirectory() as d:
    t = DEMOS["append"]({"store-dir": d, "cpu": True, "seed": 0,
                         "concurrency-spec": "2n"})
    t["generator"] = gen.limit(200, t["generator"])
    t.update({"telemetry": True, "live-check": True})
    done = core.run(t)
    rd = store.test_dir(done)
    assert {"telemetry.json", "trace.json", "events.jsonl"} <= set(
        os.listdir(rd)), os.listdir(rd)
assert done["results"]["valid?"] is True and len(done["history"]) == 400
assert done["results"]["live-check"]["seal"]["equal"] is True, done["results"]
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import __main__ as tmain
import json
with tempfile.TemporaryDirectory() as d:
    # shrink resolves a bank run's checker through `_wl_checker`'s
    # dynamic import, which no static import scan sees
    bh = chip_smoke.inject_bank_wrong_total(chip_smoke.bank_history(seed=1))
    t = {"name": "purity-shrink", "store-dir": d, "history": bh,
         "total-amount": 40, "workload-kind": "bank"}
    store.save_0(t)
    assert tcli.run(tmain.suite(), ["--cpu", "shrink", store.test_dir(t),
                                    "--anomaly", "bank-wrong-total"]) == 0
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump({"name": "purity", "seeds": [0], "workloads": [
            {"name": "bank", "opts": {"ops": 60, "time-limit": None}},
            {"name": "kafka", "opts": {"ops": 60, "time-limit": None}},
            "noop"], "opts": {"shrink": True, "concurrency": 2}}, f)
    assert tcli.run(tmain.suite(), ["--cpu", "--store-dir", d, "campaign",
                                    "run", spec]) in (0, 1)
    assert tcli.run(tmain.suite(), ["--store-dir", d, "campaign",
                                    "status", spec]) == 0
    # the observatory over that store, the Knossos CLI and the REPL
    from jepsen_tpu_torch import repl
    from jepsen_tpu_torch.campaign.index import Index
    from jepsen_tpu_torch.checkers.knossos import cli as kcli
    from jepsen_tpu_torch.telemetry import alerts, prometheus, warehouse
    assert tcli.run(tmain.suite(), ["--store-dir", d, "obs", "ingest"]) == 0
    assert warehouse.open_if_exists(d).counts()["campaign_records"] == 3
    idx = Index(os.path.join(d, "campaigns", "purity.jsonl"))
    assert idx._warehouse() is not None and idx.verdict_counts()
    assert tcli.run(tmain.suite(), ["--store-dir", d, "obs", "alerts",
                                    "--eval"]) in (0, 1)
    assert alerts.AlertJournal(alerts.alerts_path(d)).digest()
    assert "jepsen_warehouse_runs" in prometheus.exposition(base=d)
    hp = os.path.join(d, "h.json")
    with open(hp, "w") as f:
        json.dump([{"type": "invoke", "process": 0, "f": "write", "value": 1},
                   {"type": "ok", "process": 0, "f": "write", "value": 1}], f)
    assert kcli.main([hp, "--model", "register", "--cpu"]) == 0
    rt = repl.latest(None, base=d)
    rr = repl.recheck(rt, api.Stats())["results"]
    assert 0 < rr["count"] <= len(repl.history(rt)), rr
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("loaded:", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "loaded: []" in res.stdout


def test_fleet_imports_neither_jax_nor_jepsen_tpu():
    code = """
import io, sys, tempfile, threading, contextlib
from jepsen_tpu_torch import web
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import __main__ as tmain
from jepsen_tpu_torch.campaign import core as ccore
from jepsen_tpu_torch.campaign.index import Index
from jepsen_tpu_torch.fleet import Autopilot, FleetCoordinator, FleetWorker
with tempfile.TemporaryDirectory() as d:
    spec = {"name": "pure", "workloads": ["append"], "seeds": [0],
            "opts": {"time-limit": 0.2}}
    coord = FleetCoordinator(spec, d + "/coord", lease_s=5.0)
    srv = web.serve(port=0, base=d + "/coord", background=True, fleet=coord)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    w = FleetWorker(url, d + "/w", name="pw", poll_s=0.05, cpu=True,
                    upload=True)
    assert w.run() == 1 and w.uploads_done == 1
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.run(tmain.suite(), ["fleet", "status", "--coordinator",
                                        url]) == 0
        assert tcli.run(tmain.suite(), ["cache", "ls"]) == 0
    srv.server_close()
    coord.close()
    recs = Index(ccore.index_path("pure", d + "/coord")).records
    assert [r["valid?"] for r in recs] == [True], recs
    ap = Autopilot({"name": "pa", "workloads": ["noop"], "seeds": [0]},
                   d + "/ap", generations=1, poll_s=0.02)
    def drain():
        while not ap.stop.is_set():
            code, out = ap.coordinator.claim({"worker": "syn"})
            sp = out.get("spec")
            if not sp:
                ap.stop.wait(0.01)
                continue
            ap.coordinator.complete({"worker": "syn", "run": sp["run_id"],
                                     "record": {"run": sp["run_id"],
                                                "valid?": True}})
    t = threading.Thread(target=drain, daemon=True)
    t.start()
    assert ap.run()["generations"] == 1
    ap.close()
    t.join(timeout=10)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("loaded:", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "loaded: []" in res.stdout


def test_serve_ingest_imports_neither_jax_nor_jepsen_tpu(tmp_path):
    import json
    import socket
    import time
    import urllib.request

    from jepsen_tpu_torch.workloads import synth

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(NO_PROXY="127.0.0.1,localhost", no_proxy="127.0.0.1,localhost")
    err = tmp_path / "importtime.txt"
    url = f"http://127.0.0.1:{port}"
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "jepsen_tpu_torch",
             "--cpu", "--store-dir", str(tmp_path / "s"), "serve",
             "--ingest", "-p", str(port)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=f)
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, err.read_text()[-2000:]
            try:
                urllib.request.urlopen(url + "/verifier", timeout=2)
                break
            except OSError:
                assert time.monotonic() - t0 < 120, "serve never came up"
                time.sleep(0.2)
        h = synth.la_history(n_txns=60, n_keys=3, seed=4)
        assert synth.inject_wr_cycle(h)
        body = b"".join(json.dumps(op.to_dict()).encode() + b"\n"
                        for op in h)

        def call(path, data=None):
            req = urllib.request.Request(url + path, data=data,
                                         method="POST" if data is not None
                                         else "GET")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        assert json.loads(call("/ingest/p?cursor=0", body))["cursor"] == \
            len(body)
        assert json.loads(call("/verdict/p"))["valid?"] is False
        assert json.loads(call("/verifier/p/seal", b""))["equal"] is True
        for path in ("/", "/verifier", "/verifier/p", "/live/verifier/p",
                     "/campaigns", "/alerts", "/metrics"):
            call(path)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    names = {ln.rsplit("|", 1)[-1].strip()
             for ln in err.read_text().splitlines()
             if ln.startswith("import time:")}
    assert {"jepsen_tpu_torch.web", "jepsen_tpu_torch.verifier.service",
            "jepsen_tpu_torch.checkers.elle.list_append"} <= names
    bad = sorted(m for m in names
                 if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
    assert not bad, bad
