"""The port's purity: importing every module of `jepsen_tpu_torch` and
running a check (`core_check_exact`, `list_append.check`, `oracle.check`,
`rw_register.check`, Knossos, the native `wgl.check`, `session.check`,
the queue checks, `stream.check_stored`, `batch.check_batch` and a
telemetric, live-checked `core.run` of the `append` demo) in a fresh
interpreter must load neither `jax` nor `jepsen_tpu`.  The walk imports
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
