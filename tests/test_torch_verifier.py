"""Port parity for the verifier and live checking:
`jepsen_tpu_torch/verifier/` (`journal`, `session`, `sweep`, `service`,
`client`, `__init__`), the interpreter's op sink and `core.run`'s
``"live-check"`` branch.

The spec is the JAX package's `tests/test_verifier.py`.  Both packages
are fed the same op streams (`synth` histories from numpy-free seeds,
injected with the same anomalies) in the same segmentations.  Held
equal: every rolling verdict (``valid?``, ``anomaly-types``, ``new``,
``cleared``, the edge counts and counters, ``first-seen``'s keys), each
``verdict_digest``, the sealed verdicts, the journal bytes, and the
service's journal lines (``session.json``, ``events.jsonl``) once their
wall-clock fields are dropped.  The port seals with `list_append.check`
on the session's device (here the CPU); the JAX session is given its
own `list_append.check` as the batch checker wherever whole sealed dicts
are compared, and keeps its host oracle elsewhere, whose verdict the
device checker equals.  A ``kill -9`` of a child process ingesting into
a port service is replayed by a reopened service to the same digest.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu import verifier as jv  # noqa: E402
from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.checkers.elle import oracle as joracle  # noqa: E402
from jepsen_tpu.history.soa import pack_txns as jpack  # noqa: E402
from jepsen_tpu.resilience import Deadline as JDeadline  # noqa: E402
from jepsen_tpu.resilience import faults as jfaults  # noqa: E402
from jepsen_tpu.workloads import synth as jsynth  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import telemetry as ttel  # noqa: E402
from jepsen_tpu_torch import verifier as tv  # noqa: E402
from jepsen_tpu_torch.resilience import Deadline as TDeadline  # noqa: E402
from jepsen_tpu_torch.resilience import faults as tfaults  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("strict-serializable",)
#: the service's default models
SVC_MODELS = ("serializable",)
#: fields that read the wall clock
WALL = {"opened", "updated", "t", "wall_s", "dur_s"}


def _ops(h):
    return [op.to_dict() for op in h]


def _jsonl(h) -> bytes:
    return b"".join(json.dumps(d).encode() + b"\n" for d in _ops(h))


def _history(seed, n_txns=150, n_keys=5, inject=None, **kw):
    h = jsynth.la_history(n_txns=n_txns, n_keys=n_keys, concurrency=5,
                          seed=seed, **kw)
    if inject:
        assert getattr(jsynth, inject)(h)
    return h


def _sans_wall(v):
    """A verdict or snapshot without its wall-clock values
    (``first-seen`` keeps its keys)."""
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if k in WALL:
                continue
            if k == "first-seen" and isinstance(x, dict):
                out[k] = sorted(x)
            else:
                out[k] = _sans_wall(x)
        return out
    if isinstance(v, (list, tuple)):
        return [_sans_wall(x) for x in v]
    return v


def _sessions(batch=True):
    """A JAX and a port session over MODELS: the JAX one sealing with its
    own list-append checker (when `batch`), the port's with its default,
    `list_append.check` on the CPU."""
    jkw = {"batch_check": lambda p: jla.check(p, MODELS)} if batch else {}
    return (jv.VerifierSession("t", MODELS, **jkw),
            tv.VerifierSession("t", MODELS, device="cpu"))


def _feed_both(h, seg, batch=True):
    """Feed both packages' sessions the same segments, reading a rolling
    verdict after each; returns the sessions and their verdict lists."""
    ops = _ops(h)
    (js, ts), rolls = _sessions(batch), ([], [])
    for i in range(0, len(ops), seg):
        for s, out in ((js, rolls[0]), (ts, rolls[1])):
            s.append_ops(ops[i:i + seg])
            out.append(s.verdict())
    return js, ts, rolls


CASES = {
    "valid-0": dict(seed=0),
    "valid-1": dict(seed=1, n_keys=6),
    "g1a": dict(seed=4, inject="inject_g1a", fail_prob=0.05),
    "g1b": dict(seed=4, inject="inject_g1b", fail_prob=0.05),
    "wr-cycle": dict(seed=0, inject="inject_wr_cycle", fail_prob=0.05),
    "rw-cycle": dict(seed=4, inject="inject_rw_cycle", fail_prob=0.05),
    "chaos": dict(seed=1, n_txns=200, n_keys=4, fail_prob=0.15,
                  info_prob=0.15, inject="inject_rw_cycle"),
}


@pytest.mark.parametrize("seg", [23, 10_000])
@pytest.mark.parametrize("case", list(CASES))
def test_rolling_verdicts_digests_and_seal_equal(case, seg):
    h = _history(**CASES[case])
    js, ts, (jr, tr) = _feed_both(h, seg)
    assert [_sans_wall(v) for v in tr] == [_sans_wall(v) for v in jr]
    assert [tv.verdict_digest(v) for v in tr] == \
        [jv.verdict_digest(v) for v in jr]
    jseal, tseal = js.seal(), ts.seal()
    assert _sans_wall(tseal) == _sans_wall(jseal)
    assert tseal["equal"] is True
    batch = joracle.check(jpack(h, "list-append"), MODELS)
    assert (tseal["verdict"]["valid?"], tseal["verdict"]["anomaly-types"]) \
        == (batch["valid?"], batch["anomaly-types"])
    assert (batch["valid?"] is True) == case.startswith("valid")


def test_segmentation_independence_digest():
    h = _history(5, n_txns=120, n_keys=4, inject="inject_wr_cycle")
    digests = set()
    for seg in (1, 7, 10_000):
        js, ts, (jr, tr) = _feed_both(h, seg, batch=False)
        digests |= {tv.verdict_digest(tr[-1]), jv.verdict_digest(jr[-1])}
        assert [_sans_wall(v) for v in tr] == [_sans_wall(v) for v in jr]
    assert len(digests) == 1


def test_replaced_version_order_retraction_equal():
    ops = []
    for p, mops in ((0, [["append", "x", 1], ["append", "x", 2]]),
                    (1, [["r", "x", [1, 2]]]),
                    (0, [["append", "x", 3], ["append", "x", 4]]),
                    (1, [["r", "x", [1, 3, 4]]])):
        ops += [{"type": "invoke", "process": p, "f": "txn", "value": mops},
                {"type": "ok", "process": p, "f": "txn", "value": mops}]
    js, ts = _sessions()
    rolls = []
    for s in (js, ts):
        out = []
        for i in range(0, len(ops), 2):
            s.append_ops(ops[i:i + 2])
            out.append(_sans_wall(s.verdict()))
        rolls.append((out, _sans_wall(s.seal())))
    assert rolls[1] == rolls[0]
    assert "incompatible-order" in rolls[0][0][-1]["anomaly-types"]


def test_rolling_deltas_and_first_seen():
    h = _history(3, n_txns=100)
    a = [["append", "zz", 9001], ["r", "zz2", [9002]]]
    b = [["append", "zz2", 9002], ["r", "zz", [9001]]]
    cycle = [{"type": "invoke", "process": 0, "f": "txn", "value": a},
             {"type": "ok", "process": 0, "f": "txn", "value": a},
             {"type": "invoke", "process": 1, "f": "txn", "value": b},
             {"type": "ok", "process": 1, "f": "txn", "value": b}]
    got = []
    for s in _sessions():
        s.append_ops(_ops(h))
        v0 = s.verdict()
        s.append_ops(cycle)
        v1 = s.verdict()
        v2 = s.verdict()
        assert set(v1["new"]) == set(v1["anomaly-types"]) and v2["new"] == []
        assert v2["first-seen"] == v1["first-seen"]
        got.append([_sans_wall(v) for v in (v0, v1, v2)])
    assert got[1] == got[0]
    assert "G1c" in got[0][1]["anomaly-types"]


def test_packed_columns_path_equal():
    p = jsynth.packed_la_history(n_txns=3000, n_keys=400, seed=2)
    tp = tsynth.packed_la_history(n_txns=3000, n_keys=400, seed=2)
    got = []
    for mod, s, packed in ((jv, _sessions()[0], p),
                           (tv, _sessions()[1], tp)):
        for cols, rd, base in mod.iter_packed_segments(packed, 512):
            s.append_columns(cols, rd_elems=rd, rd_base=base)
        got.append((_sans_wall(s.verdict()), _sans_wall(s.seal())))
    assert got[1] == got[0]
    assert got[0][1]["txns"] == 3000


def test_seal_mismatch_deadline_and_sweep_faults():
    h = _history(2, n_txns=80, n_keys=4, inject="inject_wr_cycle")
    bad = tv.VerifierSession("t", MODELS, device="cpu", batch_check=lambda p:
                             {"valid?": False, "anomaly-types": ["G1c"]})
    bad.append_ops(_ops(_history(0, n_txns=40)))
    with pytest.raises(tv.VerdictMismatch):
        bad.seal()
    assert bad.sealed is None
    got = []
    for v, dl, fl in ((jv, JDeadline, jfaults), (tv, TDeadline, tfaults)):
        kw = {"device": "cpu"} if v is tv else {}
        s = v.VerifierSession("t", MODELS, **kw)
        s.append_ops(_ops(h))
        unknown = s.verdict(deadline=dl(0.0))
        after = s.verdict()
        plan = fl.FaultPlan(seed=1, at={0: "oom"},
                            sites=("verifier.sweep",))
        s2 = v.VerifierSession("t2", MODELS, plan=plan, **kw)
        s2.append_ops(_ops(h))
        retried = s2.verdict()
        plan3 = fl.FaultPlan(seed=1, persistent=("verifier.sweep",),
                             kinds=("oom",), max_faults=3)
        s3 = v.VerifierSession("t3", MODELS, plan=plan3, **kw)
        s3.append_ops(_ops(h))
        with pytest.raises(Exception):
            s3.sweep()
        got.append([_sans_wall(x) for x in (unknown, after, retried,
                                             s3.verdict())]
                   + [len(plan.injected), len(plan3.injected)])
    assert got[1] == got[0]
    assert got[0][0]["error"] == "deadline-exceeded"


def test_verifier_spans_emitted():
    from jepsen_tpu.resilience import guard as jguard
    from jepsen_tpu_torch.resilience import guard as tguard

    h = _history(2, n_txns=80, n_keys=4)
    # `compile_s` / `execute_s` follow each package's process-wide first
    # sighting of a (site, shape) class: start both from none, whatever
    # ran earlier in this process
    jguard.reset_compile_cache_stats()
    tguard.reset_compile_cache_stats()
    names = []
    for tel, s in ((jtel, _sessions()[0]), (ttel, _sessions()[1])):
        c = tel.activate()
        try:
            ops = _ops(h)
            for i in range(0, len(ops), 40):
                s.append_ops(ops[i:i + 40])
                s.verdict()
            s.seal()
        finally:
            tel.deactivate(c)
        names.append(sorted((r.name, tuple(sorted(
            k for k in r.attrs if k not in ("sweep_s", "rss_peak_bytes"))))
            for r in c.roots if r.name.startswith("verifier.")))
    assert names[1] == names[0]
    assert {n for n, _ in names[0]} == {
        "verifier.append", "verifier.sweep", "verifier.seal-batch-check"}


# --------------------------------------------------------------- journal

def test_split_segment_equal():
    good = b'{"type": "invoke"}\n{"type": "ok"}\n'
    bodies = [good + b'{"type": "in', b'not json\n{"type": "ok"}\n',
              b'{"type": "info", "process": ":nemesis", "f": "start"}\n']
    for bad in (b'{"a": 1}\n', b'{"type": "nope"}\n',
                b'{"type": "ok", "process": 0, "value": 3}\n',
                b'{"type": "ok", "process": 0, '
                b'"value": [["r", [1], null]]}\n',
                b'{"type": "ok", "process": 0, '
                b'"value": [["append", "k", [1]]]}\n'):
        bodies.append(good + bad + good)
    for body in bodies:
        assert tv.split_segment(body) == jv.split_segment(body)
    assert tv.split_segment(bodies[3])[1] == 2


def test_journal_bytes_recover_compact_and_checkpoint_equal(tmp_path):
    h = _history(9, n_txns=60)
    body = _jsonl(h)
    got = []
    for tag, v in (("jax", jv), ("port", tv)):
        d = str(tmp_path / tag)
        j = v.SessionJournal(d)
        j.append(body[:body.rfind(b"\n", 0, len(body) // 2) + 1])
        cut = j.cursor
        j.close()
        with open(j.path, "ab") as f:
            f.write(b'{"type": "ok", "proc')
        j2 = v.SessionJournal(d)
        s = v.VerifierSession("t", MODELS,
                              **({"device": "cpu"} if v is tv else {}))
        for chunk in j2.read_ops():
            s.append_ops(chunk)
        cols, meta = s.checkpoint_state()
        meta["cursor"] = j2.cursor
        j2.write_checkpoint(cols, meta)
        j2.compact(j2.cursor)
        j2.append(body[cut:])
        c2 = v.read_checkpoint(d)
        with open(j2.path, "rb") as f:
            raw = f.read()
        got.append((j2.cursor, j2.base, raw, c2[1],
                    {k: c2[0][k].tolist() for k in sorted(c2[0])}))
        j2.close()
    assert got[1] == got[0]
    assert got[0][0] == len(body) and got[0][2].startswith(b'{"_journal"')


# --------------------------------------------------------------- service

def _tree(base):
    """Every session dir's journal bytes, session.json and events.jsonl
    lines, wall-clock fields dropped."""
    out = {}
    root = os.path.join(base, "verifier")
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d) or name.startswith("_"):
            continue
        with open(os.path.join(d, "journal.jsonl"), "rb") as f:
            journal = f.read()
        with open(os.path.join(d, "session.json")) as f:
            meta = _sans_wall(json.load(f))
        meta.get("seal", {}).pop("verdict", None)
        with open(os.path.join(d, "events.jsonl")) as f:
            events = [_sans_wall(json.loads(line)) for line in f]
        out[name] = (journal, meta, events)
    return out


def _svc_script(v, base, **kw):
    """The JAX service tests' call sequence on one package's service;
    returns every response, wall-clock fields dropped, and the tree."""
    kw = dict(kw, **({"device": "cpu"} if v is tv else {}))
    h = _history(9, n_txns=100, n_keys=4)
    body = _jsonl(h)
    h2 = _history(3, n_txns=120, n_keys=4, inject="inject_g1a")
    body2 = _jsonl(h2)
    svc = v.VerifierService(base, **kw)
    out = [svc.ingest("s", body[:1000], cursor=0),
           svc.ingest("s", body[:2000], cursor=0)]
    acked = out[-1][1]["cursor"]
    out += [svc.ingest("s", body[:acked], cursor=0),
            svc.ingest("s", body[acked + 10:], cursor=acked + 10),
            svc.ingest("s", body[acked:], cursor=acked),
            svc.ingest("u", b'{"foo": 1}\n' + body2, cursor=0),
            svc.ingest("u", body2, cursor=0),
            svc.verdict("u"), svc.open("../evil"), svc.open("_archive"),
            svc.compact("nope")]
    sealed = svc.seal("s")
    out += [(sealed[0], {k: sealed[1][k] for k in ("equal", "digest",
                                                   "txns", "ops")}),
            svc.ingest("s", b"{}\n", cursor=len(body))]
    svc.close()
    svc2 = v.VerifierService(base, **kw)
    out += [svc2.verdict("u"), svc2.compact("u"), svc2.verdict("u"),
            svc2.expire("u")]
    seal2 = svc2.seal("u")
    out.append((seal2[0], seal2[1]["equal"], seal2[1]["digest"],
                seal2[1]["verdict"]["valid?"],
                seal2[1]["verdict"]["anomaly-types"]))
    out.append([(x["session"], x["state"]) for x in svc2.sessions()])
    svc2.close()
    return [_sans_wall(x) for x in out], _tree(base)


def test_service_script_equal(tmp_path):
    want = _svc_script(jv, str(tmp_path / "jax"))
    got = _svc_script(tv, str(tmp_path / "port"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert [r[0] for r in got[0][:8]] == [200, 200, 200, 409, 200, 200,
                                          200, 200]


def test_auto_compaction_gc_and_quarantine_equal(tmp_path):
    got = []
    for tag, v in (("jax", jv), ("port", tv)):
        kw = {"device": "cpu"} if v is tv else {}
        base = str(tmp_path / tag)
        h = _history(7, n_txns=300, n_keys=6, fail_prob=0.05,
                     inject="inject_wr_cycle")
        body = _jsonl(h)
        svc = v.VerifierService(base, default_config={
            "compact-bytes": 8192, "gc-idle-s": 5.0,
            "archive-sealed-s": 5.0}, **kw)
        cur, sizes = 0, []
        jpath = os.path.join(base, "verifier", "cp", "journal.jsonl")
        while cur < len(body):
            cur = svc.ingest("cp", body[cur:cur + 4096], cursor=cur)[1][
                "cursor"]
            sizes.append(os.path.getsize(jpath))
        assert max(sizes) <= 8192 + 4096
        _c, v_live = svc.verdict("cp")
        svc.ingest("idle", body[:3000], cursor=0)
        svc.ingest("done", body[:3000], cursor=0)
        svc.seal("done")
        live = svc._get("cp")
        live.last_ingest = live.last_verdict_ts = time.time() + 60
        stats = svc.gc(now=time.time() + 30)
        svc.close()
        with open(os.path.join(base, "verifier", "cp", "checkpoint.npz"),
                  "rb") as f:
            ckpt = f.read()
        svc2 = v.VerifierService(base, **kw)
        recovered = svc2.verdict("cp")[1]
        svc2.close()
        with open(os.path.join(base, "verifier", "cp", "checkpoint.npz"),
                  "wb") as f:
            f.write(b"garbage")
        svc3 = v.VerifierService(base, **kw)
        quarantined = [svc3.verdict("cp")[0], svc3.seal("cp")[0]]
        svc3.close()
        got.append((sizes, tv.verdict_digest(v_live), recovered["digest"],
                    stats, sorted(n for n, _ in v.scan_sessions(base)),
                    quarantined, len(ckpt) > 0))
    assert got[1] == got[0]
    assert got[0][1] == got[0][2] and got[0][5] == [410, 410]


def test_batched_sweep_equal_to_per_session(tmp_path):
    injections = [None, "inject_wr_cycle", None, "inject_rw_cycle",
                  "inject_g1a", None]
    got = []
    for tag, v, tel in (("jax", jv, jtel), ("port", tv, ttel)):
        kw = {"device": "cpu"} if v is tv else {}
        svc = v.VerifierService(str(tmp_path / tag), **kw)
        for i, inj in enumerate(injections):
            h = _history(20 + i, n_txns=120, n_keys=4, fail_prob=0.05,
                         inject=inj)
            svc.ingest(f"mt{i}", _jsonl(h), cursor=0)
        c = tel.activate()
        try:
            stats = svc.sweep_dirty()
        finally:
            tel.deactivate(c)
        batched = [r.attrs for r in c.roots if r.name == "verifier.sweep"
                   and r.attrs.get("batched")]
        digests = [svc.verdict(f"mt{i}")[1]["digest"]
                   for i in range(len(injections))]
        seals = [svc.seal(f"mt{i}")[1]["equal"]
                 for i in range(len(injections))]
        svc.close()
        got.append((stats, [{k: a[k] for k in ("sessions", "regions",
                                               "nodes", "edges")}
                            for a in batched], digests, seals))
    assert got[1] == got[0]
    assert got[0][0]["dispatched"] == 1 and len(got[0][1]) == 1
    assert all(got[0][3])


def test_batched_sweep_of_many_sessions_one_dispatch(tmp_path):
    """`batched_sweep` over sessions whose regions are disjoint blocks:
    every verdict equals the session's own per-session sweep."""
    svc = tv.VerifierService(str(tmp_path), device="cpu")
    for i in range(12):
        h = _history(40 + i, n_txns=80, n_keys=3, fail_prob=0.05,
                     inject="inject_wr_cycle" if i % 4 == 0 else None)
        svc.ingest(f"b{i}", _jsonl(h), cursor=0)
    lives = [svc._get(f"b{i}") for i in range(12)]
    solo = []
    for i, live in enumerate(lives):
        s = tv.VerifierSession("solo", SVC_MODELS, device="cpu")
        for chunk in live.journal.read_ops():
            s.append_ops(chunk)
        solo.append(tv.verdict_digest(s.verdict()))
    stats = tv.sweep.batched_sweep(lives, device="cpu")
    assert stats["dispatched"] == 1 and stats["dirty"] == 12
    assert [svc.verdict(f"b{i}")[1]["digest"] for i in range(12)] == solo
    svc.close()


# ------------------------------------------------------------ kill -9

_CHILD = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
from jepsen_tpu_torch.verifier import VerifierService
body = open({body!r}, "rb").read()
svc = VerifierService({base!r}, device="cpu")
cur = 0
while True:
    code, r = svc.ingest("k9", body[cur:cur + 1024], cursor=cur)
    assert code == 200, r
    cur = r["cursor"]
    if cur >= len(body) // 2:
        print("half", cur, flush=True)
        time.sleep(120)
"""


def test_kill9_child_ingest_replays_to_the_same_digest(tmp_path):
    base = str(tmp_path / "store")
    h = _history(13, n_txns=150, inject="inject_wr_cycle")
    body = _jsonl(h)
    path = str(tmp_path / "body.jsonl")
    with open(path, "wb") as f:
        f.write(body)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO, body=path,
                                              base=base)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("half"), line + proc.stderr.read()
        acked = int(line.split()[1])
        # a torn tail, as if the kill had landed mid-append
        jpath = os.path.join(base, "verifier", "k9", "journal.jsonl")
        with open(jpath, "ab") as f:
            f.write(b'{"type": "ok", "proc')
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == -signal.SIGKILL
    svc = tv.VerifierService(base, device="cpu")
    try:
        code, recovered = svc.verdict("k9")
        assert code == 200
        ref = tv.VerifierSession("ref", SVC_MODELS, device="cpu")
        jref = jv.VerifierSession("ref", SVC_MODELS)
        j = tv.SessionJournal(os.path.join(base, "verifier", "k9"))
        assert j.cursor == acked
        for chunk in j.read_ops():
            ref.append_ops(chunk)
            jref.append_ops(chunk)
        j.close()
        assert recovered["digest"] == tv.verdict_digest(ref.verdict()) \
            == jv.verdict_digest(jref.verdict())
        code, r = svc.ingest("k9", body[acked:], cursor=acked)
        assert code == 200 and r["cursor"] == len(body)
        code, sealed = svc.seal("k9")
        assert code == 200 and sealed["equal"] is True
        batch = joracle.check(jpack(h, "list-append"), SVC_MODELS)
        assert (sealed["verdict"]["valid?"],
                sealed["verdict"]["anomaly-types"]) == \
            (batch["valid?"], batch["anomaly-types"])
        assert "G1c" in batch["anomaly-types"]
    finally:
        svc.close()


# ------------------------------------------------------- live checking

def _run(base, live, n_ops=150, **kw):
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.workloads import append, mem
    import random

    wl = append.workload(rng=random.Random(5), device="cpu")
    return tcore.run({
        "name": "lc", "nodes": ["n1", "n2"], "concurrency": 3,
        "client": mem.MemClient(rng=random.Random(5)),
        "generator": g.clients(g.limit(n_ops, wl["generator"])),
        "checker": wl["checker"], "store-dir": base, "cpu": True,
        "live-check": live, **kw})


def test_live_check_inproc_run_seals_equal(tmp_path):
    before = set(threading.enumerate())
    done = _run(str(tmp_path), {"inproc": True}, telemetry=True)
    res, lc = done["results"], done["results"]["live-check"]
    assert lc["state"] == "ok" and lc["ops-dropped"] == 0
    assert lc["ops"] == len(done["history"])
    assert lc["seal"] == {"equal": True, "digest": lc["digest"]}
    assert (lc["valid?"], lc["anomaly-types"]) == (res["valid?"], [])
    metas = dict(tv.scan_sessions(str(tmp_path)))
    assert metas[lc["session"]]["state"] == "sealed"
    # the live session's journal is the run's history, op for op
    j = tv.SessionJournal(os.path.join(str(tmp_path), "verifier",
                                       lc["session"]))
    journaled = [op for chunk in j.read_ops() for op in chunk]
    j.close()
    keys = ("type", "process", "f", "value")
    assert [[o.get(k) for k in keys] for o in journaled] == json.loads(
        json.dumps([[op.to_dict().get(k) for k in keys]
                    for op in done["history"]]))
    with open(os.path.join(done["store-dir"], "lc", "latest",
                           "telemetry.json")) as f:
        doc = json.load(f)
    run = doc["spans"][0]
    assert [c["name"] for c in run["children"]][:2] == ["live-check.open",
                                                        "workload"]
    assert "live-check.finish" in [c["name"] for c in run["children"]]
    assert [t for t in threading.enumerate()
            if t not in before and t.is_alive()] == []


def test_live_check_partition_degrades_within_budget(tmp_path):
    plan = tfaults.FaultPlan(seed=0, sites=("verifier.live",),
                             persistent=("verifier.live",))
    with tfaults.use(plan):
        done = _run(str(tmp_path), {"inproc": True, "budget-s": 0.2,
                                    "flush-interval-s": 0.05})
    lc = done["results"]["live-check"]
    assert lc["state"] == "degraded" and lc.get("reason")
    assert done["results"]["valid?"] is True
    assert plan.injected


def test_live_check_for_refuses_a_url(tmp_path):
    # a URL target, as a string or {"url": ...}, streams to a served
    # port: the session journaled and sealed in the served store
    from jepsen_tpu_torch import web

    sbase = str(tmp_path / "served")
    svc = tv.VerifierService(sbase, device="cpu")
    srv = web.serve(port=0, base=sbase, background=True, verifier=svc)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    h = _history(7, inject="inject_wr_cycle")
    try:
        for target in (url, {"url": url, "timeout-s": 5,
                             "session": "u1"}):
            lc = tv.live_check_for({"name": "x", "store-dir": str(tmp_path),
                                    "live-check": target})
            assert lc._url == url and lc._svc is None and not lc.degraded
            for d in _ops(h):
                lc.feed(d)
            out = lc.finish()
            assert out["state"] == "ok", out
            assert out["valid?"] is False and "G1c" in out["anomaly-types"]
            assert out["seal"] == {"equal": True, "digest": out["digest"]}
            meta = dict(tv.scan_sessions(sbase))[out["session"]]
            assert meta["state"] == "sealed"
    finally:
        srv.server_close()
        svc.close()
    # a URL that nothing serves degrades at open; the run would proceed
    lc = tv.live_check_for({"name": "x", "store-dir": str(tmp_path),
                            "live-check": {"url": "http://127.0.0.1:9",
                                           "timeout-s": 0.5,
                                           "budget-s": 0.5}})
    assert lc.degraded and "open failed" in lc.last_error
    out = lc.finish()
    assert out["state"] == "degraded" and out["reason"]
    with pytest.raises(ValueError, match="bad live-check"):
        tv.live_check_for({"live-check": 3})
    assert tv.live_check_for({"live-check": None}) is None
