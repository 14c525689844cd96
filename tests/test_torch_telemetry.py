"""Port parity for the telemetry core: `jepsen_tpu_torch/telemetry/`
(`metrics`, `spans`, `export`, `stream`, `__init__`), the guard's
telemetry (`resilience/guard.py`: `env_anomaly`, retry and fallback
counters, `_stamp_device_time`), `utils/profiling.py`, and the wiring at
the JAX package's sites: `core.run`'s spans and flight recorder, the
interpreter's counters, `check_safe`'s ``check:<name>`` spans,
`save_1`'s ``telemetry.json`` / ``trace.json``, `HistoryIR`'s
``host_pack_s``, the checkers' phase spans and counters, and the CLI's
``trace`` and ``tail``.

The spec is the JAX package's `tests/test_telemetry.py` and
`tests/test_observability.py`: its unit tests run here on both packages,
and the two packages run the same seeded inputs.  Tolerances: span
names and nesting, attribute keys, non-time attribute values, counter
names, labels and integer values, ``telemetry.json``'s keys and
``trace.json``'s event names are equal; times are compared only as
present, non-negative numbers.  Left out of the comparison, because
they measure the environment rather than the run: the resource
sampler's watermarks (``rss_peak_bytes``, ``device_peak_bytes``,
``jit_cache_entries_peak``: the JAX package reports its CPU backend's
live buffers as device memory, the port only a CUDA card's), and the
counters of the JAX package's persistent compile cache
(``compile-cache-bytes``, ``-hits``, ``-misses``), which the port does
not have.
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu import core as jcore  # noqa: E402
from jepsen_tpu import resilience as jres  # noqa: E402
from jepsen_tpu import store as jstore  # noqa: E402
from jepsen_tpu import telemetry as jtel  # noqa: E402
from jepsen_tpu.checkers import api as japi  # noqa: E402
from jepsen_tpu.checkers.elle import list_append as jla  # noqa: E402
from jepsen_tpu.generator import core as jg  # noqa: E402
from jepsen_tpu.history import ops as jops  # noqa: E402
from jepsen_tpu.resilience import guard as jguard  # noqa: E402
from jepsen_tpu.workloads import append as jappend  # noqa: E402
from jepsen_tpu.workloads import mem as jmem  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch import resilience as tres  # noqa: E402
from jepsen_tpu_torch import store as tstore  # noqa: E402
from jepsen_tpu_torch import telemetry as ttel  # noqa: E402
from jepsen_tpu_torch.checkers import api as tapi  # noqa: E402
from jepsen_tpu_torch.checkers.elle import list_append as tla  # noqa: E402
from jepsen_tpu_torch.generator import core as tg  # noqa: E402
from jepsen_tpu_torch.history import HistoryIR  # noqa: E402
from jepsen_tpu_torch.history import ops as tops  # noqa: E402
from jepsen_tpu_torch.resilience import guard as tguard  # noqa: E402
from jepsen_tpu_torch.telemetry import stream as tstream  # noqa: E402
from jepsen_tpu_torch.utils import profiling  # noqa: E402
from jepsen_tpu_torch.workloads import append as tappend  # noqa: E402
from jepsen_tpu_torch.workloads import mem as tmem  # noqa: E402
from jepsen_tpu_torch.workloads import synth as tsynth  # noqa: E402

TELS = pytest.mark.parametrize("tel", [jtel, ttel], ids=["jax", "port"])

#: the resource sampler's watermarks (see the module docstring)
WATERMARKS = {"rss_peak_bytes", "device_peak_bytes",
              "jit_cache_entries_peak"}
#: attributes that carry times
TIME_ATTRS = {"compile_s", "execute_s", "device_dispatch_s",
              "device_time_ns", "host_pack_s", "queue_wait_s", "sweep_s",
              "journal_fsync_s"}
#: the JAX package's compile-cache counters (the port has no such cache)
JAX_ONLY_COUNTERS = {"compile-cache-bytes", "compile-cache-hits",
                     "compile-cache-misses"}


# ------------------------------------------ the JAX unit tests, both packages

@TELS
def test_span_nesting_and_attrs(tel):
    c = tel.Collector()
    with c.span("a", x=1) as a:
        with c.span("b") as b:
            b.set_attr(y=2)
    assert [r.name for r in c.roots] == ["a"]
    assert a.attrs == {"x": 1}
    assert a.children[0] is b and b.attrs == {"y": 2}
    assert a.duration_ns >= b.duration_ns >= 0


@TELS
def test_span_threads_get_own_roots(tel):
    c = tel.activate()
    try:
        def worker():
            with tel.span("w"):
                pass
        with tel.span("main"):
            t = threading.Thread(target=worker, name="w-thread")
            t.start()
            t.join()
    finally:
        tel.deactivate(c)
    assert sorted(r.name for r in c.roots) == ["main", "w"]
    assert next(r for r in c.roots if r.name == "w").thread_name == \
        "w-thread"


@TELS
def test_traced_phase_timer_noop_and_activation(tel):
    c = tel.activate()
    try:
        @tel.traced("deco", kind="t")
        def fn():
            assert tel.current().name == "deco"
            ph = tel.phases()
            ph.start("p1")
            ph.start("p2", n=3)
            ph.end()
            ph.end()
            return 7

        assert fn() == 7
        b = tel.activate()
        assert tel.active() is b
        tel.deactivate(b)
        assert tel.active() is c
    finally:
        tel.deactivate(c)
    assert tel.active() is tel.NOOP and not tel.enabled()
    assert tel.span("x", a=1) is tel.span("y")
    (root,) = c.roots
    assert (root.name, root.attrs) == ("deco", {"kind": "t"})
    assert [s.name for s in root.children] == ["p1", "p2"]
    assert root.children[1].attrs == {"n": 3}


@TELS
def test_open_span_gets_provisional_close(tel):
    c = tel.Collector()
    c.span("never-closed").__enter__()
    c.close_open_spans()
    (root,) = c.roots
    assert root.t1 is not None and root.attrs.get("open") is True


@TELS
def test_metrics_counter_gauge_histogram_and_threads(tel):
    reg = tel.Registry()
    reg.counter("ops", worker="0").inc()
    reg.counter("ops", worker="0").inc(2)
    reg.counter("ops", worker="1").inc()
    reg.gauge("speed").set(3.5)
    h = reg.histogram("lat", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0, 0.1):
        h.observe(v)
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")

    def hammer():
        for _ in range(1000):
            reg.counter("n").inc()

    ts = [threading.Thread(target=hammer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = reg.snapshot()
    assert {(c["name"], c["labels"].get("worker")): c["value"]
            for c in snap["counters"]} == {
        ("ops", "0"): 3, ("ops", "1"): 1, ("x", None): 0, ("n", None): 4000}
    (hist,) = snap["histograms"]
    assert hist["counts"] == [2, 1, 1] and hist["count"] == 4
    assert reg.remove("speed") and not reg.snapshot()["gauges"]


def _sample(tel):
    c = tel.Collector()
    with c.span("run", name="s"):
        with c.span("workload") as w:
            time.sleep(0.001)
            w.set_attr(ops=4, arr=np.int64(3), st={"a"})
    return c


def _snapshot_sans_times(doc):
    """A telemetry document with every time replaced by its type check."""
    def spans(sp):
        assert isinstance(sp["t0_ns"], int) and sp["dur_ns"] >= 0
        return {"name": sp["name"], "attrs": sp["attrs"],
                "children": [spans(c) for c in sp["children"]]}

    return {"keys": sorted(doc), "version": doc["version"],
            "meta": doc["meta"], "metrics": doc["metrics"],
            "spans": [spans(s) for s in doc["spans"]]}


def test_export_documents_equal(tmp_path):
    got = []
    for tag, tel in (("jax", jtel), ("port", ttel)):
        c = _sample(tel)
        reg = tel.Registry()
        reg.counter("interpreter-ops", worker="0", type="ok").inc(4)
        reg.histogram("lat", buckets=(1.0,)).observe(0.5)
        d = tmp_path / tag
        d.mkdir()
        paths = tel.write_run(str(d), c, reg, meta={"name": "s"})
        doc = json.load(open(paths["telemetry"]))
        trace = json.load(open(paths["trace"]))
        summary = tel.summarize(str(d))
        got.append((_snapshot_sans_times(doc),
                    sorted(trace), [(e["ph"], e["name"])
                                    for e in trace["traceEvents"]],
                    [line.split()[0] for line in summary.splitlines()[2:]
                     if line.strip()],
                    tel.export.top_spans(doc, 5)[0]["name"]))
        run, wl = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert run["ts"] <= wl["ts"] and wl["dur"] >= 0
    assert got[1] == got[0]
    assert got[0][0]["spans"][0]["children"][0]["attrs"] == {
        "ops": 4, "arr": 3, "st": ["a"]}


def test_histogram_quantiles_equal():
    for bounds, counts in (([1.0, 10.0, "+inf"], [2, 1, 1]),
                           ([0.001, 0.01, 0.1, "+inf"], [0, 5, 0, 0]),
                           ([1.0, "+inf"], [0, 0])):
        assert ttel.export.histogram_quantiles(bounds, counts) == \
            jtel.export.histogram_quantiles(bounds, counts)


# ------------------------------------------------------------ trace context

def test_trace_context_equal():
    for tel in (jtel, ttel):
        assert tel.trace_id_for("run-1") == jtel.trace_id_for("run-1")
    a, b = jtel.mint_trace("r7"), ttel.mint_trace("r7")
    assert (a.header(), a.child("x").to_dict()) == \
        (b.header(), b.child("x").to_dict())
    assert ttel.parse_trace_header(b.header()).to_dict() == \
        jtel.parse_trace_header(a.header()).to_dict()
    assert ttel.parse_trace_header("junk") is None
    assert ttel.trace_context("ab" * 16, "seg").to_dict() == \
        jtel.trace_context("ab" * 16, "seg").to_dict()
    seen = []

    def other():
        seen.append(ttel.current_trace())

    with ttel.trace_scope(b):
        assert ttel.current_trace() is b
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == [None] and ttel.current_trace() is None
    for tel, ctx in ((jtel, a), (ttel, b)):
        c = tel.Collector()
        c.trace = ctx
        with c.span("root"):
            with c.span("kid"):
                pass
        doc = tel.snapshot(c, tel.Registry())
        assert doc["trace"] == ctx.to_dict()
        assert doc["spans"][0]["attrs"] == {"trace_id": ctx.trace_id,
                                            "span_id": ctx.span_id}
        assert doc["spans"][0]["children"][0]["attrs"] == {}


# ------------------------------------------------------------ the recorder

def _events(tel, path, rotate=None):
    """The same event sequence through one package's EventStream."""
    reg = tel.Registry()
    s = tel.stream.EventStream(path, meta={"name": "x", "skip": None},
                               max_bytes=rotate, keep=3)
    s.bind_registry(reg)
    c = tel.Collector()
    c.stream = s
    tel.activate(c)
    try:
        with c.span("run"):
            reg.counter("ops", type="ok").inc(3)
            with c.span("check:x"):
                reg.gauge("g").set(2)
                reg.histogram("h", buckets=(1.0,)).observe(0.5)
            tel.stream_event("fault", site="s", kind="oom")
        tel.stream_event("retry", site="s")
        (jres if tel is jtel else tres).env_anomaly("site", "hang", n=1)
    finally:
        tel.deactivate(c)
    c.span("open-one").__enter__()
    return s


@pytest.mark.parametrize("rotate", [None, 300])
def test_event_stream_read_replay_render_equal(tmp_path, rotate):
    got = []
    for tag, tel in (("jax", jtel), ("port", ttel)):
        path = str(tmp_path / f"{tag}.jsonl")
        _events(tel, path, rotate)
        evs = tel.read_events(path)
        st = tel.stream.replay(evs)
        flat = [{k: v for k, v in e.items() if k != "t"} for e in evs]
        for e in flat:
            e.pop("dur_ns", None)
            e.pop("tid", None)
        tail = tel.stream.render_tail(evs, limit=0)
        got.append((flat, {k: v for k, v in st.items()
                           if k not in ("t0", "t_last", "open")},
                    [s["name"] for s in st["open"]], tail.splitlines()[1:],
                    len(tel.stream.segment_files(path))))
    assert got[1] == got[0]
    assert got[0][1]["faults"] == 1 and got[0][1]["retries"] == 1
    assert got[0][2] == ["open-one"]
    if rotate:
        assert got[0][1]["rotations"] > 0 and got[0][4] > 1


def test_torn_tail_and_follow(tmp_path):
    path = str(tmp_path / "e.jsonl")
    s = _events(ttel, path)
    with open(path, "ab") as f:
        f.write(b'{"t": 1, "ev": "span", "na')
    assert [e["ev"] for e in ttel.read_events(path)] == \
        [e["ev"] for e in jtel.read_events(path)]
    evs, cur = tstream.follow_events(path, None)
    assert len(evs) == len(ttel.read_events(path))
    s.close(valid=True)
    more, _ = tstream.follow_events(path, cur)
    assert more == [] or more[-1]["ev"] == "end"


def test_heartbeat_file(tmp_path):
    p = str(tmp_path / "hb" / "live.json")
    hb = ttel.Heartbeat(p, campaign="c", total=2)
    hb.worker("w0", {"run": "r1"})
    hb.record_done("r1", True)
    hb.close()
    doc = ttel.Heartbeat.load(p)
    assert doc["finished"] is True and doc["done"] == 1
    assert doc["last"] == {"run": "r1", "valid?": True}


# ----------------------------------------------------- sampler and profiler

def test_sampler_reads_the_card_and_joins(tmp_path, monkeypatch):
    stats = {"allocated_bytes.all.current": 1024,
             "allocated_bytes.all.peak": 4096}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    c = ttel.Collector()
    rec = ttel.attach_stream(c, str(tmp_path), interval_s=0.02)
    with c.span("x"):
        time.sleep(0.1)
    assert rec.sampler._thread.is_alive()
    rec.close()
    assert not rec.sampler._thread.is_alive()
    g = {x["name"]: x["value"] for x in c.registry.snapshot()["gauges"]
         if x["labels"] == {"device": "cuda:0"}}
    assert g == {"device-memory-bytes": 1024,
                 "device-memory-peak-bytes": 4096}
    assert c.roots[0].attrs["device_peak_bytes"] == {"cuda:0": 4096}
    evs = ttel.read_events(os.path.join(str(tmp_path), "events.jsonl"))
    assert evs[-1]["ev"] == "end" and \
        any(e.get("final") for e in evs if e["ev"] == "sample")


def test_sampler_never_initializes_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    called = []
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: called.append(i) or {})
    assert tstream._device_memory_stats() == {} and called == []


def test_profiler_trace_writes_chrome_trace(tmp_path):
    out = str(tmp_path / "prof")
    with profiling.trace(out):
        with profiling.annotate("span-x"):
            torch.ones(64).cumsum(0)
    doc = json.load(open(os.path.join(out, profiling.TRACE_FILE)))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "span-x" in names and "aten::cumsum" in names
    with profiling.trace(None):
        pass


def test_profiler_that_cannot_start_raises(tmp_path, monkeypatch):
    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="no profiler"):
        with profiling.trace(str(tmp_path)):
            pass
    t = _run_test(tcore, tg, tappend, tmem, {"device": "cpu"},
                  str(tmp_path / "run"), 20)
    t["profile-dir"] = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="no profiler"):
        tcore.run(t)


def test_profile_dir_run_bridges_spans(tmp_path):
    t = _run_test(tcore, tg, tappend, tmem, {"device": "cpu"},
                  str(tmp_path / "run"), 30)
    t["profile-dir"] = str(tmp_path / "prof")
    done = tcore.run(t)
    assert done["results"]["valid?"] is True
    doc = json.load(open(os.path.join(str(tmp_path / "prof"),
                                      profiling.TRACE_FILE)))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"run", "workload", "check:list-append", "elle.infer"} <= names
    assert os.path.exists(os.path.join(tstore.test_dir(done),
                                       "telemetry.json"))


# --------------------------------------------------------------- the guard

def test_device_call_stamps_first_and_repeat_calls():
    rows = []
    for tel, res, guard in ((jtel, jres, jguard), (ttel, tres, tguard)):
        guard.reset_compile_cache_stats()
        c = tel.activate()
        try:
            with tel.span("outer") as sp:
                for _ in range(2):
                    res.device_call("site.a", lambda x: x + 1,
                                    np.zeros((4, 2), np.int32))
        finally:
            tel.deactivate(c)
        a = sp.attrs
        assert a["device_time_ns"] >= 0 and a["compile_s"] >= 0 \
            and a["execute_s"] >= 0 and a["device_dispatch_s"] >= 0
        counters = {(x["name"], tuple(sorted(x["labels"].items()))):
                    x["value"] for x in c.registry.snapshot()["counters"]
                    if x["name"] != "device-time-ns"}
        rows.append((sorted(a), {k: v["calls"]
                                 for k, v in a["profile"].items()},
                     counters, guard.compile_cache_stats()))
    assert rows[1] == rows[0]
    assert rows[0][1] == {"site.a|(4, 2):int32": 2}


def test_stamp_times_a_cuda_result_with_events(monkeypatch):
    """With CUDA initialized, a call whose result holds a CUDA tensor
    books the two events' elapsed time; any other call the wall clock."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 0.25

    class CudaLike(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    c = ttel.activate()
    try:
        with ttel.span("card") as card:
            tres.device_call("s", lambda: {"bits": torch.zeros(2).as_subclass(
                CudaLike)})
        with ttel.span("host") as host:
            tres.device_call("s", lambda: time.sleep(0.01) or 1)
    finally:
        ttel.deactivate(c)
    assert card.attrs["device_time_ns"] == 250_000
    assert host.attrs["device_time_ns"] >= 10_000_000
    assert len(made) == 4


def test_retry_fallback_and_fault_counters_equal():
    rows = []
    for tel, res in ((jtel, jres), (ttel, tres)):
        c = tel.activate()
        try:
            plan = res.FaultPlan(seed=1, at={0: "oom"}, persistent=["p"])
            with tel.span("x") as sp:
                assert res.device_call(
                    "t", lambda: 5, plan=plan,
                    policy=res.RetryPolicy(max_attempts=3,
                                           base_delay_s=0.0)) == 5
                out, deg = res.with_fallback(
                    "p", lambda: 1, lambda: {"v": 2}, plan=plan,
                    policy=res.RetryPolicy(max_attempts=2,
                                           base_delay_s=0.0))
                dl = res.Deadline(0.0)
                with pytest.raises(res.DeadlineExceeded):
                    dl.check("d.site")
        finally:
            tel.deactivate(c)
        assert deg == res.DEGRADED_HOST and out["degraded"] == deg
        rows.append((sorted((x["name"], tuple(sorted(x["labels"].items())),
                             x["value"])
                            for x in c.registry.snapshot()["counters"]
                            if x["name"] != "device-time-ns"),
                     {k: v for k, v in sp.attrs.items()
                      if k not in TIME_ATTRS and k != "profile"}))
    assert rows[1] == rows[0]
    assert ("resilience-fallbacks", (("site", "p"),), 1) in rows[0][0]


# ------------------------------------------------------- the run, end to end

def _run_test(core, g, app, mem, kw, base, n_ops=150, **extra):
    wl = app.workload(rng=random.Random(11), **kw)
    return {"name": "tel-run", "nodes": ["n1", "n2"], "concurrency": 1,
            "client": mem.MemClient(rng=random.Random(11)),
            "generator": g.clients(g.limit(n_ops, wl["generator"])),
            "checker": wl["checker"], "store-dir": base,
            "telemetry": True, **extra}


def _shape(sp):
    """A span tree without its times: names, nesting, attribute keys and
    non-time values (the sampler's watermarks left out)."""
    attrs = {k: v for k, v in sp["attrs"].items() if k not in WATERMARKS}
    for k in TIME_ATTRS & set(attrs):
        assert isinstance(attrs[k], (int, float)) and attrs[k] >= 0, (k, sp)
        attrs[k] = "time"
    if "profile" in attrs:
        attrs["profile"] = {k: v["calls"]
                            for k, v in attrs["profile"].items()}
    return {"name": sp["name"], "attrs": attrs, "thread": sp["thread"],
            "children": [_shape(c) for c in sp["children"]]}


def _counters(doc):
    """Counters by name and labels; those that count nanoseconds compared
    only as present and non-negative."""
    out = []
    for c in doc["metrics"]["counters"]:
        if c["name"] in JAX_ONLY_COUNTERS:
            continue
        v = c["value"]
        if c["name"].endswith("-ns"):
            assert v >= 0, c
            v = "time"
        out.append((c["name"], tuple(sorted(c["labels"].items())), v))
    return sorted(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's telemetric `core.run` of the same seeded append
    test at concurrency 1, with the `_WARM` flags of both list-append
    checkers cleared first."""
    base = tmp_path_factory.mktemp("tel")
    out = []
    for tag, mods, la in (("jax", (jcore, jg, jappend, jmem, {}), jla),
                          ("port", (tcore, tg, tappend, tmem,
                                    {"device": "cpu"}), tla)):
        la._WARM.clear()
        t = _run_test(*mods, str(base / tag))
        out.append(mods[0].run(t))
    return out


def test_run_telemetry_equal(runs):
    docs, traces, dirs = [], [], []
    for pkg_store, done in zip((jstore, tstore), runs):
        d = pkg_store.test_dir(done)
        dirs.append(sorted(os.listdir(d)))
        docs.append(json.load(open(os.path.join(d, "telemetry.json"))))
        traces.append(json.load(open(os.path.join(d, "trace.json"))))
    want, got = docs
    assert sorted(got) == sorted(want)
    assert got["meta"].keys() == want["meta"].keys()
    assert [_shape(s) for s in got["spans"]] == \
        [_shape(s) for s in want["spans"]]
    assert _counters(got) == _counters(want)
    assert sorted((e["ph"], e["name"]) for e in traces[1]["traceEvents"]) \
        == sorted((e["ph"], e["name"]) for e in traces[0]["traceEvents"])
    assert dirs[1] == dirs[0]
    run = got["spans"][0]
    names = [c["name"] for c in run["children"]]
    assert names == ["workload", "store.save_0", "check:list-append",
                     "store.save_1"]
    check = run["children"][2]
    assert [c["name"] for c in check["children"]] == [
        "elle.pack", "elle.infer", "elle.graph-build", "elle.cycle-sweep",
        "elle.sessions"]
    assert ("interpreter-ops", (("type", "ok"), ("worker", "0")), 150) in \
        _counters(got)


def test_run_event_streams_equal(runs):
    got = []
    for pkg_store, tel, done in ((jstore, jtel, runs[0]),
                                 (tstore, ttel, runs[1])):
        evs = tel.read_events(os.path.join(pkg_store.test_dir(done),
                                           "events.jsonl"))
        st = tel.stream.replay(evs)
        got.append(([e.get("name") for e in evs
                     if e["ev"] in ("span-open", "span")],
                    st["ended"], st["counters"]["interpreter-ops{type=ok,"
                                                "worker=0}"]))
    assert got[1] == got[0]
    assert got[0][1] is True


def test_cli_trace_and_tail(runs, capsys):
    d = tstore.test_dir(runs[1])
    p, dispatch = tcli.single_test_cmd(lambda o: o)
    assert tcli.run((p, dispatch), ["trace", d, "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "check:list-append" in out and "top 3 spans by self time" in out
    assert tcli.run((p, dispatch), ["tail", d, "-n", "4"]) == 0
    out = capsys.readouterr().out
    assert "run ended cleanly" in out and "interpreter-ops" in out
    assert tcli.run((p, dispatch), ["tail", d, "--since", "1d"]) == 0
    assert "run ended cleanly" in capsys.readouterr().out
    jp = jcli.single_test_cmd(lambda o: o)
    assert jcli.run(jp, ["tail", jstore.test_dir(runs[0]), "-n", "0"]) == 0
    want = capsys.readouterr().out
    assert tcli.run((p, dispatch), ["tail", d, "-n", "0"]) == 0
    got = capsys.readouterr().out

    def counter_lines(out):
        sect = out.split("counters:\n")[1].split("gauges:")[0]
        return [line.split(" = ")[0] for line in sect.splitlines()
                if not line.strip().startswith(tuple(JAX_ONLY_COUNTERS))]

    assert counter_lines(got) == counter_lines(want)
    assert tcli.parse_since("90s", now=1000.0) == 910.0
    empty = os.path.dirname(d)
    assert tcli.run((p, dispatch), ["trace", os.path.join(empty, "nope")]) \
        == 2


def test_analyze_writes_suffixed_artifacts(runs):
    d = tstore.test_dir(runs[1])
    before = os.path.getmtime(os.path.join(d, "telemetry.json"))
    ttel.enable()
    try:
        tcore.analyze(d, checker=tappend.workload(device="cpu")["checker"])
    finally:
        ttel.disable()
    assert os.path.exists(os.path.join(d, "telemetry-analyze.json"))
    assert os.path.getmtime(os.path.join(d, "telemetry.json")) == before


def test_runs_without_telemetry_write_nothing(tmp_path):
    t = _run_test(tcore, tg, tappend, tmem, {"device": "cpu"},
                  str(tmp_path), 10)
    t.pop("telemetry")
    done = tcore.run(t)
    assert not {"telemetry.json", "events.jsonl"} & set(
        os.listdir(tstore.test_dir(done)))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_check_safe_crash_attribution_under_telemetry(pkg):
    tel, api = (jtel, japi) if pkg == "jax" else (ttel, tapi)

    class Boom(api.Checker):
        def name(self):
            return "boom"

        def check(self, test, history, opts=None):
            raise ValueError("kaput")

    c = tel.activate()
    try:
        r = api.check_safe(Boom(), {}, [1, 2, 3])
    finally:
        tel.deactivate(c)
    assert r["valid?"] == "unknown" and r["checker"] == "boom"
    (sp,) = c.roots
    assert sp.name == "check:boom"
    assert sp.attrs == {"checker": "boom", "ops": 3, "valid": "unknown",
                        "crashed": True}


def test_history_ir_books_host_pack():
    h = tops.history([dict(o) for o in tsynth.la_history(
        n_txns=40, n_keys=4, concurrency=3, seed=2).to_dicts()])
    c = ttel.activate()
    try:
        with ttel.span("check") as sp:
            ir = HistoryIR.of(h)
            ir.packed("list-append")
    finally:
        ttel.deactivate(c)
    assert sp.attrs["host_pack_s"] == pytest.approx(
        sum(ir.build_s.values()))


def _direct_spans(tel, fn):
    c = tel.activate()
    try:
        fn()
    finally:
        tel.deactivate(c)

    def walk(sp):
        return (sp.name, tuple(sorted(k for k in sp.attrs
                                      if k not in TIME_ATTRS | WATERMARKS
                                      and k != "profile")),
                tuple(walk(k) for k in sp.children))

    counters = sorted((x["name"], tuple(sorted(x["labels"].items())),
                       x["value"])
                      for x in c.registry.snapshot()["counters"]
                      if x["name"] not in JAX_ONLY_COUNTERS
                      and x["name"] != "device-time-ns")
    return sorted(walk(r) for r in c.roots), counters


def test_checker_phase_spans_and_counters_equal():
    """The phase spans of the oracle, rw-register, the invariants, the
    queue family, Knossos and `check_batch`, and the queue counters, on
    the same histories in both packages."""
    from jepsen_tpu.checkers.elle import oracle as joracle
    from jepsen_tpu.checkers.elle import rw_register as jrw
    from jepsen_tpu.checkers.invariants import bank as jbank
    from jepsen_tpu.checkers.invariants import predicate as jpred
    from jepsen_tpu.checkers.invariants import session as jsess
    from jepsen_tpu.checkers.knossos import analysis as jknossos
    from jepsen_tpu.checkers.queue import fifo as jfifo
    from jepsen_tpu.checkers.queue import kafka as jkafka
    from jepsen_tpu.models import cas_register as jcas
    from jepsen_tpu.parallel import batch as jbatch
    from jepsen_tpu.workloads import synth as jsynth
    from jepsen_tpu_torch.checkers.elle import oracle as toracle
    from jepsen_tpu_torch.checkers.elle import rw_register as trw
    from jepsen_tpu_torch.checkers.invariants import bank as tbank
    from jepsen_tpu_torch.checkers.invariants import predicate as tpred
    from jepsen_tpu_torch.checkers.invariants import session as tsess
    from jepsen_tpu_torch.checkers.knossos import analysis as tknossos
    from jepsen_tpu_torch.checkers.queue import fifo as tfifo
    from jepsen_tpu_torch.checkers.queue import kafka as tkafka
    from jepsen_tpu_torch.models import cas_register as tcas
    from jepsen_tpu_torch.parallel import batch as tbatch
    import chip_smoke as cs

    la = jsynth.la_history(n_txns=60, n_keys=5, concurrency=4, seed=5)
    rw = jsynth.rw_history(n_txns=60, n_keys=5, concurrency=4, seed=5)
    lin = jsynth.lin_register_history(n_ops=30, concurrency=3, seed=1)
    bank = cs.bank_history(n_ops=40, seed=1)
    q = cs.sim_mem_queue(0, reorder_dequeue_p=0.3)
    k = cs.sim_kafka(0, torn_p=0.3)
    ps = [jsynth.packed_la_history(40, n_keys=4, seed=s) for s in (0, 1)]

    def port(h):
        return tops.history([dict(o) for o in (
            h.to_dicts() if hasattr(h, "to_dicts") else h)])

    def jax_h(h):
        return jops.history([dict(o) for o in h.to_dicts()])

    cases = [
        (lambda: joracle.check(la, ["serializable"]),
         lambda: toracle.check(port(la), ["serializable"])),
        (lambda: jrw.check(rw, ["snapshot-isolation"]),
         lambda: trw.check(port(rw), ["snapshot-isolation"],
                           device="cpu")),
        (lambda: jbank.check(jax_h(bank), {"total-amount": 40}),
         lambda: tbank.check(bank, {"total-amount": 40}, device="cpu")),
        (lambda: jpred.check(rw), lambda: tpred.check(port(rw),
                                                      device="cpu")),
        (lambda: jsess.check(rw), lambda: tsess.check(port(rw),
                                                      device="cpu")),
        (lambda: jfifo.check(jax_h(q), fifo=True),
         lambda: tfifo.check(q, fifo=True, device="cpu")),
        (lambda: jkafka.check(jax_h(k)),
         lambda: tkafka.check(k, device="cpu")),
        (lambda: jknossos(lin, jcas(), algorithm="wgl"),
         lambda: tknossos(port(lin), tcas(), algorithm="wgl",
                          device="cpu")),
        (lambda: jbatch.check_batch(ps),
         lambda: tbatch.check_batch(
             [tsynth.packed_la_history(40, n_keys=4, seed=s)
              for s in (0, 1)], device="cpu")),
    ]
    for jfn, tfn in cases:
        assert _direct_spans(ttel, tfn) == _direct_spans(jtel, jfn)


def test_client_injection_counters_equal():
    from jepsen_tpu.workloads import kafka as jkafka_wl
    from jepsen_tpu_torch.workloads import kafka as tkafka_wl

    rows = []
    for tel, mem, kwl in ((jtel, jmem, jkafka_wl), (ttel, tmem, tkafka_wl)):
        c = tel.activate()
        try:
            cl = mem.MemClient(rng=random.Random(4), dup_enqueue_p=0.3,
                               lose_enqueue_p=0.2, reorder_dequeue_p=0.3)
            for i in range(40):
                cl.invoke({}, {"f": "enqueue", "value": i, "process": 0,
                               "type": "invoke"})
            for _ in range(30):
                cl.invoke({}, {"f": "dequeue", "value": None,
                               "process": 0, "type": "invoke"})
            kc = kwl.KafkaClient(kwl.KafkaStore(), rng=random.Random(4),
                                 dup_send_p=0.3, reorder_p=0.3,
                                 zombie_p=0.3, torn_p=0.3)
            kc = kc.open({}, "n1")
            for i in range(30):
                kc.invoke({}, {"f": "send", "process": 0, "type": "invoke",
                               "value": [["send", "a", i],
                                         ["send", "b", i]]})
        finally:
            tel.deactivate(c)
        rows.append(sorted(
            (x["labels"]["shape"], x["value"])
            for x in c.registry.snapshot()["counters"]
            if x["name"] == "queue-adversarial-injections"))
    assert rows[1] == rows[0] and rows[0], rows
