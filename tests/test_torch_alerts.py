"""Port parity for the alert engine: `jepsen_tpu_torch/telemetry/alerts.py`
against the JAX package's on the CPU.

The spec is the JAX package's `tests/test_alerts.py`.  Each scenario runs
once with each package's module in a store of its own and asserts the
spec's contract in both; the two observations must be equal: the rule
pack (the stock pack is the JAX one, `compile-cache-fallthrough-rate`
included, though the port never emits that counter), the state machine
and its journal (its events but their wall-clock ``ts``), digests across
replay, a torn tail, a kill -9 mid-firing, at-most-once notification, the
signal sources (registry, heartbeats, store bytes, an autopilot journal
given by duck typing, the warehouse rollups, the card's memory
watermarks as ``gauge:`` signals) and `obs alerts`.  Seeded random signal
sequences under a fake clock give equal journals and digests.  The
`WebhookSink` posts to an `http.server` on 127.0.0.1, in a daemon thread
the test joins.  The twin-pass parole tests of the spec, and
`_autopilot_signals` on a real `AutopilotJournal`, are in
`test_torch_autopilot.py`.
"""

import json
import os
import random
import signal
import subprocess
import sys
import textwrap
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from jepsen_tpu import cli as jcli  # noqa: E402
from jepsen_tpu.telemetry import alerts as jalerts  # noqa: E402
from jepsen_tpu.telemetry import metrics as jmetrics  # noqa: E402
from jepsen_tpu.telemetry import prometheus as jprom  # noqa: E402
from jepsen_tpu.telemetry import warehouse as jwh  # noqa: E402
from jepsen_tpu_torch import cli as tcli  # noqa: E402
from jepsen_tpu_torch.telemetry import alerts as talerts  # noqa: E402
from jepsen_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from jepsen_tpu_torch.telemetry import prometheus as tprom  # noqa: E402
from jepsen_tpu_torch.telemetry import warehouse as twh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(A=jalerts, metrics=jmetrics, prom=jprom,
                                 wmod=jwh, cli=jcli, name="jepsen_tpu"),
    "torch": types.SimpleNamespace(A=talerts, metrics=tmetrics, prom=tprom,
                                   wmod=twh, cli=tcli,
                                   name="jepsen_tpu_torch"),
}


def both(tmp_path, scenario):
    """Run `scenario(P, base)` with each package in a store of its own;
    the two observations must be equal.  Returns the port's."""
    out = {}
    for name, P in PKGS.items():
        base = tmp_path / name
        base.mkdir()
        out[name] = scenario(P, base)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _engine(P, base, rules, **kw):
    return P.A.AlertEngine(str(base), rules=P.A.load_rules(rules), **kw)


def _journal(P, base):
    """The journal's events, each without its wall-clock ``ts`` and the
    repr of its sink (which names a path or an object of the test)."""
    with open(P.A.alerts_path(str(base))) as f:
        return [{k: v for k, v in json.loads(ln).items()
                 if k not in ("ts", "sink")} for ln in f if ln.strip()]


class _Capture:
    """A sink that records every payload it is handed."""

    def __init__(self, fail=False):
        self.sent = []
        self.fail = fail

    def send(self, payload):
        if self.fail:
            raise ConnectionError("sink down")
        self.sent.append(payload)


# ------------------------------------------------------ rule parsing

def test_rule_roundtrip_aliases_and_validation(tmp_path):
    def scenario(P, base):
        r = P.A.Rule("x", kind="rate", severity="page", signal="gauge:g",
                     op=">=", value=2.5, for_s=7.0, window_s=30.0)
        assert P.A.Rule.from_dict(r.to_dict()).to_dict() == r.to_dict()
        alias = P.A.Rule.from_dict({"name": "y", "for": 9.0,
                                    "window": 45.0})
        assert alias.for_s == 9.0 and alias.window_s == 45.0
        for bad in ({"kind": "nope"}, {"severity": "whatever"},
                    {"op": "!="}):
            with pytest.raises(ValueError):
                P.A.Rule("x", **bad)
        return r.to_dict(), alias.to_dict()

    both(tmp_path, scenario)


def test_stock_pack_is_the_jax_pack():
    assert talerts.STOCK_PACK == jalerts.STOCK_PACK
    assert [r.to_dict() for r in talerts.stock_rules()] == \
        [r.to_dict() for r in jalerts.stock_rules()]
    assert {r.name for r in talerts.stock_rules()} == {
        "campaign-heartbeat-stale", "fleet-claim-latency-p95-high",
        "fleet-workers-alive-low", "quarantine-storm",
        "autopilot-gate-regression", "autopilot-gate-rc2-streak",
        "fleet-journal-bytes-growth", "worker-rss-watermark",
        "compile-cache-fallthrough-rate"}


def test_shipped_example_pack_matches_stock():
    with open(os.path.join(REPO, "specs", "alert-rules.json")) as f:
        doc = json.load(f)
    assert [r.to_dict() for r in talerts.load_rules(doc)] == \
        [r.to_dict() for r in jalerts.load_rules(doc)]
    assert {r.name for r in talerts.load_rules(doc)} == \
        {r.name for r in talerts.stock_rules()}


def test_store_config_overrides_pack_and_declares_sinks(tmp_path):
    def scenario(P, base):
        with open(base / "alerts.json", "w") as f:
            json.dump({"rules": [{"name": "only", "signal": "gauge:x",
                                  "value": 1.0}],
                       "sinks": [{"file": "notes.jsonl"},
                                 {"webhook": "http://127.0.0.1:9/x",
                                  "timeout": 1.5}]}, f)
        eng = P.A.AlertEngine(str(base))
        assert [r.name for r in eng.rules] == ["only"]
        kinds = [(type(s).__name__, getattr(s, "timeout", None))
                 for s in eng.sinks]
        eng.sinks = eng.sinks[:1]  # no send to the webhook's dead port
        eng.evaluate(signals={"gauge:x": 5.0}, now=10.0)
        with open(base / "notes.jsonl") as f:
            notes = [json.loads(ln) for ln in f]
        return kinds, notes, _journal(P, base)

    got = both(tmp_path, scenario)
    assert got[0] == [("FileSink", None), ("WebhookSink", 1.5)]


# ---------------------------------------------------- state machine

def test_threshold_debounce_pending_then_firing(tmp_path):
    def scenario(P, base):
        cap = _Capture()
        eng = _engine(P, base, [{"name": "hot", "signal": "gauge:t",
                                 "op": ">", "value": 10.0, "for": 5.0}],
                      sinks=[cap])
        seen = []
        for v, now in ((11.0, 100.0), (12.0, 103.0), (12.0, 105.0),
                       (1.0, 106.0)):
            eng.evaluate(signals={"gauge:t": v}, now=now)
            seen.append(dict(eng.journal.states["hot"]))
        assert [s["state"] for s in seen] == ["pending", "pending",
                                              "firing", "resolved"]
        assert seen[2]["since"] == 105.0
        assert [p["state"] for p in cap.sent] == ["firing", "resolved"]
        return seen, cap.sent, _journal(P, base), eng.journal.digest()

    both(tmp_path, scenario)


def test_for_zero_fires_same_tick_both_events_journaled(tmp_path):
    def scenario(P, base):
        eng = _engine(P, base, [{"name": "now", "signal": "gauge:t",
                                 "op": ">", "value": 0.0}], sinks=[])
        eng.evaluate(signals={"gauge:t": 1.0}, now=50.0)
        assert eng.journal.states["now"]["state"] == "firing"
        evs = _journal(P, base)
        assert [e["state"] for e in evs if e["ev"] == "state"] == \
            ["pending", "firing"]
        return evs

    both(tmp_path, scenario)


def test_pending_resolves_quietly_and_absence_freshness(tmp_path):
    def scenario(P, base):
        cap = _Capture()
        eng = _engine(P, base, [
            {"name": "blip", "signal": "gauge:t", "op": ">",
             "value": 0.0, "for": 60.0},
            {"name": "gone", "kind": "absence", "signal": "gauge:must"},
            {"name": "stale", "kind": "freshness",
             "signal": "heartbeat:max-age-s", "value": 300.0}],
            sinks=[cap])
        eng.evaluate(signals={"gauge:t": 1.0}, now=10.0)
        assert eng.journal.states["gone"]["state"] == "firing"
        assert "stale" not in eng.journal.states
        eng.evaluate(signals={"gauge:t": 0.0, "gauge:must": 1.0,
                              "heartbeat:max-age-s": 301.0}, now=20.0)
        st = {k: v["state"] for k, v in eng.journal.states.items()}
        assert st == {"blip": "resolved", "gone": "resolved",
                      "stale": "firing"}
        assert [p["alertname"] for p in cap.sent] == ["gone", "gone",
                                                      "stale"]
        return st, cap.sent, _journal(P, base)

    both(tmp_path, scenario)


def test_rate_rule_window_and_replay_restart(tmp_path):
    rules = [{"name": "surge", "kind": "rate", "signal": "counter:c",
              "op": ">", "value": 1.0, "window": 10.0}]

    def scenario(P, base):
        eng = _engine(P, base, rules, sinks=[])
        eng.evaluate(signals={"counter:c": 0.0}, now=100.0)
        eng.evaluate(signals={"counter:c": 50.0}, now=102.0)
        assert "surge" not in eng.journal.states
        eng.evaluate(signals={"counter:c": 150.0}, now=111.0)
        assert eng.journal.states["surge"]["state"] == "firing"
        eng2 = _engine(P, base, rules, sinks=[])
        assert eng2.journal.states["surge"]["state"] == "firing"
        assert eng2._samples == {}
        eng.evaluate(signals={"counter:c": 150.0}, now=122.0)
        assert eng.journal.states["surge"]["state"] == "resolved"
        return _journal(P, base), eng.journal.digest()

    both(tmp_path, scenario)


# ------------------------------------------------- journal durability

def test_journal_replay_and_torn_tail(tmp_path):
    def scenario(P, base):
        eng = _engine(P, base, [{"name": "a", "signal": "gauge:x",
                                 "op": ">", "value": 0.0}], sinks=[])
        for v, now in ((1.0, 10.0), (0.0, 20.0), (2.0, 30.0)):
            eng.evaluate(signals={"gauge:x": v}, now=now)
        path = P.A.alerts_path(str(base))
        replay = P.A.AlertJournal(path)
        assert replay.digest() == eng.journal.digest()
        assert replay.states == eng.journal.states
        good = eng.journal.digest()
        with open(path, "ab") as f:
            f.write(b'{"ev": "state", "rule": "a", "state": "resol')
        j2 = P.A.AlertJournal(path)
        assert j2.digest() == good
        j2.transition(P.A.Rule("a", signal="gauge:x"), "resolved", 0.0,
                      at=40.0)
        j3 = P.A.AlertJournal(path)
        assert j3.states["a"]["state"] == "resolved"
        assert j3.digest() == j2.digest()
        return good, j3.digest(), j3.states, _journal(P, base)

    both(tmp_path, scenario)


def test_notify_intent_is_at_most_once_and_failed_sink_audited(tmp_path):
    rules = [{"name": "a", "signal": "gauge:x", "op": ">", "value": 0.0}]

    def scenario(P, base):
        dead, live = _Capture(fail=True), _Capture()
        eng = _engine(P, base, rules, sinks=[dead, live])
        eng.evaluate(signals={"gauge:x": 1.0}, now=10.0)
        assert len(live.sent) == 1
        assert eng.journal.sends_failed == 1 and eng.journal.sends_ok == 1
        cap2 = _Capture()
        eng2 = _engine(P, base, rules, sinks=[cap2])
        eng2.evaluate(signals={"gauge:x": 1.0}, now=20.0)
        assert not cap2.sent
        assert eng2.journal.digest() == eng.journal.digest()
        return live.sent, _journal(P, base), eng2.journal.digest()

    both(tmp_path, scenario)


def test_kill9_mid_firing_replays_identical_no_duplicate(tmp_path):
    """A process that journaled the firing transition and its notify
    intent is killed with SIGKILL; the replay has its digest, and a
    restarted engine fed the same breach delivers nothing new."""
    def scenario(P, base):
        store, notif = base / "store", base / "notif.jsonl"
        prog = textwrap.dedent(f"""
            import os, signal
            from {P.name}.telemetry import alerts as A
            eng = A.AlertEngine({str(store)!r}, rules=A.load_rules(
                [{{"name": "a", "signal": "gauge:x", "op": ">",
                   "value": 0.0}}]),
                sinks=[A.FileSink({str(notif)!r})])
            eng.evaluate(signals={{"gauge:x": 1.0}}, now=10.0)
            print("FIRED", eng.journal.digest(), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        """)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                              capture_output=True, text=True, timeout=120,
                              env=env)
        assert proc.returncode == -signal.SIGKILL, proc.stderr
        word, digest = proc.stdout.split()
        assert word == "FIRED"
        replay = P.A.AlertJournal(P.A.alerts_path(str(store)))
        assert replay.digest() == digest
        assert replay.states["a"]["state"] == "firing"
        eng = P.A.AlertEngine(str(store), rules=P.A.load_rules(
            [{"name": "a", "signal": "gauge:x", "op": ">", "value": 0.0}]),
            sinks=[P.A.FileSink(str(notif))])
        eng.evaluate(signals={"gauge:x": 1.0}, now=20.0)
        with open(notif) as f:
            sent = [json.loads(ln) for ln in f if ln.strip()]
        assert len(sent) == 1 and eng.journal.digest() == digest
        return digest, sent

    both(tmp_path, scenario)


@pytest.mark.parametrize("seed", range(4))
def test_random_signal_sequences_give_equal_journals(tmp_path, seed):
    """Both engines fed one seeded sequence of signal snapshots under a
    fake clock: equal states, notifications, journals and digests."""
    rules = [
        {"name": "hot", "signal": "gauge:t", "op": ">", "value": 5.0,
         "for": 3.0, "severity": "page"},
        {"name": "cold", "signal": "gauge:t", "op": "<=", "value": 1.0},
        {"name": "gone", "kind": "absence", "signal": "gauge:m"},
        {"name": "stale", "kind": "freshness",
         "signal": "heartbeat:max-age-s", "value": 30.0, "for": 2.0},
        {"name": "surge", "kind": "rate", "signal": "counter:c",
         "op": ">", "value": 2.0, "window": 5.0},
    ]

    def scenario(P, base):
        rng = random.Random(seed)
        cap = _Capture()
        eng = _engine(P, base, rules, sinks=[cap])
        now, c = 1000.0, 0.0
        for _ in range(60):
            now += rng.choice((0.5, 1.0, 1.5, 2.0))
            c += rng.choice((0.0, 1.0, 5.0))
            sig = {"gauge:t": round(rng.uniform(0.0, 8.0), 1),
                   "counter:c": c}
            if rng.random() < 0.7:
                sig["gauge:m"] = 1.0
            if rng.random() < 0.8:
                sig["heartbeat:max-age-s"] = rng.choice((5.0, 40.0))
            eng.evaluate(signals=sig, now=now)
        replay = P.A.AlertJournal(P.A.alerts_path(str(base)))
        assert replay.digest() == eng.journal.digest()
        return (eng.journal.digest(), eng.journal.states, cap.sent,
                _journal(P, base), eng.status_doc())

    got = both(tmp_path, scenario)
    assert got[2], "the sequence fired nothing"


# ----------------------------------------------------------- signals

def test_registry_signals_sum_label_sets(tmp_path):
    def scenario(P, base):
        reg = P.metrics.Registry()
        reg.gauge("fleet-cells", state="queued").set(4)
        reg.gauge("fleet-cells", state="done").set(6)
        reg.counter("compile-cache-fallthrough", site="a").inc(2)
        reg.counter("compile-cache-fallthrough", site="b").inc(3)
        out = P.A.collect_signals(str(base), registry=reg, now=100.0)
        assert out["gauge:fleet-cells"] == 10.0
        assert out["counter:compile-cache-fallthrough"] == 5.0
        assert out["store:fleet-bytes"] == 0.0
        return out

    both(tmp_path, scenario)


def test_device_memory_watermarks_reach_rules_as_gauges(tmp_path):
    """The resource sampler's card watermarks (`device-memory-bytes`,
    `device-memory-peak-bytes`, one series per device) sum into
    ``gauge:`` signals, and a threshold rule on the peak fires."""
    def scenario(P, base):
        reg = P.metrics.Registry()
        for dev, used, peak in (("cuda:0", 1 << 30, 3 << 30),
                                ("cuda:1", 1 << 29, 1 << 31)):
            reg.gauge("device-memory-bytes", device=dev).set(used)
            reg.gauge("device-memory-peak-bytes", device=dev).set(peak)
        sig = P.A.collect_signals(str(base), registry=reg, now=5.0)
        assert sig["gauge:device-memory-peak-bytes"] == float(5 << 30)
        cap = _Capture()
        eng = _engine(P, base, [{
            "name": "card-peak", "signal": "gauge:device-memory-peak-bytes",
            "op": ">", "value": float(4 << 30), "severity": "page"}],
            sinks=[cap])
        eng.evaluate(signals=sig, now=5.0)
        assert eng.journal.states["card-peak"]["state"] == "firing"
        return sig, cap.sent

    both(tmp_path, scenario)


def test_heartbeat_signals_ages_and_max(tmp_path):
    def scenario(P, base):
        cdir = base / "campaigns"
        os.makedirs(cdir)
        with open(cdir / "soak.live.json", "w") as f:
            json.dump({"campaign": "soak", "updated": 900.0, "total": 10,
                       "done": 4, "finished": False}, f)
        with open(cdir / "old.live.json", "w") as f:
            json.dump({"campaign": "old", "updated": 100.0, "done": 9,
                       "total": 9, "finished": True}, f)
        out = P.A.collect_signals(str(base),
                                  registry=P.metrics.Registry(),
                                  now=1000.0)
        assert out["heartbeat:soak:age-s"] == 100.0
        assert out["heartbeat:old:finished"] == 1.0
        assert out["heartbeat:max-age-s"] == 100.0
        return out

    both(tmp_path, scenario)


class _Journal:
    """The fields `_autopilot_signals` reads of an autopilot's journal
    (the fleet's `AutopilotJournal` is not ported yet)."""

    def __init__(self):
        self.order = ["g0000", "g0001", "g0002"]
        self.gens = {
            "g0000": {"closed": True, "verdicts": [{"rc": 2}]},
            "g0001": {"closed": True, "verdicts": [{"rc": 2}, {"rc": 2}]},
            "g0002": {"closed": True,
                      "verdicts": [{"rc": 1, "key": "k"}, {"rc": 0}]},
        }
        self.quarantined = {"k": {"gen": "g0002"},
                            "j": {"gen": "g0000", "paroled-gen": "g0001"}}


@pytest.mark.parametrize("holder", ["journal", "autopilot", "none"])
def test_autopilot_signals_by_duck_typing(holder):
    j = _Journal()
    ap = {"journal": j, "autopilot": types.SimpleNamespace(journal=j),
          "none": None}[holder]
    got = {}
    for name, P in PKGS.items():
        out = {}
        P.A._autopilot_signals(out, ap)
        got[name] = out
    assert got["torch"] == got["jax"]
    if holder != "none":
        assert got["torch"] == {"autopilot:gate-regression": 1.0,
                                "autopilot:gate-rc2-streak": 0.0,
                                "autopilot:quarantined-active": 1.0}


def test_warehouse_signals_and_eval_with_a_warehouse(tmp_path):
    def scenario(P, base):
        cdir = base / "campaigns"
        os.makedirs(cdir)
        with open(cdir / "soak.jsonl", "w") as f:
            for gen, valid in (("g1", True), ("g2", False)):
                for i in range(3):
                    f.write(json.dumps({
                        "campaign": "soak", "run": f"r-{gen}-{i}",
                        "key": f"k{i}", "valid?": valid, "gen": gen,
                        "spans": {"check:la": 0.5 + i}}) + "\n")
        wh = P.wmod.open_or_create(str(base))
        wh.ingest_store(str(base))
        sig = P.A.collect_signals(str(base), registry=P.metrics.Registry(),
                                  warehouse=wh, now=10.0)
        eng = _engine(P, base, [{"name": "flipped",
                                 "signal": "warehouse:flip-regressions",
                                 "op": ">=", "value": 1.0}], sinks=[])
        eng.evaluate(signals=sig, now=10.0)
        return ({k: v for k, v in sig.items()
                 if k.startswith("warehouse:")}, eng.journal.states)

    got = both(tmp_path, scenario)
    assert got[0]["warehouse:flip-regressions"] == 3.0
    assert got[1]["flipped"]["state"] == "firing"


# ------------------------------------------------------ status + webhook

def test_status_doc_and_exposition_of_active_alerts(tmp_path):
    def scenario(P, base):
        eng = _engine(P, base, [{"name": "a", "signal": "gauge:x",
                                 "op": ">", "value": 0.0, "for": 60.0},
                                {"name": "b", "signal": "gauge:x",
                                 "op": ">", "value": 0.0}], sinks=[])
        eng.evaluate(signals={"gauge:x": 1.0}, now=10.0)
        doc = eng.status_doc()
        assert doc["pending"] == ["a"] and doc["firing"] == ["b"]
        ex1 = P.prom.exposition(base=str(base),
                                registry=P.metrics.Registry(), now=11.0)
        assert ('ALERTS{alertname="b",severity="warn",state="firing"} 1'
                in ex1)
        eng.evaluate(signals={"gauge:x": 0.0}, now=12.0)
        ex2 = P.prom.exposition(base=str(base),
                                registry=P.metrics.Registry(), now=13.0)
        assert "ALERTS{" not in ex2
        return doc, ex1, ex2

    both(tmp_path, scenario)


@pytest.fixture()
def hook():
    """`chip_smoke.webhook_server` (20e's endpoint): records what is
    POSTed to it, served by a daemon thread that the fixture joins."""
    srv = cs.webhook_server()
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          name="test-webhook")
    th.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(5)
        assert not th.is_alive()


def test_webhook_sink_posts_to_a_local_server(tmp_path, hook):
    url = f"http://127.0.0.1:{hook.server_address[1]}/alerts"

    def scenario(P, base):
        del hook.posts[:]
        with open(base / "alerts.json", "w") as f:
            json.dump({"rules": [{"name": "a", "signal": "gauge:x",
                                  "op": ">", "value": 0.0,
                                  "severity": "page"}],
                       "sinks": [{"webhook": url}]}, f)
        eng = P.A.AlertEngine(str(base))
        eng.evaluate(signals={"gauge:x": 2.0}, now=10.0)
        eng.evaluate(signals={"gauge:x": 3.0}, now=11.0)  # no new send
        eng.evaluate(signals={"gauge:x": 0.0}, now=12.0)
        assert eng.journal.sends_ok == 2 and eng.journal.sends_failed == 0
        return list(hook.posts), eng.journal.digest()

    posts, _ = both(tmp_path, scenario)
    assert [p["state"] for p in posts] == ["firing", "resolved"]
    assert posts[0]["alertname"] == "a" and posts[0]["value"] == 2.0


def test_webhook_to_a_closed_port_is_audited(tmp_path):
    def scenario(P, base):
        srv = cs.webhook_server()
        port = srv.server_address[1]
        srv.server_close()  # nothing listens there now
        eng = _engine(P, base, [{"name": "a", "signal": "gauge:x",
                                 "op": ">", "value": 0.0}],
                      sinks=[P.A.WebhookSink(
                          f"http://127.0.0.1:{port}/x", timeout=2.0)])
        eng.evaluate(signals={"gauge:x": 1.0}, now=10.0)
        assert eng.journal.sends_failed == 1 and eng.journal.sends_ok == 0
        return eng.journal.digest(), eng.journal.states

    both(tmp_path, scenario)


# -------------------------------------------------------- obs alerts

def test_cli_obs_alerts_eval_and_replay(tmp_path, capsys):
    def scenario(P, base):
        cdir = base / "campaigns"
        os.makedirs(cdir)
        with open(cdir / "soak.live.json", "w") as f:
            json.dump({"campaign": "soak", "updated": 100.0, "total": 3,
                       "done": 1, "finished": False}, f)
        with open(base / "alerts.json", "w") as f:
            json.dump({"rules": [
                {"name": "stale", "kind": "freshness", "severity": "page",
                 "signal": "heartbeat:max-age-s", "value": 300.0},
                {"name": "quiet", "signal": "heartbeat:soak:done",
                 "op": ">", "value": 5.0}],
                "sinks": [{"file": "notes.jsonl"}]}, f)
        disp = P.cli.single_test_cmd(lambda o: {})
        argv = ["--store-dir", str(base), "obs", "alerts"]
        rc0 = P.cli.run(disp, argv)  # no journal yet
        capsys.readouterr()
        # a rule's `since` is the tick's time rounded to the millisecond,
        # so a `for: 0` rule fires in its first tick only when that time
        # rounded down (both packages): at most one more tick fires it
        for _ in range(2):
            rc1 = P.cli.run(disp, argv + ["--eval", "--json", "-"])
            doc1 = json.loads(capsys.readouterr().out)
            if rc1 == 1:
                break
        rc2 = P.cli.run(disp, argv + ["--eval", "--json", "-"])
        doc2 = json.loads(capsys.readouterr().out)
        rc3 = P.cli.run(disp, argv + ["--json", "-"])
        doc3 = json.loads(capsys.readouterr().out)
        assert (rc0, rc1, rc2, rc3) == (2, 1, 1, 1)
        assert doc1["digest"] == doc2["digest"] == doc3["digest"]
        with open(base / "notes.jsonl") as f:
            notes = [json.loads(ln) for ln in f]
        assert [n["alertname"] for n in notes] == ["stale"]
        for d in (doc1, doc2, doc3):
            d.pop("digest")  # hashes the wall-clock `since`
            for st in d["states"].values():
                st.pop("since")
                st.pop("value")
        return doc1, doc2, doc3, [n["state"] for n in notes]

    both(tmp_path, scenario)
