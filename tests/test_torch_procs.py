"""Process and thread hygiene of the port and of `chip_smoke.py`.

`chip_smoke.guarded` marks every process a run starts (``TAG_VAR`` in the
environment, inherited by children and by daemons started under
`setsid`), and after the run kills and reports whatever still carries
the mark, and the threads left alive; a run that leaves either behind
exits 1 without printing its last lines.  These tests pin that, the
process-group kill of `LoopbackSession.execute` on a timeout, a regd run
under the kill package, and that a telemetric, live-checked `core.run`
leaves no thread behind whether its workload completes or raises.  Every
check waits with a bound and then asserts.
"""

import os
import random
import signal
import threading
import time
import uuid

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402
from jepsen_tpu_torch import core as tcore  # noqa: E402
from jepsen_tpu_torch.control import api as control  # noqa: E402
from jepsen_tpu_torch.control import util as cu  # noqa: E402
from jepsen_tpu_torch.control.core import Action, ConnectionError_  # noqa: E402
from jepsen_tpu_torch.control.local import LoopbackRemote  # noqa: E402
from jepsen_tpu_torch.dbs import regd_suite  # noqa: E402
from jepsen_tpu_torch.generator import core as g  # noqa: E402
from jepsen_tpu_torch.nemesis import combined  # noqa: E402
from jepsen_tpu_torch.workloads import append, mem  # noqa: E402


def _tag() -> str:
    return f"test-procs-{uuid.uuid4().hex}"


def _gone(tag: str, seconds: float = 5.0) -> bool:
    """Wait up to `seconds` for no process to carry `tag`."""
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        if not cs.marked_pids(tag):
            return True
        time.sleep(0.05)
    return not cs.marked_pids(tag)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[-1][:1] != "Z"
    except OSError:
        return False


def _start_sleep_daemon(base: str) -> int:
    """`sleep 300` started as a daemon on a loopback node; its pid."""
    r = LoopbackRemote(base_dir=base)
    with control.with_session("n1", r.connect("n1")):
        cu.start_daemon("sleep", "300", logfile="d.log", pidfile="d.pid")
    with open(os.path.join(base, "n1", "d.pid")) as f:
        return int(f.read())


def test_reaper_finds_and_kills_a_daemon(tmp_path, monkeypatch):
    tag = _tag()
    monkeypatch.setenv(cs.TAG_VAR, tag)
    pid = _start_sleep_daemon(str(tmp_path))
    try:
        assert pid in cs.marked_pids(tag)
        found = cs.reap(tag)
        assert [p for p, _ in found] == [pid]
        assert "sleep 300" in found[0][1]
        assert _gone(tag)
        assert not _alive(pid)
    finally:
        if _alive(pid):
            os.kill(pid, signal.SIGKILL)


def test_guarded_fails_on_a_left_process(tmp_path, capsys):
    pids = []

    def body():
        pids.append(_start_sleep_daemon(str(tmp_path)))
        return ["card line", '{"ok": true}']

    try:
        assert cs.guarded(body) == 1
        out = capsys.readouterr().out
        assert "[end] processes left: 1, threads left: 0" in out
        assert f"left running: pid {pids[0]}" in out
        assert '{"ok": true}' not in out and "card line" not in out
        t_end = time.monotonic() + 5
        while _alive(pids[0]) and time.monotonic() < t_end:
            time.sleep(0.05)
        assert not _alive(pids[0])
        assert cs.TAG_VAR not in os.environ
    finally:
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def test_guarded_fails_on_a_left_thread(capsys):
    stop = threading.Event()
    th = threading.Thread(target=stop.wait, name="left-behind")

    def body():
        th.start()
        return ['{"ok": true}']

    try:
        assert cs.guarded(body) == 1
        out = capsys.readouterr().out
        assert "[end] thread left: left-behind" in out
        assert "processes left: 0, threads left: 1" in out
        assert '{"ok": true}' not in out
    finally:
        stop.set()
        th.join(timeout=5)
    assert not th.is_alive()


def test_guarded_clean_run_prints_its_last_lines(capsys):
    closed = []

    class Service:
        def close(self):
            closed.append(True)

    def body():
        cs.opened(Service())
        return ["card line", '{"ok": true}']

    assert cs.guarded(body) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3:] == ["[end] processes left: 0, threads left: 0",
                          "card line", '{"ok": true}']
    assert closed == [True] and cs.OPEN == []


def test_sigterm_runs_the_finally_blocks(capsys):
    ran = []

    def body():
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(5)
        finally:
            ran.append(True)
        return ['{"ok": true}']

    with pytest.raises(SystemExit) as e:
        cs.guarded(body)
    assert e.value.code == 128 + signal.SIGTERM
    assert ran == [True]
    assert "processes left: 0" not in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is not None
    assert cs.TAG_VAR not in os.environ


def test_loopback_timeout_kills_the_process_group(tmp_path, monkeypatch):
    tag = _tag()
    monkeypatch.setenv(cs.TAG_VAR, tag)
    s = LoopbackRemote(base_dir=str(tmp_path), timeout_s=1.0).connect("n1")
    t0 = time.monotonic()
    with pytest.raises(ConnectionError_, match="timed out"):
        s.execute(Action(cmd="sleep 300 & sleep 301; echo done"))
    assert time.monotonic() - t0 < 10
    assert _gone(tag), [cs._cmdline(p) for p in cs.marked_pids(tag)]


def test_regd_under_the_kill_package_leaves_no_marked_process(
        tmp_path, monkeypatch):
    tag = _tag()
    monkeypatch.setenv(cs.TAG_VAR, tag)
    t = regd_suite.append_test({"store-dir": str(tmp_path), "concurrency": 3,
                                "base-port": cs.free_base(), "cpu": True})
    pkg = combined.nemesis_package({"faults": {"kill"}, "db": t["db"],
                                    "interval": 1.0,
                                    "rng": random.Random(0)})
    done = tcore.run(cs.with_package(t, pkg, t["generator"], 3.0))
    faults = {op.f for op in done["history"] if op.process == "nemesis"}
    assert "kill" in faults, faults
    assert done["results"]["valid?"] in (True, False)
    assert _gone(tag), [cs._cmdline(p) for p in cs.marked_pids(tag)]


class _Boom(RuntimeError):
    pass


def _live_test(base: str, raising: bool) -> dict:
    wl = append.workload(rng=random.Random(3), device="cpu")
    gen = g.clients(g.limit(120, wl["generator"]))
    if raising:
        def boom(test, ctx):
            raise _Boom("the workload's generator failed")

        gen = g.phases(gen, boom)
    return {"name": "procs-live", "nodes": ["n1", "n2"], "concurrency": 4,
            "client": mem.MemClient(rng=random.Random(3)),
            "generator": gen, "checker": wl["checker"], "store-dir": base,
            "telemetry": True, "live-check": {"inproc": True}, "cpu": True}


@pytest.mark.parametrize("raising", [False, True])
def test_live_checked_telemetric_run_leaves_no_thread(tmp_path, raising):
    before = set(threading.enumerate())
    t = _live_test(str(tmp_path), raising)
    if raising:
        with pytest.raises(_Boom):
            tcore.run(t)
    else:
        done = tcore.run(t)
        live = done["results"]["live-check"]
        assert live["state"] == "ok" and live["seal"]["equal"], live
    left = [th.name for th in threading.enumerate()
            if th not in before and th.is_alive()]
    assert left == []
