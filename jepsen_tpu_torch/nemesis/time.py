"""Clock-skew nemesis (the port's copy of `jepsen_tpu/nemesis/time.py`).

Equivalent of the reference's `jepsen/nemesis/time.clj` + the compiled C
helper (SURVEY.md §2.1): uploads `bump_time.c` to each node, compiles it
with the node's `cc`, then serves ops:

- ``bump-clock``   value = ms offset, or {node: ms} — jump clocks
- ``strobe-clock`` value = {"delta_ms", "period_ms", "duration_ms"}
- ``reset-clock``  re-sync node clocks to the control host's time
- ``check-clock-offsets`` sample each node's offset (for the clock plot)

Requires the OS layer to have disabled NTP (os_setup.Debian does).
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, Optional

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import on_nodes
from jepsen_tpu_torch.nemesis.core import Nemesis

HELPER_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources", "bump_time.c")
REMOTE_SRC = "/tmp/jepsen/bump_time.c"
REMOTE_BIN = "/tmp/jepsen/bump_time"


def install(test: dict) -> None:
    """Upload and compile the helper on every node (reference:
    `nemesis.time/install!`)."""

    def fn(t, node):
        control.exec_("mkdir", "-p", "/tmp/jepsen")
        control.upload(HELPER_SRC, REMOTE_SRC)
        control.exec_("cc", "-O2", "-o", REMOTE_BIN, REMOTE_SRC)
    on_nodes(test, fn)


def bump_time(ms: float) -> None:
    """Jump the current node's clock by ms (run within a session)."""
    control.exec_(REMOTE_BIN, "bump", str(int(ms)))


def strobe_time(delta_ms: float, period_ms: float, duration_ms: float
                ) -> None:
    control.exec_(REMOTE_BIN, "strobe", str(int(delta_ms)),
                  str(int(period_ms)), str(int(duration_ms)))


def reset_time() -> None:
    """Set the current node's clock to the control host's time (reference
    resets via ntpdate; we write the coordinator's clock directly so no
    NTP server is needed)."""
    control.exec_("date", "-u", "-s", "@" + str(_time.time()))


def clock_offset_ms() -> float:
    """Node wall clock minus control wall clock, in ms (sampled; includes
    command latency — fine for plots, not for science)."""
    t0 = _time.time()
    node_s = float(control.exec_("date", "+%s.%N"))
    t1 = _time.time()
    return (node_s - (t0 + t1) / 2.0) * 1000.0


class ClockNemesis(Nemesis):
    """The clock nemesis (reference `nemesis.time/clock-nemesis`)."""

    def setup(self, test):
        install(test)
        # stop ntp daemons in case the OS layer didn't
        on_nodes(test, lambda t, n: control.exec_result(
            "bash", "-c",
            "systemctl stop ntp systemd-timesyncd chrony 2>/dev/null; true"))
        return self

    def invoke(self, test, op):
        f, v = op["f"], op.get("value")
        if f == "bump-clock":
            # value: ms, or {node: ms}
            bumps: Dict[str, float]
            if isinstance(v, dict):
                bumps = v
            else:
                bumps = {n: float(v or 0) for n in test["nodes"]}
            res = on_nodes(test,
                           lambda t, n: bump_time(bumps[n]),
                           nodes=list(bumps))
            return dict(op, type="info", value=bumps)
        if f == "strobe-clock":
            v = v or {}
            on_nodes(test, lambda t, n: strobe_time(
                v.get("delta_ms", 200), v.get("period_ms", 10),
                v.get("duration_ms", 1000)),
                nodes=v.get("nodes") or test["nodes"])
            return dict(op, type="info")
        if f == "reset-clock":
            on_nodes(test, lambda t, n: reset_time(),
                     nodes=(v if isinstance(v, list) else None)
                     or test["nodes"])
            return dict(op, type="info")
        if f == "check-clock-offsets":
            offs = on_nodes(test, lambda t, n: clock_offset_ms())
            return dict(op, type="info", value=offs)
        raise ValueError(f"clock nemesis can't handle f={f!r}")

    def teardown(self, test):
        try:
            on_nodes(test, lambda t, n: reset_time())
        except Exception:
            pass
