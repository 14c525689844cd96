"""libfaketime integration: run a db process on a skewed/accelerated clock
(the port's copy of `jepsen_tpu/faketime.py`).

Equivalent of the reference's `jepsen/src/jepsen/faketime.clj` (SURVEY.md
§2.1, §2.5 #9): LD_PRELOAD wrappers around libfaketime (external C
library) so one node's process experiences a shifted or rate-scaled
clock without touching the system clock.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

from . import control
from .control.core import Lit, RemoteError

SO_PATHS = (
    "/usr/lib/x86_64-linux-gnu/faketime/libfaketime.so.1",
    "/usr/lib/faketime/libfaketime.so.1",
    "/usr/local/lib/faketime/libfaketime.so.1",
)


def install() -> None:
    """Install libfaketime on the current node (best effort)."""
    if libfaketime_path() is None:
        control.exec_("env", "DEBIAN_FRONTEND=noninteractive",
                      "apt-get", "install", "-y", "libfaketime")


def libfaketime_path() -> Optional[str]:
    for p in SO_PATHS:
        try:
            control.exec_("test", "-e", p)
            return p
        except RemoteError:
            continue
    return None


def faketime_spec(offset_s: float = 0.0, rate: float = 1.0) -> str:
    """libfaketime FAKETIME spec: '+<offset>s x<rate>'."""
    sign = "+" if offset_s >= 0 else "-"
    return f"{sign}{abs(offset_s)}s x{rate:g}"


def wrap_cmd(cmd: Sequence, offset_s: float = 0.0, rate: float = 1.0,
             so_path: Optional[str] = None) -> list:
    """Prefix a command so it runs under libfaketime (reference
    `faketime/wrap!` mechanism): env LD_PRELOAD + FAKETIME."""
    so = so_path or libfaketime_path()
    if so is None:
        raise RuntimeError("libfaketime not installed on this node")
    return ["env", Lit(f"LD_PRELOAD={so}"),
            Lit(f'FAKETIME="{faketime_spec(offset_s, rate)}"'),
            Lit("FAKETIME_NO_CACHE=1"), *cmd]


def rand_factor(rng: Optional[random.Random] = None,
                max_skew: float = 5.0) -> float:
    """A random clock rate in [1/max_skew, max_skew], log-uniform
    (reference `faketime/rand-factor`)."""
    import math
    rng = rng or random.Random()
    return math.exp(rng.uniform(-math.log(max_skew), math.log(max_skew)))
