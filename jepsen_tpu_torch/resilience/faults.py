"""Deterministic, seeded fault injection for the checking pipeline (the
port's copy of `jepsen_tpu/resilience/faults.py`).

A :class:`FaultPlan` wraps the device entry points (via
``guard.device_call``'s pre-call hook) and raises synthetic device
failures — or injects stalls — at chosen call indices.  Seeded and
deterministic: the same plan spec over the same call sequence injects
the same faults, so a chaos run that found a bug replays exactly.

It is the test harness of the resilience layer: inject a persistent
device fault, assert the checker degrades to the host oracle and still
produces the fault-free verdict.  A plan is given to a checker as
``plan=`` or installed for a block with :class:`use`; nothing installs
one behind the caller's back.

FaultPlan arguments:

    seed         int, default 0 — drives the probabilistic decisions
    p            float, default 0 — per-call fault probability
    kinds        iterable / "|"-joined — any of {"oom", "xla",
                 "device-lost", "stall"}; default ("oom", "xla")
    at           {call_index: kind} — explicit injections (exact runs)
    persistent   iterable of site names (or True for all sites) that
                 fault on EVERY call — the degradation-drill mode
    max_faults   int — stop injecting after this many faults
    stall_s      float, default 0.05 — stall duration
    sites        iterable — restrict injection to these site names

The JAX package's process-wide ``JEPSEN_FAULTS`` variable, its per-test
``"faults"`` spec and the caller-indexed `fire_at` stream serve its CLI,
checker API and client interpreter, which the port does not have yet.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

__all__ = ["FaultInjected", "FaultPlan", "use", "install", "clear",
           "active_plan", "KIND_MESSAGES"]

#: the JAX package's synthetic messages, word for word, so that a result
#: stamped with a synthetic fault reads the same from both packages (the
#: port's classifier reads the fault's own `transient`, not its message)
KIND_MESSAGES = {
    "oom": ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            "synthetic fault (injected)"),
    "xla": ("INTERNAL: Compilation failure: synthetic XLA compile flake "
            "(injected)"),
    "device-lost": "UNAVAILABLE: device lost (injected)",
    "stall": "stall",  # not raised; injected as a sleep
}

#: kinds a retry could clear; "device-lost" persists until re-dial, so
#: a plan can model both regimes
_TRANSIENT_KINDS = {"oom": True, "xla": True, "device-lost": False}


class FaultInjected(RuntimeError):
    """A synthetic device fault.  Carries its own transience verdict so
    the classifier needs no special-casing, plus the injection site and
    call index for attribution in logs."""

    def __init__(self, kind: str, site: str, index: int,
                 transient: bool = True):
        super().__init__(f"{KIND_MESSAGES.get(kind, kind)} "
                         f"[site={site} call={index}]")
        self.kind = kind
        self.site = site
        self.index = index
        self.transient = transient


def _split(v: Union[str, Iterable[str], None]) -> Optional[List[str]]:
    if v is None:
        return None
    if isinstance(v, str):
        return [s for s in v.replace("|", ",").split(",") if s]
    return list(v)


class FaultPlan:
    """Deterministic schedule of synthetic device faults.

    Each guarded call asks :meth:`fire` with its site name; the plan
    keeps one global call counter (thread-safe) and decides from its
    seed/spec whether that call faults.  Decisions depend only on
    (seed, call index, site filters) — never on wall time — so two runs
    over the same call sequence inject identically.
    """

    def __init__(self, seed: int = 0, p: float = 0.0,
                 kinds: Iterable[str] = ("oom", "xla"),
                 at: Optional[Dict[int, str]] = None,
                 persistent: Union[bool, Iterable[str], None] = None,
                 max_faults: Optional[int] = None,
                 stall_s: float = 0.05,
                 sites: Optional[Iterable[str]] = None):
        self.seed = int(seed)
        self.p = float(p)
        self.kinds = tuple(_split(kinds) or ())
        for k in self.kinds:
            if k not in KIND_MESSAGES:
                raise ValueError(f"unknown fault kind {k!r} "
                                 f"(have {sorted(KIND_MESSAGES)})")
        self.at = {int(k): v for k, v in (at or {}).items()}
        if persistent is True or persistent in ("1", "true", "all"):
            self.persistent: Union[bool, frozenset] = True
        else:
            self.persistent = frozenset(_split(persistent) or ())
        self.max_faults = int(max_faults) if max_faults is not None else None
        self.stall_s = float(stall_s)
        self.sites = frozenset(_split(sites) or ()) or None
        self._lock = threading.Lock()
        self._n_calls = 0
        #: injection log: (call_index, site, kind) — determinism tests
        #: and chaos reports read this
        self.injected: List[Tuple[int, str, str]] = []

    def _decide(self, index: int, site: str) -> Optional[str]:
        """The pure decision function: which fault (if any) fires at
        this (index, site)?  Hash-seeded per call index so decisions
        are order-independent across sites with the same counter."""
        if self.sites is not None and site not in self.sites:
            return None
        if self.persistent is True or \
                (self.persistent and site in self.persistent):
            return self.kinds[0] if self.kinds else "oom"
        if index in self.at:
            return self.at[index]
        if self.p > 0.0 and self.kinds:
            rng = random.Random((self.seed << 20) ^ index)
            if rng.random() < self.p:
                return self.kinds[rng.randrange(len(self.kinds))]
        return None

    def fire(self, site: str) -> None:
        """Called by the guard before each device entry point: count the
        call and inject the planned fault (raise, or sleep for stalls).
        The max_faults gate and the log append stay atomic under the
        plan lock; the raise or stall happens outside it."""
        with self._lock:
            index = self._n_calls
            self._n_calls += 1
            if self.max_faults is not None and \
                    len(self.injected) >= self.max_faults:
                return
            kind = self._decide(index, site)
            if kind is None:
                return
            self.injected.append((index, site, kind))
        if kind == "stall":
            time.sleep(self.stall_s)
            return
        raise FaultInjected(kind, site, index,
                            transient=_TRANSIENT_KINDS.get(kind, True))

    def __repr__(self) -> str:
        return (f"<FaultPlan seed={self.seed} p={self.p} "
                f"kinds={self.kinds} at={self.at} "
                f"persistent={self.persistent!r} "
                f"calls={self._n_calls} injected={len(self.injected)}>")


# ---------------------------------------------------------------------------
# Activation: an explicitly installed plan, else none.
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install a process-wide plan (None clears).  Returns the plan."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    install(None)


class use:
    """Context manager: install a plan for a block, restoring after —
    the unit-test idiom (`with faults.use(plan): ...`)."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        global _active
        self._prev = _active
        _active = self.plan
        return self.plan

    def __exit__(self, *exc) -> bool:
        global _active
        _active = self._prev
        return False


def active_plan() -> Optional[FaultPlan]:
    """The plan installed by :func:`install` or :class:`use`, else None."""
    return _active
