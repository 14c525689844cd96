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
``plan=`` or installed for a block with :class:`use`.  A run
(`core.run`) resolves its plan with :func:`plan_for`: the test map's
``"faults"`` spec, else an installed plan, else the ``JEPSEN_FAULTS``
variable (``"seed=7,p=0.05,kinds=oom|xla"``).  Only :func:`plan_for`
reads the variable: a checker called directly injects only a plan that
its caller gave or installed.

Spec keys (dict or ``k=v,k=v`` string), the FaultPlan arguments:

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
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

__all__ = ["FaultInjected", "FaultPlan", "parse_spec", "seeded_for",
           "plan_for", "use", "install", "clear", "active_plan",
           "KIND_MESSAGES"]

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


def parse_spec(spec: Union[str, dict, None]) -> Optional[dict]:
    """Normalize a fault spec: env-string form to a dict; dicts pass
    through (copied).  Returns None for empty/falsy specs."""
    if not spec:
        return None
    if isinstance(spec, dict):
        return dict(spec)
    out: Dict[str, Any] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad JEPSEN_FAULTS entry {part!r} "
                             "(want key=value[,key=value...])")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out or None


def seeded_for(spec: Union[str, dict, None], salt: int
               ) -> Optional[dict]:
    """Derive a spec whose seed mixes in `salt`: one template yields a
    distinct-but-replayable FaultPlan per salt.  The mix is a plain XOR
    of the normalized template seed, so ``seeded_for(s, 0)`` keeps the
    template's own stream."""
    d = parse_spec(spec)
    if d is None:
        return None
    d["seed"] = int(d.get("seed", 0)) ^ int(salt)
    return d


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

    @classmethod
    def from_spec(cls, spec: Union[str, dict, None]
                  ) -> Optional["FaultPlan"]:
        d = parse_spec(spec)
        if d is None:
            return None
        return cls(**d)

    def _decide(self, index: int, site: str,
                salt: int = 0) -> Optional[str]:
        """The pure decision function: which fault (if any) fires at
        this (index, site)?  Hash-seeded per call index so decisions
        are order-independent across sites with the same counter.
        `salt` separates index spaces: caller-indexed streams
        (:meth:`fire_at`) draw from another sequence than the global
        counter."""
        if self.sites is not None and site not in self.sites:
            return None
        if self.persistent is True or \
                (self.persistent and site in self.persistent):
            return self.kinds[0] if self.kinds else "oom"
        if index in self.at:
            return self.at[index]
        if self.p > 0.0 and self.kinds:
            rng = random.Random((self.seed << 20) ^ index ^ salt)
            if rng.random() < self.p:
                return self.kinds[rng.randrange(len(self.kinds))]
        return None

    def fire(self, site: str) -> None:
        """Called by the guard before each device entry point: count the
        call and inject the planned fault (raise, or sleep for stalls).
        """
        with self._lock:
            index = self._n_calls
            self._n_calls += 1
        self._fire_decided(site, index, salt=0)

    #: rng-stream salt for caller-indexed decisions (fire_at): keeps
    #: the interpreter's per-worker streams independent of the global
    #: device-call counter's stream for the same seed
    _CALLER_SPACE_SALT = 0x5EED5A17

    def fire_at(self, site: str, index: int) -> None:
        """Like :meth:`fire`, but the decision index is supplied by the
        caller instead of the plan's global counter: each interpreter
        worker derives its own index stream from (thread id, local op
        count), so injections are seeded-deterministic regardless of
        thread interleaving.  ``max_faults`` and the injection log stay
        plan-wide."""
        self._fire_decided(site, index, salt=self._CALLER_SPACE_SALT)

    def _fire_decided(self, site: str, index: int, salt: int) -> None:
        """Shared tail of fire/fire_at: the max_faults gate and the
        log append stay atomic under the plan lock; the raise or stall
        happens outside it."""
        with self._lock:
            if self.max_faults is not None and \
                    len(self.injected) >= self.max_faults:
                return
            kind = self._decide(index, site, salt=salt)
            if kind is None:
                return
            self.injected.append((index, site, kind))
        from jepsen_tpu_torch import telemetry

        telemetry.registry().counter("resilience-faults-injected",
                                     site=site, kind=kind).inc()
        telemetry.stream_event("fault", site=site, kind=kind, index=index)
        if kind == "stall":
            time.sleep(self.stall_s)
            return
        raise FaultInjected(kind, site, index,
                            transient=_TRANSIENT_KINDS.get(kind, True))

    def targets_site(self, site: str) -> bool:
        """Does this plan EXPLICITLY name `site`?  Sites outside the
        device-call guard (the interpreter's client-side seam) are
        strictly opt-in: a bare ``p=0.2`` checker plan must not start
        crashing client ops."""
        if self.sites is not None and site in self.sites:
            return True
        return isinstance(self.persistent, frozenset) and \
            site in self.persistent

    def __repr__(self) -> str:
        return (f"<FaultPlan seed={self.seed} p={self.p} "
                f"kinds={self.kinds} at={self.at} "
                f"persistent={self.persistent!r} "
                f"calls={self._n_calls} injected={len(self.injected)}>")


# ---------------------------------------------------------------------------
# Activation: an explicitly installed plan, else none.  A run's
# plan_for adds the test map's spec and the JEPSEN_FAULTS variable.
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


_env_plan: Optional[FaultPlan] = None
_env_spec_seen: Optional[str] = None


def _from_env() -> Optional[FaultPlan]:
    """The ``JEPSEN_FAULTS`` plan (parsed once per distinct value), else
    None."""
    global _env_plan, _env_spec_seen
    spec = os.environ.get("JEPSEN_FAULTS", "").strip()
    if not spec:
        return None
    if spec != _env_spec_seen:
        _env_spec_seen = spec
        _env_plan = FaultPlan.from_spec(spec)
    return _env_plan


def plan_for(test: Optional[dict]) -> Optional[FaultPlan]:
    """Resolve the fault plan for a run: the test map's ``"faults"``
    spec (cached on the map so every checker in the run shares ONE call
    counter), else the installed plan, else the ``JEPSEN_FAULTS`` plan.
    The JAX package's order, where its `active_plan` reads the variable.

    A set or sequence under ``"faults"`` is the nemesis vocabulary of
    the JAX package's combined nemesis, not a resilience spec: only
    dict/str specs (or a FaultPlan) select device-fault injection."""
    if test:
        spec = test.get("faults")
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, (dict, str)) and spec:
            cached = test.get("faults-plan")
            if isinstance(cached, FaultPlan):
                return cached
            plan = FaultPlan.from_spec(spec)
            test["faults-plan"] = plan
            return plan
    return active_plan() or _from_env()
