"""Composable fault packages: nemesis + generator + perf metadata (the
port's copy of `jepsen_tpu/nemesis/combined.py`).

Equivalent of the reference's `jepsen/nemesis/combined.clj` (SURVEY.md
§2.1): `nemesis_package(opts)` assembles fault packages — partition,
kill, pause, clock, file corruption, custom — each a dict

    {"nemesis":  Nemesis,
     "generator": fault-op generator (already nemesis-thread scoped),
     "final_generator": heal/recover ops run at test end,
     "perf": {"name", "start", "stop", "fs"}}  # for plot shading

and composes the requested ones into a single package whose nemesis is a
`compose` over sub-nemeses and whose generator interleaves fault
schedules (interval-driven: sleep -> start -> sleep -> stop -> ...).

`opts["faults"]` picks packages: any of {"partition", "kill", "pause",
"clock", "file", "traffic"}; `opts["interval"]` (seconds, default 10)
spaces fault start/stop pairs; `opts["db"]` supplies Process/Pause
facets for kill/pause; `opts["file"]` the corruption target.
"""

from __future__ import annotations

import random as _random
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence

from jepsen_tpu_torch import db as db_
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import on_nodes
from jepsen_tpu_torch.nemesis import core as nc
from jepsen_tpu_torch.nemesis.file import FileCorruptionNemesis
from jepsen_tpu_torch.nemesis.time import ClockNemesis

DEFAULT_INTERVAL = 10.0


# ---------------------------------------------------------------- partition

def _partition_start(opts: dict):
    """The start-partition op factory (shared between the interval
    package and the window schedule): rng-chosen grudge over the
    test's nodes at emit time."""
    rng = opts.get("rng") or _random
    targets = opts.get("partition_targets") or [
        nc.partition_random_halves, nc.partition_random_node,
        nc.partition_majorities_ring]

    def start(test, ctx):
        grudge_fn = rng.choice(targets)
        return {"f": "start-partition",
                "value": grudge_fn(test["nodes"])}

    return start


def partition_package(opts: dict) -> Optional[dict]:
    if "partition" not in opts.get("faults", ()):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    start = _partition_start(opts)

    return {
        "nemesis": nc.partitioner(),
        "generator": gen.cycle([gen.sleep(interval), gen.once(start),
                                gen.sleep(interval),
                                {"f": "stop-partition", "value": None}]),
        "final_generator": {"f": "stop-partition", "value": None},
        "perf": {"name": "partition", "start": {"start-partition"},
                 "stop": {"stop-partition"}, "fs": set()},
    }


# ---------------------------------------------------------------- kill/pause

def _db_nodes_targeter(rng, targeting: str = "one"):
    def targeter(test, nodes):
        if targeting == "all":
            return list(nodes)
        if targeting == "majority":
            from jepsen_tpu_torch.utils.core import majority
            k = majority(len(nodes))
            return rng.sample(list(nodes), k)
        if targeting == "minority":
            from jepsen_tpu_torch.utils.core import minority
            k = max(1, minority(len(nodes)))
            return rng.sample(list(nodes), k)
        return [rng.choice(list(nodes))]
    return targeter


class DBNemesis(nc.Nemesis):
    """Kill/restart or pause/resume the db via its Process/Pause facets
    (reference `nemesis.combined/db-nemesis`)."""

    def __init__(self, db, targeter, *, mode: str = "kill"):
        self.db = db
        self.targeter = targeter
        self.mode = mode
        self.affected: List[str] = []

    def invoke(self, test, op):
        f = op["f"]
        db = self.db
        if f in ("kill", "pause"):
            targets = list(op.get("value") or
                           self.targeter(test, test["nodes"]))
            fn = db.kill if f == "kill" else db.pause
            res = on_nodes(test, lambda t, n: fn(t, n), nodes=targets)
            self.affected = targets
            return dict(op, type="info", value=targets)
        if f in ("start", "resume"):
            targets = self.affected or test["nodes"]
            fn = db.start if f == "start" else db.resume
            res = on_nodes(test, lambda t, n: fn(t, n), nodes=targets)
            self.affected = []
            return dict(op, type="info", value=targets)
        raise ValueError(f"db nemesis can't handle f={f!r}")

    def teardown(self, test):
        if self.affected:
            fn = self.db.start if self.mode == "kill" else self.db.resume
            try:
                on_nodes(test, lambda t, n: fn(t, n), nodes=self.affected)
            except Exception:
                pass
            self.affected = []


def kill_package(opts: dict) -> Optional[dict]:
    if "kill" not in opts.get("faults", ()):
        return None
    db = opts.get("db")
    if not db_.supports(db, db_.Process):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    rng = opts.get("rng") or _random
    targeter = _db_nodes_targeter(rng, opts.get("kill_targeting", "one"))
    return {
        "nemesis": DBNemesis(db, targeter, mode="kill"),
        "generator": gen.cycle([gen.sleep(interval),
                                {"f": "kill", "value": None},
                                gen.sleep(interval),
                                {"f": "start", "value": None}]),
        "final_generator": {"f": "start", "value": None},
        "perf": {"name": "kill", "start": {"kill"}, "stop": {"start"},
                 "fs": set()},
    }


def pause_package(opts: dict) -> Optional[dict]:
    if "pause" not in opts.get("faults", ()):
        return None
    db = opts.get("db")
    if not db_.supports(db, db_.Pause):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    rng = opts.get("rng") or _random
    targeter = _db_nodes_targeter(rng, opts.get("pause_targeting", "one"))
    return {
        "nemesis": DBNemesis(db, targeter, mode="pause"),
        "generator": gen.cycle([gen.sleep(interval),
                                {"f": "pause", "value": None},
                                gen.sleep(interval),
                                {"f": "resume", "value": None}]),
        "final_generator": {"f": "resume", "value": None},
        "perf": {"name": "pause", "start": {"pause"}, "stop": {"resume"},
                 "fs": set()},
    }


# ---------------------------------------------------------------- clock

def _clock_bump(opts: dict):
    """The bump-clock op factory (shared with the window schedule)."""
    rng = opts.get("rng") or _random

    def bump(test, ctx):
        node = rng.choice(test["nodes"])
        ms = rng.choice([-1, 1]) * rng.choice([100, 1000, 10_000, 60_000])
        return {"f": "bump-clock", "value": {node: ms}}

    return bump


def clock_package(opts: dict) -> Optional[dict]:
    if "clock" not in opts.get("faults", ()):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    rng = opts.get("rng") or _random
    bump = _clock_bump(opts)

    def strobe(test, ctx):
        return {"f": "strobe-clock",
                "value": {"delta_ms": rng.choice([50, 200, 1000]),
                          "period_ms": rng.choice([2, 10, 50]),
                          "duration_ms": 1000,
                          "nodes": [rng.choice(test["nodes"])]}}

    return {
        "nemesis": ClockNemesis(),
        "generator": gen.cycle([gen.sleep(interval),
                                gen.once(gen.mix([bump, strobe], rng=rng)),
                                gen.sleep(interval),
                                {"f": "reset-clock", "value": None}]),
        "final_generator": {"f": "reset-clock", "value": None},
        "perf": {"name": "clock", "start": {"bump-clock", "strobe-clock"},
                 "stop": {"reset-clock"}, "fs": set()},
    }


# ---------------------------------------------------------------- file

def file_package(opts: dict) -> Optional[dict]:
    if "file" not in opts.get("faults", ()):
        return None
    path = opts.get("file")
    if not path:
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    rng = opts.get("rng") or _random

    def corrupt(test, ctx):
        node = rng.choice(test["nodes"])
        f = rng.choice(["bitflip-file", "truncate-file"])
        return {"f": f, "value": {"file": path, "nodes": [node]}}

    return {
        "nemesis": FileCorruptionNemesis(path),
        "generator": gen.cycle([gen.sleep(interval), gen.once(corrupt)]),
        "final_generator": None,
        "perf": {"name": "file",
                 "start": {"bitflip-file", "truncate-file"},
                 "stop": set(), "fs": set()},
    }


# ---------------------------------------------------------------- traffic

def _traffic_degrade(opts: dict):
    """The traffic-degrade op factory (shared with the window
    schedule): one rng-chosen shaping mode per emit."""
    rng = opts.get("rng") or _random

    def degrade(test, ctx):
        f = rng.choice(["slow", "flaky", "shape"])
        value = {
            "slow": {"mean_ms": float(rng.choice([20, 50, 200])),
                     "variance_ms": float(rng.choice([5, 10, 50]))},
            "flaky": {"loss_pct": float(rng.choice([5, 20, 45])),
                      "correlation_pct": 75.0},
            "shape": ["delay", f"{rng.choice([10, 100, 500])}ms",
                      "loss", f"{rng.choice([1, 5])}%"],
        }[f]
        return {"f": f, "value": value}

    return degrade


def traffic_package(opts: dict) -> Optional[dict]:
    """Traffic-shaping fault package: drives the `Net.slow/flaky/shape`
    protocol (which no package exercised before) through a
    :class:`~jepsen_tpu_torch.nemesis.core.TrafficShaper`.  Each cycle picks
    one shaping mode at random, holds it for `interval`, then heals
    with ``fast``."""
    if "traffic" not in opts.get("faults", ()):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    degrade = _traffic_degrade(opts)

    return {
        "nemesis": nc.traffic_shaper(),
        "generator": gen.cycle([gen.sleep(interval), gen.once(degrade),
                                gen.sleep(interval),
                                {"f": "fast", "value": None}]),
        "final_generator": {"f": "fast", "value": None},
        "perf": {"name": "traffic", "start": {"slow", "flaky", "shape"},
                 "stop": {"fast"}, "fs": set()},
    }


# ------------------------------------------------------------- sim skew

def skew_package(opts: dict) -> Optional[dict]:
    """Clock-skew package for the in-process sim cluster: drives
    :class:`~jepsen_tpu_torch.nemesis.sim.SimClockSkewNemesis` on an
    interval schedule (skew -> hold -> heal), FAKETIME-spec'd offsets
    in the op values.  Fault key ``"skew"`` (the real-cluster
    ``"clock"`` package stays separate — it needs nodes)."""
    if "skew" not in opts.get("faults", ()):
        return None
    from jepsen_tpu_torch.nemesis.sim import SimClockSkewNemesis

    interval = opts.get("interval", DEFAULT_INTERVAL)
    rng = opts.get("rng") or _random
    return {
        "nemesis": SimClockSkewNemesis(
            rng if isinstance(rng, _random.Random) else None),
        "generator": gen.cycle([gen.sleep(interval),
                                {"f": "start-skew", "value": None},
                                gen.sleep(interval),
                                {"f": "stop-skew", "value": None}]),
        "final_generator": {"f": "stop-skew", "value": None},
        "perf": {"name": "skew", "start": {"start-skew"},
                 "stop": {"stop-skew"}, "fs": set()},
    }


# ------------------------------------------------------- sim membership

def membership_package(opts: dict) -> Optional[dict]:
    """Membership-change package for the sim cluster: a
    :class:`~jepsen_tpu_torch.nemesis.membership.MembershipNemesis` over
    :class:`~jepsen_tpu_torch.nemesis.sim.SimMembershipState` (join/leave
    against the store's member set).  Fault key ``"membership"``.
    A db suite supplies its own state via ``opts["membership_state"]``."""
    if "membership" not in opts.get("faults", ()):
        return None
    from jepsen_tpu_torch.nemesis.membership import (MembershipNemesis,
                                               possible_op)
    from jepsen_tpu_torch.nemesis.sim import SimMembershipState

    interval = opts.get("interval", DEFAULT_INTERVAL)
    state = opts.get("membership_state") or SimMembershipState(
        opts.get("nodes") or ["n1", "n2", "n3"])
    nem = MembershipNemesis(
        state,
        converge_timeout_s=opts.get("membership_timeout_s", 5.0),
        poll_interval_s=opts.get("membership_poll_s", 0.05))

    def next_change(test, ctx):
        op = possible_op(state, test)
        return op or {"f": "membership-view", "value": None}

    return {
        "nemesis": nem,
        "generator": gen.cycle([gen.sleep(interval),
                                gen.once(next_change)]),
        "final_generator": None,
        "perf": {"name": "membership",
                 "start": {"leave-node", "join-node"},
                 "stop": set(), "fs": {"membership-view"}},
    }


# ------------------------------------------------------- window schedule

#: fault families a campaign-level nemesis schedule can window:
#: family -> its package fn.  Window-shaped families emit a
#: start op at window open and a heal op at close; one-shot families
#: (file, membership) emit their single op at open.
WINDOW_FAULTS = {
    "partition": partition_package,
    "kill": kill_package,
    "pause": pause_package,
    "clock": clock_package,
    "file": file_package,
    "traffic": traffic_package,
    "skew": skew_package,
    "membership": membership_package,
}

#: families whose window has no closing op
_ONE_SHOT_FAULTS = frozenset({"file", "membership"})


def _window_events(fault: str, opts: dict):
    """(start, stop) event specs for one window of `fault` — the same
    op shapes the interval packages emit, minus the cycling.  `stop` is
    None for one-shot families."""
    if fault == "partition":
        return _partition_start(opts), {"f": "stop-partition",
                                        "value": None}
    if fault == "skew":
        return ({"f": "start-skew", "value": None},
                {"f": "stop-skew", "value": None})
    if fault == "kill":
        return ({"f": "kill", "value": None},
                {"f": "start", "value": None})
    if fault == "pause":
        return ({"f": "pause", "value": None},
                {"f": "resume", "value": None})
    if fault == "clock":
        return _clock_bump(opts), {"f": "reset-clock", "value": None}
    if fault == "traffic":
        return _traffic_degrade(opts), {"f": "fast", "value": None}
    if fault == "file":
        path = opts.get("file")
        rng = opts.get("rng") or _random

        def corrupt(test, ctx):
            node = rng.choice(test["nodes"])
            f = rng.choice(["bitflip-file", "truncate-file"])
            return {"f": f, "value": {"file": path, "nodes": [node]}}

        return corrupt, None
    if fault == "membership":
        from jepsen_tpu_torch.nemesis.membership import possible_op

        state = opts["membership_state"]

        def next_change(test, ctx):
            op = possible_op(state, test)
            return op or {"f": "membership-view", "value": None}

        return next_change, None
    raise ValueError(f"unknown window fault family {fault!r} "
                     f"(have {sorted(WINDOW_FAULTS)})")


def _stamp_event(evt, stamp: dict):
    """Attach the window identity (pos/digest/fault/host) to an event's
    emitted op — it rides the op dict into `Op.ext`, survives store
    round-trips, and is what the cross-host fault-window ddmin groups
    on."""
    if callable(evt):
        def fn(test, ctx):
            op = evt(test, ctx)
            return dict(op, window=dict(stamp)) if op else op

        return fn
    return dict(evt, window=dict(stamp))


def schedule_package(opts: dict) -> dict:
    """Build a nemesis package from EXPLICIT window descriptors instead
    of interval cycling (the campaign-level nemesis schedule):
    ``opts["windows"]`` is a list of ``{"pos", "fault", "at_s",
    "dur_s", "digest"}`` (the JAX package's
    `campaign.plan.schedule_windows` makes them; the port has no
    campaigns yet); the generator emits each window's start op at its
    offset and its heal op at close, every op stamped with the window
    identity plus ``opts["host"]`` (the executing host, for cross-host
    witness attribution).  Families whose package is unavailable in
    this run (e.g. ``kill`` without a Process-capable db) have their
    windows skipped.

    Sub-nemeses, final heal ops, and perf metadata come from the
    ordinary interval packages (`compose_packages` shape), so
    downstream consumers cannot tell a scheduled window from an
    interval one — except by the window stamp."""
    windows = [w for w in (opts.get("windows") or ())
               if w.get("fault") in WINDOW_FAULTS]
    host = str(opts.get("host") or "")
    fams = []
    for w in windows:
        if w["fault"] not in fams:
            fams.append(w["fault"])
    if "membership" in fams and not opts.get("membership_state"):
        from jepsen_tpu_torch.nemesis.sim import SimMembershipState

        opts = dict(opts, membership_state=SimMembershipState(
            opts.get("nodes") or ["n1", "n2", "n3"]))
    pkgs, alive = [], []
    for fam in fams:
        p = WINDOW_FAULTS[fam](dict(opts, faults={fam}))
        if p is not None:
            pkgs.append(p)
            alive.append(fam)
    base = compose_packages(pkgs)
    # wall-clock t0 alignment: when the campaign carries an
    # absolute anchor (opts["t0"], epoch seconds — a fleet worker's
    # claim-derived, clock-offset-corrected value), every window shifts
    # by (t0 - now) so its ABSOLUTE fire time matches the other hosts'
    # regardless of when each host's workload started.  An anchor in
    # the past clamps to 0 — relative semantics, the single-process
    # behavior, and window digests are anchor-free either way.
    shift = 0.0
    t0 = opts.get("t0")
    if isinstance(t0, (int, float)):
        shift = max(0.0, float(t0) - _time.time())
    timeline = []  # (time_s, order, event)
    for w in windows:
        if w["fault"] not in alive:
            continue
        start, stop = _window_events(w["fault"], opts)
        stamp = {"pos": w.get("pos"), "digest": w.get("digest"),
                 "fault": w["fault"], "host": host}
        timeline.append((shift + float(w["at_s"]), len(timeline),
                         _stamp_event(start, stamp)))
        if stop is not None and w["fault"] not in _ONE_SHOT_FAULTS:
            timeline.append((shift + float(w["at_s"]) + float(w["dur_s"]),
                             len(timeline), _stamp_event(stop, stamp)))
    timeline.sort(key=lambda t: (t[0], t[1]))
    seq, t_prev = [], 0.0
    for t, _, evt in timeline:
        if t > t_prev:
            seq.append(gen.sleep(t - t_prev))
            t_prev = t
        seq.append(gen.once(evt) if callable(evt) else evt)
    base["generator"] = seq or None
    return base


# ---------------------------------------------------------------- compose

PACKAGE_FNS = [partition_package, kill_package, pause_package,
               clock_package, file_package, traffic_package,
               skew_package, membership_package]


def _perf_list(pkg: dict) -> List[dict]:
    """A package's perf entries as a flat list — base packages carry
    one dict, COMPOSED packages a list (so composition must accept
    both to be closed under itself)."""
    perf = pkg.get("perf")
    if not perf:
        return []
    return [p for p in perf if p] if isinstance(perf, list) else [perf]


def _fs_of(pkg: dict) -> set:
    out: set = set()
    for perf in _perf_list(pkg):
        out |= (set(perf.get("start", ())) | set(perf.get("stop", ()))
                | set(perf.get("fs", ())))
    return out


def compose_packages(pkgs: Sequence[dict]) -> dict:
    """Combine packages: compose nemeses by their op fs; interleave
    generators with `any_gen`; chain final generators
    (reference `nemesis.combined/compose-packages`).  Closed under
    itself: an already-composed package (perf list, compose nemesis)
    composes again — its fs is the union of its entries', and its
    nested compose nemesis routes ops on — which is what lets a cell's
    own nemesis package stack with a campaign-level window schedule."""
    pkgs = [p for p in pkgs if p]
    if not pkgs:
        return {"nemesis": nc.Noop(), "generator": None,
                "final_generator": None, "perf": []}
    dispatch = {}
    for p in pkgs:
        fs = _fs_of(p)
        if not fs:
            continue
        dispatch[tuple(sorted(fs))] = p["nemesis"]
    gens = [p["generator"] for p in pkgs if p.get("generator")]
    finals = [p["final_generator"] for p in pkgs
              if p.get("final_generator")]
    return {
        "nemesis": nc.compose(dispatch),
        "generator": gen.any_gen(*gens) if gens else None,
        "final_generator": finals or None,
        "perf": [q for p in pkgs for q in _perf_list(p)],
    }


def nemesis_package(opts: dict) -> dict:
    """Build the combined fault package for `opts` (reference
    `nemesis.combined/nemesis-package`).

    The returned package's generator is nemesis-thread scoped — drop it
    into `test["nemesis_generator"]` or `gen.nemesis(...)` yourself.
    """
    extra = opts.get("extra_packages") or []
    pkgs = [fn(opts) for fn in PACKAGE_FNS] + list(extra)
    return compose_packages(pkgs)
