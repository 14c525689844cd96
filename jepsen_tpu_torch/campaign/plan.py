"""Campaign spec → expanded run list with stable per-run ids (the port's
copy of `jepsen_tpu/campaign/plan.py`: the same spec expands to the same
run ids, keys and device flags in both packages).

A campaign spec is a small declarative JSON document describing a
matrix of runs::

    {
      "name": "nightly",
      "workloads": ["append", {"name": "wr", "opts": {"concurrency": 8}}],
      "faults": [null, {"seed": 7, "p": 0.2, "kinds": "oom|xla"}],
      "seeds": [0, 1, 2],
      "opts": {"time-limit": 2.0, "telemetry": true,
               "checker-time-limit": 30}
    }

`expand` turns it into the cartesian product workload × fault × seed —
one :class:`RunSpec` per cell, in deterministic (workload-major) order.
Every RunSpec carries a *stable* ``run_id`` derived from a digest of
its canonicalized cell (campaign name, workload entry, fault entry,
seed, merged opts): re-expanding the same spec yields the same ids,
which is what makes the index resumable and regression queries
well-keyed across campaign generations.

Workloads resolve by name against the port's demo registry
(`jepsen_tpu_torch.__main__._wl`, the in-process sim cluster) plus
``"noop"`` (`core.noop_test` — runs no ops, always valid; the campaign
smoke workload).  A db suite extends the table via
:func:`register_workload`.  A cell's opts may carry ``"cpu"`` (set by
`campaign.core.run_campaign` after `expand`, so it never changes a run
id): the demo's checkers then run on the CPU, and the test map says so.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from jepsen_tpu_torch.resilience import faults as faults_mod

__all__ = ["RunSpec", "expand", "load_spec", "spec_digest",
           "build_test", "register_workload", "registered",
           "register_imported", "DEVICE_WORKLOADS",
           "schedule_windows", "windows_digest"]

#: workload names whose checkers dispatch to the device pipelines (elle
#: list-append/rw-register, knossos device WGL, the invariants family)
#: — the scheduler serializes these through device slots; host-only
#: checkers run freely
DEVICE_WORKLOADS = frozenset({
    "append", "wr", "causal", "long-fork", "lin-register", "queue",
    "bank", "write-skew", "session", "kafka",
})

#: extension point: name -> builder(opts_dict) -> test map (db suites
#: add their own); names here shadow the demo registry
_EXTRA_WORKLOADS: Dict[str, Callable[[Dict[str, Any]], dict]] = {}


def register_workload(name: str, builder: Callable[[Dict[str, Any]], dict],
                      device: bool = False) -> None:
    """Register a campaign-runnable workload: `builder(opts) -> test
    map`.  `device=True` marks it for device-slot serialization."""
    _EXTRA_WORKLOADS[name] = builder
    if device:
        global DEVICE_WORKLOADS
        DEVICE_WORKLOADS = DEVICE_WORKLOADS | {name}


def registered() -> List[Dict[str, Any]]:
    """The registered workloads whose builder can be imported by name
    (a module-level function of a module other than ``__main__``), as
    ``{"name", "builder": "module:qualname", "device"}`` — what the
    subprocess executor hands its runner, so that a fresh interpreter
    knows them too.  Lambdas and nested builders are left out: a runner
    reports them as unknown workloads."""
    out = []
    for name, fn in sorted(_EXTRA_WORKLOADS.items()):
        mod = getattr(fn, "__module__", None)
        qual = getattr(fn, "__qualname__", "")
        if not mod or mod == "__main__" or "<" in qual:
            continue
        out.append({"name": name, "builder": f"{mod}:{qual}",
                    "device": name in DEVICE_WORKLOADS})
    return out


def register_imported(entries: List[Dict[str, Any]]) -> None:
    """Register every entry of :func:`registered` in this process."""
    import importlib

    for e in entries:
        mod, _, qual = e["builder"].partition(":")
        fn: Any = importlib.import_module(mod)
        for part in qual.split("."):
            fn = getattr(fn, part)
        register_workload(e["name"], fn, device=bool(e.get("device")))


@dataclass
class RunSpec:
    """One cell of the campaign matrix — everything needed to build and
    run the test, declaratively (so a subprocess executor can rebuild
    it from JSON)."""

    run_id: str
    campaign: str
    workload: str
    seed: int
    fault: Optional[Union[dict, str]] = None
    fault_label: str = "nofault"
    workload_label: str = ""
    opts: Dict[str, Any] = field(default_factory=dict)
    device: bool = False

    @property
    def key(self) -> str:
        """The regression key: stable across campaign generations."""
        return f"{self.workload_label}|{self.fault_label}|s{self.seed}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_id": self.run_id, "campaign": self.campaign,
            "workload": self.workload, "seed": self.seed,
            "fault": self.fault, "fault_label": self.fault_label,
            "workload_label": self.workload_label, "opts": self.opts,
            "device": self.device,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        return cls(**d)


def _digest(obj: Any, n: int = 8) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:n]


def spec_digest(spec: dict) -> str:
    """Digest of the whole (normalized) spec — stamped into index
    records so a ledger mixing two different specs is detectable."""
    return _digest(load_spec(spec), 12)


def load_spec(spec: Union[str, dict]) -> dict:
    """Load + normalize a campaign spec (path or dict).  Raises
    ValueError on malformed specs with a message naming the field."""
    if isinstance(spec, str):
        with open(spec) as f:
            spec = json.load(f)
    if not isinstance(spec, dict):
        raise ValueError(f"campaign spec must be a dict, got {type(spec).__name__}")
    out = dict(spec)
    out["name"] = str(out.get("name") or "campaign")
    wls = out.get("workloads")
    if not wls or not isinstance(wls, list):
        raise ValueError('campaign spec needs a non-empty "workloads" list')
    # dedupe each axis after normalization (order-preserving): entries
    # that alias to the same cell — e.g. faults [null, "", {}] all
    # normalize to None — would otherwise expand to runs with IDENTICAL
    # run_ids that race each other in the store
    out["workloads"] = _uniq([_norm_workload(w) for w in wls])
    out["faults"] = _uniq(
        [_norm_fault(fp) for fp in (out.get("faults") or [None])])
    seeds = out.get("seeds") or [0]
    out["seeds"] = _uniq([int(s) for s in seeds])
    out["opts"] = dict(out.get("opts") or {})
    out["nemesis-schedule"] = _norm_schedule(out.get("nemesis-schedule"))
    if out["nemesis-schedule"] is None:
        out.pop("nemesis-schedule")
    return out


def _norm_schedule(s: Union[None, dict]) -> Optional[dict]:
    """Normalize + validate the campaign-level ``"nemesis-schedule"``
    block: generation-scoped fault windows every
    cell of generation *g* (= the seed axis) experiences identically,
    whether the campaign runs single-process or distributed over a
    fleet.  Keys:

        faults    list of window-able fault families (validated against
                  `nemesis.combined.WINDOW_FAULTS`)
        windows   int, windows per generation (round-robin over faults)
        interval  float s, nominal gap before/between windows
        duration  float s, how long each window stays open
        seed      int, the schedule seed — combined with the generation
                  so each generation draws its own (replayable) layout
        plan      optional resilience FaultPlan spec template; each
                  generation installs it with a generation-derived seed
                  (see `resilience.faults.seeded_for`)
    """
    if not s:
        return None
    if not isinstance(s, dict):
        raise ValueError('"nemesis-schedule" must be a dict, got '
                         f"{type(s).__name__}")
    from jepsen_tpu_torch.nemesis.combined import WINDOW_FAULTS

    faults = s.get("faults")
    if isinstance(faults, str):
        faults = [faults]
    faults = [str(f) for f in (faults or ())]
    if not faults:
        raise ValueError('"nemesis-schedule" needs a non-empty '
                         '"faults" list')
    unknown = [f for f in faults if f not in WINDOW_FAULTS]
    if unknown:
        raise ValueError(
            f"unknown nemesis-schedule fault(s) {unknown}; window-able "
            f"families: {sorted(WINDOW_FAULTS)}")
    out = {
        "faults": faults,
        "windows": max(1, int(s.get("windows", 1))),
        "interval": float(s.get("interval", 0.25)),
        "duration": float(s.get("duration", s.get("interval", 0.25))),
        "seed": int(s.get("seed", 0)),
    }
    if out["interval"] < 0 or out["duration"] < 0:
        # a negative duration would sort a window's heal BEFORE its
        # start — fail at plan time like every other spec error
        raise ValueError(
            '"nemesis-schedule" interval/duration must be >= 0 (got '
            f"interval={out['interval']}, duration={out['duration']})")
    plan = faults_mod.parse_spec(s.get("plan"))
    if plan is not None:
        faults_mod.FaultPlan.from_spec(plan)  # raises on bad specs
        out["plan"] = plan
    return out


def schedule_windows(spec: Union[str, dict], generation: int
                     ) -> List[dict]:
    """Expand a campaign's nemesis schedule into generation *g*'s
    synchronized window assignments — the pure function both the
    single-process `run_campaign` (via `expand`) and the fleet
    coordinator's claim broadcast evaluate, so every host's cell for a
    generation installs the identical seeded window set.

    Each descriptor: ``{"pos", "fault", "at_s", "dur_s", "digest"}``
    — ``pos`` is the schedule position, ``at_s``/``dur_s`` the window's
    offset/length relative to workload start, and ``digest`` the
    window's schedule-shape identity (spec + generation + position;
    deliberately host-free, so distributed and single-process runs of
    the same spec agree on it)."""
    if isinstance(spec, dict) and "faults" in spec \
            and "workloads" not in spec:
        sched = _norm_schedule(spec)
    else:
        sched = load_spec(spec).get("nemesis-schedule")
    if not sched:
        return []
    import random as _random

    rng = _random.Random(f"nemesis-schedule|{sched['seed']}|{generation}")
    wins: List[dict] = []
    t = 0.0
    for pos in range(sched["windows"]):
        fault = sched["faults"][pos % len(sched["faults"])]
        t += sched["interval"] * rng.uniform(0.5, 1.5)
        w = {"pos": pos, "fault": fault, "at_s": round(t, 4),
             "dur_s": round(sched["duration"], 4)}
        w["digest"] = _digest({"schedule": {k: sched[k] for k in
                                            ("faults", "windows",
                                             "interval", "duration",
                                             "seed")},
                               "gen": int(generation), **w}, 12)
        wins.append(w)
        t += sched["duration"]
    return wins


def windows_digest(wins: Optional[List[dict]]) -> str:
    """One digest over a window set — what workers report as their
    installed-window identity and the dashboard compares for desync."""
    if not wins:
        return ""
    return _digest([w.get("digest") for w in wins], 12)


def _uniq(xs: list) -> list:
    out, seen = [], set()
    for x in xs:
        k = json.dumps(x, sort_keys=True, default=str)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


def _norm_workload(w: Union[str, dict]) -> dict:
    if isinstance(w, str):
        w = {"name": w}
    if not isinstance(w, dict) or not w.get("name"):
        raise ValueError(f'bad workload entry {w!r} (want "name" or '
                         '{"name": ..., "opts": {...}})')
    out = {"name": str(w["name"]), "opts": dict(w.get("opts") or {})}
    if w.get("label"):
        out["label"] = str(w["label"])
    return out


def _norm_fault(fp: Union[None, str, dict]) -> Optional[dict]:
    """Normalize a fault-plan entry; validates via the FaultPlan parser
    so a bad spec fails at plan time, not mid-campaign."""
    if fp is None:
        return None
    if isinstance(fp, dict) and "spec" in fp:  # labeled form
        d = faults_mod.parse_spec(fp["spec"])
        if d is None:
            return None
        faults_mod.FaultPlan.from_spec(d)  # raises on unknown keys/kinds
        return {"label": str(fp.get("label") or "f-" + _digest(d, 6)),
                "spec": d}
    d = faults_mod.parse_spec(fp)
    if d is None:
        return None
    faults_mod.FaultPlan.from_spec(d)  # raises on unknown keys/kinds
    return {"label": "f-" + _digest(d, 6), "spec": d}


def _wl_label(w: dict) -> str:
    if w.get("label"):
        return w["label"]
    return w["name"] + (f"-{_digest(w['opts'], 4)}" if w["opts"] else "")


def known_workloads() -> List[str]:
    """Every workload name a spec entry may resolve to: registered
    builders, ``"noop"``, and the demo registry."""
    from jepsen_tpu_torch.__main__ import DEMOS

    return sorted(set(_EXTRA_WORKLOADS) | {"noop"} | set(DEMOS))


def expand(spec: Union[str, dict]) -> List[RunSpec]:
    """Expand a campaign spec into its RunSpec list (workload-major,
    then fault, then seed — deterministic).

    Workload names are validated here, at plan time: an unknown entry
    raises a ValueError naming the bad workload and listing every
    registered one, instead of surfacing as a bare resolution error
    mid-campaign."""
    spec = load_spec(spec)
    known = known_workloads()
    for w in spec["workloads"]:
        if w["name"] not in known:
            raise ValueError(
                f"unknown workload {w['name']!r} in campaign spec "
                f"{spec['name']!r}; registered workloads: "
                f"{', '.join(known)}")
    name = spec["name"]
    base_opts = spec["opts"]
    sched = spec.get("nemesis-schedule")
    # one window set per generation, shared by every cell of that seed
    sched_wins = {s: schedule_windows(sched, s)
                  for s in spec["seeds"]} if sched else {}
    out: List[RunSpec] = []
    for w in spec["workloads"]:
        wl_label = _wl_label(w)
        merged = {**base_opts, **w["opts"]}
        for fp in spec["faults"]:
            f_label = fp["label"] if fp else "nofault"
            f_spec = fp["spec"] if fp else None
            for seed in spec["seeds"]:
                cell_opts = dict(merged)
                if sched:
                    # the campaign-level nemesis schedule: every cell
                    # of generation g (= the seed axis) carries the
                    # same seeded window set, so the single-process
                    # and fleet-distributed expansions of one spec are
                    # chaos-equivalent cell for cell
                    cell_opts.setdefault(
                        "nemesis-windows", sched_wins[seed])
                    if sched.get("plan") is not None:
                        cell_opts.setdefault(
                            "nemesis-plan",
                            faults_mod.seeded_for(sched["plan"], seed))
                cell = {"campaign": name, "workload": w, "fault": f_spec,
                        "seed": seed, "opts": cell_opts}
                rid = f"{wl_label}-{f_label}-s{seed}-{_digest(cell)}"
                out.append(RunSpec(
                    run_id=rid, campaign=name, workload=w["name"],
                    seed=seed, fault=f_spec, fault_label=f_label,
                    workload_label=wl_label, opts=dict(cell_opts),
                    device=bool(cell_opts.get(
                        "device", w["name"] in DEVICE_WORKLOADS)),
                ))
    return out


# ---------------------------------------------------------------------------
# RunSpec -> runnable test map
# ---------------------------------------------------------------------------

def _nemesis_for(opts: Dict[str, Any], seed: int, nodes, client):
    """Build the combined nemesis package a cell's opts request.

    ``opts["nemesis"]`` is a dict (``{"faults": ["skew"], "interval":
    0.2, ...}``) or a bare fault-name string/list; seeded from the
    cell's seed so schedules replay deterministically."""
    spec = opts.get("nemesis")
    if not spec:
        return None
    import random as _random

    from jepsen_tpu_torch.nemesis import combined

    if isinstance(spec, str):
        spec = {"faults": [spec]}
    elif isinstance(spec, (list, tuple)):
        spec = {"faults": list(spec)}
    pkg_opts = dict(spec)
    pkg_opts.setdefault("faults", [])
    pkg_opts.setdefault("interval", 0.25)
    pkg_opts.setdefault("nodes", list(nodes))
    pkg_opts["rng"] = _random.Random(seed)
    pkg_opts.setdefault("client", client)
    return combined.nemesis_package(pkg_opts)


def _schedule_pkg_for(opts: Dict[str, Any], nodes, client):
    """Build the campaign-schedule nemesis package for a cell carrying
    ``opts["nemesis-windows"]`` (injected by `expand`, or installed by
    a fleet worker from its claim response).  Seeded from the window
    set's own digest, so two hosts handed the same window set run the
    identical fault schedule; the executing host's identity
    (``opts["_fleet-host"]``, the fleet worker name, else the
    hostname) is stamped onto every window op for the cross-host
    ddmin's host attribution."""
    wins = opts.get("nemesis-windows")
    if not wins:
        return None
    import random as _random
    import socket as _socket

    from jepsen_tpu_torch.nemesis import combined

    host = str(opts.get("_fleet-host") or _socket.gethostname())
    return combined.schedule_package({
        "windows": wins,
        "nodes": list(nodes),
        "rng": _random.Random(f"sched|{windows_digest(wins)}"),
        "host": host,
        "client": client,
        # wall-clock anchor: fleet workers install the
        # claim's clock-offset-corrected t0 so every host's windows
        # fire at the same absolute time; absent (single-process) the
        # offsets stay relative to workload start
        "t0": opts.get("nemesis-t0"),
    })


def build_test(rs: RunSpec, base: str) -> dict:
    """Build the `core.run`-able test map for one campaign cell.

    Workloads resolve by name: registered builders first, then
    ``"noop"``, then the demo registry over the in-process sim cluster.
    Opts honored: ``time-limit`` (seconds of workload; None = ops-bound
    only), ``ops`` (op-count cap), ``concurrency``, ``nodes``,
    ``telemetry``, ``checker-time-limit``, ``cpu``.  The run's fault spec (if
    any) lands in ``test["faults"]`` — the resilience FaultPlan key."""
    from jepsen_tpu_torch import core as jcore
    from jepsen_tpu_torch.generator import core as g

    opts = dict(rs.opts)
    name = f"{rs.campaign}--{rs.run_id}"
    if rs.workload in _EXTRA_WORKLOADS:
        t = _EXTRA_WORKLOADS[rs.workload]({**opts, "seed": rs.seed})
        t["name"] = name
    elif rs.workload == "noop":
        t = jcore.noop_test(name=name)
    else:
        from jepsen_tpu_torch.__main__ import _wl

        wl, client = _wl(rs.workload, {**opts, "seed": rs.seed})
        nodes = list(opts.get("nodes") or ["n1", "n2", "n3"])
        gen = g.clients(wl["generator"])
        if opts.get("ops"):
            gen = g.limit(int(opts["ops"]), gen)
        # nemesis schedules (opts "nemesis": {"faults": [...], ...})
        # compose BEFORE the time limit: the package generators are
        # unbounded cycles, and the wall clock must bound the whole
        # interleaving, not just the client half.  A campaign-level
        # window schedule (opts "nemesis-windows") composes alongside
        # any per-cell nemesis.
        pkgs = [p for p in (_nemesis_for(opts, rs.seed, nodes, client),
                            _schedule_pkg_for(opts, nodes, client)) if p]
        pkg = None
        if pkgs:
            from jepsen_tpu_torch.nemesis import combined

            pkg = pkgs[0] if len(pkgs) == 1 \
                else combined.compose_packages(pkgs)
        if pkg is not None and pkg.get("generator") is not None:
            gen = g.any_gen(gen, g.nemesis(pkg["generator"]))
        tl = opts.get("time-limit", 1.0)
        if tl:
            gen = g.time_limit(float(tl), gen)
        t = jcore.noop_test(
            name=name,
            nodes=nodes,
            concurrency=int(opts.get("concurrency", 4)),
            client=client, generator=gen, checker=wl["checker"])
        for k, v in wl.items():
            if k not in ("generator", "checker", "final-generator"):
                t.setdefault(k, v)
        finals = []
        if "final-generator" in wl:
            finals.append(wl["final-generator"])
        if pkg is not None:
            t["nemesis"] = pkg["nemesis"]
            if pkg.get("final_generator"):
                finals.append(g.nemesis(pkg["final_generator"]))
        if finals:
            t["final-generator"] = finals[0] if len(finals) == 1 \
                else finals
    t["store-dir"] = base
    t["seed"] = rs.seed
    t["campaign"] = rs.campaign
    t["campaign-run-id"] = rs.run_id
    # the distributed trace id: claim-carried for fleet
    # cells, derived from the stable run id otherwise — either way the
    # SAME id, so distributed and single-process cells stitch alike
    from jepsen_tpu_torch.telemetry import spans as _spans

    t["trace-id"] = str(opts.get("trace-id")
                        or _spans.trace_id_for(rs.run_id))
    if opts.get("_fleet-host"):
        # which fleet worker executes this cell — the live-check
        # session's host attribution (verdict-freshness per host on
        # the /fleet page) and the timeline's host column
        t["fleet-host"] = str(opts["_fleet-host"])
    if opts.get("telemetry"):
        t["telemetry"] = True
    if opts.get("live-check"):
        # live verification: the cell's interpreter streams
        # completed ops into a verifier session while it runs — a URL
        # (remote service / fleet coordinator with --ingest) or
        # {"inproc": true}; see docs/VERIFIER.md
        t["live-check"] = opts["live-check"]
    if opts.get("checker-time-limit") is not None:
        t["checker-time-limit"] = float(opts["checker-time-limit"])
    if opts.get("cpu"):
        # the run's checkers are on the CPU: a later shrink or re-check
        # of the stored run resolves its checker there too
        t["cpu"] = True
    if rs.fault is not None:
        t["faults"] = rs.fault
    elif opts.get("nemesis-plan") is not None:
        # the schedule's generation-seeded resilience plan: installed
        # only when the cell's own fault axis is empty (an explicit
        # fault entry always wins)
        t["faults"] = dict(opts["nemesis-plan"])
    return t
