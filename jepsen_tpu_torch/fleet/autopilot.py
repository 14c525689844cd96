"""The fleet autopilot: continuous verification as a self-healing,
self-scaling service (the port's copy of `jepsen_tpu/fleet/autopilot.py`).

Everything below it already runs forever — the leased `WorkQueue`,
live checks, federated metrics, the regression gate — but campaigns
are batch jobs a human starts.  The autopilot is the driver: a loop
that expands a spec template into **generations** (template ×
rotating seed order, ``opts["autopilot-gen"] = "gNNNN"``), streams
each generation into the coordinator's queue, waits for the fleet to
drain it, runs the Mann-Whitney gate (`telemetry.gate`) against the
previous generation, and reacts:

- gate rc 1 (**regression**): the offending cell key is attributed
  (largest per-key p95 delta on the regressing span), **quarantined**
  — never enqueued again, ``fleet-quarantined-cells`` gauge — and
  **auto-shrunk** through `minimize.shrink` to a witness appended to
  the campaign index, next to an ``obs diff`` forensics artifact;
- gate rc 2 (**cannot evaluate**): degrade gracefully — keep
  streaming, never quarantine on missing evidence.

Durability: autopilot state (generation ledger, quarantine set, last
verdicts, shrink outcomes) lives in an fsync'd torn-line-tolerant
jsonl journal (`AutopilotJournal`) with the same
replay-to-identical-digest discipline as `fleet/queue.py`.  The
crash-window contract: a generation is journaled (``gen-open``)
BEFORE its cells are enqueued, enqueue is idempotent on the stable
run ids, and construction re-admits every journaled generation — so
``kill -9`` anywhere (including between the journal append and the
queue enqueue) resumes with zero duplicate cells and an identical
journal digest.

Chaos: every decision seam is a guarded `resilience.device_call`
fault site — ``autopilot.enqueue``, ``autopilot.gate``,
``autopilot.shrink``, ``autopilot.scale`` — so an installed
`FaultPlan` injects into the loop's own decisions.  A failed seam
never wedges the loop: enqueue retries (idempotent), a dead gate
closes the generation with an attributable ``gate-error`` verdict, a
dead shrink journals its error, a dead scale tick is skipped.

Elasticity (second leg): `Autopilot` owns a scaler that reads the
two signals the coordinator publishes — queue depth and claim-latency
p95 — and spawns/drains local ``fleet work`` subprocesses between
``min_workers``/``max_workers`` (drain = SIGTERM: the worker's
finish-in-flight semantics make it lossless).  Workers stamp a
``version`` at register/heartbeat; when ``worker_version`` changes
mid-campaign the scaler performs a **rolling upgrade** — spawn one
replacement, wait until it is alive at the new version, then drain
exactly one old worker — so every cell lands and /metrics cardinality
stays flat throughout.

See ``docs/AUTOPILOT.md``.

In the port the managed workers are ``python -m jepsen_tpu_torch fleet
work`` children, each carrying this process's environment; they check
on the CUDA card (``worker_extra=("--cpu",)`` puts them on the CPU), and
an auto-shrink resolves the stored run's checker on the device the run
was checked on.  The parole's witness re-check runs the host twin on
the CPU.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from jepsen_tpu_torch import store
from jepsen_tpu_torch.campaign import plan as plan_mod

from .coordinator import ALIVE_LEASES, FleetCoordinator

logger = logging.getLogger("jepsen.fleet.autopilot")

__all__ = ["Autopilot", "AutopilotJournal", "autopilot_path", "GATE_RC",
           "scenario_rotation"]

#: gate status -> the ``cli obs gate`` exit-code convention the loop
#: reacts to: 1 quarantines, 2 degrades gracefully (never quarantine
#: on missing evidence)
GATE_RC = {"pass": 0, "regression": 1}


def autopilot_path(name: str, base: Optional[str] = None) -> str:
    """The autopilot journal for campaign `name` —
    ``<store>/fleet/<name>.autopilot.jsonl``, next to the queue
    ledger."""
    return os.path.join(base or store.BASE, "fleet",
                        store.sanitize(name) + ".autopilot.jsonl")


def _cell_label(cell: Any) -> str:
    """The name a rotation pivot matches against: a cell's explicit
    ``label`` if it has one, else its workload ``name``."""
    if isinstance(cell, dict):
        return str(cell.get("label") or cell.get("name") or "")
    return str(cell)


def scenario_rotation(*, pivot: Tuple[str, ...] = (),
                      slots: int = 1) -> Callable[[int, dict], dict]:
    """A deterministic ``Autopilot(mutate=...)`` that rotates
    SCENARIOS, not just seeds.

    Each generation keeps the **pivot** cells — the workloads the
    cross-generation gate tracks continuously, matched by cell label
    or workload name (the template's first cell when ``pivot`` is
    empty) — and fills ``slots`` extra slots by walking the remaining
    template cells in order, ``slots`` at a time, wrapping around.
    Over ``ceil(len(rest) / slots)`` generations every scenario in the
    template has run, while the pivot's span stays gate-comparable
    generation over generation.

    Pure in ``(i, template)`` — no ambient state — which is what the
    journal's replay-to-identical-digest discipline requires: resume
    after kill -9 re-derives byte-identical generation specs.
    Quarantine keys stay meaningful because rotation re-admits a cell
    with the SAME key every time its slot comes around."""
    pivots = tuple(str(p) for p in pivot)
    n_slots = max(1, int(slots))

    def mutate(i: int, sp: dict) -> dict:
        cells = list(sp.get("workloads") or [])
        if len(cells) <= 1:
            return sp
        if pivots:
            keep = [c for c in cells if _cell_label(c) in pivots]
            rest = [c for c in cells if _cell_label(c) not in pivots]
        else:
            keep, rest = [cells[0]], cells[1:]
        if not rest:
            return sp
        k = (i * n_slots) % len(rest)
        take = [rest[(k + j) % len(rest)]
                for j in range(min(n_slots, len(rest)))]
        sp["workloads"] = keep + take
        return sp

    return mutate


class AutopilotJournal:
    """The autopilot's durable brain: an append-only fsync'd jsonl
    ledger with the exact `queue.WorkQueue` discipline — in-memory
    state is a pure function of the event sequence, a torn final line
    (crash mid-append) is ignored on replay and healed by the writer
    before its first append, and `digest` pins the replayed state so
    kill -9 tests can compare independent replays.

    Events: ``gen-open`` (a generation's durable intent — written
    BEFORE its cells are enqueued), ``gen-close`` (the gate verdicts),
    ``quarantine``, ``parole`` (re-admission after clean neighbor
    generations — a re-quarantine of a paroled key
    archives the prior stint under ``history``), ``shrink``,
    ``scale``.  Scale events are an audit trail, not state: like the
    queue's requeue/duplicate counters they are derived telemetry and
    excluded from the digest."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        #: label -> {seeds, runs, closed, verdicts, opened-ts}
        self.gens: Dict[str, Dict[str, Any]] = {}
        #: generation labels in open order
        self.order: List[str] = []
        #: key -> {gen, span, rel-delta, ts}
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        #: key -> {gen, outcome}
        self.shrinks: Dict[str, Dict[str, Any]] = {}
        #: derived audit counter (digest-excluded)
        self.scale_events = 0
        self._good_bytes = 0
        self._healed = False
        self._load()

    # -- replay --------------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail: crash mid-append — ignore
            try:
                ev = json.loads(line.decode("utf-8"))
            except ValueError:
                break
            self._apply(ev)
            good += len(line)
        self._good_bytes = good

    def _apply(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("ev")
        if kind == "gen-open":
            label = str(ev.get("gen"))
            if label not in self.gens:
                self.order.append(label)
            self.gens[label] = {
                "seeds": ev.get("seeds"), "runs": ev.get("runs"),
                "closed": False, "verdicts": None,
                "opened-ts": ev.get("ts")}
        elif kind == "gen-close":
            label = str(ev.get("gen"))
            g = self.gens.get(label)
            if g is None:
                g = self.gens[label] = {"seeds": None, "runs": None,
                                        "opened-ts": None}
                self.order.append(label)
            g["closed"] = True
            g["verdicts"] = ev.get("verdicts") or []
        elif kind == "quarantine":
            key = str(ev.get("key"))
            cur = self.quarantined.get(key)
            fresh = {"gen": ev.get("gen"), "span": ev.get("span"),
                     "rel-delta": ev.get("rel-delta"),
                     "ts": ev.get("ts")}
            if cur is None:
                self.quarantined[key] = fresh
            elif "paroled-gen" in cur:
                # a paroled key regressed again: archive the prior
                # stint so old-generation replays still exclude it
                hist = list(cur.get("history") or [])
                hist.append({"gen": cur.get("gen"),
                             "paroled-gen": cur.get("paroled-gen")})
                fresh["history"] = hist
                self.quarantined[key] = fresh
            # an active quarantine absorbs duplicate events
        elif kind == "parole":
            v = self.quarantined.get(str(ev.get("key")))
            if v is not None and "paroled-gen" not in v:
                v["paroled-gen"] = ev.get("gen")
        elif kind == "shrink":
            self.shrinks[str(ev.get("key"))] = {
                "gen": ev.get("gen"), "outcome": ev.get("outcome")}
        elif kind == "scale":
            self.scale_events += 1

    # -- append --------------------------------------------------------------

    def _event(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        ev = dict(ev)
        ev["ts"] = round(time.time(), 3)
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            if not self._healed:
                # only the writer heals: truncate a torn tail right
                # before the first append so readers of a crashed
                # journal replay the same prefix we extend
                if os.path.exists(self.path) and \
                        os.path.getsize(self.path) > self._good_bytes:
                    with open(self.path, "rb+") as f:
                        f.truncate(self._good_bytes)
                self._healed = True
            with open(self.path, "ab") as f:
                f.write((json.dumps(ev, sort_keys=True) + "\n")
                        .encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            self._apply(ev)
        return ev

    def open_gen(self, label: str, *, seeds: Any = None,
                 runs: Any = None) -> None:
        self._event({"ev": "gen-open", "gen": label, "seeds": seeds,
                     "runs": runs})

    def close_gen(self, label: str,
                  verdicts: List[Dict[str, Any]]) -> None:
        self._event({"ev": "gen-close", "gen": label,
                     "verdicts": verdicts})

    def quarantine(self, key: str, *, gen: str, span: Any = None,
                   rel_delta: Any = None) -> None:
        self._event({"ev": "quarantine", "key": key, "gen": gen,
                     "span": span, "rel-delta": rel_delta})

    def parole(self, key: str, *, gen: str,
               twin: Any = None) -> None:
        """Re-admit a quarantined key: durable as of generation
        `gen`'s close — the key re-enters the plan from the NEXT
        generation on.  ``twin`` records the host-twin re-check that
        justified the parole; it is audit
        payload only — ``_apply`` reads key/gen alone, so journals
        with and without it replay to the same state."""
        ev = {"ev": "parole", "key": key, "gen": gen}
        if twin is not None:
            ev["twin"] = twin
        self._event(ev)

    def shrink(self, key: str, *, gen: str,
               outcome: Dict[str, Any]) -> None:
        self._event({"ev": "shrink", "key": key, "gen": gen,
                     "outcome": outcome})

    def scale(self, action: str, **fields: Any) -> None:
        self._event(dict({"ev": "scale", "action": action}, **fields))

    # -- state ---------------------------------------------------------------

    def closed_labels(self) -> List[str]:
        with self._lock:
            return [l for l in self.order
                    if self.gens[l].get("closed")]

    def digest(self) -> str:
        """Replayed-state digest (scale audit events excluded — they
        are derived counters, same rule as the queue's requeues)."""
        with self._lock:
            state = {
                "gens": [(l, bool(self.gens[l].get("closed")),
                          self.gens[l].get("runs"),
                          self.gens[l].get("verdicts"))
                         for l in self.order],
                "quarantined": sorted(
                    (k, v.get("gen"), v.get("span"),
                     v.get("paroled-gen"),
                     json.dumps(v.get("history") or [],
                                sort_keys=True))
                    for k, v in self.quarantined.items()),
                "shrinks": sorted(
                    (k, json.dumps(v, sort_keys=True, default=str))
                    for k, v in self.shrinks.items()),
            }
        blob = json.dumps(state, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class Autopilot:
    """Stream generations of `template` into a fleet forever (or for
    ``generations``), gate each one, quarantine + auto-shrink
    regressions, and keep the worker pool sized to the queue.

    The constructor owns a `FleetCoordinator` built from generation
    0's spec (mount it on `web.serve` to give workers the HTTP plane)
    and immediately **re-admits every journaled generation** — the
    crash-recovery seam: enqueue is idempotent on run ids, indexed
    cells are recognized as done, so a restart never duplicates work.
    """

    def __init__(self, template: Union[str, dict],
                 base: Optional[str] = None, *,
                 lease_s: float = 15.0,
                 run_deadline_s: Optional[float] = None,
                 generations: Optional[int] = None,
                 spans: Tuple[str, ...] = ("workload", "check:*"),
                 alpha: float = 0.05, threshold: float = 0.25,
                 min_runs: int = 3,
                 parole_after: Optional[int] = None,
                 mutate: Optional[Callable[[int, dict], dict]] = None,
                 on_generation: Optional[
                     Callable[["Autopilot", dict], None]] = None,
                 coordinator_url: Optional[str] = None,
                 min_workers: int = 0, max_workers: int = 0,
                 worker_version: str = "dev",
                 depth_per_worker: int = 2,
                 p95_high_s: float = 5.0,
                 scale_interval_s: float = 1.0,
                 worker_poll_s: float = 0.1,
                 worker_extra: Tuple[str, ...] = (),
                 shrink_knobs: Optional[Dict[str, Any]] = None,
                 alert_rules: Optional[list] = None,
                 alert_sinks: Optional[list] = None,
                 poll_s: float = 0.2):
        if isinstance(template, str):
            with open(template) as f:
                template = json.load(f)
        #: the RAW template — generation specs are json-copies of it,
        #: mutated (seed rotation + autopilot-gen opt) then normalized
        self.template = json.loads(json.dumps(template))
        self._norm = plan_mod.load_spec(self.template)
        self.name = self._norm["name"]
        self.base = base or store.BASE
        self.generations = generations
        self.spans = tuple(spans)
        self.alpha, self.threshold = float(alpha), float(threshold)
        self.min_runs = int(min_runs)
        self.parole_after = int(parole_after) if parole_after \
            else None
        self.mutate = mutate
        self.on_generation = on_generation
        self.coordinator_url = coordinator_url
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.worker_version = str(worker_version)
        self.depth_per_worker = max(1, int(depth_per_worker))
        self.p95_high_s = float(p95_high_s)
        self.scale_interval_s = float(scale_interval_s)
        self.worker_poll_s = float(worker_poll_s)
        self.worker_extra = tuple(worker_extra or ())
        self.shrink_knobs = dict(shrink_knobs or {})
        self.poll_s = float(poll_s)
        self.stop = threading.Event()
        from jepsen_tpu_torch.resilience import RetryPolicy, \
            is_transient

        self._seam_policy = RetryPolicy(
            max_attempts=3, base_delay_s=0.05, max_delay_s=0.5,
            classify=is_transient)
        self.journal = AutopilotJournal(
            autopilot_path(self.name, self.base))
        #: managed worker subprocesses:
        #: name -> {proc, version, spawned, draining}
        self.workers: Dict[str, Dict[str, Any]] = {}
        self._wseq = 0
        self._upgrading: Optional[Tuple[str, str]] = None
        self._last_scale = 0.0
        #: witness digest -> (parole allowed, twin audit doc) — the
        #: host-twin re-check is deterministic, so one verdict per
        #: digest serves every parole tick
        self._twin_cache: Dict[str, Tuple[bool, Any]] = {}
        from jepsen_tpu_torch.telemetry.alerts import AlertEngine

        #: the watchtower: evaluated on the scale cadence
        #: while awaiting a generation, and once after each gate
        self.alerts = AlertEngine(self.base, rules=alert_rules,
                                  sinks=alert_sinks)
        self.coordinator = FleetCoordinator(
            self._gen_spec(0), self.base, lease_s=lease_s,
            run_deadline_s=run_deadline_s)
        #: the /fleet page's autopilot panel reads status_doc via this
        self.coordinator.autopilot = self
        self._readmit()
        self._update_gauges()
        logger.info("autopilot %s: journal %s (%d gen(s) journaled, "
                    "%d quarantined), digest %s", self.name,
                    self.journal.path, len(self.journal.order),
                    len(self.journal.quarantined),
                    self.journal.digest())

    # -- generation planning -------------------------------------------------

    @staticmethod
    def _label(i: int) -> str:
        return "g%04d" % i

    @staticmethod
    def _gen_index(label: Any) -> int:
        try:
            return int(str(label).lstrip("g"))
        except (TypeError, ValueError):
            return -1

    def _gen_spec(self, i: int) -> dict:
        """Generation i's spec: a copy of the template with the seed
        ORDER rotated (same seed set — cell keys stay stable across
        generations, which is what makes quarantine keys and the
        cross-generation gate meaningful) and the generation label in
        the base opts (in the cells' run-id digests but NOT their
        keys, so every generation gets fresh idempotent run ids)."""
        sp = json.loads(json.dumps(self.template))
        if self.mutate is not None:
            sp = self.mutate(i, sp) or sp
        seeds = [int(s) for s in
                 (sp.get("seeds") or self._norm["seeds"])]
        k = i % max(1, len(seeds))
        sp["seeds"] = seeds[k:] + seeds[:k]
        sp.setdefault("opts", {})["autopilot-gen"] = self._label(i)
        return sp

    def _quarantined_at(self, v: Dict[str, Any], i: int) -> bool:
        """Was this key out of the plan at generation i?  A key is
        excluded during every quarantine STINT — from the generation
        after its quarantine through its parole generation inclusive
        (re-admission starts the generation after the parole), with
        prior stints preserved under ``history`` so old-generation
        replays stay byte-identical after a re-quarantine."""
        for stint in list(v.get("history") or []) + [v]:
            q = self._gen_index(stint.get("gen"))
            p = stint.get("paroled-gen")
            if q < i and (p is None or self._gen_index(p) >= i):
                return True
        return False

    def _plan(self, i: int) -> list:
        """Generation i's cells, minus keys quarantined by an EARLIER
        generation's gate and not yet paroled — a replay of an old
        generation applies the quarantine/parole state as of that
        generation, so resume re-admits byte-identical cell sets."""
        specs = plan_mod.expand(plan_mod.load_spec(self._gen_spec(i)))
        quarantined = {k for k, v in self.journal.quarantined.items()
                       if self._quarantined_at(v, i)}
        return [rs for rs in specs if rs.key not in quarantined]

    def _next_index(self) -> int:
        for i, label in enumerate(self.journal.order):
            if not self.journal.gens[label].get("closed"):
                return i
        return len(self.journal.order)

    def _readmit(self) -> None:
        """Re-admit every journaled generation on boot — heals the
        crash window between a ``gen-open`` append and the queue
        enqueue (idempotent: already-queued cells are duplicates the
        queue refuses, indexed cells count done immediately)."""
        for i, label in enumerate(self.journal.order):
            try:
                out = self.coordinator.admit(self._plan(i), gen=label)
                logger.info("autopilot %s: re-admitted %s (%s)",
                            self.name, label, out)
            except Exception:  # noqa: BLE001 — step() retries via seam
                logger.warning("autopilot %s: re-admit of %s failed",
                               self.name, label, exc_info=True)

    # -- the loop ------------------------------------------------------------

    def _seam(self, site: str, fn: Callable, *args: Any
              ) -> Tuple[bool, Any]:
        """Run one decision through its guarded fault site.  The loop
        never dies on a seam failure — callers get (False, error) and
        degrade per the quarantine policy."""
        from jepsen_tpu_torch import resilience

        try:
            return True, resilience.device_call(
                site, fn, *args, policy=self._seam_policy)
        except Exception as e:  # noqa: BLE001 — survives own chaos
            logger.warning("autopilot seam %s failed: %s", site, e)
            return False, f"{type(e).__name__}: {e}"

    def step(self) -> Dict[str, Any]:
        """Run ONE generation end to end: journal intent, admit,
        await drain (scaling while waiting), gate, journal verdicts,
        quarantine + shrink regressions.  Returns a summary doc."""
        i = self._next_index()
        label = self._label(i)
        specs = self._plan(i)
        if label not in self.journal.gens:
            # durable intent FIRST: the journal append is the commit
            # point, the enqueue below is its idempotent replay arm
            self.journal.open_gen(
                label, seeds=self._gen_spec(i).get("seeds"),
                runs=len(specs))
        while not self.stop.is_set():
            ok, _ = self._seam("autopilot.enqueue",
                               self.coordinator.admit, specs, label)
            if ok:
                break
            self.stop.wait(0.2)
        summary: Dict[str, Any] = {"gen": label, "runs": len(specs)}
        if not self._await([rs.run_id for rs in specs]):
            summary["stopped"] = True
            return summary
        ok, verdicts = self._seam("autopilot.gate", self._gate,
                                  i, label)
        if not ok:
            # the gate itself died: close the generation with an
            # attributable error verdict — rc 2 semantics, never
            # quarantine on missing evidence
            verdicts = [{"span": None, "status": "gate-error",
                         "rc": 2, "reason": verdicts,
                         "to-gen": label}]
        self.journal.close_gen(label, verdicts)
        summary["verdicts"] = verdicts
        quarantined = []
        for v in verdicts:
            if v.get("status") != "regression":
                continue
            key = v.get("key")
            cur = self.journal.quarantined.get(str(key)) \
                if key else None
            if not key or (cur is not None
                           and "paroled-gen" not in cur):
                continue  # active quarantine — nothing new to do
            self.journal.quarantine(
                str(key), gen=label, span=v.get("span"),
                rel_delta=v.get("key-rel-delta"))
            quarantined.append(str(key))
            self._update_gauges()
            ok, out = self._seam("autopilot.shrink", self._shrink,
                                 str(key), label, v)
            self.journal.shrink(
                str(key), gen=label,
                outcome=out if ok else {"error": out})
        if quarantined:
            summary["quarantined"] = quarantined
        paroled = self._parole_tick(label)
        if paroled:
            summary["paroled"] = paroled
        self._update_gauges()
        # the gate's verdicts just changed the alertable state
        # (gate-regression / rc2-streak / quarantine census): evaluate
        # now instead of waiting for the next await tick
        self._seam("alerts.evaluate", self._alert_tick)
        return summary

    def _parole_tick(self, label: str) -> List[str]:
        """Quarantine parole: once ``parole_after``
        closed generations SINCE a key's quarantine came back with no
        regression anywhere — its neighbors ran clean without it —
        the key is re-admitted starting with the next generation.  A
        paroled key that regresses again is re-quarantined (prior
        stint archived), so parole is a retrial, not an acquittal."""
        if not self.parole_after:
            return []
        clean = []
        for l in self.journal.closed_labels():
            vs = self.journal.gens[l].get("verdicts") or []
            if all(v.get("rc") != 1 for v in vs):
                clean.append(self._gen_index(l))
        out = []
        for key, v in sorted(self.journal.quarantined.items()):
            if "paroled-gen" in v:
                continue
            q = self._gen_index(v.get("gen"))
            n = sum(1 for ci in clean if ci > q)
            if n < self.parole_after:
                continue
            allowed, twin = self._witness_twin_check(key)
            if not allowed:
                logger.info(
                    "autopilot %s: parole of %s DENIED by host-twin "
                    "re-check (%s)", self.name, key, twin)
                continue
            self.journal.parole(key, gen=label, twin=twin)
            out.append(key)
            logger.info(
                "autopilot %s: paroled %s after %d clean "
                "generation(s) (quarantined at %s, twin %s)",
                self.name, key, n, v.get("gen"), twin)
        return out

    def _witness_twin_check(self, key: str) -> Tuple[bool, Any]:
        """Parole on twin-pass: a quarantined
        key whose auto-shrink produced a WITNESS may only be paroled
        if that witness's shrunken history re-checks VALID through its
        host twin — the device-independent oracle.  Twin-valid means
        the archived anomaly was a device-path false positive and the
        neighbors-ran-clean evidence stands; twin-invalid means the
        anomaly is real and clean neighbor generations prove nothing
        (denied until the witness changes).  A missing/unreadable
        witness denies conservatively; a shrink with NO witness (perf
        regressions have nothing to re-check) keeps the plain
        clean-generations criterion."""
        outcome = (self.journal.shrinks.get(key) or {}).get(
            "outcome") or {}
        digest = outcome.get("digest")
        if not digest:
            return True, None
        cached = self._twin_cache.get(digest)
        if cached is not None:
            return cached
        res = self._twin_recheck(key, str(digest))
        self._twin_cache[digest] = res
        return res

    def _twin_recheck(self, key: str, digest: str) -> Tuple[bool, Any]:
        from jepsen_tpu_torch.minimize import probe
        from jepsen_tpu_torch.minimize import witness as witness_mod

        with self.coordinator._lock:
            recs = [r for r in self.coordinator.idx.records
                    if str(r.get("key")) == key and r.get("dir")
                    and isinstance(r.get("witness"), dict)
                    and r["witness"].get("digest") == digest]
        if not recs:
            return False, {"digest": digest,
                           "error": "witness-record-missing"}
        run_dir = os.path.join(self.base, str(recs[-1]["dir"]))
        try:
            w = witness_mod.load_witness(run_dir)
            if w is None or w.get("digest") != digest:
                return False, {"digest": digest,
                               "error": "witness-artifact-missing"}
            hist = w["history"]
            chk = probe.resolve_checker(None, hist, "cpu")
            twin = probe.host_equivalent(chk) or chk
            res = twin.check({}, hist, {})
            valid = res.get("valid?") if isinstance(res, dict) else None
        except Exception as e:  # noqa: BLE001 — deny conservatively
            return False, {"digest": digest,
                           "error": f"{type(e).__name__}: {e}"}
        doc = {"digest": digest,
               "checker": str(getattr(twin, "name",
                                      type(twin).__name__)),
               "valid?": valid}
        return (valid is True), doc

    def _alert_tick(self) -> Dict[str, Any]:
        return self.alerts.evaluate(autopilot=self)

    def run(self) -> Dict[str, Any]:
        """The unattended loop: generations until ``generations`` (or
        forever), then drain the managed workers."""
        out: Dict[str, Any] = {}
        try:
            while not self.stop.is_set():
                if self.generations is not None and \
                        len(self.journal.closed_labels()) >= \
                        self.generations:
                    break
                out = self.step()
                if self.on_generation is not None:
                    try:
                        self.on_generation(self, out)
                    except Exception:  # noqa: BLE001 — hook is advisory
                        logger.warning("on_generation hook failed",
                                       exc_info=True)
                if out.get("stopped"):
                    break
        finally:
            self.drain_workers()
        return {"generations": len(self.journal.closed_labels()),
                "quarantined": sorted(self.journal.quarantined),
                "digest": self.journal.digest(), "last": out}

    def _await(self, run_ids: List[str]) -> bool:
        wanted = set(run_ids)
        while not self.stop.is_set():
            self.coordinator.queue.expire()
            with self.coordinator._lock:
                done = wanted <= self.coordinator._done_ids
            if done:
                return True
            now = time.monotonic()
            if now - self._last_scale >= self.scale_interval_s:
                self._last_scale = now
                self._seam("autopilot.scale", self._scale_tick)
                self._seam("alerts.evaluate", self._alert_tick)
            self.stop.wait(self.poll_s)
        return False

    # -- gate + quarantine + shrink ------------------------------------------

    def _prev_closed(self, label: str) -> Optional[str]:
        prev = None
        for l in self.journal.order:
            if l == label:
                break
            if self.journal.gens[l].get("closed"):
                prev = l
        return prev

    def _gate(self, i: int, label: str) -> List[Dict[str, Any]]:
        from jepsen_tpu_torch.telemetry import forensics
        from jepsen_tpu_torch.telemetry import gate as gate_mod

        prev = self._prev_closed(label)
        if prev is None:
            return [{"span": None, "status": "insufficient-data",
                     "rc": 2, "reason": "first-generation",
                     "to-gen": label}]
        with self.coordinator._lock:
            recs = list(self.coordinator.idx.records)
        known = sorted({
            n for r in recs if str(r.get("gen")) in (prev, label)
            for n, d in (r.get("spans") or {}).items()
            if isinstance(d, (int, float))})
        wanted = forensics.resolve_spans(known, list(self.spans))
        if not wanted:
            return [{"span": None, "status": "insufficient-data",
                     "rc": 2, "to-gen": label,
                     "reason": f"no spans matching {list(self.spans)} "
                               f"in {prev}..{label}"}]
        out = []
        for span in wanted:
            res = gate_mod.run_gate(
                self.base, self.name, span, from_gen=prev,
                to_gen=label, alpha=self.alpha,
                threshold=self.threshold, min_runs=self.min_runs)
            status = str(res.get("status"))
            v = {"span": span, "status": status,
                 "rc": GATE_RC.get(status, 2),
                 "from-gen": prev, "to-gen": label,
                 "reason": res.get("reason"),
                 "rel-delta": res.get("rel_delta"),
                 "p-value": res.get("p_value")}
            if status == "regression":
                att = self._attribute(span, prev, label, recs)
                if att is not None:
                    v["key"], v["key-rel-delta"] = att
            out.append(v)
        return out

    def _attribute(self, span: str, prev: str, label: str,
                   recs: List[Dict[str, Any]]
                   ) -> Optional[Tuple[str, float]]:
        """The regressing CELL: the key with the largest relative
        mean delta on the regressing span between the two
        generations."""
        by_key: Dict[str, Dict[str, List[float]]] = {}
        for r in recs:
            key, g = r.get("key"), str(r.get("gen"))
            d = (r.get("spans") or {}).get(span)
            if not key or g not in (prev, label) or \
                    not isinstance(d, (int, float)):
                continue
            by_key.setdefault(str(key), {})[g] = \
                by_key.setdefault(str(key), {}).get(g, []) + [float(d)]
        best: Optional[Tuple[str, float]] = None
        for key, groups in by_key.items():
            a, b = groups.get(prev), groups.get(label)
            if not a or not b:
                continue
            ma = sum(a) / len(a)
            if ma <= 0:
                continue
            rel = (sum(b) / len(b) - ma) / ma
            if best is None or rel > best[1]:
                best = (key, round(rel, 4))
        return best

    def _artifacts_dir(self) -> str:
        return os.path.join(self.base, "fleet",
                            store.sanitize(self.name) + ".autopilot")

    def _diff_artifact(self, label: str, key: str,
                       verdict: Dict[str, Any]) -> Optional[str]:
        """The ``obs diff`` forensics report for a quarantine, written
        next to the journal (best-effort — forensics never blocks the
        quarantine itself)."""
        from jepsen_tpu_torch.telemetry import forensics

        try:
            rep = forensics.run_diff(
                self.base, self.name,
                from_gen=verdict.get("from-gen"), to_gen=label,
                spans=[verdict["span"]] if verdict.get("span")
                else None,
                alpha=self.alpha, threshold=self.threshold,
                min_runs=self.min_runs)
            d = self._artifacts_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"{label}-{store.sanitize(str(key))}.diff.json")
            with open(path, "w") as f:
                json.dump(rep, f, indent=1, sort_keys=True,
                          default=str)
            return os.path.relpath(path, self.base)
        except Exception:  # noqa: BLE001 — forensics is best-effort
            logger.warning("autopilot %s: diff artifact for %s "
                           "failed", self.name, key, exc_info=True)
            return None

    def _shrink(self, key: str, label: str,
                verdict: Dict[str, Any]) -> Dict[str, Any]:
        """Auto-shrink the quarantined cell's latest run to an
        attributed witness, append the witness record to the campaign
        index (the same surface `run_campaign`'s auto-shrink feeds),
        and drop the ``obs diff`` forensics artifact."""
        from jepsen_tpu_torch import minimize

        art = self._diff_artifact(label, key, verdict)
        with self.coordinator._lock:
            recs = [r for r in self.coordinator.idx.records
                    if str(r.get("key")) == key and r.get("dir")]
        cand = ([r for r in recs if str(r.get("gen")) == label]
                or recs)
        if not cand:
            return {"error": "no-run-dir", "forensics": art}
        last = cand[-1]
        run_dir = os.path.join(self.base, str(last["dir"]))
        k = self.shrink_knobs
        try:
            s = minimize.shrink(
                run_dir, rounds=k.get("rounds"),
                probe_deadline_s=float(
                    k.get("probe-deadline", 30.0)),
                workers=int(k.get("workers", 2)),
                device_slots=int(k.get("device-slots", 1)),
                host_oracle=bool(k.get("host-oracle", True)))
        except Exception as e:  # noqa: BLE001 — journal the failure
            return {"run": last.get("run"), "forensics": art,
                    "error": f"{type(e).__name__}: {e}"}
        if s.get("error"):
            # e.g. "not-invalid": a perf-only regression has no
            # anomaly to shrink — the quarantine + forensics artifact
            # are the whole story
            return {"run": last.get("run"), "forensics": art,
                    "error": s["error"]}
        witness = {kk: s[kk] for kk in
                   ("ops", "source-ops", "digest", "anomaly-types",
                    "probes", "cached", "fault-windows") if kk in s}
        rec = {"run": last.get("run"), "key": key,
               "campaign": self.name,
               "workload": last.get("workload"),
               "fault": last.get("fault"), "seed": last.get("seed"),
               "gen": label, "dir": last.get("dir"),
               "valid?": last.get("valid?"), "witness": witness,
               "autopilot": {"quarantined": label,
                             "span": verdict.get("span"),
                             "forensics": art}}
        with self.coordinator._lock:
            self.coordinator.idx.append(rec)
        return {"run": last.get("run"), "forensics": art,
                "witness-ops": witness.get("ops"),
                "digest": witness.get("digest"),
                "anomaly-types": witness.get("anomaly-types")}

    # -- elasticity ----------------------------------------------------------

    def _reap(self) -> None:
        for name in list(self.workers):
            proc = self.workers[name]["proc"]
            rc = proc.poll()
            if rc is not None:
                self.journal.scale("exit", worker=name, rc=rc)
                del self.workers[name]

    def _live_workers(self) -> List[str]:
        return [n for n, w in self.workers.items()
                if w["proc"].poll() is None]

    def _worker_alive(self, name: str) -> bool:
        """Alive per the COORDINATOR's view (registered + heartbeat
        fresh) — the rolling upgrade's hand-over criterion."""
        with self.coordinator._lock:
            c = self.coordinator.workers.get(name)
            if not c:
                return False
            fresh = time.time() - c["last-seen"] <= \
                ALIVE_LEASES * self.coordinator.lease_s
            return fresh and \
                c.get("version") == self.workers.get(
                    name, {}).get("version")

    def _spawn_worker(self) -> Optional[str]:
        import subprocess
        import sys

        if not self.coordinator_url:
            return None
        self._wseq += 1
        name = f"ap-{os.getpid()}-{self._wseq}"
        env = dict(os.environ,
                   JEPSEN_WORKER_VERSION=self.worker_version)
        cmd = [sys.executable, "-m", "jepsen_tpu_torch",
               "--store-dir", self.base, "fleet", "work",
               "--coordinator", self.coordinator_url,
               "--name", name, "--poll", str(self.worker_poll_s)]
        cmd += list(self.worker_extra)
        proc = subprocess.Popen(cmd, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        self.workers[name] = {"proc": proc,
                              "version": self.worker_version,
                              "spawned": round(time.time(), 3),
                              "draining": False}
        self.journal.scale("spawn", worker=name,
                           version=self.worker_version)
        return name

    def _drain_worker(self, name: str, reason: str = "scale-down"
                      ) -> None:
        w = self.workers.get(name)
        if w is None or w["draining"]:
            return
        w["draining"] = True
        if w["proc"].poll() is None:
            w["proc"].terminate()  # SIGTERM: finish-in-flight drain
        self.journal.scale("drain", worker=name, reason=reason,
                           version=w["version"])

    def _scale_tick(self) -> Dict[str, Any]:
        """One scaler decision: size the pool to queue depth and
        claim-latency p95 (the coordinator's two federated signals),
        then advance the rolling upgrade one worker at a time."""
        self._reap()
        if self.max_workers <= 0 or not self.coordinator_url:
            self._update_gauges()
            return {"workers": 0, "managed": False}
        counts = self.coordinator.queue.counts()
        depth = counts["queued"]
        p95 = self.coordinator.queue.claim_latency_p95()
        active = [n for n in self._live_workers()
                  if not self.workers[n]["draining"]]
        want = max(self.min_workers,
                   min(self.max_workers,
                       math.ceil(depth / self.depth_per_worker)
                       if depth else self.min_workers))
        if depth and p95 is not None and p95 > self.p95_high_s:
            want = min(self.max_workers, max(want, len(active) + 1))
        if len(active) < want:
            self._spawn_worker()
        elif len(active) > want and self._upgrading is None:
            self._drain_worker(active[0])
        self._upgrade_tick()
        self._update_gauges()
        return {"workers": len(self._live_workers()), "want": want,
                "depth": depth, "p95": p95}

    def _upgrade_tick(self) -> None:
        """The rolling version upgrade: at most ONE replacement in
        flight — spawn the new-version worker, wait until the
        coordinator sees it alive at the new version, only then
        SIGTERM its predecessor (finish-in-flight: zero lost cells)."""
        if self._upgrading is not None:
            old, new = self._upgrading
            if new not in self.workers or \
                    self.workers[new]["proc"].poll() is not None:
                self._upgrading = None  # replacement died: retry later
            elif self._worker_alive(new):
                self._drain_worker(old, reason="upgrade")
                self.journal.scale("upgraded", worker=old,
                                   replacement=new,
                                   version=self.worker_version)
                self._upgrading = None
            return
        for name in self._live_workers():
            w = self.workers[name]
            if w["draining"] or w["version"] == self.worker_version:
                continue
            new = self._spawn_worker()  # transient max+1 by design
            if new:
                self._upgrading = (name, new)
            return

    def drain_workers(self, timeout_s: float = 30.0) -> None:
        """SIGTERM every managed worker and wait for the drain;
        stragglers past the timeout are killed."""
        for name in list(self.workers):
            self._drain_worker(name, reason="shutdown")
        deadline = time.time() + timeout_s
        for name, w in list(self.workers.items()):
            left = max(0.1, deadline - time.time())
            try:
                w["proc"].wait(timeout=left)
            except Exception:  # noqa: BLE001 — straggler
                w["proc"].kill()
        self._reap()

    def close(self) -> None:
        self.stop.set()
        self.drain_workers()
        self.coordinator.close()

    # -- surfaces ------------------------------------------------------------

    def _update_gauges(self) -> None:
        try:
            from jepsen_tpu_torch import telemetry

            reg = telemetry.registry()
            active = [k for k, v in
                      self.journal.quarantined.items()
                      if "paroled-gen" not in v]
            reg.gauge("fleet-quarantined-cells").set(len(active))
            reg.gauge("fleet-paroled-cells").set(
                len(self.journal.quarantined) - len(active))
            reg.gauge("fleet-autopilot-generations").set(
                len(self.journal.closed_labels()))
        except Exception:  # noqa: BLE001 — observability only
            logger.debug("autopilot gauges failed", exc_info=True)

    def status_doc(self) -> Dict[str, Any]:
        """The /fleet panel + ``cli fleet status`` document."""
        closed = self.journal.closed_labels()
        last = (self.journal.gens[closed[-1]].get("verdicts")
                if closed else None)
        workers = {}
        for name, w in self.workers.items():
            workers[name] = {"version": w["version"],
                             "pid": w["proc"].pid,
                             "running": w["proc"].poll() is None,
                             "draining": w["draining"]}
        return {
            "campaign": self.name,
            "generation": (self.journal.order[-1]
                           if self.journal.order else None),
            "generations-closed": len(closed),
            "worker-version": self.worker_version,
            "quarantined": {k: dict(v) for k, v in
                            self.journal.quarantined.items()},
            "shrinks": {k: dict(v) for k, v in
                        self.journal.shrinks.items()},
            "last-verdicts": last or [],
            "workers": workers,
            "journal-digest": self.journal.digest(),
            "alerts": self.alerts.status_doc(),
        }
