"""Delta debugging over histories — the reduction engine (the port's
copy of `jepsen_tpu/minimize/reduce.py`; host-only).

Classic ddmin (Zeller & Hildebrandt, "Simplifying and Isolating
Failure-Inducing Input", TSE '02) specialized for Jepsen histories.
The unit of reduction is never a single op: dropping an ``ok`` without
its ``invoke`` would leave an orphaned completion, so the engine works
over :class:`Unit`\\s — invoke/completion *pairs* (plus lone infos /
unpaired tails as single-op units) — and every candidate sub-history is
re-closed by construction (`build_history` keeps original op order and
reindexes densely).

Reduction runs in three structure-aware phases, cheapest first, exactly
because a history has exploitable structure a flat byte-ddmin lacks:

1. **processes** — drop every op of one process at a time (a whole
   worker's timeline is the coarsest irrelevant chunk);
2. **keys** — project keys away from transactional mop lists
   (`elle`-style independence: an anomaly on keys {x, y} survives the
   removal of every other key's mops);
3. **ops** — classic ddmin over the remaining units (subsets, then
   complements, doubling granularity), which ends 1-minimal: no single
   remaining unit can be removed.

Every phase asks the same question — "does this candidate still
reproduce the anomaly?" — through a caller-supplied *batch* probe
callback ``probe_batch(list[list[Unit]]) -> list[bool]``, so all
candidates of one round fan out in parallel (the campaign scheduler is
the execution engine, see :mod:`~.probe`) while the *choice* among
failing candidates stays canonical-order deterministic: same history +
same probe verdicts → same witness, regardless of probe completion
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from jepsen_tpu_torch.history.ops import History, Op

__all__ = ["Unit", "units_of", "build_history", "unit_keys",
           "drop_key", "Reducer", "is_nemesis_unit", "unit_window",
           "fault_windows", "window_descriptors"]

#: the interpreter's nemesis thread id — fault ops carry it as their
#: process (generator/context.NEMESIS_THREAD)
NEMESIS_PROCESS = "nemesis"

#: mop kinds whose middle element is a key (list-append + rw-register
#: transactional values: ["append" k v] / ["w" k v] / ["r" k v-or-nil])
_TXN_MOP_KINDS = ("append", "w", "r")

ProbeBatch = Callable[[str, List[List["Unit"]]], List[bool]]


@dataclass
class Unit:
    """One irreducible chunk of history: an invoke/completion pair, or
    a single unpaired op.  `ops` holds the original Op objects in
    original order; `order` is the first op's original index (the sort
    key that keeps rebuilt histories in real-time order)."""

    ops: Tuple[Op, ...]
    order: int

    @property
    def process(self) -> Any:
        return self.ops[0].process

    def __len__(self) -> int:
        return len(self.ops)


def units_of(history: History) -> List[Unit]:
    """Group a history into closure-safe units via the pair index."""
    paired: Dict[int, int] = {}
    for op in history:
        j = history.pair_index(op.index) if 0 <= op.index < len(history) \
            else -1
        if j >= 0:
            paired[op.index] = j
    units: List[Unit] = []
    seen = set()
    for op in history:
        if op.index in seen:
            continue
        j = paired.get(op.index, -1)
        if j >= 0 and j > op.index:
            seen.add(op.index)
            seen.add(j)
            units.append(Unit(ops=(op, history.get_index(j)),
                              order=op.index))
        elif j < 0:
            seen.add(op.index)
            units.append(Unit(ops=(op,), order=op.index))
    units.sort(key=lambda u: u.order)
    return units


def build_history(units: Sequence[Unit]) -> History:
    """Re-close a candidate: flatten units, restore original op order,
    reindex densely.  Ops are copied so reduction never mutates the
    source history."""
    ops = [op for u in units for op in u.ops]
    ops.sort(key=lambda op: op.index)
    return History([op.with_() for op in ops], reindex=True)


# -- key projection ---------------------------------------------------------

def unit_keys(u: Unit) -> set:
    """Keys touched by a unit's transactional mops (empty for non-txn
    ops — those are untouched by the key phase)."""
    out: set = set()
    for op in u.ops:
        if op.f == "txn" and isinstance(op.value, (list, tuple)):
            for m in op.value:
                if (isinstance(m, (list, tuple)) and len(m) >= 2
                        and m[0] in _TXN_MOP_KINDS):
                    out.add(m[1])
    return out


def drop_key(units: Sequence[Unit], key: Any) -> List[Unit]:
    """Project one key away: filter its mops out of every txn value
    (invoke and completion alike); units whose txns become empty are
    dropped entirely.  Non-txn units pass through untouched."""
    out: List[Unit] = []
    for u in units:
        if key not in unit_keys(u):
            out.append(u)
            continue
        new_ops = []
        empty = False
        for op in u.ops:
            if op.f == "txn" and isinstance(op.value, (list, tuple)):
                mops = [list(m) for m in op.value
                        if not (isinstance(m, (list, tuple)) and
                                len(m) >= 2 and m[0] in _TXN_MOP_KINDS
                                and m[1] == key)]
                if not mops and op.type != "info":
                    empty = True
                new_ops.append(op.with_(value=mops))
            else:
                new_ops.append(op)
        if not empty:
            out.append(Unit(ops=tuple(new_ops), order=u.order))
    return out


# -- fault windows ----------------------------------------------------------

def is_nemesis_unit(u: Unit) -> bool:
    return u.process == NEMESIS_PROCESS


def unit_window(u: Unit) -> Optional[dict]:
    """The window identity a scheduled nemesis op carries (`Op.ext`
    ``"window"``: pos/digest/fault/host, stamped by
    `nemesis.combined.schedule_package`), or None for unscheduled
    fault ops.  This is the **host dimension** of the cross-host
    fault-window ddmin: ops from different hosts' windows never share
    an identity, so each host's window is its own drop candidate and
    the minimal witness records *whose* window mattered."""
    for op in u.ops:
        w = (op.ext or {}).get("window")
        if isinstance(w, dict) and w.get("digest") is not None:
            return w
    return None


_STOP_PREFIXES = ("stop", "heal", "resume", "fast", "reset")


def _win_suffix(f: str) -> str:
    """The fault family a start/stop f belongs to: 'start-skew' and
    'stop-skew' share suffix 'skew', so interleaved windows from
    composed packages pair up correctly."""
    for pre in ("start-", "stop-", "heal-", "resume-", "reset-"):
        if f.startswith(pre):
            return f[len(pre):]
    return f


def fault_windows(nem_units: Sequence[Unit]) -> List[List[int]]:
    """Group nemesis units into fault *windows* (indices into
    `nem_units`, deterministic order).

    Scheduled ops group EXACTLY: units stamped with a window identity
    (`unit_window`) belong to the window keyed by (host, digest) — the
    host dimension — so a merged multi-host history keeps each host's
    instance of the same schedule position as a separate droppable
    window.  Unstamped ops fall back to the suffix-aware heuristic
    mirroring `perf.nemesis_intervals`: a start-like f opens a window;
    a stop/heal-like f closes the open window of the SAME fault family
    (suffix after the start-/stop- prefix), falling back to the most
    recent open window — so composed packages' interleaved windows
    (start-skew, start-partition, stop-skew, stop-partition) pair
    correctly.  One-shot faults (``leave-node``, ``bump-clock``, ...)
    join the most recent open window, or stand alone outside any.
    Output order is by first unit index — canonical at any worker
    count."""
    stamped: Dict[tuple, List[int]] = {}
    plain: List[int] = []
    for i, u in enumerate(nem_units):
        w = unit_window(u)
        if w is not None:
            key = (str(w.get("host") or ""), str(w["digest"]))
            stamped.setdefault(key, []).append(i)
        else:
            plain.append(i)
    wins = [sorted(v) for v in stamped.values()]
    sub = [nem_units[i] for i in plain]
    wins.extend([plain[j] for j in w] for w in _heuristic_windows(sub))
    wins.sort(key=lambda w: w[0])
    return wins


def _heuristic_windows(nem_units: Sequence[Unit]) -> List[List[int]]:
    """The start/stop pairing heuristic over unstamped nemesis units
    (indices into `nem_units`)."""
    wins: List[List[int]] = []
    open_wins: List[tuple] = []  # (suffix, window) in open order
    for i, u in enumerate(nem_units):
        f = str(u.ops[0].f or "")
        is_stop = f.startswith(_STOP_PREFIXES)
        if is_stop:
            sfx = _win_suffix(f)
            hit = next((j for j in range(len(open_wins) - 1, -1, -1)
                        if open_wins[j][0] == sfx),
                       len(open_wins) - 1 if open_wins else None)
            if hit is None:
                wins.append([i])  # orphan heal: its own window
            else:
                _, w = open_wins.pop(hit)
                w.append(i)
                wins.append(w)
        elif f.startswith("start"):
            open_wins.append((_win_suffix(f), [i]))
        elif open_wins:
            open_wins[-1][1].append(i)
        else:
            wins.append([i])  # one-shot fault
    wins.extend(w for _, w in open_wins)  # still open at history end
    return wins


def window_descriptors(nem_units: Sequence[Unit],
                       wins: Sequence[List[int]],
                       kept: Optional[Sequence[str]] = None
                       ) -> List[dict]:
    """The witness-meta shape for a window set: per window, its
    opening f, the original op indices it spans, and the index span;
    scheduled windows add their identity (``pos``/``digest``/``fault``
    from the schedule — host-free, so distributed and single-process
    runs of one spec agree — plus ``host``, the executing host, as
    attribution).  `kept` labels why each window survived reduction
    (``necessary`` / ``overlap`` / ``interaction``)."""
    out = []
    for j, w in enumerate(wins):
        ops = [op.index for i in w for op in nem_units[i].ops]
        d = {
            "f": str(nem_units[w[0]].ops[0].f),
            "ops": sorted(ops),
            "span": [min(ops), max(ops)],
        }
        ident = unit_window(nem_units[w[0]])
        if ident is not None:
            d.update(pos=ident.get("pos"), digest=ident.get("digest"),
                     fault=ident.get("fault"),
                     host=ident.get("host") or None)
        if kept is not None:
            d["kept"] = kept[j]
        out.append(d)
    return out


def _merge(client: Sequence[Unit], nem: Sequence[Unit]) -> List[Unit]:
    return sorted([*client, *nem], key=lambda u: u.order)


# -- the reducer ------------------------------------------------------------

@dataclass
class RoundStats:
    phase: str
    candidates: int
    ops_remaining: int
    improved: bool


@dataclass
class Reducer:
    """Drives the three phases against a batch probe.

    `probe_batch` maps candidate unit lists to "still fails?" booleans;
    `max_rounds` bounds the TOTAL number of probe rounds across phases
    (None = run to 1-minimality); `on_round(RoundStats)` observes
    progress (the telemetry hook)."""

    probe_batch: ProbeBatch
    max_rounds: Optional[int] = None
    on_round: Optional[Callable[[RoundStats], None]] = None
    rounds: int = 0
    probes: int = 0
    history: List[RoundStats] = field(default_factory=list)

    def _budget_left(self) -> bool:
        return self.max_rounds is None or self.rounds < self.max_rounds

    def _probe(self, phase: str, candidates: List[List[Unit]]
               ) -> List[bool]:
        self.rounds += 1
        self.probes += len(candidates)
        # client-phase candidates carry the CURRENT fault schedule
        # along, so fault-sensitive checkers see the same windows in
        # every probe; the fault-windows phase builds its own merges
        nem = getattr(self, "_nemesis", None)
        if nem and phase != "fault-windows":
            candidates = [_merge(c, nem) for c in candidates]
        return self.probe_batch(phase, candidates)

    def _note(self, phase: str, n_cand: int, units: Sequence[Unit],
              improved: bool) -> None:
        st = RoundStats(phase=phase, candidates=n_cand,
                        ops_remaining=sum(len(u) for u in units),
                        improved=improved)
        self.history.append(st)
        if self.on_round is not None:
            self.on_round(st)

    # -- phase 1: processes -------------------------------------------------

    def drop_processes(self, units: List[Unit]) -> List[Unit]:
        """Greedy complement search over processes: each round probes
        "units minus process p" for every remaining process in
        parallel, then keeps the smallest failing complement (ties →
        canonical process order).  Repeats until no process can go."""
        while self._budget_left():
            procs = sorted({u.process for u in units}, key=repr)
            if len(procs) <= 1:
                return units
            cands = [[u for u in units if u.process != p] for p in procs]
            keep = [(p, c) for (p, c) in zip(procs, cands) if c]
            if not keep:
                return units
            res = self._probe("processes", [c for _, c in keep])
            failing = [(len(c), i, c) for i, ((_, c), ok) in
                       enumerate(zip(keep, res)) if ok]
            if not failing:
                self._note("processes", len(keep), units, False)
                return units
            failing.sort()
            units = failing[0][2]
            self._note("processes", len(keep), units, True)
        return units

    # -- phase 2: keys ------------------------------------------------------

    def project_keys(self, units: List[Unit]) -> List[Unit]:
        """Greedy key projection: probe "units with key k projected
        away" for every key in parallel; keep the smallest failing
        projection; repeat."""
        while self._budget_left():
            keys = sorted({k for u in units for k in unit_keys(u)},
                          key=repr)
            if len(keys) <= 1:
                return units
            cands = [(k, drop_key(units, k)) for k in keys]
            keep = [(k, c) for (k, c) in cands if c and c != list(units)]
            if not keep:
                return units
            res = self._probe("keys", [c for _, c in keep])
            failing = [(sum(len(u) for u in c), i, c)
                       for i, ((_, c), ok) in enumerate(zip(keep, res))
                       if ok]
            if not failing:
                self._note("keys", len(keep), units, False)
                return units
            failing.sort(key=lambda t: (t[0], t[1]))
            units = failing[0][2]
            self._note("keys", len(keep), units, True)
        return units

    # -- phase 3: ddmin over op units ---------------------------------------

    def ddmin(self, units: List[Unit]) -> List[Unit]:
        """Classic ddmin: probe the n chunks, then the n complements,
        all in one parallel batch per round; reduce to the FIRST
        failing subset in canonical order; double granularity when
        nothing fails.  Terminates 1-minimal (granularity == length and
        no single-unit removal reproduces)."""
        n = 2
        while len(units) >= 2 and self._budget_left():
            n = min(n, len(units))
            chunks = _split(units, n)
            cands: List[List[Unit]] = list(chunks)
            kinds = [("subset", i) for i in range(len(chunks))]
            if n > 2:
                for i in range(len(chunks)):
                    cands.append([u for j, c in enumerate(chunks)
                                  if j != i for u in c])
                    kinds.append(("complement", i))
            res = self._probe("ops", cands)
            hit = next((k for k, (kind, ok) in
                        enumerate(zip(kinds, res)) if ok), None)
            if hit is not None:
                kind, _ = kinds[hit]
                units = cands[hit]
                n = 2 if kind == "subset" else max(n - 1, 2)
                self._note("ops", len(cands), units, True)
                continue
            self._note("ops", len(cands), units, False)
            if n >= len(units):
                break
            n = min(len(units), 2 * n)
        return units

    # -- phase 4: fault windows ---------------------------------------------

    def reduce_fault_windows(self, client: List[Unit]) -> List[Unit]:
        """Shrink the nemesis schedule alongside the ops: one parallel
        probe round asks, per fault window, whether dropping it still
        reproduces; a window survives only if it is reproduction-
        necessary (fault-sensitive checkers) or it OVERLAPS the minimal
        client ops — the fault the anomaly actually lives inside stays
        as attribution, every other window goes.  A final combined
        probe guards against window-interaction effects (failure keeps
        the whole schedule — conservative, never unsound).  Selection
        is canonical-order deterministic: same history + verdicts →
        same surviving window set at any worker count."""
        nem = list(getattr(self, "_nemesis", ()) or ())
        self.windows_meta: List[dict] = []
        if not nem:
            return client
        wins = fault_windows(nem)
        droppable = [False] * len(wins)
        if self._budget_left():
            cands = []
            for w in wins:
                drop = set(w)
                cands.append(_merge(client,
                                    [u for i, u in enumerate(nem)
                                     if i not in drop]))
            droppable = self._probe("fault-windows", cands)
        lo = min((u.order for u in client), default=0)
        hi = max((max(op.index for op in u.ops) for u in client),
                 default=0)
        verdicts = []  # (window, drop_ok, overlaps)
        for w, drop_ok in zip(wins, droppable):
            ops = [op.index for i in w for op in nem[i].ops]
            verdicts.append((w, drop_ok,
                             min(ops) <= hi and max(ops) >= lo))
        keep: List[List[int]] = []
        reasons: List[str] = []
        for w, drop_ok, overlaps in verdicts:
            if not drop_ok:
                keep.append(w)
                reasons.append("necessary")
            elif overlaps:
                keep.append(w)
                reasons.append("overlap")
        kept = [nem[i] for w in keep for i in w]
        improved = len(kept) < len(nem)
        if improved:
            # the combined interaction guard is mandatory: two windows
            # individually droppable may not be JOINTLY droppable, so
            # an exhausted budget keeps the whole schedule rather than
            # shipping an unconfirmed multi-window drop
            if self._budget_left() and \
                    self._probe("fault-windows",
                                [_merge(client, kept)])[0]:
                pass
            else:
                kept, keep, improved = nem, wins, False
                reasons = ["necessary" if not ok else
                           ("overlap" if ov else "interaction")
                           for _, ok, ov in verdicts]
        self._note("fault-windows", len(wins), _merge(client, kept),
                   improved)
        self._nemesis = kept
        self.windows_meta = window_descriptors(nem, keep, reasons)
        return _merge(client, kept)

    def run(self, units: List[Unit]) -> List[Unit]:
        client = [u for u in units if not is_nemesis_unit(u)]
        self._nemesis: List[Unit] = [u for u in units
                                     if is_nemesis_unit(u)]
        client = self.drop_processes(client)
        client = self.project_keys(client)
        client = self.ddmin(client)
        return self.reduce_fault_windows(client)


def _split(xs: List[Unit], n: int) -> List[List[Unit]]:
    """n near-equal contiguous chunks (ddmin's partition)."""
    k, m = divmod(len(xs), n)
    out, i = [], 0
    for j in range(n):
        size = k + (1 if j < m else 0)
        if size:
            out.append(xs[i:i + size])
        i += size
    return out
