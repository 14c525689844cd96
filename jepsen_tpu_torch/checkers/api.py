"""Checker protocol + built-in checkers (the port of
`jepsen_tpu/checkers/api.py`).

Equivalent of the reference's `jepsen/checker.clj` (SURVEY.md §2.1): the
`Checker` protocol — `check(test, history, opts) -> {"valid?": ...}` — plus
`check_safe` (exception -> invalid), `compose` (map of named checkers), and
the built-in history checkers (stats, set, counter, unique-ids, queues,
unhandled exceptions, log-file-pattern).

Valid? values follow the reference: True, False, or "unknown" (e.g. an empty
history).  `compose` is valid iff every sub-checker is, unknown if any is
unknown and none is false.

`Linearizable` and `QueueChecker` run `knossos.analysis`, whose device leg
runs on the CUDA card unless they are given ``device="cpu"``.
`output_path` resolves a checker's artifact file in the store (the perf,
timeline and clock checkers write there).
"""

from __future__ import annotations

import re
import time
import traceback
from collections import Counter as _Counter
from typing import Any, Callable, Dict, Iterable, Optional

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.backend import DeviceLike
from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, History, Op
from jepsen_tpu_torch.resilience import DEADLINE_ERROR, Deadline, DeadlineExceeded


class Checker:
    """Base checker protocol.  Subclasses implement `check`."""

    def check(self, test: dict, history: History, opts: Optional[dict] = None
              ) -> Dict[str, Any]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class FnChecker(Checker):
    def __init__(self, fn: Callable, nm: str = "fn"):
        self.fn = fn
        self._name = nm

    def check(self, test, history, opts=None):
        return self.fn(test, history, opts or {})

    def name(self):
        return self._name


def checker(fn: Callable, name: str = "fn") -> Checker:
    return FnChecker(fn, name)


def check_safe(chk: Checker, test: dict, history: History,
               opts: Optional[dict] = None) -> Dict[str, Any]:
    """Run a checker, converting exceptions into an "unknown" result
    (reference: `jepsen.checker/check-safe`).  The failing checker's
    `name()` rides along in the error result so composed-checker
    failures stay attributable in stored results, and the error is the
    traceback, which names the exception.

    Deadlines: ``opts["time-limit"]`` (seconds) or the test map's
    ``"checker-time-limit"`` bound the check — a cooperative
    :class:`Deadline` is placed in ``opts["deadline"]`` for checkers
    that poll it (the elle and knossos pipelines do), and any
    :class:`DeadlineExceeded` escaping a checker becomes
    ``{"valid?": "unknown", "error": "deadline-exceeded"}`` rather
    than a crash dump.  Composed checkers share ONE deadline: the
    outermost `check_safe` creates it, the nested calls find it
    already present in opts.  Telemetric runs get one ``check:<name>``
    span per (composed) checker, carrying the history length, verdict,
    and throughput."""
    try:
        name = chk.name()
    except Exception:  # noqa: BLE001 — a broken name() must not mask check()
        name = type(chk).__name__
    dl = Deadline.resolve(opts, test)
    if dl is not None:
        opts = dict(opts or {}, deadline=dl)

    def deadline_res() -> Dict[str, Any]:
        telemetry.registry().counter("checker-deadline-exceeded",
                                     checker=name).inc()
        return {"valid?": "unknown", "checker": name,
                "error": DEADLINE_ERROR}

    tel = telemetry.active()
    if not tel.enabled:
        try:
            return chk.check(test, history, opts)
        except DeadlineExceeded:
            return deadline_res()
        except Exception:
            return {"valid?": "unknown", "checker": name,
                    "error": traceback.format_exc()}
    with tel.span(f"check:{name}", checker=name) as sp:
        try:
            n = len(history)
        except TypeError:
            n = None
        t0 = time.perf_counter()
        try:
            res = chk.check(test, history, opts)
        except DeadlineExceeded:
            sp.set_attr(ops=n, valid="unknown", error=DEADLINE_ERROR)
            return deadline_res()
        except Exception:
            sp.set_attr(ops=n, valid="unknown", crashed=True)
            return {"valid?": "unknown", "checker": name,
                    "error": traceback.format_exc()}
        dt = time.perf_counter() - t0
        sp.set_attr(ops=n, valid=res.get("valid?")
                    if isinstance(res, dict) else None)
        if n and dt > 0:
            telemetry.registry().gauge(
                "checker-ops-per-s", checker=name).set(round(n / dt, 1))
        return res


def _merge_valid(vs: Iterable[Any]) -> Any:
    vs = list(vs)
    if any(v is False for v in vs):
        return False
    if any(v == "unknown" for v in vs):
        return "unknown"
    return True


class Compose(Checker):
    """A map of named checkers run over the same history.

    The history is wrapped in ONE :class:`~jepsen_tpu_torch.history.ir.
    HistoryIR` (a History subclass sharing the same op list), so every
    IR-aware sub-checker reuses the same packed columns, pad and
    linearizability entry table instead of re-deriving per family."""

    def __init__(self, checkers: Dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts=None):
        if isinstance(history, History):
            from jepsen_tpu_torch.history.ir import HistoryIR

            history = HistoryIR.of(history)
        results = {name: check_safe(c, test, history, opts)
                   for name, c in self.checkers.items()}
        return {"valid?": _merge_valid(r.get("valid?") for r in results.values()),
                **results}


def compose(checkers: Dict[str, Checker]) -> Checker:
    return Compose(checkers)


def output_path(test: dict, opts: Optional[dict], filename: str) -> str:
    """Resolve (and create) the artifact path for a checker's output file
    in the store dir, honoring opts["subdirectory"] (reference checkers'
    :subdirectory opt).  Shared by perf/timeline/clock."""
    import os

    from .. import store

    d = store.test_dir(test)
    sub = (opts or {}).get("subdirectory")
    if sub:
        d = os.path.join(d, str(sub))
        os.makedirs(d, exist_ok=True)
    return os.path.join(d, filename)


class NoopChecker(Checker):
    def check(self, test, history, opts=None):
        return {"valid?": True}


noop = NoopChecker


class Stats(Checker):
    """Op counts by :f and overall ok/fail/info rates (reference `stats`).

    Valid iff every :f has at least one ok (unknown on empty).  Large
    histories take the columnar fold path (numpy group counts over column
    chunks, chunk-parallel) instead of per-op Python — the vectorized
    built-in fold the reference gets from fold.clj fusion."""

    COLUMNAR_MIN = 65536

    def check(self, test, history, opts=None):
        try:
            n = len(history)
        except TypeError:
            n = 0
        if n >= self.COLUMNAR_MIN:
            by_f, total = self._columnar_counts(history)
        else:
            by_f, total = self._loop_counts(history)
        if not total:
            return {"valid?": "unknown", "count": 0}
        valid = all(c[OK] > 0 for c in by_f.values())
        return {
            "valid?": valid,
            "count": sum(total.values()),
            "ok-count": total[OK],
            "fail-count": total[FAIL],
            "info-count": total[INFO],
            "by-f": {f: {"count": sum(c.values()), "ok-count": c[OK],
                         "fail-count": c[FAIL], "info-count": c[INFO]}
                     for f, c in by_f.items()},
        }

    @staticmethod
    def _loop_counts(history):
        by_f: Dict[Any, _Counter] = {}
        total = _Counter()
        for op in history:
            if op.type == INVOKE or not op.is_client_op():
                continue
            total[op.type] += 1
            by_f.setdefault(op.f, _Counter())[op.type] += 1
        return by_f, total

    @staticmethod
    def _columnar_counts(history):
        import numpy as np

        from ..history.fold import Folder, fold_spec

        def col(cols):
            m = cols["client?"] & (cols["type"] != INVOKE)
            fs = cols["f"][m]
            ts = cols["type"][m]
            pairs: Dict[Any, _Counter] = {}
            # group by f via sort-unique, then bincount types inside
            for fv in set(fs.tolist()):
                sel = fs == fv
                vals, counts = np.unique(ts[sel], return_counts=True)
                c = _Counter({str(t): int(n) for t, n in
                              zip(vals, counts)})
                pairs[fv] = c
            return pairs

        def comb(a, b):
            for k, c in b.items():
                if k in a:
                    a[k].update(c)
                else:
                    a[k] = c
            return a

        f = fold_spec(name="stats", reducer_identity=dict,
                      reducer=lambda acc, op: acc,  # unused on column path
                      combiner_identity=dict, combiner=comb, columnar=col)
        with Folder(history, columnar=True) as folder:
            by_f = folder.fold(f)
        total = _Counter()
        for c in by_f.values():
            total.update(c)
        return by_f, total


class UnhandledExceptions(Checker):
    """Collects ops with :error / exception classes (reference
    `unhandled-exceptions`).  Always valid; informational."""

    def check(self, test, history, opts=None):
        by_err: Dict[str, int] = {}
        for op in history:
            if op.type in (INFO, FAIL) and op.error is not None:
                key = str(op.error)
                by_err[key] = by_err.get(key, 0) + 1
        return {"valid?": True, "exceptions": by_err}


class UniqueIds(Checker):
    """Checks that all ok op values are distinct (reference `unique-ids`)."""

    def check(self, test, history, opts=None):
        seen: Dict[Any, int] = {}
        dups: Dict[Any, int] = {}
        attempted = 0
        for op in history:
            if op.type == OK and op.is_client_op():
                attempted += 1
                v = op.value
                try:
                    hash(v)
                except TypeError:
                    v = repr(v)
                seen[v] = seen.get(v, 0) + 1
                if seen[v] > 1:
                    dups[v] = seen[v]
        if attempted == 0:
            return {"valid?": "unknown", "attempted-count": 0}
        return {"valid?": not dups,
                "attempted-count": attempted,
                "acknowledged-count": len(seen),
                "duplicated-count": len(dups),
                "duplicated": dict(list(dups.items())[:32])}


class SetChecker(Checker):
    """Add-then-read set (reference `set`): elements added via :add ops, one
    final :read op; lost = acknowledged adds missing from the read."""

    def check(self, test, history, opts=None):
        attempts, adds = set(), set()
        final_read = None
        for op in history:
            if not op.is_client_op():
                continue
            if op.f == "add":
                if op.type == INVOKE:
                    attempts.add(op.value)
                elif op.type == OK:
                    adds.add(op.value)
            elif op.f == "read" and op.type == OK:
                final_read = set(op.value or [])
        if final_read is None:
            return {"valid?": "unknown", "error": "no read found"}
        lost = adds - final_read
        unexpected = final_read - attempts
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(final_read & adds),
            "lost-count": len(lost),
            "lost": sorted(lost)[:32],
            "unexpected-count": len(unexpected),
            "unexpected": sorted(unexpected)[:32],
            "recovered-count": len(final_read - adds & attempts),
        }


class SetFullChecker(Checker):
    """Reference `set-full`: every add should eventually be readable; computes
    stale-read windows.  For each acknowledged add, finds reads invoked after
    the add completed that omit the element (stale reads), and whether the
    element was ever lost (absent from all subsequent reads after appearing).
    """

    def check(self, test, history, opts=None):
        # collect reads (invoke time, completion value) and adds
        adds = {}  # value -> completion index of ok add
        add_invokes = {}
        reads = []  # (invoke_idx, ok_idx, set(value))
        for op in history:
            if not op.is_client_op():
                continue
            if op.f == "add":
                if op.type == INVOKE:
                    add_invokes[op.value] = op.index
                elif op.type == OK:
                    adds[op.value] = op.index
            elif op.f == "read" and op.type == OK:
                inv = history.invocation(op)
                reads.append((inv.index if inv else op.index, op.index,
                              set(op.value or [])))
        if not reads:
            return {"valid?": "unknown", "error": "no reads"}
        reads.sort()
        lost = []
        stale = []
        for v, ok_idx in adds.items():
            later = [r for r in reads if r[0] > ok_idx]
            if not later:
                continue
            missing = [r for r in later if v not in r[2]]
            if missing and all(v not in r[2] for r in later):
                lost.append(v)
            elif missing:
                stale.append(v)
        return {"valid?": not lost,
                "lost": sorted(lost)[:32], "lost-count": len(lost),
                "stale-count": len(stale), "stale": sorted(stale)[:32],
                "read-count": len(reads), "add-count": len(adds)}


class CounterChecker(Checker):
    """Reference `counter`: :add ops with deltas, :read ops; each read must
    lie within [sum of definite adds, sum of possible adds] at that point."""

    def check(self, test, history, opts=None):
        lower = 0          # definite adds completed
        pending: Dict[int, int] = {}  # invoke index -> delta in flight
        errs = []
        reads = 0
        for op in history:
            if not op.is_client_op():
                continue
            if op.f == "add":
                if op.type == INVOKE:
                    pending[op.index] = op.value
                elif op.type == OK:
                    j = history.pair_index(op.index)
                    pending.pop(j, None)
                    lower += op.value
                elif op.type == FAIL:
                    pending.pop(history.pair_index(op.index), None)
                # info: stays possibly-applied forever
            elif op.f == "read" and op.type == OK:
                reads += 1
                hi = lower + sum(d for d in pending.values() if d > 0)
                lo = lower + sum(d for d in pending.values() if d < 0)
                if not (lo <= op.value <= hi):
                    errs.append({"op": op.index, "value": op.value,
                                 "expected": [lo, hi]})
        if reads == 0:
            return {"valid?": "unknown", "error": "no reads"}
        return {"valid?": not errs, "reads": reads,
                "errors": errs[:32], "error-count": len(errs)}


class TotalQueueChecker(Checker):
    """Reference `total-queue`: every successful enqueue should be dequeued
    exactly once; dequeues must have been enqueued (possibly by an :info)."""

    def check(self, test, history, opts=None):
        enq_attempt, enq_ok, enq_maybe, deq = (
            _Counter(), _Counter(), _Counter(), _Counter())
        for op in history:
            if not op.is_client_op():
                continue
            if op.f == "enqueue":
                if op.type == INVOKE:
                    enq_attempt[op.value] += 1
                elif op.type == OK:
                    enq_ok[op.value] += 1
                elif op.type == INFO:
                    enq_maybe[op.value] += 1  # possibly enqueued, not required
            elif op.f == "dequeue" and op.type == OK:
                deq[op.value] += 1
        # lost: definitely enqueued more times than ever dequeued
        lost = {v: c - deq[v] for v, c in enq_ok.items() if deq[v] < c}
        # unexpected: dequeued more times than it could possibly be enqueued
        unexpected = {v: c - (enq_ok[v] + enq_maybe[v]) for v, c in deq.items()
                      if c > enq_ok[v] + enq_maybe[v]}
        if not enq_attempt and not deq:
            return {"valid?": "unknown"}
        return {"valid?": not lost and not unexpected,
                "lost": dict(list(lost.items())[:32]), "lost-count": len(lost),
                "unexpected": dict(list(unexpected.items())[:32]),
                "unexpected-count": len(unexpected),
                "enqueue-count": sum(enq_attempt.values()),
                "dequeue-count": sum(deq.values())}


class QueueChecker(Checker):
    """Reference `queue`: dequeues must be consistent with *some*
    linearization of a FIFO queue — delegated to the Knossos-equivalent
    search over the fifo-queue model.  `device` is where the search's
    device leg runs (the CUDA card unless it names another)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.checkers.knossos import analysis
        from jepsen_tpu_torch.models import unordered_queue

        # Concurrent dequeues make strict FIFO order unobservable; the
        # reference's queue checker likewise accepts any order but requires
        # dequeues to return enqueued-and-undelivered items.
        return analysis(history, unordered_queue(),
                        deadline=(opts or {}).get("deadline"),
                        device=self.device)


class LogFilePattern(Checker):
    """Reference `log-file-pattern`: greps downloaded node logs for a
    pattern; invalid if found."""

    def __init__(self, pattern: str, filename: str):
        self.pattern = pattern
        self.filename = filename

    def check(self, test, history, opts=None):
        import glob
        import os
        dirpath = (test or {}).get("store-dir")
        matches = []
        if dirpath:
            for path in glob.glob(os.path.join(dirpath, "*", self.filename)):
                node = os.path.basename(os.path.dirname(path))
                try:
                    with open(path, "r", errors="replace") as f:
                        for line in f:
                            if re.search(self.pattern, line):
                                matches.append({"node": node,
                                                "line": line.strip()[:200]})
                except OSError:
                    pass
        return {"valid?": not matches, "count": len(matches),
                "matches": matches[:32]}


class Linearizable(Checker):
    """Linearizability via the Knossos-equivalent competition search
    (reference `checker/linearizable` -> knossos, SURVEY.md §2.1/§2.4).
    `device` is where the search's device leg runs (the CUDA card unless
    it names another)."""

    def __init__(self, model=None, algorithm: str = "auto",
                 device: DeviceLike = None):
        self.model = model
        self.algorithm = algorithm
        self.device = device

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.checkers.knossos import analysis
        from jepsen_tpu_torch.models import cas_register

        model = self.model or (test or {}).get("model") or cas_register()
        return analysis(history, model, algorithm=self.algorithm,
                        deadline=(opts or {}).get("deadline"),
                        device=self.device)


class ConcurrencyLimit(Checker):
    """Reference `concurrency-limit`: no more than n concurrent invocations
    (sanity check on the generator/interpreter)."""

    def __init__(self, limit: int):
        self.limit = limit

    def check(self, test, history, opts=None):
        open_ops = 0
        worst = 0
        for op in history:
            if not op.is_client_op():
                continue
            if op.type == INVOKE:
                open_ops += 1
                worst = max(worst, open_ops)
            else:
                open_ops = max(0, open_ops - 1)
        return {"valid?": worst <= self.limit, "max-concurrency": worst}
