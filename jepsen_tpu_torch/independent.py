"""Independent keys: lift a single-key workload over many keys (the
port's copy of `jepsen_tpu/independent.py`).

Equivalent of the reference's `jepsen/src/jepsen/independent.clj`
(SURVEY.md §2.1): op values become ``(k, v)`` tuples;
:func:`sequential_generator` runs a fresh sub-generator per key in order;
:func:`concurrent_generator` splits the client threads into fixed groups of
`n`, each group working through its own queue of keys; and :func:`checker`
splits the history per key and checks each sub-history independently —
CPU Jepsen's main data-parallel axis, and on the card the natural batch
axis (`jepsen_tpu_torch.parallel.batch` consumes the same per-key split).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .checkers import api as checker_api
from .generator import core as g
from .history.ops import History, Op


def tuple_(k, v) -> Tuple[Any, Any]:
    """An independent (key, value) pair (reference `independent/tuple`)."""
    return (k, v)


def is_tuple(v: Any) -> bool:
    return isinstance(v, tuple) and len(v) == 2


def _wrap_key(k, gen_spec) -> g.Generator:
    """Wrap every op of a sub-generator so value -> (k, value)."""
    return g.f_map(lambda op: dict(op, value=(k, op.get("value"))),
                   g.lift(gen_spec))


def sequential_generator(keys: Sequence[Any],
                         gen_fn: Callable[[Any], Any]) -> g.Generator:
    """One key at a time: exhaust gen_fn(k) before moving on (reference
    `independent/sequential-generator`)."""
    return g.lift([_wrap_key(k, gen_fn(k)) for k in keys])


class _GroupWorker(g.Generator):
    """One thread group's generator: works through keys from a shared
    queue, running gen_fn(k) to exhaustion for each."""

    def __init__(self, keys: List[Any], gen_fn: Callable[[Any], Any],
                 current: Optional[g.Generator] = None):
        self.keys = keys
        self.gen_fn = gen_fn
        self.current = current

    def _advance(self) -> Optional["_GroupWorker"]:
        if not self.keys:
            return None
        k = self.keys[0]
        return _GroupWorker(self.keys[1:], self.gen_fn,
                            _wrap_key(k, self.gen_fn(k)))

    def op(self, test, ctx):
        cur = self
        while True:
            if cur.current is None:
                cur = cur._advance()
                if cur is None:
                    return None
            res = g.next_op(cur.current, test, ctx)
            if res is None:
                cur = _GroupWorker(cur.keys, cur.gen_fn, None)
                continue
            op_, gen2 = res
            return (op_, _GroupWorker(cur.keys, cur.gen_fn, gen2))

    def update(self, test, ctx, event):
        if self.current is None:
            return self
        return _GroupWorker(self.keys, self.gen_fn,
                            g.gen_update(self.current, test, ctx, event))


def concurrent_generator(n: int, keys: Sequence[Any],
                         gen_fn: Callable[[Any], Any]) -> g.Generator:
    """Divide client threads into groups of `n`; groups run concurrently,
    each working its own share of `keys` sequentially (reference
    `independent/concurrent-generator`; requires concurrency % n == 0,
    checked at runtime by thread restriction)."""
    keys = list(keys)

    class _Concurrent(g.Generator):
        def __init__(self, inner: Optional[g.Generator] = None):
            self.inner = inner

        def _build(self, ctx) -> g.Generator:
            threads = sorted(t for t, _ in ctx.workers
                             if isinstance(t, int))
            if not threads:
                return g.lift([])
            n_groups = max(1, len(threads) // n)
            if len(threads) % n != 0:
                raise ValueError(
                    f"concurrent_generator: concurrency {len(threads)} "
                    f"not divisible by group size {n}")
            shard = math.ceil(len(keys) / n_groups)
            subs = []
            for gi in range(n_groups):
                lo, hi = gi * n, (gi + 1) * n
                group_keys = keys[gi * shard:(gi + 1) * shard]
                subs.append(g.on_threads(
                    (lambda lo=lo, hi=hi: lambda t: isinstance(t, int)
                     and threads[lo] <= t <= threads[hi - 1])(),
                    _GroupWorker(group_keys, gen_fn)))
            return g.any_gen(*subs)

        def op(self, test, ctx):
            inner = self.inner or self._build(ctx)
            res = g.next_op(inner, test, ctx)
            if res is None:
                return None
            op_, gen2 = res
            return (op_, _Concurrent(gen2))

        def update(self, test, ctx, event):
            if self.inner is None:
                return self
            return _Concurrent(g.gen_update(self.inner, test, ctx, event))

    return _Concurrent()


def subhistories(history) -> Dict[Any, History]:
    """Split a history on tuple values into per-key dense histories
    (reference `independent/history-keys` + per-key projection)."""
    by_key: Dict[Any, List[Op]] = {}
    for op in history:
        v = op.value
        if is_tuple(v):
            k, inner = v
            by_key.setdefault(k, []).append(op.with_(value=inner))
    return {k: History(ops, reindex=True) for k, ops in by_key.items()}


class IndependentChecker(checker_api.Checker):
    """Check each key's sub-history with its own checker instance; valid
    iff every key is valid (reference `independent/checker`)."""

    def __init__(self, checker_or_factory):
        import copy

        if callable(checker_or_factory) and not isinstance(
                checker_or_factory, checker_api.Checker):
            self.factory = checker_or_factory
        else:
            # fresh copy per key so stateful checkers can't leak state
            # across keys
            self.factory = lambda: copy.deepcopy(checker_or_factory)

    def check(self, test, history, opts=None):
        subs = subhistories(history)
        if not subs:
            return {"valid?": "unknown", "key-count": 0}
        results: Dict[Any, dict] = {}
        for k, h in sorted(subs.items(), key=lambda kv: repr(kv[0])):
            results[k] = checker_api.check_safe(self.factory(), test, h, opts)
        valids = [r.get("valid?") for r in results.values()]
        if all(v is True for v in valids):
            valid = True
        elif any(v is False for v in valids):
            valid = False
        else:
            valid = "unknown"
        failures = [k for k, r in results.items()
                    if r.get("valid?") is False]
        return {"valid?": valid, "key-count": len(subs),
                "failures": failures[:32],
                "results": {repr(k): r for k, r in results.items()}}


def checker(checker_or_factory) -> IndependentChecker:
    return IndependentChecker(checker_or_factory)
