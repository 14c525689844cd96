"""Chunk-parallel folds over histories, with fold fusion (the port's copy
of `jepsen_tpu/history/fold.py`; numpy on the host, as there).

Equivalent of the reference's `jepsen/history/fold.clj` + `task.clj`
(SURVEY.md §2.2): a fold is a spec of

- ``reducer_identity`` / ``reducer`` / ``post_reducer`` — applied within a
  chunk,
- ``combiner_identity`` / ``combiner`` / ``post_combiner`` — applied across
  chunk results **in order**,
- ``associative`` — when False the fold runs serially (exact reference
  semantics: only associative folds go chunk-parallel).

:class:`Folder` binds to a chunked op source (a History, a store
``LazyHistory``, or an explicit chunk list) and **fuses** folds into one
pass — each chunk is traversed once no matter how many folds run:

- `fold_many(folds)` fuses an explicit batch;
- `submit(fold)` fuses folds submitted *concurrently* (from any thread):
  submissions that arrive while a pass is in flight are batched into the
  next pass — the reference's concurrent-submission fusion, built on the
  dependency-DAG :class:`~jepsen_tpu_torch.history.task.TaskExecutor`.

Chunks are held as lazy thunks: a LazyHistory source decodes chunks
inside the workers (bounded by its own LRU), never materializing a 10M-op
history on the host at once.

Columnar fast path: a fold may carry a ``columnar`` reducer operating on
a dict of numpy column arrays; sources that provide column chunks
(`columns_of`, or any PackedTxns-like object) then run folds at numpy
speed instead of per-op Python — the host-side mirror of the device
segment reductions in `ops/segments.py`.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .ops import History, Op
from .task import TaskExecutor

CHUNK_SIZE = 16384


def _identity(x: Any) -> Any:
    return x


@dataclasses.dataclass
class Fold:
    """A fold spec (reference fold maps).

    `columnar`, when given, maps a dict of numpy column arrays (keys
    "type", "process", "f", "time", "error?") to a chunk partial that
    feeds the combiner — used instead of the per-op reducer whenever the
    source provides column chunks.
    """

    reducer_identity: Callable[[], Any]
    reducer: Callable[[Any, Op], Any]
    post_reducer: Callable[[Any], Any] = _identity
    combiner_identity: Optional[Callable[[], Any]] = None
    combiner: Optional[Callable[[Any, Any], Any]] = None
    post_combiner: Callable[[Any], Any] = _identity
    associative: bool = True
    name: str = "fold"
    columnar: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None


def fold_spec(*, reducer_identity, reducer, post_reducer=_identity,
              combiner_identity=None, combiner=None,
              post_combiner=_identity, associative=True,
              name="fold", columnar=None) -> Fold:
    return Fold(reducer_identity, reducer, post_reducer, combiner_identity,
                combiner, post_combiner, associative, name, columnar)


_GETTER = __import__("operator").attrgetter(
    "type", "process", "f", "time", "error")


def columns_of(ops: Sequence[Op]) -> Dict[str, np.ndarray]:
    """Build column arrays from an op chunk.  The per-op work is one
    C-level attrgetter call; everything downstream is numpy."""
    n = len(ops)
    if n == 0:
        return {"type": np.empty(0, "U6"), "process": np.empty(0, object),
                "f": np.empty(0, object), "time": np.empty(0, np.int64),
                "error?": np.zeros(0, bool), "client?": np.zeros(0, bool)}
    arr = np.array(list(map(_GETTER, ops)), dtype=object)
    process = arr[:, 1]
    client = np.fromiter(
        (isinstance(p, int) and p >= 0 for p in process),
        dtype=bool, count=n)
    return {
        "type": arr[:, 0].astype("U6"),
        "process": process,
        "f": arr[:, 2],
        "time": arr[:, 3].astype(np.int64),
        "error?": arr[:, 4] != None,  # noqa: E711 — elementwise object cmp
        "client?": client,
    }


def _memo_thunk(thunk: Callable[[], Any]) -> Callable[[], Any]:
    cell: list = []

    def get():
        if not cell:
            cell.append(thunk())
        return cell[0]

    return get


class Folder:
    """Bound to one chunked source; runs (fused) folds over it."""

    def __init__(self, chunks_or_history, *,
                 max_workers: Optional[int] = None,
                 executor: Optional[TaskExecutor] = None,
                 columnar: bool = False):
        self._thunks = self._chunkify(chunks_or_history, columnar)
        self.max_workers = max_workers or min(8, (os.cpu_count() or 2))
        self._executor = executor
        self._own_executor = executor is None
        self._lock = threading.Lock()
        self._pending: List[tuple] = []       # (Fold, Future)
        self._pass_scheduled = False

    # -- chunk sources ------------------------------------------------------

    @staticmethod
    def _chunkify(src, columnar: bool) -> List[Callable[[], Any]]:
        """Return lazy chunk thunks.  Never materializes a chunk-lazy
        source eagerly; workers decode chunks on demand."""
        # store.format.LazyHistory (or anything chunk-addressable)
        if hasattr(src, "_load_chunk") and hasattr(src, "_chunks"):
            n = len(src._chunks)
            thunks = [
                (lambda ci=ci: src._load_chunk(ci)) for ci in range(n)]
            thunks = thunks or [lambda: []]
            if columnar:
                return [(lambda t=t: columns_of(t())) for t in thunks]
            return thunks
        if hasattr(src, "iter_chunks"):  # generic chunked protocol
            chunks = list(src.iter_chunks())
            return Folder._wrap_lists(chunks, columnar)
        if isinstance(src, History):
            ops = src.ops
        else:
            ops = list(src)
            if ops and not isinstance(ops[0], Op):
                # a list of chunks — validate the shape: each chunk must
                # be a sequence of Ops (a history passed as raw dicts
                # would otherwise silently fold garbage)
                for c in ops:
                    if not isinstance(c, (list, tuple)) or \
                            (len(c) and not isinstance(c[0], Op)):
                        raise TypeError(
                            "Folder expects a History, a chunk-lazy "
                            "source, a list of Ops, or a list of Op "
                            f"chunks; got element {type(c).__name__}")
                return Folder._wrap_lists(ops, columnar)
        chunks = [ops[i:i + CHUNK_SIZE]
                  for i in range(0, len(ops), CHUNK_SIZE)] or [[]]
        return Folder._wrap_lists(chunks, columnar)

    @staticmethod
    def _wrap_lists(chunks, columnar):
        if columnar:
            # in-memory chunks are immutable: build columns once, reuse
            # across passes (LazyHistory chunks stay uncached above —
            # bounded memory beats repeat-pass speed there)
            return [_memo_thunk(lambda c=c: columns_of(c)) for c in chunks]
        return [(lambda c=c: c) for c in chunks]

    # -- execution ---------------------------------------------------------

    def _reduce_chunk(self, folds: Sequence[Fold], thunk) -> List[Any]:
        chunk = thunk()
        if isinstance(chunk, dict):  # column chunk
            out = []
            for f in folds:
                if f.columnar is None:
                    raise TypeError(
                        f"fold {f.name!r} has no columnar reducer but the "
                        "source provides column chunks")
                out.append(f.columnar(chunk))
            return out
        accs = [f.reducer_identity() for f in folds]
        reducers = [f.reducer for f in folds]
        for op in chunk:
            for i, r in enumerate(reducers):
                accs[i] = r(accs[i], op)
        return [f.post_reducer(a) for f, a in zip(folds, accs)]

    def fold_many(self, folds: Sequence[Fold]) -> List[Any]:
        """Run several folds in ONE pass over the chunks (fold fusion).
        Associative folds share a chunk-parallel pass; non-associative
        ones run serially (still fused with each other)."""
        folds = list(folds)
        par = [f for f in folds if f.associative]
        ser = [f for f in folds if not f.associative]
        results: Dict[int, Any] = {}

        if par:
            for f in par:
                if f.combiner is None:
                    raise TypeError(f"associative fold {f.name!r} needs "
                                    f"a combiner")
            if len(self._thunks) > 1:
                with _fut.ThreadPoolExecutor(self.max_workers) as ex:
                    chunk_results = list(ex.map(
                        lambda t: self._reduce_chunk(par, t), self._thunks))
            else:
                chunk_results = [self._reduce_chunk(par, self._thunks[0])]
            for fi, f in enumerate(par):
                acc = (f.combiner_identity or f.reducer_identity)()
                for cr in chunk_results:  # ordered combine
                    acc = f.combiner(acc, cr[fi])
                results[id(f)] = f.post_combiner(acc)
        for f in ser:
            acc = f.reducer_identity()
            for thunk in self._thunks:
                chunk = thunk()
                if isinstance(chunk, dict):
                    raise TypeError(f"non-associative fold {f.name!r} "
                                    "cannot run on column chunks")
                for op in chunk:
                    acc = f.reducer(acc, op)
            results[id(f)] = f.post_combiner(f.post_reducer(acc))
        return [results[id(f)] for f in folds]

    def fold(self, f: Fold) -> Any:
        return self.fold_many([f])[0]

    # -- concurrent submission fusion --------------------------------------

    def submit(self, f: Fold) -> "_fut.Future":
        """Submit a fold from any thread; returns a Future.  All folds
        pending when a pass starts are fused into that single pass; folds
        submitted while a pass is in flight batch into the next pass."""
        fut: _fut.Future = _fut.Future()
        with self._lock:
            self._pending.append((f, fut))
            if not self._pass_scheduled:
                self._pass_scheduled = True
                ex = self._ensure_executor()
                ex.submit(self._drain, name="fold-pass")
        return fut

    def _ensure_executor(self) -> TaskExecutor:
        if self._executor is None:
            self._executor = TaskExecutor(self.max_workers)
            self._own_executor = True
        return self._executor

    def _drain(self) -> None:
        while True:
            with self._lock:
                batch = self._pending
                self._pending = []
                if not batch:
                    self._pass_scheduled = False
                    return
            folds = [f for (f, _) in batch]
            try:
                outs = self.fold_many(folds)
                for (_, fut), out in zip(batch, outs):
                    fut.set_result(out)
            except BaseException as e:  # noqa: BLE001 — deliver to waiters
                for (_, fut) in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def close(self) -> None:
        if self._own_executor and self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Common folds (reference history's built-in folds / tesser shims)


def count_fold(pred: Optional[Callable[[Op], bool]] = None) -> Fold:
    return fold_spec(
        name="count",
        reducer_identity=lambda: 0,
        reducer=(lambda acc, op: acc + 1) if pred is None
        else (lambda acc, op: acc + (1 if pred(op) else 0)),
        combiner_identity=lambda: 0,
        combiner=lambda a, b: a + b,
        columnar=None if pred is not None
        else (lambda cols: int(len(cols["type"]))))


def type_count_fold() -> Fold:
    """Counts by op type — columnar-capable (stats checker hot path)."""
    def red(acc, op):
        acc[op.type] = acc.get(op.type, 0) + 1
        return acc

    def comb(a, b):
        for k, v in b.items():
            a[k] = a.get(k, 0) + v
        return a

    def col(cols):
        vals, counts = np.unique(cols["type"], return_counts=True)
        return {str(v): int(c) for v, c in zip(vals, counts)}

    return fold_spec(name="type-count", reducer_identity=dict,
                     reducer=red, combiner_identity=dict, combiner=comb,
                     columnar=col)


def group_count_fold(key: Callable[[Op], Any] = None,
                     column: Optional[str] = None) -> Fold:
    """Counts grouped by key(op) — or by a column name, making the fold
    columnar-capable."""
    if key is None:
        if column is None:
            raise TypeError("need key or column")
        key = lambda op: getattr(op, column)  # noqa: E731

    def red(acc, op):
        k = key(op)
        acc[k] = acc.get(k, 0) + 1
        return acc

    def comb(a, b):
        for k, v in b.items():
            a[k] = a.get(k, 0) + v
        return a

    col = None
    if column is not None:
        def col(cols):  # noqa: F811
            vals, counts = np.unique(cols[column], return_counts=True)
            return {v: int(c) for v, c in zip(vals, counts)}

    return fold_spec(name="group-count", reducer_identity=dict,
                     reducer=red, combiner_identity=dict, combiner=comb,
                     columnar=col)


def collect_fold(pred: Callable[[Op], bool],
                 xform: Callable[[Op], Any] = _identity) -> Fold:
    return fold_spec(
        name="collect",
        reducer_identity=list,
        reducer=lambda acc, op: (acc.append(xform(op)) or acc)
        if pred(op) else acc,
        combiner_identity=list,
        combiner=lambda a, b: a + b)
