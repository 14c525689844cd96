"""Host WGL linearizability search (the exact anchor; the port's copy of
`jepsen_tpu/checkers/knossos/wgl.py`).

Equivalent of `knossos/wgl.clj` (SURVEY.md §2.4): Wing-Gong-Lowe DFS over
configurations (model state, linearized-set bitset) with a visited cache
of packed configs.  Uses the memoized int transition table; bitsets are
Python arbitrary-precision ints (the JVM BitSet analogue).  `info`
(crashed) ops never return: they may linearize anywhere after invocation
or not at all.

This is BASELINE.json config 1's correctness anchor; the batched
frontier search on the card (`device_wgl`) is differentially tested
against it.

As in the JAX package, `check` runs the C++ WGL of `jepsen_tpu_torch.native`
first (`_search_native`) and the Python DFS only under `JT_NO_NATIVE`, or
to re-derive the failure diagnostics of a small invalid search.  Where the
JAX package also runs the Python DFS when its library did not build, the
port raises `native.NativeError`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import native
from jepsen_tpu_torch.checkers.knossos.memo import Memo, StateExplosion, memoize
from jepsen_tpu_torch.checkers.knossos.prep import NEVER, LinOp, prepare
from jepsen_tpu_torch.checkers.knossos.search import stamp_abort
from jepsen_tpu_torch.history.ops import History
from jepsen_tpu_torch.models import Inconsistent, Model


def _search_memo(ops: Sequence[LinOp], memo: Memo,
                 max_configs: int = 5_000_000, ctl=None):
    """DFS over (linearized bitset, state).  Returns (ok, final_info)."""
    n = len(ops)
    must = 0  # bitmask of ops that MUST linearize (have returns)
    for i, op in enumerate(ops):
        if op.return_pos < NEVER:
            must |= 1 << i
    table = memo.table
    op_sym = memo.op_sym
    invokes = [op.invoke_pos for op in ops]
    returns = [op.return_pos for op in ops]

    # candidates(S): ops not in S invoked before min return of not-in-S ops
    def candidates(S: int) -> List[int]:
        minret = NEVER + 1
        for i in range(n):
            if not (S >> i) & 1 and returns[i] < minret:
                minret = returns[i]
        return [i for i in range(n)
                if not (S >> i) & 1 and invokes[i] < minret]

    seen = set()
    # stack entries: (S, state, candidate list, next candidate index)
    S, state = 0, memo.init_state
    stack = [(S, state, candidates(S), 0)]
    seen.add((S, state))
    explored = 0
    while stack:
        S, state, cands, ci = stack[-1]
        if (S & must) == must:
            return True, None
        if ci >= len(cands):
            stack.pop()
            continue
        stack[-1] = (S, state, cands, ci + 1)
        i = cands[ci]
        s2 = int(table[state, op_sym[i]])
        if s2 < 0:
            continue
        S2 = S | (1 << i)
        key = (S2, s2)
        if key in seen:
            continue
        seen.add(key)
        explored += 1
        if explored > max_configs:
            return None, {"reason": "config budget exhausted"}
        if ctl is not None and explored % 4096 == 0 and ctl.aborted():
            return None, {"reason": "aborted"}
        stack.append((S2, s2, candidates(S2), 0))
    # exhausted without linearizing all required ops
    return False, _final_info(ops, seen, memo)


def _final_info(ops, seen, memo):
    """Minimal failure context: the largest linearized sets reached."""
    best = []
    best_count = -1
    for (S, st) in seen:
        c = bin(S).count("1")
        if c > best_count:
            best_count = c
            best = [(S, st)]
        elif c == best_count and len(best) < 4:
            best.append((S, st))
    return {
        "max-linearized": best_count,
        "op-count": len(ops),
        # history indices (orig_invoke), not internal prepared-op ids, so
        # reports and humans can find the ops
        "configs": [{"linearized": [ops[i].orig_invoke
                                    for i in range(len(ops))
                                    if (S >> i) & 1],
                     "state": int(st)} for (S, st) in best[:4]],
    }


def _search_direct(ops: Sequence[LinOp], model: Model,
                   max_configs: int = 1_000_000, ctl=None):
    """Unmemoized DFS for models whose state space explodes.  Polls
    `ctl` every 4096 configs so a competition/deadline can abort this
    leg too (it is a race contestant via `check`'s StateExplosion
    fallback, and non-daemon racer threads must stay cancellable)."""
    n = len(ops)
    must = 0
    for i, op in enumerate(ops):
        if op.return_pos < NEVER:
            must |= 1 << i
    returns = [op.return_pos for op in ops]
    invokes = [op.invoke_pos for op in ops]

    def candidates(S: int) -> List[int]:
        minret = NEVER + 1
        for i in range(n):
            if not (S >> i) & 1 and returns[i] < minret:
                minret = returns[i]
        return [i for i in range(n)
                if not (S >> i) & 1 and invokes[i] < minret]

    seen = set()
    stack = [(0, model, candidates(0), 0)]
    seen.add((0, model))
    explored = 0
    while stack:
        S, m, cands, ci = stack[-1]
        if (S & must) == must:
            return True, None
        if ci >= len(cands):
            stack.pop()
            continue
        stack[-1] = (S, m, cands, ci + 1)
        i = cands[ci]
        m2 = m.step(ops[i].f, ops[i].value)
        if isinstance(m2, Inconsistent):
            continue
        S2 = S | (1 << i)
        if (S2, m2) in seen:
            continue
        seen.add((S2, m2))
        explored += 1
        if explored > max_configs:
            return None, {"reason": "config budget exhausted"}
        if ctl is not None and explored % 4096 == 0 and ctl.aborted():
            return None, {"reason": "aborted"}
        stack.append((S2, m2, candidates(S2), 0))
    return False, {"op-count": n}


def _search_native(ops: Sequence[LinOp], memo: Memo, max_configs: int,
                   ctl=None):
    """The C++ WGL (`jepsen_tpu_torch.native`); returns (NotImplemented,
    None) under `JT_NO_NATIVE`, for the Python search.  `ctl.flag` is
    shared with the C++ search so a competition can abort it mid-run (the
    ctypes call releases the GIL)."""
    if os.environ.get("JT_NO_NATIVE"):
        return NotImplemented, None
    ok, explored, aborted = native.wgl(
        memo.op_sym, [op.invoke_pos for op in ops],
        [op.return_pos for op in ops], NEVER, memo.table, memo.init_state,
        max_configs, abort_flag=ctl.flag if ctl is not None else None)
    if aborted:
        return None, {"reason": "aborted", "explored": explored}
    if ok is None:
        return None, {"reason": "config budget exhausted",
                      "explored": explored}
    if ok is False:
        # Re-run the Python search for the final-info diagnostics
        # (max-linearized, witness configs) when cheap; keep the summary
        # shape when the config space is too big to redo.
        if explored <= 200_000:
            return _search_memo(ops, memo, max_configs, ctl)
        return False, {"op-count": len(ops), "explored": explored}
    return True, None


def check(history: History | Sequence[LinOp], model: Model,
          max_configs: int = 5_000_000, ctl=None) -> Dict[str, Any]:
    """Check linearizability of a single-object history against a model.
    `ctl` (a `search.Search`) lets a competition abort the search —
    both the Python DFS (polled every 4096 configs) and the C++ one
    (shared abort flag, polled every 1024 configs)."""
    ops = history if isinstance(history, list) else prepare(history)
    if not ops:
        return {"valid?": "unknown", "op-count": 0}
    try:
        memo = memoize(model, ops)
        ok, info = _search_native(ops, memo, max_configs, ctl)
        if ok is NotImplemented:
            ok, info = _search_memo(ops, memo, max_configs, ctl)
    except StateExplosion:
        ok, info = _search_direct(ops, model, max_configs, ctl)
    if ok is None:
        # an aborted search names its cause: deadline-driven aborts
        # surface as error=deadline-exceeded (resilience contract)
        return stamp_abort({"valid?": "unknown", "op-count": len(ops),
                            **(info or {})}, ctl)
    out: Dict[str, Any] = {"valid?": bool(ok), "op-count": len(ops)}
    if info:
        out["final-info"] = info
    return out
