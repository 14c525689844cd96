"""Just-in-time linearization (Lowe's algorithm; the port's copy of
`jepsen_tpu/checkers/knossos/linear.py`, all numpy).

Equivalent of `knossos/linear.clj` + `knossos/linear/config.clj`
(SURVEY.md §2.4): configurations evolve per history *event* rather than
per linearization order.  A configuration is ``(model-state,
linearized-set)`` where the set holds ops linearized but not yet
returned.  On an op's return, every surviving configuration must have
linearized it — configurations are expanded "just in time" by linearizing
subsets of pending calls, then filtered; an empty configuration set is a
linearizability violation, localized to that return event.

Two config-set representations, the analogue of the reference's
array-packed config structures (`knossos/linear/config.clj`):

- **packed** (default): a config is ONE int64, ``state << P | mask``,
  where ``mask`` is a bitmask over concurrency *slots* (a slot is held
  by an op while it is pending, freed at its return; P = peak
  concurrency).  The whole config set is a sorted-unique numpy int64
  array, and the per-event JIT expansion is vectorized: one transition-
  table gather per (pending slot x frontier) round, `np.unique` dedup —
  no per-config Python.  This is what makes `linear` competitive with
  `wgl` on adversarial histories.
- **sets** (fallback for > 57 concurrent ops or huge state spaces):
  ``(state:int, frozenset[int])`` tuples, expanded per config.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from jepsen_tpu_torch.checkers.knossos.memo import Memo, StateExplosion, memoize
from jepsen_tpu_torch.checkers.knossos.prep import NEVER, LinOp, prepare
from jepsen_tpu_torch.checkers.knossos.search import Search, stamp_abort
from jepsen_tpu_torch.history.ops import History
from jepsen_tpu_torch.models import Model

Config = Tuple[int, frozenset]


def _events(ops: Sequence[LinOp]) -> List[Tuple[int, str, int]]:
    evs = []
    for op in ops:
        evs.append((op.invoke_pos, "call", op.index))
        if op.return_pos < NEVER:
            evs.append((op.return_pos, "ret", op.index))
    evs.sort()
    return evs


def _jit_expand(configs: Set[Config], target: int, calls: Set[int],
                table, op_sym, max_configs: int) -> Optional[Set[Config]]:
    """All configs reachable by linearizing pending calls, keeping those
    with `target` linearized (then dropping target from the set).
    Returns None on budget blowout."""
    out: Set[Config] = set()
    seen: Set[Config] = set(configs)
    stack = list(configs)
    budget = max_configs
    while stack:
        state, lin = stack.pop()
        if target in lin:
            out.add((state, lin - {target}))
        pending = calls - lin
        for j in pending:
            s2 = int(table[state, op_sym[j]])
            if s2 < 0:
                continue
            c2 = (s2, lin | {j})
            if c2 in seen:
                continue
            seen.add(c2)
            budget -= 1
            if budget <= 0:
                return None
            stack.append(c2)
    return out


def _peak_concurrency(evs) -> int:
    """Peak number of simultaneously-pending ops = slots needed."""
    live = peak = 0
    for _, kind, _ in evs:
        live += 1 if kind == "call" else -1
        peak = max(peak, live)
    return peak


def _search_packed(ops: Sequence[LinOp], memo: Memo, evs, P: int,
                   max_configs: int, ctl: Optional[Search] = None):
    """Vectorized JIT search over int64-packed configs (see module doc)."""
    table = memo.table
    op_sym = memo.op_sym
    mask_all = (np.int64(1) << P) - 1

    free = list(range(P - 1, -1, -1))   # slot pool (smallest on top)
    slot_of: Dict[int, int] = {}        # pending op -> slot
    slot_sym: Dict[int, int] = {}       # slot -> transition symbol

    configs = np.asarray([np.int64(memo.init_state) << P])
    for pos, kind, i in evs:
        if ctl is not None and ctl.aborted():
            return None, {"reason": "aborted"}
        if kind == "call":
            s = free.pop()
            slot_of[i] = s
            slot_sym[s] = int(op_sym[i])
            continue

        # JIT expansion: closure of `configs` under linearizing pending
        # ops, as rounds of vectorized table gathers over the frontier
        t_slot = slot_of.pop(i)
        all_cfgs = configs                     # sorted unique
        frontier = configs
        while frontier.size:
            states = frontier >> P
            masks = frontier & mask_all
            new_parts = []
            for s, sym in slot_sym.items():
                bit = np.int64(1) << s
                sel = (masks & bit) == 0
                if not sel.any():
                    continue
                s2 = table[states[sel], sym]
                ok = s2 >= 0
                if not ok.any():
                    continue
                new_parts.append((s2[ok].astype(np.int64) << P)
                                 | (masks[sel][ok] | bit))
            if not new_parts:
                break
            cand = np.unique(np.concatenate(new_parts))
            fresh = cand[~np.isin(cand, all_cfgs, assume_unique=True)]
            if not fresh.size:
                break
            all_cfgs = np.union1d(all_cfgs, fresh)
            if all_cfgs.size > max_configs:
                return None, {"reason": "config budget exhausted"}
            frontier = fresh

        bit = np.int64(1) << t_slot
        survivors = all_cfgs[(all_cfgs & bit) != 0]
        if not survivors.size:
            # decode a few prior configs for the failure report
            op_of_slot = {s: j for j, s in slot_of.items()}
            op_of_slot[t_slot] = i
            prior = set()
            for c in configs[:4]:
                m = int(c) & int(mask_all)
                lin = frozenset(op_of_slot[s] for s in range(P)
                                if (m >> s) & 1 and s in op_of_slot)
                prior.add((int(c) >> P, lin))
            del slot_sym[t_slot]
            free.append(t_slot)
            return False, _failure_info(ops, i, pos, prior)
        configs = np.unique(survivors & ~bit)
        del slot_sym[t_slot]
        free.append(t_slot)
        if ctl is not None:
            ctl.add_explored(int(configs.size))
    return True, None


def _rowview(a: np.ndarray) -> np.ndarray:
    """View (C, W) rows as a structured 1-D array for row-wise
    membership (np.isin sorts lexicographically by fields)."""
    return np.ascontiguousarray(a).view(
        [("", a.dtype)] * a.shape[1]).ravel()


def _search_packed_wide(ops: Sequence[LinOp], memo: Memo, evs, P: int,
                        max_configs: int, ctl: Optional[Search] = None):
    """Wide-mask packed search: the >57-slot regime (crash-heavy
    histories, where every `info` op holds a slot forever).

    A config is a row ``[state, lane_0 .. lane_{L-1}]`` (int64 cols;
    lanes hold uint32 slot bitmasks, L = ceil(P/32)) in a (C, 1+L)
    array kept row-sorted-unique by np.unique(axis=0).  The per-event
    expansion is the same vectorized frontier closure as the int64 path
    — one transition-table gather per (pending slot x frontier) round —
    just with 2-D rows instead of scalar packs.  ~P/57x more memory per
    config than the int64 path; identical asymptotics.
    """
    table = memo.table
    L = (P + 31) // 32

    free = list(range(P - 1, -1, -1))
    slot_of: Dict[int, int] = {}
    slot_sym: Dict[int, int] = {}

    configs = np.zeros((1, 1 + L), np.int64)
    configs[0, 0] = memo.init_state
    for pos, kind, i in evs:
        if ctl is not None and ctl.aborted():
            return None, {"reason": "aborted"}
        if kind == "call":
            s = free.pop()
            slot_of[i] = s
            slot_sym[s] = int(memo.op_sym[i])
            continue

        t_slot = slot_of.pop(i)
        all_cfgs = configs
        frontier = configs
        while frontier.shape[0]:
            # poll INSIDE the closure too: one event's expansion can run
            # minutes on info-dense histories, and the competition must
            # be able to abort this leg mid-event
            if ctl is not None and ctl.aborted():
                return None, {"reason": "aborted"}
            new_parts = []
            for s, sym in slot_sym.items():
                lane, bit = 1 + s // 32, np.int64(1) << (s % 32)
                sel = (frontier[:, lane] & bit) == 0
                if not sel.any():
                    continue
                sub = frontier[sel]
                s2 = table[sub[:, 0], sym]
                ok = s2 >= 0
                if not ok.any():
                    continue
                rows = sub[ok].copy()
                rows[:, 0] = s2[ok]
                rows[:, lane] |= bit
                new_parts.append(rows)
            if not new_parts:
                break
            cand = np.unique(np.concatenate(new_parts), axis=0)
            fresh = cand[~np.isin(_rowview(cand), _rowview(all_cfgs),
                                  assume_unique=True)]
            if not fresh.shape[0]:
                break
            all_cfgs = np.unique(np.concatenate([all_cfgs, fresh]),
                                 axis=0)
            if all_cfgs.shape[0] > max_configs:
                return None, {"reason": "config budget exhausted"}
            frontier = fresh

        lane, bit = 1 + t_slot // 32, np.int64(1) << (t_slot % 32)
        survivors = all_cfgs[(all_cfgs[:, lane] & bit) != 0]
        if not survivors.shape[0]:
            op_of_slot = {s: j for j, s in slot_of.items()}
            op_of_slot[t_slot] = i
            prior = set()
            for row in configs[:4]:
                lin = frozenset(
                    op_of_slot[s] for s in range(P)
                    if (int(row[1 + s // 32]) >> (s % 32)) & 1
                    and s in op_of_slot)
                prior.add((int(row[0]), lin))
            del slot_sym[t_slot]
            free.append(t_slot)
            return False, _failure_info(ops, i, pos, prior)
        survivors = survivors.copy()
        survivors[:, lane] &= ~bit
        configs = np.unique(survivors, axis=0)
        del slot_sym[t_slot]
        free.append(t_slot)
        if ctl is not None:
            ctl.add_explored(int(configs.shape[0]))
    return True, None


def _search_sets(ops: Sequence[LinOp], memo: Memo, evs, max_configs: int,
                 ctl: Optional[Search] = None):
    table = memo.table
    op_sym = memo.op_sym
    configs: Set[Config] = {(memo.init_state, frozenset())}
    calls: Set[int] = set()
    for pos, kind, i in evs:
        if ctl is not None and ctl.aborted():
            return None, {"reason": "aborted"}
        if kind == "call":
            calls.add(i)
            continue
        expanded = _jit_expand(configs, i, calls, table, op_sym,
                               max_configs)
        if expanded is None:
            return None, {"reason": "config budget exhausted"}
        calls.remove(i)
        if not expanded:
            return False, _failure_info(ops, i, pos, configs)
        configs = expanded
        if ctl is not None:
            ctl.add_explored(len(configs))
    return True, None


#: wide-mask slot ceiling: L = ceil(P/32) lanes per config row; past
#: this the per-config rows are so wide the sets path wins anyway
WIDE_MAX_SLOTS = 1024


def _search(ops: Sequence[LinOp], memo: Memo, max_configs: int,
            ctl: Optional[Search] = None, _force_sets: bool = False,
            _force_wide: bool = False):
    evs = _events(ops)
    P = _peak_concurrency(evs)
    # packed configs need state << P to fit an int64
    if not _force_sets:
        if not _force_wide and P and P <= 57 and \
                memo.n_states <= (1 << (62 - P)):
            return _search_packed(ops, memo, evs, P, max_configs, ctl)
        if P and P <= WIDE_MAX_SLOTS:
            return _search_packed_wide(ops, memo, evs, P, max_configs,
                                       ctl)
    return _search_sets(ops, memo, evs, max_configs, ctl)


def _failure_info(ops: Sequence[LinOp], bad_op: int, pos: int,
                  prior_configs: Set[Config]) -> dict:
    op = ops[bad_op]
    return {
        "op": {"index": op.orig_invoke, "f": op.f, "value": op.value},
        "return-pos": pos,
        "prior-config-count": len(prior_configs),
        "prior-configs": [
            {"state": int(s), "linearized-not-returned": sorted(lin)}
            for (s, lin) in list(prior_configs)[:4]],
    }


def check(history: "History | Sequence[LinOp]", model: Model,
          max_configs: int = 5_000_000,
          ctl: Optional[Search] = None) -> Dict[str, Any]:
    """JIT-linearization check; same result shape as `wgl.check`.  Unlike
    WGL, a violation is localized to the first un-linearizable return."""
    ops = history if isinstance(history, list) else prepare(history)
    if not ops:
        return {"valid?": "unknown", "op-count": 0}
    try:
        memo = memoize(model, ops)
    except StateExplosion:
        return {"valid?": "unknown", "reason": "state explosion",
                "op-count": len(ops)}
    ok, info = _search(ops, memo, max_configs, ctl)
    if ok is None:
        return stamp_abort({"valid?": "unknown", "op-count": len(ops),
                            **(info or {})}, ctl)
    out: Dict[str, Any] = {"valid?": bool(ok), "op-count": len(ops),
                           "algorithm": "linear"}
    if info:
        out["final-info"] = info
    return out
