"""Model memoization: reachable states -> dense ints + transition table
(the port's copy of `jepsen_tpu/checkers/knossos/memo.py`, pinned equal
to it by a test: the BFS order of the states decides `table`).

Equivalent of `knossos/model/memo.clj` (SURVEY.md §2.4) — "the key trick
that makes WGL bit-packable, and the direct precursor of the TPU
transition-matrix design": enumerate the model states reachable under the
history's op alphabet, canonicalize each to an int, and precompute
`table[state, op] -> state' | -1` (inconsistent).  The host WGL walks the
int table; the device frontier search uploads it as an (S, A) int32
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch.checkers.knossos.prep import LinOp
from jepsen_tpu_torch.models import Inconsistent, Model


class StateExplosion(Exception):
    pass


@dataclasses.dataclass
class Memo:
    table: np.ndarray          # (S, A) int32; -1 = inconsistent
    op_sym: np.ndarray         # (n_ops,) int32: op -> alphabet symbol
    n_states: int
    n_syms: int
    init_state: int = 0


def memoize(model: Model, ops: Sequence[LinOp],
            max_states: int = 200_000) -> Memo:
    """Enumerate reachable states under the ops' alphabet."""
    # alphabet: distinct (f, value) pairs (values normalized to hashables)
    def norm(v):
        if isinstance(v, list):
            return tuple(norm(x) for x in v)
        return v

    sym_ids: Dict[Tuple, int] = {}
    syms: List[Tuple[Any, Any]] = []
    op_sym = np.zeros(len(ops), np.int32)
    for i, op in enumerate(ops):
        k = (op.f, norm(op.value))
        s = sym_ids.get(k)
        if s is None:
            s = len(syms)
            sym_ids[k] = s
            syms.append((op.f, op.value))
        op_sym[i] = s

    state_ids: Dict[Model, int] = {model: 0}
    states: List[Model] = [model]
    rows: List[List[int]] = []
    frontier = [0]
    while frontier:
        nxt = []
        for si in frontier:
            m = states[si]
            row = []
            for (f, v) in syms:
                m2 = m.step(f, v)
                if isinstance(m2, Inconsistent):
                    row.append(-1)
                    continue
                j = state_ids.get(m2)
                if j is None:
                    j = len(states)
                    if j >= max_states:
                        raise StateExplosion(
                            f"more than {max_states} reachable states")
                    state_ids[m2] = j
                    states.append(m2)
                    nxt.append(j)
                row.append(j)
            while len(rows) <= si:
                rows.append(None)
            rows[si] = row
        frontier = nxt
    table = np.asarray(rows, dtype=np.int32)
    return Memo(table=table, op_sym=op_sym, n_states=len(states),
                n_syms=len(syms))
