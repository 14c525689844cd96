"""History preparation for linearizability checking (the port's copy of
`jepsen_tpu/checkers/knossos/prep.py`, pinned equal to it by a test).

Equivalent of `knossos/history.clj` (SURVEY.md §2.4): pair invocations
with completions, drop `fail` ops entirely (they never took effect), keep
`info` (crashed) ops as forever-open — they may linearize at any point
after their invocation, or not at all.

Produces a compact entry table: for each checked op i —
  f[i], value[i] (completion value for ok; invocation value for info,
  with reads' results unknown -> None), invoke_pos[i], return_pos[i]
  (2**30 for info = never returns).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, History

NEVER = 2 ** 30


@dataclasses.dataclass
class LinOp:
    index: int           # dense op id
    f: Any
    value: Any
    invoke_pos: int
    return_pos: int      # NEVER for info ops
    orig_invoke: int     # original history index (reporting)
    orig_complete: int   # -1 if none

    @property
    def is_info(self) -> bool:
        return self.return_pos >= NEVER


def prepare(h: History) -> List[LinOp]:
    ops: List[LinOp] = []
    for op in h.ops:
        if op.type != INVOKE or not op.is_client_op():
            continue
        comp_idx = h.pair_index(op.index)
        comp = h.ops[comp_idx] if comp_idx >= 0 else None
        if comp is not None and comp.type == FAIL:
            continue  # never happened
        if comp is not None and comp.type == OK:
            ops.append(LinOp(len(ops), op.f, comp.value, op.index,
                             comp.index, op.index, comp.index))
        else:
            # crashed / still open: result unknown
            v = op.value
            if op.f in ("read", "dequeue"):
                v = None
            ops.append(LinOp(len(ops), op.f, v, op.index, NEVER,
                             op.index, comp.index if comp else -1))
    return ops
