"""Op records and histories (the port's copy of `jepsen_tpu/history/ops.py`).

Host-side mirror of `jepsen/history.clj` (reference layout, SURVEY.md §2.2):
the `Op` record `{:index :time :type :process :f :value}`, the `history`
constructor that normalizes and indexes a sequence of ops, dense histories
(index == array position), the O(1) pair index, and `invocation`/`completion`
lookups.  Filters (`client_ops`, `oks`, `invokes`) preserve original indices,
like the reference's lazy index-preserving views.

This layer is pure Python/numpy; the device-resident representation lives in
`jepsen_tpu_torch.history.soa`.

One difference from the original: `Op.from_dict` merges a dict under the
key ``"ext"`` into the op's extra keys, so that
``history([dataclasses.asdict(op) for op in other])`` rebuilds the ops of
a history from either package field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

# Op types.  Encoded as small ints for device packing.
INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPE_CODE = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}
CODE_TYPE = {v: k for k, v in TYPE_CODE.items()}

# Non-client processes get negative int codes (reference: keyword processes
# like :nemesis; we follow jepsen's convention that client processes are
# non-negative ints).
NEMESIS_PROCESS = -1


@dataclasses.dataclass
class Op:
    """A single operation event.

    Mirrors the reference Op defrecord: {:index :time :type :process :f
    :value} plus arbitrary extra keys (kept in `ext`).  `value` for Elle
    transactional workloads is a list of micro-ops (mops), e.g.
    ``[("append", k, v), ("r", k, [v1, v2])]``.
    """

    index: int = -1
    time: int = -1  # monotonic nanoseconds (relative test clock)
    type: str = INVOKE
    process: Any = None
    f: Any = None
    value: Any = None
    error: Any = None
    ext: Optional[dict] = None

    def is_invoke(self) -> bool:
        return self.type == INVOKE

    def is_ok(self) -> bool:
        return self.type == OK

    def is_fail(self) -> bool:
        return self.type == FAIL

    def is_info(self) -> bool:
        return self.type == INFO

    def is_client_op(self) -> bool:
        return isinstance(self.process, int) and self.process >= 0

    def with_(self, **kw) -> "Op":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = {
            "index": self.index,
            "time": self.time,
            "type": self.type,
            "process": self.process,
            "f": self.f,
            "value": self.value,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.ext:
            d.update(self.ext)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Op":
        ext = {
            k: v
            for k, v in d.items()
            if k not in ("index", "time", "type", "process", "f", "value",
                         "error", "ext")
        }
        ext.update(d.get("ext") or {})
        return Op(
            index=d.get("index", -1),
            time=d.get("time", -1),
            type=d["type"],
            process=d.get("process"),
            f=d.get("f"),
            value=d.get("value"),
            error=d.get("error"),
            ext=ext or None,
        )


def invoke(process, f, value, **kw) -> Op:
    return Op(type=INVOKE, process=process, f=f, value=value, **kw)


def ok(process, f, value, **kw) -> Op:
    return Op(type=OK, process=process, f=f, value=value, **kw)


def fail(process, f, value, **kw) -> Op:
    return Op(type=FAIL, process=process, f=f, value=value, **kw)


def info(process, f, value, **kw) -> Op:
    return Op(type=INFO, process=process, f=f, value=value, **kw)


class History:
    """A dense, indexed history of ops.

    Construction normalizes ops: assigns `index` = position, assigns
    monotonically non-decreasing synthetic `time` where missing, and builds
    the invoke<->completion pair index (reference: `jepsen.history/pair-index`).

    An invocation is paired with the next op by the same process; `info` ops
    from a crashed process remain unpaired (pair == -1) and are treated as
    forever-concurrent by checkers, exactly as in the reference.
    """

    def __init__(self, ops: Sequence[Op], *, reindex: bool = True):
        ops = list(ops)
        if reindex:
            for i, op in enumerate(ops):
                op.index = i
        last_t = -1
        for op in ops:
            if op.time is None or op.time < 0:
                op.time = last_t + 1
            last_t = max(last_t, op.time)
        self.ops = ops
        self._pair = self._build_pair_index(ops)

    @staticmethod
    def _build_pair_index(ops: Sequence[Op]) -> np.ndarray:
        pair = np.full(len(ops), -1, dtype=np.int64)
        open_by_process: dict = {}
        for i, op in enumerate(ops):
            p = op.process
            if op.type == INVOKE:
                if p in open_by_process:
                    raise ValueError(
                        f"process {p!r} invoked op {i} while op "
                        f"{open_by_process[p]} was still open"
                    )
                open_by_process[p] = i
            else:
                j = open_by_process.pop(p, None)
                if j is not None:
                    pair[i] = j
                    pair[j] = i
                # A completion with no invocation (e.g. half a history) is
                # left unpaired, like the reference's sparse handling.
        return pair

    # -- core lookups (all O(1), mirroring jepsen.history) -----------------

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __getitem__(self, idx: int) -> Op:
        return self.ops[idx]

    def get_index(self, index: int) -> Op:
        return self.ops[index]

    def pair_index(self, index: int) -> int:
        return int(self._pair[index])

    def completion(self, op: Op) -> Optional[Op]:
        j = int(self._pair[op.index])
        return self.ops[j] if j >= 0 and self.ops[j].type != INVOKE else None

    def invocation(self, op: Op) -> Optional[Op]:
        j = int(self._pair[op.index])
        return self.ops[j] if j >= 0 and self.ops[j].type == INVOKE else None

    # -- filters (index-preserving views) ----------------------------------

    def filter(self, pred: Callable[[Op], bool]) -> list:
        return [op for op in self.ops if pred(op)]

    def client_ops(self) -> list:
        return self.filter(Op.is_client_op)

    def oks(self) -> list:
        return self.filter(Op.is_ok)

    def invokes(self) -> list:
        return self.filter(Op.is_invoke)

    def infos(self) -> list:
        return self.filter(Op.is_info)

    def fails(self) -> list:
        return self.filter(Op.is_fail)

    def to_dicts(self) -> list:
        return [op.to_dict() for op in self.ops]

    @staticmethod
    def from_dicts(ds: Iterable[dict]) -> "History":
        return History([Op.from_dict(d) for d in ds], reindex=False)


def history(ops: Iterable[Op | dict], *, reindex: bool = True) -> History:
    """Normalize a sequence of Ops (or op dicts) into a dense History."""
    out = []
    for op in ops:
        out.append(Op.from_dict(op) if isinstance(op, dict) else op)
    return History(out, reindex=reindex)
