"""Sequential datatype models for linearizability checking (the port's
copy of `jepsen_tpu/models`, pinned equal to it by a test).

Equivalent of the reference's `knossos/model.clj` (SURVEY.md §2.4): a
`Model` steps through operations, returning the next model or
`Inconsistent`.  Models are pure and hashable — the property the memoizer
(`checkers.knossos.memo`) exploits to canonicalize reachable states into
dense ints and precompute the state x op transition table that both the
host WGL search and the batched frontier search on the card consume.

Ops are (f, value) pairs; a read with value None matches any state
(unknown result, e.g. a crashed read), as in the reference.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple


class Inconsistent:
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


class Model:
    """Base sequential model.  Subclasses implement `step(f, value)` and
    must be value-objects: __eq__/__hash__ over their state."""

    def step(self, f: str, value: Any):
        raise NotImplementedError

    # default identity = type + __dict__ tuple
    def _key(self) -> Tuple:
        return tuple(sorted(self.__dict__.items(),
                            key=lambda kv: kv[0]))

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__, self._key()))

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class Register(Model):
    """A read/write register (reference `model/register`)."""

    def __init__(self, value=None):
        self.value = value

    def step(self, f, v):
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"read {v!r}, expected {self.value!r}")
        return inconsistent(f"unknown op {f!r}")


class CASRegister(Model):
    """A compare-and-set register (reference `model/cas-register`)."""

    def __init__(self, value=None):
        self.value = value

    def step(self, f, v):
        if f == "write":
            return CASRegister(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"read {v!r}, expected {self.value!r}")
        if f == "cas":
            old, new = v
            if self.value == old:
                return CASRegister(new)
            return inconsistent(f"cas {old!r}->{new!r} on {self.value!r}")
        return inconsistent(f"unknown op {f!r}")


class Mutex(Model):
    """A lock (reference `model/mutex`)."""

    def __init__(self, locked: bool = False):
        self.locked = locked

    def step(self, f, v):
        if f == "acquire":
            if self.locked:
                return inconsistent("already held")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("not held")
            return Mutex(False)
        return inconsistent(f"unknown op {f!r}")


class FIFOQueue(Model):
    """A FIFO queue (reference `model/fifo-queue`)."""

    def __init__(self, items: Tuple = ()):
        self.items = tuple(items)

    def step(self, f, v):
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            head, rest = self.items[0], self.items[1:]
            if v is None or v == head:
                return FIFOQueue(rest)
            return inconsistent(f"dequeued {v!r}, expected {head!r}")
        return inconsistent(f"unknown op {f!r}")


class UnorderedQueue(Model):
    """A bag/unordered queue (reference `model/unordered-queue`)."""

    def __init__(self, items: Tuple = ()):
        self.items = tuple(sorted(items, key=repr))

    def step(self, f, v):
        if f == "enqueue":
            return UnorderedQueue(self.items + (v,))
        if f == "dequeue":
            if v is None:
                if not self.items:
                    return inconsistent("dequeue from empty queue")
                return UnorderedQueue(self.items[1:])
            if v in self.items:
                items = list(self.items)
                items.remove(v)
                return UnorderedQueue(tuple(items))
            return inconsistent(f"dequeued {v!r} not in queue")
        return inconsistent(f"unknown op {f!r}")


class GrowOnlySet(Model):
    """A grow-only set with reads (reference `model/set`)."""

    def __init__(self, items: Tuple = ()):
        self.items = tuple(sorted(set(items), key=repr))

    def step(self, f, v):
        if f == "add":
            return GrowOnlySet(self.items + (v,))
        if f == "read":
            if v is None or set(v) == set(self.items):
                return self
            return inconsistent(f"read {v!r}, expected {self.items!r}")
        return inconsistent(f"unknown op {f!r}")


def register(value=None) -> Register:
    return Register(value)


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def grow_only_set() -> GrowOnlySet:
    return GrowOnlySet()
