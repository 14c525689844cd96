"""Pure-data generator DSL (the port's copy of `jepsen_tpu/generator/core.py`).

Equivalent of the reference's `jepsen/generator.clj` (SURVEY.md §2.1): a
`Generator` protocol with two pure operations —

    op(test, ctx)            -> None | (op-or-PENDING, next-generator)
    update(test, ctx, event) -> next-generator

— plus lifting rules (dicts are one-shot op templates, functions are
infinite op factories, sequences run their elements in order) and the
combinator library (stagger, delay, sleep, mix, phases, then, any, limit,
time-limit, repeat, cycle, reserve, clients, nemesis, on-threads,
synchronize, log, until-ok, flip-flop, filter, each-thread, trace).

Generators never mutate: every transition returns a fresh generator value,
so the interpreter (and the pure test simulator in `generator/sim.py`) can
replay and backtrack freely, exactly like the reference's design.

Times in op maps are nanoseconds on the test clock; DSL entry points take
seconds (floats), mirroring the reference's second-based sugar over
nanosecond internals.
"""

from __future__ import annotations

import inspect
import logging
import random as _random
from typing import Any, Callable, List, Optional, Sequence, Tuple

from jepsen_tpu_torch.generator.context import NEMESIS_THREAD, Context

logger = logging.getLogger("jepsen.generator")

OpResult = Optional[Tuple[Any, Optional["Generator"]]]


class _Pending:
    """Sentinel: nothing to emit right now.  May carry a wake time so the
    interpreter can sleep precisely instead of spinning."""

    __slots__ = ("time",)

    def __init__(self, time: Optional[int] = None):
        self.time = time

    def __repr__(self):
        return f"Pending(until={self.time})"


PENDING = _Pending()


def is_pending(x: Any) -> bool:
    return isinstance(x, _Pending)


def pending_until(t: int) -> _Pending:
    return _Pending(t)


def _s_to_ns(seconds: float) -> int:
    return int(seconds * 1e9)


# ---------------------------------------------------------------------------
# Protocol


class Generator:
    def op(self, test: dict, ctx: Context) -> OpResult:
        """Produce the next op.

        Returns None when exhausted, or a pair (op, gen') where op is an op
        dict (with at least :f; :process/:time filled in from ctx when
        missing) or PENDING when nothing can be emitted yet."""
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: dict) -> "Generator":
        """Feed back an event (invoke/ok/fail/info).  Default: ignore."""
        return self


def fill_op(op: dict, ctx: Context) -> Optional[dict]:
    """Complete an op template from the context (reference `fill-in-op`):
    assign a free process and the current time where missing.  Returns None
    if the op needs a process and none is free."""
    out = dict(op)
    out.setdefault("type", "invoke")
    if out.get("process") is None:
        p = ctx.some_free_process()
        if p is None:
            return None
        out["process"] = p
    elif out["process"] not in ctx.free_processes():
        return None
    if out.get("time") is None:
        out["time"] = ctx.time
    return out


def lift(x: Any) -> Optional["Generator"]:
    """Lift a spec into a Generator.

    - None           -> None (exhausted)
    - Generator      -> itself
    - dict           -> one-shot op template
    - callable       -> infinite op factory, called as f(test, ctx) or f()
    - list/tuple     -> run elements in order
    """
    if x is None or isinstance(x, Generator):
        return x
    if isinstance(x, dict):
        return _MapGen(x)
    if callable(x):
        return _FnGen(x)
    if isinstance(x, (list, tuple)):
        return _SeqGen([e for e in x])
    raise TypeError(f"can't lift {type(x).__name__} to a generator")


def next_op(gen: Optional[Generator], test: dict, ctx: Context) -> OpResult:
    """op() on a possibly-exhausted generator."""
    if gen is None:
        return None
    return gen.op(test, ctx)


def gen_update(gen: Optional[Generator], test: dict, ctx: Context,
               event: dict) -> Optional[Generator]:
    if gen is None:
        return None
    return gen.update(test, ctx, event)


# ---------------------------------------------------------------------------
# Lifted primitives


class _MapGen(Generator):
    """A dict yields exactly one op (itself), then is exhausted — matching
    the reference, where infinite streams come from fns or `repeat`."""

    def __init__(self, template: dict):
        self.template = template

    def op(self, test, ctx):
        filled = fill_op(self.template, ctx)
        if filled is None:
            return (PENDING, self)
        return (filled, None)

    def __repr__(self):
        return f"MapGen({self.template!r})"


class _FnGen(Generator):
    """A function is an infinite generator: each op() calls f(test, ctx)
    (or f()) for an op template.  If f returns a non-dict spec, that spec
    runs to exhaustion before f is called again."""

    def __init__(self, f: Callable):
        self.f = f
        # Call f(test, ctx) whenever f *can take* two positionals (required
        # or defaulted), like the reference's 2-arity preference; f() only
        # when it can't.
        try:
            sig = inspect.signature(f)
            params = list(sig.parameters.values())
            can_take_2 = (
                any(p.kind is p.VAR_POSITIONAL for p in params)
                or len([p for p in params if p.kind in
                        (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]) >= 2)
            self._nullary = not can_take_2
        except (TypeError, ValueError):  # builtins without signatures
            self._nullary = False

    def _call(self, test, ctx):
        if self._nullary:
            return self.f()
        return self.f(test, ctx)

    def op(self, test, ctx):
        if ctx.some_free_process() is None:
            return (PENDING, self)
        x = self._call(test, ctx)
        if x is None:
            return None
        if isinstance(x, dict):
            filled = fill_op(x, ctx)
            if filled is None:
                return (PENDING, self)
            return (filled, self)
        sub = lift(x)
        return next_op(_SeqGen([sub, self]), test, ctx)


class _SeqGen(Generator):
    """Runs element generators in order; updates go to the active element."""

    def __init__(self, elements: Sequence[Any]):
        self.elements: List[Any] = list(elements)

    def op(self, test, ctx):
        elems = self.elements
        while elems:
            head = lift(elems[0])
            if head is None:
                elems = elems[1:]
                continue
            res = head.op(test, ctx)
            if res is None:
                elems = elems[1:]
                continue
            op_, head2 = res
            rest = [head2] + list(elems[1:]) if head2 is not None else list(elems[1:])
            return (op_, _SeqGen(rest) if rest else None)
        return None

    def update(self, test, ctx, event):
        if not self.elements:
            return self
        head = lift(self.elements[0])
        if head is None:
            return _SeqGen(self.elements[1:]).update(test, ctx, event)
        head2 = head.update(test, ctx, event)
        return _SeqGen([head2] + list(self.elements[1:]))


# ---------------------------------------------------------------------------
# Scheduling combinators


class _Stagger(Generator):
    """Ops spaced by uniform random delays averaging dt (reference
    `stagger`).  The schedule is tracked against the context clock, so slow
    clients don't cause a burst of catch-up ops."""

    def __init__(self, dt_ns: int, gen: Any, next_time: Optional[int] = None,
                 rng: Optional[_random.Random] = None):
        self.dt_ns = dt_ns
        self.gen = lift(gen)
        self.next_time = next_time
        self.rng = rng

    def _rand(self) -> float:
        return (self.rng or _random).random()

    def op(self, test, ctx):
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        nt = self.next_time if self.next_time is not None else ctx.time
        if is_pending(op_):
            return (op_, _Stagger(self.dt_ns, gen2, nt, self.rng))
        op_ = dict(op_)
        op_["time"] = max(op_.get("time", 0) or 0, nt)
        nt2 = nt + int(self._rand() * 2 * self.dt_ns)
        return (op_, _Stagger(self.dt_ns, gen2, nt2, self.rng))

    def update(self, test, ctx, event):
        return _Stagger(self.dt_ns, gen_update(self.gen, test, ctx, event),
                        self.next_time, self.rng)


def stagger(dt_seconds: float, gen: Any,
            rng: Optional[_random.Random] = None) -> Generator:
    return _Stagger(_s_to_ns(dt_seconds), gen, rng=rng)


class _Delay(Generator):
    """Ops spaced by exactly dt (reference `delay`)."""

    def __init__(self, dt_ns: int, gen: Any, next_time: Optional[int] = None):
        self.dt_ns = dt_ns
        self.gen = lift(gen)
        self.next_time = next_time

    def op(self, test, ctx):
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        nt = self.next_time if self.next_time is not None else ctx.time
        if is_pending(op_):
            return (op_, _Delay(self.dt_ns, gen2, nt))
        op_ = dict(op_)
        op_["time"] = max(op_.get("time", 0) or 0, nt)
        return (op_, _Delay(self.dt_ns, gen2, nt + self.dt_ns))

    def update(self, test, ctx, event):
        return _Delay(self.dt_ns, gen_update(self.gen, test, ctx, event),
                      self.next_time)


def delay(dt_seconds: float, gen: Any) -> Generator:
    return _Delay(_s_to_ns(dt_seconds), gen)


class _Sleep(Generator):
    """Emits nothing for dt, then is exhausted (reference `sleep`)."""

    def __init__(self, dt_ns: int, end: Optional[int] = None):
        self.dt_ns = dt_ns
        self.end = end

    def op(self, test, ctx):
        end = self.end if self.end is not None else ctx.time + self.dt_ns
        if ctx.time >= end:
            return None
        return (pending_until(end), _Sleep(self.dt_ns, end))


def sleep(dt_seconds: float) -> Generator:
    return _Sleep(_s_to_ns(dt_seconds))


class _TimeLimit(Generator):
    """Passes ops through until dt has elapsed from first op() call
    (reference `time-limit`)."""

    def __init__(self, dt_ns: int, gen: Any, deadline: Optional[int] = None):
        self.dt_ns = dt_ns
        self.gen = lift(gen)
        self.deadline = deadline

    def op(self, test, ctx):
        deadline = self.deadline if self.deadline is not None \
            else ctx.time + self.dt_ns
        if ctx.time >= deadline:
            return None
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        if not is_pending(op_) and (op_.get("time") or 0) >= deadline:
            return None
        return (op_, _TimeLimit(self.dt_ns, gen2, deadline))

    def update(self, test, ctx, event):
        return _TimeLimit(self.dt_ns, gen_update(self.gen, test, ctx, event),
                          self.deadline)


def time_limit(dt_seconds: float, gen: Any) -> Generator:
    return _TimeLimit(_s_to_ns(dt_seconds), gen)


# ---------------------------------------------------------------------------
# Cardinality combinators


class _Limit(Generator):
    def __init__(self, remaining: int, gen: Any):
        self.remaining = remaining
        self.gen = lift(gen)

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        n = self.remaining if is_pending(op_) else self.remaining - 1
        return (op_, _Limit(n, gen2))

    def update(self, test, ctx, event):
        return _Limit(self.remaining, gen_update(self.gen, test, ctx, event))


def limit(n: int, gen: Any) -> Generator:
    return _Limit(n, gen)


def once(gen: Any) -> Generator:
    return _Limit(1, gen)


class _Repeat(Generator):
    """Re-lifts the original spec each time it exhausts; n cycles or
    forever (reference `repeat` / `cycle`)."""

    def __init__(self, spec: Any, n: Optional[int] = None,
                 active: Optional[Generator] = None):
        self.spec = spec
        self.n = n
        self.active = active

    def op(self, test, ctx):
        active, n = self.active, self.n
        for _ in range(2):  # current cycle, then at most one fresh cycle
            if active is None:
                if n is not None:
                    if n <= 0:
                        return None
                    n = n - 1
                active = lift(self.spec)
            res = next_op(active, test, ctx)
            if res is not None:
                op_, gen2 = res
                return (op_, _Repeat(self.spec, n, gen2))
            active = None
        return None

    def update(self, test, ctx, event):
        return _Repeat(self.spec, self.n,
                       gen_update(self.active, test, ctx, event))


def repeat(spec: Any, n: Optional[int] = None) -> Generator:
    return _Repeat(spec, n)


def cycle(spec: Any) -> Generator:
    return _Repeat(spec, None)


# ---------------------------------------------------------------------------
# Composition combinators


def then(first: Any, then_gen: Any) -> Generator:
    """first, then then_gen (reference `then`, argument order normalized)."""
    return _SeqGen([first, then_gen])


class _Mix(Generator):
    """Random uniform mixture; updates broadcast to all (reference `mix`)."""

    def __init__(self, gens: Sequence[Any], rng: Optional[_random.Random] = None):
        self.gens = [lift(g) for g in gens]
        self.rng = rng

    def op(self, test, ctx):
        gens = [g for g in self.gens if g is not None]
        rng = self.rng or _random
        while gens:
            i = rng.randrange(len(gens))
            res = gens[i].op(test, ctx)
            if res is None:
                gens = gens[:i] + gens[i + 1:]
                continue
            op_, gen2 = res
            out = list(gens)
            if gen2 is None:
                out = gens[:i] + gens[i + 1:]
            else:
                out[i] = gen2
            return (op_, _Mix(out, self.rng) if out else None)
        return None

    def update(self, test, ctx, event):
        return _Mix([gen_update(g, test, ctx, event) for g in self.gens
                     if g is not None], self.rng)


def mix(gens: Sequence[Any], rng: Optional[_random.Random] = None) -> Generator:
    return _Mix(gens, rng)


class _Any(Generator):
    """Emits the soonest op offered by any sub-generator (reference `any`)."""

    def __init__(self, gens: Sequence[Any]):
        self.gens = [lift(g) for g in gens]

    def op(self, test, ctx):
        best = None  # (time, i, op, gen2)
        pend = None
        alive = False
        out = list(self.gens)
        for i, g in enumerate(self.gens):
            res = next_op(g, test, ctx)
            if res is None:
                out[i] = None
                continue
            alive = True
            op_, gen2 = res
            if is_pending(op_):
                # a consumed pending is a no-op, so keeping the successor is
                # safe — and necessary: e.g. _Sleep fixes its end time in its
                # successor, which must not be recomputed every poll
                out[i] = gen2
                if pend is None or (op_.time or 0) < (pend.time or 0):
                    pend = op_
                continue
            t = op_.get("time") or 0
            if best is None or t < best[0]:
                best = (t, i, op_, gen2)
        if best is not None:
            _, i, op_, gen2 = best
            # build on `out`, not self.gens: pending successors recorded in
            # out (e.g. _Sleep's fixed end time) must survive this poll
            chosen = list(out)
            chosen[i] = gen2
            return (op_, _Any(chosen))
        if alive:
            return (pend or PENDING, _Any(out))
        return None

    def update(self, test, ctx, event):
        return _Any([gen_update(g, test, ctx, event) for g in self.gens])


def any_gen(*gens: Any) -> Generator:
    return _Any(gens)


class _FlipFlop(Generator):
    """Alternates ops between two generators (reference `flip-flop`);
    exhausted when either side is."""

    def __init__(self, a: Any, b: Any, turn: int = 0):
        self.sides = [lift(a), lift(b)]
        self.turn = turn

    def op(self, test, ctx):
        g = self.sides[self.turn]
        res = next_op(g, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        sides = list(self.sides)
        sides[self.turn] = gen2
        turn = self.turn if is_pending(op_) else 1 - self.turn
        return (op_, _FlipFlop(sides[0], sides[1], turn))

    def update(self, test, ctx, event):
        return _FlipFlop(gen_update(self.sides[0], test, ctx, event),
                         gen_update(self.sides[1], test, ctx, event),
                         self.turn)


def flip_flop(a: Any, b: Any) -> Generator:
    return _FlipFlop(a, b)


# ---------------------------------------------------------------------------
# Predicates & transforms


class _Filter(Generator):
    def __init__(self, pred: Callable[[dict], bool], gen: Any):
        self.pred = pred
        self.gen = lift(gen)

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = next_op(gen, test, ctx)
            if res is None:
                return None
            op_, gen2 = res
            if is_pending(op_) or self.pred(op_):
                return (op_, _Filter(self.pred, gen2))
            gen = gen2

    def update(self, test, ctx, event):
        return _Filter(self.pred, gen_update(self.gen, test, ctx, event))


def filter_gen(pred: Callable[[dict], bool], gen: Any) -> Generator:
    return _Filter(pred, gen)


class _FMap(Generator):
    """Transforms emitted ops with f (reference `map`/`f-map`)."""

    def __init__(self, f: Callable[[dict], dict], gen: Any):
        self.f = f
        self.gen = lift(gen)

    def op(self, test, ctx):
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        if not is_pending(op_):
            op_ = self.f(dict(op_))
        return (op_, _FMap(self.f, gen2))

    def update(self, test, ctx, event):
        return _FMap(self.f, gen_update(self.gen, test, ctx, event))


def f_map(f: Callable[[dict], dict], gen: Any) -> Generator:
    return _FMap(f, gen)


class _UntilOk(Generator):
    """Runs gen until an :ok completion is observed (reference `until-ok`)."""

    def __init__(self, gen: Any, done: bool = False):
        self.gen = lift(gen)
        self.done = done

    def op(self, test, ctx):
        if self.done:
            return None
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        return (op_, _UntilOk(gen2, False))

    def update(self, test, ctx, event):
        done = self.done or event.get("type") == "ok"
        return _UntilOk(gen_update(self.gen, test, ctx, event), done)


def until_ok(gen: Any) -> Generator:
    return _UntilOk(gen)


# ---------------------------------------------------------------------------
# Thread-restriction combinators


class _OnThreads(Generator):
    """Restricts a generator to the threads matching pred; both ops and
    updates see (and only see) the restricted context (reference
    `on-threads`)."""

    def __init__(self, pred: Callable[[Any], bool], gen: Any):
        self.pred = pred
        self.gen = lift(gen)

    def op(self, test, ctx):
        sub = ctx.restrict(self.pred)
        if not sub.workers:
            return None
        res = next_op(self.gen, test, sub)
        if res is None:
            return None
        op_, gen2 = res
        return (op_, _OnThreads(self.pred, gen2))

    def update(self, test, ctx, event):
        p = event.get("process")
        try:
            t = ctx.thread_for_process(p)
        except KeyError:
            return self
        if not self.pred(t):
            return self
        sub = ctx.restrict(self.pred)
        return _OnThreads(self.pred, gen_update(self.gen, test, sub, event))


def on_threads(pred: Callable[[Any], bool], gen: Any) -> Generator:
    return _OnThreads(pred, gen)


def clients(gen: Any) -> Generator:
    """Restrict to client (integer) threads (reference `clients`)."""
    return _OnThreads(lambda t: isinstance(t, int), gen)


def nemesis(gen: Any) -> Generator:
    """Restrict to the nemesis thread (reference `nemesis`)."""
    return _OnThreads(lambda t: t == NEMESIS_THREAD, gen)


def reserve(*args: Any) -> Generator:
    """reserve(n1, gen1, n2, gen2, ..., default): the first n1 client
    threads run gen1, the next n2 run gen2, ..., remaining client threads
    run the default (reference `reserve`)."""
    if len(args) % 2 != 1:
        raise ValueError("reserve needs (n, gen)* pairs plus a default")
    pairs = list(zip(args[:-1:2], args[1:-1:2]))
    default = args[-1]
    gens = []
    lo = 0
    for n, g in pairs:
        hi = lo + n
        gens.append(_OnThreads(
            (lambda lo=lo, hi=hi: lambda t: isinstance(t, int) and lo <= t < hi)(),
            g))
        lo = hi
    cut = lo
    gens.append(_OnThreads(lambda t: isinstance(t, int) and t >= cut, default))
    return _Any(gens)


class _Synchronize(Generator):
    """Barriers the start of gen until every thread in ctx is free
    (reference `synchronize`)."""

    def __init__(self, gen: Any, started: bool = False):
        self.gen = lift(gen)
        self.started = started

    def op(self, test, ctx):
        if not self.started and ctx.free_count() < len(ctx.workers):
            return (PENDING, self)
        res = next_op(self.gen, test, ctx)
        if res is None:
            return None
        op_, gen2 = res
        return (op_, _Synchronize(gen2, True))

    def update(self, test, ctx, event):
        return _Synchronize(gen_update(self.gen, test, ctx, event),
                            self.started)


def synchronize(gen: Any) -> Generator:
    return _Synchronize(gen)


def phases(*gens: Any) -> Generator:
    """Each phase starts only after all threads finish the previous one
    (reference `phases`)."""
    return _SeqGen([_Synchronize(g) for g in gens])


class _EachThread(Generator):
    """Every thread runs its own fresh copy of the spec (reference
    `each-thread`)."""

    def __init__(self, spec: Any, copies: Optional[dict] = None):
        self.spec = spec
        self.copies = copies  # thread -> Generator|None; None once exhausted

    def _copies_for(self, ctx) -> dict:
        if self.copies is not None:
            return self.copies
        return {t: lift(self.spec) for t in ctx.all_threads()}

    def op(self, test, ctx):
        copies = dict(self._copies_for(ctx))
        alive = False
        pend = None
        for t in ctx._sorted_free():
            g = copies.get(t, "missing")
            if g == "missing":
                g = copies[t] = lift(self.spec)
            if g is None:
                continue
            sub = ctx.restrict(lambda x, t=t: x == t)
            res = g.op(test, sub)
            if res is None:
                copies[t] = None
                continue
            op_, gen2 = res
            if is_pending(op_):
                # keep the pending successor: e.g. _Sleep fixes its end time
                # there, and it must not be recomputed on the next poll
                copies[t] = gen2
                alive = True
                if pend is None or (op_.time or 0) < (pend.time or 0):
                    pend = op_
                continue
            copies[t] = gen2
            return (op_, _EachThread(self.spec, copies))
        if any(g is not None for g in copies.values()) and (
                alive or ctx.free_count() < len(ctx.workers)):
            return (pend or PENDING, _EachThread(self.spec, copies))
        return None

    def update(self, test, ctx, event):
        if self.copies is None:
            return self
        p = event.get("process")
        try:
            t = ctx.thread_for_process(p)
        except KeyError:
            return self
        g = self.copies.get(t)
        if g is None:
            return self
        copies = dict(self.copies)
        sub = ctx.restrict(lambda x: x == t)
        copies[t] = g.update(test, sub, event)
        return _EachThread(self.spec, copies)


def each_thread(spec: Any) -> Generator:
    return _EachThread(spec)


# ---------------------------------------------------------------------------
# Observability


class _Log(Generator):
    """Logs a message when asked for an op, then is exhausted (reference
    `log`)."""

    def __init__(self, msg: str):
        self.msg = msg

    def op(self, test, ctx):
        logger.info(self.msg)
        return None


def log(msg: str) -> Generator:
    return _Log(msg)


class _Trace(Generator):
    """Logs every op/update flowing through (reference `trace`)."""

    def __init__(self, name: str, gen: Any):
        self.name = name
        self.gen = lift(gen)

    def op(self, test, ctx):
        res = next_op(self.gen, test, ctx)
        logger.debug("trace %s op -> %r", self.name,
                     None if res is None else res[0])
        if res is None:
            return None
        op_, gen2 = res
        return (op_, _Trace(self.name, gen2))

    def update(self, test, ctx, event):
        logger.debug("trace %s update <- %r", self.name, event)
        return _Trace(self.name, gen_update(self.gen, test, ctx, event))


def trace(name: str, gen: Any) -> Generator:
    return _Trace(name, gen)
