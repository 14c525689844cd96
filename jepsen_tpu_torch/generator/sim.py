"""Pure generator simulation (the port's copy of
`jepsen_tpu/generator/sim.py`).

Equivalent of the reference's generator test harness (SURVEY.md §4: drives
generators with a fake context and a perfect simulated clock, asserting on
exact op sequences).  No threads: every dispatched invoke completes after a
fixed simulated latency, and the whole run is deterministic.

Also serves as the reference semantics for the real interpreter
(`generator/interpreter.py`): both follow the same dispatch/update rules,
so interpreter behavior can be differentially tested against this.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, List, Optional

from jepsen_tpu_torch.generator import core as g
from jepsen_tpu_torch.generator.context import context


def simulate(gen: Any, test: Optional[dict] = None, *,
             latency_ns: int = 10_000_000,
             complete: Optional[Callable[[dict], dict]] = None,
             max_ops: int = 100_000) -> List[dict]:
    """Run a generator to exhaustion under a simulated perfect cluster.

    Returns the full event list (invokes and completions, time-ordered).
    `complete` maps an invoke op to its completion (default: same op with
    type "ok")."""
    test = test or {"concurrency": 2}
    gen = g.lift(gen)
    ctx = context(test)
    concurrency = int(test.get("concurrency", 1))
    events: List[dict] = []
    in_flight: list = []  # heap of (time, seq, thread, completion-op)
    seq = 0
    steps = 0

    def apply_completion() -> None:
        nonlocal ctx, gen
        t, _, thread, comp = heapq.heappop(in_flight)
        ctx = ctx.with_time(max(ctx.time, t))
        comp = dict(comp, time=ctx.time)
        events.append(comp)
        ctx = ctx.free_thread(thread)
        if comp.get("type") == "info" and isinstance(comp.get("process"), int):
            ctx = ctx.with_next_process(thread, concurrency)
        gen = g.gen_update(gen, test, ctx, comp)

    while len(events) < max_ops:
        steps += 1
        if steps > 10 * max_ops + 1000:
            raise RuntimeError(
                f"simulation stuck: {steps} steps for {len(events)} events")
        res = g.next_op(gen, test, ctx)
        if res is None:
            if in_flight:
                apply_completion()
                continue
            break
        op_, gen2 = res
        if g.is_pending(op_):
            if in_flight and (op_.time is None
                              or in_flight[0][0] <= op_.time):
                gen = gen2
                apply_completion()
                continue
            if op_.time is not None:
                ctx = ctx.with_time(max(ctx.time + 1, op_.time))
                gen = gen2
                continue
            if in_flight:
                gen = gen2
                apply_completion()
                continue
            break  # deadlocked: pending forever with nothing in flight
        # completions due before this op's scheduled time go first
        t_op = op_.get("time") or ctx.time
        if in_flight and in_flight[0][0] <= t_op:
            apply_completion()
            continue
        gen = gen2
        ctx = ctx.with_time(max(ctx.time, t_op))
        invoke = dict(op_, type="invoke", time=ctx.time)
        events.append(invoke)
        thread = ctx.thread_for_process(invoke["process"])
        ctx = ctx.busy_thread(thread)
        gen = g.gen_update(gen, test, ctx, invoke)
        comp = complete(invoke) if complete else dict(invoke, type="ok")
        seq += 1
        heapq.heappush(in_flight,
                       (ctx.time + latency_ns, seq, thread, comp))
    else:
        raise RuntimeError(f"simulation exceeded {max_ops} events")
    return events


def invokes(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("type") == "invoke"]


def completions(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("type") != "invoke"]
