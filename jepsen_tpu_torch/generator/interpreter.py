"""The concurrency engine (the port's copy of
`jepsen_tpu/generator/interpreter.py`).

Equivalent of the reference's `jepsen/generator/interpreter.clj` (SURVEY.md
§2.1, §3.4): one OS thread per client worker plus a nemesis worker; a
central loop polls the pure generator for ops, dispatches them to per-worker
queues, and feeds invocations and completions back through `gen.update`,
building the history.

Semantics mirrored exactly from the reference:
- op :time is the relative test clock (nanoseconds since run start);
- an op whose :time is in the future is held until then;
- a client exception or :info completion means the op's effect is unknown;
  the worker's process is considered crashed, its thread gets process
  p + concurrency, and its client is re-opened for the new process;
- the nemesis is driven as one more worker, never crashes, ops complete
  :info;
- workers survive client exceptions: the run always produces a history.

The pure simulator in `generator/sim.py` implements the same dispatch rules
with a virtual clock; the two are differentially tested.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.client import Client, invoke_with_errors
from jepsen_tpu_torch.generator import core as g
from jepsen_tpu_torch.generator.context import NEMESIS_THREAD, Context, context
from jepsen_tpu_torch.history.ops import History, Op, history
from jepsen_tpu_torch.utils.core import init_time_origin, relative_time_nanos

logger = logging.getLogger("jepsen.interpreter")

_STOP = object()
_TICK_S = 0.001  # poll granularity when pending with no wake time

#: the client-side chaos seam: a FaultPlan that
#: EXPLICITLY names this site (``sites`` or ``persistent``) injects
#: stalls (op latency) and crash-kind faults (``info`` completions —
#: the op's effect is unknown, the process is re-opened) into every
#: worker's invoke path.  Strictly opt-in: checker-chaos plans without
#: the site never touch the workload.
FAULT_SITE = "interpreter"

#: index-stream stride per worker: fire_at decisions hash the supplied
#: index, so giving each worker a disjoint arithmetic stream makes
#: injection deterministic per (seed, worker, local op) regardless of
#: thread interleaving
_FAULT_STRIDE = 1_000_003


class _ClientWorker:
    """Owns one thread + queue; opens a client per process incarnation."""

    def __init__(self, thread_id: int, test: dict, completions: queue.Queue,
                 plan=None):
        self.thread_id = thread_id
        self.test = test
        self.completions = completions
        self.plan = plan  # a FaultPlan targeting FAULT_SITE, or None
        self._n_ops = 0
        self.q: "queue.Queue" = queue.Queue()
        self.process: Optional[int] = None
        self.client: Optional[Client] = None
        self.thread = threading.Thread(
            target=self._run, name=f"jepsen-worker-{thread_id}", daemon=True)
        self.thread.start()

    def _node_for(self, process: int) -> Optional[str]:
        nodes = self.test.get("nodes") or []
        return nodes[process % len(nodes)] if nodes else None

    def _ensure_client(self, process: int) -> Client:
        if self.client is not None and self.process == process:
            return self.client
        if self.client is not None:
            try:
                self.client.close(self.test)
            except Exception as e:  # noqa: BLE001
                logger.warning("client close failed: %s", e)
        base: Client = self.test["client"]
        self.client = base.open(self.test, self._node_for(process))
        self.process = process
        return self.client

    def _run(self):
        while True:
            msg = self.q.get()
            if msg is _STOP:
                if self.client is not None:
                    try:
                        self.client.close(self.test)
                    except Exception as e:  # noqa: BLE001
                        logger.warning("client close failed: %s", e)
                return
            op: dict = msg
            comp = None
            if self.plan is not None:
                # stalls sleep here (client latency), crash kinds turn
                # the op into an :info completion without invoking the
                # client — indistinguishable from a client that died
                # mid-call, which is exactly what checkers must absorb
                from jepsen_tpu_torch.resilience.faults import FaultInjected

                idx = self.thread_id * _FAULT_STRIDE + self._n_ops
                self._n_ops += 1
                try:
                    self.plan.fire_at(FAULT_SITE, idx)
                except FaultInjected as e:
                    comp = dict(op, type="info",
                                error=f"fault-injected: {e.kind}")
            if comp is None:
                try:
                    client = self._ensure_client(op["process"])
                    comp = invoke_with_errors(client, self.test, op)
                except Exception as e:  # noqa: BLE001 — open() failed
                    comp = dict(op, type="info",
                                error=f"open failed: "
                                      f"{type(e).__name__}: {e}")
            self.completions.put((self.thread_id, comp))


class _NemesisWorker:
    """The nemesis is one more worker; its ops complete :info."""

    def __init__(self, test: dict, completions: queue.Queue):
        self.test = test
        self.completions = completions
        self.q: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(
            target=self._run, name="jepsen-nemesis", daemon=True)
        self.thread.start()

    def _run(self):
        nemesis = self.test.get("nemesis")
        while True:
            msg = self.q.get()
            if msg is _STOP:
                return
            op: dict = msg
            if nemesis is None:
                comp = dict(op, type="info", value=None)
            else:
                try:
                    comp = nemesis.invoke(self.test, op)
                    if not isinstance(comp, dict):
                        comp = dict(op, type="info", value=comp)
                except Exception as e:  # noqa: BLE001
                    comp = dict(op, type="info",
                                error=f"{type(e).__name__}: {e}")
            if comp.get("type") == "invoke":
                comp = dict(comp, type="info")
            self.completions.put((NEMESIS_THREAD, comp))


def run(test: dict) -> History:
    """Run the test's generator against its client and nemesis, returning
    the completed history (reference `generator.interpreter/run!`)."""
    concurrency = int(test.get("concurrency", 1))
    gen = g.lift(test.get("generator"))
    ctx = context(test)
    init_time_origin()

    from jepsen_tpu_torch.resilience import faults as faults_mod

    plan = faults_mod.plan_for(test)
    if plan is not None and not plan.targets_site(FAULT_SITE):
        plan = None

    completions: "queue.Queue" = queue.Queue()
    workers = {t: _ClientWorker(t, test, completions, plan=plan)
               for t in range(concurrency)}
    nemesis_worker = _NemesisWorker(test, completions)
    events: List[dict] = []
    in_flight = 0

    # the live-check op sink: every appended history event
    # (invokes AND completions, in history order) is offered to
    # test["op-sink"] — `verifier.client.LiveCheck.feed`, which only
    # buffers under a lock (its own sender thread does the I/O).  A
    # sink that raises is disarmed: live checking is an accelerant and
    # must never break the workload.
    sink = test.get("op-sink")

    def offer(ev: dict) -> None:
        nonlocal sink
        if sink is None:
            return
        try:
            sink(ev)
        except Exception as e:  # noqa: BLE001
            logger.warning("op-sink failed (%s); live feed disarmed", e)
            sink = None

    # telemetry: per-worker op counts accumulate in a local
    # dict on the (single-threaded) dispatch loop and flush to the
    # process registry once at the end — zero locking on the op path,
    # zero work when disabled
    telemetric = telemetry.enabled()
    op_counts: Dict[Tuple[Any, str], int] = {}
    stall_ns = 0

    def now() -> int:
        return relative_time_nanos()

    def apply_completion(thread, comp) -> None:
        nonlocal ctx, gen, in_flight
        comp = dict(comp, time=now())
        events.append(comp)
        offer(comp)
        if telemetric:
            k = (thread, comp.get("type"))
            op_counts[k] = op_counts.get(k, 0) + 1
        ctx = ctx.with_time(comp["time"]).free_thread(thread)
        if comp.get("type") == "info" and isinstance(comp.get("process"), int):
            ctx = ctx.with_next_process(thread, concurrency)
        gen = g.gen_update(gen, test, ctx, comp)
        in_flight -= 1

    def wait_for_completion(timeout_s: Optional[float]) -> bool:
        nonlocal ctx
        try:
            thread, comp = completions.get(timeout=timeout_s)
        except queue.Empty:
            ctx = ctx.with_time(now())
            return False
        apply_completion(thread, comp)
        return True

    try:
        while True:
            ctx = ctx.with_time(now())
            res = g.next_op(gen, test, ctx)
            if res is None:
                if in_flight > 0:
                    wait_for_completion(None)
                    continue
                break
            op_, gen2 = res
            if g.is_pending(op_):
                gen = gen2
                wake = ((op_.time - ctx.time) / 1e9
                        if op_.time is not None else _TICK_S)
                if telemetric:
                    t_stall = time.perf_counter_ns()
                    wait_for_completion(
                        min(max(wake, _TICK_S / 10), 10.0))
                    stall_ns += time.perf_counter_ns() - t_stall
                else:
                    wait_for_completion(min(max(wake, _TICK_S / 10), 10.0))
                continue
            t_op = op_.get("time") or ctx.time
            if t_op > ctx.time:
                # future op: completions arriving first must update the
                # generator before dispatch time
                if wait_for_completion((t_op - ctx.time) / 1e9):
                    continue
                ctx = ctx.with_time(now())
            gen = gen2
            invoke = dict(op_, type="invoke", time=ctx.time)
            events.append(invoke)
            offer(invoke)
            thread = ctx.thread_for_process(invoke["process"])
            if telemetric:
                k = (thread, "invoke")
                op_counts[k] = op_counts.get(k, 0) + 1
            ctx = ctx.busy_thread(thread)
            gen = g.gen_update(gen, test, ctx, invoke)
            in_flight += 1
            if thread == NEMESIS_THREAD:
                nemesis_worker.q.put(invoke)
            else:
                workers[thread].q.put(invoke)
    finally:
        for w in workers.values():
            w.q.put(_STOP)
        nemesis_worker.q.put(_STOP)
        for w in workers.values():
            w.thread.join(timeout=10)
        nemesis_worker.thread.join(timeout=10)
        if telemetric:
            _flush_metrics(concurrency, op_counts, stall_ns)

    ops = [Op.from_dict(e) for e in events]
    return history(ops)


def _flush_metrics(concurrency: int,
                   op_counts: Dict[Tuple[Any, str], int],
                   stall_ns: int) -> None:
    """Flush the dispatch loop's local tallies into the process-wide
    registry: ops invoked/ok/fail/info per worker + generator stall."""
    reg = telemetry.registry()
    for (thread, typ), n in sorted(op_counts.items(), key=lambda kv:
                                   (str(kv[0][0]), str(kv[0][1]))):
        worker = "nemesis" if thread == NEMESIS_THREAD else str(thread)
        reg.counter("interpreter-ops", worker=worker, type=typ).inc(n)
    reg.counter("generator-stall-ns").inc(stall_ns)
    reg.gauge("interpreter-concurrency").set(concurrency)
