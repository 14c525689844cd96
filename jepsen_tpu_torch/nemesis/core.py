"""Nemesis protocol, partitioners, and process-fault nemeses (the port's
copy of `jepsen_tpu/nemesis/core.py`).

Equivalent of the reference's `jepsen/nemesis.clj` (SURVEY.md §2.1):
the `Nemesis` protocol (`setup`/`invoke`/`teardown`), the partitioner
nemesis with its grudge functions (`complete_grudge`, `bridge`,
`majorities_ring`, `partition_halves`, `partition_random_halves`,
`partition_random_node`), `compose` for routing ops to sub-nemeses,
`node_start_stopper` and `hammer_time` (SIGSTOP) process faults.

Grudges are maps {dst_node: set-of-src-nodes-to-block}, applied by
`net.drop_all`; a partition op's value carries the grudge, and `stop`
heals.
"""

from __future__ import annotations

import random as _random
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from jepsen_tpu_torch import control
from jepsen_tpu_torch import net as net_
from jepsen_tpu_torch.control import on_nodes
from jepsen_tpu_torch.utils.core import majority


def _net(test: dict) -> net_.Net:
    """The test's Net, defaulting to the noop net: nemeses must work on
    test maps without a ``"net"`` key (`core.noop_test` now carries
    one, but hand-built maps routinely don't — a KeyError here used to
    kill Partitioner.setup/invoke/teardown)."""
    return test.get("net") or net_.noop


class Nemesis:
    """Base nemesis: a single-threaded fault client
    (reference `nemesis/Nemesis`)."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply a fault op; return its completion."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass


class Noop(Nemesis):
    """Does nothing (reference `nemesis/noop`)."""

    def invoke(self, test, op):
        return dict(op, type="info")


# ---------------------------------------------------------------------------
# Grudges: {dst: set(srcs blocked at dst)}

Grudge = Dict[str, Set[str]]


def complete_grudge(components: Sequence[Sequence[str]]) -> Grudge:
    """Each component can only see itself (reference
    `nemesis/complete-grudge`)."""
    grudge: Grudge = {}
    all_nodes = [n for comp in components for n in comp]
    for comp in components:
        others = set(all_nodes) - set(comp)
        for node in comp:
            grudge[node] = set(others)
    return grudge


def bridge(nodes: Sequence[str]) -> Grudge:
    """Splits nodes into two halves joined only by one bridge node
    (reference `nemesis/bridge`)."""
    nodes = list(nodes)
    mid = len(nodes) // 2
    b = nodes[mid]
    left, right = nodes[:mid], nodes[mid + 1:]
    grudge: Grudge = {b: set()}
    for n in left:
        grudge[n] = set(right)
    for n in right:
        grudge[n] = set(left)
    return grudge


def split_one(nodes: Sequence[str],
              node: Optional[str] = None,
              rng: Optional[_random.Random] = None) -> List[List[str]]:
    """Isolate one node (given or random) from the rest."""
    nodes = list(nodes)
    rng = rng or _random
    node = node if node is not None else rng.choice(nodes)
    return [[node], [n for n in nodes if n != node]]


def majorities_ring(nodes: Sequence[str],
                    rng: Optional[_random.Random] = None) -> Grudge:
    """Every node sees a majority, but no two majorities agree: node i
    sees itself and the (m-1)//2 neighbors on each side of a shuffled
    ring (reference `nemesis/majorities-ring`)."""
    nodes = list(nodes)
    rng = rng or _random
    ring = list(nodes)
    rng.shuffle(ring)
    n = len(ring)
    m = majority(n)
    half = (m - 1) // 2
    grudge: Grudge = {}
    for i, node in enumerate(ring):
        visible = {ring[(i + d) % n] for d in range(-half, half + 1)}
        grudge[node] = set(ring) - visible
    return grudge


def invert_grudge(nodes: Sequence[str], visible: Dict[str, Set[str]]
                  ) -> Grudge:
    """Turn a visibility map into a grudge."""
    return {n: set(nodes) - set(visible.get(n, ())) - {n} for n in nodes}


# Grudge-producing strategies for the partitioner.  Each takes the test's
# node list and returns a grudge.

def partition_halves(nodes: Sequence[str]) -> Grudge:
    """First half | second half (reference `nemesis/partition-halves`:
    used via `(partitioner (comp complete-grudge split-one ...))`)."""
    nodes = list(nodes)
    mid = (len(nodes) + 1) // 2
    return complete_grudge([nodes[:mid], nodes[mid:]])


def partition_random_halves(nodes: Sequence[str],
                            rng: Optional[_random.Random] = None) -> Grudge:
    nodes = list(nodes)
    rng = rng or _random
    shuffled = list(nodes)
    rng.shuffle(shuffled)
    mid = (len(shuffled) + 1) // 2
    return complete_grudge([shuffled[:mid], shuffled[mid:]])


def partition_random_node(nodes: Sequence[str],
                          rng: Optional[_random.Random] = None) -> Grudge:
    return complete_grudge(split_one(nodes, rng=rng))


def partition_majorities_ring(nodes: Sequence[str],
                              rng: Optional[_random.Random] = None
                              ) -> Grudge:
    return majorities_ring(nodes, rng=rng)


class Partitioner(Nemesis):
    """Applies partitions on `start-partition` ops and heals on
    `stop-partition` (reference `nemesis/partitioner`).

    `grudge_fn(nodes) -> grudge` picks the partition when the op's value
    doesn't already carry one.  The completion's value describes the
    applied grudge so the history records what actually happened.
    """

    def __init__(self, grudge_fn: Optional[Callable] = None, *,
                 start_f: str = "start-partition",
                 stop_f: str = "stop-partition"):
        self.grudge_fn = grudge_fn or partition_random_halves
        self.start_f = start_f
        self.stop_f = stop_f

    def setup(self, test):
        _net(test).heal(test)
        return self

    def invoke(self, test, op):
        if op["f"] == self.start_f:
            grudge = op.get("value") or self.grudge_fn(test["nodes"])
            net = _net(test)
            if hasattr(net, "drop_all"):
                net.drop_all(test, grudge)
            else:
                for dst, srcs in grudge.items():
                    for src in srcs:
                        net.drop_(test, src, dst)
            return dict(op, type="info",
                        value={d: sorted(s) for d, s in grudge.items()})
        elif op["f"] == self.stop_f:
            _net(test).heal(test)
            return dict(op, type="info", value="network healed")
        raise ValueError(f"partitioner can't handle op f={op['f']!r}")

    def teardown(self, test):
        _net(test).heal(test)


def partitioner(grudge_fn: Optional[Callable] = None, **kw) -> Nemesis:
    return Partitioner(grudge_fn, **kw)


class Compose(Nemesis):
    """Routes ops to sub-nemeses by an f-dispatch map (reference
    `nemesis/compose`).  Keys are sets/sequences of op :f values (or a
    predicate); values are nemeses."""

    def __init__(self, dispatch: Dict[Any, Nemesis]):
        self.dispatch = [(set(fs) if not callable(fs) else fs, nem)
                         for fs, nem in dispatch.items()]

    def _route(self, f) -> Nemesis:
        for fs, nem in self.dispatch:
            if (fs(f) if callable(fs) else f in fs):
                return nem
        raise ValueError(f"no nemesis handles op f={f!r}")

    def setup(self, test):
        self.dispatch = [(fs, nem.setup(test)) for fs, nem in self.dispatch]
        return self

    def invoke(self, test, op):
        return self._route(op["f"]).invoke(test, op)

    def teardown(self, test):
        for _, nem in self.dispatch:
            nem.teardown(test)


def compose(dispatch: Dict[Any, Nemesis]) -> Nemesis:
    # dict keys must be hashable: accept tuples/frozensets/callables
    return Compose(dispatch)


class NodeStartStopper(Nemesis):
    """On `start_f`, runs `stop_fn` on targeted nodes; on `stop_f`, runs
    `start_fn` on the affected ones (reference
    `nemesis/node-start-stopper`).  `targeter(test, nodes) -> nodes`."""

    def __init__(self, targeter: Callable, stop_fn: Callable,
                 start_fn: Callable, *, start_f: str = "start",
                 stop_f: str = "stop"):
        self.targeter = targeter
        self.stop_fn = stop_fn
        self.start_fn = start_fn
        self.start_f = start_f
        self.stop_f = stop_f
        self.affected: List[str] = []

    def invoke(self, test, op):
        if op["f"] == self.start_f:
            targets = list(self.targeter(test, test["nodes"]))
            res = on_nodes(test, self.stop_fn, nodes=targets)
            self.affected = targets
            return dict(op, type="info", value=res)
        elif op["f"] == self.stop_f:
            res = on_nodes(test, self.start_fn,
                           nodes=self.affected or test["nodes"])
            self.affected = []
            return dict(op, type="info", value=res)
        raise ValueError(f"can't handle op f={op['f']!r}")

    def teardown(self, test):
        if self.affected:
            on_nodes(test, self.start_fn, nodes=self.affected)
            self.affected = []


def node_start_stopper(targeter, stop_fn, start_fn, **kw) -> Nemesis:
    return NodeStartStopper(targeter, stop_fn, start_fn, **kw)


def hammer_time(process_pattern: str,
                targeter: Optional[Callable] = None) -> Nemesis:
    """SIGSTOP/SIGCONT a process by pgrep pattern on targeted nodes
    (reference `nemesis/hammer-time`)."""
    targeter = targeter or (lambda test, nodes: [_random.choice(nodes)])

    def _signal_all(sig: str) -> str:
        # not pkill: the invoking shell's cmdline contains the pattern
        p = control.escape(process_pattern)
        return (f"for p in $(pgrep -f -- {p}); do "
                f'[ "$p" != "$$" ] && [ "$p" != "$PPID" ] '
                f"&& kill -{sig} $p 2>/dev/null; done; true")

    def stop(test, node):
        control.exec_("bash", "-c", _signal_all("STOP"))
        return "paused"

    def start(test, node):
        control.exec_("bash", "-c", _signal_all("CONT"))
        return "resumed"

    return NodeStartStopper(targeter, stop, start,
                            start_f="start-pause", stop_f="stop-pause")


class TrafficShaper(Nemesis):
    """Drives the Net traffic-shaping protocol (the `net.py` methods
    nothing drove before this): ``slow``/``flaky``/``shape`` ops apply
    latency/loss/raw-netem behaviors cluster-wide; ``fast`` heals.

    Op values:
      slow  — kwargs dict for `Net.slow` (mean_ms, variance_ms,
              distribution); None for defaults
      flaky — kwargs dict for `Net.flaky` (loss_pct, correlation_pct)
      shape — raw netem behavior list, e.g. ["delay", "100ms",
              "loss", "5%"]
      fast  — ignored

    The completion's value echoes what was applied so the history
    records the actual shaping (same contract as the partitioner's
    grudge echo).
    """

    def __init__(self, *, fast_f: str = "fast"):
        self.fast_f = fast_f

    def setup(self, test):
        _net(test).fast(test)
        return self

    def invoke(self, test, op):
        net = _net(test)
        f = op["f"]
        if f == "slow":
            kw = dict(op.get("value") or {})
            net.slow(test, **kw)
            return dict(op, type="info", value=["slow", kw])
        if f == "flaky":
            kw = dict(op.get("value") or {})
            net.flaky(test, **kw)
            return dict(op, type="info", value=["flaky", kw])
        if f == "shape":
            behaviors = list(op.get("value") or ())
            if not behaviors:
                raise ValueError("shape op needs a netem behavior list")
            net.shape(test, behaviors)
            return dict(op, type="info", value=["shape", behaviors])
        if f == self.fast_f:
            net.fast(test)
            return dict(op, type="info", value="shaping removed")
        raise ValueError(f"traffic shaper can't handle op f={f!r}")

    def teardown(self, test):
        _net(test).fast(test)


def traffic_shaper(**kw) -> Nemesis:
    return TrafficShaper(**kw)
