"""Network manipulation: partitions and traffic shaping (the port's copy of
`jepsen_tpu/net.py`).

Equivalent of the reference's `jepsen/net.clj` + `net/proto.clj`
(SURVEY.md §2.1): the `Net` protocol — `drop_` (block src->dst), `heal`,
`slow`, `flaky`, `fast`, `shape` — with the default implementation
shelling out to **iptables** (partitions) and **tc qdisc netem**
(latency/loss/rate) on each node via the control plane, exactly the
binaries the reference drives.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import on_nodes


class Net:
    """Network manipulation protocol.  All methods take the full test map
    (for nodes/remote) and act cluster-wide unless given src/dst."""

    def drop_(self, test: dict, src: str, dst: str) -> None:
        """Block traffic from src to dst (on dst's side)."""
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        """Remove all partitions."""
        raise NotImplementedError

    def slow(self, test: dict, *, mean_ms: float = 50.0,
             variance_ms: float = 10.0,
             distribution: str = "normal") -> None:
        """Add latency to all node links."""
        raise NotImplementedError

    def flaky(self, test: dict, *, loss_pct: float = 20.0,
              correlation_pct: float = 75.0) -> None:
        """Introduce packet loss."""
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        """Remove traffic shaping (undo slow/flaky/shape)."""
        raise NotImplementedError

    def shape(self, test: dict, behaviors: Sequence[str]) -> None:
        """Apply raw netem behaviors, e.g. ["delay", "100ms", "loss", "5%"]."""
        raise NotImplementedError


class NoopNet(Net):
    def drop_(self, test, src, dst):
        pass

    def heal(self, test):
        pass

    def slow(self, test, **kw):
        pass

    def flaky(self, test, **kw):
        pass

    def fast(self, test):
        pass

    def shape(self, test, behaviors):
        pass


noop = NoopNet()


class IptablesNet(Net):
    """The reference's default `net/iptables` impl: DROP rules on the
    receiving node; netem on eth for shaping."""

    def __init__(self, interface: str = "eth0", chain: str = "INPUT"):
        self.interface = interface
        self.chain = chain

    def drop_(self, test, src, dst):
        def fn(t, node):
            control.exec_("iptables", "-A", self.chain, "-s", src,
                          "-j", "DROP", "-w")
        on_nodes(test, fn, nodes=[dst])

    def drop_all(self, test, grudge: Dict[str, Sequence[str]]) -> None:
        """Apply a whole grudge map {dst: [srcs-to-block]} in one parallel
        fan-out (reference: `net/drop-all!`)."""

        def fn(t, node):
            for src in grudge.get(node, ()):
                control.exec_("iptables", "-A", self.chain, "-s", src,
                              "-j", "DROP", "-w")
        on_nodes(test, fn, nodes=[n for n, srcs in grudge.items() if srcs])

    def heal(self, test):
        def fn(t, node):
            control.exec_("iptables", "-F", "-w")
            control.exec_("iptables", "-X", "-w")
        on_nodes(test, fn)

    def _netem(self, test, *behavior: str) -> None:
        def fn(t, node):
            control.exec_("tc", "qdisc", "replace", "dev", self.interface,
                          "root", "netem", *behavior)
        on_nodes(test, fn)

    def slow(self, test, *, mean_ms=50.0, variance_ms=10.0,
             distribution="normal"):
        self._netem(test, "delay", f"{mean_ms}ms", f"{variance_ms}ms",
                    "distribution", distribution)

    def flaky(self, test, *, loss_pct=20.0, correlation_pct=75.0):
        self._netem(test, "loss", f"{loss_pct}%", f"{correlation_pct}%")

    def shape(self, test, behaviors):
        self._netem(test, *behaviors)

    def fast(self, test):
        def fn(t, node):
            # deleting a qdisc that isn't there exits nonzero; that's fine
            control.exec_result("tc", "qdisc", "del", "dev", self.interface,
                                "root")
        on_nodes(test, fn)


class SimNet(Net):
    """In-memory net for tests: records the current partition state and
    shaping, and can drive a `MemStore`-style reachability predicate."""

    def __init__(self):
        self.blocked = set()  # (src, dst) pairs
        self.shaping: Optional[list] = None

    def drop_(self, test, src, dst):
        self.blocked.add((src, dst))

    def heal(self, test):
        self.blocked.clear()

    def slow(self, test, **kw):
        self.shaping = ["slow", kw]

    def flaky(self, test, **kw):
        self.shaping = ["flaky", kw]

    def shape(self, test, behaviors):
        self.shaping = list(behaviors)

    def fast(self, test):
        self.shaping = None

    def reachable(self, src: str, dst: str) -> bool:
        return (src, dst) not in self.blocked
