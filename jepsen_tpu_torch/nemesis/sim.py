"""Nemeses for the in-process sim cluster (`workloads.mem`; the port's
copy of `jepsen_tpu/nemesis/sim.py`).

The real-cluster nemeses (`nemesis/time.py` clock bumps via the
compiled helper, `nemesis/membership.py` over a db's views) need nodes;
these are their in-process twins, so campaign cells over the MemStore
sim can run the same fault *schedules* — and actually corrupt reads —
without SSH:

- :class:`SimClockSkewNemesis` — "clock skew" for a snapshot store:
  on ``start-skew`` it snapshots the store and puts it in *skewed read*
  mode, where whole-state reads observe a torn mix of the snapshot and
  the live state (exactly what a snapshot read built from per-node
  clocks that disagree looks like); ``stop-skew`` heals.  The skew
  magnitude is derived through `faketime.faketime_spec` /
  `faketime.rand_factor` so the op values carry the same FAKETIME
  offset strings a real libfaketime deployment would use.

- :class:`SimMembershipState` — a `MembershipState` over the sim
  cluster: views are the store's member set; ``leave-node`` /
  ``join-node`` converge after a configurable number of view polls,
  and clients bound to a removed node fail cleanly
  (``error="node-removed"``).  Drive it with the standard
  :class:`~jepsen_tpu_torch.nemesis.membership.MembershipNemesis`.
"""

from __future__ import annotations

import random as _random
from typing import Any, List, Optional

from jepsen_tpu_torch import faketime
from jepsen_tpu_torch.nemesis.core import Nemesis
from jepsen_tpu_torch.nemesis.membership import MembershipState

__all__ = ["SimClockSkewNemesis", "SimMembershipState", "store_of"]


def store_of(test: dict):
    """The sim cluster's MemStore, via the test's client."""
    client = test.get("client")
    store = getattr(client, "store", None)
    if store is None:
        raise ValueError("sim nemesis needs a MemClient-backed test "
                         "(no client.store found)")
    return store


class SimClockSkewNemesis(Nemesis):
    """Skew the sim store's read clock (reference: `nemesis/time.clj`'s
    role, realized for the in-process store).

    Ops:
    - ``start-skew`` value = {"offset_s", "rate", "faketime"} (filled
      in from the rng when absent) — snapshot the store and enter
      skewed-read mode;
    - ``stop-skew``  — heal (reads observe the live state again).
    """

    def __init__(self, rng: Optional[_random.Random] = None,
                 max_offset_s: float = 60.0):
        self.rng = rng or _random.Random()
        self.max_offset_s = max_offset_s

    def invoke(self, test, op):
        store = store_of(test)
        f = op["f"]
        if f == "start-skew":
            v = dict(op.get("value") or {})
            if "offset_s" not in v:
                v["offset_s"] = round(
                    self.rng.uniform(-self.max_offset_s,
                                     self.max_offset_s), 3)
            if "rate" not in v:
                v["rate"] = round(faketime.rand_factor(self.rng), 4)
            v["faketime"] = faketime.faketime_spec(v["offset_s"],
                                                   v.get("rate", 1.0))
            store.start_skew(self.rng.random())
            return dict(op, type="info", value=v)
        if f == "stop-skew":
            store.stop_skew()
            return dict(op, type="info")
        raise ValueError(f"sim clock-skew nemesis can't handle f={f!r}")

    def teardown(self, test):
        try:
            store_of(test).stop_skew()
        except Exception:
            pass


class SimMembershipState(MembershipState):
    """Membership over the sim store's member set.

    A change takes effect after `converge_polls` view polls (modelling
    config-propagation latency); the merged view is the member set.
    Clients whose node has left the view fail ops cleanly (the
    MemClient checks ``store.members``)."""

    def __init__(self, nodes: List[str], *, converge_polls: int = 1,
                 min_members: int = 1):
        self.initial = list(nodes)
        self.converge_polls = converge_polls
        self.min_members = min_members
        self._pending: Optional[tuple] = None
        self._store = None

    def setup(self, test):
        self._store = store_of(test)
        if getattr(self._store, "members", None) is None:
            self._store.members = set(self.initial)

    def view(self, test) -> Any:
        if self._pending is not None:
            op, polls = self._pending
            if polls <= 0:
                members = self._store.members
                if op["f"] == "leave-node":
                    members.discard(op["value"])
                else:
                    members.add(op["value"])
                self._pending = None
            else:
                self._pending = (op, polls - 1)
        return set(self._store.members)

    def possible_ops(self, test, view):
        out = []
        if view and len(view) > self.min_members:
            out.append({"f": "leave-node", "value": sorted(view)[-1],
                        "type": "invoke"})
        gone = [n for n in self.initial if n not in (view or ())]
        if gone:
            out.append({"f": "join-node", "value": gone[0],
                        "type": "invoke"})
        return out

    def apply_op(self, test, op):
        if self._pending is not None:
            return {"status": "fail", "reason": "change-in-flight"}
        self._pending = (op, self.converge_polls)
        return "requested"

    def converged(self, test, view, op):
        if op["f"] == "leave-node":
            return op["value"] not in view
        return op["value"] in view
