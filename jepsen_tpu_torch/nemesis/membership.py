"""Membership-change nemesis: grow/shrink the cluster during a test (the
port's copy of `jepsen_tpu/nemesis/membership.py`).

Equivalent of the reference's `jepsen/nemesis/membership.clj` (SURVEY.md
§2.1): a *staged state-machine* nemesis.  The db-specific logic lives in
a `MembershipState` — how to read one node's view, how to merge the
per-node views into a cluster view, which ops are possible, how to apply
one, and when a pending op has taken effect ("resolved") in a view.

The nemesis keeps:
- the merged **view** and a **view log** (every distinct view observed,
  with its index and wall time — the reference's view history);
- a **pending set** of applied-but-unresolved ops.  After applying an op
  it polls the per-node views; when the op resolves against a merged
  view it completes **ok** (with the resolving view index).  On timeout
  the op completes **info** and *stays pending*: later invocations keep
  resolving it against newer views and report it in ``also-resolved`` —
  the synchronous-client rendering of the reference's async resolution.
"""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.nemesis.core import Nemesis


class MembershipState:
    """Db-specific membership protocol (reference: the `State` protocol).

    New implementations override the staged protocol (`node_view` /
    `merge_views` / `possible_ops` / `apply_op` / `resolve_op`); the
    legacy single-view protocol (`view` + `converged`) keeps working via
    the defaults.
    """

    # ---- lifecycle -------------------------------------------------------
    def setup(self, test: dict) -> None:
        pass

    def teardown(self, test: dict) -> None:
        pass

    # ---- staged protocol -------------------------------------------------
    def node_view(self, test: dict, node: Optional[str]) -> Any:
        """The cluster view from one node's perspective.  Default:
        delegate to the legacy whole-cluster `view`."""
        return self.view(test)

    def merge_views(self, test: dict, views: List[Any]) -> Any:
        """Combine per-node views into the canonical cluster view.
        Default: the first non-None view (single-source states)."""
        for v in views:
            if v is not None:
                return v
        return None

    def possible_ops(self, test: dict, view: Any) -> List[dict]:
        """Ops applicable now, e.g. [{"f": "leave-node", "value": "n3"}]."""
        raise NotImplementedError

    def apply_op(self, test: dict, op: dict) -> Any:
        """Start the change; return a result for the completion value.
        Returning a dict with ``{"status": "fail"}`` means the change
        definitely did NOT start (nothing entered any log): the nemesis
        completes the op ``fail`` and does not track it as pending."""
        raise NotImplementedError

    def resolve_op(self, test: dict, op: dict, result: Any,
                   view: Any) -> bool:
        """Has the change from `op` (with apply result `result`) taken
        effect in `view`?  Default: the legacy `converged`."""
        return self.converged(test, view, op)

    # ---- legacy protocol (still honored) ---------------------------------
    def view(self, test: dict) -> Any:
        """Current cluster view (e.g. member list), from the db's pov."""
        raise NotImplementedError

    def converged(self, test: dict, view: Any, op: dict) -> bool:
        """Has the change from `op` taken effect in `view`?"""
        return True


class MembershipNemesis(Nemesis):
    """Drives a MembershipState (reference
    `nemesis.membership/nemesis-for-state`).

    Ops:
    - any f the state's possible_ops produce (join/leave/grow/shrink...)
    - ``membership-view``: report the current merged view + log index
    """

    def __init__(self, state: MembershipState, *,
                 converge_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.5):
        self.state = state
        self.converge_timeout_s = converge_timeout_s
        self.poll_interval_s = poll_interval_s
        self.view: Any = None
        self.view_log: List[Dict[str, Any]] = []
        self.pending: List[Dict[str, Any]] = []

    def setup(self, test):
        self.state.setup(test)
        self._refresh(test)
        return self

    # ---- view plumbing ---------------------------------------------------
    def _refresh(self, test) -> Any:
        v = merged_view(self.state, test)
        if not self.view_log or v != self.view_log[-1]["view"]:
            self.view_log.append({"i": len(self.view_log),
                                  "time": _time.time(), "view": v})
        self.view = v
        return v

    def _resolve_pending(self, test, view) -> List[Dict[str, Any]]:
        resolved, still = [], []
        for p in self.pending:
            try:
                done = self.state.resolve_op(test, p["op"], p["result"],
                                             view)
            except Exception:
                done = False
            (resolved if done else still).append(p)
        self.pending = still
        for p in resolved:
            p["view-index"] = self.view_log[-1]["i"] if self.view_log \
                else None
        return resolved

    # ---- nemesis protocol ------------------------------------------------
    def invoke(self, test, op):
        if op["f"] == "membership-view":
            v = self._refresh(test)
            return dict(op, type="info",
                        value={"view": v,
                               "view-index": self.view_log[-1]["i"]})

        result = self.state.apply_op(test, op)
        if isinstance(result, dict) and result.get("status") == "fail":
            # the state reports the change definitely did NOT start
            # (e.g. no quorum, nothing entered any log): a clean :fail —
            # it must not join the pending set, or an unrelated later
            # change could "resolve" it into a fault that never happened
            return dict(op, type="fail",
                        value={"result": result, "converged": False})
        entry = {"op": op, "result": result, "since": _time.time()}
        self.pending.append(entry)
        also: List[dict] = []
        deadline = _time.monotonic() + self.converge_timeout_s
        while _time.monotonic() < deadline:
            view = self._refresh(test)
            for p in self._resolve_pending(test, view):
                if p is entry:
                    # the change took effect: a definite ok completion
                    return dict(op, type="ok",
                                value={"result": result, "converged": True,
                                       "view-index": p["view-index"],
                                       "also-resolved": also})
                also.append({"f": p["op"]["f"], "value": p["op"]["value"],
                             "view-index": p["view-index"]})
            _time.sleep(self.poll_interval_s)
        # indeterminate: the op stays pending and may resolve during a
        # later invocation (reported there via also-resolved)
        return dict(op, type="info",
                    value={"result": result, "converged": False,
                           "pending": True, "also-resolved": also})

    def teardown(self, test):
        self.state.teardown(test)


def merged_view(state: MembershipState, test: dict) -> Any:
    """Gather per-node views (a dead/partitioned node yields None rather
    than crashing the caller — it's exactly the fault window membership
    tests create) and merge them."""
    if type(state).node_view is MembershipState.node_view:
        # legacy single-view state: node_view ignores the node, so N
        # polls would be N identical (possibly expensive) cluster fetches
        try:
            return state.view(test)
        except Exception:
            return None
    views = []
    for node in (test.get("nodes") or [None]):
        try:
            views.append(state.node_view(test, node))
        except Exception:
            views.append(None)
    return state.merge_views(test, views)


def possible_op(state: MembershipState, test: dict) -> Optional[dict]:
    """Generator helper: pick the next membership op, or None if the view
    offers nothing (used as `lambda t, ctx: possible_op(state, t)`)."""
    ops = state.possible_ops(test, merged_view(state, test))
    return ops[0] if ops else None
