"""Client protocol (the port's copy of `jepsen_tpu/client.py`).

Equivalent of the reference's `jepsen/client.clj` (SURVEY.md §2.1): a
`Client` owns one connection to one db node on behalf of one logical
process.  Lifecycle: `open` (per-process connection) -> `setup` (once) ->
`invoke` (op -> completed op) -> `teardown` -> `close`.

`invoke` receives an invoke op dict and must return its completion: the
same op with type "ok" / "fail" / "info" (info = indeterminate — the op
may or may not have taken effect; the process is considered crashed and
its thread is given a fresh process id by the interpreter, exactly the
reference's semantics).
"""

from __future__ import annotations

import traceback
from typing import Any

from jepsen_tpu_torch.utils.core import TimeoutError_, timeout


class Client:
    """Base client.  Subclasses override what they need."""

    def open(self, test: dict, node: str) -> "Client":
        """Return a client bound to `node` for a new process.  May return
        self for connectionless clients."""
        return self

    def setup(self, test: dict) -> None:
        """One-time data setup (e.g. create tables)."""

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply op; return the completion op (type ok/fail/info)."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        """One-time cleanup."""

    def close(self, test: dict) -> None:
        """Release this connection."""


def closable(client: Any) -> bool:
    return hasattr(client, "close")


class Validate(Client):
    """Wraps a client, checking invoke returns a legal completion
    (reference `client/validate`)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        return Validate(self.client.open(test, node))

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        res = self.client.invoke(test, op)
        if not isinstance(res, dict):
            raise ValueError(f"client returned non-op {res!r} for {op!r}")
        if res.get("type") not in ("ok", "fail", "info"):
            raise ValueError(f"client completion has bad type: {res!r}")
        if res.get("process") != op.get("process"):
            raise ValueError(
                f"client changed op process {op.get('process')!r} -> "
                f"{res.get('process')!r}")
        return res

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)


class WithTimeout(Client):
    """Wraps a client so invokes time out with an :info completion
    (reference `client/timeout` idiom)."""

    def __init__(self, client: Client, seconds: float):
        self.client = client
        self.seconds = seconds

    def open(self, test, node):
        return WithTimeout(self.client.open(test, node), self.seconds)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        try:
            return timeout(self.seconds, lambda: self.client.invoke(test, op))
        except TimeoutError_:
            return dict(op, type="info", error="timeout")

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)


def invoke_with_errors(client: Client, test: dict, op: dict) -> dict:
    """Run client.invoke, converting exceptions into :info completions (the
    interpreter's safety net; reference interpreter behavior — a client
    exception means the op's effect is unknown)."""
    try:
        return client.invoke(test, op)
    except Exception as e:  # noqa: BLE001 — any client error = indeterminate
        return dict(op, type="info",
                    error=f"{type(e).__name__}: {e}",
                    ext={"traceback": traceback.format_exc()})
