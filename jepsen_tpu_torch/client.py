"""Client protocol (the port's copy of the `Client` base class of
`jepsen_tpu/client.py`).

Equivalent of the reference's `jepsen/client.clj` (SURVEY.md §2.1): a
`Client` owns one connection to one db node on behalf of one logical
process.  Lifecycle: `open` (per-process connection) -> `setup` (once) ->
`invoke` (op -> completed op) -> `teardown` -> `close`.

`invoke` receives an invoke op dict and must return its completion: the
same op with type "ok" / "fail" / "info" (info = indeterminate — the op
may or may not have taken effect; the process is considered crashed and
its thread is given a fresh process id by the interpreter, exactly the
reference's semantics).

Only the base class is ported: the simulated clients of the queue corpora
(`workloads.kafka.KafkaClient`, `workloads.mem.MemClient`) subclass it.
The JAX module's `Validate` and `WithTimeout` wrappers serve its
interpreter, which the port does not have yet.
"""

from __future__ import annotations


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
