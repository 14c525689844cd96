"""Role composition: one cluster, several roles (the port's copy of
`jepsen_tpu/role.py`).

Equivalent of the reference's `jepsen/src/jepsen/role.clj` (SURVEY.md
§2.1): split the node list into named roles (e.g. two shards plus a
coordinator), then restrict DBs, clients, nemeses, and generators to the
nodes of one role.  The test map carries ``test["roles"] = {role:
[nodes...]}``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from . import db as db_proto
from .nemesis.core import Nemesis


def roles(assignment: Dict[str, Sequence[str]]) -> Dict[str, List[str]]:
    """Normalize a role assignment map."""
    return {r: list(ns) for r, ns in assignment.items()}


def role_of(test: dict, node: str) -> Optional[str]:
    """Which role a node plays (reference `role/role`)."""
    for r, ns in (test.get("roles") or {}).items():
        if node in ns:
            return r
    return None


def nodes_of(test: dict, role: str) -> List[str]:
    """The nodes holding a role (reference `role/nodes`)."""
    return list((test.get("roles") or {}).get(role, ()))


def restrict_test(test: dict, role: str) -> dict:
    """A view of the test scoped to one role's nodes (reference
    `role/restrict-test`)."""
    sub = dict(test)
    sub["nodes"] = nodes_of(test, role)
    return sub


class RoleDB(db_proto.DB, db_proto.LogFiles, db_proto.Primary):
    """Dispatches db lifecycle calls to the role-specific DB for each node
    (reference `role/db`).  Nodes with no role (or no db for their role)
    are no-ops."""

    def __init__(self, dbs: Dict[str, Any]):
        self.dbs = dict(dbs)

    def _db_for(self, test: dict, node: str):
        return self.dbs.get(role_of(test, node))

    def setup(self, test, node):
        db = self._db_for(test, node)
        if db is not None:
            db.setup(restrict_test(test, role_of(test, node)), node)

    def teardown(self, test, node):
        db = self._db_for(test, node)
        if db is not None:
            db.teardown(restrict_test(test, role_of(test, node)), node)

    def log_files(self, test, node):
        db = self._db_for(test, node)
        if db is not None and db_proto.supports(db, db_proto.LogFiles):
            return db.log_files(restrict_test(test, role_of(test, node)),
                                node)
        return []

    def primaries(self, test):
        out = []
        for role, db in self.dbs.items():
            if db_proto.supports(db, db_proto.Primary):
                out.extend(db.primaries(restrict_test(test, role)))
        return out

    def setup_primary(self, test, node):
        db = self._db_for(test, node)
        if db is not None and db_proto.supports(db, db_proto.Primary):
            db.setup_primary(restrict_test(test, role_of(test, node)), node)


class RoleNemesis(Nemesis):
    """Scopes an inner nemesis to one role: it sees a test whose nodes are
    only that role's (reference `role/nemesis`)."""

    def __init__(self, role: str, nemesis: Nemesis):
        self.role = role
        self.nemesis = nemesis

    def setup(self, test):
        inner = self.nemesis.setup(restrict_test(test, self.role))
        return RoleNemesis(self.role, inner or self.nemesis)

    def invoke(self, test, op):
        return self.nemesis.invoke(restrict_test(test, self.role), op)

    def teardown(self, test):
        self.nemesis.teardown(restrict_test(test, self.role))


def restrict_client(role: str, client):
    """A client whose opens are pinned to the role's nodes (reference
    `role/restrict-client`): process->node mapping cycles within role."""
    from .client import Client

    class _RoleClient(Client):
        def __init__(self, inner):
            self.inner = inner

        def open(self, test, node):
            ns = nodes_of(test, role)
            if ns:
                # re-map whatever node the worker picked into the role
                idx = (test.get("nodes") or [node]).index(node) \
                    if node in (test.get("nodes") or []) else 0
                node = ns[idx % len(ns)]
            opened = self.inner.open(restrict_test(test, role), node)
            return _RoleClient(opened) if opened is not self.inner else self

        def setup(self, test):
            self.inner.setup(restrict_test(test, role))

        def invoke(self, test, op):
            return self.inner.invoke(restrict_test(test, role), op)

        def teardown(self, test):
            self.inner.teardown(restrict_test(test, role))

        def close(self, test):
            self.inner.close(restrict_test(test, role))

    return _RoleClient(client)
