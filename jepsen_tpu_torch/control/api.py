"""Control-plane DSL: per-thread node context + exec + cluster fan-out (the
port's copy of `jepsen_tpu/control/api.py`).

Equivalent of the reference's `jepsen/control.clj` (SURVEY.md §2.1): the
dynamic environment (`*host*`, `*session*`, `*dir*`, `*sudo*`, `*remote*`),
`exec` (shell-escaped command execution on the current node), `su`/`sudo`
and `cd` scoping, `upload`/`download`, and `on_nodes` — parallel map over
nodes with a per-node session.  The reference uses Clojure dynamic vars;
we use a `threading.local` stack so `on_nodes` worker threads each see
their own binding.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import posixpath
import threading
from typing import Any, Callable, Dict, Optional, Sequence

from jepsen_tpu_torch.control.core import (Action, CmdResult, Remote,
                                           RemoteError, Session, join_cmd,
                                           lit)

__all__ = ["exec_", "exec_result", "cd", "sudo", "with_env", "upload",
           "download", "with_session", "session", "host", "on_nodes",
           "on_many", "lit", "file_contents", "write_file"]

_ctx = threading.local()


def _frame() -> dict:
    stack = getattr(_ctx, "stack", None)
    if not stack:
        raise RemoteError("no node session bound on this thread — use "
                          "with_session(...) or on_nodes(...)")
    return stack[-1]


def _push(frame: dict):
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    _ctx.stack.append(frame)


def _pop():
    _ctx.stack.pop()


@contextlib.contextmanager
def with_session(host_: str, session_: Session, *,
                 dir: Optional[str] = None, sudo_user: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
    """Bind a node session on this thread."""
    _push({"host": host_, "session": session_, "dir": dir,
           "sudo": sudo_user, "env": env})
    try:
        yield
    finally:
        _pop()


def _rebind(**changes):
    f = dict(_frame())
    f.update(changes)

    @contextlib.contextmanager
    def scope():
        _push(f)
        try:
            yield
        finally:
            _pop()

    return scope()


def cd(dir: str):
    """Scope: run subsequent exec_ calls in `dir`."""
    return _rebind(dir=dir)


def sudo(user: str = "root"):
    """Scope: run subsequent exec_ calls as `user`."""
    return _rebind(sudo=user)


def with_env(**env):
    """Scope: add environment variables to subsequent exec_ calls."""
    f = _frame()
    merged = {**(f.get("env") or {}), **env}
    return _rebind(env=merged)


def host() -> str:
    return _frame()["host"]


def session() -> Session:
    return _frame()["session"]


def exec_result(*args: Any, in_: Optional[str] = None) -> CmdResult:
    """Run a command on the current node; return the full CmdResult
    without throwing on nonzero exit."""
    f = _frame()
    action = Action(cmd=join_cmd(args), in_=in_, dir=f.get("dir"),
                    sudo=f.get("sudo"), env=f.get("env"))
    return f["session"].execute(action)


def exec_(*args: Any, in_: Optional[str] = None) -> str:
    """Run a command on the current node; return trimmed stdout; raise
    RemoteError on nonzero exit (reference: `jepsen.control/exec`)."""
    return exec_result(*args, in_=in_).throw_on_nonzero().out.strip()


def upload(local_paths, remote_path: str) -> None:
    session().upload(local_paths, remote_path)


def download(remote_paths, local_dir: str) -> None:
    session().download(remote_paths, local_dir)


def file_contents(path: str) -> str:
    return exec_("cat", path)


def write_file(path: str, content: str) -> None:
    parent = posixpath.dirname(path)
    if parent:
        exec_("mkdir", "-p", parent)
    exec_("tee", path, in_=content)


def _node_opts(test: dict) -> dict:
    return {k: test[k] for k in ("username", "password", "port",
                                 "private_key_path", "strict_host_key_checking")
            if k in test}


def on_nodes(test: dict, fn: Callable[[dict, str], Any],
             nodes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run `fn(test, node)` on each node in parallel, with a session for
    that node bound on the worker thread.  Returns {node: result}.

    Reference: `jepsen.control/on-nodes`.  Sessions come from
    `test["sessions"]` when `core.run` already opened them, else are opened
    (and closed) here from `test["remote"]`.
    """
    nodes = list(nodes if nodes is not None else test["nodes"])
    if not nodes:
        return {}
    remote: Remote = test["remote"]
    sessions: Dict[str, Session] = test.get("sessions") or {}

    def work(node: str) -> Any:
        sess = sessions.get(node)
        opened = False
        if sess is None:
            sess = remote.connect(node, _node_opts(test))
            opened = True
        try:
            with with_session(node, sess,
                              sudo_user=test.get("sudo"),
                              dir=test.get("dir")):
                return fn(test, node)
        finally:
            if opened:
                sess.disconnect()

    with _fut.ThreadPoolExecutor(max_workers=len(nodes)) as ex:
        results = list(ex.map(work, nodes))
    return dict(zip(nodes, results))


def on_many(test: dict, nodes: Sequence[str], thunk: Callable[[], Any]
            ) -> Dict[str, Any]:
    """Like on_nodes but takes a zero-arg thunk using the bound context."""
    return on_nodes(test, lambda _t, _n: thunk(), nodes)
