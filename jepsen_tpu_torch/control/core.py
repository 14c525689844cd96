"""Remote protocol: how the control plane talks to a node (the port's copy
of `jepsen_tpu/control/core.py`).

Equivalent of the reference's `jepsen/control/core.clj` (SURVEY.md §2.1):
the `Remote` protocol — `connect`, `execute`, `upload`, `download`,
`disconnect` — plus shell escaping, command/result types, error handling,
and a retrying wrapper remote (reference: `control/retry.clj`).

Remotes are *factories*: `connect(host, opts)` returns a live session bound
to one node; sessions are used concurrently from at most one thread each
(the reference holds one sshj session per node under a lock; we hold one
session per node per `on_nodes` worker thread).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, Optional, Sequence


class RemoteError(Exception):
    """A command failed (nonzero exit) or the transport broke."""

    def __init__(self, msg: str, *, cmd: Optional[str] = None,
                 exit_status: Optional[int] = None,
                 out: str = "", err: str = ""):
        super().__init__(msg)
        self.cmd = cmd
        self.exit_status = exit_status
        self.out = out
        self.err = err


class ConnectionError_(RemoteError):
    """Could not reach the node / transport unavailable."""


@dataclasses.dataclass
class Action:
    """A command to run on a node.

    Mirrors the reference's action maps: `cmd` is the (already-escaped)
    shell string; `in_` optional stdin; `dir` working directory; `sudo`
    user to become; `env` extra environment.
    """

    cmd: str
    in_: Optional[str] = None
    dir: Optional[str] = None
    sudo: Optional[str] = None
    env: Optional[Dict[str, str]] = None

    def wrapped_cmd(self) -> str:
        """The full shell line: env + cd + sudo wrapping, like the
        reference's `jepsen.control/wrap-cd`/`wrap-sudo`/`env`."""
        c = self.cmd
        if self.env:
            exports = " ".join(f"{k}={escape(str(v))}"
                               for k, v in sorted(self.env.items()))
            c = f"env {exports} {c}"
        if self.dir:
            c = f"cd {escape(self.dir)} && {c}"
        if self.sudo:
            # -n: never prompt — stdin belongs to the command (`in_`), not
            # to sudo; passworded sudo fails fast with a clear error
            c = f"sudo -n -u {escape(self.sudo)} bash -c {escape(c)}"
        return c


@dataclasses.dataclass
class CmdResult:
    cmd: str
    out: str
    err: str
    exit_status: int

    def throw_on_nonzero(self) -> "CmdResult":
        if self.exit_status != 0:
            raise RemoteError(
                f"command returned exit status {self.exit_status}\n"
                f"cmd: {self.cmd}\nout: {self.out[-2000:]}\n"
                f"err: {self.err[-2000:]}",
                cmd=self.cmd, exit_status=self.exit_status,
                out=self.out, err=self.err)
        return self


_UNSAFE = re.compile(r"[^A-Za-z0-9_/.,:=+@%^-]")


class Lit:
    """A literal shell fragment that must NOT be escaped (reference:
    `jepsen.control/lit`)."""

    def __init__(self, s: str):
        self.s = s

    def __repr__(self):
        return f"lit({self.s!r})"


def lit(s: str) -> Lit:
    return Lit(s)


def escape(x: Any) -> str:
    """Escape one token for the shell, like `jepsen.control/escape`."""
    if isinstance(x, Lit):
        return x.s
    s = str(x)
    if s == "":
        return "''"
    if _UNSAFE.search(s):
        return "'" + s.replace("'", "'\\''") + "'"
    return s


def join_cmd(args: Sequence[Any]) -> str:
    """Escape and join a token sequence into one shell line."""
    return " ".join(escape(a) for a in args)


class Session:
    """A live connection to one node."""

    def execute(self, action: Action) -> CmdResult:
        raise NotImplementedError

    def upload(self, local_paths, remote_path: str) -> None:
        raise NotImplementedError

    def download(self, remote_paths, local_dir: str) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        pass


class Remote:
    """Remote factory protocol."""

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        raise NotImplementedError


class RetrySession(Session):
    """Wraps a session, retrying failed operations with backoff and
    reconnecting on connection errors (reference: `control/retry.clj`)."""

    def __init__(self, remote: Remote, host: str, opts: Optional[dict],
                 session: Session, *, retries: int = 5,
                 backoff_s: float = 0.2):
        self.remote = remote
        self.host = host
        self.opts = opts
        self.session = session
        self.retries = retries
        self.backoff_s = backoff_s

    def _with_retry(self, fn):
        delay = self.backoff_s
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except ConnectionError_ as e:
                last = e
                if attempt == self.retries:
                    break
                time.sleep(delay)
                delay *= 2
                try:
                    self.session.disconnect()
                except Exception:
                    pass
                try:
                    self.session = self.remote.connect(self.host, self.opts)
                except Exception as e2:  # reconnect failed; keep retrying
                    last = ConnectionError_(str(e2))
        raise last  # type: ignore[misc]

    def execute(self, action: Action) -> CmdResult:
        return self._with_retry(lambda: self.session.execute(action))

    def upload(self, local_paths, remote_path):
        return self._with_retry(
            lambda: self.session.upload(local_paths, remote_path))

    def download(self, remote_paths, local_dir):
        return self._with_retry(
            lambda: self.session.download(remote_paths, local_dir))

    def disconnect(self):
        self.session.disconnect()


class RetryRemote(Remote):
    def __init__(self, remote: Remote, *, retries: int = 5,
                 backoff_s: float = 0.2):
        self.remote = remote
        self.retries = retries
        self.backoff_s = backoff_s

    def connect(self, host, opts=None):
        return RetrySession(self.remote, host, opts,
                            self.remote.connect(host, opts),
                            retries=self.retries, backoff_s=self.backoff_s)
