"""Simulated remote for unit tests (the port's copy of
`jepsen_tpu/control/sim.py`).

Records every command each node was asked to run and lets tests script
responses — how we test nemeses/net/db logic with no cluster, mirroring the
reference's strategy of keeping SSH out of its unit tests (SURVEY.md §4).
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Callable, Dict, List, Optional, Tuple

from jepsen_tpu_torch.control.core import Action, CmdResult, Remote, Session


class SimNode:
    """Shared per-host log + scripted responses."""

    def __init__(self, host: str):
        self.host = host
        self.log: List[Action] = []
        self.uploads: List[Tuple[object, str]] = []
        self.downloads: List[Tuple[object, str]] = []
        self.responders: List[Tuple[str, Callable[[Action], CmdResult]]] = []
        self.lock = threading.Lock()

    def respond(self, glob: str, fn_or_out) -> None:
        """Script a response for commands matching `glob` (fnmatch over the
        wrapped command line).  `fn_or_out` is a string stdout or a
        callable(action) -> CmdResult."""
        if callable(fn_or_out):
            fn = fn_or_out
        else:
            def fn(a, out=fn_or_out):
                return CmdResult(cmd=a.wrapped_cmd(), out=out, err="",
                                 exit_status=0)
        self.responders.append((glob, fn))

    def cmds(self) -> List[str]:
        return [a.wrapped_cmd() for a in self.log]


class SimSession(Session):
    def __init__(self, node: SimNode):
        self.node = node

    def execute(self, action: Action) -> CmdResult:
        with self.node.lock:
            self.node.log.append(action)
            cmd = action.wrapped_cmd()
            for glob, fn in self.node.responders:
                if fnmatch.fnmatch(cmd, glob):
                    return fn(action)
        return CmdResult(cmd=cmd, out="", err="", exit_status=0)

    def upload(self, local_paths, remote_path):
        with self.node.lock:
            self.node.uploads.append((local_paths, remote_path))

    def download(self, remote_paths, local_dir):
        with self.node.lock:
            self.node.downloads.append((remote_paths, local_dir))


class SimRemote(Remote):
    def __init__(self):
        self.nodes: Dict[str, SimNode] = {}
        self._lock = threading.Lock()

    def node(self, host: str) -> SimNode:
        with self._lock:
            if host not in self.nodes:
                self.nodes[host] = SimNode(host)
            return self.nodes[host]

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        return SimSession(self.node(host))

    def all_cmds(self) -> Dict[str, List[str]]:
        return {h: n.cmds() for h, n in self.nodes.items()}
