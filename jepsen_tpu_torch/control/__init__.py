"""Cluster control plane (the port's copy of `jepsen_tpu/control`;
reference: `jepsen/control*.clj`, SURVEY.md §1 L1).

Host-side only — never touches the card.  The checkers (L2-L3) are pure
and device-resident; this layer runs setup/teardown/faults on db nodes
through a pluggable `Remote` transport (loopback subprocess, OpenSSH
CLI, docker, kubectl, or an in-memory simulated cluster for tests).
"""

from jepsen_tpu_torch.control.api import (cd, download, exec_, exec_result,
                                          file_contents, host, on_many,
                                          on_nodes, session, sudo, upload,
                                          with_env, with_session,
                                          write_file)
from jepsen_tpu_torch.control.core import (Action, CmdResult,
                                           ConnectionError_, Remote,
                                           RemoteError, RetryRemote,
                                           Session, escape, join_cmd, lit)
from jepsen_tpu_torch.control.local import LoopbackRemote
from jepsen_tpu_torch.control.sim import SimRemote

__all__ = [
    "Action", "CmdResult", "ConnectionError_", "Remote", "RemoteError",
    "RetryRemote", "Session", "escape", "join_cmd", "lit",
    "cd", "download", "exec_", "exec_result", "host", "on_many", "on_nodes",
    "session", "sudo", "upload", "with_env", "with_session",
    "file_contents", "write_file",
    "LoopbackRemote", "SimRemote",
]
