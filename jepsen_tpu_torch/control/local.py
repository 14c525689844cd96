"""Loopback remote: run "node" commands as local subprocesses (the port's
copy of `jepsen_tpu/control/local.py`).

No reference equivalent file — the reference gets no-SSH operation from its
docker/k8s exec remotes (`control/docker.clj`, `control/k8s.clj`); this is
the same idea taken one step further so the whole control plane is testable
on a single machine with zero infrastructure.  Each logical node gets a
private root directory; uploads/downloads are copies into/out of it.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
from typing import Optional

from jepsen_tpu_torch.control.core import (
    Action,
    CmdResult,
    ConnectionError_,
    Remote,
    Session,
)


class LoopbackSession(Session):
    def __init__(self, host: str, root: Optional[str], timeout_s: float):
        self.host = host
        self.root = root
        self.timeout_s = timeout_s

    def execute(self, action: Action) -> CmdResult:
        cmd = action.wrapped_cmd()
        env = dict(os.environ)
        if self.root:
            env["JEPSEN_NODE_ROOT"] = self.root
            env["JEPSEN_NODE"] = self.host
        # bash leads a session (and process group) of its own, so a
        # timeout kills everything the command started, not bash alone;
        # a daemon that must outlive its command detaches with setsid
        # (`control/util.start_daemon`) and is ended by its db's teardown
        proc = subprocess.Popen(
            ["bash", "-c", cmd], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=self.root or None, env=env, start_new_session=True)
        try:
            out, err = proc.communicate(action.in_, timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()
            raise ConnectionError_(f"command timed out: {cmd}", cmd=cmd) \
                from e
        except BaseException:
            # interrupted (KeyboardInterrupt, SystemExit from a signal
            # handler): the command's group goes with its caller
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            raise
        return CmdResult(cmd=cmd, out=out, err=err,
                         exit_status=proc.returncode)

    def _resolve(self, path: str) -> str:
        # Relative paths are node-local (sandboxed); absolute paths refer to
        # the real filesystem — the same rule execute() follows (commands run
        # with cwd=root, so their relative paths land in the sandbox too).
        if self.root and not os.path.isabs(path):
            return os.path.join(self.root, path)
        return path

    def upload(self, local_paths, remote_path: str) -> None:
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        dest = self._resolve(remote_path)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        for lp in local_paths:
            if os.path.isdir(lp):
                shutil.copytree(lp, dest, dirs_exist_ok=True)
            elif len(local_paths) == 1 and not os.path.isdir(dest):
                shutil.copyfile(lp, dest)
            else:
                os.makedirs(dest, exist_ok=True)
                shutil.copyfile(lp, os.path.join(dest, os.path.basename(lp)))

    def download(self, remote_paths, local_dir: str) -> None:
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        os.makedirs(local_dir, exist_ok=True)
        for rp in remote_paths:
            src = self._resolve(str(rp))
            if not os.path.exists(src):
                continue
            dst = os.path.join(local_dir, os.path.basename(src))
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copyfile(src, dst)


class LoopbackRemote(Remote):
    """`base_dir=None` executes in the real filesystem (like running the
    control plane on the node itself); otherwise each host is sandboxed in
    `base_dir/<host>/`."""

    def __init__(self, base_dir: Optional[str] = None,
                 timeout_s: float = 60.0):
        self.base_dir = base_dir
        self.timeout_s = timeout_s

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        root = None
        if self.base_dir:
            root = os.path.join(self.base_dir, host)
            os.makedirs(root, exist_ok=True)
        return LoopbackSession(host, root, self.timeout_s)
