"""Docker / Kubernetes exec remotes (the port's copy of
`jepsen_tpu/control/docker.py`).

Equivalent of the reference's `jepsen/control/docker.clj` and
`control/k8s.clj` (SURVEY.md §2.1): run node commands with `docker exec` /
`kubectl exec` instead of SSH, letting tests target containerized clusters
with no SSH daemon.  Gated on the respective binary existing.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

from jepsen_tpu_torch.control.core import (Action, CmdResult, ConnectionError_,
                                     Remote, Session)


class _ExecSession(Session):
    """Shared machinery: a session that runs `<argv-prefix> <shell -c cmd>`
    and copies files with a cp-style subcommand."""

    def __init__(self, host: str, timeout_s: float):
        self.host = host
        self.timeout_s = timeout_s

    def _exec_argv(self, cmd: str) -> List[str]:
        raise NotImplementedError

    def _cp_argv(self, src: str, dst: str) -> List[str]:
        """argv for copying src -> dst, where one side is host:path."""
        raise NotImplementedError

    def execute(self, action: Action) -> CmdResult:
        cmd = action.wrapped_cmd()
        try:
            proc = subprocess.run(self._exec_argv(cmd), input=action.in_,
                                  text=True, capture_output=True,
                                  timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise ConnectionError_(f"exec timed out: {cmd}", cmd=cmd) from e
        return CmdResult(cmd=cmd, out=proc.stdout, err=proc.stderr,
                         exit_status=proc.returncode)

    def _cp(self, src: str, dst: str) -> None:
        argv = self._cp_argv(src, dst)
        try:
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise ConnectionError_(f"{argv[0]} cp timed out") from e
        if proc.returncode != 0:
            raise ConnectionError_(f"{argv[0]} cp failed: {proc.stderr}")

    def upload(self, local_paths, remote_path: str) -> None:
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        for lp in local_paths:
            self._cp(str(lp), f"{self.host}:{remote_path}")

    def download(self, remote_paths, local_dir: str) -> None:
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        os.makedirs(local_dir, exist_ok=True)
        for rp in remote_paths:
            self._cp(f"{self.host}:{rp}",
                     os.path.join(local_dir, os.path.basename(str(rp))))


class DockerSession(_ExecSession):
    def _exec_argv(self, cmd):
        return ["docker", "exec", "-i", self.host, "bash", "-c", cmd]

    def _cp_argv(self, src, dst):
        return ["docker", "cp", src, dst]


class DockerRemote(Remote):
    def __init__(self, timeout_s: float = 60.0):
        if shutil.which("docker") is None:
            raise ConnectionError_("no `docker` binary on PATH")
        self.timeout_s = timeout_s

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        return DockerSession(host, self.timeout_s)


class K8sSession(_ExecSession):
    def __init__(self, host: str, namespace: str, container: Optional[str],
                 timeout_s: float):
        super().__init__(host, timeout_s)
        self.namespace = namespace
        self.container = container

    def _exec_argv(self, cmd):
        argv = ["kubectl", "-n", self.namespace, "exec", "-i", self.host]
        if self.container:
            argv += ["-c", self.container]
        return [*argv, "--", "bash", "-c", cmd]

    def _cp_argv(self, src, dst):
        return ["kubectl", "-n", self.namespace, "cp", src, dst]


class K8sRemote(Remote):
    def __init__(self, namespace: str = "default",
                 container: Optional[str] = None, timeout_s: float = 60.0):
        if shutil.which("kubectl") is None:
            raise ConnectionError_("no `kubectl` binary on PATH")
        self.namespace = namespace
        self.container = container
        self.timeout_s = timeout_s

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        return K8sSession(host, self.namespace, self.container,
                          self.timeout_s)
