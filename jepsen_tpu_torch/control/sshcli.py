"""SSH remote via the OpenSSH client binaries (the port's copy of
`jepsen_tpu/control/sshcli.py`).

Equivalent of the reference's `jepsen/control/sshj.clj` + `control/scp.clj`
(SURVEY.md §2.1): persistent per-node sessions, exec with stdin/env/sudo,
scp upload/download.  The reference embeds a Java SSH library (sshj); we
drive the system `ssh`/`scp` binaries with a ControlMaster socket per node,
which gives the same persistent-session behavior without a Python SSH
dependency.  Gated: raises a clear error when no `ssh` binary exists
(tests check the argv with `subprocess.run` replaced, and use the
loopback remote otherwise, mirroring how the reference's test suite
avoids real SSH, SURVEY.md §4).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

from jepsen_tpu_torch.control.core import (Action, CmdResult, ConnectionError_,
                                     Remote, Session)


def ssh_available() -> bool:
    return shutil.which("ssh") is not None


class SshSession(Session):
    def __init__(self, host: str, opts: dict):
        if not ssh_available():
            raise ConnectionError_(
                "no `ssh` binary on PATH — install OpenSSH client, or use "
                "LoopbackRemote / DockerRemote for clusterless operation")
        self.host = host
        self.opts = opts
        self.user = opts.get("username", "root")
        self.port = int(opts.get("port", 22))
        self.timeout_s = float(opts.get("timeout_s", 60.0))
        if opts.get("password"):
            raise ConnectionError_(
                "password auth is not supported by the OpenSSH-CLI remote "
                "(no TTY); use private_key_path / an ssh agent instead")
        self._ctl_dir = tempfile.mkdtemp(prefix="jepsen-ssh-")
        self._ctl = os.path.join(self._ctl_dir, "ctl")
        # options shared by ssh and scp; NOTE ssh takes -p <port> but scp
        # takes -P <port>, so the port flag is added per-command below
        self._base = ["-o", "StrictHostKeyChecking=" +
                      ("yes" if opts.get("strict_host_key_checking")
                       else "no"),
                      "-o", "UserKnownHostsFile=/dev/null",
                      "-o", "LogLevel=ERROR",
                      "-o", "BatchMode=yes",
                      "-o", f"ControlPath={self._ctl}",
                      "-o", "ControlMaster=auto",
                      "-o", "ControlPersist=120"]
        if opts.get("private_key_path"):
            self._base += ["-i", opts["private_key_path"]]
        self._ssh_base = [*self._base, "-p", str(self.port)]
        self._scp_base = [*self._base, "-P", str(self.port)]
        # Open the master connection eagerly so connect errors surface here.
        r = self._run_ssh("true")
        if r.exit_status != 0:
            raise ConnectionError_(
                f"ssh to {self.user}@{host}:{self.port} failed: {r.err}")

    def _run_ssh(self, cmd: str, in_: Optional[str] = None) -> CmdResult:
        argv = ["ssh", *self._ssh_base, f"{self.user}@{self.host}", cmd]
        try:
            proc = subprocess.run(argv, input=in_, text=True,
                                  capture_output=True,
                                  timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise ConnectionError_(f"ssh timed out: {cmd}", cmd=cmd) from e
        return CmdResult(cmd=cmd, out=proc.stdout, err=proc.stderr,
                         exit_status=proc.returncode)

    def execute(self, action: Action) -> CmdResult:
        return self._run_ssh(action.wrapped_cmd(), action.in_)

    def upload(self, local_paths, remote_path: str) -> None:
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        argv = ["scp", *self._scp_base, "-r", *map(str, local_paths),
                f"{self.user}@{self.host}:{remote_path}"]
        try:
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise ConnectionError_("scp upload timed out") from e
        if proc.returncode != 0:
            raise ConnectionError_(f"scp upload failed: {proc.stderr}")

    def download(self, remote_paths, local_dir: str) -> None:
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        os.makedirs(local_dir, exist_ok=True)
        srcs = [f"{self.user}@{self.host}:{p}" for p in remote_paths]
        try:
            proc = subprocess.run(
                ["scp", *self._scp_base, "-r", *srcs, local_dir],
                capture_output=True, text=True, timeout=self.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise ConnectionError_("scp download timed out") from e
        if proc.returncode != 0:
            raise ConnectionError_(f"scp download failed: {proc.stderr}")

    def disconnect(self) -> None:
        try:
            subprocess.run(["ssh", *self._ssh_base, "-O", "exit",
                            f"{self.user}@{self.host}"],
                           capture_output=True, timeout=10)
        except Exception:
            pass
        shutil.rmtree(self._ctl_dir, ignore_errors=True)


class SshRemote(Remote):
    def __init__(self, **default_opts):
        self.default_opts = default_opts

    def connect(self, host: str, opts: Optional[dict] = None) -> Session:
        return SshSession(host, {**self.default_opts, **(opts or {})})
