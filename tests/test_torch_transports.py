"""Port parity for the remote transports: `DockerRemote` and `K8sRemote`
(`jepsen_tpu_torch/control/docker.py`) and `SshRemote`
(`control/sshcli.py`).

No docker, kubectl or ssh process is started: `subprocess.run` and
`shutil.which` are replaced, and each package's session is driven
through its own control API (`exec_` with stdin, a directory and an
environment, `upload`, `download`, errors, timeouts).  The argv each
transport hands `subprocess.run`, with its input and timeout, must be the
JAX package's, and so must what the control API returns or raises.
`SshSession`'s ControlMaster socket lies in a temporary directory of its
own, whose path is replaced by a placeholder before the comparison.
"""

import re
import shutil
import subprocess
import tempfile

import pytest

from jepsen_tpu import control as jcontrol
from jepsen_tpu.control import docker as jdocker
from jepsen_tpu.control import sshcli as jsshcli
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch.control import docker as tdocker
from jepsen_tpu_torch.control import sshcli as tsshcli

JAX = dict(control=jcontrol, docker=jdocker, sshcli=jsshcli)
PORT = dict(control=tcontrol, docker=tdocker, sshcli=tsshcli)
SIDES = (JAX, PORT)


class FakeRun:
    """`subprocess.run`'s stand-in: records (argv, input, timeout) and
    answers from `script`, a list of (argv substring, returncode, stdout,
    stderr) or (argv substring, an exception to raise); the default is
    exit 0 with "out\\n"."""

    def __init__(self, script=()):
        self.calls = []
        self.script = list(script)

    def __call__(self, argv, input=None, text=None, capture_output=None,
                 timeout=None, **kw):
        self.calls.append((list(argv), input, timeout))
        line = " ".join(map(str, argv))
        for rule in self.script:
            if rule[0] in line:
                if isinstance(rule[1], BaseException):
                    raise rule[1]
                _, rc, out, err = rule
                return subprocess.CompletedProcess(argv, rc, out, err)
        return subprocess.CompletedProcess(argv, 0, "out\n", "")


@pytest.fixture
def binaries(monkeypatch):
    """Every binary present on PATH."""
    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")


def drive(side, session, tmp_path, run):
    """The control API over `session`: what it returns or raises, in
    order."""
    c = side["control"]
    out = []
    with c.with_session("n1", session):
        out.append(c.exec_("echo", "hello world"))
        with c.cd("/var/lib/db"), c.with_env(A="1 2"):
            out.append(c.exec_result("cat", in_="payload").out)
        with c.sudo("postgres"):
            out.append(c.exec_("whoami"))
        try:
            c.exec_("false")
        except c.RemoteError as e:
            out.append(("raised", type(e).__name__, str(e)))
        c.upload(str(tmp_path / "a.tar"), "/opt/a.tar")
        c.upload([str(tmp_path / "b"), str(tmp_path / "c d")], "/opt/")
        c.download("/var/log/db.log", str(tmp_path / "logs"))
        c.download(["/x/1", "/x/2"], str(tmp_path / "logs2"))
    return out


EXEC_SCRIPT = [("false", 1, "", "no\n")]


@pytest.mark.parametrize("kind", ["docker", "k8s", "k8s-container"])
def test_exec_transports_argv_equal_to_jax(kind, binaries, monkeypatch,
                                           tmp_path):
    """`DockerRemote` / `K8sRemote` (with and without a container): the
    same argv, stdin and timeouts for exec, `docker cp` / `kubectl cp`
    upload and download, and the same results and errors."""
    out = []
    for side in SIDES:
        run = FakeRun(EXEC_SCRIPT)
        monkeypatch.setattr(subprocess, "run", run)
        d = side["docker"]
        if kind == "docker":
            remote = d.DockerRemote(timeout_s=7.0)
        else:
            remote = d.K8sRemote(
                namespace="jepsen", timeout_s=9.0,
                container="db" if kind == "k8s-container" else None)
        res = drive(side, remote.connect("pod-1"), tmp_path, run)
        out.append((run.calls, res))
    assert out[0] == out[1]
    argvs = [call[0] for call in out[1][0]]
    assert argvs[0][0] == ("docker" if kind == "docker" else "kubectl")
    assert any("cp" in a for a in argvs)


@pytest.mark.parametrize("failure", ["cp-fails", "exec-times-out",
                                     "cp-times-out"])
def test_exec_transport_errors_equal_to_jax(failure, binaries, monkeypatch,
                                            tmp_path):
    """A failed copy and a timed-out exec or copy raise the same
    `ConnectionError_` with the same message in both packages."""
    script = {
        "cp-fails": [(" cp ", 1, "", "no such container\n")],
        "exec-times-out": [("exec", subprocess.TimeoutExpired("docker", 7))],
        "cp-times-out": [(" cp ", subprocess.TimeoutExpired("docker", 7))],
    }[failure]
    out = []
    for side in SIDES:
        run = FakeRun(script)
        monkeypatch.setattr(subprocess, "run", run)
        c = side["control"]
        s = side["docker"].DockerRemote(timeout_s=7.0).connect("c1")
        seen = []
        with c.with_session("c1", s):
            for call in (lambda: c.exec_("ls"),
                         lambda: c.upload(str(tmp_path / "f"), "/f"),
                         lambda: c.download("/f", str(tmp_path / "d"))):
                try:
                    seen.append(call())
                except c.ConnectionError_ as e:
                    seen.append(("raised", type(e).__name__, str(e)))
        out.append((run.calls, seen))
    assert out[0] == out[1]
    assert any(s[0] == "raised" for s in out[1][1] if isinstance(s, tuple))


@pytest.mark.parametrize("cls", ["DockerRemote", "K8sRemote"])
def test_exec_transport_without_binary_raises(cls, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    msgs = []
    for side in SIDES:
        with pytest.raises(side["control"].ConnectionError_) as e:
            getattr(side["docker"], cls)()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def ssh_calls(run):
    """`run.calls` with each session's ControlMaster directory replaced."""
    return [([re.sub(r"/jepsen-ssh-[^/]+/", "/<ctl>/", a) for a in argv],
             inp, t) for argv, inp, t in run.calls]


@pytest.fixture
def ctl_dirs(monkeypatch, tmp_path):
    """The sessions' ControlMaster directories under `tmp_path` (a
    session that fails to connect leaves its own behind)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.mark.parametrize("opts", [
    {},
    {"username": "admin", "port": 2222, "timeout_s": 5,
     "private_key_path": "/keys/id_ed25519",
     "strict_host_key_checking": True},
])
def test_ssh_argv_equal_to_jax(opts, binaries, ctl_dirs, monkeypatch,
                               tmp_path):
    """`SshRemote`: the master connection's `ssh ... true`, exec with
    stdin, `scp -r` upload and download (ssh's `-p` against scp's `-P`)
    and the `-O exit` of `disconnect`: the same argv, stdin and timeouts,
    results and errors."""
    out = []
    for side in SIDES:
        run = FakeRun(EXEC_SCRIPT)
        monkeypatch.setattr(subprocess, "run", run)
        s = side["sshcli"].SshRemote(**opts).connect("n1.example")
        res = drive(side, s, tmp_path, run)
        s.disconnect()
        out.append((ssh_calls(run), res))
    assert out[0] == out[1]
    argvs = [call[0] for call in out[1][0]]
    assert argvs[0][0] == "ssh" and argvs[0][-1] == "true"
    assert any(a[0] == "scp" for a in argvs)
    assert argvs[-1][-3:-1] == ["-O", "exit"]


@pytest.mark.parametrize("failure", ["master-fails", "password", "no-ssh",
                                     "scp-fails", "ssh-times-out"])
def test_ssh_errors_equal_to_jax(failure, ctl_dirs, monkeypatch,
                                tmp_path):
    """A master connection that fails, password auth, no `ssh` binary, a
    failed `scp` and a timed-out exec raise the same `ConnectionError_`
    with the same message in both packages."""
    monkeypatch.setattr(shutil, "which", lambda name: (
        None if failure == "no-ssh" else f"/usr/bin/{name}"))
    script = {
        "master-fails": [("true", 255, "", "Connection refused\n")],
        "scp-fails": [("scp", 1, "", "permission denied\n")],
        "ssh-times-out": [("uptime", subprocess.TimeoutExpired("ssh", 60))],
    }.get(failure, [])
    opts = {"password": "secret"} if failure == "password" else {}
    out = []
    for side in SIDES:
        run = FakeRun(script)
        monkeypatch.setattr(subprocess, "run", run)
        c = side["control"]
        seen = []
        try:
            s = side["sshcli"].SshRemote(**opts).connect("n1")
            with c.with_session("n1", s):
                for call in (lambda: c.exec_("uptime"),
                             lambda: c.upload(str(tmp_path / "f"), "/f")):
                    try:
                        seen.append(call())
                    except c.ConnectionError_ as e:
                        seen.append(("raised", str(e)))
            s.disconnect()
        except c.ConnectionError_ as e:
            seen.append(("raised at connect", str(e)))
        out.append((ssh_calls(run), seen))
    assert out[0] == out[1]
    assert any(x[0].startswith("raised") for x in out[1][1]
               if isinstance(x, tuple))
    assert jsshcli.ssh_available() == tsshcli.ssh_available()
