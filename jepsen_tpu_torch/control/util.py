"""Node administration helpers built on the control DSL (the port's copy of
`jepsen_tpu/control/util.py`).

Equivalent of the reference's `jepsen/control/util.clj` (SURVEY.md §2.1):
daemon lifecycle (`start_daemon`/`stop_daemon` with pidfiles),
`grepkill`, archive install, cached wget, temp dirs, existence checks.
All of these run *on the current node* via the bound session.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

from jepsen_tpu_torch.control import api as c
from jepsen_tpu_torch.control.core import RemoteError, escape


def exists(path: str) -> bool:
    return c.exec_result("test", "-e", path).exit_status == 0


def ls(dir: str = ".") -> List[str]:
    out = c.exec_result("ls", "-1", dir).throw_on_nonzero().out
    return [l for l in out.splitlines() if l]


def tmp_dir() -> str:
    """Create and return a fresh temp dir on the node."""
    return c.exec_("mktemp", "-d", "-t", "jepsen.XXXXXX")


def start_daemon(bin_: str, *args: Any, logfile: str, pidfile: str,
                 chdir: Optional[str] = None,
                 env: Optional[dict] = None,
                 make_pidfile: bool = True) -> None:
    """Start a long-running process on the node, recording its pid.

    Reference: `control/util.clj start-daemon!` (start-stop-daemon).  We
    use setsid + nohup + `$!` which needs only POSIX sh, since db images
    may lack start-stop-daemon.
    """
    envs = " ".join(f"{escape(k)}={escape(str(v))}"
                    for k, v in (env or {}).items())
    cmdline = " ".join(escape(a) for a in (bin_, *args))
    script = (f"{'cd ' + escape(chdir) + ' && ' if chdir else ''}"
              f"setsid nohup env {envs} {cmdline} "
              f">> {escape(logfile)} 2>&1 & "
              + (f"echo $! > {escape(pidfile)}" if make_pidfile else "true"))
    c.exec_("bash", "-c", script)


def daemon_running(pidfile: str) -> bool:
    p = escape(pidfile)
    r = c.exec_result("bash", "-c", f"test -e {p} && kill -0 $(cat {p})")
    return r.exit_status == 0


def stop_daemon(pidfile: str, *, signal: str = "TERM",
                wait_s: float = 5.0) -> None:
    """Kill the process recorded in pidfile (then KILL), remove pidfile.
    Reference: `control/util.clj stop-daemon!`."""
    p = escape(pidfile)
    script = (f"if test -e {p}; then "
              f"pid=$(cat {p}); "
              f"kill -{signal} $pid 2>/dev/null || true; "
              f"for i in $(seq 1 {int(wait_s * 10)}); do "
              f"kill -0 $pid 2>/dev/null || break; sleep 0.1; done; "
              f"kill -KILL $pid 2>/dev/null || true; "
              f"rm -f {p}; fi")
    c.exec_("bash", "-c", script)


def grepkill(pattern: str, signal: str = "KILL") -> None:
    """Kill all processes matching `pattern` (reference: `grepkill!`).

    The invoking shell's own cmdline contains the pattern, so pkill would
    match (and kill) it; filter out $$ and $PPID instead.
    """
    c.exec_("bash", "-c",
            f"for p in $(pgrep -f -- {escape(pattern)}); do "
            f'[ "$p" != "$$" ] && [ "$p" != "$PPID" ] '
            f"&& kill -{signal} $p 2>/dev/null; done; true")


def install_archive(url: str, dest_dir: str, *,
                    force: bool = False) -> str:
    """Download (with cache) and unpack a tar/zip archive into dest_dir.
    Reference: `control/util.clj install-archive!`."""
    if exists(dest_dir) and not force:
        return dest_dir
    cache = cached_wget(url)
    c.exec_("rm", "-rf", dest_dir)
    c.exec_("mkdir", "-p", dest_dir)
    name = os.path.basename(url)
    if name.endswith(".zip"):
        # match the tar branch's layout: strip a single top-level dir
        c.exec_("unzip", "-q", "-o", cache, "-d", dest_dir + ".unzip")
        c.exec_("bash", "-c",
                f"src={escape(dest_dir + '.unzip')}; "
                f"dst={escape(dest_dir)}; "
                "entries=$(ls -1 \"$src\" | wc -l); "
                "if [ \"$entries\" = 1 ] && "
                "[ -d \"$src/$(ls -1 \"$src\")\" ]; then "
                "mv \"$src\"/*/* \"$dst\"/ 2>/dev/null; "
                "mv \"$src\"/*/.[!.]* \"$dst\"/ 2>/dev/null; true; "
                "else mv \"$src\"/* \"$dst\"/; fi; rm -rf \"$src\"")
    else:
        c.exec_("tar", "-xf", cache, "-C", dest_dir,
                "--strip-components", "1")
    return dest_dir


def cached_wget(url: str, *, cache_dir: str = "/tmp/jepsen/cache",
                force: bool = False) -> str:
    """Fetch url once per node; return the cached file path.
    Reference: `control/util.clj cached-wget!`."""
    name = os.path.basename(url) or "download"
    path = f"{cache_dir}/{name}"
    if force or not exists(path):
        c.exec_("mkdir", "-p", cache_dir)
        try:
            c.exec_("wget", "-q", "-O", path + ".part", url)
        except RemoteError:
            c.exec_("curl", "-fsSL", "-o", path + ".part", url)
        c.exec_("mv", path + ".part", path)
    return path


def signal_process(pattern_or_pid, sig: str) -> None:
    if isinstance(pattern_or_pid, int):
        c.exec_("kill", f"-{sig}", str(pattern_or_pid))
    else:
        c.exec_("bash", "-c",
                f"pkill -{sig} -f {escape(pattern_or_pid)} "
                "2>/dev/null || true")
