"""OS protocol: prepare a node's operating system (the port's copy of
`jepsen_tpu/os_setup.py`).

Equivalent of the reference's `jepsen/os.clj` + `os/debian.clj` /
`os/ubuntu.clj` / `os/centos.clj` (SURVEY.md §2.1): an `OS` with
`setup`/`teardown` run on every node before/after the db, typically
installing packages and disabling time sync so clock nemeses work.
"""

from __future__ import annotations

from typing import Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control.core import RemoteError


class OS:
    def setup(self, test: dict, node: str) -> None:
        pass

    def teardown(self, test: dict, node: str) -> None:
        pass


class Noop(OS):
    """No OS preparation (reference: `os/noop`)."""


noop = Noop()


class Debian(OS):
    """Debian/Ubuntu setup (reference: `os/debian.clj`): apt package
    install, NTP/timesyncd disable (so clock nemeses own the clock)."""

    def __init__(self, packages: Sequence[str] = (),
                 disable_time_sync: bool = True):
        self.packages = list(packages)
        self.disable_time_sync = disable_time_sync

    def install(self, pkgs: Sequence[str]) -> None:
        if not pkgs:
            return
        control.exec_("env", "DEBIAN_FRONTEND=noninteractive",
                      "apt-get", "install", "-y", "--no-install-recommends",
                      *pkgs)

    def setup(self, test, node):
        try:
            control.exec_("apt-get", "update", "-q")
        except RemoteError:
            pass  # stale mirrors shouldn't kill the run; install will retry
        self.install(self.packages)
        if self.disable_time_sync:
            for svc in ("ntp", "systemd-timesyncd", "chrony"):
                control.exec_result("systemctl", "stop", svc)
                control.exec_result("systemctl", "disable", svc)

    def teardown(self, test, node):
        pass


class Ubuntu(Debian):
    """Ubuntu setup (reference: `os/ubuntu.clj`, which extends debian):
    Debian behavior plus Ubuntu-specific background jobs that fight
    nemeses and db installs.  apt-daily/apt-daily-upgrade TIMERS are what
    relaunch unattended-upgrade runs (stopping only the service leaves
    the dpkg-lock contention in place), and snap refreshes are held via
    snapd's own hold — there is no stoppable refresh unit."""

    def setup(self, test, node):
        super().setup(test, node)
        for unit in ("apt-daily.timer", "apt-daily-upgrade.timer",
                     "unattended-upgrades"):
            control.exec_result("systemctl", "stop", unit)
            control.exec_result("systemctl", "disable", unit)
        control.exec_result("snap", "refresh", "--hold")


class Centos(OS):
    """CentOS/RHEL setup (reference: `os/centos.clj`)."""

    def __init__(self, packages: Sequence[str] = (),
                 disable_time_sync: bool = True):
        self.packages = list(packages)
        self.disable_time_sync = disable_time_sync

    def setup(self, test, node):
        if self.packages:
            control.exec_("yum", "install", "-y", *self.packages)
        if self.disable_time_sync:
            for svc in ("ntpd", "chronyd"):
                control.exec_result("systemctl", "stop", svc)
                control.exec_result("systemctl", "disable", svc)

    def teardown(self, test, node):
        pass
