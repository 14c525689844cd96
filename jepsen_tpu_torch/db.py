"""DB protocol: how to set up and tear down the system under test (the
port's copy of `jepsen_tpu/db.py`).

Equivalent of the reference's `jepsen/db.clj` (SURVEY.md §2.1): the core
`DB` lifecycle (`setup`/`teardown`) plus optional facets — `LogFiles`,
`Primary` (`primaries`/`setup_primary`), `Process` (`start`/`kill`) and
`Pause` (`pause`/`resume`).  The reference models facets as separate
protocols satisfied ad hoc; here they are mixin base classes and
capability checks via `supports()`.

All methods run with a control session bound for `node` (they are invoked
from `control.on_nodes`), so implementations use `control.exec_` freely.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import util as cu


class DB:
    """Base DB. Subclasses override lifecycle methods as needed."""

    def setup(self, test: dict, node: str) -> None:
        """Install and start the db on `node`."""

    def teardown(self, test: dict, node: str) -> None:
        """Stop the db and wipe its state on `node`."""


class LogFiles:
    """Facet: which files to download from nodes after a run
    (reference: `db/LogFiles`)."""

    def log_files(self, test: dict, node: str) -> Sequence[str]:
        return []


class Primary:
    """Facet: primary/leader discovery and initial placement
    (reference: `db/Primary`)."""

    def primaries(self, test: dict) -> List[str]:
        """Nodes currently believed to be primaries."""
        return []

    def setup_primary(self, test: dict, node: str) -> None:
        """One-time setup performed on the first node before others."""


class Process:
    """Facet: start/kill the db process (reference: `db/Process`/`Kill`)."""

    def start(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def kill(self, test: dict, node: str) -> None:
        raise NotImplementedError


class Pause:
    """Facet: pause/resume (SIGSTOP/SIGCONT) the db process
    (reference: `db/Pause`)."""

    def pause(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def resume(self, test: dict, node: str) -> None:
        raise NotImplementedError


def supports(db: Any, facet: type) -> bool:
    return isinstance(db, facet)


class Noop(DB):
    """A db that does nothing (reference: `db/noop`) — for tests whose
    clients talk to an external or in-process system."""


noop = Noop()


class ProcessDB(DB, Process, Pause, LogFiles):
    """A db managed as a single daemon process per node: start with a
    pidfile, kill/pause via signals.  Convenience base covering the common
    shape of real Jepsen db implementations (reference idiom:
    `control/util start-daemon!` + `db/Process` facet).
    """

    def __init__(self, bin_: str, args: Sequence[Any] = (), *,
                 logfile: str = "db.log", pidfile: str = "db.pid",
                 dir: Optional[str] = None, env: Optional[dict] = None):
        self.bin = bin_
        self.args = list(args)
        self.logfile = logfile
        self.pidfile = pidfile
        self.dir = dir
        self.env = env

    def setup(self, test, node):
        self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        control.exec_result("rm", "-f", self.logfile, self.pidfile)

    def start(self, test, node):
        if cu.daemon_running(self.pidfile):
            return
        cu.start_daemon(self.bin, *self.args, logfile=self.logfile,
                        pidfile=self.pidfile, chdir=self.dir, env=self.env)

    def kill(self, test, node):
        cu.stop_daemon(self.pidfile, signal="KILL", wait_s=1.0)
        cu.grepkill(self.bin)

    def pause(self, test, node):
        control.exec_("bash", "-c",
                      f"kill -STOP $(cat {control.escape(self.pidfile)})")

    def resume(self, test, node):
        control.exec_("bash", "-c",
                      f"kill -CONT $(cat {control.escape(self.pidfile)})")

    def log_files(self, test, node):
        return [self.logfile]


class TcpdumpDB(DB, LogFiles):
    """Wraps another db, running tcpdump on each node during the test
    (reference: `db/tcpdump`)."""

    def __init__(self, db: DB, *, ports: Sequence[int] = (),
                 pcap: str = "trace.pcap", filter_: str = ""):
        self.db = db
        self.ports = list(ports)
        self.pcap = pcap
        self.filter = filter_ or " or ".join(f"port {p}" for p in self.ports)

    def setup(self, test, node):
        cu.start_daemon("tcpdump", "-w", self.pcap, *(
            ["-i", "any"] + ([self.filter] if self.filter else [])),
            logfile="tcpdump.log", pidfile="tcpdump.pid")
        self.db.setup(test, node)

    def teardown(self, test, node):
        self.db.teardown(test, node)
        cu.stop_daemon("tcpdump.pid", wait_s=1.0)

    def log_files(self, test, node):
        inner = (self.db.log_files(test, node)
                 if supports(self.db, LogFiles) else [])
        return [*inner, self.pcap]


def cycle_db(db: DB, test: dict, node: str) -> None:
    """teardown! then setup! on one node (reference: `db/cycle!`)."""
    db.teardown(test, node)
    db.setup(test, node)
