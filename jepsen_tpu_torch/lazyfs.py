"""lazyfs integration: lose un-fsynced writes (the port's copy of
`jepsen_tpu/lazyfs.py`).

Equivalent of the reference's `jepsen/src/jepsen/lazyfs.clj` (SURVEY.md
§2.1, §2.5 #6): installs/builds the external lazyfs FUSE filesystem on db
nodes, mounts the db's data dir through it, and injects "lose un-fsynced
writes" faults through lazyfs's command FIFO.  lazyfs itself is an
external C++ project (out of rewrite scope per §2.5); this is the
integration layer that drives it over the control plane.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from . import control
from . import db as db_proto
from .control.core import RemoteError

logger = logging.getLogger("jepsen.lazyfs")

REPO_URL = "https://github.com/dsrhaslab/lazyfs.git"
DIR = "/opt/jepsen/lazyfs"
BIN = DIR + "/lazyfs/build/lazyfs"


@dataclasses.dataclass
class LazyFS:
    """One lazyfs mount on a node: `dir` is what the db sees; writes pass
    through to `data_dir` and live in page cache until fsync."""

    dir: str
    data_dir: Optional[str] = None
    fifo: Optional[str] = None
    config: Optional[str] = None

    def __post_init__(self):
        base = self.dir.rstrip("/")
        if self.data_dir is None:
            self.data_dir = base + ".data"
        if self.fifo is None:
            self.fifo = base + ".fifo"
        if self.config is None:
            self.config = base + ".lazyfs.toml"


def install() -> None:
    """Clone and build lazyfs on the current node (reference
    `lazyfs/install!`).  Needs git, cmake, g++, libfuse3-dev."""
    control.exec_("mkdir", "-p", DIR)
    if not _exists(BIN):
        control.exec_("sh", "-c",
                      f"test -d {DIR}/.git || "
                      f"git clone {REPO_URL} {DIR}")
        for sub in ("libs/libpcache", "lazyfs"):
            control.exec_("sh", "-c",
                          f"cd {DIR}/{sub} && ./build.sh")


def _exists(path: str) -> bool:
    try:
        control.exec_("test", "-e", path)
        return True
    except RemoteError:
        return False


def config_toml(fs: LazyFS) -> str:
    """The lazyfs config enabling the faults FIFO."""
    return (f'[faults]\nfifo_path="{fs.fifo}"\n'
            f'[cache]\napply_lru_eviction=false\n'
            f'[cache.simple]\ncustom_size="0.5GB"\nblocks_per_page=1\n')


def mount(fs: LazyFS) -> None:
    """Mount fs.dir through lazyfs, backed by fs.data_dir (reference
    `lazyfs/mount!`)."""
    control.exec_("mkdir", "-p", fs.dir, fs.data_dir)
    control.exec_("sh", "-c",
                  f"echo {control.core.escape(config_toml(fs))} "
                  f"> {fs.config}")
    control.exec_(BIN, fs.dir,
                  "--config-path", fs.config,
                  "-o", "allow_other",
                  "-o", "modules=subdir",
                  "-o", f"subdir={fs.data_dir}")


def umount(fs: LazyFS) -> None:
    try:
        control.exec_("fusermount", "-u", fs.dir)
    except RemoteError as e:
        logger.warning("lazyfs umount failed: %s", e)


def _fifo_cmd(fs: LazyFS, cmd: str) -> None:
    control.exec_("sh", "-c",
                  f"echo {control.core.escape(cmd)} > {fs.fifo}")


def lose_unfsynced_writes(fs: LazyFS) -> None:
    """Drop every write that was never fsynced (the signature fault)."""
    _fifo_cmd(fs, "lazyfs::clear-cache")


def checkpoint(fs: LazyFS) -> None:
    """Persist current cache state (used between fault rounds)."""
    _fifo_cmd(fs, "lazyfs::cache-checkpoint")


class DB(db_proto.DB):
    """Wraps a db so its data dir lives on lazyfs (reference `lazyfs/db`):
    install+mount before inner setup, unmount after inner teardown."""

    def __init__(self, db, fs: LazyFS):
        self.db = db
        self.fs = fs

    def setup(self, test, node):
        install()
        mount(self.fs)
        self.db.setup(test, node)

    def teardown(self, test, node):
        self.db.teardown(test, node)
        umount(self.fs)

    def __getattr__(self, name):
        # forward facet methods (log_files, kill, ...) to the inner db
        return getattr(self.db, name)
