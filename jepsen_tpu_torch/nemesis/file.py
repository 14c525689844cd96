"""File-corruption nemesis (the port's copy of
`jepsen_tpu/nemesis/file.py`).

Equivalent of the reference's `jepsen/nemesis/file.clj` (SURVEY.md §2.1):
corrupt chunks of a db file on nodes — bitflip a random chunk, truncate
bytes off the end, or snapshot/restore chunks — implemented with `dd`
and `/dev/urandom` on the node (the (M)-confidence survey note says the
reference uses a deployed helper or dd; dd keeps us dependency-free).

Ops:
- ``bitflip-file``  value = {"file", "probability"? , "nodes"?}
- ``truncate-file`` value = {"file", "bytes"?, "nodes"?}
- ``snapshot-file`` value = {"file", "nodes"?}   (copy aside)
- ``restore-file``  value = {"file", "nodes"?}   (copy back)
"""

from __future__ import annotations

import random as _random
from typing import Optional, Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import on_nodes
from jepsen_tpu_torch.control.core import escape
from jepsen_tpu_torch.nemesis.core import Nemesis

SNAP_DIR = "/tmp/jepsen/snapshots"


def bitflip_chunk(path: str, *, chunk_size: int = 512,
                  rng: Optional[_random.Random] = None) -> str:
    """Overwrite one random chunk of `path` with urandom bytes, in place.
    Returns a description. Runs on the current node."""
    rng = rng or _random
    p = escape(path)
    script = (
        f"size=$(stat -c %s {p}); "
        f"if [ \"$size\" -lt {chunk_size} ]; then exit 0; fi; "
        f"chunks=$((size / {chunk_size})); "
        f"target=$((RANDOM * RANDOM % chunks)); "
        f"dd if=/dev/urandom of={p} bs={chunk_size} seek=$target count=1 "
        f"conv=notrunc 2>/dev/null; echo corrupted chunk $target of $chunks")
    return control.exec_("bash", "-c", script)


def truncate_file(path: str, bytes_: int = 64) -> str:
    """Chop `bytes_` off the end of path (reference truncation fault)."""
    p = escape(path)
    return control.exec_(
        "bash", "-c",
        f"size=$(stat -c %s {p}); "
        f"new=$((size > {bytes_} ? size - {bytes_} : 0)); "
        f"truncate -s $new {p}; echo truncated to $new")


def snapshot_file(path: str) -> None:
    p = escape(path)
    control.exec_("mkdir", "-p", SNAP_DIR)
    control.exec_("bash", "-c",
                  f"cp -p {p} {SNAP_DIR}/$(echo {p} | tr / _)")


def restore_file(path: str) -> None:
    p = escape(path)
    control.exec_("bash", "-c",
                  f"cp -p {SNAP_DIR}/$(echo {p} | tr / _) {p}")


class FileCorruptionNemesis(Nemesis):
    """Dispatches the corruption ops (reference
    `nemesis.file/corrupt-file-nemesis`)."""

    def __init__(self, default_file: Optional[str] = None):
        self.default_file = default_file

    def _targets(self, test, v) -> Sequence[str]:
        return (v or {}).get("nodes") or test["nodes"]

    def _file(self, v) -> str:
        f = (v or {}).get("file") or self.default_file
        if not f:
            raise ValueError("no file given for corruption op")
        return f

    def invoke(self, test, op):
        f, v = op["f"], op.get("value")
        path = self._file(v)
        nodes = self._targets(test, v)
        if f == "bitflip-file":
            res = on_nodes(test, lambda t, n: bitflip_chunk(path),
                           nodes=nodes)
        elif f == "truncate-file":
            res = on_nodes(test, lambda t, n: truncate_file(
                path, (v or {}).get("bytes", 64)), nodes=nodes)
        elif f == "snapshot-file":
            res = on_nodes(test, lambda t, n: snapshot_file(path),
                           nodes=nodes)
        elif f == "restore-file":
            res = on_nodes(test, lambda t, n: restore_file(path),
                           nodes=nodes)
        else:
            raise ValueError(f"file nemesis can't handle f={f!r}")
        return dict(op, type="info", value={"file": path, "nodes": res})
