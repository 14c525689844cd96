"""Campaign device slots for the current thread (the port's copy of the
thread-local part of `jepsen_tpu/parallel/slots.py`).

The campaign scheduler pins each device run to the slot it acquired
(`set_active_slot` around the run on a worker thread); the subprocess
runner exports the ``JEPSEN_CAMPAIGN_DEVICE_SLOT`` /
``..._SLOTS`` environment pair instead.  `active_slot` reads either.
A fleet worker pins a cell's shard count with `set_forced_shards`
(thread-local; ``JEPSEN_SHARDS`` when unpinned, read by
`_forced_shards` as in the JAX module).

Nothing in the port reads that pin yet: the JAX module's mesh half
(`slot_devices`, `default_mesh`, `place_sharded`) waits for the port's
multi-card paths.  This is what the JAX package does on a one-device
host too: there `default_mesh` takes ``devs[:forced]``, finds fewer
than 2 devices and returns None, the single-device path.

Keeping this module import-light matters: it is consulted from the
campaign scheduler threads.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

__all__ = ["set_active_slot", "set_forced_shards", "active_slot"]

_local = threading.local()


def set_active_slot(slot: Optional[int], n_slots: int = 1) -> None:
    """Pin this THREAD's device slice to campaign slot `slot` of
    `n_slots` (None clears).  The campaign scheduler calls this around
    each device run; the subprocess runner exports the env pair
    instead."""
    _local.slot = None if slot is None else (int(slot), max(1, int(n_slots)))


def set_forced_shards(n: Optional[int]) -> None:
    """Pin this THREAD's shard count (None clears) — the thread-safe
    form of JEPSEN_SHARDS, used by fleet workers running cells with a
    pinned ``opts["mesh"]`` (several workers may share one process)."""
    _local.shards = None if n is None else int(n)


def _forced_shards() -> Optional[int]:
    n = getattr(_local, "shards", None)
    if n is not None:
        return n
    env = os.environ.get("JEPSEN_SHARDS")
    if env is None:
        return None
    try:
        return int(env)
    except ValueError:
        return None


def active_slot() -> Optional[Tuple[int, int]]:
    """(slot, n_slots) for this thread, the env pair, or None."""
    sl = getattr(_local, "slot", None)
    if sl is not None:
        return sl
    env = os.environ.get("JEPSEN_CAMPAIGN_DEVICE_SLOT")
    if env is None:
        return None
    try:
        return (int(env),
                max(1, int(os.environ.get(
                    "JEPSEN_CAMPAIGN_DEVICE_SLOTS", 1))))
    except ValueError:
        return None
