"""Default-mesh resolution and campaign device slots (the port's copy of
`jepsen_tpu/parallel/slots.py`).

Every single-history device check resolves its mesh here:

- the visible device set is this thread's **slot slice** when a
  campaign or fleet scheduler assigned one (`set_active_slot`, or the
  ``JEPSEN_CAMPAIGN_DEVICE_SLOT`` / ``..._SLOTS`` environment pair the
  subprocess runner exports);
- a fleet worker pins a cell's shard count with `set_forced_shards`
  (thread-local; ``JEPSEN_SHARDS`` when unpinned, ``1`` disables
  sharding);
- otherwise a history is checked sharded over ALL visible devices as a
  1-D ``("batch",)`` `mesh.Mesh` once it is big enough
  (`SHARD_MIN_TXNS`).

The visible devices depend on the check's device: every CUDA device on
the card's side (``cuda:0`` .. ``cuda:n-1``), and the one ``cpu`` on the
CPU's, as JAX sees one device on a CPU host.  The gates are the JAX
module's: on the CPU an unforced check shards only when a slot is
active, a forced count of 1 or less gives no mesh, and fewer than 2
visible devices give no mesh.  So on one card, or on the CPU,
``JEPSEN_SHARDS=4`` keeps the single-device path, as JAX does on a
one-device host.

Keeping this module import-light matters: it is consulted from the
checker hot path and from the campaign scheduler threads.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

__all__ = ["set_active_slot", "set_forced_shards", "active_slot",
           "slot_devices", "all_devices", "default_mesh", "place_sharded",
           "SHARD_MIN_TXNS"]

#: below this many (padded) txns an unforced check keeps the
#: single-device path: the JAX package's value, not yet measured on
#: H100s (ROADMAP A6 measures the crossover on four cards)
SHARD_MIN_TXNS = 65536

_local = threading.local()
_mesh_cache: dict = {}


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


def slot_devices(slot: int, n_slots: int, devices=None) -> List:
    """Contiguous device slice for `slot` of `n_slots` sub-meshes, of
    `devices` (the card's visible devices when None).  With fewer
    devices than slots, slots round-robin single devices (a 1-device
    slice = the plain single-device path)."""
    devs = list(devices if devices is not None else all_devices(None))
    n = len(devs)
    if n == 0:
        return devs
    if n < n_slots:
        return [devs[slot % n]]
    per = n // n_slots
    lo = (slot % n_slots) * per
    return devs[lo:lo + per]


def all_devices(device) -> List:
    """Every device of `device`'s kind: the one ``cpu``, or each visible
    CUDA device (none without a card) for a CUDA device or None."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _visible_devices(device=None) -> List:
    devs = all_devices(device)
    sl = active_slot()
    if sl is not None:
        devs = slot_devices(sl[0], sl[1], devs)
    return devs


def default_mesh(n_txns: Optional[int] = None, device=None):
    """The 1-D ("batch",) `mesh.Mesh` this check should shard over, or
    None for the single-device path.  `n_txns` (padded txn capacity)
    gates the size threshold; None skips the gate (caller forces).
    `device` is the check's device (the card when None): its kind picks
    the visible devices.

    On the CPU one device is visible (`all_devices`), so no mesh
    results; the JAX module's CPU gate is kept all the same (an unforced
    check takes a mesh there only when slot-assigned), for the tests
    that widen `all_devices` to several ``cpu`` shards, as the JAX tests
    force 8 virtual host devices."""
    import torch

    forced = _forced_shards()
    devs = _visible_devices(device)
    if forced is not None:
        if forced <= 1:
            return None
        devs = devs[:forced]
    else:
        if n_txns is not None and n_txns < SHARD_MIN_TXNS:
            return None
        if device is not None and torch.device(device).type == "cpu" \
                and active_slot() is None:
            return None
    if len(devs) < 2:
        return None
    key = tuple(devs)
    mesh = _mesh_cache.get(key)
    if mesh is None:
        from jepsen_tpu_torch.parallel.mesh import Mesh

        mesh = _mesh_cache[key] = Mesh(devs, ("batch",))
    return mesh


def place_sharded(x, mesh=None, device=None):
    """`x` (a numpy array) on the devices: a list of tensors, the row
    blocks of its leading axis in order, one on each shard of `mesh` (or
    of the default mesh for `device`, its leading dimension standing in
    for n_txns so that the size gate applies) when the axis divides the
    mesh's size; else one tensor, on the mesh's first device (the JAX
    replicated placement, computed once) or on `device` when no mesh
    applies.  The on-ramp for the invariants' row reductions (bank row
    sums)."""
    import numpy as np
    import torch

    arr = np.ascontiguousarray(x)
    t = torch.from_numpy(arr)
    if mesh is None:
        mesh = default_mesh(arr.shape[0] if arr.ndim >= 1 else 0,
                            device=device)
    if mesh is None:
        from jepsen_tpu_torch import backend

        return [t.to(backend.resolve(device))]
    devs = [torch.device(d) for d in mesh.devices.flat]
    n = len(devs)
    if arr.ndim < 1 or arr.shape[0] % n:
        return [t.to(devs[0])]
    per = arr.shape[0] // n
    return [t[i * per:(i + 1) * per].to(d) for i, d in enumerate(devs)]
